"""SPIRAL runners: the pretrain loop, and the CTC finetune runner.

``SpiralPretrainRunner`` is the single-device part of
``tpu_speech/train/spiral_runner.py::SpiralPretrainRunner`` (``:100-566``):
``AudioDataset(return_both=True)``, ``AudioBatchCollate`` and ``DataLoader``
(the port's copies, ``data/``), the host-side masks and teacher shifts with
the same generator seeding (``_augment``), the int16 wire format,
``pretrain_step`` (``train/spiral.py``) with ``model.precision`` (``bf16``
mixed precision) and ``trainer.accumulate_grad_batches`` (micro-batches
buffered across epochs, one update per ``accum`` batches, ``iteration``
counting updates), a log line per epoch with loss, accuracy and ms/step,
``validate:329`` (the no-update contrastive loss and ``check_collapse`` over
``validation_ds``, one line in ``train.log``), a reference-named
``state_dict`` and a ``.tpu_speech`` archive at the end.

``SpiralFinetuneRunner`` is the single-device part of
``tpu_speech/train/spiral_runner.py::SpiralFinetuneRunner``. Serving: the
model built from the run config (``:692-705``), weight loading,
``_infer_fn:1098`` (wav -> ``wav_to_spec`` -> ``CTCFinetuneModel`` ->
log-probs), ``transcribe:961`` (with the overlapping-window path for audio
longer than ``max_duration``) and ``evaluate:1134`` (greedy CTC decode,
WER/CER and the per-utterance HTML diagnosis). Training (``:569-959``): the
pretrained encoder from ``model.pretrain_chkpt_path`` (``_load_pretrain:773``),
``AudioToTextDataset`` with ``dup_factor``, ``AudioTextBatchCollate(max
samples, 512)`` and ``DataLoader``, the host generator ``default_rng(1)``
(``:709-711``) and its spec masks (``_train_masks:871``), the int16 wire
(``_device_batches:890``), AdamW with the lr rescale (``:724-733``),
``finetune_step`` with the freeze gate decided from the iteration counter,
``train_epoch:914`` (metrics read back once per epoch), ``validate:941`` and
a reference-named ``state_dict`` and an archive at the end; bf16 and
accumulation as the pretrain runner (``:890-929``). Host-side data,
tokenizers and scoring are the port's own copies of the JAX package's
modules (``data/``, ``text/``, ``eval/wer.py``).

Both runners share (``_Runner``) the checkpoints and the weight files:
- ``save_checkpoint`` writes one ``utils/checkpoint.py`` step file a call
  (the CLI calls it at every epoch's end, after that epoch's validation, as
  the JAX runners save at ``:564``/``:937``) on the ``Checkpointer``'s
  background thread: the model (float32 masters, the EMA teacher, BatchNorm
  statistics), AdamW's moments and count, the step counts, the epoch, every
  generator (dropout, the host masks, the datasets' crops), the loader's
  epoch and the micro-batches buffered for the next update. So
  ``resume_if_exists`` (``:246``/``:796``) continues a run where it stopped,
  at the next epoch, and a resumed run equals a straight one bit for bit
  where the step is deterministic: on the CPU, and on the card with
  ``torch.backends.cudnn.deterministic`` (cuDNN's default weight-gradient
  algorithms sum in an order of their own from call to call). A checkpoint
  directory that holds only the JAX package's orbax steps stops the resume
  with a message: orbax imports JAX.
- ``save_archive`` (``:259``/``:809``) writes ``<log_dir>/<cfg.name>.tpu_speech``
  (``utils/archive.py``): the flax trees of ``compat/jax_spiral.py``'s
  ``*_to_jax``, with ``teacher`` and ``batch_stats`` as extra trees.
- ``restore_from_archive`` (``:270``/``:818``) and ``restore_from_checkpoint``
  (``:301``/``:846``; here also a reference-named ``.pt`` or an ``.npz`` of
  JAX trees) load weights only, through ``utils/surgery.py::merge_params``
  on those trees: strict, or ``partial``, with ``skip`` patterns.

Both keep float32 parameters and run float32 with ``use_full_fp32()``, which
turns TF32 off for cuDNN convolutions (on by default in PyTorch) and matmuls;
with ``model.precision = "bf16"`` the training steps run the network on bf16
copies of the parameters (serving and validation stay float32). Both default
to the CUDA device and raise when there is none; the CPU runs only when it is
asked for (``device="cpu"``).

Not ported yet: orbax checkpoints, the native C++ batcher, tarred data, the
mu-law wire format, the bucketed loader (``num_buckets``), beam search and
streaming decode, mesh / FSDP / sequence parallelism and multi-process runs.
"""

from __future__ import annotations

import functools
import os
import re
import time
from typing import Optional

import numpy as np
import torch

from tpu_speech_torch.compat.jax_spiral import (
    ctc_finetune_from_jax,
    ctc_finetune_to_jax,
    load_jax_npz,
    st2vec_from_jax,
    st2vec_to_jax,
)
from tpu_speech_torch.data.loader import DataLoader
from tpu_speech_torch.data.spiral import (
    AudioAugmentor,
    AudioBatchCollate,
    AudioDataset,
    AudioTextBatchCollate,
    AudioToTextDataset,
    RandomNoisePerturbation,
)
from tpu_speech_torch.data.wav import read_wav
from tpu_speech_torch.eval.wer import ctc_greedy_decode, error_counts, render_wer_html
from tpu_speech_torch.models.spiral.ctc import CTCFinetuneModel, load_pretrained_encoder
from tpu_speech_torch.models.spiral.masking import make_student_masks
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, wav_to_spec
from tpu_speech_torch.text.tokenizers import BlankOffsetTokenizer
from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
from tpu_speech_torch.train.optim import lr_scale, make_optimizer
from tpu_speech_torch.train.spiral import (
    batch_to_device,
    host_augment_batch,
    make_pretrain_state,
    pretrain_step,
    quantize_wire_int16,
    validation_loss,
)
from tpu_speech_torch.utils.archive import load_archive, save_archive
from tpu_speech_torch.utils.checkpoint import Checkpointer
from tpu_speech_torch.utils.device import resolve_device
from tpu_speech_torch.utils.surgery import merge_params

# reference-checkpoint buffers that are constants here, under any task-model
# prefix (the JAX converter drops them the same way,
# compat/torch_spiral.py:200-204)
_REFERENCE_CONSTANTS = ("mask_emb", "wav2spec.featurizer.window", "wav2spec.featurizer.fb")


def build_model(cfg, num_classes: int, device=None) -> CTCFinetuneModel:
    """CTCFinetuneModel from ``cfg.model`` (encoder + decoder configs)."""
    m = cfg.model
    dec = m.decoder
    kw = {}
    blank_pos = "vocab_first"
    if dec is not None:
        blank_pos = dec.blank_pos
        if dec.conv_layers is not None:
            kw["decoder_convs"] = tuple(dec.conv_layers)
        kw.update(upsample_rate=dec.upsample_rate,
                  upsample_filters=dec.upsample_filters,
                  upsample_norm=dec.upsample_norm,
                  upsample_act=dec.upsample_act,
                  upsample_dropout=dec.upsample_dropout)
    return CTCFinetuneModel(m.encoder, num_classes, blank_pos, device=device, **kw)


def _is_step_checkpoint(obj) -> bool:
    """A port step checkpoint (``_Runner.save_checkpoint``), not a bare
    state_dict."""
    return (isinstance(obj, dict) and "model" in obj and "iteration" in obj
            and not torch.is_tensor(obj["model"]))


def _torch_state_dict(path: str):
    """The model state_dict in a torch file: a bare state_dict, a Lightning
    checkpoint's ``state_dict``, or a port step checkpoint's ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if _is_step_checkpoint(sd):
        return sd["model"]
    if "state_dict" in sd and not torch.is_tensor(sd["state_dict"]):
        sd = sd["state_dict"]
    return sd


def _drop_constants(state_dict):
    return {k: v for k, v in state_dict.items() if not k.endswith(_REFERENCE_CONSTANTS)}


def load_pretrain_file(path: str):
    """A pretraining model's state_dict (``_load_pretrain:773``): the port's
    ``st2vec.pt`` or one of its step checkpoints, a reference Lightning
    checkpoint (``.pt``/``.ckpt``), a ``.tpu_speech`` archive, or JAX trees in
    an ``.npz`` (``params/``, ``batch_stats/``, ``teacher/``)."""
    if os.path.isdir(path):
        raise NotImplementedError(f"{path}: orbax checkpoints are not ported (they import JAX)")
    if path.endswith(".npz"):
        return st2vec_from_jax(*load_jax_npz(path, ("params", "batch_stats", "teacher")))
    if path.endswith(".tpu_speech"):
        _, params, extra = load_archive(path)
        return st2vec_from_jax(params, extra.get("batch_stats"), extra.get("teacher"))
    return _torch_state_dict(path)


def _orbax_steps(ckpt_dir: str):
    """The JAX package's orbax step directories (``step_NNNNNNNNNN/``)."""
    return sorted(n for n in os.listdir(ckpt_dir) if re.fullmatch(r"step_\d+", n)
                  and os.path.isdir(os.path.join(ckpt_dir, n)))


def _to_device(obj, device):
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_device(v, device) for v in obj]
    return obj


class _Runner:
    """Checkpoints, resume, archives and weight surgery, shared by the two
    runners. A runner provides ``_weights`` (the module that holds every
    weight), ``state`` (its optimizer and step count), ``rng``, ``host_rng``,
    ``_micro``, ``_to_jax``/``_from_jax`` (its state_dict <-> flax trees,
    ``compat/jax_spiral.py``), ``_npz_roots``, ``archive_default`` and
    ``_extra_state``/``_load_extra_state`` for what else resumes."""

    def _init_run(self, cfg, log_dir: str, exp, ckpt_dir: str) -> str:
        self.cfg = cfg
        self.exp = exp
        if exp is not None:
            log_dir = exp.log_dir
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.tb = exp.tb if exp is not None else None
        # --chkpt_dir relocates the step checkpoints (JAX runner :237-239)
        self.ckpt = Checkpointer(ckpt_dir or os.path.join(log_dir, "ckpt"))
        self.epoch = 0  # epochs completed (the one the latest checkpoint ended)
        self.iteration = 0  # optimizer updates
        self.history = []  # per-step metrics, floats
        return log_dir

    def _log(self, msg: str) -> None:
        with open(os.path.join(self.log_dir, "train.log"), "a") as f:
            f.write(msg + "\n")

    # ---- step checkpoints and resume --------------------------------------

    def checkpoint_state(self) -> dict:
        """What a step checkpoint holds: the model's state_dict (float32
        masters, the EMA teacher, BatchNorm statistics), AdamW's moments by
        parameter name and its count, the step counts and the epoch, the
        dropout generators, the host mask generator, the micro-batches
        buffered for the next update, and the runner's own extras."""
        model, opt = self._weights, self.state.optimizer
        names = {p: n for n, p in model.named_parameters()}
        out = {"model": model.state_dict(),
               "mu": {names[p]: st["mu"] for p, st in opt.state.items()},
               "nu": {names[p]: st["nu"] for p, st in opt.state.items()},
               "count": opt.count, "step": self.state.step,
               "iteration": self.iteration, "epoch": self.epoch,
               "rng_host": self.rng.host.get_state(),
               "rng_device": self.rng.device.get_state(),
               "host_rng": self.host_rng.bit_generator.state,
               "micro": list(self._micro)}
        out.update(self._extra_state())
        return out

    def load_checkpoint_state(self, st: dict) -> None:
        model, opt = self._weights, self.state.optimizer
        model.load_state_dict(st["model"])
        params = dict(model.named_parameters())
        opt.state.clear()
        for name, mu in st["mu"].items():
            p = params[name]
            opt.state[p] = {"mu": mu.to(p.device), "nu": st["nu"][name].to(p.device)}
        opt.count = int(st["count"])
        self.state.step = int(st["step"])
        self.iteration, self.epoch = int(st["iteration"]), int(st["epoch"])
        self.rng.host.set_state(st["rng_host"])
        self.rng.device.set_state(st["rng_device"])
        self.host_rng.bit_generator.state = st["host_rng"]
        self._micro = _to_device(st["micro"], self.device)
        self._load_extra_state(st)

    def save_checkpoint(self, epoch: int) -> None:
        """Checkpoint the run as it stands at the end of ``epoch``: the state
        is copied to host memory here and written on the Checkpointer's
        thread (the next save, or ``ckpt.wait``, drains it)."""
        self.epoch = epoch
        self.ckpt.save(self.iteration, self.checkpoint_state())

    def resume_if_exists(self) -> bool:
        """Load the latest step checkpoint, if the checkpoint directory has
        one; training then continues at the epoch after it."""
        st = self.ckpt.restore_latest()
        if st is None:
            orbax = _orbax_steps(self.ckpt.ckpt_dir)
            if orbax:
                raise SystemExit(
                    f"{self.ckpt.ckpt_dir} holds the JAX package's orbax checkpoints "
                    f"({orbax[-1]}) and no step checkpoint of the port: the port cannot "
                    "read orbax (it imports JAX). Pass --resume_if_exists false to train "
                    "from scratch, or another --model_save_dir / --chkpt_dir.")
            return False
        self.load_checkpoint_state(st)
        return True

    # ---- weights: archives and surgery --------------------------------------

    def weight_trees(self) -> dict:
        """The model's weights as the JAX package's flax trees."""
        return self._to_jax(self._weights.state_dict())

    def save_archive(self) -> str:
        """``<log_dir>/<cfg.name>.tpu_speech``: the config, the params tree and
        the other trees (``batch_stats``, and ``teacher`` when pretraining)."""
        trees = self.weight_trees()
        params = trees.pop("params")
        path = os.path.join(self.log_dir, f"{self.cfg.name or self.archive_default}.tpu_speech")
        save_archive(path, self.cfg, params, extra=trees)
        return path

    def _restore_trees(self, params, extra: dict, partial: bool, skip, what: str):
        """Merge a source's params into the model's by flax path (strict
        unless ``partial``; ``skip`` patterns keep the model's leaves); the
        other trees are taken whole where the source has them. Step counts
        and the optimizer stay as they are."""
        trees = self.weight_trees()
        merged, report = merge_params(trees["params"], params, partial=partial, skip=skip)
        print(f"{what} restore: {report.summary()}")
        trees = {k: (extra[k] if extra.get(k) else v) for k, v in trees.items()}
        trees["params"] = merged
        with torch.no_grad():
            self._weights.load_state_dict(self._from_jax(trees), strict=True)
        return report

    def restore_from_archive(self, path: str, partial: bool = False, skip=()):
        """A ``.tpu_speech`` archive's weights, through ``merge_params``."""
        _, params, extra = load_archive(path)
        return self._restore_trees(params, extra, partial, skip, "archive")

    def restore_from_checkpoint(self, path: str, partial: bool = False, skip=()):
        """The weights of a step checkpoint, a reference-named ``.pt``, an
        archive or an ``.npz`` of JAX trees, through ``merge_params``."""
        if path.endswith(".tpu_speech"):
            return self.restore_from_archive(path, partial, skip)
        if path.endswith(".npz"):
            trees = dict(zip(self._npz_roots, load_jax_npz(path, self._npz_roots)))
        else:
            trees = self._to_jax(_drop_constants(_torch_state_dict(path)))
        params = trees.pop("params")
        return self._restore_trees(params, trees, partial, skip, "checkpoint")



class SpiralFinetuneRunner(_Runner):
    """Single-device CTC finetuning and serving."""

    archive_default = "ctc_finetune"
    _npz_roots = ("params", "batch_stats")

    def __init__(self, cfg, log_dir: str, tokenizer, device="cuda", exp=None,
                 ckpt_dir: str = ""):
        """exp: an optional ``utils/exp_manager.py::ExpManager`` that owns the
        run directory and the TensorBoard writer; ckpt_dir: the step
        checkpoints' directory (default ``<log_dir>/ckpt``)."""
        log_dir = self._init_run(cfg, log_dir, exp, ckpt_dir)
        m = cfg.model
        self.enc_cfg = m.encoder
        self.device = resolve_device(device)
        dec = m.decoder
        if dec is None or dec.blank_pos == "vocab_first":
            # reserve id 0 for the CTC blank (blank_pos='vocab_first')
            tokenizer = BlankOffsetTokenizer(tokenizer)
        self.tokenizer = tokenizer
        self.sample_rate = m.train_ds.sample_rate
        self.max_samples = int((m.train_ds.max_duration or 24.0) * self.sample_rate)
        # random weights from a seeded generator until load_* replaces them
        # (the JAX runner's model.init with PRNGKey(0))
        model = build_model(cfg, tokenizer.vocab_size)
        model.init_weights(torch.Generator().manual_seed(0))
        if m.pretrain_chkpt_path:
            load_pretrained_encoder(model, load_pretrain_file(m.pretrain_chkpt_path),
                                    m.use_teacher_encoder)
        self.model = model.to(self.device).eval()
        self.accum = max(1, getattr(cfg.trainer, "accumulate_grad_batches", 1))
        self.bf16 = getattr(m, "precision", "fp32") == "bf16"
        self._micro = []  # micro-batches of the next update (kept across epochs)
        self._loader_resume = None  # a checkpoint's loader state, for when it is built

    @property
    def _weights(self):
        return self.model

    @staticmethod
    def _to_jax(state_dict) -> dict:
        return dict(zip(("params", "batch_stats"), ctc_finetune_to_jax(state_dict)))

    @staticmethod
    def _from_jax(trees):
        return ctc_finetune_from_jax(trees["params"], trees["batch_stats"])

    def _extra_state(self) -> dict:
        return {"loader_epoch": self.loader._epoch,
                "dataset_rng": self.loader.dataset.rng.getstate()}

    def _load_extra_state(self, st: dict) -> None:
        self._loader_resume = (st["loader_epoch"], st["dataset_rng"])
        if "loader" in self.__dict__:
            self._apply_loader_resume()

    def _apply_loader_resume(self):
        if self._loader_resume is not None:
            epoch, crop_rng = self._loader_resume
            self.loader.set_epoch(epoch)
            self.loader.dataset.rng.setstate(crop_rng)
            self._loader_resume = None

    # the training half is built at first use: serving needs no optimizer,
    # dropout generator, mask generator or training manifest

    @functools.cached_property
    def state(self):
        m = self.cfg.model
        total_steps = m.optim.sched.max_steps if m.optim.sched else 80000
        scale = lr_scale(m, data_parallel=1, accum=self.accum)
        return make_finetune_state(
            self.model, lambda params: make_optimizer(m.optim, params, total_steps, scale))

    @functools.cached_property
    def rng(self):
        return DropoutRng.seeded(0, self.device)

    @functools.cached_property
    def host_rng(self):
        return np.random.default_rng(1)  # process index 0

    def load_state_dict(self, state_dict) -> None:
        self.model.load_state_dict(state_dict, strict=True)

    @torch.inference_mode()
    def infer(self, wavs, wav_lens):
        """wavs (B, N) float32 / int16 / uint8, lengths (B,) -> (log_probs
        (B, T, V), lens (B,)) on the runner's device, in eval mode."""
        self.model.eval()
        wavs = torch.as_tensor(wavs).to(self.device)
        wav_lens = torch.as_tensor(wav_lens).to(self.device)
        specs, spec_lens = wav_to_spec(self.enc_cfg, wavs, wav_lens)
        return self.model(specs, spec_lens)

    def _decode(self, log_probs, lens):
        return ctc_greedy_decode(log_probs.cpu().numpy(), lens.cpu().numpy(),
                                 self.model.blank_idx)

    def transcribe(self, audio_paths, batch_size: int = 4,
                   overlap_s: float = 3.2):
        """Decode wav files -> texts (greedy). Audio longer than
        ``max_duration`` runs as overlapping windows stitched at the overlap
        midpoints (``_chunked_log_probs``)."""
        texts = [None] * len(audio_paths)
        short = []
        for pos, path in enumerate(audio_paths):
            wav, sr = read_wav(path)
            if sr != self.sample_rate:
                raise ValueError(f"{path}: sample rate {sr} != {self.sample_rate}")
            if len(wav) > self.max_samples:
                lp = self._chunked_log_probs(wav, overlap_s)
                ids = ctc_greedy_decode(lp[None], np.array([lp.shape[0]]),
                                        self.model.blank_idx)[0]
                texts[pos] = self.tokenizer.ids_to_text(ids)
            else:
                short.append((pos, wav))
        for i in range(0, len(short), batch_size):
            group = short[i:i + batch_size]
            padded = np.zeros((len(group), self.max_samples), np.float32)
            lens = np.zeros((len(group),), np.int32)
            for j, (_, w) in enumerate(group):
                padded[j, :len(w)] = w
                lens[j] = len(w)
            ids = self._decode(*self.infer(padded, lens))
            for (pos, _), seq in zip(group, ids):
                texts[pos] = self.tokenizer.ids_to_text(seq)
        return texts

    def _chunked_log_probs(self, wav: np.ndarray, overlap_s: float) -> np.ndarray:
        """Overlapping full-width windows over one long wav, frame log-probs
        stitched at the overlap midpoints (spiral_runner.py:1061-1094)."""
        window = self.max_samples
        ov = min(int(overlap_s * self.sample_rate), window // 2)
        hop = window - ov
        starts = list(range(0, len(wav), hop))
        while len(starts) > 1 and starts[-1] + ov >= len(wav):
            starts.pop()
        pieces = []
        for k, s in enumerate(starts):
            seg = wav[s:s + window]
            padded = np.zeros((1, window), np.float32)
            padded[0, :len(seg)] = seg
            lp, out_len = self.infer(padded, np.array([len(seg)], np.int32))
            lp = lp[0].cpu().numpy()
            f = int(out_len[0])
            frames_per_sample = f / max(len(seg), 1)
            edge = int(round((ov / 2) * frames_per_sample))
            lo = 0 if k == 0 else edge
            hi = f if k == len(starts) - 1 else f - edge
            pieces.append(lp[lo:hi])
        return np.concatenate(pieces, axis=0)

    def evaluate(self, manifest: Optional[str] = None,
                 save_logits_dir: Optional[str] = None, ds_cfg=None) -> dict:
        """Test-mode WER/CER with greedy decoding (spiral_runner.py:1134)."""
        m = self.cfg.model
        ds_cfg = ds_cfg or m.test_ds or m.validation_ds
        manifest = manifest or ds_cfg.manifest_filepath
        dataset = AudioToTextDataset(
            manifest, self.tokenizer, sample_rate=ds_cfg.sample_rate,
            crop_size=self.max_samples,
        )
        loader = DataLoader(
            dataset, ds_cfg.batch_size, AudioTextBatchCollate(self.max_samples, 512),
            shuffle=False, drop_last=False, num_workers=ds_cfg.num_workers,
        )
        hyps, refs = [], []
        for raw in loader:
            log_probs, lens = self.infer(raw["wavs"], raw["wav_lens"])
            for seq, text in zip(self._decode(log_probs, lens), raw["texts"]):
                hyps.append(self.tokenizer.ids_to_text(seq))
                refs.append(text)
            if save_logits_dir:
                os.makedirs(save_logits_dir, exist_ok=True)
                np.save(os.path.join(save_logits_dir, f"logits_{len(hyps)}.npy"),
                        log_probs.cpu().numpy())
        w_err, w_tot = error_counts(hyps, refs)
        c_err, c_tot = error_counts(hyps, refs, use_cer=True)
        err_utts = sum(1 for h, r in zip(hyps, refs) if h.split() != r.split())
        html_path = os.path.join(self.log_dir, "wer_diagnosis.html")
        render_wer_html(hyps, refs, html_path)
        return {
            "wer": w_err / max(w_tot, 1),
            "cer": c_err / max(c_tot, 1),
            "n": len(hyps),
            "ser": err_utts / max(len(hyps), 1),
            "diagnosis_html": html_path,
            "hyps": hyps,
        }


    # ---- training ---------------------------------------------------------

    @functools.cached_property
    def loader(self):
        ds = self.cfg.model.train_ds
        if getattr(ds, "tarred_audio_filepaths", None):
            raise NotImplementedError("tarred training data is not ported yet")
        if max(1, getattr(ds, "num_buckets", 1)) > 1:
            raise NotImplementedError("the bucketed loader is not ported yet")
        dataset = AudioToTextDataset(
            ds.manifest_filepath, self.tokenizer, sample_rate=ds.sample_rate,
            crop_size=self.max_samples, min_duration=ds.min_duration,
            max_duration=ds.max_duration, dup_factor=getattr(ds, "dup_factor", 1),
        )
        loader = DataLoader(
            dataset, ds.batch_size, AudioTextBatchCollate(self.max_samples, 512),
            shuffle=ds.shuffle, num_workers=ds.num_workers,
        )
        self.__dict__["loader"] = loader
        self._apply_loader_resume()
        return loader

    def _train_masks(self, wav_width: int, wav_lens):
        """The spec masks of one training batch from the host generator
        (``_train_masks:871``)."""
        hop = int(0.01 * self.sample_rate)
        spec_lens = np.ceil(np.asarray(wav_lens) / hop).astype(np.int32)
        e = self.enc_cfg
        return make_student_masks(
            len(spec_lens), _spec_len(int(wav_width), self.sample_rate),
            e.num_features, spec_lens, e.mask_prob, e.mask_length,
            e.mask_channel_prob, e.mask_channel_length, rng=self.host_rng,
        )

    def device_batch(self, raw) -> dict:
        """A collated batch -> masks, the wire format, the device
        (``_device_batches:890-899``)."""
        batch = {k: v for k, v in raw.items() if k != "texts"}
        batch["time_mask"], batch["chan_mask"] = self._train_masks(
            batch["wavs"].shape[1], batch["wav_lens"])
        wire = getattr(self.cfg.model.train_ds, "wire_dtype", "int16")
        if wire == "int16":
            batch = quantize_wire_int16(batch)
        elif wire != "float32":
            raise NotImplementedError(f"wire_dtype={wire!r} is not ported yet")
        return batch_to_device(batch, self.device)

    def step(self, batch) -> dict:
        """One update from a device batch, or from a list of ``accum`` of
        them. The encoder-freeze gate comes from the host-side iteration
        counter (step_auto:252-267), once per update: no device read."""
        n = self.cfg.model.freeze_finetune_updates
        frozen = n > 0 and self.iteration < n
        m = finetune_step(self.state, batch, self.rng, freeze_encoder=frozen,
                          bf16=self.bf16, accum_steps=self.accum)
        m["frozen"] = frozen
        return m

    def train_epoch(self, epoch: int, max_steps: Optional[int] = None) -> float:
        """One pass over the loader, one update per ``accum`` batches (the
        leftover micro-batches wait for the next epoch), stopping early at
        ``max_steps`` total updates. Metrics are read back once, at the end
        of the epoch."""
        pending = []
        t0 = time.perf_counter()
        for raw in self.loader:
            if max_steps and self.iteration >= max_steps:
                break
            self._micro.append(self.device_batch(raw))
            if len(self._micro) < self.accum:
                continue
            batch = self._micro if self.accum > 1 else self._micro[0]
            self._micro = []
            pending.append(self.step(batch))
            self.iteration += 1
        losses = [float(m["loss"]) for m in pending]  # the epoch's one sync
        dt = time.perf_counter() - t0
        for m in pending:
            self.history.append({k: float(v) if torch.is_tensor(v) else v
                                 for k, v in m.items()})
        loss = float(np.mean(losses)) if losses else float("nan")
        msg = (f"Epoch {epoch}: ctc loss = {loss:.4f} | "
               f"step {dt * 1e3 / max(len(pending), 1):.0f} ms")
        print(msg, flush=True)
        self._log(msg)
        if self.tb is not None:
            self.tb.add_scalar("train/loss", loss, self.iteration)
        return loss

    def validate(self) -> dict:
        """Validation WER/CER over ``validation_ds`` (``validate:941``)."""
        ds_cfg = self.cfg.model.validation_ds
        if ds_cfg is None:
            return {}
        results = self.evaluate(manifest=ds_cfg.manifest_filepath, ds_cfg=ds_cfg)
        if self.tb is not None:
            self.tb.add_scalar("val/wer", results["wer"], self.iteration)
            self.tb.add_scalar("val/cer", results["cer"], self.iteration)
        self._log(f"Validation: WER = {results['wer']:.4f} | CER = {results['cer']:.4f}")
        return results

    def save_state_dict(self, name: str = "ctc_finetune.pt") -> str:
        """The model's reference-named state_dict, which ``--run_mode test
        --init_chkpt_file`` and ``convert_ctc_finetune`` load."""
        path = os.path.join(self.log_dir, name)
        torch.save({k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                   path)
        return path


def _spec_len(crop_size: int, sample_rate: int) -> int:
    """Static padded spec length of a crop: 1 + N // hop frames, padded to a
    multiple of 16 (``spiral_runner.py::_spec_len:72``)."""
    t = 1 + crop_size // int(0.01 * sample_rate)
    return ((t + 15) // 16) * 16


class SpiralPretrainRunner(_Runner):
    """Single-device SPIRAL pretraining over a manifest."""

    archive_default = "st2vec"
    _npz_roots = ("params", "batch_stats", "teacher")

    def __init__(self, cfg, log_dir: str, device="cuda", seed: int = 0, exp=None,
                 ckpt_dir: str = ""):
        """exp and ckpt_dir as for ``SpiralFinetuneRunner``."""
        log_dir = self._init_run(cfg, log_dir, exp, ckpt_dir)
        m = cfg.model
        self.enc_cfg = m.encoder
        self.device = resolve_device(device)
        self.accum = max(1, getattr(cfg.trainer, "accumulate_grad_batches", 1))
        self.bf16 = getattr(m, "precision", "fp32") == "bf16"
        self.wire = getattr(m.train_ds, "wire_dtype", "int16")
        if self.wire not in ("int16", "float32"):
            raise NotImplementedError(f"wire_dtype={self.wire!r} is not ported yet")
        if getattr(m.train_ds, "tarred_audio_filepaths", None):
            raise NotImplementedError("tarred training data is not ported yet")

        aug = None
        noise_cfg = getattr(m, "noise_perturb", None)
        if noise_cfg is not None and noise_cfg.manifest_path:
            aug = AudioAugmentor([(1.0, RandomNoisePerturbation(
                noise_cfg.manifest_path, min_snr_db=noise_cfg.min_snr_db,
                max_snr_db=noise_cfg.max_snr_db, ratio=noise_cfg.ratio))])
        elif m.train_ds.noise_manifest:
            aug = AudioAugmentor([(1.0, RandomNoisePerturbation(m.train_ds.noise_manifest))])
        ds = m.train_ds
        self.dataset = AudioDataset(ds.manifest_filepath, ds.sample_rate, ds.crop_size,
                                    ds.min_duration, ds.max_duration, augmentor=aug,
                                    return_both=True)
        self.loader = DataLoader(self.dataset, ds.batch_size, AudioBatchCollate(ds.crop_size),
                                 shuffle=ds.shuffle, num_workers=ds.num_workers)
        self.spec_len = _spec_len(ds.crop_size, ds.sample_rate)

        # the student from a seeded generator (the JAX runner's PRNGKey(0)
        # init), the teacher a copy of its subset
        model = ST2VecEncoder(self.enc_cfg, pretraining=True)
        model.init_weights(torch.Generator().manual_seed(seed))
        total_steps = m.optim.sched.max_steps if m.optim.sched else 100000
        self.lr_scale = lr_scale(m, data_parallel=1, accum=self.accum)
        self.state = make_pretrain_state(
            model.to(self.device),
            lambda params: make_optimizer(m.optim, params, total_steps, self.lr_scale))
        self.rng = DropoutRng.seeded(seed, self.device)
        self.host_rng = np.random.default_rng(0)  # process index 0
        # micro-batches of the next update and their audio seconds (kept
        # across epochs; the seconds count when the update consumes them)
        self._micro, self._micro_sec = [], 0.0
        self.last_validation = {}

    @property
    def _weights(self):
        return self.state.model

    @staticmethod
    def _to_jax(state_dict) -> dict:
        return dict(zip(("params", "batch_stats", "teacher"), st2vec_to_jax(state_dict)))

    @staticmethod
    def _from_jax(trees):
        return st2vec_from_jax(trees["params"], trees["batch_stats"], trees["teacher"])

    def _extra_state(self) -> dict:
        out = {"loader_epoch": self.loader._epoch, "dataset_rng": self.dataset.rng.getstate(),
               "micro_sec": self._micro_sec}
        if "val_loader" in self.__dict__:
            out["val_dataset_rng"] = self.val_loader.dataset.rng.getstate()
        return out

    def _load_extra_state(self, st: dict) -> None:
        self.loader.set_epoch(st["loader_epoch"])
        self.dataset.rng.setstate(st["dataset_rng"])
        self._micro_sec = float(st["micro_sec"])
        if "val_dataset_rng" in st:
            self.val_loader.dataset.rng.setstate(st["val_dataset_rng"])

    def _augment(self, raw, micro: int = 0):
        # shift scalars seeded by the update that consumes the batch and the
        # batch's micro index (spiral_runner.py:461-474)
        shift_rng = np.random.default_rng(1_000_003 + self.iteration * self.accum + micro)
        return host_augment_batch(
            self.enc_cfg, raw["wavs"], raw["wav_lens"], raw["p_wavs"],
            raw["p_wav_lens"], self.spec_len, self.host_rng, shift_rng)

    def device_batch(self, raw, micro: int = 0) -> dict:
        batch = self._augment(raw, micro)
        if self.wire == "int16":
            batch = quantize_wire_int16(batch)
        return batch_to_device(batch, self.device)

    def step(self, batch) -> dict:
        return pretrain_step(self.state, batch, self.rng, grad_clip=self.cfg.model.grad_clip,
                             bf16=self.bf16, accum_steps=self.accum)

    def train_epoch(self, epoch: int, max_steps: Optional[int] = None) -> float:
        """One pass over the loader, one update per ``accum`` batches (the
        leftover micro-batches wait for the next epoch), stopping early at
        ``max_steps`` total updates. Metrics are read back once, at the end
        of the epoch."""
        sr = self.cfg.model.train_ds.sample_rate
        pending, n_sec = [], 0.0
        t0 = time.perf_counter()
        for raw in self.loader:
            if max_steps and self.iteration >= max_steps:
                break
            self._micro.append(self.device_batch(raw, len(self._micro)))
            self._micro_sec += float(np.sum(raw["wav_lens"])) / sr
            if len(self._micro) < self.accum:
                continue
            batch = self._micro if self.accum > 1 else self._micro[0]
            n_sec += self._micro_sec
            self._micro, self._micro_sec = [], 0.0
            pending.append(self.step(batch))
            self.iteration += 1
        losses = [float(m["loss"]) for m in pending]  # the epoch's one sync
        dt = time.perf_counter() - t0
        for m in pending:
            self.history.append({k: float(v) if torch.is_tensor(v) else v
                                 for k, v in m.items()})
        n = max(len(pending), 1)
        loss = float(np.mean(losses)) if losses else float("nan")
        acc = float(np.mean([h["accuracy"] for h in self.history[-len(pending):]])) \
            if pending else float("nan")
        msg = (f"Epoch {epoch}: loss = {loss:.4f} | acc = {acc:.4f} | "
               f"step {dt * 1e3 / n:.0f} ms | {n_sec / max(dt, 1e-9):.1f}x realtime")
        print(msg, flush=True)
        self._log(msg)
        if self.tb is not None:
            self.tb.add_scalar("train/loss", loss, self.iteration)
            self.tb.add_scalar("train/accuracy", acc, self.iteration)
        return loss

    @functools.cached_property
    def val_loader(self):
        """``validation_ds`` cropped and collated as the training data, in
        order, whole batches (the JAX runner's ``_val_loader``)."""
        m = self.cfg.model
        ds = m.validation_ds
        dataset = AudioDataset(ds.manifest_filepath, ds.sample_rate, m.train_ds.crop_size,
                               ds.min_duration, ds.max_duration, return_both=True,
                               dup_factor=getattr(ds, "dup_factor", 1))
        return DataLoader(dataset, ds.batch_size, AudioBatchCollate(m.train_ds.crop_size),
                          shuffle=False, num_workers=ds.num_workers)

    def validation_step(self, batch, neg_idx=None):
        """(loss, accuracy, collapse diagnostics) of one device batch
        (``train/spiral.py::validation_loss``); the negatives are drawn from a
        generator seeded 0 for every batch, as JAX draws them with
        ``PRNGKey(0)``."""
        if neg_idx is None:
            gen = torch.Generator(self.device).manual_seed(0)
            return validation_loss(self.state.model, batch, generator=gen)
        return validation_loss(self.state.model, batch, neg_idx=neg_idx)

    def validate(self) -> float:
        """The mean no-update contrastive loss over ``validation_ds``
        (``validate:329``), float32 and without any update; each batch's masks
        and shifts come from the host generators as a training batch's do
        (the waves stay float32, as JAX's validation feeds them). Writes one
        line to ``train.log`` with the loss and the mean of each
        ``check_collapse`` scalar; ``last_validation`` keeps them, with the
        accuracy and the batch count."""
        if self.cfg.model.validation_ds is None:
            return float("nan")
        results = []
        for raw in self.val_loader:
            batch = batch_to_device(self._augment(raw), self.device)
            results.append(self.validation_step(batch))
        if not results:
            self.last_validation = {}
            return float("nan")
        val = float(np.mean([float(loss) for loss, _, _ in results]))  # the one sync
        out = {"loss": val, "accuracy": float(np.mean([float(a) for _, a, _ in results])),
               "batches": len(results)}
        msg = f"Validation: loss = {val:.4f}"
        for k in results[0][2]:
            out[k] = float(np.mean([float(d[k]) for _, _, d in results]))
            msg += f" | {k} = {out[k]:.4f}"
        if self.tb is not None:
            self.tb.add_scalar("val/loss", val, self.iteration)
            for k in results[0][2]:
                self.tb.add_scalar(f"val/collapse/{k}", out[k], self.iteration)
        self._log(msg)
        self.last_validation = out
        return val

    def save_state_dict(self, name: str = "st2vec.pt") -> str:
        """The model's reference-named state_dict (student, predictor BN
        statistics, ``target_*`` teacher), loadable by
        ``tpu_speech.compat.torch_spiral.convert_st2vec``."""
        path = os.path.join(self.log_dir, name)
        torch.save({k: v.detach().cpu() for k, v in self.state.model.state_dict().items()},
                   path)
        return path
