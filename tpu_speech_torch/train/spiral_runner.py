"""SPIRAL runners: the pretrain loop, and the CTC finetune runner.

``SpiralPretrainRunner`` is the single-device part of
``tpu_speech/train/spiral_runner.py::SpiralPretrainRunner`` (``:100-245``,
``:461-566``): ``AudioDataset(return_both=True)``, ``AudioBatchCollate``
and ``DataLoader`` (the port's copies, ``data/``), the host-side
masks and teacher shifts with the same generator seeding (``_augment``), the
int16 wire format, ``pretrain_step`` (``train/spiral.py``) with
``model.precision`` (``bf16`` mixed precision) and
``trainer.accumulate_grad_batches`` (micro-batches buffered across epochs,
one update per ``accum`` batches, ``iteration`` counting updates), a log line
per epoch with loss, accuracy and ms/step, and a reference-named
``state_dict`` saved at the end. Not ported yet: ``validate``, resume, archives, orbax
checkpoints, the native C++ batcher, tarred data, the mu-law wire format,
mesh / FSDP / sequence parallelism.

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
a reference-named ``state_dict`` at the end; bf16 and accumulation as the
pretrain runner (``:890-929``). Host-side data, tokenizers and
scoring are the port's own copies of the JAX package's modules (``data/``,
``text/``, ``eval/wer.py``).

Both keep float32 parameters and run float32 with ``use_full_fp32()``, which
turns TF32 off for cuDNN convolutions (on by default in PyTorch) and matmuls;
with ``model.precision = "bf16"`` the training steps run the network on bf16
copies of the parameters (serving stays float32). Both default to the
CUDA device and raise when there is none; the CPU runs only when it is asked
for (``device="cpu"``).

Not ported yet: resume, orbax checkpoints and ``.tpu_speech`` archives, the
bucketed loader (``num_buckets``), tarred data, beam search and streaming
decode, multi-process runs.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from tpu_speech_torch.compat.jax_spiral import (
    ctc_finetune_from_jax,
    load_jax_npz,
    st2vec_from_jax,
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
)
from tpu_speech_torch.utils.device import resolve_device

# reference-checkpoint buffers that are constants here (the JAX converter
# drops them the same way, compat/torch_spiral.py:200-204)
_REFERENCE_CONSTANTS = ("encoder.mask_emb", "encoder.wav2spec.featurizer.window",
                        "encoder.wav2spec.featurizer.fb")


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


def load_state_dict_file(path: str):
    """A torch state_dict (``.pt``/``.pth``/``.ckpt``; a Lightning checkpoint's
    ``state_dict`` is unwrapped) or JAX trees in an ``.npz``."""
    if path.endswith(".npz"):
        return ctc_finetune_from_jax(*load_jax_npz(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and not torch.is_tensor(sd["state_dict"]):
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if k not in _REFERENCE_CONSTANTS}


def load_pretrain_file(path: str):
    """A pretraining model's state_dict (``_load_pretrain:773``): the port's
    ``st2vec.pt``, a reference Lightning checkpoint (``.pt``/``.ckpt``), or
    JAX trees in an ``.npz`` (``params/``, ``batch_stats/``, ``teacher/``)."""
    if os.path.isdir(path):
        raise NotImplementedError(f"{path}: orbax checkpoints are not ported yet")
    if path.endswith(".npz"):
        return st2vec_from_jax(*load_jax_npz(path, ("params", "batch_stats", "teacher")))
    return torch.load(path, map_location="cpu", weights_only=True)


class SpiralFinetuneRunner:
    """Single-device CTC finetuning and serving."""

    def __init__(self, cfg, log_dir: str, tokenizer, device="cuda"):
        self.cfg = cfg
        m = cfg.model
        self.enc_cfg = m.encoder
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
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
        self.iteration = 0  # optimizer updates
        self.history = []  # per-step metrics, floats
        self._micro = []  # micro-batches of the next update (kept across epochs)

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

    def load_weights(self, path: str) -> None:
        self.load_state_dict(load_state_dict_file(path))

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
        return DataLoader(
            dataset, ds.batch_size, AudioTextBatchCollate(self.max_samples, 512),
            shuffle=ds.shuffle, num_workers=ds.num_workers,
        )

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
        with open(os.path.join(self.log_dir, "train.log"), "a") as f:
            f.write(msg + "\n")
        return loss

    def validate(self) -> dict:
        """Validation WER/CER over ``validation_ds`` (``validate:941``)."""
        ds_cfg = self.cfg.model.validation_ds
        if ds_cfg is None:
            return {}
        results = self.evaluate(manifest=ds_cfg.manifest_filepath, ds_cfg=ds_cfg)
        with open(os.path.join(self.log_dir, "train.log"), "a") as f:
            f.write(f"Validation: WER = {results['wer']:.4f} | "
                    f"CER = {results['cer']:.4f}\n")
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


class SpiralPretrainRunner:
    """Single-device SPIRAL pretraining over a manifest."""

    def __init__(self, cfg, log_dir: str, device="cuda", seed: int = 0):
        self.cfg = cfg
        m = cfg.model
        self.enc_cfg = m.encoder
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
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
        self.iteration = 0  # optimizer updates
        self.history = []  # per-step metrics, floats
        # micro-batches of the next update and their audio seconds (kept
        # across epochs; the seconds count when the update consumes them)
        self._micro, self._micro_sec = [], 0.0

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
        with open(os.path.join(self.log_dir, "train.log"), "a") as f:
            f.write(msg + "\n")
        return loss

    def save_state_dict(self, name: str = "st2vec.pt") -> str:
        """The model's reference-named state_dict (student, predictor BN
        statistics, ``target_*`` teacher), loadable by
        ``tpu_speech.compat.torch_spiral.convert_st2vec``."""
        path = os.path.join(self.log_dir, name)
        torch.save({k: v.detach().cpu() for k, v in self.state.model.state_dict().items()},
                   path)
        return path
