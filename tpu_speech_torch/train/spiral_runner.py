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
longer than ``max_duration``) and ``evaluate:1134`` (greedy CTC decode, or
prefix beam search with an optional n-gram LM on the host,
``eval/ctc_beam.py``; WER/CER and the per-utterance HTML diagnosis).
Training (``:569-959``): the pretrained encoder from
``model.pretrain_chkpt_path`` (``_load_pretrain:773``), ``AudioToTextDataset``
with ``dup_factor``, ``AudioTextBatchCollate(max samples, 512)`` and
``DataLoader``, the host generator ``default_rng(1)``
(``:709-711``) and its spec masks (``_train_masks:871``), the int16 wire
(``_device_batches:890``), AdamW with the lr rescale (``:724-733``),
``finetune_step`` with the freeze gate decided from the iteration counter,
``train_epoch:914`` (metrics read back once per epoch), ``validate:941`` and
a reference-named ``state_dict`` and an archive at the end; bf16 and
accumulation as the pretrain runner (``:890-929``). Host-side data,
tokenizers and scoring are the port's own copies of the JAX package's
modules (``data/``, ``text/``, ``eval/wer.py``, ``eval/ctc_beam.py``).

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

``transcribe_streaming:1017`` and ``evaluate_streaming:1043`` decode a
streaming-mode model chunk by chunk (``models/spiral/streaming.py``).

Data parallelism (``parallel/``; the JAX runners' mesh, ``:109-238``,
``:580-744``, ``:1160-1218``): one process a card, rank r of N. The loaders
take ``shard_id=r, num_shards=N`` (``batch_size`` is per device, so the
global batch is ``batch_size x N``), the lr rescale counts N
(``lr_scale(m, N, accum)``), the host mask generators are
``default_rng(r)`` (pretraining) and ``default_rng(1 + r)`` (finetuning), as
JAX seeds them by process index, and the dropout generators are
``DropoutRng.seeded(seed, device, rank=r, row0=r x batch_size)``. Before the
optimizer is built, ``trainer.fsdp`` shards the model with FSDP2
(``parallel/mesh.py::shard_state_fsdp``); otherwise every rank takes rank 0's
weights. Only rank 0 writes TensorBoard, ``train.log``, the step
checkpoints, the state_dict and the archive, each write followed by a
barrier; under FSDP the whole state is gathered first, so the files are those
of a one-device run. A step checkpoint of N ranks also holds each rank's
generators, loader state and buffered micro-batches (``ranks``), so N ranks
resume where they stopped; one process resumes from it as rank 0, and N
ranks resume from a one-device file with fresh generators on ranks 1..N-1.
``evaluate`` decodes ``entries[r::N]`` and sums the six error counts over
the ranks (``allreduce_sum``): every rank returns the WER of one process.
Under FSDP, validation, evaluation and serving run on a float32 copy with
the whole weights (``_plain_model``), gathered once a call.

Sequence parallelism (``trainer.seq_parallel`` S > 1, pretraining only,
``:109-117``): the mesh is (data, seq) of N / S by S ranks
(``parallel/mesh.py::make_mesh``). A data group's S ranks read the same
rows: the loader shards over the data index d of N / S, the global batch is
``batch_size x N / S``, the lr rescale counts N / S, the host generators and
the dropout generators are seeded by d (``row0 = d x batch_size``), and the
step runs the towers on each rank's T / S frames (``train/spiral.py``). The
group's first rank makes each device batch (the crops, the noise, the masks
and shifts) and sends it to the others (``seq.broadcast_batch``): the
loader's draws depend on its threads' timing, so S loaders of one shard do
not give the same audio. The finetune runner raises for S > 1, as the JAX
one does.

The data options (``:142-163``, ``:605-681``): ``train_ds.tarred_audio_filepaths``
streams the training audio from tar shards (``TarredAudioDataset``, the
shards split over the data ranks, a ``shuffle_n`` reservoir; ``_TarLoader``);
the finetune runner's ``train_ds.num_buckets`` > 1 draws each batch from one
duration bucket padded to its bound (``BucketedDataLoader``: quantile bounds
snapped up to quarter seconds, the label capacity scaled with the bound, runs
of ``accumulate_grad_batches`` batches of one bucket), which tarred data
refuses; ``train_ds.wire_dtype`` ``mulaw`` ships 8-bit mu-law waves
(``quantize_wire``), which ``wav_to_spec`` expands on the device.

Not ported: orbax checkpoints and the native C++ batcher.
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
from tpu_speech_torch.data.loader import BucketedDataLoader, DataLoader
from tpu_speech_torch.data.spiral import (
    AudioAugmentor,
    AudioBatchCollate,
    AudioDataset,
    AudioTextBatchCollate,
    AudioToTextDataset,
    RandomNoisePerturbation,
    TarredAudioDataset,
    read_manifest,
)
from tpu_speech_torch.data.wav import read_wav
from tpu_speech_torch.eval.ctc_beam import ctc_beam_search_batch
from tpu_speech_torch.eval.wer import ctc_greedy_decode, error_counts, render_wer_html
from tpu_speech_torch.models.spiral.ctc import CTCFinetuneModel, load_pretrained_encoder
from tpu_speech_torch.models.spiral.masking import make_student_masks
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, wav_to_spec
from tpu_speech_torch.models.spiral.streaming import StreamingTranscriber
from tpu_speech_torch.parallel import distributed, seq
from tpu_speech_torch.parallel.mesh import (
    full_state_dict,
    full_tensor,
    is_sharded,
    load_full_,
    data_axis,
    load_state_dict_,
    make_mesh,
    replicate,
    shard_state_fsdp,
)
from tpu_speech_torch.text.tokenizers import BlankOffsetTokenizer
from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
from tpu_speech_torch.train.optim import lr_scale, make_optimizer
from tpu_speech_torch.train.spiral import (
    batch_to_device,
    host_augment_batch,
    make_pretrain_state,
    pretrain_step,
    quantize_wire,
    validation_loss,
)
from tpu_speech_torch.utils.archive import load_archive, save_archive
from tpu_speech_torch.utils.checkpoint import Checkpointer, _to_host
from tpu_speech_torch.utils.device import resolve_device
from tpu_speech_torch.utils.surgery import merge_params

# reference-checkpoint buffers that are constants here, under any task-model
# prefix (the JAX converter drops them the same way,
# compat/torch_spiral.py:200-204)
_REFERENCE_CONSTANTS = ("mask_emb", "wav2spec.featurizer.window", "wav2spec.featurizer.fb")

TARRED_BUCKETS = ("train_ds.num_buckets requires random-access manifests; tarred shards "
                  "stream in order (one static shape)")


class _TarLoader:
    """A tarred dataset's batches in stream order (the JAX runners'
    ``_TarLoader``, ``spiral_runner.py:155-163``), with the loader surface
    the checkpoints read (``dataset``, ``_epoch``, ``set_epoch``)."""

    def __init__(self, dataset: TarredAudioDataset, batch_size: int, collate):
        self.dataset, self.batch_size, self.collate = dataset, batch_size, collate
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        self._epoch += 1
        return self.dataset.iter_batches(self.batch_size, self.collate)

    def __len__(self):
        return len(self.dataset) // self.batch_size


def bucket_bounds(durations, max_samples: int, sample_rate: int, num_buckets: int) -> list:
    """The finetune runner's bucket bounds in seconds (``:660-670``):
    quantiles of the durations snapped up to quarter seconds (near-equal
    ones collapse), the last at the max duration."""
    qs = np.quantile(np.asarray(durations, dtype=np.float64),
                     np.arange(1, num_buckets + 1) / num_buckets)
    max_dur = max_samples / sample_rate
    bounds = sorted(set(min(max_dur, float(np.ceil(q * 4.0) / 4.0)) for q in qs))
    bounds[-1] = max_dur
    return bounds


def bucket_collate(bound_samples: int, max_samples: int) -> AudioTextBatchCollate:
    """A bucket's collate (``:672-675``): the label capacity of 512 scaled
    with the bucket's bound, at least 64, in multiples of 32."""
    cap = -(-512 * bound_samples // max_samples)  # ceil-scale
    return AudioTextBatchCollate(bound_samples, int(max(64, (cap + 31) // 32 * 32)))


SEQ_FINETUNE = ("trainer.seq_parallel is a pretrain-only knob (the 250k-sample crops); the "
                "CTC finetune step does not implement it")


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
    weight), ``_new_model`` (a fresh module of its class), ``state`` (its
    optimizer and step count), ``rng``, ``host_rng``, ``_micro``,
    ``_to_jax``/``_from_jax`` (its state_dict <-> flax trees,
    ``compat/jax_spiral.py``), ``_npz_roots``, ``archive_default`` and
    ``_extra_state``/``_load_extra_state`` for what else resumes."""

    def _init_run(self, cfg, log_dir: str, exp, ckpt_dir: str) -> str:
        self.cfg = cfg
        self.exp = exp
        if exp is not None:
            log_dir = exp.log_dir
        self.log_dir = log_dir
        self.rank, self.world = distributed.process_index(), distributed.process_count()
        self.primary = self.rank == 0
        self.fsdp = bool(getattr(cfg.trainer, "fsdp", False))
        os.makedirs(log_dir, exist_ok=True)
        self.tb = exp.tb if exp is not None and self.primary else None
        # --chkpt_dir relocates the step checkpoints (JAX runner :237-239)
        self.ckpt = Checkpointer(ckpt_dir or os.path.join(log_dir, "ckpt"))
        self.epoch = 0  # epochs completed (the one the latest checkpoint ended)
        self.iteration = 0  # optimizer updates
        self.history = []  # per-step metrics, floats
        return log_dir

    def _log(self, msg: str, echo: bool = False) -> None:
        """A line of ``train.log`` (and of stdout with ``echo``), on the
        primary only."""
        if not self.primary:
            return
        if echo:
            print(msg, flush=True)
        with open(os.path.join(self.log_dir, "train.log"), "a") as f:
            f.write(msg + "\n")

    def _data_parallel(self, model: torch.nn.Module) -> torch.nn.Module:
        """Place ``model`` for the ranks, before its optimizer is built:
        ``trainer.fsdp`` shards it over the data mesh (a one-rank mesh in a
        one-process run), otherwise every rank takes rank 0's weights."""
        if self.fsdp:
            distributed.initialize(device=self.device)  # a no-op when already joined
            shard_state_fsdp(make_mesh(), model, bf16=self.bf16)
        else:
            replicate(model)
        return model

    def _plain_model(self) -> torch.nn.Module:
        """The model that forwards outside the training step run (validation,
        evaluation, serving, export): ``_weights``, or under FSDP a plain
        copy of it with the whole float32 weights (a gather: every rank
        calls it). So those forwards run in float32 under ``--fsdp`` with
        bf16 too, as they do in a DDP or one-process run (FSDP's bf16
        policy casts every forward of the sharded model), and make no
        collective: ranks whose shards of an evaluation set differ in
        batch count never pair mismatched all-gathers."""
        model = self._weights
        if not any(is_sharded(p) for p in model.parameters()):
            return model
        with torch.random.fork_rng(devices=[]):  # the copy's init draws nothing seen
            plain = self._new_model()
        plain.load_state_dict(full_state_dict(model), strict=True)
        return plain.to(self.device).train(model.training)

    def _write(self, fn, *args):
        """``fn(*args)`` on the primary (a file write), then a barrier."""
        out = fn(*args) if self.primary else None
        distributed.barrier()
        return out

    # ---- step checkpoints and resume --------------------------------------

    def _rank_state(self) -> dict:
        """What differs between ranks: the dropout generators, the host
        mask generator, the micro-batches buffered for the next update, and
        the runner's own extras (the loader, the crops)."""
        out = {"rng_host": self.rng.host.get_state(),
               "rng_device": self.rng.device.get_state(),
               "host_rng": self.host_rng.bit_generator.state,
               "micro": list(self._micro)}
        out.update(self._extra_state())
        return out

    def _load_rank_state(self, st: dict) -> None:
        self.rng.host.set_state(st["rng_host"])
        self.rng.device.set_state(st["rng_device"])
        self.host_rng.bit_generator.state = st["host_rng"]
        self._micro = _to_device(st["micro"], self.device)
        self._load_extra_state(st)

    def checkpoint_state(self) -> dict:
        """What a step checkpoint holds: the model's state_dict (float32
        masters, the EMA teacher, BatchNorm statistics), the optimizer's
        state by key and parameter name (AdamW's ``mu`` and ``nu``) and its
        count, the step counts and the epoch, and
        ``_rank_state`` (rank 0's; over N ranks also every rank's, under
        ``ranks``). Sharded tensors are gathered whole: every rank calls
        it."""
        model, opt = self._weights, self.state.optimizer
        names = {p: n for n, p in model.named_parameters()}
        out = {"model": full_state_dict(model), "count": opt.count, "step": self.state.step,
               "iteration": self.iteration, "epoch": self.epoch}
        for key in opt.STATE:  # AdamW's "mu" and "nu", by parameter name
            out[key] = {names[p]: full_tensor(st[key]) for p, st in opt.state.items()}
        mine = self._rank_state()
        out.update(mine)
        if self.world > 1:
            out["ranks"] = [None] * self.world
            torch.distributed.all_gather_object(out["ranks"], _to_host(mine))
        return out

    def load_checkpoint_state(self, st: dict) -> None:
        """Resume from ``checkpoint_state``'s dict: the same number of
        ranks takes each rank's part; one process takes rank 0's; N ranks
        from a one-process file keep fresh generators on ranks 1..N-1 and
        drop the buffered micro-batches (only rank 0 would have them)."""
        model, opt = self._weights, self.state.optimizer
        load_state_dict_(model, st["model"])
        params = dict(model.named_parameters())
        opt.state.clear()
        for name in st[opt.STATE[0]] if opt.STATE else ():
            p = params[name]
            opt.state[p] = {key: opt.init_state(key, p) for key in opt.STATE}
            for key in opt.STATE:
                load_full_(opt.state[p][key], st[key][name])
        opt.count = int(st["count"])
        self.state.step = int(st["step"])
        self.iteration, self.epoch = int(st["iteration"]), int(st["epoch"])
        ranks = st.get("ranks") or [st]
        if len(ranks) == self.world:
            self._load_rank_state(ranks[self.rank])
        elif self.world == 1:
            self._load_rank_state(st)
        else:
            if self.rank == 0:
                self._load_rank_state(st)
            self._micro = []
            self._load_extra_state({k: st[k] for k in ("loader_epoch",)}, partial=True)

    def save_checkpoint(self, epoch: int) -> None:
        """Checkpoint the run as it stands at the end of ``epoch``: the state
        is copied to host memory here and written on the Checkpointer's
        thread (the next save, or ``ckpt.wait``, drains it); over N ranks
        rank 0 writes it before the barrier."""
        self.epoch = epoch
        state = self.checkpoint_state()
        if self.world == 1:
            self.ckpt.save(self.iteration, state)
            return
        if self.primary:
            self.ckpt.save(self.iteration, state)
            self.ckpt.wait()
        distributed.barrier()

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
        return self._to_jax(full_state_dict(self._weights))

    def save_archive(self) -> str:
        """``<log_dir>/<cfg.name>.tpu_speech``: the config, the params tree and
        the other trees (``batch_stats``, and ``teacher`` when pretraining);
        written by the primary."""
        trees = self.weight_trees()
        params = trees.pop("params")
        path = os.path.join(self.log_dir, f"{self.cfg.name or self.archive_default}.tpu_speech")
        self._write(save_archive, path, self.cfg, params, trees)
        return path

    def _save_weights(self, name: str) -> str:
        """The model's whole state_dict at ``<log_dir>/name``, written by the
        primary."""
        path = os.path.join(self.log_dir, name)
        sd = {k: v.detach().cpu() for k, v in full_state_dict(self._weights).items()}
        self._write(torch.save, sd, path)
        return path

    def _restore_trees(self, params, extra: dict, partial: bool, skip, what: str):
        """Merge a source's params into the model's by flax path (strict
        unless ``partial``; ``skip`` patterns keep the model's leaves); the
        other trees are taken whole where the source has them. Step counts
        and the optimizer stay as they are."""
        trees = self.weight_trees()
        merged, report = merge_params(trees["params"], params, partial=partial, skip=skip)
        if self.primary:
            print(f"{what} restore: {report.summary()}")
        trees = {k: (extra[k] if extra.get(k) else v) for k, v in trees.items()}
        trees["params"] = merged
        load_state_dict_(self._weights, self._from_jax(trees))
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



class InferenceGraph(torch.nn.Module):
    """wav -> ``wav_to_spec`` -> ``CTCFinetuneModel`` -> (log-probs, lengths),
    the graph that ``SpiralFinetuneRunner.export_model`` traces (the JAX
    runner's ``infer`` of ``export_model:1111``)."""

    def __init__(self, model: CTCFinetuneModel, enc_cfg):
        super().__init__()
        self.model, self.enc_cfg = model, enc_cfg

    def forward(self, wavs, wav_lens):
        specs, spec_lens = wav_to_spec(self.enc_cfg, wavs, wav_lens)
        return self.model(specs, spec_lens)


class SpiralFinetuneRunner(_Runner):
    """Single-device CTC finetuning and serving."""

    archive_default = "ctc_finetune"
    _npz_roots = ("params", "batch_stats")

    def __init__(self, cfg, log_dir: str, tokenizer, device="cuda", exp=None,
                 ckpt_dir: str = ""):
        """exp: an optional ``utils/exp_manager.py::ExpManager`` that owns the
        run directory and the TensorBoard writer; ckpt_dir: the step
        checkpoints' directory (default ``<log_dir>/ckpt``)."""
        if max(1, getattr(cfg.trainer, "seq_parallel", 1)) > 1:
            raise ValueError(SEQ_FINETUNE)
        log_dir = self._init_run(cfg, log_dir, exp, ckpt_dir)
        m = cfg.model
        self.enc_cfg = m.encoder
        self.device = distributed.rank_device(resolve_device(device))
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

    def _new_model(self) -> CTCFinetuneModel:
        return build_model(self.cfg, self.tokenizer.vocab_size)

    @staticmethod
    def _to_jax(state_dict) -> dict:
        return dict(zip(("params", "batch_stats"), ctc_finetune_to_jax(state_dict)))

    @staticmethod
    def _from_jax(trees):
        return ctc_finetune_from_jax(trees["params"], trees["batch_stats"])

    def _extra_state(self) -> dict:
        return {"loader_epoch": self.loader._epoch,
                "dataset_rng": self.loader.dataset.rng.getstate()}

    def _load_extra_state(self, st: dict, partial: bool = False) -> None:
        self._loader_resume = (st["loader_epoch"], None if partial else st["dataset_rng"])
        if "loader" in self.__dict__:
            self._apply_loader_resume()

    def _apply_loader_resume(self):
        if self._loader_resume is not None:
            epoch, crop_rng = self._loader_resume
            self.loader.set_epoch(epoch)
            if crop_rng is not None:
                self.loader.dataset.rng.setstate(crop_rng)
            self._loader_resume = None

    # the training half is built at first use: serving needs no optimizer,
    # dropout generator, mask generator or training manifest

    @functools.cached_property
    def state(self):
        m = self.cfg.model
        total_steps = m.optim.sched.max_steps if m.optim.sched else 80000
        scale = lr_scale(m, data_parallel=self.world, accum=self.accum)
        return make_finetune_state(
            self._data_parallel(self.model),
            lambda params: make_optimizer(m.optim, params, total_steps, scale))

    @functools.cached_property
    def rng(self):
        return DropoutRng.seeded(0, self.device, rank=self.rank,
                                 row0=self.rank * self.cfg.model.train_ds.batch_size)

    @functools.cached_property
    def host_rng(self):
        return np.random.default_rng(1 + self.rank)  # 1 + process index

    def load_state_dict(self, state_dict) -> None:
        load_state_dict_(self.model, state_dict)

    def _graph(self, model: Optional[CTCFinetuneModel] = None) -> InferenceGraph:
        """The wav -> log-probs composition that ``infer`` runs and
        ``export_model`` traces, on ``model`` (by default ``_plain_model()``)
        in eval mode."""
        model = self._plain_model() if model is None else model
        return InferenceGraph(model.eval(), self.enc_cfg)

    @torch.inference_mode()
    def infer(self, wavs, wav_lens, model: Optional[CTCFinetuneModel] = None):
        """wavs (B, N) float32 / int16 / uint8, lengths (B,) -> (log_probs
        (B, T, V), lens (B,)) on the runner's device, in eval mode, on
        ``model`` (``evaluate`` passes the ``_plain_model()`` it gathered
        once)."""
        wavs = torch.as_tensor(wavs).to(self.device)
        wav_lens = torch.as_tensor(wav_lens).to(self.device)
        return self._graph(model)(wavs, wav_lens)

    def export_model(self, path: str, n_samples: Optional[int] = None) -> str:
        """Save the wav -> log-probs inference graph as a ``torch.export``
        program (``utils/export.py``; the JAX runner's StableHLO
        ``export_model:1111``) at ``path``, traced on the runner's device in
        eval mode for wavs of ``n_samples`` (default ``max_samples``) with
        the batch dynamic. K1, K2's forward and K4 stay in the graph as the
        ``tpu_speech::`` ops; ``load_exported`` runs it."""
        from torch.export import Dim

        from tpu_speech_torch.utils.export import export_fn

        n = n_samples or self.max_samples
        # two rows: a batch of one would fix the batch dimension at 1
        example = (torch.zeros((2, n), device=self.device),
                   torch.full((2,), n, dtype=torch.int32, device=self.device))
        batch = Dim("batch", min=1)
        export_fn(self._graph(), example, path,
                  dynamic_shapes=({0: batch}, {0: batch}))
        return path

    def _decode(self, log_probs, lens, beam_width: int = 1, lm=None,
                lm_alpha: float = 0.5):
        """(B, T, V) log-probs and lengths, numpy or tensors -> label
        sequences: greedy, or CTC prefix beam search (``eval/ctc_beam.py``)
        with ``beam_width`` > 1, shallow-fused with ``lm`` at ``lm_alpha``.
        On the host, as in the JAX runner."""
        log_probs, lens = (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                           for x in (log_probs, lens))
        if beam_width > 1:
            return ctc_beam_search_batch(log_probs, lens, blank=self.model.blank_idx,
                                         beam_width=beam_width, lm=lm, alpha=lm_alpha)
        return ctc_greedy_decode(log_probs, lens, self.model.blank_idx)

    def transcribe(self, audio_paths, batch_size: int = 4,
                   overlap_s: float = 3.2, beam_width: int = 1,
                   lm=None, lm_alpha: float = 0.5):
        """Decode wav files -> texts (``transcribe:961``): greedy, or prefix
        beam search with ``beam_width`` > 1 and an optional ``lm`` (see
        ``_decode``). Audio longer than ``max_duration`` runs as overlapping
        windows stitched at the overlap midpoints (``_chunked_log_probs``)."""
        decode = functools.partial(self._decode, beam_width=beam_width, lm=lm,
                                   lm_alpha=lm_alpha)
        texts = [None] * len(audio_paths)
        short = []
        for pos, path in enumerate(audio_paths):
            wav, sr = read_wav(path)
            if sr != self.sample_rate:
                raise ValueError(f"{path}: sample rate {sr} != {self.sample_rate}")
            if len(wav) > self.max_samples:
                lp = self._chunked_log_probs(wav, overlap_s)
                ids = decode(lp[None], np.array([lp.shape[0]]))[0]
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
            ids = decode(*self.infer(padded, lens))
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
                 save_logits_dir: Optional[str] = None, ds_cfg=None,
                 beam_width: int = 1, lm=None, lm_alpha: float = 0.5) -> dict:
        """Test-mode WER/CER (spiral_runner.py:1134): greedy decoding, or
        prefix beam search with ``beam_width`` > 1 shallow-fused with ``lm``
        (e.g. an ``NGramLM`` fit in the model's id space) at ``lm_alpha``.
        ``decode_s`` in the result is the host's decode time over the run.

        Over N ranks each decodes the round-robin shard ``entries[r::N]``
        (``:1160-1164``) and the six error counts are summed over the ranks
        (``:1215-1218``), so every rank returns the one-process WER, CER,
        ``n`` and SER; ``hyps``, ``decode_s`` (beside ``rank``) and the HTML
        diagnosis (written by the primary) cover the rank's own shard. With
        ``save_logits_dir`` a rank's files are ``logits_r<rank>_<n>.npy``
        (one process keeps ``logits_<n>.npy``): in JAX every process writes
        ``logits_<n>.npy`` into the same directory."""
        m = self.cfg.model
        ds_cfg = ds_cfg or m.test_ds or m.validation_ds
        manifest = manifest or ds_cfg.manifest_filepath
        dataset = AudioToTextDataset(
            manifest, self.tokenizer, sample_rate=ds_cfg.sample_rate,
            crop_size=self.max_samples,
        )
        if self.world > 1:
            dataset.entries = dataset.entries[self.rank::self.world]
        tag = f"r{self.rank}_" if self.world > 1 else ""
        loader = DataLoader(
            dataset, ds_cfg.batch_size, AudioTextBatchCollate(self.max_samples, 512),
            shuffle=False, drop_last=False, num_workers=ds_cfg.num_workers,
        )
        hyps, refs = [], []
        decode_s = 0.0
        model = self._plain_model()
        for raw in loader:
            log_probs, lens = self.infer(raw["wavs"], raw["wav_lens"], model)
            log_probs, lens = log_probs.cpu().numpy(), lens.cpu().numpy()  # one copy a batch
            t0 = time.perf_counter()
            ids = self._decode(log_probs, lens, beam_width, lm, lm_alpha)
            decode_s += time.perf_counter() - t0
            for seq, text in zip(ids, raw["texts"]):
                hyps.append(self.tokenizer.ids_to_text(seq))
                refs.append(text)
            if save_logits_dir:
                os.makedirs(save_logits_dir, exist_ok=True)
                np.save(os.path.join(save_logits_dir, f"logits_{tag}{len(hyps)}.npy"),
                        log_probs)
        w_err, w_tot = error_counts(hyps, refs)
        c_err, c_tot = error_counts(hyps, refs, use_cer=True)
        err_utts = sum(1 for h, r in zip(hyps, refs) if h.split() != r.split())
        counts = distributed.allreduce_sum(
            np.array([w_err, w_tot, c_err, c_tot, len(hyps), err_utts], np.int64))
        html_path = os.path.join(self.log_dir, "wer_diagnosis.html")
        self._write(render_wer_html, hyps, refs, html_path)
        return {
            "wer": counts[0] / max(counts[1], 1),
            "cer": counts[2] / max(counts[3], 1),
            "n": int(counts[4]),
            "ser": counts[5] / max(counts[4], 1),
            "diagnosis_html": html_path,
            "hyps": hyps,
            "decode_s": decode_s,
            "rank": self.rank,
        }


    def _require_streaming(self) -> None:
        if self.enc_cfg.streaming is None:
            raise ValueError("streaming transcription needs a streaming-mode model "
                             "(set encoder.streaming=StreamingCfg(...) in the config)")

    def transcribe_streaming(self, audio_paths, feed_seconds: float = 0.5):
        """Chunk-incremental decode (``transcribe_streaming:1017``) through
        ``models/spiral/streaming.py::StreamingTranscriber``, fed
        ``feed_seconds`` of samples at a time: constant memory and bounded
        latency whatever the utterance's length. Needs a streaming-mode model
        (``encoder.streaming``), which serves exactly as it trains."""
        self._require_streaming()
        tr = StreamingTranscriber(self._plain_model().eval(), batch=1)
        feed = max(1, int(feed_seconds * self.sample_rate))
        texts = []
        for path in audio_paths:
            wav, sr = read_wav(path)
            if sr != self.sample_rate:
                raise ValueError(f"{path}: sample rate {sr} != {self.sample_rate}")
            tr.reset()
            for i in range(0, len(wav), feed):
                tr.feed(wav[None, i:i + feed])
            texts.append(self.tokenizer.ids_to_text(tr.flush()[0]))
        return texts

    def evaluate_streaming(self, manifest: Optional[str] = None,
                           feed_seconds: float = 0.5) -> dict:
        """Test-mode WER/CER decoded through the streaming transcriber
        (``evaluate_streaming:1043``): every utterance chunk by chunk with
        carried state, the deployment metric of a streaming model."""
        self._require_streaming()
        manifest = manifest or self.cfg.model.test_ds.manifest_filepath
        entries = read_manifest(manifest, 0.0, None)
        refs = [e["text"] for e in entries]
        hyps = self.transcribe_streaming([e["audio_filepath"] for e in entries],
                                         feed_seconds=feed_seconds)
        w_err, w_tot = error_counts(hyps, refs)
        c_err, c_tot = error_counts(hyps, refs, use_cer=True)
        return {"wer": w_err / max(w_tot, 1), "cer": c_err / max(c_tot, 1), "n": len(refs),
                "hyps": hyps}

    # ---- training ---------------------------------------------------------

    @functools.cached_property
    def loader(self):
        ds = self.cfg.model.train_ds
        num_buckets = max(1, getattr(ds, "num_buckets", 1))
        collate = AudioTextBatchCollate(self.max_samples, 512)
        if getattr(ds, "tarred_audio_filepaths", None):
            if num_buckets > 1:
                raise ValueError(TARRED_BUCKETS)
            dataset = TarredAudioDataset(
                ds.manifest_filepath, ds.tarred_audio_filepaths, ds.sample_rate,
                crop_size=self.max_samples, min_duration=ds.min_duration,
                max_duration=ds.max_duration, shuffle_n=getattr(ds, "shuffle_n", 0),
                shard_id=self.rank, num_shards=self.world, tokenizer=self.tokenizer)
            loader = _TarLoader(dataset, ds.batch_size, collate)
        else:
            dataset = AudioToTextDataset(
                ds.manifest_filepath, self.tokenizer, sample_rate=ds.sample_rate,
                crop_size=self.max_samples, min_duration=ds.min_duration,
                max_duration=ds.max_duration, dup_factor=getattr(ds, "dup_factor", 1),
            )
            kw = dict(shuffle=ds.shuffle, num_workers=ds.num_workers, shard_id=self.rank,
                      num_shards=self.world)
            if num_buckets > 1:
                durations = [e["duration"] for e in dataset.entries]
                loader = BucketedDataLoader(
                    dataset, ds.batch_size,
                    functools.partial(bucket_collate, max_samples=self.max_samples),
                    durations, bucket_bounds(durations, self.max_samples, ds.sample_rate,
                                             num_buckets),
                    ds.sample_rate, run_length=self.accum, **kw)
            else:
                loader = DataLoader(dataset, ds.batch_size, collate, **kw)
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
        batch = quantize_wire(batch, getattr(self.cfg.model.train_ds, "wire_dtype", "int16"))
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
        self._log(msg, echo=True)
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
        return self._save_weights(name)


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
        self.device = distributed.rank_device(resolve_device(device))
        self.mesh = None
        sp = max(1, getattr(cfg.trainer, "seq_parallel", 1))
        if sp > 1:
            distributed.initialize(device=self.device)  # a no-op when already joined
            self.mesh = make_mesh(seq_parallel=sp)
        self.seq = seq.from_mesh(self.mesh)
        # the data axis: the loader's shard, the generators and the lr
        # rescale count data groups, not ranks (one rank each without seq)
        self.data_rank, self.n_data = data_axis(self.mesh)
        self.accum = max(1, getattr(cfg.trainer, "accumulate_grad_batches", 1))
        self.bf16 = getattr(m, "precision", "fp32") == "bf16"
        self.wire = getattr(m.train_ds, "wire_dtype", "int16")

        aug = None
        noise_cfg = getattr(m, "noise_perturb", None)
        if noise_cfg is not None and noise_cfg.manifest_path:
            aug = AudioAugmentor([(1.0, RandomNoisePerturbation(
                noise_cfg.manifest_path, min_snr_db=noise_cfg.min_snr_db,
                max_snr_db=noise_cfg.max_snr_db, ratio=noise_cfg.ratio))])
        elif m.train_ds.noise_manifest:
            aug = AudioAugmentor([(1.0, RandomNoisePerturbation(m.train_ds.noise_manifest))])
        ds = m.train_ds
        collate = AudioBatchCollate(ds.crop_size)
        if getattr(ds, "tarred_audio_filepaths", None):
            self.dataset = TarredAudioDataset(
                ds.manifest_filepath, ds.tarred_audio_filepaths, ds.sample_rate, ds.crop_size,
                ds.min_duration, ds.max_duration, augmentor=aug, return_both=True,
                shuffle_n=getattr(ds, "shuffle_n", 0), shard_id=self.data_rank,
                num_shards=self.n_data)
            self.loader = _TarLoader(self.dataset, ds.batch_size, collate)
        else:
            self.dataset = AudioDataset(ds.manifest_filepath, ds.sample_rate, ds.crop_size,
                                        ds.min_duration, ds.max_duration, augmentor=aug,
                                        return_both=True)
            self.loader = DataLoader(self.dataset, ds.batch_size, collate, shuffle=ds.shuffle,
                                     num_workers=ds.num_workers, shard_id=self.data_rank,
                                     num_shards=self.n_data)
        self.spec_len = _spec_len(ds.crop_size, ds.sample_rate)

        # the student from a seeded generator (the JAX runner's PRNGKey(0)
        # init), the teacher a copy of its subset
        model = ST2VecEncoder(self.enc_cfg, pretraining=True)
        model.init_weights(torch.Generator().manual_seed(seed))
        total_steps = m.optim.sched.max_steps if m.optim.sched else 100000
        self.lr_scale = lr_scale(m, data_parallel=self.n_data, accum=self.accum)
        self.state = make_pretrain_state(
            self._data_parallel(model.to(self.device)),
            lambda params: make_optimizer(m.optim, params, total_steps, self.lr_scale))
        self.rng = DropoutRng.seeded(seed, self.device, rank=self.data_rank,
                                     row0=self.data_rank * ds.batch_size)
        self.host_rng = np.random.default_rng(self.data_rank)  # the process index
        # micro-batches of the next update and their audio seconds (kept
        # across epochs; the seconds count when the update consumes them)
        self._micro, self._micro_sec = [], 0.0
        self.last_validation = {}

    @property
    def _weights(self):
        return self.state.model

    def _new_model(self) -> ST2VecEncoder:
        return ST2VecEncoder(self.enc_cfg, pretraining=True)

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

    def _load_extra_state(self, st: dict, partial: bool = False) -> None:
        self.loader.set_epoch(st["loader_epoch"])
        if partial:
            return
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

    def device_batch(self, raw, micro: int = 0, wire: Optional[str] = None) -> dict:
        """A loader batch augmented and on the device in ``wire`` (the
        config's by default); under seq parallelism the group's first rank's
        batch on every rank of the group (the others' ``raw`` is unused)."""
        if self.seq is not None and self.seq.index > 0:
            return seq.broadcast_batch(None, self.seq, self.device)
        batch = quantize_wire(self._augment(raw, micro), wire or self.wire)
        batch = batch_to_device(batch, self.device)
        return batch if self.seq is None else seq.broadcast_batch(batch, self.seq, self.device)

    def step(self, batch) -> dict:
        return pretrain_step(self.state, batch, self.rng, grad_clip=self.cfg.model.grad_clip,
                             bf16=self.bf16, accum_steps=self.accum, mesh=self.mesh)

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
        self._log(msg, echo=True)
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
                          shuffle=False, num_workers=ds.num_workers,
                          shard_id=self.data_rank, num_shards=self.n_data)

    def validation_step(self, batch, neg_idx=None, model=None):
        """(loss, accuracy, collapse diagnostics) of one device batch
        (``train/spiral.py::validation_loss``) on ``model`` (by default
        ``_plain_model()``; ``validate`` passes the one it gathered once);
        the negatives are drawn from a generator seeded 0 for every batch, as
        JAX draws them with ``PRNGKey(0)``."""
        model = self._plain_model() if model is None else model
        if neg_idx is None:
            gen = torch.Generator(self.device).manual_seed(0)
            return validation_loss(model, batch, generator=gen)
        return validation_loss(model, batch, neg_idx=neg_idx)

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
        results, model = [], self._plain_model()
        for raw in self.val_loader:
            batch = self.device_batch(raw, wire="float32")
            results.append(self.validation_step(batch, model=model))
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
        return self._save_weights(name)
