"""The ranks of ``tests/test_torch_ddp.py``: two gloo processes on the CPU.

``run(rank, root)`` reads ``root/job.pt`` (the tiny configs, weights and
global batches the test made from numpy seeds), joins a two-rank process group
at a ``file://`` store under ``root``, runs every check of ``CHECKS`` on its
slice of each global batch and saves what it saw to ``root/rank<r>.pt``. It
imports torch and the port only (the spawned process starts fast; JAX stays in
the test process).
"""

from __future__ import annotations

import copy
import os

import torch

from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder
from tpu_speech_torch.parallel import distributed, mesh
from tpu_speech_torch.text.tokenizers import CharTokenizer
from tpu_speech_torch.train import optim
from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
from tpu_speech_torch.train.spiral import batch_to_device, make_pretrain_state, pretrain_step
from tpu_speech_torch.train.spiral_runner import (
    SpiralFinetuneRunner,
    SpiralPretrainRunner,
    build_model,
)


def _rows(x, rank, world):
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


def _place(model, fsdp, bf16=False):
    if fsdp:
        mesh.shard_state_fsdp(mesh.make_mesh(), model, bf16=bf16)
    else:
        mesh.replicate(model)
    return model


def _host_sd(model):
    return {k: v.detach().cpu().clone() for k, v in mesh.full_state_dict(model).items()}


def _pretrain(job, rank, world, fsdp=False, bf16=False, accum=1, adamw=False,
              cfg_key="pre_cfg", steps=None):
    """pretrain_step on this rank's rows of the job's global batch(es)."""
    cfg = job[cfg_key]
    model = ST2VecEncoder(cfg.model.encoder, pretraining=True)
    model.load_state_dict(job["pre_sd"], strict=True)
    _place(model, fsdp, bf16)
    make_opt = ((lambda ps: optim.make_optimizer(cfg.model.optim, ps, 100)) if adamw
                else (lambda ps: torch.optim.SGD(ps, lr=1.0, foreach=False)))
    state = make_pretrain_state(model, make_opt)
    b = len(job["pre_batch"]["wavs"]) // world
    out = {"loss": [], "acc": [], "layers": [], "bytes": []}
    for i, (batch, neg) in enumerate(steps or [(job["pre_batch"], job["pre_neg"])]):
        rng = DropoutRng.seeded(i, "cpu", rank=rank, row0=rank * b)
        if accum > 1:  # stacked (accum, B, ...) leaves; negatives a list
            micro = mesh.shard_microbatches(batch, rank, world)
            mbs = [batch_to_device({k: v[j] for k, v in micro.items()}, "cpu")
                   for j in range(accum)]
            negs = [None if n is None else _rows(n, rank, world) for n in neg]
            m = pretrain_step(state, mbs, rng, grad_clip=job["clip"], bf16=bf16,
                              accum_steps=accum, neg_idx=negs)
        else:
            m = pretrain_step(state, batch_to_device(mesh.shard_batch(batch, rank, world), "cpu"),
                              rng, grad_clip=job["clip"], bf16=bf16,
                              neg_idx=None if neg is None else _rows(neg, rank, world))
        out["loss"].append(float(m["loss"]))
        out["acc"].append(float(m["accuracy"]))
        out["layers"].append((m["teacher_layers"], m["student_layers"]))
        out["bytes"].append(m["allreduce_bytes"])
    out["sd"] = _host_sd(model)
    out["sharded"] = sorted(n for n, p in model.named_parameters() if mesh.is_sharded(p))
    return out


def _finetune(job, rank, world, fsdp=False):
    """Two AdamW finetune steps across the freeze gate (step 0 frozen)."""
    cfg = job["ft_cfg"]
    model = build_model(cfg, 28)
    model.load_state_dict(job["ft_sd"], strict=True)
    _place(model, fsdp)
    state = make_finetune_state(model, lambda ps: optim.make_optimizer(job["ft_optim"], ps, 100))
    losses = []
    for i, batch in enumerate(job["ft_batches"]):
        b = len(batch["wavs"]) // world
        m = finetune_step(state, batch_to_device(mesh.shard_batch(batch, rank, world), "cpu"),
                          DropoutRng.seeded(i, "cpu", rank=rank, row0=rank * b),
                          freeze_encoder=i < 1)
        losses.append(float(m["loss"]))
    return {"loss": losses, "sd": _host_sd(model)}


def _streams(job, rank, world):
    rng = DropoutRng.seeded(3, "cpu", rank=rank, row0=rank * 2)
    return {"host": [rng.attention_seed() for _ in range(4)] + [rng.keep_layer(0.5)
                                                                 for _ in range(8)],
            "device": torch.rand(8, generator=rng.device), "row0": rng.row0}


def _evaluate(job, rank, world, fsdp_bf16=False):
    """Test-mode evaluation of the job's weights over the corpus (5
    utterances, batches of 2: rank 0 decodes one batch more than rank 1).
    With ``fsdp_bf16`` the runner's model is first sharded for bf16
    training, as a finetune run's validation finds it."""
    cfg = copy.deepcopy(job["eval_cfg"])
    cfg.trainer.fsdp = fsdp_bf16
    cfg.model.precision = "bf16" if fsdp_bf16 else "fp32"
    run = os.path.join(job["root"], "eval_fsdp" if fsdp_bf16 else "eval")
    runner = SpiralFinetuneRunner(cfg, run, CharTokenizer(cfg.model.labels), device="cpu")
    runner.load_state_dict(job["eval_sd"])
    if fsdp_bf16:
        runner.state  # noqa: B018 (builds the training half: shards the model)
        assert any(mesh.is_sharded(p) for p in runner.model.parameters())
    res = runner.evaluate(job["eval_manifest"], save_logits_dir=os.path.join(run, "logits"))
    return {k: res[k] for k in ("wer", "cer", "n", "ser", "hyps", "rank")}


def _validate(job, rank, world, fsdp=False):
    """A bf16 pretrain runner's validation before any step (DDP, or FSDP):
    float32 forwards on the whole weights either way."""
    cfg = copy.deepcopy(job["val_cfg"])
    cfg.trainer.fsdp = fsdp
    runner = SpiralPretrainRunner(cfg, os.path.join(job["root"], f"val_{fsdp}"), device="cpu")
    loss = runner.validate()
    return dict(runner.last_validation, loss=loss,
                sharded=any(mesh.is_sharded(p) for p in runner.state.model.parameters()))


def _runner_checkpoint(job, rank, world, fsdp):
    """A pretrain runner over the toy manifest: one epoch of two updates, its
    step checkpoint and state_dict (written by rank 0)."""
    cfg = copy.deepcopy(job["run_cfg"])
    cfg.trainer.fsdp = fsdp
    run = os.path.join(job["root"], "fsdp" if fsdp else "ddp")
    runner = SpiralPretrainRunner(cfg, run, device="cpu")
    runner.train_epoch(1, max_steps=2)
    runner.save_checkpoint(1)
    return {"dir": run, "state_dict": runner.save_state_dict(), "lr_scale": runner.lr_scale,
            "iteration": runner.iteration, "loss": [h["loss"] for h in runner.history],
            "sd": _host_sd(runner.state.model)}


CHECKS = {
    "pre_sgd": lambda j, r, w: _pretrain(j, r, w),
    "pre_sgd_fsdp": lambda j, r, w: _pretrain(j, r, w, fsdp=True),
    "pre_sgd_bf16": lambda j, r, w: _pretrain(j, r, w, bf16=True),
    "pre_sgd_fsdp_bf16": lambda j, r, w: _pretrain(j, r, w, fsdp=True, bf16=True),
    "pre_adamw_accum2": lambda j, r, w: _pretrain(j, r, w, accum=2, adamw=True,
                                                  steps=[(j["pre_micro"], j["pre_micro_neg"])]),
    "pre_dropout": lambda j, r, w: _pretrain(j, r, w, adamw=True, cfg_key="drop_cfg",
                                             steps=j["drop_steps"]),
    "ft_adamw": lambda j, r, w: _finetune(j, r, w),
    "ft_adamw_fsdp": lambda j, r, w: _finetune(j, r, w, fsdp=True),
    "streams": _streams,
    "evaluate": _evaluate,
    "evaluate_fsdp_bf16": lambda j, r, w: _evaluate(j, r, w, fsdp_bf16=True),
    "validate_bf16": _validate,
    "validate_fsdp_bf16": lambda j, r, w: _validate(j, r, w, fsdp=True),
    "ckpt_ddp": lambda j, r, w: _runner_checkpoint(j, r, w, False),
    "ckpt_fsdp": lambda j, r, w: _runner_checkpoint(j, r, w, True),
}


def run(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(os.path.join(root, "job.pt"), weights_only=False)
    mesh.MIN_SIZE = job["fsdp_min_size"]
    distributed.initialize(num_processes=job["world"], process_id=rank, device="cpu",
                           init_method="file://" + os.path.join(root, "store"))
    try:
        out = {name: CHECKS[name](job, rank, job["world"]) for name in job["checks"]}
    finally:
        distributed.shutdown()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
