"""The ranks of ``tests/test_torch_seq_parallel.py``: four gloo processes on
the CPU.

``run(rank, root)`` reads ``root/job.pt`` (the tiny pretrain config, its
weights, a global batch of 8 and JAX's negatives). First the ranks run as two
independent worlds of two (ranks 0-1 and 2-3, each a (data 1, seq 2) mesh):
the first holds the steps to one process and JAX and runs the unit checks of
``parallel/seq.py``; the second runs the step with dropout, layerdrop and
dither on. Then all four join one world for the (data 2, seq 2) and (data
1, seq 4) meshes and a pretrain runner at seq 2. Each rank saves what it saw
to ``root/rank<r>.pt``. A step check called without a mesh is the
one-process step on the whole batch. It imports torch and the port only.
"""

from __future__ import annotations

import copy
import os

import torch
import torch.nn.functional as F

from tpu_speech_torch.models.spiral.conv_layers import FlaxBatchNorm1d
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, draw_negative_indices
from tpu_speech_torch.parallel import distributed, mesh, seq
from tpu_speech_torch.train import optim
from tpu_speech_torch.train.spiral import batch_to_device, make_pretrain_state, pretrain_step
from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner


def _host_sd(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def pretrain(job, seq_parallel=0, kind="sgd", cfg_key="cfg"):
    """One pretrain step on this rank's data group's rows (all of them
    without a mesh): SGD(1) with the clip, AdamW, bf16 SGD, or ``dropout``
    (AdamW with dropout, layerdrop and dither on, the negatives drawn)."""
    cfg = job[cfg_key]
    model = ST2VecEncoder(cfg.model.encoder, pretraining=True)
    model.load_state_dict(job["sd"], strict=True)
    m = mesh.make_mesh(seq_parallel=seq_parallel) if seq_parallel else None
    d, n_data = mesh.data_axis(m) if m is not None else (0, 1)
    mesh.replicate(model)
    adamw = kind in ("adamw", "dropout")
    make_opt = ((lambda ps: optim.make_optimizer(cfg.model.optim, ps, 100)) if adamw
                else (lambda ps: torch.optim.SGD(ps, lr=1.0, foreach=False)))
    state = make_pretrain_state(model, make_opt)
    batch = mesh.shard_batch(job["batch"], d, n_data)
    b = len(batch["wavs"])
    neg = None if kind == "dropout" else job["neg"][d * b:(d + 1) * b]
    rng = DropoutRng.seeded(3, "cpu", rank=d, row0=d * b)
    out = pretrain_step(state, batch_to_device(batch, "cpu"), rng, grad_clip=job["clip"],
                        bf16=kind == "bf16", neg_idx=neg, mesh=m)
    return {"loss": float(out["loss"]), "acc": float(out["accuracy"]),
            "frames": out["frames"], "sd": _host_sd(model), "bytes": out["allreduce_bytes"],
            "layers": (out["teacher_layers"], out["student_layers"])}


def _unit_checks(job):
    """``parallel/seq.py``'s collectives and BatchNorm's moments on this
    rank's frames of whole tensors (every rank builds the same ones), with
    rank-dependent output weights for the backward."""
    sq = seq.from_mesh(mesh.make_mesh(seq_parallel=2))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 3, generator=g)
    t0, t1 = seq.frame_range(8, sq)
    w = torch.randn(2, 4 + 3, 3, generator=g) * (sq.index + 1)
    out = {"range": (t0, t1)}
    local = x[:, t0:t1].clone().requires_grad_()
    y = seq.halo(local, 1, 2, sq)
    (y * w).sum().backward()
    out["halo"] = (y.detach(), local.grad.clone())
    local = x[:, t0:t1].clone().requires_grad_()
    y = seq.gather_time(local, sq)
    (y * torch.randn(2, 8, 3, generator=g) * (sq.index + 1)).sum().backward()
    out["gather"] = (y.detach(), local.grad.clone())
    whole = x.clone().requires_grad_()
    y = seq.local_frames(whole, sq)
    (y * 2.0).sum().backward()
    out["local"] = (y.detach(), whole.grad.clone())
    bn = FlaxBatchNorm1d(3, eps=1e-3, momentum=0.01).train()
    local = x[:, t0:t1].transpose(1, 2).clone().requires_grad_()
    y = bn(local)
    (y * torch.randn(2, 3, 8, generator=g)[:, :, t0:t1]).sum().backward()
    out["bn"] = (y.detach(), local.grad.clone(), bn.running_mean.clone(),
                 bn.running_var.clone())
    lens = torch.tensor([8, 5])
    whole_idx = draw_negative_indices(lens, 8, 4, torch.Generator().manual_seed(1))
    with seq.sharded(sq):
        drawn = draw_negative_indices(lens, 8, 4, torch.Generator().manual_seed(1))
        out["negatives"] = (seq.keep_frames(drawn), whole_idx)
        out["positions"] = seq.positions(4, "cpu")
    return out


def _runner(job, rank):
    """A pretrain runner at seq 2 over the four ranks: a validation, then
    two updates; the device batches the steps were given are kept."""
    cfg = copy.deepcopy(job["run_cfg"])
    cfg.trainer.seq_parallel = 2
    runner = SpiralPretrainRunner(cfg, os.path.join(job["root"], "runner"), device="cpu")
    val = runner.validate()
    batches, step = [], runner.step

    def recording_step(batch):
        batches.append({k: v.clone() if torch.is_tensor(v) else v for k, v in batch.items()})
        return step(batch)

    runner.step = recording_step
    runner.train_epoch(1, max_steps=2)
    return {"lr_scale": runner.lr_scale, "data": (runner.data_rank, runner.n_data),
            "validation": (val, runner.last_validation),
            "shards": (runner.loader.shard_id, runner.loader.num_shards),
            "loss": [h["loss"] for h in runner.history], "iteration": runner.iteration,
            "frames": runner.history[0]["frames"], "batches": batches}


def _join(root, name, world, rank):
    distributed.initialize(num_processes=world, process_id=rank, device="cpu",
                           init_method="file://" + os.path.join(root, name))


def run(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(os.path.join(root, "job.pt"), weights_only=False)
    out = {}
    pair = rank // 2
    _join(root, f"pair{pair}", 2, rank % 2)
    try:
        if pair == 0:
            out["s2_sgd"] = pretrain(job, 2)
            out["s2_adamw"] = pretrain(job, 2, "adamw")
            out["s2_bf16"] = pretrain(job, 2, "bf16")
            out["units"] = _unit_checks(job)
        else:
            out["s2_dropout"] = pretrain(job, 2, "dropout", cfg_key="drop_cfg")
    finally:
        distributed.shutdown()
    _join(root, "four", 4, rank)
    try:
        out["d2s2_sgd"] = pretrain(job, 2)
        out["d2s2_adamw"] = pretrain(job, 2, "adamw")
        out["d1s4_sgd"] = pretrain(job, 4)
        out["runner"] = _runner(job, rank)
    finally:
        distributed.shutdown()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def halo_reference(x, left, right, size):
    """What ``seq.halo`` gives each of ``size`` ranks: its window of the
    zero-padded whole tensor."""
    xp = F.pad(x, (0, 0, left, right))
    per = x.shape[1] // size
    return [xp[:, r * per:r * per + per + left + right] for r in range(size)]
