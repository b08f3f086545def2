"""The ranks of ``tests/test_torch_tp.py``: four gloo processes on the CPU.

``run(rank, root)`` reads ``root/job.pt`` (the tiny Grad-TTS and SPIRAL
weights, their global batches and JAX's draws and negatives), joins one
world of four at a ``file://`` store and runs every check of ``CHECKS``:
the meshes' layouts, the Grad-TTS step on (data 2, model 2) replicated and
TP-placed (AdamW and Novograd), a TP checkpoint saved after one step and
resumed, a whole tensor loaded into a shard of the 2-D mesh, and the SPIRAL
pretrain step on (data 1, seq 2, model 2) replicated and TP-placed. Each
rank saves what it saw to ``root/rank<r>.pt``. A step check called with
``placement="one"`` is the one-process step on the whole batch. It imports
torch and the port only.
"""

from __future__ import annotations

import os
import time

import torch

from tpu_speech_torch.models.grad_tts import GradTTS
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder
from tpu_speech_torch.parallel import distributed, mesh
from tpu_speech_torch.train import optim
from tpu_speech_torch.train.gradtts import train_step
from tpu_speech_torch.train.spiral import batch_to_device, make_pretrain_state, pretrain_step
from tpu_speech_torch.train.trainer import step_generator


def _host(module):
    return {k: v.detach().clone() for k, v in mesh.full_state_dict(module).items()}


def _grads(module):
    """Each parameter's gradient, gathered whole (the teacher has none)."""
    return {n: mesh.full_tensor(p.grad).detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def _local_bytes(params, opt):
    """(parameter bytes, optimizer-state bytes) this rank holds."""
    nbytes = lambda t: mesh.local(t).numel() * mesh.local(t).element_size()  # noqa: E731
    return (sum(nbytes(p) for p in params),
            sum(nbytes(v) for st in opt.state.values() for v in st.values()))


def _place(module, placement, m):
    """``replicated``: rank 0's weights everywhere; ``tp``: JAX's TP
    placement over the mesh's model axis; ``one``: as it is."""
    if placement == "tp":
        mesh.shard_params_tp(m, module)
    elif placement == "replicated":
        mesh.replicate(module)
    return module


def _tts_opt(job, params, name):
    if name == "novograd":
        return optim.Novograd(params, job["lr"], eps=job["eps"], weight_decay=1e-3)
    return optim.AdamW(params, job["lr"], eps=job["eps"])


def _tts_rows(job, x, d, n):
    per = len(x) // n
    return x[d * per:(d + 1) * per]


def gradtts(job, placement, opt_name="adam", steps=1, state=None):
    """Grad-TTS steps (eval mode, JAX's draws replayed) on (data 2, model
    2), each rank its data coordinate's rows; ``one``: the whole batch.
    ``state`` (a saved checkpoint) resumes before the steps."""
    m = mesh.make_mesh(model_parallel=2) if placement != "one" else None
    d, n = distributed.data_coordinate() if m is not None else (0, 1)
    model = GradTTS(**job["tts_cfg"]).eval()
    model.load_state_dict(job["tts_sd"], strict=True)
    _place(model, placement, m)
    opt = _tts_opt(job, model.parameters(), opt_name)
    if state is not None:
        mesh.load_state_dict_(model, state["model"])
        params = dict(model.named_parameters())
        for name in state["mu"]:
            p = params[name]
            opt.state[p] = {k: opt.init_state(k, p) for k in opt.STATE}
            for k in opt.STATE:
                mesh.load_full_(opt.state[p][k], state[k][name])
        opt.count = state["count"]
    batch = batch_to_device(mesh.shard_batch(job["tts_batch"], d, n), "cpu")
    offsets, t, z = (_tts_rows(job, x, d, n) for x in job["tts_draws"])
    out = {"metrics": [], "saved": None}
    for i in range(steps):
        it = opt.count
        metrics = train_step(model, opt, batch, step_generator(job["seed"], it, "cpu"),
                             job["out_size"], offsets=offsets, t=t, z=z)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if i == 0 and steps > 1:  # the checkpoint a resumed run starts from
            names = {p: n for n, p in model.named_parameters()}
            out["saved"] = {"model": _host(model), "count": opt.count}
            for k in opt.STATE:
                out["saved"][k] = {names[p]: mesh.full_tensor(st[k]).clone()
                                   for p, st in opt.state.items()}
    out["grads"] = _grads(model)
    out["sd"] = _host(model)
    out["sharded"] = sorted(n for n, p in model.named_parameters() if mesh.is_sharded(p))
    out["bytes"] = _local_bytes(list(model.parameters()), opt)
    return out


def pretrain(job, placement, kind="adamw"):
    """One SPIRAL pretrain step (the tiny config, the clip, JAX's negatives)
    on (data 1, seq 2, model 2): every rank the whole batch's rows, half the
    frames; ``one``: one process."""
    m = mesh.make_mesh(seq_parallel=2, model_parallel=2) if placement != "one" else None
    d, n_data = mesh.data_axis(m) if m is not None else (0, 1)
    cfg = job["cfg"]
    model = ST2VecEncoder(cfg.model.encoder, pretraining=True)
    model.load_state_dict(job["sd"], strict=True)
    _place(model, placement, m)
    make_opt = ((lambda ps: optim.make_optimizer(cfg.model.optim, ps, 100)) if kind == "adamw"
                else (lambda ps: optim.SGD(ps, 1.0)))
    state = make_pretrain_state(model, make_opt)
    batch = mesh.shard_batch(job["batch"], d, n_data)
    b = len(batch["wavs"])
    rng = DropoutRng.seeded(3, "cpu", rank=d, row0=d * b)
    out = pretrain_step(state, batch_to_device(batch, "cpu"), rng, grad_clip=job["clip"],
                        neg_idx=job["neg"][d * b:(d + 1) * b], mesh=m)
    return {"loss": float(out["loss"]), "acc": float(out["accuracy"]),
            "frames": out["frames"], "grads": _grads(model),
            "sd": _host(model),
            "sharded": sorted(n for n, p in model.named_parameters() if mesh.is_sharded(p)),
            "bytes": _local_bytes(list(model.parameters()), state.optimizer)}


def _layouts(job):
    """Each mesh's coordinates of this rank, its data coordinate and the
    size of its batch group."""
    out = {}
    for sp, mp in ((1, 2), (2, 2), (1, 4)):
        m = mesh.make_mesh(seq_parallel=sp, model_parallel=mp)
        out[(sp, mp)] = {"names": m.mesh_dim_names, "coord": tuple(m.get_coordinate()),
                         "data": distributed.data_coordinate(),
                         "batch": distributed.batch_count()}
    mesh.make_mesh()
    out["cleared"] = (distributed.data_coordinate(), distributed.batch_count())
    return out


def _load_2d(job):
    """A whole (4, 6) tensor loaded into a tensor sharded along dim 1 over
    the model ranks of the 2-D (batch, model) mesh: this rank's chunk."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh.make_mesh(model_parallel=2)
    m2 = mesh._batch_model_mesh(4, 2, "cpu")
    t = distribute_tensor(torch.zeros(4, 6), m2, [Replicate(), Shard(1)])
    full = torch.arange(24.0).reshape(4, 6)
    mesh.load_full_(t, full)
    return {"local": t.to_local().clone(), "model": m2.get_local_rank(mesh.MODEL_AXIS),
            "whole": mesh.full_tensor(t).clone()}


def _checkpoint(job):
    """Two TP Grad-TTS steps straight, and the second again from the
    checkpoint the first left (gathered whole, loaded shard by shard)."""
    straight = gradtts(job, "tp", steps=2)
    resumed = gradtts(job, "tp", steps=1, state=straight["saved"])
    return {"straight": straight["sd"], "resumed": resumed["sd"],
            "metrics": (straight["metrics"][1], resumed["metrics"][0])}


CHECKS = {
    "layouts": _layouts,
    "load_2d": _load_2d,
    "gradtts_replicated": lambda j: gradtts(j, "replicated"),
    "gradtts_tp": lambda j: gradtts(j, "tp"),
    "gradtts_tp_novograd": lambda j: gradtts(j, "tp", "novograd", steps=2),
    "checkpoint": _checkpoint,
    "pretrain_replicated": lambda j: pretrain(j, "replicated"),
    "pretrain_tp": lambda j: pretrain(j, "tp"),
}


def run(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    job = torch.load(os.path.join(root, "job.pt"), weights_only=False)
    distributed.initialize(num_processes=4, process_id=rank, device="cpu",
                           init_method="file://" + os.path.join(root, "store"))
    try:
        out = {name: check(job) for name, check in CHECKS.items()}
    finally:
        distributed.shutdown()
    out["finished"] = time.time()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
