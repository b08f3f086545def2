"""Starting the ranks of a CLI: one process a card, the copy every CLI shares.

JAX's CLIs build ``make_mesh()`` over every local device, so one command
trains data-parallel on a multi-chip host. The port runs one process a card:
``launch`` starts one rank per visible card (``CUDA_VISIBLE_DEVICES`` picks
them) with ``torch.multiprocessing``, each rank calls the CLI's ``main``
again with the same arguments, and the launcher returns rank 0's result. The
ranks of one node meet at a ``file://`` store in a temporary directory;
several nodes meet at the coordinator (``MASTER_ADDR``/``MASTER_PORT``, or
``--master_addr`` where the CLI has it). ``torchrun`` works too: its variables
(RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR) make the process a rank that
joins at once.

On the CPU a launch is one process unless asked for more (``n`` ranks of
gloo, or torchrun's variables); a one-card machine runs one process and
spawns nothing. A spawned rank starts a fresh interpreter, so the settings a
caller put into config modules (``configs/gradtts.py`` and the like) are
carried to the ranks by value (``modules``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Iterable, Optional, Sequence

import torch

from tpu_speech_torch.parallel import distributed

_PLAIN = (int, float, str, bool, type(None), list, tuple, dict)


def local_ranks(n: int, device) -> int:
    """The ranks a launch starts on this node: ``n``, or with 0 every
    visible card (one process on the CPU)."""
    if n:
        return n
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def is_rank() -> bool:
    """True in a process that torchrun or another launcher started as a
    rank (RANK is set): it joins the group instead of spawning."""
    return bool(os.environ.get("RANK"))


def config_snapshot(modules: Iterable) -> dict:
    """``{module name: {attribute: value}}`` of the plain public settings of
    config modules, for the spawned ranks."""
    return {m.__name__: {k: v for k, v in vars(m).items()
                         if not k.startswith("_") and isinstance(v, _PLAIN)}
            for m in modules}


def apply_snapshot(snapshot: dict) -> None:
    import importlib

    for name, values in snapshot.items():
        mod = importlib.import_module(name)
        for k, v in values.items():
            setattr(mod, k, v)


def spawn(entry: Callable, argv: Sequence[str], n: int, device,
          master_addr: str = "", num_nodes: int = 1, node_rank: int = -1,
          modules: Iterable = ()):
    """Start ``n`` local ranks of ``entry(argv, _init_method=...)`` and
    return rank 0's result; a failing rank fails the launch. On the card the
    kernels are built here first, so the ranks only load them."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from tpu_speech_torch.ops import _build

        _build.library()  # built once here; the ranks load it
    tmp = tempfile.mkdtemp(prefix="tpu_speech_ranks_")
    try:
        rv = distributed.rendezvous(master_addr or None,
                                    num_nodes if num_nodes > 1 else None,
                                    node_rank if node_rank >= 0 else None)
        nodes = num_nodes if num_nodes > 1 else rv["world"]
        launch = {"local_world": n, "world": nodes * n, "rank0": rv["rank"] * n,
                  "init_method": (f"tcp://{rv['coordinator']}" if rv["coordinator"]
                                  else f"file://{os.path.join(tmp, 'rendezvous')}"),
                  "result": os.path.join(tmp, "result.pt"), "threads": torch.get_num_threads(),
                  "config": config_snapshot(modules)}
        mp.spawn(_rank_main, args=(entry, list(argv), launch), nprocs=n, join=True)
        return torch.load(launch["result"], weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(local_rank: int, entry: Callable, argv, launch: dict) -> None:
    """One spawned rank: torchrun's variables and the launcher's config
    settings, then ``entry``; rank 0 keeps its result for the launcher."""
    torch.set_num_threads(launch["threads"])
    apply_snapshot(launch["config"])
    os.environ.update(LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(launch["local_world"]),
                      RANK=str(launch["rank0"] + local_rank), WORLD_SIZE=str(launch["world"]))
    out = entry(argv, _init_method=launch["init_method"])
    if distributed.is_primary():
        torch.save(out, launch["result"])
    distributed.shutdown()


def join_process_group(device, init_method: Optional[str] = None, master_addr: str = "",
                       num_nodes: int = 1, node_rank: int = -1) -> None:
    """Join the process group before any device is used: a spawned rank, or
    a launch that names a coordinator (``master_addr``, MASTER_ADDR, which
    torchrun sets); then fail if ``num_nodes`` did not federate (with no
    coordinator, it cannot). Without either this is a one-process run and
    nothing is joined."""
    if init_method is not None:
        distributed.initialize(device=device, init_method=init_method)
    elif master_addr or os.environ.get("MASTER_ADDR"):
        distributed.initialize(
            coordinator_address=master_addr or None,
            num_processes=num_nodes if num_nodes > 1 else None,
            process_id=node_rank if node_rank >= 0 else None,
            device=device, init_method=None,
        )
    distributed.require_multiprocess(num_nodes)
    if torch.device(device).type == "cuda" and distributed.process_count() > 1:
        # one build a node, before any rank needs it (the others load it)
        if distributed.rendezvous()["local_rank"] == 0:
            from tpu_speech_torch.ops import _build

            _build.library()
        distributed.barrier()


def launch(entry: Callable, argv: Sequence[str], device, init_method: Optional[str] = None,
           n: int = 0, modules: Iterable = (), master_addr: str = "", num_nodes: int = 1,
           node_rank: int = -1):
    """A CLI's ranks: in the launching process of a node with more than one
    local rank, spawn them and return ``(True, rank 0's result)``; in a rank
    (or a one-process run) join the group and return ``(False, None)``, and
    the caller goes on with its work. ``num_nodes`` > 1 needs a coordinator
    (``master_addr`` or MASTER_ADDR) and fails before any spawn without
    one."""
    if not (master_addr or os.environ.get("MASTER_ADDR")):
        distributed.require_multiprocess(num_nodes)
    n_local = local_ranks(n, device)
    if n_local > 1 and init_method is None and not is_rank():
        return True, spawn(entry, argv, n_local, device, master_addr, num_nodes, node_rank,
                           modules)
    join_process_group(device, init_method, master_addr, num_nodes, node_rank)
    return False, None


def say(*args, **kw) -> None:
    """``print`` on the primary rank only."""
    if distributed.is_primary():
        print(*args, **kw)


def check_batch(batch_size: int) -> None:
    """SystemExit unless the global ``batch_size`` splits into equal rows
    over the ranks of the data axis."""
    world = distributed.process_count()
    if batch_size % world:
        raise SystemExit(f"batch_size {batch_size} (the global batch) does not divide "
                         f"by the {world} ranks")
