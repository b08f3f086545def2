"""Build and load the hand-written Hopper kernels; count their launches.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into ONE shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), then loaded
through ``ctypes``. The build runs at first use, never at import:
the CPU test tier imports every module on a machine without ``nvcc``.

The library lands in ``<repo>/build/tpu_speech_torch/<key>/`` where ``key``
hashes the sources (and the ``csrc/*.cuh`` headers they include) and the
compiler flags, so a stale library is never loaded after a source edit.
Concurrent builders write to a temporary name and rename atomically.

Each C entry point takes pointers and the CUDA stream as ``void*``, launches
on that stream without synchronising or allocating, and returns
``cudaGetLastError()``; ``check()`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpu_speech_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# C entry points: name -> argtypes (restype is int: a cudaError_t)
SIGNATURES = {
    # x, window, mel_fb, bands, twiddle tables, out, B, N, n_fft, hop, n_mels,
    # num_frames, mag_mode, mag_eps, log_mode, log_guard, stream
    "tsx_fused_logmel": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _F, _I, _F, _P],
    # q, k, v, row stride, key_pad (nullable), out, lse (nullable), B, T, H, D,
    # seed, dropout threshold, dropout scale, stream
    "tsx_attention_fwd": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _P],
    # q, k, v, row stride, key_pad (nullable), out, dout, lse, scratch (fp32:
    # Delta, then dS^T; bf16: L and Delta in rows of T rounded up to 64), dq,
    # dk, dv, gradient row stride, B, T, H, D, seed, dropout threshold,
    # dropout scale, stream
    "tsx_attention_bwd": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _I, _I, _U, _U, _F, _P],
    # x, w, out, B, T, C, G, K, left_pad, stream
    "tsx_grouped_conv1d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # value, mask, DP scratch, path, B, Tx, Ty, stream
    "tsx_maximum_path": [_P, _P, _P, _P, _I, _I, _I, _P],
}
# the bf16 variants take the same arguments
for _name in ("tsx_attention_fwd", "tsx_attention_bwd", "tsx_grouped_conv1d"):
    SIGNATURES[_name + "_bf16"] = SIGNATURES[_name]
# the bf16 grouped conv's weights: w, out, G, Cg, K, dx, stream
SIGNATURES["tsx_grouped_conv1d_bf16_weights"] = [_P, _P, _I, _I, _I, _I, _P]
# Cg -> output frames a block of the bf16 grouped conv (a count, not an error)
SIGNATURES["tsx_grouped_conv1d_bf16_frames"] = [_I]

# Launches made through each wrapper: a plain integer per kernel, bumped
# where the wrapper launches its kernel and nowhere else. A bf16 launch
# counts under the kernel's name with "_bf16".
_KERNELS = ("fused_qkv_attention", "fused_qkv_attention_bwd", "fused_attention",
            "fused_attention_bwd", "grouped_conv1d", "grouped_conv1d_dx")
LAUNCHES = {"fused_logmel": 0, **dict.fromkeys(_KERNELS, 0),
            **dict.fromkeys((k + "_bf16" for k in _KERNELS), 0), "maximum_path": 0}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"
    ]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels build from "
        f"{CSRC} at first use"
    )


def _build_key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _compile(sources, out_dir: Path, so_path: Path) -> str:
    """One nvcc per source, all at once, then one link; returns the log,
    which it also keeps beside the library (``build.log``)."""
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [tmp / f"{src.stem}.o" for src in sources]
        jobs = [(cmd, _run(cmd)) for cmd in (
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs))]
        outs = [proc.communicate()[0] for _, proc in jobs]  # wait for every one
        log = "".join(outs)
        for (cmd, proc), out in zip(jobs, outs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        so_tmp = tmp / so_path.name
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(so_tmp), *map(str, objs)]
        link = _run(cmd)
        out = link.communicate()[0]
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
        (tmp / "build.log").write_text(log + out)
        os.replace(tmp / "build.log", out_dir / "build.log")
        os.replace(so_tmp, so_path)
        return log + out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        out_dir = BUILD_ROOT / _build_key(sources)
        so_path = out_dir / "libtpu_speech_kernels.so"
        t0 = time.perf_counter()
        compiled = not so_path.exists()
        if compiled:
            out_dir.mkdir(parents=True, exist_ok=True)
            log = _compile(sources, out_dir, so_path)
        else:  # the log of the build that made it (registers, spills)
            log_path = out_dir / "build.log"
            log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(so_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tsx_error_string.argtypes = [ctypes.c_int]
        lib.tsx_error_string.restype = ctypes.c_char_p
        build_info.update(
            path=str(so_path), seconds=time.perf_counter() - t0,
            compiled=compiled, log=log,
        )
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise unless a C entry point returned cudaSuccess."""
    if err != 0:
        msg = library().tsx_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")

