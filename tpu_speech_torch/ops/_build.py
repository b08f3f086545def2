"""Build and load the hand-written Hopper kernels; count their launches.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into ONE shared library with
a plain C interface (no PyTorch headers, so the build takes seconds), then
loaded through ``ctypes``. The build runs at first use, never at import:
the CPU test tier imports every module on a machine without ``nvcc``.

The library lands in ``<repo>/build/tpu_speech_torch/<key>/`` where ``key``
hashes the sources and the compiler flags, so a stale library is never
loaded after a source edit. Concurrent builders write to a temporary name and
rename atomically.

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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (restype is int: a cudaError_t)
SIGNATURES = {
    # x, dft, mel, out, B, N, n_fft, hop, n_freq, n_mels, num_frames,
    # mag_mode, mag_eps, log_mode, log_guard, stream
    "tsx_fused_logmel": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _F, _I, _F, _P],
    # qkv, key_pad (nullable), out, B, T, H, D, stream
    "tsx_qkv_attention_fwd": [_P, _P, _P, _I, _I, _I, _I, _P],
}

# Launches made through each wrapper: a plain integer per kernel, bumped
# where the wrapper launches its kernel and nowhere else.
LAUNCHES = {"fused_logmel": 0, "fused_qkv_attention": 0}

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
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


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
        log = ""
        compiled = not so_path.exists()
        if compiled:
            out_dir.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, so_path)
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

