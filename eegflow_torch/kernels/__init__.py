"""Build, load and count the hand-written CUDA kernels.

The sources in ``eegflow_torch/csrc`` have a plain C interface. On first use
:func:`load_library` compiles them with ``nvcc`` for ``sm_90a`` into one
shared library under ``eegflow_torch/_build/`` (named by a hash of the
sources and flags, so an edited source rebuilds) and loads it with
``ctypes``. Nothing is downloaded and nothing else is needed: no PyTorch
headers, no ``torch.utils.cpp_extension``. A failed build raises with
nvcc's output.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises when
it is not 0. Each wrapper adds one to :data:`launch_counts` where it launches
its kernel and nowhere else, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

#: kernel name -> launches made through its wrapper in this process
launch_counts: Counter = Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: nvcc's output (ptxas register / shared-memory report) and the build time
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x0, x1, d0, d1, w0, w1, b, whh, h_out, B, T, H, reverse, stream
    "eegflow_lstm_fwd": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x0, x1, d0, d1, gamma, beta, w1, b1, w2, ctx0, ctx1, scores,
    # B, T, K, use_ln, bf16, stream
    "eegflow_pool_head_fwd": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
}


def reset_launch_counts() -> None:
    launch_counts.clear()


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda "
                           "and PATH): the CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libeegflow_kernels_{_source_hash()}.so"
        if not so.exists():
            t0 = time.perf_counter()
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            build_info.update(seconds=time.perf_counter() - t0,
                              log=proc.stdout + proc.stderr, command=cmd)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.eegflow_cuda_error_string.argtypes = [ctypes.c_int]
        lib.eegflow_cuda_error_string.restype = ctypes.c_char_p
        build_info["library"] = str(so)
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = lib.eegflow_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")
