"""Build, load and count the hand-written CUDA kernels.

The sources in ``eegflow_torch/csrc`` have a plain C interface. On first use
:func:`load_library` compiles them with ``nvcc`` for ``sm_90a``, one ``nvcc``
process per source, all started together, and links the objects into one
shared library under ``eegflow_torch/_build/`` (named by a hash of the
sources and flags, so an edited source rebuilds), which it loads with
``ctypes``. Nothing is downloaded and nothing else is needed: no PyTorch
headers, no ``torch.utils.cpp_extension``. A failed build raises with
nvcc's output.

Every C entry point that launches returns ``cudaGetLastError()``;
:func:`check` raises when it is not 0. Each wrapper adds one to
:data:`launch_counts` where it launches its kernel and nowhere else, so a
run can show that its main path went through the kernels.
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

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

#: kernel name -> launches made through its wrapper in this process
launch_counts: Counter = Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_csrc: Optional[Path] = None
#: nvcc's output (ptxas register / shared-memory report) and the build time
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong
_U = ctypes.c_uint32
_SIGNATURES = {
    # lstm_fwd.cu, kernel 2 (bf16 policy), eval mode; (hc, rows, k_res) is
    # the cluster plan of nn/lstm_plan.py:
    # x0, x1, d0, d1, w0, w1, b, wfrag, pre, h_out, B, T, H, hc, rows, k_res,
    # reverse, stream
    "eegflow_lstm_fwd": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    # lstm_fwd.cu, kernel 2, training mode (res_out bf16 when res_bf16):
    # x0, x1, m0, m1, bits0, bits1, d0, d1, inv_keep, w0, w1, b, wfrag, pre,
    # h_out, res_out, res_bf16, B, T, H, hc, rows, k_res, reverse, stream
    # (bits_p: the parts' packed Philox keep bits, or null for the uint8 masks
    # m_p or none)
    "eegflow_lstm_fwd_train": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # lstm_fwd.cu, kernel 2, raw-gate training mode (gates_out bf16 when
    # res_bf16):
    # x0, x1, m0, m1, bits0, bits1, d0, d1, inv_keep, w0, w1, b, wfrag, pre,
    # h_out, gates_out, res_bf16, c_out, B, T, H, hc, rows, k_res, reverse,
    # stream
    "eegflow_lstm_fwd_train_gates": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P,
                                     _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # lstm_fwd.cu, the recurrence's shared memory and clusters held at once:
    # mode (0 eval, 1 planes, 2 raw gates, 3 bf16 planes, 4 bf16 raw gates),
    # H, hc, rows, k_res, *smem, *clusters
    "eegflow_lstm_fwd_plan": [_I, _I, _I, _I, _I, _P, _P],
    # lstm_bwd.cu, kernel 3 (res bf16 when res_bf16):
    # res, res_bf16, h, g, x0, x1, m0, m1, bits0, bits1, d0, d1, inv_keep, w0,
    # w1, wfrag, add0, add1, dx0, dx1, dw_ih, dw_hh, db, dz16, db_part, part,
    # splits, B, T, H, hc, rows, k_res, reverse, stream
    "eegflow_lstm_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    # lstm_bwd.cu, the chain's shared memory and clusters held at once:
    # res_bf16, H, hc, rows, k_res, *smem, *clusters
    "eegflow_lstm_bwd_plan": [_I, _I, _I, _I, _I, _P, _P],
    # lstm_bwd_v2.cu, kernel 3b (gates bf16 when res_bf16):
    # gates, res_bf16, c, h, g, x0, x1, m0, m1, bits0, bits1, d0, d1,
    # inv_keep, w0, w1, wfrag, add0, add1, dx0, dx1, dw_ih, dw_hh, db, dz16,
    # db_part, part, splits, B, T, H, hc, rows, k_res, reverse, stream
    "eegflow_lstm_bwd_v2": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P],
    # lstm_bwd_v2.cu, its chain's shared memory and clusters held at once:
    # res_bf16, H, hc, rows, k_res, *smem, *clusters
    "eegflow_lstm_bwd_v2_plan": [_I, _I, _I, _I, _I, _P, _P],
    # lstm_bwd_dualdir.cu, kernel 4 (both planes bf16 when res_bf16):
    # res_f, h_f, g_f, res_r, h_r, g_r, res_bf16, x0, x1, d0, d1, mask_from_x,
    # inv_keep, w0_f, w1_f, wfrag_f, w0_r, w1_r, wfrag_r, dx0, dx1, dw_ih_f,
    # dw_hh_f, db_f, dw_ih_r, dw_hh_r, db_r, dz16_f, dz16_r, db_part_f,
    # db_part_r, part, splits, B, T, H, hc, rows, k_res, stream
    "eegflow_lstm_bwd_dualdir": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F,
                                 _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # lstm_bwd_dualdir.cu, its chain's shared memory and clusters held at once:
    # res_bf16, H, hc, rows, k_res, *smem, *clusters
    "eegflow_lstm_bwd_dualdir_plan": [_I, _I, _I, _I, _I, _P, _P],
    # lstm_rec.cu, kernel 1 (float32 policy); c_out null in eval mode, and in
    # training mode z written over the gates:
    # gates, wslice, h_out, c_out, B, T, H, hc, rows, k_res, reverse, stream
    "eegflow_lstm_rec_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # lstm_rec.cu, kernel 1's shared memory and clusters held at once:
    # mode (0 eval, 1 training), H, hc, rows, k_res, *smem, *clusters
    "eegflow_lstm_rec_plan": [_I, _I, _I, _I, _I, _P, _P],
    # lstm_rec.cu, kernel 5:
    # z, c, g, wslice, dgates, B, T, H, hc, rows, k_res, reverse, stream
    "eegflow_lstm_rec_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # lstm_rec.cu, kernel 5's shared memory and clusters held at once:
    # H, hc, rows, k_res, *smem, *clusters
    "eegflow_lstm_rec_bwd_plan": [_I, _I, _I, _I, _P, _P],
    # input_block.cu, kernel 9 (grid and tile from nn/cuda_input.py fwd_plan):
    # x, w, b, gamma, beta, y, ctas, tile_rows, rows, C, H, bf16, stream
    "eegflow_input_block_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # input_block.cu, kernel 10 (grid, tile and scratch from nn/cuda_input.py
    # bwd_plan; the bf16 wide class in clusters of two CTAs): x, dy, w, b,
    # gamma, beta, dx, grads, part, ctas, tile_rows, rows, C, H, bf16, stream
    "eegflow_input_block_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _P],
    # input_block.cu, kernel 10's bf16 launch for C and H: C, H, *plan (class,
    # CTAs a row tile, rows a tile, shared memory a CTA, CTAs or clusters held
    # at once), *name
    "eegflow_input_block_bwd_bf16_plan": [_I, _I, _P, _P],
    # pool_head_fwd.cu, kernel 7 (and kernel 6: one part, use_ln=0, bf16=0;
    # w1: W1 in bf16 under bf16, else W1^T in float32):
    # x0, x1, d0, d1, gamma, beta, w1, b1, w2, ctx0, ctx1, scores,
    # B, T, K, use_ln, bf16, stream
    "eegflow_pool_head_fwd": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
    # pool_head_bwd.cu, kernel 8 (w1, w1t, y_scr and u_scr bf16 under bf16,
    # else float32):
    # x0, x1, d0, d1, gamma, beta, w1, w1t, b1, w2, wts, gs, g0, g1, gctx,
    # dh0, dh1, dw1, vec, y_scr, u_scr, vec_part, part, splits, B, T, K,
    # use_ln, bf16, stream
    "eegflow_pool_head_bwd": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _P],
    # pool_head_bwd.cu, kernel 8's bf16 launch for D and K: D, K, *plan (class,
    # CTAs a batch row, time steps a tile, shared memory a CTA), *name
    "eegflow_pool_head_bwd_bf16_plan": [_I, _I, _P, _P],
    # philox_bits.cu, the keep-bit planes of kernel_dropout (one or two parts):
    # key, stream0, stream1, off0, off1, n0, n1, thresh, bits0, bits1, stream
    "eegflow_philox_keep_bits": [_P, _I, _I, _L, _L, _L, _L, _U, _P, _P, _P],
    # apf_rk4.cu, kernel 11 (trajectory mode with traj, else the fit loss,
    # with its gradient when grad is given):
    # y0, y0_stride, k, B, n_points, substeps, half, full, sixth, traj, obs,
    # reg_weight, loss, grad, stream
    "eegflow_apf_rk4": [_P, _I, _P, _I, _I, _I, _F, _F, _F, _P, _P, _F, _P, _P, _P],
    # apf_rk4.cu, kernel 11's DE mode (pop and fit in place; status: generations
    # run, stopped by the convergence test; work: the plan's scratch):
    # pop, fit, n, lo, hi, f, u, cr, j, gens, tol, atol, y0, obs, n_points,
    # substeps, half, full, sixth, reg_weight, status, work, stream
    "eegflow_apf_de": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _D, _D, _P, _P, _I, _I, _F, _F,
                       _F, _F, _P, _P, _P],
    # apf_rk4.cu, kernel 11's DE launch for n members: n, substeps, *plan
    # (CTAs, threads a CTA, shared memory a CTA, CTAs held at once, scratch
    # floats), *name
    "eegflow_apf_de_plan": [_I, _I, _P, _P],
    # sos_filter.cu, kernel 12 (x, y_fwd and out in (time, row) layout):
    # x, sos, zi, y_fwd, out, rows, T, padlen, sections, stream
    "eegflow_sos_filtfilt": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def gemm_splits(rows: int, rows_per_split: int = 4096) -> int:
    """How many slices the kernels split a weight-gradient sum over ``rows``
    (= B*T) into: about ``rows_per_split`` rows a slice, at most 16. The
    split depends on the shapes only, so the summation order, and the
    result, repeat bitwise run to run."""
    return max(1, min(16, -(-rows // rows_per_split)))


def reset_launch_counts() -> None:
    launch_counts.clear()


def _sources(csrc: Path):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda "
                           "and PATH): the CUDA kernels cannot be built")
    return found


def _source_hash(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library(csrc: Optional[Path] = None, build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library, from the
    sources in ``csrc`` into ``build_dir`` (by default the package's
    ``csrc/`` and ``_build/``). The first load of a process is the library
    every wrapper uses; a later call naming other sources raises, since two
    builds of the library in one process fault (each holds its own static
    CUDA runtime)."""
    global _lib, _lib_csrc
    with _lock:
        if _lib is not None:
            if csrc is not None and Path(csrc).resolve() != _lib_csrc:
                raise RuntimeError(f"the kernel library of this process was built from "
                                   f"{_lib_csrc}, not {csrc}")
            return _lib
        csrc = Path(csrc) if csrc is not None else CSRC
        build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
        build_dir.mkdir(parents=True, exist_ok=True)
        so = build_dir / f"libeegflow_kernels_{_source_hash(csrc)}.so"
        if not so.exists():
            t0 = time.perf_counter()
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            nvcc = _nvcc()
            objs, procs = [], []
            for src in sorted(csrc.glob("*.cu")):
                obj = build_dir / f"{src.stem}.{os.getpid()}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
                objs.append(obj)
            log, failed = [], None
            for cmd, proc in procs:
                out = proc.communicate()[0]
                log.append(out)
                if proc.returncode != 0 and failed is None:
                    failed = (cmd, proc.returncode, out)
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *[str(o) for o in objs]]
            if failed is None:
                proc = subprocess.run(link, capture_output=True, text=True)
                log.append(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed = (link, proc.returncode, proc.stdout + proc.stderr)
            for obj in objs:
                obj.unlink(missing_ok=True)
            if failed is not None:
                tmp.unlink(missing_ok=True)
                cmd, code, out = failed
                raise RuntimeError(f"nvcc failed (exit {code}): {' '.join(cmd)}\n{out}")
            os.replace(tmp, so)
            build_info.update(seconds=time.perf_counter() - t0, log="".join(log),
                              command=[p[0] for p in procs] + [link])
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            if csrc.resolve() != CSRC.resolve() and not hasattr(lib, name):
                continue  # another tree's sources (kernels.ablate --csrc) may predate an entry
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.eegflow_cuda_error_string.argtypes = [ctypes.c_int]
        lib.eegflow_cuda_error_string.restype = ctypes.c_char_p
        build_info["library"] = str(so)
        _lib, _lib_csrc = lib, csrc.resolve()
        return lib


def stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream, for a launch."""
    return torch.cuda.current_stream(dev).cuda_stream


class HostCopy:
    """A device tensor's copy to host memory, started without waiting for the
    device; ``np.asarray`` of it waits for that copy alone, so work queued
    after it stays in flight."""

    def __init__(self, t: torch.Tensor):
        self._host = t.to("cpu", non_blocking=True)
        self._done = None
        if t.is_cuda:
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(t.device))

    def __array__(self, dtype=None, copy=None):
        if self._done is not None:
            self._done.synchronize()
        return np.asarray(self._host.numpy(), dtype=dtype)


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = lib.eegflow_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")
