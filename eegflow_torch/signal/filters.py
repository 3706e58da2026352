"""Zero-phase bandpass filters (``eegflow.signal.filters``).

* :func:`fft_zero_phase`: odd extension by the filter's transient length,
  ``rfft`` x |H|^2, ``irfft``, on the input's device. filtfilt is a
  zero-phase filter of magnitude |H|^2, so the two agree except within an
  edge transient. The FFT is ``torch.fft``, as the reference's is ``jnp.fft``
  in XLA.
* :func:`filtfilt_iir`: scipy ``filtfilt`` parity (odd extension by
  ``padlen = 3 max(len(a), len(b))``, steady-state initial conditions scaled
  by the first sample of each pass, forward and reverse pass, trim) as a
  cascade of second-order sections. The recursion is kernel 12
  (``eegflow_torch/csrc/sos_filter.cu``, :func:`sos_filtfilt`), which
  replaces ``_sos_scan`` and ``_filtfilt_core``
  (``eegflow/signal/filters.py:96-138``), a ``lax.scan`` over every sample
  that eager PyTorch would run as ~40 launches a sample. For CPU tensors
  :func:`sos_filtfilt` runs its plain twin :func:`sos_filtfilt_plain`; for
  CUDA tensors it launches the kernel or raises. The recursion's 1 Hz poles
  (|p| ~ 0.996) make float32 results sensitive to each rounding (a
  different contraction of one multiply-add moves the output by ~8e-5 of
  its scale), so kernel and twin both take the multiply-adds XLA forms from
  the reference's expressions: the twin then matches the reference to
  float32 rounding, and the kernel the twin.

Coefficient design (``butter``, ``freqz``, ``tf2sos``, ``sosfilt_zi``) is
scipy on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from eegflow_torch import kernels

#: kernel 12 holds each section's state in registers, unrolled up to this
#: many sections (an order-8 bandpass)
MAX_SECTIONS = 8
#: rows a CTA of kernel 12 filters (one warp, a row a thread)
SOS_GROUP = 32


def butter_bandpass(lowcut: float, highcut: float, fs: float, order: int = 4
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Butterworth bandpass (b, a) coefficients."""
    from scipy.signal import butter

    nyq = 0.5 * fs
    b, a = butter(order, [lowcut / nyq, highcut / nyq], btype="band")
    return np.asarray(b), np.asarray(a)


def _iir_magnitude_sq(b: np.ndarray, a: np.ndarray, n_freqs: int, n_fft: int) -> np.ndarray:
    """|H(e^{jw})|^2 of the IIR filter on the rfft grid of length ``n_fft``."""
    from scipy.signal import freqz

    w = 2.0 * np.pi * np.arange(n_freqs) / n_fft
    _, h = freqz(b, a, worN=w)
    return np.abs(h) ** 2


def _transient_padlen(b: np.ndarray, a: np.ndarray, decay: float = 1e-4) -> int:
    """Samples until the impulse response decays to ``decay``: the FFT
    filter's pad against circular wrap-around, from the slowest pole."""
    r = float(np.max(np.abs(np.roots(a))))
    r = min(r, 1.0 - 1e-9)
    return int(np.ceil(np.log(decay) / np.log(r)))


def _odd_extend(x: torch.Tensor, pad: int) -> torch.Tensor:
    """scipy's padtype='odd' along the last axis."""
    left = 2.0 * x[..., :1] - x[..., 1: pad + 1].flip(-1)
    right = 2.0 * x[..., -1:] - x[..., -pad - 1: -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def fft_zero_phase(x: torch.Tensor, b: np.ndarray, a: np.ndarray) -> torch.Tensor:
    """Zero-phase filter of ``x (..., T)`` along the last axis: odd extension
    by the transient length, then one rfft, a product with |H|^2 and one
    irfft, on x's device."""
    t = x.shape[-1]
    pad = min(t - 1, _transient_padlen(b, a))
    ext = _odd_extend(x, pad)
    n = ext.shape[-1]
    gain = torch.as_tensor(_iir_magnitude_sq(b, a, n // 2 + 1, n), dtype=x.dtype,
                           device=x.device)
    out = torch.fft.irfft(torch.fft.rfft(ext, dim=-1) * gain, n=n, dim=-1).to(x.dtype)
    return out[..., pad: pad + t]


def _sos_pass_plain(ext: torch.Tensor, sos: np.ndarray, zi: np.ndarray) -> torch.Tensor:
    """One pass of the biquad cascade over ``ext (N, R)`` (time first), the
    delay lines started at ``zi`` x the first sample, with the kernel's
    roundings: y = fma(b0, v, z0); z0 = fma(b1, v, -(a1 y)) + z1;
    z1 = fma(b2, v, -(a2 y)). These are the multiply-adds XLA's CPU
    compiler forms from the reference's ``_sos_scan`` (it contracts each
    ``b * v - a * y`` on its first product). A fused multiply-add rounds
    once: the product of two float32 values is exact in float64, so it is
    the float64 sum rounded to float32. A sample runs the sections' outputs
    in series, then every section's delay lines at once; v and z0 are kept
    in float64 (holding float32 values)."""
    col = lambda j: torch.as_tensor(sos[:, j:j + 1], device=ext.device)  # noqa: E731
    b1, b2, a1, a2 = (col(j) for j in (1, 2, 4, 5))
    b0s = [float(c) for c in sos[:, 0]]
    first = ext[0]
    z0 = (torch.as_tensor(zi[:, :1], device=ext.device) * first).double()  # (S, R)
    z1 = torch.as_tensor(zi[:, 1:], device=ext.device) * first
    out = torch.empty_like(ext)
    for i in range(ext.shape[0]):
        v64 = ext[i].double()
        ins, ys = [], []
        for s, b0 in enumerate(b0s):
            ins.append(v64)
            ys.append((b0 * v64 + z0[s]).float())
            v64 = ys[-1].double()
        x64, y = torch.stack(ins), torch.stack(ys)
        z0 = ((b1 * x64 - (a1 * y).double()).float() + z1).double()
        z1 = (b2 * x64 - (a2 * y).double()).float()
        out[i] = ys[-1]
    return out


def _sos_design(b: np.ndarray, a: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """float32 second-order sections, their unit steady-state delay lines
    and scipy's padlen for (b, a)."""
    from scipy.signal import sosfilt_zi, tf2sos

    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    sos = tf2sos(b, a)
    return (sos.astype(np.float32), sosfilt_zi(sos).astype(np.float32),
            3 * max(len(a), len(b)))


def sos_filtfilt_plain(x: torch.Tensor, sos: np.ndarray, zi: np.ndarray,
                       padlen: int) -> torch.Tensor:
    """Twin of :func:`sos_filtfilt`: ``x (R, T)`` float32 -> (R, T)."""
    ext = _odd_extend(x, padlen).t()  # (T + 2 padlen, R)
    y = _sos_pass_plain(ext, sos, zi)
    y2 = _sos_pass_plain(y.flip(0), sos, zi).flip(0)
    return y2[padlen: ext.shape[0] - padlen].t().contiguous()


def sos_filtfilt(x: torch.Tensor, sos: np.ndarray, zi: np.ndarray, padlen: int) -> torch.Tensor:
    """Kernel 12: filtfilt of ``x (R, T)`` float32 rows through the float32
    sections ``sos (S, 6)`` with unit delay lines ``zi (S, 2)`` -> (R, T).
    One thread a row runs the odd extension, both passes and the trim, a CTA
    a group of 32 rows; the rows are staged group-major, (ceil(R / 32), T,
    32) with the last group padded by zero rows, so a chunk of a group's
    samples is one contiguous block for the kernel's bulk copies."""
    if x.device.type == "cpu":
        return sos_filtfilt_plain(x, sos, zi, padlen)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x must be float32 (R, T), got {x.dtype} {tuple(x.shape)}")
    rows, t = x.shape
    sections = sos.shape[0]
    if not 0 < sections <= MAX_SECTIONS:
        raise ValueError(f"sos_filtfilt takes 1..{MAX_SECTIONS} sections, got {sections}")
    if t <= padlen:
        raise ValueError(f"signal length {t} must exceed padlen {padlen}")
    if padlen <= 0:
        raise ValueError(f"padlen must be positive, got {padlen}")
    dev = x.device
    xg = sos_groups(x)
    groups = xg.shape[0]
    sos_d = torch.as_tensor(np.ascontiguousarray(sos, np.float32), device=dev)
    zi_d = torch.as_tensor(np.ascontiguousarray(zi, np.float32), device=dev)
    y_fwd = torch.empty(groups, t + 2 * padlen, SOS_GROUP, dtype=torch.float32, device=dev)
    out = torch.empty(groups, t, SOS_GROUP, dtype=torch.float32, device=dev)
    lib = kernels.load_library()
    err = lib.eegflow_sos_filtfilt(xg.data_ptr(), sos_d.data_ptr(), zi_d.data_ptr(),
                                   y_fwd.data_ptr(), out.data_ptr(), rows, t, padlen, sections,
                                   kernels.stream(dev))
    kernels.check(lib, err, "sos_filtfilt")
    kernels.launch_counts["sos_filtfilt"] += 1
    return sos_ungroup(out, rows)


def sos_groups(x: torch.Tensor) -> torch.Tensor:
    """Rows ``x (R, T)`` -> kernel 12's layout (ceil(R / 32), T, 32): groups
    of 32 rows, time-major in each, the last group padded by zero rows."""
    rows, t = x.shape
    groups = -(-rows // SOS_GROUP)
    xg = torch.nn.functional.pad(x, (0, 0, 0, groups * SOS_GROUP - rows))
    return xg.view(groups, SOS_GROUP, t).transpose(1, 2).contiguous()


def sos_ungroup(xg: torch.Tensor, rows: int) -> torch.Tensor:
    """The inverse of :func:`sos_groups`: (G, T, 32) -> the first ``rows``
    rows, (rows, T)."""
    groups, t, _ = xg.shape
    return xg.transpose(1, 2).reshape(groups * SOS_GROUP, t)[:rows].contiguous()


def filtfilt_iir(x: torch.Tensor, b: np.ndarray, a: np.ndarray) -> torch.Tensor:
    """scipy.signal.filtfilt-parity zero-phase IIR along the last axis of
    ``x (..., T)`` (float32, on x's device), as a cascade of second-order
    sections for float32 stability."""
    sos, zi, padlen = _sos_design(b, a)
    if x.shape[-1] <= padlen:
        raise ValueError(f"signal length {x.shape[-1]} must exceed padlen {padlen}")
    x = torch.as_tensor(x, dtype=torch.float32)
    rows = x.reshape(-1, x.shape[-1])
    return sos_filtfilt(rows, sos, zi, padlen).reshape(x.shape)


def bandpass_filter(data: torch.Tensor, lowcut: float, highcut: float, fs: float,
                    order: int = 4, method: str = "fft") -> torch.Tensor:
    """Bandpass along the last (time) axis: ``method`` ``"fft"``
    (:func:`fft_zero_phase`) or ``"filtfilt"`` (:func:`filtfilt_iir`)."""
    b, a = butter_bandpass(lowcut, highcut, fs, order)
    if method == "fft":
        return fft_zero_phase(data, b, a)
    if method == "filtfilt":
        return filtfilt_iir(data, b, a)
    raise ValueError(f"filter method must be 'fft' or 'filtfilt', got {method!r}")
