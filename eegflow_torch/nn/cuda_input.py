"""Fused input block ``gelu(LayerNorm(x . W + b))``, forward and recomputing
backward (``eegflow.nn.pallas_input`` counterpart).

:func:`input_block_fused` launches the hand-written CUDA kernel
``eegflow_torch/csrc/input_block.cu`` for CUDA tensors; it replaces
``eegflow/nn/pallas_input.py`` ``_input_block_fwd_kernel`` (entry
``_fwd_call``). :func:`input_block_bwd` launches the same source's backward,
which replaces ``_input_block_bwd_kernel`` (entry ``_bwd_call``): it
recomputes the forward from x, so no (B, T, H) residual is kept. The kernel
source says what bounds it on the card and how its design deals with that.
For CPU tensors a wrapper runs its plain twin (:func:`input_block_fused_plain`,
:func:`input_block_bwd_plain`); for CUDA tensors it launches the kernel or
raises. :class:`InputBlock` is the ``torch.autograd.Function`` around the
pair, as ``_input_block_core``'s custom VJP is in the reference.

The reference's ``out_keep``/``out_mask`` mode (``EEGFLOW_FWD_DROPW=2``: the
stack's input dropout folded into the block's output) draws the same masks
and computes the same function as the port's mask path, where the first LSTM
layer applies the input dropout from explicit masks; its ``out_seed`` mode
(the TPU's hardware PRNG) has no counterpart.
"""

from __future__ import annotations

import ctypes
import math
import re
from typing import List, Mapping, NamedTuple, Tuple

import torch

from eegflow_torch import kernels
from eegflow_torch.nn.cuda_lstm import _device_kind
from eegflow_torch.nn.layers import bf16_round

LN_EPS = 1e-5
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
#: kernel 9: its fixed persistent grid (one 512-thread CTA on each of an
#: H100's 132 SMs) and the widest hidden size a 64-row tile takes (32-row
#: tiles above it, up to 512)
FWD_CTAS = 132
FWD_WIDE_TILE_MAX_HIDDEN = 256
#: kernel 10: its fixed persistent grid (one CTA of 16 warps on each of an
#: H100's 132 SMs; a fixed count keeps the order of the partial sums, and so
#: the result, the same on any card); the bf16 mode's rows a tile, one CTA a
#: tile up to BWD_MAX_CHANNELS inputs and BWD_MAX_HIDDEN units (its narrow
#: class) and beyond either a cluster of BWD_WIDE_CLUSTER CTAs a tile, each
#: CTA half of the units (its wide class: a 64-row tile's float32 z and dy
#: beside bf16 W would not fit in one CTA's shared memory at H = 512); the
#: float32 mode takes 32-row tiles up to FWD_WIDE_TILE_MAX_HIDDEN and 16-row
#: tiles above it (float32 W, z and dy tiles of 32 rows would not fit in
#: shared memory at H = 512)
BWD_CTAS = 132
BWD_TILE_ROWS = 64
BWD_WIDE_CLUSTER = 2
BWD_MAX_CHANNELS, BWD_MAX_HIDDEN = 64, 256


def _tiles_of(cta: int, rows: int, ctas: int, tile_rows: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each tile a persistent CTA ``cta`` walks, in its
    order: tiles cta, cta + ctas, .. of ``rows`` rows."""
    return [(t * tile_rows, min(tile_rows, rows - t * tile_rows))
            for t in range(cta, -(-rows // tile_rows), ctas)]


class FwdPlan(NamedTuple):
    """A launch of kernel 9: ``ctas`` CTAs, each taking ``tile_rows`` rows at
    a time."""

    ctas: int
    tile_rows: int

    def tiles_of(self, cta: int, rows: int) -> List[Tuple[int, int]]:
        return _tiles_of(cta, rows, self.ctas, self.tile_rows)


def fwd_plan(rows: int, hidden: int) -> FwdPlan:
    """Kernel 9's grid and tile for ``rows`` = B*T rows of ``hidden`` units,
    in either mode: 64-row tiles up to H = 256 and 32-row tiles above it (a
    64-row float32 z tile beside float32 W would not fit in shared memory at
    H = 512), on at most :data:`FWD_CTAS` CTAs. Raises ``ValueError`` for H
    outside 32..512 or not a multiple of 32."""
    if hidden % 32 or not 0 < hidden <= 512:
        raise ValueError(f"the input block kernels need H % 32 == 0 and H <= 512, got {hidden}")
    tile_rows = 64 if hidden <= FWD_WIDE_TILE_MAX_HIDDEN else 32
    return FwdPlan(min(FWD_CTAS, -(-rows // tile_rows)), tile_rows)


class BwdPlan(NamedTuple):
    """A launch of kernel 10: ``ctas`` CTAs in clusters of ``cluster`` (1: a
    CTA alone), each cluster taking ``tile_rows`` rows at a time, and
    ``part`` floats of scratch: one partial row [dW, db, dgamma, dbeta] a
    cluster, which a second launch adds in cluster order."""

    ctas: int
    cluster: int
    tile_rows: int
    part: int

    @property
    def clusters(self) -> int:
        return self.ctas // self.cluster

    def tiles_of(self, cta: int, rows: int) -> List[Tuple[int, int]]:
        """(first row, rows) of each tile CTA ``cta`` walks: its cluster's."""
        return _tiles_of(cta // self.cluster, rows, self.clusters, self.tile_rows)

    def columns_of(self, cta: int, hidden: int) -> Tuple[int, int]:
        """(first unit, units) of the columns of z, dy and dW that CTA ``cta``
        owns: a cluster's CTAs split the ``hidden`` units evenly, in rank
        order."""
        n = hidden // self.cluster
        return (cta % self.cluster) * n, n


def bwd_plan(rows: int, channels: int, hidden: int, bf16: bool) -> BwdPlan:
    """Kernel 10's grid, tile and scratch for ``rows`` = B*T rows of
    ``channels`` inputs and ``hidden`` units; the wrapper allocates from it.
    Both modes take any C and kernel 9's widths (H % 32 == 0, H <= 512): the
    bf16 mode one CTA a 64-row tile for C <= 64 and H <= 256 and beyond
    either a cluster of :data:`BWD_WIDE_CLUSTER` CTAs a 64-row tile (at most
    ``BWD_CTAS / 2`` clusters), the float32 mode one CTA a 32-row tile,
    16-row above H = 256. Raises ``ValueError`` for other widths; there is no
    other body."""
    if hidden % 32 or not 0 < hidden <= 512:
        raise ValueError(f"input_block_bwd {'under bf16' if bf16 else 'in float32'} needs "
                         f"H % 32 == 0 and H <= 512; got C={channels}, H={hidden}")
    cluster = 1
    if bf16:
        tile_rows = BWD_TILE_ROWS
        if channels > BWD_MAX_CHANNELS or hidden > BWD_MAX_HIDDEN:
            cluster = BWD_WIDE_CLUSTER
    else:
        tile_rows = 32 if hidden <= FWD_WIDE_TILE_MAX_HIDDEN else 16
    clusters = min(BWD_CTAS // cluster, -(-rows // tile_rows))
    return BwdPlan(clusters * cluster, cluster, tile_rows, clusters * (channels + 3) * hidden)


class Bf16BwdPlan(NamedTuple):
    """The launch that kernel 10's bf16 mode makes for C and H, as its C entry
    point reports it: the wide class or the narrow one, its CTAs a row tile
    (a cluster in the wide class), the rows a tile, the dynamic shared memory
    of a CTA in bytes, how many of its CTAs (narrow) or clusters (wide) the
    card holds at once, and the row kernel's name."""

    wide: bool
    cluster: int
    tile_rows: int
    smem: int
    held: int
    kernel: str


def input_block_bwd_bf16_plan(channels: int, hidden: int) -> Bf16BwdPlan:
    """Kernel 10's bf16 launch for C = ``channels`` and H = ``hidden``, read
    from ``csrc/input_block.cu`` (``eegflow_input_block_bwd_bf16_plan``: the
    constants and shared-memory layout its launch uses, the card's
    ``cudaOccupancy`` answer, and the row kernel's identifier out of the name
    ``cudaFuncGetName`` gives). Builds the kernels (CUDA only); raises as
    :func:`bwd_plan` does for other widths."""
    bwd_plan(1, channels, hidden, True)
    lib = kernels.load_library()
    plan, name = (ctypes.c_int * 5)(), ctypes.c_char_p()
    kernels.check(lib, lib.eegflow_input_block_bwd_bf16_plan(channels, hidden, plan,
                                                             ctypes.byref(name)),
                  "input_block_bwd_bf16_plan")
    mangled = name.value.decode()
    ident = re.search(r"input_block_bwd_[a-z0-9_]*kernel", mangled)
    return Bf16BwdPlan(bool(plan[0]), plan[1], plan[2], plan[3], plan[4],
                       ident.group(0) if ident else mangled)


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7), as the kernels
    and the reference's Pallas kernels evaluate it."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t - 0.284496736) * t
            + 0.254829592) * t
    r = 1.0 - poly * torch.exp(-ax * ax)
    return torch.where(x < 0.0, -r, r)


def _gelu(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * z * (1.0 + _erf(z * _INV_SQRT2))


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of GELU: Phi(z) + z phi(z)."""
    return 0.5 * (1.0 + _erf(z * _INV_SQRT2)) + z * torch.exp(-0.5 * z * z) * _INV_SQRT2PI


def _project_ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, bf16: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x . W + b (bf16-rounded operands under ``bf16``), then the LayerNorm
    statistics as the kernels take them (mean and E[z^2] - mean^2) ->
    (xhat, rsig)."""
    z = (bf16_round(x) @ bf16_round(w) if bf16 else x @ w) + b
    mu = z.mean(-1, keepdim=True)
    rsig = torch.rsqrt((z * z).mean(-1, keepdim=True) - mu * mu + LN_EPS)
    return (z - mu) * rsig, rsig


def input_block_fused_plain(proj: Mapping, norm: Mapping, x: torch.Tensor,
                            bf16: bool = False) -> torch.Tensor:
    """Plain twin of kernel 9: (B, T, C) -> gelu(LN(x . W + b)) (B, T, H),
    float32, with the kernel's A&S erf (within 1.5e-7 of ``torch.erf``)."""
    xhat, _ = _project_ln(x.to(torch.float32), proj["w"], proj["b"], bf16)
    return _gelu(xhat * norm["scale"] + norm["bias"])


Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def input_block_bwd_plain(proj: Mapping, norm: Mapping, x: torch.Tensor, dy: torch.Tensor,
                          bf16: bool = False) -> Grads:
    """Plain twin of kernel 10: recompute the forward from x and, from the
    upstream gradient ``dy`` (B, T, H), return (dx (B, T, C), dW (C, H),
    db, dgamma, dbeta (H,)). dx and dW take bf16(dz), bf16(W) and bf16(x)
    under ``bf16``; the sums are float32."""
    x = x.to(torch.float32)
    w, gamma = proj["w"], norm["scale"]
    xhat, rsig = _project_ln(x, w, proj["b"], bf16)
    dln = dy * _gelu_grad(xhat * gamma + norm["bias"])
    dxhat = dln * gamma
    dz = rsig * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    rnd = bf16_round if bf16 else (lambda t: t)
    dz2 = rnd(dz).reshape(-1, dz.shape[-1])
    dw = rnd(x).reshape(-1, x.shape[-1]).t() @ dz2
    dx = (dz2 @ rnd(w).t()).reshape(x.shape)
    bt = (0, 1)  # sums over all (b, t) rows
    return dx, dw, dz.sum(dim=bt), (dln * xhat).sum(dim=bt), dln.sum(dim=bt)


def _check_cuda_args(proj, norm, x, dy=None):
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be contiguous float32 (B, T, C)")
    channels = x.shape[-1]
    w = proj["w"]
    if w.dim() != 2 or w.shape[0] != channels:
        raise ValueError(f"input_proj w must be ({channels}, H), got {tuple(w.shape)}")
    hidden = w.shape[1]
    if hidden % 32 or hidden > 512:
        raise ValueError(f"the input block kernels need H % 32 == 0 and H <= 512, got {hidden}")
    for t in (proj["b"], norm["scale"], norm["bias"]):
        if tuple(t.shape) != (hidden,):
            raise ValueError(f"bias, scale and LayerNorm bias must be ({hidden},)")
    if any(t.device != x.device for t in (w, proj["b"], norm["scale"], norm["bias"])):
        raise ValueError("parameters must be on the input's device")
    if dy is not None and (dy.dtype != torch.float32 or dy.device != x.device
                           or tuple(dy.shape) != (*x.shape[:2], hidden)
                           or not dy.is_contiguous()):
        raise ValueError(f"dy must be contiguous float32 {(*x.shape[:2], hidden)}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def input_block_fused(proj: Mapping, norm: Mapping, x: torch.Tensor,
                      bf16: bool = False) -> torch.Tensor:
    """Kernel 9: ``gelu(LayerNorm(x @ W + b))`` over (B, T, C) windows ->
    (B, T, H) float32; ``bf16`` rounds x and W to bf16 (float32 sums), on
    the tensor cores. Its tiles and grid come from :func:`fwd_plan`."""
    if _device_kind("input_block_fwd", x) == "cpu":
        return input_block_fused_plain(proj, norm, x, bf16)
    _check_cuda_args(proj, norm, x)
    batch, steps, channels = x.shape
    hidden = proj["w"].shape[1]
    plan = fwd_plan(batch * steps, hidden)
    lib = kernels.load_library()
    y = torch.empty(batch, steps, hidden, dtype=torch.float32, device=x.device)
    w, b, gamma, beta = (_f32(t) for t in (proj["w"], proj["b"], norm["scale"], norm["bias"]))
    # the kernel streams x in 16-byte copies
    x_in = x if x.data_ptr() % 16 == 0 else x.clone()
    err = lib.eegflow_input_block_fwd(x_in.data_ptr(), w.data_ptr(), b.data_ptr(),
                                      gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                                      plan.ctas, plan.tile_rows, batch * steps, channels,
                                      hidden, int(bf16), kernels.stream(x.device))
    kernels.check(lib, err, "input_block_fwd")
    kernels.launch_counts["input_block_fwd"] += 1
    return y


def input_block_bwd(proj: Mapping, norm: Mapping, x: torch.Tensor, dy: torch.Tensor,
                    bf16: bool = False) -> Grads:
    """Kernel 10: the recomputing backward of :func:`input_block_fused` ->
    (dx, dW, db, dgamma, dbeta), as :func:`input_block_bwd_plain`. The kernel
    runs dx and dW on the tensor cores, in bf16 under ``bf16``, else in
    3xTF32, and takes the widths :func:`bwd_plan` allows."""
    if _device_kind("input_block_bwd", x) == "cpu":
        return input_block_bwd_plain(proj, norm, x, dy, bf16)
    _check_cuda_args(proj, norm, x, dy)
    batch, steps, channels = x.shape
    hidden = proj["w"].shape[1]
    rows = batch * steps
    plan = bwd_plan(rows, channels, hidden, bf16)
    lib = kernels.load_library()
    dev = x.device
    w, b, gamma, beta = (_f32(t) for t in (proj["w"], proj["b"], norm["scale"], norm["bias"]))
    # the kernel streams x and dy in 16-byte copies
    x_in = x if x.data_ptr() % 16 == 0 else x.clone()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    grads = torch.empty((channels + 3) * hidden, **f32)
    part = torch.empty(plan.part, **f32)
    err = lib.eegflow_input_block_bwd(
        x_in.data_ptr(), dy.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), dx.data_ptr(), grads.data_ptr(), part.data_ptr(), plan.ctas,
        plan.tile_rows, rows, channels, hidden, int(bf16), kernels.stream(dev))
    kernels.check(lib, err, "input_block_bwd")
    kernels.launch_counts["input_block_bwd"] += 1
    dw, vec = grads.split([channels * hidden, 3 * hidden])
    db, dgamma, dbeta = vec.split(hidden)
    return dx, dw.view(channels, hidden), db, dgamma, dbeta


class InputBlock(torch.autograd.Function):
    """``forward(kernel, bf16, x, w, b, gamma, beta) -> y`` through kernel 9
    (``kernel``) or its twin; the backward recomputes from x through kernel
    10 or its twin. Only x and the four parameters are saved."""

    @staticmethod
    def forward(ctx, kernel, bf16, x, w, b, gamma, beta):
        proj, norm = {"w": w, "b": b}, {"scale": gamma, "bias": beta}
        y = (input_block_fused if kernel else input_block_fused_plain)(proj, norm, x, bf16)
        ctx.kernel, ctx.bf16 = kernel, bf16
        ctx.save_for_backward(x, w, b, gamma, beta)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b, gamma, beta = ctx.saved_tensors
        bwd = input_block_bwd if ctx.kernel else input_block_bwd_plain
        dx, dw, db, dgamma, dbeta = bwd({"w": w, "b": b}, {"scale": gamma, "bias": beta}, x,
                                        dy.contiguous(), ctx.bf16)
        return None, None, dx, dw, db, dgamma, dbeta


def input_block(proj: Mapping, norm: Mapping, x: torch.Tensor, bf16: bool = False,
                kernel: bool = False) -> torch.Tensor:
    """The classifier's input block: through :class:`InputBlock` where
    gradients are enabled, else kernel 9 (``kernel``) or its twin alone."""
    if torch.is_grad_enabled():
        return InputBlock.apply(kernel, bf16, x, proj["w"], proj["b"], norm["scale"],
                                norm["bias"])
    return (input_block_fused if kernel else input_block_fused_plain)(proj, norm, x, bf16)
