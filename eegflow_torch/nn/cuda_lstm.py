"""LSTM layer-direction forward and backward kernels (``eegflow.nn.pallas_lstm``
counterpart), for both precision policies.

Five wrappers launch hand-written CUDA kernels for CUDA tensors; each
kernel source says which TPU kernel it replaces, what bounds it on the card
and how its design deals with that. The bf16 policy:

* :func:`lstm_fwd_fused_proj` — ``csrc/lstm_fwd.cu`` in eval mode: the
  reference's ``_fwd_proj_kernel`` (entry ``lstm_fwd_fused_proj``) with
  ``need_residuals=False`` and no dropout.
* :func:`lstm_fwd_train` — the same kernel in training mode: uint8 keep-masks
  on the input parts and the six adjoint planes of the reference's default
  residual contract (``_ADJ_RES=1``).
* :func:`lstm_bwd` — ``csrc/lstm_bwd.cu``: ``_bwd_fused_kernel`` (entry
  ``lstm_bwd_fused``), the adjoint from those planes to dx, dW_ih, dW_hh, db.

The float32 policy, whose input projection and weight products stay
``torch.matmul`` as the reference leaves them to XLA:

* :func:`lstm_recurrence` — ``csrc/lstm_rec.cu``: ``_lstm_chunk_kernel``
  (entry ``lstm_recurrence_pallas``), the recurrence over precomputed gates;
  in training mode it also writes c.
* :func:`lstm_recurrence_backward` — ``csrc/lstm_rec.cu``:
  ``_lstm_bwd_chunk_kernel`` (entry ``lstm_recurrence_backward``), dgates
  from (gates, h, c), plus dW_hh.

Each has a plain PyTorch twin in this module (``*_plain``). For CPU tensors a
wrapper runs its twin; for CUDA tensors it launches the kernel or raises.
:class:`BiLSTMLayer` (bf16) and :class:`BiLSTMLayerF32` (float32) put both
directions of a bidirectional layer under one ``torch.autograd.Function``,
as ``_bilstm_layer_fused_core`` does; the bf16 one's second backward adds
the first's dx in its kernel, the float32 one adds the two dx, as the
reference's float32 fallback does.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from eegflow_torch import kernels
from eegflow_torch.nn.layers import bf16_round

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]
Masks = Optional[Sequence[Optional[torch.Tensor]]]


def as_parts(xs: Parts) -> Tuple[torch.Tensor, ...]:
    return (xs,) if isinstance(xs, torch.Tensor) else tuple(xs)


def _mask_list(masks: Masks, n: int) -> Tuple[Optional[torch.Tensor], ...]:
    if masks is None:
        return (None,) * n
    masks = tuple(masks)
    if len(masks) != n:
        raise ValueError(f"{len(masks)} masks for {n} input parts")
    return masks


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    """sigmoid through the tanh identity, as the kernels evaluate it."""
    return 0.5 * torch.tanh(0.5 * z) + 0.5


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor], keep: float) -> torch.Tensor:
    """Inverted dropout with a keep-mask (nonzero = kept), as the kernels apply
    it on load: ``where(m, x * (1/keep), 0)``."""
    if mask is None:
        return x
    return torch.where(mask != 0, x * (1.0 / keep), torch.zeros((), dtype=x.dtype,
                                                               device=x.device))


def _lstm_fwd_plain(xs, w_ih, b, w_hh, reverse, masks, keep, residuals):
    xs = as_parts(xs)
    masks = _mask_list(masks, len(xs))
    widths = [p.shape[-1] for p in xs]
    gates = b + sum(bf16_round(apply_mask(x, m, keep)) @ bf16_round(w)
                    for x, m, w in zip(xs, masks, torch.split(w_ih, widths, dim=0)))
    batch, steps, _ = xs[0].shape
    hidden = w_hh.shape[0]
    whh = bf16_round(w_hh)
    dev = xs[0].device
    h = torch.zeros(batch, hidden, dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    out = torch.empty(batch, steps, hidden, dtype=torch.float32, device=dev)
    res = (torch.empty(batch, steps, 6 * hidden, dtype=torch.float32, device=dev)
           if residuals else None)
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    for t in order:
        z = gates[:, t] + bf16_round(h) @ whh
        zi, zf, zg, zo = z.split(hidden, dim=-1)
        i, f, g, o = _sigmoid(zi), _sigmoid(zf), torch.tanh(zg), _sigmoid(zo)
        c_prev = c
        c = f * c_prev + i * g
        tc = torch.tanh(c)
        h = o * tc
        out[:, t] = h
        if residuals:
            res[:, t] = torch.cat([g * (i * (1 - i)), c_prev * (f * (1 - f)),
                                   i * (1 - g * g), o * (1 - tc * tc), f,
                                   tc * (o * (1 - o))], dim=-1)
    return out, res


def lstm_fwd_fused_proj_plain(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor,
                              w_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain twin of the eval-mode kernel: parts (B, T, D_p) -> h (B, T, H).

    z = b + sum_p bf16(x_p) . bf16(W_ih_p) + bf16(h) . bf16(W_hh), products
    accumulated in float32; W_ih is split by rows to match the parts.
    """
    return _lstm_fwd_plain(xs, w_ih, b, w_hh, reverse, None, 1.0, False)[0]


def lstm_fwd_train_plain(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor,
                         w_hh: torch.Tensor, reverse: bool = False, masks: Masks = None,
                         keep: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the training-mode kernel: -> (h (B, T, H), residual
    planes (B, T, 6H)). Each part is masked as ``apply_mask`` does before the
    bf16 rounding; the planes are [g i(1-i), c_prev f(1-f), i(1-g^2),
    o(1-tanh^2 c), f, tanh(c) o(1-o)] of every step."""
    return _lstm_fwd_plain(xs, w_ih, b, w_hh, reverse, masks, keep, True)


def _check_cuda_args(xs, w_ih, b, w_hh, masks=None):
    dev = xs[0].device
    if len(xs) not in (1, 2):
        raise ValueError(f"lstm_fwd takes 1 or 2 input parts, got {len(xs)}")
    batch, steps = xs[0].shape[:2]
    for x in xs:
        if x.device != dev or x.dtype != torch.float32 or x.dim() != 3:
            raise ValueError("input parts must be float32 (B, T, D_p) on one device")
        if tuple(x.shape[:2]) != (batch, steps):
            raise ValueError("input parts disagree on (B, T)")
        if not x.is_contiguous():
            raise ValueError("input parts must be contiguous")
    for x, m in zip(xs, _mask_list(masks, len(xs))):
        if m is not None and (m.dtype != torch.uint8 or m.shape != x.shape
                              or m.device != dev or not m.is_contiguous()):
            raise ValueError("masks must be contiguous uint8 tensors shaped like their parts")
    hidden = w_hh.shape[0]
    d_total = sum(x.shape[-1] for x in xs)
    if tuple(w_hh.shape) != (hidden, 4 * hidden):
        raise ValueError(f"w_hh must be (H, 4H), got {tuple(w_hh.shape)}")
    if tuple(w_ih.shape) != (d_total, 4 * hidden):
        raise ValueError(f"w_ih must be ({d_total}, {4 * hidden}), got {tuple(w_ih.shape)}")
    if b is not None and tuple(b.shape) != (4 * hidden,):
        raise ValueError(f"b must be ({4 * hidden},), got {tuple(b.shape)}")
    if hidden % 32 or hidden > 512:
        raise ValueError(f"the lstm kernels need H % 32 == 0 and H <= 512, got {hidden}")
    for w in (w_ih, b, w_hh):
        if w is not None and w.device != dev:
            raise ValueError("weights must be on the inputs' device")


def _device_kind(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def lstm_fwd_fused_proj(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor,
                        w_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One LSTM direction over input parts (B, T, D_p) -> h (B, T, H) float32.

    Weights in the JAX layout: ``w_ih`` (sum D_p, 4H), ``b`` (4H,), ``w_hh``
    (H, 4H), gate order i, f, g, o. ``reverse`` walks t from T-1 down to 0
    and writes ``h[:, t]`` at its natural position.
    """
    xs = as_parts(xs)
    if _device_kind("lstm_fwd", xs[0]) == "cpu":
        return lstm_fwd_fused_proj_plain(xs, w_ih, b, w_hh, reverse)
    _check_cuda_args(xs, w_ih, b, w_hh)
    lib = kernels.load_library()
    dev = xs[0].device
    batch, steps = xs[0].shape[:2]
    hidden = w_hh.shape[0]
    widths = [x.shape[-1] for x in xs]
    w_parts = torch.split(w_ih.to(torch.bfloat16).contiguous(), widths, dim=0)
    whh = w_hh.to(torch.bfloat16).contiguous()
    bias = b.to(torch.float32).contiguous()
    out = torch.empty(batch, steps, hidden, dtype=torch.float32, device=dev)
    two = len(xs) == 2
    err = lib.eegflow_lstm_fwd(
        xs[0].data_ptr(), _ptr(xs[1]) if two else None,
        widths[0], widths[1] if two else 0,
        w_parts[0].data_ptr(), w_parts[1].data_ptr() if two else None,
        bias.data_ptr(), whh.data_ptr(), out.data_ptr(),
        batch, steps, hidden, int(reverse), _stream(dev))
    kernels.check(lib, err, "lstm_fwd")
    kernels.launch_counts["lstm_fwd"] += 1
    return out


def lstm_fwd_train(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor, w_hh: torch.Tensor,
                   reverse: bool = False, masks: Masks = None,
                   keep: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-mode forward: -> (h (B, T, H), planes (B, T, 6H)), float32.

    ``masks``: one uint8 keep-mask (B, T, D_p) per part or None (0 = dropped,
    kept values scaled by 1/keep, as :func:`apply_mask`).
    """
    xs = as_parts(xs)
    if _device_kind("lstm_fwd_train", xs[0]) == "cpu":
        return lstm_fwd_train_plain(xs, w_ih, b, w_hh, reverse, masks, keep)
    _check_cuda_args(xs, w_ih, b, w_hh, masks)
    masks = _mask_list(masks, len(xs))
    lib = kernels.load_library()
    dev = xs[0].device
    batch, steps = xs[0].shape[:2]
    hidden = w_hh.shape[0]
    widths = [x.shape[-1] for x in xs]
    w_parts = torch.split(w_ih.to(torch.bfloat16).contiguous(), widths, dim=0)
    whh = w_hh.to(torch.bfloat16).contiguous()
    bias = b.to(torch.float32).contiguous()
    out = torch.empty(batch, steps, hidden, dtype=torch.float32, device=dev)
    res = torch.empty(batch, steps, 6 * hidden, dtype=torch.float32, device=dev)
    two = len(xs) == 2
    err = lib.eegflow_lstm_fwd_train(
        xs[0].data_ptr(), _ptr(xs[1]) if two else None,
        _ptr(masks[0]), _ptr(masks[1]) if two else None,
        widths[0], widths[1] if two else 0, 1.0 / keep,
        w_parts[0].data_ptr(), w_parts[1].data_ptr() if two else None,
        bias.data_ptr(), whh.data_ptr(), out.data_ptr(), res.data_ptr(),
        batch, steps, hidden, int(reverse), _stream(dev))
    kernels.check(lib, err, "lstm_fwd_train")
    kernels.launch_counts["lstm_fwd_train"] += 1
    return out, res


Grads = Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]


def lstm_bwd_plain(res: torch.Tensor, h: torch.Tensor, g: torch.Tensor, xs: Parts,
                   w_ih: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
                   masks: Masks = None, keep: float = 1.0,
                   dx_add: Optional[Sequence[torch.Tensor]] = None) -> Grads:
    """Plain twin of the backward kernel: -> (dx parts, dW_ih, dW_hh, db).

    The adjoint walks against the direction of time from the planes ``res``
    (dh = g + dh_carry; dc = dh E + dc_carry; dz = [dc A, dc B, dc C, dh G];
    dc_carry = dc F; dh_carry = bf16(dz) . bf16(W_hh)^T). The products take
    bf16(dz), db sums the float32 dz, dx is masked like the input and
    ``dx_add`` (the sibling direction's dx) is added last.
    """
    xs = as_parts(xs)
    masks = _mask_list(masks, len(xs))
    batch, steps, _ = res.shape
    hidden = w_hh.shape[0]
    whh_t = bf16_round(w_hh).t()
    dh_c = torch.zeros(batch, hidden, dtype=torch.float32, device=res.device)
    dc_c = torch.zeros_like(dh_c)
    dz = torch.empty(batch, steps, 4 * hidden, dtype=torch.float32, device=res.device)
    order = range(steps) if reverse else range(steps - 1, -1, -1)
    for t in order:
        a, b_, c, e, f, gg = res[:, t].split(hidden, dim=-1)
        dh = g[:, t] + dh_c
        dc = dh * e + dc_c
        dc_c = dc * f
        z = torch.cat([dc * a, dc * b_, dc * c, dh * gg], dim=-1)
        dz[:, t] = z
        dh_c = bf16_round(z) @ whh_t
    dz16 = bf16_round(dz).reshape(batch * steps, 4 * hidden)
    zero = torch.zeros_like(h[:, :1])
    h_prev = (torch.cat([h[:, 1:], zero], dim=1) if reverse
              else torch.cat([zero, h[:, :-1]], dim=1))
    dw_hh = bf16_round(h_prev).reshape(-1, hidden).t() @ dz16
    db = dz.sum(dim=(0, 1))
    widths = [p.shape[-1] for p in xs]
    dxs, dw_ih = [], []
    for q, (x, m, w) in enumerate(zip(xs, masks, torch.split(w_ih, widths, dim=0))):
        xm = bf16_round(apply_mask(x, m, keep)).reshape(-1, x.shape[-1])
        dw_ih.append(xm.t() @ dz16)
        dx = apply_mask((dz16 @ bf16_round(w).t()).reshape(x.shape), m, keep)
        if dx_add is not None:
            dx = dx + dx_add[q]
        dxs.append(dx)
    return tuple(dxs), torch.cat(dw_ih, dim=0), dw_hh, db


def lstm_bwd(res: torch.Tensor, h: torch.Tensor, g: torch.Tensor, xs: Parts,
             w_ih: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
             masks: Masks = None, keep: float = 1.0,
             dx_add: Optional[Sequence[torch.Tensor]] = None) -> Grads:
    """Backward of one layer-direction from its training-mode forward:
    ``res`` (B, T, 6H) planes, ``h`` (B, T, H), upstream ``g`` (B, T, H), the
    same input parts and masks as the forward -> (dx parts, dW_ih (D, 4H),
    dW_hh (H, 4H), db (4H,)), float32."""
    xs = as_parts(xs)
    if _device_kind("lstm_bwd", res) == "cpu":
        return lstm_bwd_plain(res, h, g, xs, w_ih, w_hh, reverse, masks, keep, dx_add)
    _check_cuda_args(xs, w_ih, None, w_hh, masks)
    masks = _mask_list(masks, len(xs))
    batch, steps = xs[0].shape[:2]
    hidden = w_hh.shape[0]
    for name, t, width in (("res", res, 6 * hidden), ("h", h, hidden), ("g", g, hidden)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (batch, steps, width)
                or t.device != xs[0].device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({batch}, {steps}, {width})")
    if dx_add is not None:
        dx_add = tuple(dx_add)
        if len(dx_add) != len(xs) or any(
                d.shape != x.shape or d.dtype != torch.float32 or not d.is_contiguous()
                or d.device != x.device for d, x in zip(dx_add, xs)):
            raise ValueError("dx_add must hold one contiguous float32 tensor per part")
    lib = kernels.load_library()
    dev = xs[0].device
    gates = 4 * hidden
    widths = [x.shape[-1] for x in xs]
    w_parts = torch.split(w_ih.to(torch.bfloat16).contiguous(), widths, dim=0)
    whh_t = w_hh.to(torch.bfloat16).t().contiguous()
    dxs = [torch.empty_like(x) for x in xs]
    dw_ih = torch.empty(sum(widths), gates, dtype=torch.float32, device=dev)
    dw_hh = torch.empty(hidden, gates, dtype=torch.float32, device=dev)
    db = torch.empty(gates, dtype=torch.float32, device=dev)
    dz = torch.empty(batch, steps, gates, dtype=torch.float32, device=dev)
    splits = kernels.gemm_splits(batch * steps)
    part = torch.empty(splits * max(widths + [hidden]) * gates, dtype=torch.float32,
                       device=dev)
    two = len(xs) == 2
    err = lib.eegflow_lstm_bwd(
        res.data_ptr(), h.data_ptr(), g.data_ptr(),
        xs[0].data_ptr(), _ptr(xs[1]) if two else None,
        _ptr(masks[0]), _ptr(masks[1]) if two else None,
        widths[0], widths[1] if two else 0, 1.0 / keep,
        w_parts[0].data_ptr(), w_parts[1].data_ptr() if two else None, whh_t.data_ptr(),
        _ptr(dx_add[0]) if dx_add else None, _ptr(dx_add[1]) if dx_add and two else None,
        dxs[0].data_ptr(), dxs[1].data_ptr() if two else None,
        dw_ih.data_ptr(), dw_hh.data_ptr(), db.data_ptr(), dz.data_ptr(), part.data_ptr(),
        splits, batch, steps, hidden, int(reverse), _stream(dev))
    kernels.check(lib, err, "lstm_bwd")
    kernels.launch_counts["lstm_bwd"] += 1
    return tuple(dxs), dw_ih, dw_hh, db


class BiLSTMLayer(torch.autograd.Function):
    """One LSTM layer over input parts, both directions under one Function.

    ``forward(kernel, keep, m0, m1, x0, x1, w_ih_f, w_hh_f, b_f, w_ih_b,
    w_hh_b, b_b) -> (h_f, h_b)`` (``x1``/``m1`` None for a one-part input;
    the ``_b`` weights None for a unidirectional layer, which returns
    ``(h_f,)``). The masks are shared by both directions. ``kernel`` picks the
    CUDA wrappers (:func:`lstm_fwd_train`, :func:`lstm_bwd`) or their twins.
    The backward runs the forward direction's adjoint, then the reverse
    direction's with the first dx added in.
    """

    @staticmethod
    def forward(ctx, kernel, keep, m0, m1, x0, x1, w_ih_f, w_hh_f, b_f,
                w_ih_b=None, w_hh_b=None, b_b=None):
        xs = (x0,) if x1 is None else (x0, x1)
        masks = None if m0 is None else ((m0,) if x1 is None else (m0, m1))
        fwd = lstm_fwd_train if kernel else lstm_fwd_train_plain
        h_f, res_f = fwd(xs, w_ih_f, b_f, w_hh_f, False, masks, keep)
        outs, saved = [h_f], [res_f, h_f]
        if w_ih_b is not None:
            h_b, res_b = fwd(xs, w_ih_b, b_b, w_hh_b, True, masks, keep)
            outs.append(h_b)
            saved += [res_b, h_b]
        ctx.kernel, ctx.keep, ctx.two = kernel, keep, x1 is not None
        ctx.bidirectional = w_ih_b is not None
        ctx.save_for_backward(x0, x1, m0, m1, w_ih_f, w_hh_f, w_ih_b, w_hh_b, *saved)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        x0, x1, m0, m1, w_ih_f, w_hh_f, w_ih_b, w_hh_b, *saved = ctx.saved_tensors
        xs = (x0, x1) if ctx.two else (x0,)
        masks = None if m0 is None else ((m0, m1) if ctx.two else (m0,))
        bwd = lstm_bwd if ctx.kernel else lstm_bwd_plain
        dxs, dwih_f, dwhh_f, db_f = bwd(saved[0], saved[1], grads[0].contiguous(), xs,
                                        w_ih_f, w_hh_f, False, masks, ctx.keep)
        dwih_b = dwhh_b = db_b = None
        if ctx.bidirectional:
            dxs, dwih_b, dwhh_b, db_b = bwd(saved[2], saved[3], grads[1].contiguous(), xs,
                                            w_ih_b, w_hh_b, True, masks, ctx.keep, dxs)
        return (None, None, None, None, dxs[0], dxs[1] if ctx.two else None,
                dwih_f, dwhh_f, db_f, dwih_b, dwhh_b, db_b)


def bilstm_layer(layer: Mapping, xs: Parts, masks: Masks = None, keep: float = 1.0,
                 kernel: bool = False, bf16: bool = True) -> Tuple[torch.Tensor, ...]:
    """One layer of the stack (``{"fwd": ..., "bwd": ...}`` params) over input
    parts, differentiable through :class:`BiLSTMLayer` (the bf16 policy) or
    :class:`BiLSTMLayerF32` (``bf16=False``) -> output parts."""
    xs = as_parts(xs)
    ms = _mask_list(masks, len(xs))
    two = len(xs) == 2
    pf, pb = layer["fwd"], (layer["bwd"] if "bwd" in layer else None)
    weights = [pf["w_ih"], pf["w_hh"], pf["b"]]
    if pb is not None:
        weights += [pb["w_ih"], pb["w_hh"], pb["b"]]
    fn = BiLSTMLayer if bf16 else BiLSTMLayerF32
    return fn.apply(kernel, float(keep), ms[0], ms[1] if two else None,
                    xs[0], xs[1] if two else None, *weights)


# ---------------------------------------------------------------------------
# The float32 policy: recurrence-only kernels over precomputed gates
# ---------------------------------------------------------------------------


def _shift(seq: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The state before each step: seq[:, t-1] (seq[:, t+1] for the reverse
    direction), zero before the direction's first step."""
    zero = torch.zeros_like(seq[:, :1])
    if reverse:
        return torch.cat([seq[:, 1:], zero], dim=1)
    return torch.cat([zero, seq[:, :-1]], dim=1)


def _dw_hh(h: torch.Tensor, dgates: torch.Tensor, reverse: bool) -> torch.Tensor:
    """dW_hh = sum over (b, t) of h_prev^T dgates, float32 (the reference's
    einsum outside its kernel)."""
    hidden = h.shape[-1]
    return _shift(h, reverse).reshape(-1, hidden).t() @ dgates.reshape(-1, 4 * hidden)


def lstm_recurrence_plain(gates: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
                          collect_cell: bool = False):
    """Plain twin of kernel 1: gates (B, T, 4H) -> h (B, T, H), or (h, c)
    with ``collect_cell``. z = gates[t] + h_prev . W_hh in float32, gate order
    i, f, g, o, the tanh-form sigmoid, zero initial state."""
    batch, steps, g4 = gates.shape
    hidden = g4 // 4
    h = torch.zeros(batch, hidden, dtype=torch.float32, device=gates.device)
    c = torch.zeros_like(h)
    hs = torch.empty(batch, steps, hidden, dtype=torch.float32, device=gates.device)
    cs = torch.empty_like(hs) if collect_cell else None
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        zi, zf, zg, zo = (gates[:, t] + h @ w_hh).split(hidden, dim=-1)
        c = _sigmoid(zf) * c + _sigmoid(zi) * torch.tanh(zg)
        h = _sigmoid(zo) * torch.tanh(c)
        hs[:, t] = h
        if collect_cell:
            cs[:, t] = c
    return (hs, cs) if collect_cell else hs


def lstm_recurrence_backward_plain(gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                                   w_hh: torch.Tensor, g: torch.Tensor,
                                   reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of kernel 5: -> (dgates (B, T, 4H), dW_hh (H, 4H)).

    The activations are recomputed from z = gates + h_prev . W_hh; the
    adjoint walks against the direction of time (dh = g + dh_carry,
    dc = dh o (1 - tanh^2 c) + dc_carry, dz = [dc g i(1-i), dc c_prev f(1-f),
    dc i (1-g^2), dh tanh(c) o(1-o)], dc_carry = dc f, dh_carry =
    dz . W_hh^T), all in float32.
    """
    batch, steps, g4 = gates.shape
    hidden = g4 // 4
    zi, zf, zg, zo = (gates + _shift(h, reverse) @ w_hh).split(hidden, dim=-1)
    i, f, gg, o = _sigmoid(zi), _sigmoid(zf), torch.tanh(zg), _sigmoid(zo)
    c_prev, tc = _shift(c, reverse), torch.tanh(c)
    whh_t = w_hh.t()
    dh_c = torch.zeros(batch, hidden, dtype=torch.float32, device=gates.device)
    dc_c = torch.zeros_like(dh_c)
    dgates = torch.empty_like(gates)
    for t in (range(steps) if reverse else range(steps - 1, -1, -1)):
        dh = g[:, t] + dh_c
        dc = dh * o[:, t] * (1 - tc[:, t] * tc[:, t]) + dc_c
        dc_c = dc * f[:, t]
        dz = torch.cat([dc * gg[:, t] * i[:, t] * (1 - i[:, t]),
                        dc * c_prev[:, t] * f[:, t] * (1 - f[:, t]),
                        dc * i[:, t] * (1 - gg[:, t] * gg[:, t]),
                        dh * tc[:, t] * o[:, t] * (1 - o[:, t])], dim=-1)
        dgates[:, t] = dz
        dh_c = dz @ whh_t
    return dgates, _dw_hh(h, dgates, reverse)


def _check_rec_args(gates, w_hh, *seqs):
    if gates.dtype != torch.float32 or gates.dim() != 3 or not gates.is_contiguous():
        raise ValueError("gates must be contiguous float32 (B, T, 4H)")
    batch, steps, g4 = gates.shape
    hidden = g4 // 4
    if g4 != 4 * hidden or tuple(w_hh.shape) != (hidden, 4 * hidden):
        raise ValueError(f"w_hh must be (H, 4H) = ({hidden}, {g4}), got {tuple(w_hh.shape)}")
    if hidden % 32 or hidden > 512:
        raise ValueError(f"the lstm kernels need H % 32 == 0 and H <= 512, got {hidden}")
    for name, t in seqs:
        if (t.dtype != torch.float32 or tuple(t.shape) != (batch, steps, hidden)
                or not t.is_contiguous() or t.device != gates.device):
            raise ValueError(f"{name} must be contiguous float32 ({batch}, {steps}, {hidden})")
    if w_hh.device != gates.device:
        raise ValueError("w_hh must be on the gates' device")


def lstm_recurrence(gates: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
                    collect_cell: bool = False):
    """Kernel 1: precomputed gates (B, T, 4H) float32 -> h (B, T, H), or
    (h, c) with ``collect_cell`` (training mode). Counted as ``lstm_rec_fwd``
    (eval) or ``lstm_rec_fwd_train``."""
    if _device_kind("lstm_rec_fwd", gates) == "cpu":
        return lstm_recurrence_plain(gates, w_hh, reverse, collect_cell)
    _check_rec_args(gates, w_hh)
    lib = kernels.load_library()
    dev = gates.device
    batch, steps, g4 = gates.shape
    hidden = g4 // 4
    whh = w_hh.to(torch.float32).contiguous()
    h = torch.empty(batch, steps, hidden, dtype=torch.float32, device=dev)
    c = torch.empty_like(h) if collect_cell else None
    name = "lstm_rec_fwd_train" if collect_cell else "lstm_rec_fwd"
    err = lib.eegflow_lstm_rec_fwd(gates.data_ptr(), whh.data_ptr(), h.data_ptr(), _ptr(c),
                                   batch, steps, hidden, int(reverse), _stream(dev))
    kernels.check(lib, err, name)
    kernels.launch_counts[name] += 1
    return (h, c) if collect_cell else h


def lstm_recurrence_backward(gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                             w_hh: torch.Tensor, g: torch.Tensor,
                             reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5: the adjoint of :func:`lstm_recurrence` from its training-mode
    (gates, h, c) and the upstream gradient ``g`` of h -> (dgates (B, T, 4H),
    dW_hh (H, 4H)), float32. dW_hh is a ``torch.matmul`` outside the kernel,
    as in the reference."""
    if _device_kind("lstm_rec_bwd", gates) == "cpu":
        return lstm_recurrence_backward_plain(gates, h, c, w_hh, g, reverse)
    _check_rec_args(gates, w_hh, ("h", h), ("c", c), ("g", g))
    lib = kernels.load_library()
    dev = gates.device
    batch, steps, g4 = gates.shape
    whh = w_hh.to(torch.float32).contiguous()
    whh_t = whh.t().contiguous()
    dgates = torch.empty_like(gates)
    err = lib.eegflow_lstm_rec_bwd(gates.data_ptr(), h.data_ptr(), c.data_ptr(), g.data_ptr(),
                                   whh.data_ptr(), whh_t.data_ptr(), dgates.data_ptr(),
                                   batch, steps, g4 // 4, int(reverse), _stream(dev))
    kernels.check(lib, err, "lstm_rec_bwd")
    kernels.launch_counts["lstm_rec_bwd"] += 1
    return dgates, _dw_hh(h, dgates, reverse)


def _gates(xs: Sequence[torch.Tensor], w_ih: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """concat(xs) . W_ih + b (B, T, 4H), one float32 ``torch.addmm``."""
    x = xs[0] if len(xs) == 1 else torch.cat(tuple(xs), dim=-1)
    batch, steps, width = x.shape
    return torch.addmm(b, x.reshape(-1, width), w_ih).reshape(batch, steps, -1)


def lstm_rec_layer(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor, w_hh: torch.Tensor,
                   reverse: bool = False, kernel: bool = False) -> torch.Tensor:
    """One layer-direction under the float32 policy in eval mode (no
    residuals): gates by ``torch.addmm``, then kernel 1 (``kernel``) or its
    twin -> h (B, T, H)."""
    rec = lstm_recurrence if kernel else lstm_recurrence_plain
    return rec(_gates(as_parts(xs), w_ih, b), w_hh, reverse, False)


class BiLSTMLayerF32(torch.autograd.Function):
    """One LSTM layer under the float32 policy, over input parts, both
    directions under one Function (the reference's ``_bilstm_fwd`` /
    ``_bilstm_bwd`` float32 branch).

    ``forward(kernel, keep, m0, m1, x0, x1, w_ih_f, w_hh_f, b_f, w_ih_b,
    w_hh_b, b_b) -> (h_f, h_b)``, arguments as :class:`BiLSTMLayer`. The
    masks are applied outside the kernels, as ``_apply_masks_xla`` does:
    before the projection and on dx. Per direction the forward runs
    gates = masked x . W_ih + b and kernel 1 in training mode, and saves
    (gates, h, c); the backward runs kernel 5, then dW_ih = x^T dgates,
    dx = dgates W_ih^T (masked) and db as ``torch.matmul`` and sums, and adds
    the two directions' dx.
    """

    @staticmethod
    def forward(ctx, kernel, keep, m0, m1, x0, x1, w_ih_f, w_hh_f, b_f,
                w_ih_b=None, w_hh_b=None, b_b=None):
        xs = (x0,) if x1 is None else (x0, x1)
        masks = (m0,) if x1 is None else (m0, m1)
        xe = tuple(apply_mask(x, m, keep) for x, m in zip(xs, masks))
        rec = lstm_recurrence if kernel else lstm_recurrence_plain
        dirs = [(w_ih_f, w_hh_f, b_f, False)]
        if w_ih_b is not None:
            dirs.append((w_ih_b, w_hh_b, b_b, True))
        outs, saved = [], []
        for w_ih, w_hh, b, reverse in dirs:
            gates = _gates(xe, w_ih, b)
            h, c = rec(gates, w_hh, reverse, True)
            outs.append(h)
            saved += [gates, h, c]
        ctx.kernel, ctx.keep, ctx.two = kernel, keep, x1 is not None
        ctx.save_for_backward(x0, x1, m0, m1, w_ih_f, w_hh_f, w_ih_b, w_hh_b, *saved)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        x0, x1, m0, m1, w_ih_f, w_hh_f, w_ih_b, w_hh_b, *saved = ctx.saved_tensors
        xs = (x0, x1) if ctx.two else (x0,)
        masks = (m0, m1) if ctx.two else (m0,)
        xe = tuple(apply_mask(x, m, ctx.keep) for x, m in zip(xs, masks))
        widths = [x.shape[-1] for x in xs]
        bwd = lstm_recurrence_backward if ctx.kernel else lstm_recurrence_backward_plain
        dxs, out = None, []
        for d, (w_ih, w_hh) in enumerate(((w_ih_f, w_hh_f), (w_ih_b, w_hh_b))[:len(grads)]):
            gates, h, c = saved[3 * d: 3 * d + 3]
            dgates, dw_hh = bwd(gates, h, c, w_hh, grads[d].contiguous(), d == 1)
            dz = dgates.reshape(-1, dgates.shape[-1])
            dw_ih = torch.cat([x.reshape(-1, x.shape[-1]).t() @ dz for x in xe], dim=0)
            dx = tuple(apply_mask((dz @ w.t()).reshape(x.shape), m, ctx.keep)
                       for x, m, w in zip(xs, masks, torch.split(w_ih, widths, dim=0)))
            dxs = dx if dxs is None else tuple(a + b for a, b in zip(dxs, dx))
            out += [dw_ih, dw_hh, dgates.sum(dim=(0, 1))]
        out += [None] * (6 - len(out))
        return (None, None, None, None, dxs[0], dxs[1] if ctx.two else None, *out)
