"""LSTM layer-direction forward and backward kernels (``eegflow.nn.pallas_lstm``
counterpart), for both precision policies.

Eight wrappers launch hand-written CUDA kernels for CUDA tensors; each
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
* :func:`lstm_fwd_train_gates` — ``csrc/lstm_fwd.cu`` in raw-gate training
  mode (``_ADJ_RES=0``): the post-activation gates and c of every step.
* :func:`lstm_bwd_v2` — ``csrc/lstm_bwd_v2.cu``: ``_bwd_fused_kernel_v2``
  (``EEGFLOW_BWD_V2``), the two-pass adjoint from raw gates and c.
* :func:`lstm_bwd_dualdir` — ``csrc/lstm_bwd_dualdir.cu``:
  ``_bwd_dualdir_kernel`` (entry ``lstm_bwd_dualdir``), both directions'
  adjoints from their planes in one launch, with the mask of select dropout
  recovered from the dropped input's zeros (``mask_from_x``).

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
as ``_bilstm_layer_fused_core`` does; the float32 one adds the two dx, as the
reference's float32 fallback does. The bf16 one runs one of three backward
schedules (``lstm_bwd``, :data:`LSTM_BWD_SCHEDULES`), each the reference's
bf16 path under one set of its flags:

* ``"fused"`` (``EEGFLOW_MASK_DROPOUT=1``): training-mode forwards with
  uint8 masks, then :func:`lstm_bwd` per direction, the second adding the
  first's dx in its kernel;
* ``"two_pass"`` (+ ``EEGFLOW_ADJOINT_RES=0``, ``EEGFLOW_BWD_V2=1``):
  raw-gate forwards with uint8 masks, then :func:`lstm_bwd_v2` per
  direction, the second adding the first's dx;
* ``"dualdir"`` (``EEGFLOW_BWD_DUALDIR=1``, select dropout): the parts
  arrive already dropped by :func:`select_dropout`, the forwards take no
  masks, and one :func:`lstm_bwd_dualdir` launch gives both directions'
  gradients. Bidirectional layers only.
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


def _lstm_fwd_plain(xs, w_ih, b, w_hh, reverse, masks, keep, residuals=None):
    """The forward twins' loop. ``residuals``: None, ``"planes"`` (the six
    adjoint planes) or ``"gates"`` (the post-activation gates and c)."""
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
    width = {None: 0, "planes": 6 * hidden, "gates": 4 * hidden}[residuals]
    res = torch.empty(batch, steps, width, dtype=torch.float32, device=dev)
    cs = torch.empty_like(out) if residuals == "gates" else None
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
        if residuals == "planes":
            res[:, t] = torch.cat([g * (i * (1 - i)), c_prev * (f * (1 - f)),
                                   i * (1 - g * g), o * (1 - tc * tc), f,
                                   tc * (o * (1 - o))], dim=-1)
        elif residuals == "gates":
            res[:, t] = torch.cat([i, f, g, o], dim=-1)
            cs[:, t] = c
    if residuals == "gates":
        return out, res, cs
    return out, res


def lstm_fwd_fused_proj_plain(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor,
                              w_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain twin of the eval-mode kernel: parts (B, T, D_p) -> h (B, T, H).

    z = b + sum_p bf16(x_p) . bf16(W_ih_p) + bf16(h) . bf16(W_hh), products
    accumulated in float32; W_ih is split by rows to match the parts.
    """
    return _lstm_fwd_plain(xs, w_ih, b, w_hh, reverse, None, 1.0)[0]


def lstm_fwd_train_plain(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor,
                         w_hh: torch.Tensor, reverse: bool = False, masks: Masks = None,
                         keep: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the training-mode kernel: -> (h (B, T, H), residual
    planes (B, T, 6H)). Each part is masked as ``apply_mask`` does before the
    bf16 rounding; the planes are [g i(1-i), c_prev f(1-f), i(1-g^2),
    o(1-tanh^2 c), f, tanh(c) o(1-o)] of every step."""
    return _lstm_fwd_plain(xs, w_ih, b, w_hh, reverse, masks, keep, "planes")


def lstm_fwd_train_gates_plain(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor,
                               w_hh: torch.Tensor, reverse: bool = False, masks: Masks = None,
                               keep: float = 1.0
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the raw-gate training mode: -> (h (B, T, H), gates
    (B, T, 4H), c (B, T, H)); the gates are the post-activation [i, f, g, o]
    of every step, the inputs masked as :func:`lstm_fwd_train_plain`."""
    return _lstm_fwd_plain(xs, w_ih, b, w_hh, reverse, masks, keep, "gates")


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


def lstm_fwd_train_gates(xs: Parts, w_ih: torch.Tensor, b: torch.Tensor, w_hh: torch.Tensor,
                         reverse: bool = False, masks: Masks = None, keep: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw-gate training-mode forward: -> (h (B, T, H), gates (B, T, 4H),
    c (B, T, H)), float32; ``masks`` as :func:`lstm_fwd_train`."""
    xs = as_parts(xs)
    if _device_kind("lstm_fwd_train_gates", xs[0]) == "cpu":
        return lstm_fwd_train_gates_plain(xs, w_ih, b, w_hh, reverse, masks, keep)
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
    gates = torch.empty(batch, steps, 4 * hidden, dtype=torch.float32, device=dev)
    c = torch.empty_like(out)
    two = len(xs) == 2
    err = lib.eegflow_lstm_fwd_train_gates(
        xs[0].data_ptr(), _ptr(xs[1]) if two else None,
        _ptr(masks[0]), _ptr(masks[1]) if two else None,
        widths[0], widths[1] if two else 0, 1.0 / keep,
        w_parts[0].data_ptr(), w_parts[1].data_ptr() if two else None,
        bias.data_ptr(), whh.data_ptr(), out.data_ptr(), gates.data_ptr(), c.data_ptr(),
        batch, steps, hidden, int(reverse), _stream(dev))
    kernels.check(lib, err, "lstm_fwd_train_gates")
    kernels.launch_counts["lstm_fwd_train_gates"] += 1
    return out, gates, c


Grads = Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]


def _planes_adjoint(res: torch.Tensor, g: torch.Tensor, w_hh: torch.Tensor,
                    reverse: bool) -> torch.Tensor:
    """dz (B, T, 4H) float32 of kernel 3's chain: from the planes ``res``,
    against the direction of time (dh = g + dh_carry; dc = dh E + dc_carry;
    dz = [dc A, dc B, dc C, dh G]; dc_carry = dc F; dh_carry =
    bf16(dz) . bf16(W_hh)^T)."""
    batch, steps, _ = res.shape
    hidden = w_hh.shape[0]
    whh_t = bf16_round(w_hh).t()
    dh_c = torch.zeros(batch, hidden, dtype=torch.float32, device=res.device)
    dc_c = torch.zeros_like(dh_c)
    dz = torch.empty(batch, steps, 4 * hidden, dtype=torch.float32, device=res.device)
    for t in (range(steps) if reverse else range(steps - 1, -1, -1)):
        a, b_, c, e, f, gg = res[:, t].split(hidden, dim=-1)
        dh = g[:, t] + dh_c
        dc = dh * e + dc_c
        dc_c = dc * f
        z = torch.cat([dc * a, dc * b_, dc * c, dh * gg], dim=-1)
        dz[:, t] = z
        dh_c = bf16_round(z) @ whh_t
    return dz


def _weight_products(dz: torch.Tensor, h: torch.Tensor, xs: Sequence[torch.Tensor],
                     w_ih: torch.Tensor, reverse: bool, masks=None, keep: float = 1.0,
                     dx_add: Optional[Sequence[torch.Tensor]] = None) -> Grads:
    """The products of the bf16 backward kernels from dz: dx_p =
    bf16(dz) . bf16(W_ih_p)^T, masked like the input, plus ``dx_add``;
    dW_ih_p = bf16(masked x_p)^T . bf16(dz); dW_hh = bf16(h_prev)^T .
    bf16(dz); db = the sum of the float32 dz."""
    masks = _mask_list(masks, len(xs))
    batch, steps, g4 = dz.shape
    hidden = g4 // 4
    dz16 = bf16_round(dz).reshape(batch * steps, g4)
    dw_hh = bf16_round(_shift(h, reverse)).reshape(-1, hidden).t() @ dz16
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
    return _weight_products(_planes_adjoint(res, g, w_hh, reverse), h, xs, w_ih, reverse,
                            masks, keep, dx_add)


def _check_seqs(xs, *seqs):
    batch, steps = xs[0].shape[:2]
    for name, t, width in seqs:
        if (t.dtype != torch.float32 or tuple(t.shape) != (batch, steps, width)
                or t.device != xs[0].device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 ({batch}, {steps}, {width})")


def _check_dx_add(dx_add, xs):
    if dx_add is None:
        return None
    dx_add = tuple(dx_add)
    if len(dx_add) != len(xs) or any(
            d.shape != x.shape or d.dtype != torch.float32 or not d.is_contiguous()
            or d.device != x.device for d, x in zip(dx_add, xs)):
        raise ValueError("dx_add must hold one contiguous float32 tensor per part")
    return dx_add


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
    _check_seqs(xs, ("res", res, 6 * hidden), ("h", h, hidden), ("g", g, hidden))
    dx_add = _check_dx_add(dx_add, xs)
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


def lstm_bwd_v2_plain(gates: torch.Tensor, c: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
                      xs: Parts, w_ih: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
                      masks: Masks = None, keep: float = 1.0,
                      dx_add: Optional[Sequence[torch.Tensor]] = None) -> Grads:
    """Plain twin of kernel 3b: the adjoint from the raw-gate residuals ->
    (dx parts, dW_ih, dW_hh, db).

    Against the direction of time, with tanh(c) recomputed and c_prev the
    cell state before the step: dh = g + dh_carry; do = dh tanh(c);
    dc = dh o (1 - tanh^2 c) + dc_carry; dz = [dc g i(1-i), dc c_prev
    f(1-f), dc i (1-g^2), do o(1-o)]; dc_carry = dc f; dh_carry =
    bf16(dz) . bf16(W_hh)^T. The products are :func:`lstm_bwd_plain`'s.
    """
    xs = as_parts(xs)
    batch, steps, g4 = gates.shape
    hidden = g4 // 4
    gi, gf, gg, go = gates.split(hidden, dim=-1)
    tc, c_prev = torch.tanh(c), _shift(c, reverse)
    whh_t = bf16_round(w_hh).t()
    dh_c = torch.zeros(batch, hidden, dtype=torch.float32, device=gates.device)
    dc_c = torch.zeros_like(dh_c)
    dz = torch.empty_like(gates)
    for t in (range(steps) if reverse else range(steps - 1, -1, -1)):
        i, f, gt, o, tct = gi[:, t], gf[:, t], gg[:, t], go[:, t], tc[:, t]
        dh = g[:, t] + dh_c
        d_o = dh * tct
        dc = dh * o * (1 - tct * tct) + dc_c
        dc_c = dc * f
        z = torch.cat([dc * gt * i * (1 - i), dc * c_prev[:, t] * f * (1 - f),
                       dc * i * (1 - gt * gt), d_o * o * (1 - o)], dim=-1)
        dz[:, t] = z
        dh_c = bf16_round(z) @ whh_t
    return _weight_products(dz, h, xs, w_ih, reverse, masks, keep, dx_add)


#: bytes of one bf16 dz chunk buffer of kernel 3b (two are live): small enough
#: that both stay in the H100's 50 MB L2
V2_CHUNK_BYTES = 16 << 20
#: rows a split-K slice of one chunk's weight-gradient product covers: a
#: chunk's sums are T/t_chunk times shorter than kernel 3's, so they are cut
#: finer to give each product enough CTAs (1024 at B=512, t_chunk 16)
V2_ROWS_PER_SPLIT = 512
_aux_streams = {}


def _aux_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The second stream kernel 3b runs its chunks' products on (one per
    device, made at first use)."""
    key = torch.cuda.current_device() if dev.index is None else dev.index
    if key not in _aux_streams:
        _aux_streams[key] = torch.cuda.Stream(device=dev)
    return _aux_streams[key]


def lstm_bwd_v2(gates: torch.Tensor, c: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
                xs: Parts, w_ih: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False,
                masks: Masks = None, keep: float = 1.0,
                dx_add: Optional[Sequence[torch.Tensor]] = None) -> Grads:
    """Kernel 3b: the two-pass backward of one layer-direction from its
    raw-gate forward (:func:`lstm_fwd_train_gates`): ``gates`` (B, T, 4H),
    ``c``, ``h`` and the upstream ``g`` (B, T, H), the same input parts and
    masks as the forward -> (dx parts, dW_ih (D, 4H), dW_hh (H, 4H), db
    (4H,)), float32.

    A chunk of the adjoint is as many steps as fit :data:`V2_CHUNK_BYTES` of
    bf16 dz (the last one may be shorter); the chunks' products run on a
    second stream beside the next chunk's chain.
    """
    xs = as_parts(xs)
    if _device_kind("lstm_bwd_v2", gates) == "cpu":
        return lstm_bwd_v2_plain(gates, c, h, g, xs, w_ih, w_hh, reverse, masks, keep,
                                 dx_add)
    _check_cuda_args(xs, w_ih, None, w_hh, masks)
    masks = _mask_list(masks, len(xs))
    batch, steps = xs[0].shape[:2]
    hidden = w_hh.shape[0]
    g4 = 4 * hidden
    _check_seqs(xs, ("gates", gates, g4), ("c", c, hidden), ("h", h, hidden),
                ("g", g, hidden))
    dx_add = _check_dx_add(dx_add, xs)
    t_chunk = max(1, min(steps, V2_CHUNK_BYTES // (batch * g4 * 2)))
    lib = kernels.load_library()
    dev = xs[0].device
    widths = [x.shape[-1] for x in xs]
    w_parts = torch.split(w_ih.to(torch.bfloat16).contiguous(), widths, dim=0)
    whh_t = w_hh.to(torch.bfloat16).t().contiguous()
    dxs = [torch.empty_like(x) for x in xs]
    dw_ih = torch.empty(sum(widths), g4, dtype=torch.float32, device=dev)
    dw_hh = torch.empty(hidden, g4, dtype=torch.float32, device=dev)
    db = torch.empty(g4, dtype=torch.float32, device=dev)
    carry = torch.zeros(2, batch, hidden, dtype=torch.float32, device=dev)
    db_part = torch.zeros(-(-batch // 8), g4, dtype=torch.float32, device=dev)
    dz16 = torch.empty(2, batch, t_chunk, g4, dtype=torch.bfloat16, device=dev)
    splits = kernels.gemm_splits(batch * t_chunk, V2_ROWS_PER_SPLIT)
    part = torch.empty(splits * max(widths + [hidden]) * g4, dtype=torch.float32, device=dev)
    two = len(xs) == 2
    err = lib.eegflow_lstm_bwd_v2(
        gates.data_ptr(), c.data_ptr(), h.data_ptr(), g.data_ptr(),
        xs[0].data_ptr(), _ptr(xs[1]) if two else None,
        _ptr(masks[0]), _ptr(masks[1]) if two else None,
        widths[0], widths[1] if two else 0, 1.0 / keep,
        w_parts[0].data_ptr(), w_parts[1].data_ptr() if two else None, whh_t.data_ptr(),
        _ptr(dx_add[0]) if dx_add else None, _ptr(dx_add[1]) if dx_add and two else None,
        dxs[0].data_ptr(), dxs[1].data_ptr() if two else None,
        dw_ih.data_ptr(), dw_hh.data_ptr(), db.data_ptr(), carry.data_ptr(),
        db_part.data_ptr(), dz16.data_ptr(), part.data_ptr(), splits, t_chunk,
        batch, steps, hidden, int(reverse), _stream(dev),
        _aux_stream(dev).cuda_stream)
    kernels.check(lib, err, "lstm_bwd_v2")
    kernels.launch_counts["lstm_bwd_v2"] += 1
    return tuple(dxs), dw_ih, dw_hh, db


DirGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _dx_from_x(dx: torch.Tensor, x: torch.Tensor, keep: float) -> torch.Tensor:
    """The reference's mask_from_x recovery: where(x == 0, 0, dx / keep),
    as a product with 1/keep."""
    return torch.where(x == 0, torch.zeros((), dtype=dx.dtype, device=dx.device),
                       dx * (1.0 / keep))


def lstm_bwd_dualdir_plain(res_f: torch.Tensor, h_f: torch.Tensor, g_f: torch.Tensor,
                           res_r: torch.Tensor, h_r: torch.Tensor, g_r: torch.Tensor,
                           xs: Parts, w_f: Sequence[torch.Tensor], w_r: Sequence[torch.Tensor],
                           keep: float = 1.0, mask_from_x: bool = False
                           ) -> Tuple[Tuple[torch.Tensor, ...], DirGrads, DirGrads]:
    """Plain twin of kernel 4: both directions' adjoints from their planes
    (kernel 3's chain, the forward direction against time, the reverse one
    with it) -> (dx parts, (dW_ih, dW_hh, db) forward, ... reverse).

    ``xs`` are the parts both directions read, as given: with
    ``mask_from_x`` they are already dropped, each direction's dx becomes
    where(x == 0, 0, dx / keep) and dW_ih contracts bf16(x) without masking
    again. dx is the forward direction's plus the reverse one's.
    """
    xs = as_parts(xs)
    out, dxs = [], None
    for res, h, g, (w_ih, w_hh), reverse in ((res_f, h_f, g_f, w_f, False),
                                             (res_r, h_r, g_r, w_r, True)):
        dx, dw_ih, dw_hh, db = _weight_products(_planes_adjoint(res, g, w_hh, reverse), h, xs,
                                                w_ih, reverse)
        if mask_from_x:
            dx = tuple(_dx_from_x(d, x, keep) for d, x in zip(dx, xs))
        dxs = dx if dxs is None else tuple(a + b for a, b in zip(dxs, dx))
        out.append((dw_ih, dw_hh, db))
    return dxs, out[0], out[1]


def lstm_bwd_dualdir(res_f: torch.Tensor, h_f: torch.Tensor, g_f: torch.Tensor,
                     res_r: torch.Tensor, h_r: torch.Tensor, g_r: torch.Tensor, xs: Parts,
                     w_f: Sequence[torch.Tensor], w_r: Sequence[torch.Tensor],
                     keep: float = 1.0, mask_from_x: bool = False
                     ) -> Tuple[Tuple[torch.Tensor, ...], DirGrads, DirGrads]:
    """Kernel 4: the backward of a bidirectional layer in one launch, from
    both directions' training-mode forwards without masks: per direction the
    planes ``res_*`` (B, T, 6H), ``h_*`` and the upstream ``g_*`` (B, T, H),
    and ``w_* = (w_ih, w_hh)``; the shared input parts ``xs`` -> (dx parts,
    summed over both directions, (dW_ih, dW_hh, db) forward, ... reverse),
    float32. ``mask_from_x``: the parts carry select dropout with ``keep``
    (see :func:`lstm_bwd_dualdir_plain`)."""
    xs = as_parts(xs)
    if _device_kind("lstm_bwd_dualdir", res_f) == "cpu":
        return lstm_bwd_dualdir_plain(res_f, h_f, g_f, res_r, h_r, g_r, xs, w_f, w_r, keep,
                                      mask_from_x)
    (w_ih_f, w_hh_f), (w_ih_r, w_hh_r) = w_f, w_r
    _check_cuda_args(xs, w_ih_f, None, w_hh_f)
    _check_cuda_args(xs, w_ih_r, None, w_hh_r)
    batch, steps = xs[0].shape[:2]
    hidden = w_hh_f.shape[0]
    g4 = 4 * hidden
    _check_seqs(xs, ("res_f", res_f, 6 * hidden), ("h_f", h_f, hidden), ("g_f", g_f, hidden),
                ("res_r", res_r, 6 * hidden), ("h_r", h_r, hidden), ("g_r", g_r, hidden))
    lib = kernels.load_library()
    dev = xs[0].device
    widths = [x.shape[-1] for x in xs]
    wp_f = torch.split(w_ih_f.to(torch.bfloat16).contiguous(), widths, dim=0)
    wp_r = torch.split(w_ih_r.to(torch.bfloat16).contiguous(), widths, dim=0)
    whh_t_f = w_hh_f.to(torch.bfloat16).t().contiguous()
    whh_t_r = w_hh_r.to(torch.bfloat16).t().contiguous()
    dxs = [torch.empty_like(x) for x in xs]
    grads = [(torch.empty(sum(widths), g4, dtype=torch.float32, device=dev),
              torch.empty(hidden, g4, dtype=torch.float32, device=dev),
              torch.empty(g4, dtype=torch.float32, device=dev)) for _ in range(2)]
    dz = torch.empty(2, batch, steps, g4, dtype=torch.float32, device=dev)
    splits = kernels.gemm_splits(batch * steps)
    part = torch.empty(splits * max(widths + [hidden]) * g4, dtype=torch.float32, device=dev)
    two = len(xs) == 2
    err = lib.eegflow_lstm_bwd_dualdir(
        res_f.data_ptr(), h_f.data_ptr(), g_f.data_ptr(),
        res_r.data_ptr(), h_r.data_ptr(), g_r.data_ptr(),
        xs[0].data_ptr(), _ptr(xs[1]) if two else None, widths[0], widths[1] if two else 0,
        int(mask_from_x), 1.0 / keep,
        wp_f[0].data_ptr(), wp_f[1].data_ptr() if two else None, whh_t_f.data_ptr(),
        wp_r[0].data_ptr(), wp_r[1].data_ptr() if two else None, whh_t_r.data_ptr(),
        dxs[0].data_ptr(), dxs[1].data_ptr() if two else None,
        *[t.data_ptr() for t in grads[0]], *[t.data_ptr() for t in grads[1]],
        dz[0].data_ptr(), dz[1].data_ptr(), part.data_ptr(), splits,
        batch, steps, hidden, _stream(dev))
    kernels.check(lib, err, "lstm_bwd_dualdir")
    kernels.launch_counts["lstm_bwd_dualdir"] += 1
    return tuple(dxs), grads[0], grads[1]


def select_dropout(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """The select dropout of the ``"dualdir"`` schedule, the reference's
    ``dropout_fwd_only`` (``eegflow/nn/lstm.py``): the value is
    ``x + (where(mask, x / keep, 0) - x)``, which is 0 exactly where
    ``mask`` drops; the backward is the identity, since the layer that
    reads the dropped copy recovers the mask from its zeros
    (``mask_from_x``). The division is a true one (by a tensor), as the
    reference's ``x / keep``."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dropped = torch.where(mask != 0, x / torch.full((), keep, dtype=x.dtype, device=x.device),
                          zero)
    return x + (dropped - x).detach()


#: the bf16 policy's backward schedules (:class:`BiLSTMLayer`)
LSTM_BWD_SCHEDULES = ("fused", "two_pass", "dualdir")


def check_lstm_bwd(lstm_bwd: str, bf16: bool = True, bidirectional: bool = True) -> None:
    """Raise ``ValueError`` unless the backward schedule ``lstm_bwd`` can run
    a layer of this precision policy and direction: any schedule but
    ``"fused"`` needs the bf16 policy, ``"dualdir"`` a bidirectional layer.
    There is no fallback: a schedule runs its kernels on every layer."""
    if lstm_bwd not in LSTM_BWD_SCHEDULES:
        raise ValueError(f"lstm_bwd must be one of {LSTM_BWD_SCHEDULES}, got {lstm_bwd!r}")
    if lstm_bwd != "fused" and not bf16:
        raise ValueError(f"lstm_bwd={lstm_bwd!r} needs the bf16 policy; float32 runs "
                         f"only 'fused'")
    if lstm_bwd == "dualdir" and not bidirectional:
        raise ValueError("lstm_bwd='dualdir' needs a bidirectional layer")


class BiLSTMLayer(torch.autograd.Function):
    """One LSTM layer over input parts, both directions under one Function.

    ``forward(kernel, keep, m0, m1, x0, x1, w_ih_f, w_hh_f, b_f, w_ih_b,
    w_hh_b, b_b, schedule) -> (h_f, h_b)`` (``x1``/``m1`` None for a one-part
    input; the ``_b`` weights None for a unidirectional layer, which returns
    ``(h_f,)``). The masks are shared by both directions. ``kernel`` picks the
    CUDA wrappers or their twins; ``schedule`` one of
    :data:`LSTM_BWD_SCHEDULES` (see the module docstring). Under ``"fused"``
    and ``"two_pass"`` the backward runs the forward direction's adjoint,
    then the reverse direction's with the first dx added in; under
    ``"dualdir"`` (no masks: the parts are already dropped, and ``keep < 1``
    means the mask is recovered from their zeros) one launch runs both.
    """

    @staticmethod
    def forward(ctx, kernel, keep, m0, m1, x0, x1, w_ih_f, w_hh_f, b_f,
                w_ih_b=None, w_hh_b=None, b_b=None, schedule="fused"):
        xs = (x0,) if x1 is None else (x0, x1)
        masks = None if m0 is None else ((m0,) if x1 is None else (m0, m1))
        dirs = [(w_ih_f, w_hh_f, b_f, False)]
        if w_ih_b is not None:
            dirs.append((w_ih_b, w_hh_b, b_b, True))
        outs, saved = [], []
        for w_ih, w_hh, b, reverse in dirs:
            if schedule == "two_pass":
                fwd = lstm_fwd_train_gates if kernel else lstm_fwd_train_gates_plain
                h, gates, c = fwd(xs, w_ih, b, w_hh, reverse, masks, keep)
                saved += [gates, c, h]
            else:
                fwd = lstm_fwd_train if kernel else lstm_fwd_train_plain
                h, res = fwd(xs, w_ih, b, w_hh, reverse, masks, keep)
                saved += [res, h]
            outs.append(h)
        ctx.kernel, ctx.keep, ctx.two, ctx.schedule = kernel, keep, x1 is not None, schedule
        ctx.bidirectional = w_ih_b is not None
        ctx.save_for_backward(x0, x1, m0, m1, w_ih_f, w_hh_f, w_ih_b, w_hh_b, *saved)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        x0, x1, m0, m1, w_ih_f, w_hh_f, w_ih_b, w_hh_b, *saved = ctx.saved_tensors
        xs = (x0, x1) if ctx.two else (x0,)
        masks = None if m0 is None else ((m0, m1) if ctx.two else (m0,))
        grads = [gr.contiguous() for gr in grads]
        dwih_b = dwhh_b = db_b = None
        if ctx.schedule == "dualdir":
            bwd = lstm_bwd_dualdir if ctx.kernel else lstm_bwd_dualdir_plain
            dxs, (dwih_f, dwhh_f, db_f), (dwih_b, dwhh_b, db_b) = bwd(
                saved[0], saved[1], grads[0], saved[2], saved[3], grads[1], xs,
                (w_ih_f, w_hh_f), (w_ih_b, w_hh_b), ctx.keep, ctx.keep < 1.0)
        else:
            if ctx.schedule == "two_pass":
                bwd = lstm_bwd_v2 if ctx.kernel else lstm_bwd_v2_plain
                per_dir = 3
            else:
                bwd = lstm_bwd if ctx.kernel else lstm_bwd_plain
                per_dir = 2
            dxs, dwih_f, dwhh_f, db_f = bwd(*saved[:per_dir], grads[0], xs, w_ih_f, w_hh_f,
                                            False, masks, ctx.keep)
            if ctx.bidirectional:
                dxs, dwih_b, dwhh_b, db_b = bwd(*saved[per_dir:], grads[1], xs, w_ih_b,
                                                w_hh_b, True, masks, ctx.keep, dxs)
        return (None, None, None, None, dxs[0], dxs[1] if ctx.two else None,
                dwih_f, dwhh_f, db_f, dwih_b, dwhh_b, db_b, None)


def bilstm_layer(layer: Mapping, xs: Parts, masks: Masks = None, keep: float = 1.0,
                 kernel: bool = False, bf16: bool = True, *,
                 lstm_bwd: str = "fused") -> Tuple[torch.Tensor, ...]:
    """One layer of the stack (``{"fwd": ..., "bwd": ...}`` params) over input
    parts, differentiable through :class:`BiLSTMLayer` (the bf16 policy) or
    :class:`BiLSTMLayerF32` (``bf16=False``) -> output parts.

    ``lstm_bwd`` picks the bf16 policy's backward schedule
    (:data:`LSTM_BWD_SCHEDULES`); the float32 policy has only ``"fused"``.
    Under ``"dualdir"`` the layer must be bidirectional and takes no masks:
    its parts come already dropped by :func:`select_dropout` with ``keep``.
    """
    pf, pb = layer["fwd"], (layer["bwd"] if "bwd" in layer else None)
    check_lstm_bwd(lstm_bwd, bf16, pb is not None)
    xs = as_parts(xs)
    ms = _mask_list(masks, len(xs))
    two = len(xs) == 2
    if lstm_bwd == "dualdir" and any(m is not None for m in ms):
        raise ValueError("lstm_bwd='dualdir' takes parts already dropped by "
                         "select_dropout, not masks")
    weights = [pf["w_ih"], pf["w_hh"], pf["b"]]
    if pb is not None:
        weights += [pb["w_ih"], pb["w_hh"], pb["b"]]
    if not bf16:
        return BiLSTMLayerF32.apply(kernel, float(keep), ms[0], ms[1] if two else None,
                                    xs[0], xs[1] if two else None, *weights)
    if pb is None:
        weights += [None, None, None]
    return BiLSTMLayer.apply(kernel, float(keep), ms[0], ms[1] if two else None,
                             xs[0], xs[1] if two else None, *weights, lstm_bwd)


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
