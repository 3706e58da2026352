"""The in-kernel dropout masks of the bf16 LSTM kernels: Philox4x32-10 keyed
by element, and its plain PyTorch twin.

The reference draws the masks of its in-kernel dropout (``EEGFLOW_KERNEL_DROPOUT``,
mode 1 of ``EEGFLOW_FWD_DROPW``, the input block's ``out_seed``) from the TPU's
hardware bits inside its kernels (``eegflow.nn.pallas_lstm._prng_block_masks``),
a stream no other device reproduces. The port draws them from the counter-based
generator of Salmon et al., "Parallel Random Numbers: As Easy as 1, 2, 3"
(SC'11, Random123), the one curand and PyTorch's CUDA generator use, inside
kernels 2, 3 and 3b (``csrc/philox.cuh``). No mask tensor exists in device
memory: a mask bit is a function of a 64-bit key and the element's position.

* **Key**: a pair of 32-bit words (k0, k1), a (2,) int32 tensor on the
  device, drawn each step from the trainer's mask generator.
* **Counter**: element i of a part's (B_global, T, D) tensor, i = ((b_global T
  + t) D + j), reads word i & 3 of the block at counter (q mod 2^32, q >> 32,
  stream, 0), q = i >> 2. ``b_global`` is the row's place in the whole batch:
  a mesh rank's rows start at its ``row_offset``, so two ranks draw the one
  process's masks.
* **Streams**: 0 is the stack's input (rate d/2); 1 + 2 l + p is part p (0
  forward, 1 reverse) of layer l's output (rate d).
* **Keep**: word < min(floor(keep 2^32), 2^32 - 1), the reference's
  ``_keep_threshold``; kept values are scaled by exactly 1/keep.

:func:`philox_keep_mask` is the twin: plain integer arithmetic in int64 (the
32 x 32-bit products split into 16-bit halves) that gives the kernels' bits on
either device. The kernels' twins expand a :class:`PhiloxSource` with it and
then run their uint8-mask path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

#: Philox4x32's round multipliers and Weyl key increments (Random123)
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
_MASK32 = 0xFFFFFFFF


def keep_threshold(keep: float) -> int:
    """The largest 32-bit word that drops an element, plus one: a word below
    it keeps (the reference's ``_keep_threshold``)."""
    if not 0.0 < keep <= 1.0:
        raise ValueError(f"keep must be in (0, 1], got {keep}")
    return min(int(keep * 2.0 ** 32), 2 ** 32 - 1)


def _mulhilo(m: int, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the constant ``m`` times ``a`` (int64
    tensors of 32-bit values): ``m`` split into 16-bit halves, so no product
    leaves int64."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(counter: Sequence[torch.Tensor], key: Sequence) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the four counter words (int64 tensors of 32-bit
    values, broadcast together) under the key words (ints or int64 tensors)
    -> its four output words, int64 tensors of 32-bit values."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def key_words(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (2,) int32 key as two int64 0-d tensors of its 32-bit words, on
    its device (no host sync)."""
    if key.shape != (2,) or key.dtype != torch.int32:
        raise ValueError(f"a Philox key is a (2,) int32 tensor, got {tuple(key.shape)} "
                         f"{key.dtype}")
    words = key.to(torch.int64) & _MASK32
    return words[0], words[1]


def philox_keep_mask(key: torch.Tensor, stream: int, shape: Sequence[int], keep: float,
                     row_offset: int = 0) -> torch.Tensor:
    """The keep-mask (bool, True = kept) of stream ``stream`` over a
    ``shape`` = (B, T, D) part whose first row is row ``row_offset`` of the
    whole batch, as kernels 2, 3 and 3b draw it (module docstring), on the
    key's device."""
    batch, steps, width = shape
    first = row_offset * steps * width
    n = batch * steps * width
    q0, q1 = first >> 2, (first + n - 1) >> 2
    q = torch.arange(q0, q1 + 1, dtype=torch.int64, device=key.device)
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    words = philox4x32((q & _MASK32, q >> 32, zero + stream, zero), key_words(key))
    flat = torch.stack(words, dim=-1).reshape(-1)[first - 4 * q0: first - 4 * q0 + n]
    return (flat < keep_threshold(keep)).reshape(batch, steps, width)


@dataclass(frozen=True)
class PhiloxSource:
    """The in-kernel dropout masks of a layer's input parts: the step's
    ``key`` ((2,) int32 on the parts' device), one stream per part, and the
    global row of the parts' first row (a mesh rank's offset)."""

    key: torch.Tensor
    streams: Tuple[int, ...]
    row_offset: int = 0

    def masks(self, xs: Sequence[torch.Tensor], keep: float) -> Tuple[torch.Tensor, ...]:
        """The uint8 keep-masks the kernels draw for the parts ``xs``."""
        if len(self.streams) != len(xs):
            raise ValueError(f"{len(self.streams)} Philox streams for {len(xs)} input parts")
        return tuple(philox_keep_mask(self.key, s, x.shape, keep, self.row_offset)
                     .to(torch.uint8) for s, x in zip(self.streams, xs))
