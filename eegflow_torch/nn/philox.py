"""The in-kernel dropout masks of the bf16 LSTM kernels: Philox4x32-10 keyed
by element, the kernel that draws its packed keep bits, and their plain
PyTorch twins.

The reference draws the masks of its in-kernel dropout (``EEGFLOW_KERNEL_DROPOUT``,
mode 1 of ``EEGFLOW_FWD_DROPW``, the input block's ``out_seed``) from the TPU's
hardware bits inside its kernels (``eegflow.nn.pallas_lstm._prng_block_masks``),
a stream no other device reproduces. The port draws them from the counter-based
generator of Salmon et al., "Parallel Random Numbers: As Easy as 1, 2, 3"
(SC'11, Random123), the one curand and PyTorch's CUDA generator use
(``csrc/philox.cuh``). A mask bit is a function of a 64-bit key and the
element's position. No uint8 mask exists in device memory: each layer draws
its input parts' bits into a transient packed plane, 1 bit an element (1/32
of the part's float32 bytes), once at the top of its forward and once at
the top of its backward (:func:`draw_keep_bits`, ``csrc/philox_bits.cu``),
and kernels 2, 3 and 3b of both directions read it.

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
* **Plane**: bit i mod 8 of byte i / 8 holds element i of the part (its
  rank's rows), in ceil(n / 32) 32-bit words; bits past the part are 0.

:func:`philox_keep_mask` is the twin of the bits: plain integer arithmetic
in int64 (the 32 x 32-bit products split into 16-bit halves) that gives the
kernels' bits on either device, and :func:`philox_keep_bits` packs them into
the draw kernel's plane. The LSTM kernels' twins expand a
:class:`PhiloxSource` (or the source of a :class:`PhiloxBits`) with it and
then run their uint8-mask path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from eegflow_torch import kernels

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


def philox_keep_bits(key: torch.Tensor, stream: int, shape: Sequence[int], keep: float,
                     row_offset: int = 0) -> torch.Tensor:
    """Plain twin of the draw kernel: the keep bits of
    :func:`philox_keep_mask` packed into its plane (module docstring), a
    uint8 tensor of 4 ceil(n / 32) bytes on the key's device."""
    flat = philox_keep_mask(key, stream, shape, keep, row_offset).reshape(-1)
    n = flat.numel()
    padded = torch.zeros(32 * -(-n // 32), dtype=torch.uint8, device=key.device)
    padded[:n] = flat
    weights = torch.tensor([1 << e for e in range(8)], dtype=torch.uint8, device=key.device)
    return (padded.reshape(-1, 8) * weights).sum(dim=1, dtype=torch.uint8)


def unpack_keep_bits(bits: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """A plane's keep bits as the bool mask (True = kept) of a ``shape``
    part."""
    unpacked = (bits[:, None].to(torch.int32) >> torch.arange(8, device=bits.device)) & 1
    return unpacked.reshape(-1)[:math.prod(shape)].bool().reshape(tuple(shape))


@dataclass(frozen=True)
class PhiloxBits:
    """A :class:`PhiloxSource`'s bits for the input parts of one layer and
    pass at ``keep``: one packed plane per part (uint8, on the parts'
    device), drawn by :func:`draw_keep_bits`."""

    source: PhiloxSource
    keep: float
    planes: Tuple[torch.Tensor, ...]


def draw_keep_bits(source: PhiloxSource, xs: Sequence[torch.Tensor], keep: float) -> PhiloxBits:
    """The keep-bit planes of ``source`` for the parts ``xs`` at ``keep``:
    on CUDA parts one launch of ``csrc/philox_bits.cu`` for all of them,
    counted as ``philox_keep_bits``; on CPU parts its twin
    (:func:`philox_keep_bits`)."""
    if len(source.streams) != len(xs) or len(xs) not in (1, 2):
        raise ValueError(f"{len(source.streams)} Philox streams for {len(xs)} input parts "
                         f"(one or two)")
    key = source.key
    if xs[0].device.type == "cpu":
        return PhiloxBits(source, keep, tuple(
            philox_keep_bits(key, s, x.shape, keep, source.row_offset)
            for s, x in zip(source.streams, xs)))
    if xs[0].device.type != "cuda":
        raise ValueError(f"draw_keep_bits: unsupported device {xs[0].device}")
    if (key.dtype != torch.int32 or tuple(key.shape) != (2,) or key.device != xs[0].device
            or not key.is_contiguous()):
        raise ValueError("a Philox key must be a contiguous (2,) int32 tensor on the parts' "
                         "device")
    if source.row_offset < 0 or any(not 0 <= s < 2 ** 31 for s in source.streams):
        raise ValueError(f"a Philox source needs streams in [0, 2^31) and a row offset >= 0, "
                         f"got {source.streams}, {source.row_offset}")
    lib = kernels.load_library()
    counts = [x.numel() for x in xs]
    offs = [source.row_offset * x.shape[1] * x.shape[2] for x in xs]
    planes = tuple(torch.empty(4 * -(-n // 32), dtype=torch.uint8, device=xs[0].device)
                   for n in counts)
    two = len(xs) == 2
    err = lib.eegflow_philox_keep_bits(
        key.data_ptr(), source.streams[0], source.streams[1] if two else 0, offs[0],
        offs[1] if two else 0, counts[0], counts[1] if two else 0, keep_threshold(keep),
        planes[0].data_ptr(), planes[1].data_ptr() if two else None,
        kernels.stream(xs[0].device))
    kernels.check(lib, err, "philox_keep_bits")
    kernels.launch_counts["philox_keep_bits"] += 1
    return PhiloxBits(source, keep, planes)
