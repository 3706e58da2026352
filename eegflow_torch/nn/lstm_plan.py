"""Host side of the cluster LSTM kernels (kernel 2, ``csrc/lstm_fwd.cu``;
kernels 3, 3b and 4, ``csrc/lstm_bwd_chain.cuh``; kernels 1 and 5, the
float32 recurrence and its adjoint in ``csrc/lstm_rec.cu``): the launch plan
and the weight layouts the wrappers build.

A cluster of ``hc`` CTAs owns a tile of ``rows`` batch rows (16, 32 or 48:
one to three ``mma.sync`` m-tiles) and one direction. Each CTA owns ``units =
H / hc`` hidden units with 4U threads (the bf16 kernels: one warp per octet
of 8 units; kernel 1: four row groups of one thread per unit) and keeps its
slice of the recurrent weight in shared memory for the whole launch:

* ``"fwd"``: W_hh[:, the 4 gate columns of its units], H x 4U bf16;
* ``"bwd"``: W_hh^T[:, its units], 4H x U bf16;
* ``"rec"`` (float32, kernel 1): W_hh[:, the 4 gate columns of its units],
  H x 4U float32, aiming at 32 units a CTA (8 CTAs at H = 256);
* ``"rec_bwd"`` (float32, kernel 5): the same columns as ``"rec"``, held as
  4U rows of H (the depth of its product dz . W_hh^T is the CTA's 4U
  columns), on kernel 1's clusters.

Where the slice does not fit the 227 KB a block may hold (H = 512), its first
``k_res`` rows (of K = H forward, 4H backward) stay resident and the rest is
read from L2 every step. Beside the slice a CTA holds the state the cluster
exchanges each step: h (rows x H) forward, double-buffered, bf16 (``"fwd"``)
or float32 (``"rec"``); bf16 dz (rows x 4H) backward, in one buffer the
chain fills and reads between two barrier phases; kernel 5 its float32 dz
(rows x 4U) and one inbox of the cluster's partial dh (hc x rows x U),
filled and read between two barrier phases. The plan takes the number
of clusters the card can hold at once (``cudaOccupancyMaxActiveClusters``,
queried by the caller) and picks the rows per cluster: a whole slice resident
first, then the fewest waves, then the fewest rows. A CTA of more than 8
warps (over 64 units: H = 160 in the bf16 kernels, H = 416 in kernel 1;
over 32 in kernel 5) has 128 registers a thread or fewer and takes 16
rows. A cluster the card cannot hold raises.

The weights go to the kernels in **fragment order**: the B operand of one
``mma.sync.m16n8k16`` (16 k by 8 n, bf16) as the 32 lanes of a warp hold it,
lane = 4 n + k-pair (PTX ISA, "Matrix Fragments for mma.m16n8k16"). Forward,
the n of one warp's four n-tiles are the i, f, g, o columns of the same 8
units (the gate-interleaved order), so each thread's accumulators hold all
four gates of its (row, unit) pairs; one 16-byte load gives a lane two
gates' fragments. Backward, one 16-byte load gives a lane two k-tiles of its
octet's n-tile. Kernel 1 multiplies on CUDA cores and takes its float32
slice as (CTA, k, unit, gate), so one 16-byte load gives a thread the four
gates of its unit at one k (:func:`rec_slices`); kernel 5 takes its slice as
(CTA, unit, gate, k), so a warp's lanes read consecutive k
(:func:`rec_bwd_slices`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

#: shared memory a block may use on an H100 (227 KB)
SMEM_LIMIT = 232_448
#: the largest portable cluster
MAX_CLUSTER = 8
#: hidden units per CTA the plan aims at, per kind (4 CTAs at H = 256 for
#: the bf16 kernels, 8 for the float32 recurrence)
TARGET_UNITS = {"fwd": 64, "bwd": 64, "rec": 32, "rec_bwd": 32}
#: rows of one mma m-tile; a cluster takes one to three
ROW_TILE = 16
ROWS = (16, 32, 48)
#: the granularity of the resident rows of a slice (the product loops take
#: four 16-row k-tiles at a time)
K_STEP = 64
KINDS = ("fwd", "bwd", "rec", "rec_bwd")

#: (rows, hc, k_res, smem, threads) -> clusters the card holds at once
MaxClusters = Callable[[int, int, int, int, int], int]


def check_hidden(hidden: int) -> None:
    if hidden % 32 or not 32 <= hidden <= 512:
        raise ValueError(f"the lstm kernels need H % 32 == 0 and H <= 512, got {hidden}")


def check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def cluster_size(hidden: int, kind: str = "fwd") -> int:
    """CTAs per cluster: the largest divisor of the octet count H/8 that is
    at most ceil(H / target units) and at most 8 (bf16 kinds: 4 at H=256, 2
    at H=128, 1 at H=64; ``"rec"``: 8 at H=256, 4 at H=128, 4 of 104 units
    at H=416)."""
    check_hidden(hidden)
    check_kind(kind)
    octets = hidden // 8
    cap = min(MAX_CLUSTER, -(-hidden // TARGET_UNITS[kind]))
    return max(d for d in range(1, cap + 1) if octets % d == 0)


def cta_threads(kind: str, units: int) -> int:
    """Threads of a CTA: 4U (one warp per octet of units, or four row
    groups of one thread per unit), 8U for kernel 5 (``"rec_bwd"``: two
    halves that split its rows and its product)."""
    return 32 * (units // 8) * (2 if kind == "rec_bwd" else 1)


def k_total(kind: str, hidden: int) -> int:
    """Rows of a CTA's weight slice: the product's K (H forward, 4H backward,
    4U for kernel 5)."""
    if kind == "rec_bwd":
        return 4 * hidden // cluster_size(hidden, kind)
    return 4 * hidden if kind == "bwd" else hidden


def slice_row_bytes(kind: str, units: int, hidden: int = 0) -> int:
    """Bytes of one row of a CTA's slice: 4U bf16 (``"fwd"``), U bf16
    (``"bwd"``), 4U float32 (``"rec"``) or H float32 (``"rec_bwd"``, which
    needs ``hidden``)."""
    if kind == "rec_bwd":
        if hidden <= 0:
            raise ValueError("a rec_bwd slice row is H floats: pass hidden")
        return hidden * 4
    return {"fwd": 4 * units * 2, "bwd": units * 2, "rec": 4 * units * 4}[kind]


def smem_bytes(kind: str, hidden: int, units: int, rows: int, k_res: int) -> int:
    """Dynamic shared memory of a recurrent CTA: ``k_res`` resident rows of
    its slice and the state tiles the cluster exchanges: two of bf16 h
    (``"fwd"``) or one of bf16 dz (``"bwd"``), rows padded by 8 elements
    against bank conflicts, two of float32 h (``"rec"``), rows padded by
    4, or (``"rec_bwd"``) the float32 dz tile (rows x 4U) and the partial
    inbox (hc x rows x U). ``csrc/lstm_cluster.cuh`` computes the same."""
    check_kind(kind)
    if kind == "rec":
        state = 2 * rows * (hidden + 4) * 4
    elif kind == "rec_bwd":
        state = rows * (4 * units + hidden) * 4
    else:
        state = (2 if kind == "fwd" else 1) * rows * (k_total(kind, hidden) + 8) * 2
    return k_res * slice_row_bytes(kind, units, hidden) + state


def resident_rows(kind: str, hidden: int, units: int, rows: int) -> int:
    """The rows of the slice that fit beside the state buffers: all K of
    them, or else the most that are a multiple of 64."""
    per_row = slice_row_bytes(kind, units, hidden)
    fit = max(0, (SMEM_LIMIT - smem_bytes(kind, hidden, units, rows, 0)) // per_row)
    return k_total(kind, hidden) if fit >= k_total(kind, hidden) else fit // K_STEP * K_STEP


@dataclass(frozen=True)
class LstmPlan:
    kind: str
    batch: int
    hidden: int
    directions: int
    hc: int            # CTAs per cluster
    units: int         # hidden units per CTA
    rows: int          # batch rows per cluster
    k_res: int         # resident rows of the CTA's weight slice
    smem: int          # dynamic shared memory per CTA, bytes
    max_clusters: int  # clusters the card holds at once

    @property
    def threads(self) -> int:
        return cta_threads(self.kind, self.units)

    @property
    def tiles(self) -> int:
        """Row tiles (clusters) per direction."""
        return -(-self.batch // self.rows)

    @property
    def clusters(self) -> int:
        return self.tiles * self.directions

    @property
    def waves(self) -> int:
        return -(-self.clusters // self.max_clusters)

    @property
    def resident(self) -> bool:
        return self.k_res == k_total(self.kind, self.hidden)

    def rows_of(self, tile: int) -> range:
        """The batch rows row tile ``tile`` covers (rows past B are masked)."""
        return range(tile * self.rows, min(self.batch, (tile + 1) * self.rows))

    def describe(self) -> str:
        return (f"{self.kind} B={self.batch} H={self.hidden} dirs={self.directions}: "
                f"cluster {self.hc} x {self.threads} threads, {self.units} units/CTA, "
                f"{self.rows} rows/cluster, {self.clusters} clusters "
                f"(max active {self.max_clusters}, {self.waves} wave(s)), slice rows "
                f"resident {self.k_res}/{k_total(self.kind, self.hidden)}, "
                f"smem {self.smem} B")


def check_rows(rows) -> tuple:
    """``rows`` as a tuple of rows per cluster a plan may take: a non-empty
    subset of :data:`ROWS`."""
    rows = tuple(rows)
    if not rows or any(r not in ROWS for r in rows):
        raise ValueError(f"rows per cluster must be a non-empty subset of {ROWS}, got {rows}")
    return rows


def plan(kind: str, batch: int, hidden: int, max_clusters: MaxClusters,
         directions: int = 1, rows_allowed=ROWS) -> LstmPlan:
    """The launch plan of a recurrent kernel (see the module docstring),
    taking one of ``rows_allowed`` rows per cluster."""
    check_kind(kind)
    if batch <= 0 or directions not in (1, 2):
        raise ValueError(f"batch must be positive and directions 1 or 2, got {batch}, "
                         f"{directions}")
    hc = cluster_size(hidden, kind)
    units = hidden // hc
    cands = []
    for rows in check_rows(rows_allowed):
        k_res = resident_rows(kind, hidden, units, rows)
        smem = smem_bytes(kind, hidden, units, rows, k_res)
        threads = cta_threads(kind, units)
        if smem > SMEM_LIMIT or (threads > 256 and rows > ROW_TILE):
            continue
        n = int(max_clusters(rows, hc, k_res, smem, threads))
        if n > 0:
            cands.append(LstmPlan(kind, batch, hidden, directions, hc, units, rows, k_res,
                                  smem, n))
    if not cands:
        raise RuntimeError(f"no cluster of {hc} CTAs for the {kind} kernel at H={hidden} "
                           f"fits on this card")
    return min(cands, key=lambda p: (not p.resident, p.waves, p.rows))


# ---------------------------------------------------------------------------
# Weight layouts
# ---------------------------------------------------------------------------


def gate_interleave(hidden: int) -> torch.Tensor:
    """The gate-interleaved column order of W_hh (H, 4H): octet by octet, the
    i, f, g, o columns of its 8 units. ``w[:, gate_interleave(H)]``."""
    check_hidden(hidden)
    o, gate, j = torch.meshgrid(torch.arange(hidden // 8), torch.arange(4), torch.arange(8),
                                indexing="ij")
    return (gate * hidden + o * 8 + j).reshape(-1)


def fwd_fragments(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh (H, 4H) -> bf16 (H/8, H/16, 2, 32, 2, 2, 2) in the forward
    kernel's fragment order: [octet][k-tile][gate pair][lane (unit, k-pair)]
    [gate of the pair][k half][k of the pair]."""
    hidden = w_hh.shape[0]
    check_hidden(hidden)
    kt, no = hidden // 16, hidden // 8
    w = w_hh.to(torch.bfloat16).reshape(kt, 2, 4, 2, 2, 2, no, 8)
    return w.permute(6, 0, 4, 7, 2, 5, 1, 3).contiguous().reshape(no, kt, 2, 32, 2, 2, 2)


def fwd_unfragment(frag: torch.Tensor, hidden: int) -> torch.Tensor:
    """The inverse of :func:`fwd_fragments`: -> W_hh (H, 4H) bf16."""
    w = frag.reshape(hidden // 8, hidden // 16, 2, 8, 4, 2, 2, 2)
    return w.permute(1, 6, 4, 7, 2, 5, 0, 3).reshape(hidden, 4 * hidden)


def bwd_fragments(w_hh: torch.Tensor) -> torch.Tensor:
    """W_hh (H, 4H) -> bf16 (H/8, H/8, 32, 2, 2, 2) holding W_hh^T (4H, H) in
    the backward chain's fragment order: [octet][k-tile pair][lane (unit,
    k-pair)][k-tile of the pair][k half][k of the pair]."""
    hidden = w_hh.shape[0]
    check_hidden(hidden)
    no = hidden // 8
    w = w_hh.to(torch.bfloat16).reshape(no, 8, no, 2, 2, 4, 2)
    return w.permute(0, 2, 1, 5, 3, 4, 6).contiguous().reshape(no, no, 32, 2, 2, 2)


def bwd_unfragment(frag: torch.Tensor, hidden: int) -> torch.Tensor:
    """The inverse of :func:`bwd_fragments`: -> W_hh (H, 4H) bf16."""
    w = frag.reshape(hidden // 8, hidden // 8, 8, 4, 2, 2, 2)
    return w.permute(0, 2, 1, 4, 5, 3, 6).reshape(hidden, 4 * hidden)


def rec_slices(w_hh: torch.Tensor, hc: int) -> torch.Tensor:
    """W_hh (H, 4H) -> float32 (hc, H, U, 4) for kernel 1: CTA c's slice,
    [k][unit][gate] = W_hh[k, gate H + c U + unit] (U = H / hc)."""
    hidden = w_hh.shape[0]
    check_hidden(hidden)
    if hidden % (8 * hc):
        raise ValueError(f"{hc} CTAs do not split H={hidden} into octets")
    w = w_hh.to(torch.float32).reshape(hidden, 4, hc, hidden // hc)
    return w.permute(2, 0, 3, 1).contiguous()


def rec_unslice(slices: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`rec_slices`: -> W_hh (H, 4H) float32."""
    hc, hidden, units, _ = slices.shape
    return slices.permute(1, 3, 0, 2).reshape(hidden, 4 * hidden)


def rec_bwd_slices(w_hh: torch.Tensor, hc: int) -> torch.Tensor:
    """W_hh (H, 4H) -> float32 (hc, U, 4, H) for kernel 5: CTA c's slice,
    [unit][gate][k] = W_hh[k, gate H + c U + unit] (U = H / hc), k
    contiguous; its rows (unit, gate) are the depth of the CTA's product
    dz . W_hh^T."""
    hidden = w_hh.shape[0]
    check_hidden(hidden)
    if hidden % (8 * hc):
        raise ValueError(f"{hc} CTAs do not split H={hidden} into octets")
    w = w_hh.to(torch.float32).reshape(hidden, 4, hc, hidden // hc)
    return w.permute(2, 3, 1, 0).contiguous()


def rec_bwd_unslice(slices: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`rec_bwd_slices`: -> W_hh (H, 4H) float32."""
    hc, units, _, hidden = slices.shape
    return slices.permute(3, 2, 0, 1).reshape(hidden, 4 * hidden)
