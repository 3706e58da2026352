"""The precision of 3xTF32, the products of the float32 pool head (kernels
7 and 8, ``eegflow_torch/csrc/mma_gemm.cuh`` ``tile_mma_tf32x3`` and
``tf32x3_gemm_split_k``) and of the float32 input-block backward (kernel 10's
dx and dW, ``csrc/input_block.cu``), emulated in plain PyTorch on the CPU: each float32
operand split into hi = tf32(a) and lo = tf32(a - hi) (``cvt.rna``: round
to nearest, ties away from zero, to 10 mantissa bits), a . b as
lo_a hi_b + hi_a lo_b + hi_a hi_b with float32 sums. At the pool head's
widths (D = 512, K = 256) the three products agree with float64 and with
the plain twin's float32 product to 1e-6 of the largest entry, where one
TF32 product misses by more than 1e-5; so do kernel 10's dx = dz . W^T (a
sum over H = 256) and dW = x^T . dz (over the rows) at C = 61, and kernel
7's scores s = tanh(y . W1 + b1) . w2. Inputs are made with numpy from a
seed."""

import numpy as np
import pytest
import torch

D, K, ROWS = 512, 256, 2048
# relative to the largest entry of the product: each 3xTF32 product is good
# to about 2^-21 relative (the dropped lo . lo and lo's own rounding), summed
# over D or K or the rows in float32
REL_TOL = 1e-6


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32``: the low 13 mantissa
    bits rounded off to nearest, ties away from zero (on the magnitude)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (mag | sign).view(torch.float32)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32 with float32 sums (the products of two TF32 values are
    exact in float32)."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.float64), want.to(torch.float64)
    return ((got - want).abs().max() / want.abs().max()).item()


def test_tf32_rounding_is_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -20, 1 + ulp / 4, -(1 + ulp / 2),
                      1 + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32_rna(x), want)
    # hi + lo carries a float32 to about 2^-22 of itself
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tf32_rna(v)
    assert ((v - hi - tf32_rna(v - hi)).abs() <= v.abs() * 2.0 ** -21).all()


def _operands(seed):
    """The pool head's operands at full width: y (LayerNorm output), W1 as
    dense_init draws it, u = ds (1 - proj^2) w2 at its scale."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((ROWS, D)) * (1 + 0.1 * rng.standard_normal(D))
         + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bound = 1 / np.sqrt(D)
    w1 = rng.uniform(-bound, bound, (D, K)).astype(np.float32)
    u = (1e-3 * rng.standard_normal((ROWS, K))).astype(np.float32)
    return torch.from_numpy(y), torch.from_numpy(w1), torch.from_numpy(u)


@pytest.mark.parametrize("product", ["proj", "dy", "dW1"])
def test_tf32x3_holds_float32_precision_at_the_pool_heads_widths(product):
    """proj = y . W1 (a sum over D = 512), dy's u . W1^T (over K = 256) and
    dW1 = y^T . u (over the rows)."""
    y, w1, u = _operands({"proj": 1, "dy": 2, "dW1": 3}[product])
    a, b = {"proj": (y, w1), "dy": (u, w1.t()), "dW1": (y.t(), u)}[product]
    got = matmul_tf32x3(a, b)
    want64 = a.to(torch.float64) @ b.to(torch.float64)
    assert _rel(got, want64) <= REL_TOL
    # the plain twin's float32 product (pool_head_bwd_plain multiplies in
    # float32)
    assert _rel(got, a @ b) <= REL_TOL
    # one TF32 product is a different function
    assert _rel(tf32_rna(a) @ tf32_rna(b), want64) > 10 * REL_TOL


C_IN, H_IN = 61, 256


def _input_operands(seed):
    """The input block's backward operands at full width: x windows N(0, 1),
    W as dense_init draws it (61 -> 256), dz at the scale rsig dxhat takes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, C_IN)).astype(np.float32)
    bound = 1 / np.sqrt(C_IN)
    w = rng.uniform(-bound, bound, (C_IN, H_IN)).astype(np.float32)
    dz = (0.3 * rng.standard_normal((ROWS, H_IN))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dz)


@pytest.mark.parametrize("product", ["dx", "dW"])
def test_tf32x3_holds_float32_precision_at_the_input_blocks_widths(product):
    """Kernel 10's float32 products: dx = dz . W^T (a sum over H = 256) and
    dW = x^T . dz (a sum over the rows), at C = 61."""
    x, w, dz = _input_operands({"dx": 4, "dW": 5}[product])
    a, b = {"dx": (dz, w.t()), "dW": (x.t(), dz)}[product]
    got = matmul_tf32x3(a, b)
    want64 = a.to(torch.float64) @ b.to(torch.float64)
    assert _rel(got, want64) <= REL_TOL
    # the plain twin's float32 product (input_block_bwd_plain)
    assert _rel(got, a @ b) <= REL_TOL
    assert _rel(tf32_rna(a) @ tf32_rna(b), want64) > 10 * REL_TOL


def test_tf32x3_scores_hold_float32_precision_at_the_pool_heads_widths():
    """Kernel 7's float32 scores s = tanh(y . W1 + b1) . w2 at D = 512, K =
    256, from the 3xTF32 projection, against float64 and against the twin's
    float32 product; one TF32 product moves them by more than 10x as much."""
    y, w1, _ = _operands(6)
    rng = np.random.default_rng(7)
    b1 = torch.from_numpy((0.1 * rng.standard_normal(K)).astype(np.float32))
    w2 = torch.from_numpy((0.1 * rng.standard_normal(K)).astype(np.float32))

    def scores(proj):
        return (torch.tanh(proj.to(torch.float64) + b1.to(torch.float64))
                * w2.to(torch.float64)).sum(-1)

    want64 = scores(y.to(torch.float64) @ w1.to(torch.float64))
    got = scores(matmul_tf32x3(y, w1))
    assert _rel(got, want64) <= REL_TOL
    assert _rel(got, scores(y @ w1)) <= REL_TOL
    assert _rel(scores(tf32_rna(y) @ tf32_rna(w1)), want64) > 10 * REL_TOL
