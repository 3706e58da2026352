"""The port's fused input block (kernels 9 and 10) against
``eegflow.nn.pallas_input.input_block_fused`` with its Pallas kernels in
interpret mode: the forward twin, the backward twin on the same upstream
gradient, and the ``InputBlock`` autograd Function against ``jax.vjp``, in
the float32 and the bf16 mode, on an odd batch. Inputs are made with numpy
from a seed; tiny shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from eegflow.nn.pallas_input import input_block_fused as jax_input_block
from eegflow_torch.nn.cuda_input import (BWD_CTAS, BWD_MAX_CHANNELS, BWD_MAX_HIDDEN,
                                         BWD_TILE_ROWS, BWD_WIDE_CLUSTER, FWD_CTAS, bwd_plan,
                                         fwd_plan, input_block, input_block_bwd,
                                         input_block_bwd_plain, input_block_fused,
                                         input_block_fused_plain)

# forward: the same (bf16-rounded) operands and LayerNorm formula; float32
# sums in another order, and the kernel's A&S erf (|err| <= 1.5e-7) against
# torch.erf in the twin
FWD_TOL = 2e-6
# backward, relative to each gradient's largest entry: the same, through the
# LayerNorm backward's cancellations and the sums over B*T rows
BWD_REL_TOL = 1e-4
BATCH, STEPS, CHANNELS, HIDDEN = 3, 8, 61, 32


def _case(seed):
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(CHANNELS)
    proj = {"w": rng.uniform(-bound, bound, (CHANNELS, HIDDEN)).astype(np.float32),
            "b": rng.uniform(-bound, bound, HIDDEN).astype(np.float32)}
    norm = {"scale": (1 + 0.1 * rng.standard_normal(HIDDEN)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)}
    x = rng.standard_normal((BATCH, STEPS, CHANNELS)).astype(np.float32)
    dy = rng.standard_normal((BATCH, STEPS, HIDDEN)).astype(np.float32)
    return proj, norm, x, dy


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree, grad=False):
    return {k: torch.from_numpy(v).requires_grad_(grad) for k, v in tree.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_vjp(proj, norm, x, dy, bf16):
    y, vjp = jax.vjp(lambda p, n, x_: jax_input_block(p, n, x_, bf16=bf16),
                     _j(proj), _j(norm), jnp.asarray(x))
    dp, dn, dx = vjp(jnp.asarray(dy))
    return np.asarray(y), (dx, dp["w"], dp["b"], dn["scale"], dn["bias"])


@pytest.mark.parametrize("bf16", [False, True])
def test_forward_twin_matches_pallas(bf16):
    proj, norm, x, _ = _case(1)
    want = np.asarray(jax_input_block(_j(proj), _j(norm), jnp.asarray(x), bf16=bf16))
    got = input_block_fused_plain(_t(proj), _t(norm), torch.from_numpy(x), bf16)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)
    # on CPU tensors the wrapper runs the twin
    assert torch.equal(input_block_fused(_t(proj), _t(norm), torch.from_numpy(x), bf16), got)


@pytest.mark.parametrize("bf16", [False, True])
def test_backward_twin_matches_pallas_vjp(bf16):
    proj, norm, x, dy = _case(2)
    _, want = _jax_vjp(proj, norm, x, dy, bf16)
    got = input_block_bwd_plain(_t(proj), _t(norm), torch.from_numpy(x), torch.from_numpy(dy),
                                bf16)
    for name, a, b in zip(("dx", "dW", "db", "dgamma", "dbeta"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) < BWD_REL_TOL, name
    wrapped = input_block_bwd(_t(proj), _t(norm), torch.from_numpy(x), torch.from_numpy(dy),
                              bf16)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


@pytest.mark.parametrize("bf16", [False, True])
def test_function_matches_jax_vjp(bf16):
    """Through autograd: the forward and all five gradients."""
    proj, norm, x, dy = _case(3)
    want_y, want = _jax_vjp(proj, norm, x, dy, bf16)
    tp, tn = _t(proj, True), _t(norm, True)
    tx = torch.from_numpy(x).requires_grad_()
    y = input_block(tp, tn, tx, bf16)
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=FWD_TOL, rtol=0)
    y.backward(torch.from_numpy(dy))
    got = (tx.grad, tp["w"].grad, tp["b"].grad, tn["scale"].grad, tn["bias"].grad)
    for name, a, b in zip(("dx", "dW", "db", "dgamma", "dbeta"), got, want):
        assert _rel(a.numpy(), b) < BWD_REL_TOL, name
    # without gradients the block runs the forward alone, to the same values
    with torch.no_grad():
        assert torch.equal(input_block(tp, tn, tx, bf16), y.detach())


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("rows", [1, 63, 64, 185, 8448, 8449, 131072])
def test_bwd_plan_owns_every_row_tile_once_and_sizes_the_scratch(rows, bf16):
    """Kernel 10's launch plan, from which the wrapper allocates: the CTAs'
    tiles (tile i of CTA c: i = c, c + ctas, ..) cover every row exactly once
    and every CTA owns at least one, also where the rows span more tiles than
    the persistent grid holds (8449 rows); 64-row tiles under bf16, 32-row
    tiles in float32 at the classifier's H = 256, one CTA a tile in both
    modes; the scratch holds one partial row [dW, db, dgamma, dbeta] a CTA in
    both modes, and nothing of size B*T x H."""
    channels, hidden = 61, 256
    plan = bwd_plan(rows, channels, hidden, bf16)
    owned = np.zeros(rows, np.int64)
    for cta in range(plan.ctas):
        tiles = plan.tiles_of(cta, rows)
        assert tiles
        for row0, n in tiles:
            assert row0 % plan.tile_rows == 0 and 0 < n <= plan.tile_rows
            owned[row0:row0 + n] += 1
    assert (owned == 1).all()
    assert plan._fields == ("ctas", "cluster", "tile_rows", "part")
    assert plan.cluster == 1 and plan.clusters == plan.ctas
    assert plan.tile_rows == (BWD_TILE_ROWS if bf16 else 32)
    assert plan.ctas == min(BWD_CTAS, -(-rows // plan.tile_rows))
    assert plan.part == plan.ctas * (channels * hidden + 3 * hidden)


@pytest.mark.parametrize("channels,hidden", [(65, 48), (61, 544), (130, 1024), (61, 0)])
def test_bwd_plan_rejects_widths_off_the_bf16_tiles(channels, hidden):
    """Both modes take any C and H % 32 == 0, 0 < H <= 512 (kernel 9's
    widths), and raise for any other H."""
    with pytest.raises(ValueError, match="input_block_bwd under bf16 needs H % 32 == 0 and "
                                         "H <= 512"):
        bwd_plan(185, channels, hidden, True)
    with pytest.raises(ValueError, match="input_block_bwd in float32 needs H % 32 == 0"):
        bwd_plan(185, channels, hidden, False)


@pytest.mark.parametrize("channels,hidden", [(65, 256), (61, 288), (61, 512), (130, 512),
                                             (130, 288), (7, 512), (64, 256), (130, 32)])
@pytest.mark.parametrize("rows", [185, 8449, 131072])
def test_bwd_plan_bf16_takes_kernel_9s_widths_on_their_tiles(rows, channels, hidden):
    """The bf16 mode's wide class: beyond C = 64 or H = 256 (the widths one
    CTA's 64-row tile takes) it runs clusters of two CTAs a 64-row tile, at
    most BWD_CTAS / 2 of them, each row tile owned once by a cluster that
    owns at least one, one partial row a cluster; C <= 64 and H <= 256 keep
    one CTA a tile."""
    plan = bwd_plan(rows, channels, hidden, True)
    narrow = channels <= BWD_MAX_CHANNELS and hidden <= BWD_MAX_HIDDEN
    assert plan.tile_rows == BWD_TILE_ROWS
    assert plan.cluster == (1 if narrow else BWD_WIDE_CLUSTER)
    assert plan.clusters == min(BWD_CTAS // plan.cluster, -(-rows // plan.tile_rows))
    assert plan.ctas == plan.clusters * plan.cluster <= BWD_CTAS
    assert plan.part == plan.clusters * (channels + 3) * hidden
    owned = np.zeros(rows, np.int64)
    for cta in range(0, plan.ctas, plan.cluster):
        tiles = plan.tiles_of(cta, rows)
        assert tiles
        for row0, n in tiles:
            assert row0 % plan.tile_rows == 0 and 0 < n <= plan.tile_rows
            owned[row0:row0 + n] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("channels,hidden", [(61, 512), (61, 288), (130, 288), (65, 256),
                                             (7, 512), (130, 32)])
@pytest.mark.parametrize("rows", [1, 64, 65, 185, 4223, 8449, 131072])
def test_bwd_plan_wide_cluster_splits_the_tiles_and_the_units(rows, channels, hidden):
    """The wide class's cluster plan: every row tile is owned once by one
    cluster (66 tiles at 4223 rows, one a cluster; 133 at 8449 rows, odd
    against the 66 clusters, the first taking three), both CTAs of a
    cluster walk the same tiles, and their column halves cover H exactly, in
    rank order, each a whole number of 16-column z pairs (144 columns at
    H = 288); the widths off the kernel still raise."""
    plan = bwd_plan(rows, channels, hidden, True)
    assert plan.cluster == BWD_WIDE_CLUSTER == 2 and plan.ctas % 2 == 0
    owner = np.full(-(-rows // plan.tile_rows), -1, np.int64)
    for cta in range(plan.ctas):
        tiles = plan.tiles_of(cta, rows)
        assert tiles == plan.tiles_of(cta - cta % 2, rows)  # the cluster's
        for row0, _ in tiles:
            k = row0 // plan.tile_rows
            assert owner[k] in (-1, cta // 2)
            owner[k] = cta // 2
        covered = np.zeros(hidden, np.int64)
        for c in range(cta - cta % 2, cta - cta % 2 + 2):
            u0, n = plan.columns_of(c, hidden)
            assert u0 == (c % 2) * n and n % 16 == 0
            covered[u0:u0 + n] += 1
        assert (covered == 1).all()
    assert (owner >= 0).all()
    for bad in (0, 48, 544, 1024):
        with pytest.raises(ValueError, match="H % 32 == 0 and H <= 512"):
            bwd_plan(rows, channels, bad, True)


@pytest.mark.parametrize("channels", [7, 61, 130])
@pytest.mark.parametrize("hidden", [32, 256, 288, 512])
@pytest.mark.parametrize("rows", [185, 8449, 131072])
def test_bwd_plan_f32_takes_kernel_9s_widths_on_their_tiles(rows, hidden, channels):
    """The float32 mode takes kernel 9's widths, so a float32 model with
    H <= 512 trains: any C, 32-row tiles up to H = 256 and 16-row tiles above
    it, each row tile owned once, one partial row a CTA."""
    plan = bwd_plan(rows, channels, hidden, False)
    assert plan.tile_rows == (32 if hidden <= 256 else 16)
    assert plan.ctas == min(BWD_CTAS, -(-rows // plan.tile_rows))
    assert plan.part == plan.ctas * (channels + 3) * hidden
    owned = np.zeros(rows, np.int64)
    for cta in range(plan.ctas):
        for row0, n in plan.tiles_of(cta, rows):
            owned[row0:row0 + n] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("hidden", [0, 48, 544, 1024])
def test_bwd_plan_f32_rejects_hidden_off_the_kernel(hidden):
    with pytest.raises(ValueError, match="input_block_bwd in float32 needs H % 32 == 0 and "
                                         "H <= 512"):
        bwd_plan(185, 61, hidden, False)


@pytest.mark.parametrize("hidden", [32, 256, 288, 512])
@pytest.mark.parametrize("rows", [1, 31, 32, 185, 8448, 8449, 131072, 262144])
def test_fwd_plan_owns_every_row_tile_once_and_takes_its_tile_by_width(rows, hidden):
    """Kernel 9's launch plan: its persistent CTAs' tiles (tile i of CTA c: i
    = c, c + ctas, ..) cover every row exactly once, every CTA owns at least
    one, on at most FWD_CTAS CTAs; 64-row tiles up to H = 256 (the warps of a
    64-row tile cover 256 units), 32-row tiles above it (a 64-row float32 z
    tile and W would not fit in shared memory at H = 512)."""
    plan = fwd_plan(rows, hidden)
    assert plan.tile_rows == (64 if hidden <= 256 else 32)
    assert plan.ctas == min(FWD_CTAS, -(-rows // plan.tile_rows))
    owned = np.zeros(rows, np.int64)
    for cta in range(plan.ctas):
        tiles = plan.tiles_of(cta, rows)
        assert tiles
        for row0, n in tiles:
            assert row0 % plan.tile_rows == 0 and 0 < n <= plan.tile_rows
            owned[row0:row0 + n] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("hidden", [0, 48, 544, 1024])
def test_fwd_plan_rejects_hidden_off_the_kernel(hidden):
    with pytest.raises(ValueError, match="H % 32 == 0 and H <= 512"):
        fwd_plan(185, hidden)
