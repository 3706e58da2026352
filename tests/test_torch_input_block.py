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

from eegflow.nn.pallas_input import input_block_fused as jax_input_block
from eegflow_torch.nn.cuda_input import (input_block, input_block_bwd, input_block_bwd_plain,
                                         input_block_fused, input_block_fused_plain)

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
