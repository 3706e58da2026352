"""The port's pool-head backward against eegflow's: the ``PoolHead`` autograd
Function (forward twin, backward twin) against ``jax.grad`` of
``pool_head_fused`` (both Pallas kernels in interpret mode), with LayerNorm
on and off and one and two parts. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_attention import pool_head_fused as pallas_pool_head
from eegflow_torch.nn.cuda_attention import pool_head, pool_head_bwd, pool_head_bwd_plain

# Same LayerNorm formula, the same bf16-rounded operands (y before W1, u
# before W1^T and dW1) on both sides, float32 sums in another order. A
# last-bit difference in a LayerNorm output can flip its bf16 rounding, one
# bf16 ulp (2^-8 relative) of one operand, which moves a weight-gradient
# entry by up to ~1e-3 of the gradient's largest entry at these sizes
# (measured 9e-4 in one case; the others agree to 2e-5). Relative to the
# largest entry of each gradient.
REL_TOL = 2e-3


def _params(rng, d, k):
    f = lambda *s, sc=0.3: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    ln = {"scale": 1.0 + f(d, sc=0.1), "bias": f(d, sc=0.1)}
    attn = {"proj": {"w": f(d, k), "b": f(k)}, "score": {"w": f(k, 1), "b": f(1)}}
    return ln, attn


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_pool_head_function_grads_match_jax(n_parts, use_ln):
    rng = np.random.default_rng(60 + n_parts + 2 * use_ln)
    d_part, k, b, t = 16, 16, 5, 24
    ln, attn = _params(rng, d_part * n_parts, k)
    xs = tuple(np.tanh(rng.standard_normal((b, t, d_part))).astype(np.float32)
               for _ in range(n_parts))
    r_ctx = tuple(rng.standard_normal((b, d_part)).astype(np.float32) for _ in range(n_parts))
    r_s = rng.standard_normal((b, t)).astype(np.float32)

    def loss_jax(ln_, attn_, xs_):
        ctx, s = pallas_pool_head(ln_ if use_ln else None, attn_, xs_, use_ln=use_ln, bf16=True)
        return sum(jnp.sum(c * r) for c, r in zip(ctx, r_ctx)) + jnp.sum(s * r_s)

    want, (g_ln, g_attn, g_xs) = jax.value_and_grad(loss_jax, argnums=(0, 1, 2))(
        _map(ln, jnp.asarray), _map(attn, jnp.asarray), tuple(jnp.asarray(x) for x in xs))

    tln = _map(ln, lambda a: torch.from_numpy(a).requires_grad_())
    tattn = _map(attn, lambda a: torch.from_numpy(a).requires_grad_())
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    ctx, s = pool_head(tln if use_ln else None, tattn, txs, use_ln=use_ln, bf16=True)
    loss = sum((c * torch.from_numpy(r)).sum() for c, r in zip(ctx, r_ctx)) \
        + (s * torch.from_numpy(r_s)).sum()
    loss.backward()
    assert abs(loss.item() - float(want)) < REL_TOL * max(1.0, abs(float(want)))
    assert _rel(tattn["proj"]["w"].grad.numpy(), g_attn["proj"]["w"]) < REL_TOL
    assert _rel(tattn["proj"]["b"].grad.numpy(), g_attn["proj"]["b"]) < REL_TOL
    assert _rel(tattn["score"]["w"].grad.numpy(), g_attn["score"]["w"]) < REL_TOL
    # softmax ignores the score bias: the reference's VJP gives it zeros and
    # the port's Function gives it no gradient at all (the optimizer reads
    # None as zeros)
    np.testing.assert_array_equal(np.asarray(g_attn["score"]["b"]), 0.0)
    assert tattn["score"]["b"].grad is None
    if use_ln:
        assert _rel(tln["scale"].grad.numpy(), g_ln["scale"]) < REL_TOL
        assert _rel(tln["bias"].grad.numpy(), g_ln["bias"]) < REL_TOL
    else:
        assert tln["scale"].grad is None and tln["bias"].grad is None
    for x, g in zip(txs, g_xs):
        assert _rel(x.grad.numpy(), g) < REL_TOL


def test_pool_head_bwd_wrapper_runs_the_twin_on_cpu():
    rng = np.random.default_rng(7)
    ln, attn = _params(rng, 32, 16)
    tln, tattn = _map(ln, torch.from_numpy), _map(attn, torch.from_numpy)
    xs = tuple(torch.from_numpy(rng.standard_normal((3, 9, 16)).astype(np.float32))
               for _ in range(2))
    w = torch.softmax(torch.from_numpy(rng.standard_normal((3, 9)).astype(np.float32)), -1)
    gs = torch.from_numpy(rng.standard_normal((3, 9)).astype(np.float32))
    gc = tuple(torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
               for _ in range(2))
    gctx = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    got = pool_head_bwd(tln, tattn, xs, w, gs, gc, gctx, True, True)
    want = pool_head_bwd_plain(tln, tattn, xs, w, gs, gc, gctx, True, True)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    assert got[1].shape == (32, 16) and got[4].shape == (32,)
