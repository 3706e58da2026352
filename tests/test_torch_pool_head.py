"""The ``pool_head_fwd`` kernel's plain twin against the Pallas
``_pool_head_fwd_kernel`` (``pool_head_fused``, interpret mode on the CPU),
and kernel 6's twin (``attention_pool``) against ``_attention_pool_kernel``
(``attention_pool_pallas`` / ``pallas_attention_apply``). Inputs are made
with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_attention import attention_pool_pallas, pallas_attention_apply
from eegflow.nn.pallas_attention import pool_head_fused as pallas_pool_head
from eegflow_torch.nn.cuda_attention import (attention_pool, attention_pool_apply,
                                             attention_pool_plain, check_bf16_widths,
                                             check_f32_widths, pool_head_bwd_bf16_plan,
                                             pool_head_fused, pool_head_fused_plain)

# Same LayerNorm formula and the same bf16-rounded operands on both sides;
# float32 sums in another order (and, under bf16, a last-bit LN difference
# can flip the rounding of one y element), online softmax against a direct one.
TOL = 2e-5


def _params(rng, d, k):
    f = lambda *s, sc=0.3: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    ln = {"scale": 1.0 + f(d, sc=0.1), "bias": f(d, sc=0.1)}
    attn = {"proj": {"w": f(d, k), "b": f(k)}, "score": {"w": f(k, 1), "b": f(1)}}
    return ln, attn


def _map(tree, fn):
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_pool_head_twin_matches_pallas(n_parts, use_ln, bf16):
    rng = np.random.default_rng(20 + n_parts)
    d_part, k, b, t = 16, 16, 5, 24
    ln, attn = _params(rng, d_part * n_parts, k)
    xs = tuple(np.tanh(rng.standard_normal((b, t, d_part))).astype(np.float32)
               for _ in range(n_parts))
    want_ctx, want_s = pallas_pool_head(
        _map(ln, jnp.asarray) if use_ln else None, _map(attn, jnp.asarray),
        tuple(jnp.asarray(x) for x in xs), use_ln=use_ln, bf16=bf16)
    tln, tattn = _map(ln, torch.from_numpy), _map(attn, torch.from_numpy)
    txs = tuple(torch.from_numpy(x) for x in xs)
    got_ctx, got_s = pool_head_fused_plain(tln if use_ln else None, tattn, txs, use_ln, bf16)
    assert len(got_ctx) == n_parts and got_s.shape == (b, t)
    for g, w in zip(got_ctx, want_ctx):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=TOL, rtol=0)
    # on CPU tensors the wrapper runs the twin
    w_ctx, w_s = pool_head_fused(tln if use_ln else None, tattn, txs, use_ln, bf16)
    torch.testing.assert_close(w_s, got_s, rtol=0, atol=0)
    for g, w in zip(w_ctx, got_ctx):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_pool_head_scores_stable_at_large_magnitude():
    """Large raw scores: the twin's softmax must not overflow (the kernel
    keeps a running max for the same reason)."""
    rng = np.random.default_rng(3)
    ln, attn = _params(rng, 16, 16)
    attn["score"]["w"] *= 200.0
    x = torch.from_numpy(rng.standard_normal((2, 12, 16)).astype(np.float32))
    ctx, s = pool_head_fused_plain(None, _map(attn, torch.from_numpy), (x,),
                                   use_ln=False, bf16=True)
    assert s.abs().max() > 100 and torch.isfinite(ctx[0]).all()
    want_ctx, _ = jax.jit(lambda a, xx: pallas_pool_head(None, a, (xx,), use_ln=False,
                                                         bf16=True))(
        _map(attn, jnp.asarray), jnp.asarray(x.numpy()))
    np.testing.assert_allclose(ctx[0].numpy(), np.asarray(want_ctx[0]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("batch", [3, 8])
def test_attention_pool_twin_matches_pallas(batch):
    """Kernel 6: one float32 part, no LayerNorm; the raw scores and the
    context against ``attention_pool_pallas``, and the apply wrapper (score
    bias and softmax outside) against ``pallas_attention_apply``. Float32
    sums in another order, an online softmax against a direct one (TOL)."""
    rng = np.random.default_rng(30 + batch)
    d, k, t = 32, 16, 24
    _, attn = _params(rng, d, k)
    x = rng.standard_normal((batch, t, d)).astype(np.float32)
    tattn = _map(attn, torch.from_numpy)
    args = (torch.from_numpy(x), tattn["proj"]["w"], tattn["proj"]["b"],
            tattn["score"]["w"][:, 0])
    ctx, scores = attention_pool_plain(*args)
    if batch % 8 == 0:  # the Pallas entry takes a batch the tile divides
        want_ctx, want_s = attention_pool_pallas(
            jnp.asarray(x), jnp.asarray(attn["proj"]["w"]), jnp.asarray(attn["proj"]["b"]),
            jnp.asarray(attn["score"]["w"][:, 0]), batch_tile=8, t_chunk=8, interpret=True)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=TOL, rtol=0)
        np.testing.assert_allclose(scores.numpy(), np.asarray(want_s), atol=TOL, rtol=0)
    want_ctx, want_w = pallas_attention_apply(_map(attn, jnp.asarray), jnp.asarray(x))
    got_ctx, got_w = attention_pool_apply(tattn, torch.from_numpy(x))
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), atol=TOL, rtol=0)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=TOL, rtol=0)
    # on CPU tensors the wrapper runs the twin
    w_ctx, w_s = attention_pool(*args)
    assert torch.equal(w_ctx, ctx) and torch.equal(w_s, scores)


@pytest.mark.parametrize("hidden", [32, 64, 128, 160, 256, 288, 512])
def test_bf16_width_rule_takes_the_classifiers_widths(hidden):
    """The bf16 modes of kernels 7 and 8 share one width rule; it takes the
    classifier's D = 2H and K = H for every H <= 512 that is a multiple of
    32, and the widths of the card tests (D = 64, K = 96; one part of 512
    with K = 512)."""
    for name in ("pool_head_fwd", "pool_head_bwd"):
        check_bf16_widths(name, 2 * hidden, hidden)
    check_bf16_widths("pool_head_fwd", 64, 96)
    check_bf16_widths("pool_head_fwd", 512, 512)
    check_bf16_widths("pool_head_bwd", 1024, 512)


@pytest.mark.parametrize("d,k", [(40, 64), (1056, 256), (512, 544), (512, 48), (48, 32)])
def test_bf16_width_rule_rejects_widths_off_its_tiles(d, k):
    with pytest.raises(ValueError, match=rf"pool_head_fwd under bf16 needs D <= 1024 and K "
                                         rf"<= 512, both multiples of 32; got D={d}, K={k}"):
        check_bf16_widths("pool_head_fwd", d, k)


@pytest.mark.parametrize("d,k", [(40, 64), (1056, 256), (512, 544)])
def test_bf16_plan_refuses_what_the_width_rule_refuses(d, k):
    """Kernel 8's launch plan (read from its C entry point on the card)
    refuses, before it builds anything, the widths the bf16 rule refuses."""
    with pytest.raises(ValueError, match=rf"pool_head_bwd under bf16 needs D <= 1024 and K "
                                         rf"<= 512, both multiples of 32; got D={d}, K={k}"):
        pool_head_bwd_bf16_plan(d, k)


@pytest.mark.parametrize("hidden", [32, 64, 256, 288, 512])
def test_f32_width_rule_takes_the_classifiers_widths(hidden):
    """The float32 modes of kernels 7 and 8 (and kernel 6) share one width
    rule; it takes the classifier's D = 2H and K = H for every H <= 512 that
    is a multiple of 32 (the widths kernels 9 and 10 take), kernel 6's D = H,
    K = H / 2, and the widths of the card tests (D = 1024, K = 96)."""
    for name in ("pool_head_fwd", "pool_head_bwd", "attention_pool"):
        check_f32_widths(name, 2 * hidden, hidden)
    check_f32_widths("attention_pool", 256, 128)
    check_f32_widths("pool_head_fwd", 1024, 96)


@pytest.mark.parametrize("d,k", [(40, 64), (64, 40), (1056, 64), (64, 544), (48, 32)])
def test_f32_width_rule_rejects_widths_off_its_tiles(d, k):
    with pytest.raises(ValueError, match=rf"pool_head_fwd in float32 needs D <= 1024 and K "
                                         rf"<= 512, both multiples of 32; got D={d}, K={k}"):
        check_f32_widths("pool_head_fwd", d, k)
