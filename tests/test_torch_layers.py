"""eegflow_torch layers against eegflow.nn: dense (float32 and the bf16
policy), LayerNorm, GELU and additive attention. The same float32 inputs go
through both; the only differences are float32 summation orders, so the
tolerance is 1e-6 (absolute, on values of order 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn import attention as jatt
from eegflow.nn import layers as jl
from eegflow_torch.nn import attention as tatt
from eegflow_torch.nn import layers as tl

TOL = 1e-6


def _pair(rng, shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _dense(rng, din, dout):
    w = rng.uniform(-0.5, 0.5, (din, dout)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (dout,)).astype(np.float32)
    return ({"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)})


@pytest.mark.parametrize("bf16", [False, True])
def test_dense_apply_matches_reference(bf16):
    rng = np.random.default_rng(0)
    jp, tp = _dense(rng, 24, 12)
    xj, xt = _pair(rng, (3, 7, 24))
    want = jl.dense_apply(jp, xj, jnp.bfloat16 if bf16 else None)
    got = tl.dense_apply(tp, xt, torch.bfloat16 if bf16 else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_bf16_round_matches_jax_cast():
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (1000,), scale=10.0)
    want = np.asarray(xj.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(tl.bf16_round(xt).numpy(), want)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (4, 9, 32), scale=3.0)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    want = jl.layer_norm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, xj)
    got = tl.layer_norm_apply({"scale": torch.from_numpy(scale),
                               "bias": torch.from_numpy(bias)}, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_gelu_is_exact_erf_form():
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (2000,), scale=4.0)
    np.testing.assert_allclose(tl.gelu(xt).numpy(), np.asarray(jl.gelu(xj)), atol=TOL, rtol=0)


@pytest.mark.parametrize("b,t,d", [(4, 16, 16), (3, 9, 32)])
def test_additive_attention_matches_reference(b, t, d):
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(np.asarray,
                                    jatt.additive_attention_init(jax.random.key(0), d))
    tparams = {k: {n: torch.from_numpy(np.array(v)) for n, v in sub.items()}
               for k, sub in params.items()}
    xj, xt = _pair(rng, (b, t, d))
    ctx_j, w_j = jatt.additive_attention_apply(params, xj)
    ctx_t, w_t = tatt.additive_attention_apply(tparams, xt)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(w_t.sum(-1).numpy(), 1.0, atol=TOL)
