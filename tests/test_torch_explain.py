"""The model-driven attributions of eegflow_torch against ``eegflow.explain``
on the same numpy inputs and the JAX params pytree, converted with
``params_from_jax``: per-window input gradients (the port's plain schedule
against ``jax.grad`` of the Pallas path in interpret mode, with the fused
input block), ``gradient_channel_importance``, ``permutation_channel_importance``
and ``kernel_shap_channel_importance`` (against the JAX functions, whose
``"auto"`` resolves to the scan path on the CPU). The port runs its plain
twins on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.core import config as jcfg
from eegflow.explain import gradient_channel_importance as jax_gradient_importance
from eegflow.explain import kernel_shap_channel_importance as jax_kernel_shap
from eegflow.explain import permutation_channel_importance as jax_permutation_importance
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow.nn.model import classifier_init as jax_init
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.explain import (gradient_channel_importance, kernel_shap_channel_importance,
                                   permutation_channel_importance)
from eegflow_torch.explain.gradient import batch_input_gradients
from eegflow_torch.nn.model import classifier_apply
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(input_size=5, hidden_size=32, num_layers=2)
# per-window input gradients, relative to the largest entry, against the
# Pallas path: float32 sums in another order (as tests/test_torch_f32.py
# holds the float32 gradients; measured 5.5e-7), and under bf16 the
# rounding-tie flips of tests/test_torch_train.py (measured 1.6e-3)
GRAD_REL_TOL = {"float32": 1e-4, "bf16": 2e-2}
# the normalised gradient importance against the JAX function on its scan
# path, whose bf16 input block is XLA's dense -> LayerNorm -> GELU: the same
# sampled windows, |grad| summed over them (measured 6.4e-5)
IMPORTANCE_TOL = 2e-3
# KernelSHAP values and importance against the JAX function: the same
# coalitions, the model's P(closed) within ~2e-4 of the scan path's
# (tests/test_torch_couple.py); measured 1.0e-5 on the values, 2.9e-4 on
# the normalised importance
SHAP_TOL = 1e-3
# the efficiency identity sum(phi) = f(x) - phi0, per explained row
EFFICIENCY_TOL = 1e-6


def _models(seed):
    jc = jcfg.ModelConfig(**SMALL)
    params = jax_init(jax.random.key(seed), jc)
    return params, jc, params_from_jax(params), tcfg.ModelConfig(**SMALL)


def _windows(seed, b, t=16):
    return np.random.default_rng(seed).standard_normal((b, t, 5)).astype(np.float32)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture
def fused_input(monkeypatch):
    """The JAX package's schedule that the port runs: the fused input block."""
    monkeypatch.setenv("EEGFLOW_FUSED_INPUT", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("policy", ["float32", "bf16"])
def test_input_gradients_match_jax_grad_on_the_pallas_path(policy, fused_input):
    jp, jc, tp, tc = _models(1)
    x = _windows(2, 3, t=8)
    jdtype = jnp.bfloat16 if policy == "bf16" else None
    pred = jnp.argmax(jax_apply(jp, jnp.asarray(x), jc, compute_dtype=jdtype,
                                lstm_impl="pallas"), axis=-1)

    def summed(x_in):
        lg = jax_apply(jp, x_in, jc, compute_dtype=jdtype, lstm_impl="pallas")
        return jnp.sum(jnp.take_along_axis(lg, pred[:, None], axis=-1))

    want = np.asarray(jax.grad(summed)(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    if policy == "bf16":
        got = batch_input_gradients(tp, xt, tc).numpy()
    else:
        x_in = xt.clone().requires_grad_(True)
        logits = classifier_apply(tp, x_in, tc)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(pred))
        (got,) = torch.autograd.grad(logits.gather(1, torch.tensor(
            np.asarray(pred))[:, None]).sum(), x_in)
        got = got.numpy()
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) <= GRAD_REL_TOL[policy]


def test_gradient_channel_importance_matches_jax():
    jp, jc, tp, tc = _models(3)
    x = _windows(4, 30)
    names = [f"E{i}" for i in range(5)]
    kw = dict(n_samples=12, batch_size=12, channel_names=names)
    want = jax_gradient_importance(jp, jc, x, **kw)
    got = gradient_channel_importance(tp, tc, x, **kw)
    assert set(got) == set(want) and got["method"] == "gradient"
    assert got["channels"] == names
    np.testing.assert_allclose(np.sum(got["importance"]), 1.0, atol=1e-12)
    np.testing.assert_allclose(got["importance"], want["importance"], atol=IMPORTANCE_TOL,
                               rtol=0)


def _logit_gap(params, jc, x):
    logits = np.asarray(jax_apply(params, jnp.asarray(x), jc, compute_dtype=jnp.bfloat16,
                                  lstm_impl="scan"))
    return logits[:, 1] - logits[:, 0]


def test_permutation_importance_matches_jax():
    """Both packages permute the same windows from the same seed; where no
    window's decision is within reach of the two schedules' difference the
    accuracies, and so the importances, are equal. Channel 3 carries a
    group offset that moves the logits far more than the noise does, and the
    head's bias puts the decision between the two groups."""
    jc = jcfg.ModelConfig(**SMALL)
    jp = jax_init(jax.random.key(7), jc)
    rng = np.random.default_rng(6)
    group = rng.integers(0, 2, 50)
    x = 0.3 * rng.standard_normal((50, 16, 5)).astype(np.float32)
    x[:, :, 2] += (4.0 * group - 2.0)[:, None]
    gap = _logit_gap(jp, jc, x)
    mid = 0.5 * (gap[group == 0].mean() + gap[group == 1].mean())
    jp["head3"]["b"] = jp["head3"]["b"].at[1].add(-mid)
    tp, tc = params_from_jax(jp), tcfg.ModelConfig(**SMALL)
    y = (_logit_gap(jp, jc, x) > 0).astype(np.int64)  # labels the model gets right
    kw = dict(n_permutations=2, n_samples=30, batch_size=32, seed=11)
    want = jax_permutation_importance(jp, jc, x, y, **kw)
    got = permutation_channel_importance(tp, tc, x, y, **kw)
    # the windows and permutations the reference draws, in its order
    rng = np.random.RandomState(11)
    xs = x[rng.choice(50, 30, replace=False)]
    perms = np.stack([[rng.permutation(30) for _ in range(2)] for _ in range(5)])
    stacked = np.concatenate([xs] + [
        np.where(np.arange(5) == ch, xs[perms[ch].reshape(-1)], np.tile(xs, (2, 1, 1)))
        for ch in range(5)])
    mine = classifier_apply(tp, torch.from_numpy(stacked), tc,
                            compute_dtype=torch.bfloat16).numpy()
    theirs = _logit_gap(jp, jc, stacked)
    assert np.abs(theirs).min() > 4 * np.abs((mine[:, 1] - mine[:, 0]) - theirs).max()
    assert got == want
    assert got["baseline_accuracy"] == 1.0 and got["ranking"][0] == "Ch3"
    assert got["importance"][2] > 0.2


def test_kernel_shap_channel_importance_matches_jax():
    jp, jc, tp, tc = _models(8)
    x = _windows(9, 24)
    kw = dict(n_background=4, n_explain=3, nsamples=100, seed=5)
    want = jax_kernel_shap(jp, jc, x, **kw)
    got = kernel_shap_channel_importance(tp, tc, x, **kw)
    assert set(got) == set(want) and got["method"] == "kernel_shap"
    np.testing.assert_array_equal(got["x_explain"], want["x_explain"])
    assert got["shap_values"].shape == (3, 5)
    np.testing.assert_allclose(got["shap_values"], want["shap_values"], atol=SHAP_TOL, rtol=0)
    np.testing.assert_allclose(got["importance"], want["importance"], atol=SHAP_TOL, rtol=0)
    # efficiency: sum(phi) = f(x) - E_bg[f], the model's P(closed) on the
    # rows tiled across time
    bg = x.mean(axis=1)[np.random.RandomState(5).choice(24, 4, replace=False)]

    def f(rows):
        tiled = np.repeat(rows.astype(np.float32)[:, None, :], 16, axis=1)
        logits = classifier_apply(tp, torch.from_numpy(tiled), tc, compute_dtype=torch.bfloat16)
        return torch.softmax(logits, -1)[:, 1].double().numpy()

    np.testing.assert_allclose(got["shap_values"].sum(1), f(got["x_explain"]) - f(bg).mean(),
                               atol=EFFICIENCY_TOL, rtol=0)
