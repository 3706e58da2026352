"""eegflow_torch classifier, ODE and coupled rollout against eegflow.

The classifier's fused bf16 schedule (the plain twins on the CPU) is held
against JAX ``classifier_apply(..., lstm_impl="pallas")`` with its Pallas
kernels in interpret mode; the float32 schedule against the ``lax.scan``
path; the exact ODE solve against JAX and against scipy's ``solve_ivp``;
the coupled rollout against the JAX rollout. Inputs come from numpy seeds
and the JAX params pytree, converted with ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from eegflow.core import config as jcfg
from eegflow.couple import modulation as jmod
from eegflow.couple.rollout import CoupledModel as JaxCoupledModel
from eegflow.couple.rollout import predict_batch as jax_predict_batch
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow.nn.model import classifier_init as jax_init
from eegflow.ode import field as jfield
from eegflow.ode import integrate as jint
from eegflow.ode.field import rates_to_array as jax_rates
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.couple import modulation as tmod
from eegflow_torch.couple.rollout import CoupledModel, coupled_rollout, predict_batch
from eegflow_torch.nn.model import classifier_apply, resolve_lstm_impl
from eegflow_torch.ode import integrate as tint
from eegflow_torch.ode import field as tfield
from eegflow_torch.ode.field import DEFAULT_RATES, RATE_NAMES, rates_to_array
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(input_size=5, hidden_size=32, num_layers=2)
# bf16 schedule vs the Pallas path: identical bf16-rounded operands and
# LayerNorm formulas, float32 sums in another order through 2 layers x 2
# directions, the pool head and the head; a rounding flip of one bf16 operand
# moves a logit by a few 1e-5 at these widths (measured up to 3e-5)
LOGIT_TOL = 1e-4
# float32 schedule vs the scan path: summation order only
F32_TOL = 1e-5
# the judged ODE budget against scipy
ODE_TOL = 1e-5

RATES_CASES = [
    DEFAULT_RATES,
    {"k_ap": 0.020, "k_af": 0.095, "k_pa": 0.02, "k_pf": 0.626, "k_fa": 0.139, "k_fp": 0.02},
    {"k_ap": 0.5, "k_af": 0.2, "k_pa": 0.5, "k_pf": 0.3, "k_fa": 0.3, "k_fp": 0.4},
    {"k_ap": 0.1, "k_af": 0.4, "k_pa": 0.3, "k_pf": 0.6, "k_fa": 0.6, "k_fp": 0.1},
]


def _models(kw, seed=0):
    jc = jcfg.ModelConfig(**kw)
    params = jax_init(jax.random.key(seed), jc)
    return params, jc, params_from_jax(params), tcfg.ModelConfig(**kw)


def _windows(seed, b, t=16, c=5):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, use_attention=False),
                                dict(SMALL, use_layer_norm=False)],
                         ids=["flagship", "mean_pool", "no_ln"])
def test_classifier_bf16_matches_pallas(kw):
    jp, jc, tp, tc = _models(kw)
    x = _windows(1, 4)
    want_logits, want_attn = jax_apply(jp, jnp.asarray(x), jc, return_attention=True,
                                       compute_dtype=jnp.bfloat16, lstm_impl="pallas")
    logits, attn = classifier_apply(tp, torch.from_numpy(x), tc, return_attention=True,
                                    compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=LOGIT_TOL, rtol=0)


def test_classifier_f32_matches_scan():
    jp, jc, tp, tc = _models(SMALL, seed=2)
    x = _windows(3, 3)
    want_logits, want_attn = jax_apply(jp, jnp.asarray(x), jc, return_attention=True,
                                       lstm_impl="scan")
    logits, attn = classifier_apply(tp, torch.from_numpy(x), tc, return_attention=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=F32_TOL, rtol=0)


def test_lstm_impl_resolution_on_cpu():
    _, _, tp, tc = _models(SMALL)
    x = torch.from_numpy(_windows(4, 2))
    assert resolve_lstm_impl("auto", x.device) == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        classifier_apply(tp, x, tc, compute_dtype=torch.bfloat16, lstm_impl="kernel")
    with pytest.raises(ValueError):
        classifier_apply(tp, x, tc, lstm_impl="pallas")
    auto = classifier_apply(tp, x, tc, compute_dtype=torch.bfloat16, lstm_impl="auto")
    plain = classifier_apply(tp, x, tc, compute_dtype=torch.bfloat16, lstm_impl="plain")
    torch.testing.assert_close(auto, plain, rtol=0, atol=0)


def _scipy(y0, t1, n_points, k):
    def rhs(t, y):
        a, p, f = np.maximum(y, 0.0)
        return [-(k[0] + k[1]) * a + k[2] * p + k[4] * f,
                k[0] * a - (k[2] + k[3]) * p + k[5] * f,
                k[1] * a + k[3] * p - (k[4] + k[5]) * f]

    t = np.linspace(0.0, t1, n_points)
    return solve_ivp(rhs, (0.0, t1), y0, t_eval=t, method="RK45", rtol=1e-10,
                     atol=1e-12).y.T


def test_solve_batch_matches_scipy_and_jax():
    y0 = np.array([[0.33, 0.34, 0.33], [0.2, 0.2, 0.6], [0.6, 0.2, 0.2], [0.5, 0.5, 0.0]],
                  np.float32)
    ks = np.stack([[r[n] for n in RATE_NAMES] for r in RATES_CASES]).astype(np.float32)
    got = tint.solve_batch(torch.from_numpy(y0), 0.0, 20.0, 20, torch.from_numpy(ks)).numpy()
    want = np.asarray(jint.solve_batch(jnp.asarray(y0), 0.0, 20.0, 20, jnp.asarray(ks)))
    assert got.shape == (4, 20, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for i in range(4):
        ref = _scipy(y0[i].astype(np.float64), 20.0, 20, ks[i].astype(np.float64))
        assert np.max(np.abs(got[i] - ref)) < ODE_TOL
    raw = tint.expm_solve(torch.from_numpy(y0), 0.0, 20.0, 20, torch.from_numpy(ks))
    np.testing.assert_allclose(raw.numpy(), np.asarray(jint.expm_solve(
        jnp.asarray(y0), 0.0, 20.0, 20, jnp.asarray(ks))), atol=1e-6, rtol=0)


def test_field_matches_reference():
    rng = np.random.default_rng(8)
    k = rng.uniform(0.001, 0.6, (5, 6)).astype(np.float32)
    y = rng.uniform(-0.1, 1.0, (5, 3)).astype(np.float32)  # the clamp at 0 is exercised
    np.testing.assert_array_equal(tfield.transition_matrix(torch.from_numpy(k)).numpy(),
                                  np.asarray(jfield.transition_matrix(jnp.asarray(k))))
    np.testing.assert_allclose(tfield.apf_field(torch.from_numpy(y), torch.from_numpy(k)).numpy(),
                               np.asarray(jfield.apf_field(jnp.asarray(y), jnp.asarray(k))),
                               atol=1e-7, rtol=0)
    assert DEFAULT_RATES == jfield.DEFAULT_RATES and RATE_NAMES == jfield.RATE_NAMES


def test_modulation_and_initial_state_exact():
    rng = np.random.default_rng(5)
    p_closed = rng.uniform(0, 1, 64).astype(np.float32)
    p_closed[:4] = [0.6, 0.4, 0.0, 1.0]  # threshold edges
    p_open = (1 - p_closed).astype(np.float32)
    k = np.array(jax_rates(DEFAULT_RATES))
    for alpha, floor in ((0.5, 1e-3), (1.0, 0.05)):
        want = jmod.modulate_rates(jnp.asarray(k), jnp.asarray(p_closed), jnp.asarray(p_open),
                                   alpha, floor)
        got = tmod.modulate_rates(torch.from_numpy(k), torch.from_numpy(p_closed),
                                  torch.from_numpy(p_open), alpha, floor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jmod.infer_initial_state(jnp.asarray(p_closed), jnp.asarray(p_open), 0.6)
    got = tmod.infer_initial_state(torch.from_numpy(p_closed), torch.from_numpy(p_open), 0.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_predict_batch_matches_jax_rollout():
    jp, jc, tp, tc = _models(SMALL, seed=4)
    x = _windows(6, 11)
    want = jax_predict_batch(JaxCoupledModel(jp, jc, jax_rates(DEFAULT_RATES),
                                             jcfg.CouplingConfig(), lstm_impl="pallas"), x)
    model = CoupledModel(tp, tc, rates_to_array(DEFAULT_RATES), tcfg.CouplingConfig(),
                         device=torch.device("cpu"))
    got = predict_batch(model, x)
    assert set(got) == set(want)
    for name in ("probs", "attention", "trajectories", "final_state"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name], want[name], atol=LOGIT_TOL, rtol=0)
    decided = np.abs(want["final_state"] - 0.5).min(-1) > LOGIT_TOL
    np.testing.assert_array_equal(got["pred_binary"][decided], want["pred_binary"][decided])
    np.testing.assert_array_equal(got["pred_three"][decided], want["pred_three"][decided])


def test_predict_batch_buckets_and_chunks():
    """Chunks of batch_size, each padded to a power-of-two bucket, give the
    same rows as one rollout over the whole batch."""
    _, _, tp, tc = _models(SMALL, seed=5)
    x = _windows(7, 13)
    model = CoupledModel(tp, tc, rates_to_array(DEFAULT_RATES), tcfg.CouplingConfig(),
                         device=torch.device("cpu"))
    chunked = predict_batch(model, x, batch_size=8)
    whole = coupled_rollout(tp, torch.from_numpy(x), model.k_base, tc)
    for name, val in chunked.items():
        assert len(val) == 13
        np.testing.assert_allclose(val, whole[name].numpy(), atol=1e-5, rtol=0)
    traj = chunked["trajectories"]
    assert traj.shape == (13, 20, 3)
    np.testing.assert_allclose(traj.sum(-1), 1.0, atol=1e-5)
