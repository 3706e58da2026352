"""The ``"dualdir"`` backward schedule against eegflow's Pallas kernels in
interpret mode under ``EEGFLOW_BWD_DUALDIR=1`` (the select-dropout path: no
``EEGFLOW_MASK_DROPOUT``): the kernel 4 twin against ``lstm_bwd_dualdir`` on
the same planes, ``select_dropout`` against the reference's
``dropout_fwd_only``, the ``BiLSTMLayer`` Function against ``jax.grad`` of
``bilstm_layer_fused_parts(..., mask_from_x=True)`` on pre-dropped parts, the
classifier and a train step against the reference's schedule, and the
selector's errors.

The flags are set and restored by ``reference_flags`` of
``test_torch_lstm_bwd_v2`` (environment first, then ``refresh_flags()`` and
``jax.clear_caches()``). Inputs are made with numpy from a seed; tiny shapes,
no exact zeros among the kept values (``mask_from_x`` would read them as
dropped, in the reference as in the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_lstm import bilstm_layer_fused_parts
from eegflow.nn.pallas_lstm import lstm_bwd_dualdir as pallas_bwd_dualdir
from eegflow.nn.pallas_lstm import lstm_fwd_fused_proj as pallas_fwd_proj
from eegflow_torch.core import config as tcfg
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, lstm_bwd_dualdir, lstm_bwd_dualdir_plain,
                                        select_dropout)
from eegflow_torch.nn.model import classifier_apply, classifier_init
from test_torch_lstm_bwd_v2 import (BWD_REL_TOL, KEEP, LAYER_REL_TOL, SMALL, TILE, _inputs,
                                    _pad, _rel, _t, _weights, classifier_matches_reference,
                                    reference_flags, train_step_matches_reference)
from torch_threads import one_torch_thread  # noqa: F401

DUALDIR = {"EEGFLOW_BWD_DUALDIR": "1", "EEGFLOW_MASK_DROPOUT": None}
# the reference's schedule of the port's whole classifier under "dualdir": the
# fused input block, select dropout, kernel 4 in every bidirectional layer
CLASSIFIER_DUALDIR = dict(DUALDIR, EEGFLOW_FUSED_INPUT="1")


@pytest.fixture
def dualdir():
    with reference_flags(DUALDIR):
        yield


@pytest.fixture
def classifier_dualdir():
    with reference_flags(CLASSIFIER_DUALDIR):
        yield


def _dropped(xs, ms):
    """The parts as select dropout leaves them: where(m, x / keep, 0)."""
    return tuple(np.where(m != 0, x / np.float32(KEEP), np.float32(0)).astype(np.float32)
                 for x, m in zip(xs, ms))


def _pallas_planes(xs, p, reverse):
    """Pallas training-mode forward without masks on the padded batch ->
    the residual tuple ``lstm_bwd_dualdir`` takes (z, c, h, h_bound,
    c_bound): the six planes, c None under the adjoint-plane contract."""
    h, c, z, tc, hb, cb, _ = pallas_fwd_proj(
        tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
        jnp.asarray(p["w_hh"]), batch_tile=TILE, t_chunk=4, need_residuals=True,
        interpret=True, reverse=reverse)
    assert c is None and tc is None and z.shape[-1] == 6 * p["w_hh"].shape[0]
    return z, c, h, hb, cb


@pytest.mark.parametrize("mask_from_x", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_bwd_dualdir_twin_matches_pallas_on_the_same_planes(n_parts, mask_from_x, dualdir):
    rng, pf, xs, ms = _inputs(90 + n_parts, n_parts)
    pr = _weights(rng, xs[0].shape[-1] * n_parts, pf["w_hh"].shape[0])
    keep = KEEP if mask_from_x else 1.0
    if mask_from_x:
        xs = _dropped(xs, ms)
    batch, steps, _ = xs[0].shape
    hidden = pf["w_hh"].shape[0]
    res_f, res_r = _pallas_planes(xs, pf, False), _pallas_planes(xs, pr, True)
    g_f, g_r = ((0.1 * rng.standard_normal((batch, steps, hidden))).astype(np.float32)
                for _ in range(2))
    dxs_f, dxs_r, want_f, want_r = pallas_bwd_dualdir(
        res_f, res_r, tuple(_pad(x) for x in xs), _pad(g_f), _pad(g_r),
        jnp.asarray(pf["w_ih"]), jnp.asarray(pf["w_hh"]), jnp.asarray(pr["w_ih"]),
        jnp.asarray(pr["w_hh"]), keep=keep, mask_from_x=mask_from_x, batch_tile=TILE,
        t_chunk=4, interpret=True)
    cut = lambda a: torch.from_numpy(np.array(a)[:batch])  # noqa: E731
    tf, tr = _t(pf), _t(pr)
    args = (cut(res_f[0]), cut(res_f[2]), torch.from_numpy(g_f),
            cut(res_r[0]), cut(res_r[2]), torch.from_numpy(g_r),
            tuple(torch.from_numpy(x) for x in xs), (tf["w_ih"], tf["w_hh"]),
            (tr["w_ih"], tr["w_hh"]), keep, mask_from_x)
    got_dx, got_f, got_r = lstm_bwd_dualdir_plain(*args)
    # the reference returns each direction's dx and adds them outside
    for dx, a, b in zip(got_dx, dxs_f, dxs_r):
        assert _rel(dx.numpy(), (np.asarray(a) + np.asarray(b))[:batch]) < BWD_REL_TOL
    for got, want in ((got_f, want_f), (got_r, want_r)):
        for a, b in zip(got, want):
            assert _rel(a.numpy(), b) < BWD_REL_TOL
    if mask_from_x:  # dropped inputs get exactly zero input gradient
        for dx, m in zip(got_dx, ms):
            assert (dx.numpy()[m == 0] == 0).all()
    # on CPU tensors the wrapper runs the twin
    wrapped = lstm_bwd_dualdir(*args)
    flat = lambda out: list(out[0]) + list(out[1]) + list(out[2])  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(wrapped), flat((got_dx, got_f, got_r))))


def test_select_dropout_is_the_reference_dropout_fwd_only():
    """The same bits forward (x + (where(m, x / keep, 0) - x)), and an
    identity backward, as eegflow.nn.lstm's dropout_fwd_only."""
    rng = np.random.default_rng(95)
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    m = rng.random(x.shape) < KEEP
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jax_fwd_only(p):
        d = jnp.where(jnp.asarray(m), p / KEEP, 0.0)
        return p + jax.lax.stop_gradient(d - p)

    want, vjp = jax.vjp(jax_fwd_only, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = select_dropout(tx, torch.from_numpy(m.astype(np.uint8)), KEEP)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert (got.detach().numpy()[~m] == 0).all()


@pytest.mark.parametrize("n_parts", [1, 2])
def test_bilstm_layer_dualdir_matches_jax_grad(n_parts, dualdir):
    rng, pf, xs, ms = _inputs(100 + n_parts, n_parts)
    pb = _weights(rng, xs[0].shape[-1] * n_parts, pf["w_hh"].shape[0])
    xs = _dropped(xs, ms)

    def loss_jax(pf_, pb_, xs_):
        hf, hb = bilstm_layer_fused_parts(pf_, pb_, xs_, bf16=True, keep=KEEP,
                                          mask_from_x=True)
        return jnp.sum(jnp.tanh(hf)) + jnp.sum(jnp.cos(hb))

    jtree = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    want_loss, (gf, gb, gx) = jax.value_and_grad(loss_jax, argnums=(0, 1, 2))(
        jtree(pf), jtree(pb), tuple(jnp.asarray(x) for x in xs))

    layer = {"fwd": {k: v.requires_grad_() for k, v in _t(pf).items()},
             "bwd": {k: v.requires_grad_() for k, v in _t(pb).items()}}
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    hf, hb = bilstm_layer(layer, txs, None, KEEP, lstm_bwd="dualdir")
    loss = torch.tanh(hf).sum() + torch.cos(hb).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LAYER_REL_TOL * abs(float(want_loss))
    for direction, grads in (("fwd", gf), ("bwd", gb)):
        for k in ("w_ih", "w_hh", "b"):
            assert _rel(layer[direction][k].grad.numpy(), grads[k]) < LAYER_REL_TOL, (direction, k)
    for x, g, m in zip(txs, gx, ms):
        assert _rel(x.grad.numpy(), g) < LAYER_REL_TOL
        assert (x.grad.numpy()[m == 0] == 0).all()


def test_classifier_dualdir_matches_the_reference_schedule(classifier_dualdir):
    classifier_matches_reference("dualdir", SMALL, seeds=(12, 14, 36))


def test_train_step_dualdir_matches_the_reference_step(classifier_dualdir):
    params, jp = train_step_matches_reference("dualdir")
    assert not np.array_equal(params["head3"]["w"].detach().numpy(), np.asarray(jp["head3"]["w"]))


def test_dualdir_needs_a_bidirectional_stack_and_no_masks():
    uni = tcfg.ModelConfig(**SMALL, bidirectional=False)
    params = classifier_init(uni, trainable=True)
    with pytest.raises(ValueError, match="bidirectional"):
        classifier_apply(params, torch.zeros(2, 4, 5), uni, compute_dtype=torch.bfloat16,
                         train=True, lstm_bwd="dualdir")
    with pytest.raises(ValueError, match="bidirectional"):
        bilstm_layer(params["lstm"][0], torch.zeros(2, 4, 16), lstm_bwd="dualdir")
    bi = classifier_init(tcfg.ModelConfig(**SMALL), trainable=True)
    mask = torch.ones(2, 4, 16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="select_dropout"):
        bilstm_layer(bi["lstm"][0], torch.zeros(2, 4, 16), (mask,), KEEP, lstm_bwd="dualdir")
