"""The training half of the port's LSTM layer against eegflow's Pallas kernels
in interpret mode: the training-mode forward twin (masks, the six adjoint
planes) against ``lstm_fwd_fused_proj(need_residuals=True)``, the backward
twin against ``lstm_bwd_fused`` on the same planes, and the
``BiLSTMLayer`` autograd Function against ``jax.grad`` of
``bilstm_layer_fused_parts``. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_lstm import (bilstm_layer_fused_parts, lstm_bwd_fused,
                                    lstm_layer_fused_parts)
from eegflow.nn.pallas_lstm import lstm_fwd_fused_proj as pallas_fwd_proj
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, lstm_bwd, lstm_bwd_plain,
                                        lstm_fwd_train, lstm_fwd_train_plain)

# twin vs Pallas kernel: the same masked, bf16-rounded operands and float32
# sums in another order; a last-bit difference can flip the bf16 rounding of
# h at the next step and carries through the recurrence (as test_torch_lstm)
TWIN_TOL = 1e-4
# backward twin vs Pallas on the SAME planes: dz is computed the same way on
# both sides; the products sum in another order, and a last-bit difference in
# dz can flip its bf16 rounding, carried on through dh_carry. Relative to the
# largest entry of each gradient.
BWD_REL_TOL = 1e-4
# the whole layer through autograd vs jax.grad through both Pallas kernels:
# the forward differences above feed the planes of the backward
LAYER_REL_TOL = 1e-3
KEEP = 0.75
TILE = 8


def _weights(rng, din, hidden):
    bound = 1 / np.sqrt(hidden)
    u = lambda *s: rng.uniform(-bound, bound, s).astype(np.float32)  # noqa: E731
    return {"w_ih": u(din, 4 * hidden), "w_hh": u(hidden, 4 * hidden),
            "b": u(4 * hidden) + u(4 * hidden)}


def _inputs(seed, n_parts, batch=5, steps=8, d_part=16, hidden=32):
    rng = np.random.default_rng(seed)
    p = _weights(rng, d_part * n_parts, hidden)
    xs = tuple(rng.standard_normal((batch, steps, d_part)).astype(np.float32)
               for _ in range(n_parts))
    ms = tuple((rng.random((batch, steps, d_part)) < KEEP).astype(np.uint8)
               for _ in range(n_parts))
    return rng, p, xs, ms


def _pad(a):
    pad = (-a.shape[0]) % TILE
    return jnp.pad(jnp.asarray(a), ((0, pad),) + ((0, 0),) * (a.ndim - 1))


def _pallas_fwd(xs, ms, p, reverse):
    """Pallas training-mode forward on the batch padded to the tile, as the
    JAX package pads it -> (h, planes, h_bound) of the padded batch."""
    h, _, z, _, hb, _, _ = pallas_fwd_proj(
        tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
        jnp.asarray(p["w_hh"]), masks=tuple(_pad(m) for m in ms), keep=KEEP,
        batch_tile=TILE, t_chunk=4, need_residuals=True, interpret=True, reverse=reverse)
    return h, z, hb


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_fwd_train_twin_matches_pallas(n_parts, reverse):
    _, p, xs, ms = _inputs(30 + n_parts, n_parts)
    batch = xs[0].shape[0]
    h_want, z_want, _ = _pallas_fwd(xs, ms, p, reverse)
    assert z_want.shape[-1] == 6 * p["w_hh"].shape[0], "the default adjoint-plane contract"
    tp = _t(p)
    txs = tuple(torch.from_numpy(x) for x in xs)
    tms = tuple(torch.from_numpy(m) for m in ms)
    h, res = lstm_fwd_train_plain(txs, tp["w_ih"], tp["b"], tp["w_hh"], reverse, tms, KEEP)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want)[:batch], atol=TWIN_TOL, rtol=0)
    np.testing.assert_allclose(res.numpy(), np.asarray(z_want)[:batch], atol=TWIN_TOL, rtol=0)
    # on CPU tensors the wrapper runs the twin
    h2, res2 = lstm_fwd_train(txs, tp["w_ih"], tp["b"], tp["w_hh"], reverse, tms, KEEP)
    assert torch.equal(h2, h) and torch.equal(res2, res)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_twin_matches_pallas_on_the_same_planes(n_parts, reverse):
    rng, p, xs, ms = _inputs(40 + n_parts, n_parts)
    batch, steps, _ = xs[0].shape
    hidden = p["w_hh"].shape[0]
    h_pad, z_pad, hb = _pallas_fwd(xs, ms, p, reverse)
    g = (0.1 * rng.standard_normal((batch, steps, hidden))).astype(np.float32)
    add = (tuple(rng.standard_normal(x.shape).astype(np.float32) for x in xs)
           if reverse else None)
    dxs, dwih, dwhh, db = lstm_bwd_fused(
        z_pad, None, h_pad, hb, None, tuple(_pad(x) for x in xs), _pad(g),
        jnp.asarray(p["w_ih"]), jnp.asarray(p["w_hh"]), tuple(_pad(m) for m in ms), KEEP,
        dx_add=tuple(_pad(a) for a in add) if add else None, batch_tile=TILE, t_chunk=4,
        interpret=True, reverse=reverse)
    tp = _t(p)
    args = (torch.from_numpy(np.array(z_pad)[:batch]),
            torch.from_numpy(np.array(h_pad)[:batch]), torch.from_numpy(g),
            tuple(torch.from_numpy(x) for x in xs), tp["w_ih"], tp["w_hh"], reverse,
            tuple(torch.from_numpy(m) for m in ms), KEEP,
            tuple(torch.from_numpy(a) for a in add) if add else None)
    got = lstm_bwd_plain(*args)
    for a, b in zip(got[0], dxs):
        assert _rel(a.numpy(), np.asarray(b)[:batch]) < BWD_REL_TOL
    assert _rel(got[1].numpy(), dwih) < BWD_REL_TOL
    assert _rel(got[2].numpy(), dwhh) < BWD_REL_TOL
    assert _rel(got[3].numpy(), db) < BWD_REL_TOL
    # dropped inputs get exactly zero input gradient (before the sibling's dx)
    if add is None:
        for dx, m in zip(got[0], ms):
            assert (dx.numpy()[m == 0] == 0).all()
    # on CPU tensors the wrapper runs the twin
    wrapped = lstm_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(wrapped[0] + wrapped[1:], got[0] + got[1:]))


@pytest.mark.parametrize("n_parts", [1, 2])
def test_bilstm_layer_function_matches_jax_grad(n_parts):
    rng, pf, xs, ms = _inputs(50 + n_parts, n_parts)
    pb = _weights(rng, xs[0].shape[-1] * n_parts, pf["w_hh"].shape[0])

    def loss_jax(pf_, pb_, xs_):
        hf, hb = bilstm_layer_fused_parts(pf_, pb_, xs_, bf16=True,
                                          masks=tuple(jnp.asarray(m) for m in ms), keep=KEEP)
        return jnp.sum(jnp.tanh(hf)) + jnp.sum(jnp.cos(hb))

    jtree = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    want_loss, (gf, gb, gx) = jax.value_and_grad(loss_jax, argnums=(0, 1, 2))(
        jtree(pf), jtree(pb), tuple(jnp.asarray(x) for x in xs))

    layer = {"fwd": {k: v.requires_grad_() for k, v in _t(pf).items()},
             "bwd": {k: v.requires_grad_() for k, v in _t(pb).items()}}
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    hf, hb = bilstm_layer(layer, txs, tuple(torch.from_numpy(m) for m in ms), KEEP)
    loss = torch.tanh(hf).sum() + torch.cos(hb).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LAYER_REL_TOL * abs(float(want_loss))
    for direction, grads in (("fwd", gf), ("bwd", gb)):
        for k in ("w_ih", "w_hh", "b"):
            assert _rel(layer[direction][k].grad.numpy(), grads[k]) < LAYER_REL_TOL, (direction, k)
    for x, g in zip(txs, gx):
        assert _rel(x.grad.numpy(), g) < LAYER_REL_TOL


def test_unidirectional_layer_function_matches_jax_grad():
    """A unidirectional layer: one direction under the Function, no dx_add."""
    _, p, xs, ms = _inputs(55, 2)

    def loss_jax(p_, xs_):
        h = lstm_layer_fused_parts(p_["w_ih"], p_["w_hh"], p_["b"], xs_, False, True,
                                   tuple(jnp.asarray(m) for m in ms), KEEP)
        return jnp.sum(jnp.tanh(h))

    want_loss, (gp, gx) = jax.value_and_grad(loss_jax, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, tuple(jnp.asarray(x) for x in xs))
    layer = {"fwd": {k: v.requires_grad_() for k, v in _t(p).items()}}
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    (h,) = bilstm_layer(layer, txs, tuple(torch.from_numpy(m) for m in ms), KEEP)
    loss = torch.tanh(h).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LAYER_REL_TOL * abs(float(want_loss))
    for k in ("w_ih", "w_hh", "b"):
        assert _rel(layer["fwd"][k].grad.numpy(), gp[k]) < LAYER_REL_TOL, k
    for x, g in zip(txs, gx):
        assert _rel(x.grad.numpy(), g) < LAYER_REL_TOL
