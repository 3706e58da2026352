"""The port's float32-policy LSTM kernels against eegflow's Pallas kernels in
interpret mode: the recurrence twin (kernel 1) against
``lstm_recurrence_pallas`` with and without ``collect_cell`` (training mode,
which writes the pre-activations z over its gates), the backward twin
(kernel 5) from that z, h and c against ``lstm_recurrence_backward`` on the
gates, h and c, and the ``BiLSTMLayerF32`` autograd Function against
``jax.grad`` of
``bilstm_layer_fused_parts(..., bf16=False)`` and of a unidirectional
``lstm_layer_fused_parts``, with explicit keep-masks. Both directions; odd
batches. Inputs are made with numpy from a seed; tiny shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_lstm import (bilstm_layer_fused_parts, lstm_layer_fused_parts,
                                    lstm_recurrence_backward as jax_rec_bwd,
                                    lstm_recurrence_pallas)
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, lstm_rec_layer, lstm_recurrence,
                                        lstm_recurrence_backward,
                                        lstm_recurrence_backward_plain,
                                        lstm_recurrence_plain)
from torch_threads import one_torch_thread  # noqa: F401

# twin vs Pallas kernel, float32 throughout: the same operations, float32
# sums in another order (as tests/test_pallas_lstm.py holds its kernels)
FWD_TOL = 1e-5
# gradients, relative to each one's largest entry
GRAD_REL_TOL = 1e-4
KEEP = 0.75
TILE = 8


def _weights(rng, din, hidden):
    bound = 1 / np.sqrt(hidden)
    u = lambda *s: rng.uniform(-bound, bound, s).astype(np.float32)  # noqa: E731
    return {"w_ih": u(din, 4 * hidden), "w_hh": u(hidden, 4 * hidden),
            "b": u(4 * hidden) + u(4 * hidden)}


def _pad(a):
    pad = (-a.shape[0]) % TILE
    return jnp.pad(jnp.asarray(a), ((0, pad),) + ((0, 0),) * (a.ndim - 1))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _gates(seed, batch=5, steps=8, hidden=32):
    rng = np.random.default_rng(seed)
    gates = rng.standard_normal((batch, steps, 4 * hidden)).astype(np.float32)
    return rng, gates, _weights(rng, 8, hidden)["w_hh"]


@pytest.mark.parametrize("collect_cell", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_twin_matches_pallas(reverse, collect_cell):
    _, gates, w_hh = _gates(60 + reverse)
    batch = gates.shape[0]
    want = lstm_recurrence_pallas(_pad(gates), jnp.asarray(w_hh), batch_tile=TILE, t_chunk=4,
                                  interpret=True, collect_cell=collect_cell, reverse=reverse)
    # training mode writes z over its gates: each call gets its own copy
    args = lambda: (torch.from_numpy(gates.copy()), torch.from_numpy(w_hh), reverse,  # noqa
                    collect_cell)
    got = lstm_recurrence_plain(*args())
    if collect_cell:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b)[:batch], atol=FWD_TOL, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:batch], atol=FWD_TOL, rtol=0)
    # on CPU tensors the wrapper runs the twin
    wrapped = lstm_recurrence(*args())
    if collect_cell:
        assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    else:
        assert torch.equal(wrapped, got)


@pytest.mark.parametrize("reverse", [False, True])
def test_preactivations_match_pallas_state(reverse):
    """The pre-activations z = gates + h_prev . W_hh that kernel 1's training
    mode writes over its gates and kernel 5 reads (on the CPU the twin's, by
    the wrapper as by the twin) agree with the Pallas kernel's h and c:
    c[t] = f c[t-1] + i g from the tanh-form gates of z."""
    _, gates, w_hh = _gates(65 + reverse)
    batch = gates.shape[0]
    h_j, c_j = lstm_recurrence_pallas(_pad(gates), jnp.asarray(w_hh), batch_tile=TILE,
                                      t_chunk=4, interpret=True, collect_cell=True,
                                      reverse=reverse)
    h_j, c_j = np.asarray(h_j)[:batch], np.asarray(c_j)[:batch]
    z_fwd, z_twin = torch.from_numpy(gates.copy()), torch.from_numpy(gates.copy())
    lstm_recurrence(z_fwd, torch.from_numpy(w_hh), reverse, True)
    lstm_recurrence_plain(z_twin, torch.from_numpy(w_hh), reverse, True)
    assert torch.equal(z_fwd, z_twin) and not np.array_equal(z_fwd.numpy(), gates)
    h_prev, c_prev = np.zeros_like(h_j), np.zeros_like(c_j)
    if reverse:
        h_prev[:, :-1], c_prev[:, :-1] = h_j[:, 1:], c_j[:, 1:]
    else:
        h_prev[:, 1:], c_prev[:, 1:] = h_j[:, :-1], c_j[:, :-1]
    np.testing.assert_allclose(z_fwd.numpy(), gates + h_prev @ w_hh, atol=FWD_TOL, rtol=0)
    sig = lambda v: 0.5 * np.tanh(0.5 * v) + 0.5  # noqa: E731
    i, f, g, _ = np.split(z_fwd.numpy(), 4, axis=-1)
    np.testing.assert_allclose(sig(f) * c_prev + sig(i) * np.tanh(g), c_j, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_backward_twin_matches_pallas_on_the_same_sequences(reverse):
    """Kernel 5's twin takes the z the forward wrote over its gates; the
    Pallas kernel recomputes it from the gates, h and c."""
    rng, gates, w_hh = _gates(70 + reverse)
    batch = gates.shape[0]
    z = torch.from_numpy(gates.copy())
    h, c = lstm_recurrence_plain(z, torch.from_numpy(w_hh), reverse, collect_cell=True)
    g = (0.1 * rng.standard_normal(h.shape)).astype(np.float32)
    want_dg, want_dw = jax_rec_bwd(_pad(gates), _pad(h.numpy()), _pad(c.numpy()),
                                   jnp.asarray(w_hh), _pad(g), batch_tile=TILE, t_chunk=4,
                                   interpret=True, reverse=reverse)
    args = (z, h, c, torch.from_numpy(w_hh), torch.from_numpy(g), reverse)
    dgates, dw_hh = lstm_recurrence_backward_plain(*args)
    assert _rel(dgates.numpy(), np.asarray(want_dg)[:batch]) < GRAD_REL_TOL
    assert _rel(dw_hh.numpy(), want_dw) < GRAD_REL_TOL
    wrapped = lstm_recurrence_backward(*args)
    assert torch.equal(wrapped[0], dgates) and torch.equal(wrapped[1], dw_hh)


def _layer_case(seed, n_parts, batch=5, steps=8, d_part=16, hidden=32):
    rng = np.random.default_rng(seed)
    pf = _weights(rng, d_part * n_parts, hidden)
    pb = _weights(rng, d_part * n_parts, hidden)
    xs = tuple(rng.standard_normal((batch, steps, d_part)).astype(np.float32)
               for _ in range(n_parts))
    ms = tuple((rng.random((batch, steps, d_part)) < KEEP).astype(np.uint8)
               for _ in range(n_parts))
    return pf, pb, xs, ms


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _ttree(tree):
    return {k: torch.from_numpy(v).requires_grad_() for k, v in tree.items()}


@pytest.mark.parametrize("n_parts", [1, 2])
def test_bilstm_f32_function_matches_jax_grad(n_parts):
    pf, pb, xs, ms = _layer_case(80 + n_parts, n_parts)

    def loss_jax(pf_, pb_, xs_):
        hf, hb = bilstm_layer_fused_parts(pf_, pb_, xs_, bf16=False,
                                          masks=tuple(jnp.asarray(m) for m in ms), keep=KEEP)
        return jnp.sum(jnp.tanh(hf)) + jnp.sum(jnp.cos(hb))

    want_loss, (gf, gb, gx) = jax.value_and_grad(loss_jax, argnums=(0, 1, 2))(
        _jtree(pf), _jtree(pb), tuple(jnp.asarray(x) for x in xs))
    layer = {"fwd": _ttree(pf), "bwd": _ttree(pb)}
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    hf, hb = bilstm_layer(layer, txs, tuple(torch.from_numpy(m) for m in ms), KEEP,
                          bf16=False)
    loss = torch.tanh(hf).sum() + torch.cos(hb).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < GRAD_REL_TOL * abs(float(want_loss))
    for direction, grads in (("fwd", gf), ("bwd", gb)):
        for k in ("w_ih", "w_hh", "b"):
            assert _rel(layer[direction][k].grad.numpy(), grads[k]) < GRAD_REL_TOL, (direction, k)
    for x, g, m in zip(txs, gx, ms):
        assert _rel(x.grad.numpy(), g) < GRAD_REL_TOL
        assert (x.grad.numpy()[m == 0] == 0).all()  # dropped inputs get no gradient
    # eval mode (no residuals) gives the Function's outputs
    with torch.no_grad():
        for direction, h, reverse in (("fwd", hf, False), ("bwd", hb, True)):
            p = layer[direction]
            xe = tuple(torch.where(torch.from_numpy(m) != 0, x / KEEP, 0.0)
                       for x, m in zip(txs, ms))
            assert torch.allclose(lstm_rec_layer(xe, p["w_ih"], p["b"], p["w_hh"], reverse), h,
                                  atol=FWD_TOL, rtol=0)


def test_unidirectional_f32_function_matches_jax_grad():
    pf, _, xs, ms = _layer_case(85, 2)

    def loss_jax(p_, xs_):
        h = lstm_layer_fused_parts(p_["w_ih"], p_["w_hh"], p_["b"], xs_, False, False,
                                   tuple(jnp.asarray(m) for m in ms), KEEP)
        return jnp.sum(jnp.tanh(h))

    want_loss, (gp, gx) = jax.value_and_grad(loss_jax, argnums=(0, 1))(
        _jtree(pf), tuple(jnp.asarray(x) for x in xs))
    layer = {"fwd": _ttree(pf)}
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    (h,) = bilstm_layer(layer, txs, tuple(torch.from_numpy(m) for m in ms), KEEP, bf16=False)
    loss = torch.tanh(h).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < GRAD_REL_TOL * abs(float(want_loss))
    for k in ("w_ih", "w_hh", "b"):
        assert _rel(layer["fwd"][k].grad.numpy(), gp[k]) < GRAD_REL_TOL, k
    for x, g in zip(txs, gx):
        assert _rel(x.grad.numpy(), g) < GRAD_REL_TOL
