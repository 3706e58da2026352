"""eegflow_torch LSTM against eegflow: the eager float32 stack against the
``lax.scan`` stack, and the ``lstm_fwd`` kernel's plain twin against the
Pallas ``_fwd_proj_kernel`` (``lstm_fwd_fused_proj``, eval mode) run in
interpret mode. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn import lstm as jlstm
from eegflow.nn.pallas_lstm import lstm_fwd_fused_proj as pallas_fwd_proj
from eegflow_torch.nn import lstm as tlstm
from eegflow_torch.nn.cuda_lstm import lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain
from torch_threads import one_torch_thread  # noqa: F401

# eager float32 stack vs the scan: same algorithm, float32 summation order
# differs through two layers of 16 steps
STACK_TOL = 1e-5
# twin vs Pallas kernel: both round the same operands to bf16 and sum the
# products in float32, in another order; a last-bit difference can flip the
# bf16 rounding of h at the next step and carries through the recurrence
TWIN_TOL = 1e-4


def _layers(rng, din, hidden, n_layers, bidirectional):
    bound = 1 / np.sqrt(hidden)
    u = lambda *s: rng.uniform(-bound, bound, s).astype(np.float32)  # noqa: E731
    layers, d = [], din
    for _ in range(n_layers):
        layer = {"fwd": {"w_ih": u(d, 4 * hidden), "w_hh": u(hidden, 4 * hidden),
                         "b": u(4 * hidden) + u(4 * hidden)}}
        if bidirectional:
            layer["bwd"] = {"w_ih": u(d, 4 * hidden), "w_hh": u(hidden, 4 * hidden),
                            "b": u(4 * hidden) + u(4 * hidden)}
        layers.append(layer)
        d = hidden * (2 if bidirectional else 1)
    return layers


def _tree(layers, fn):
    return [{k: {n: fn(v) for n, v in p.items()} for k, p in layer.items()}
            for layer in layers]


@pytest.mark.parametrize("bidirectional", [True, False])
def test_eager_stack_matches_scan_f32(bidirectional):
    rng = np.random.default_rng(0)
    layers = _layers(rng, 6, 16, 2, bidirectional)
    x = rng.standard_normal((3, 16, 6)).astype(np.float32)
    want = jlstm.bilstm_stack_apply(_tree(layers, jnp.asarray), jnp.asarray(x), impl="scan")
    got = tlstm.bilstm_stack_apply(_tree(layers, torch.from_numpy), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=STACK_TOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_eager_layer_bf16_policy_matches_scan(reverse):
    rng = np.random.default_rng(1)
    p = _layers(rng, 8, 16, 1, False)[0]["fwd"]
    x = rng.standard_normal((4, 12, 8)).astype(np.float32)
    want = jlstm.lstm_layer_apply({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), reverse, jnp.bfloat16)
    got = tlstm.lstm_layer_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x), reverse, torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TWIN_TOL, rtol=0)


def _pallas_h(xs, p, reverse, tile=8):
    """Pallas forward in eval mode, the batch padded to a multiple of ``tile``
    as the JAX package pads it."""
    b = xs[0].shape[0]
    pad = (-b) % tile
    xs_pad = tuple(jnp.pad(jnp.asarray(x), ((0, pad), (0, 0), (0, 0))) for x in xs)
    out = pallas_fwd_proj(xs_pad, jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
                          jnp.asarray(p["w_hh"]), batch_tile=tile, t_chunk=4,
                          need_residuals=False, interpret=True, reverse=reverse)
    return np.asarray(out[0])[:b]


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch", [8, 5])
def test_lstm_fwd_twin_matches_pallas(n_parts, reverse, batch):
    rng = np.random.default_rng(10 + n_parts)
    d_part, hidden, steps = 16, 32, 24
    p = _layers(rng, d_part * n_parts, hidden, 1, False)[0]["fwd"]
    xs = tuple(rng.standard_normal((batch, steps, d_part)).astype(np.float32)
               for _ in range(n_parts))
    want = _pallas_h(xs, p, reverse)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    txs = tuple(torch.from_numpy(x) for x in xs)
    got = lstm_fwd_fused_proj_plain(txs, tp["w_ih"], tp["b"], tp["w_hh"], reverse)
    assert got.shape == (batch, steps, hidden)
    np.testing.assert_allclose(got.numpy(), want, atol=TWIN_TOL, rtol=0)
    # on CPU tensors the wrapper runs the twin
    wrapped = lstm_fwd_fused_proj(txs, tp["w_ih"], tp["b"], tp["w_hh"], reverse)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_lstm_fwd_reverse_is_time_flip():
    """The reverse direction equals the forward direction on flipped time,
    flipped back (the kernel walks t backwards instead of flipping)."""
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(v) for k, v in _layers(rng, 8, 16, 1, False)[0]["fwd"].items()}
    x = torch.from_numpy(rng.standard_normal((3, 10, 8)).astype(np.float32))
    rev = lstm_fwd_fused_proj_plain((x,), p["w_ih"], p["b"], p["w_hh"], True)
    fwd_flipped = lstm_fwd_fused_proj_plain((x.flip(1),), p["w_ih"], p["b"], p["w_hh"], False)
    torch.testing.assert_close(rev, fwd_flipped.flip(1), rtol=0, atol=0)
