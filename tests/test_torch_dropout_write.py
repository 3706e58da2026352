"""The port's mask path against the reference's dropped-copy write
(``EEGFLOW_FWD_DROPW=2``) on eegflow's Pallas kernels in interpret mode.

Under that flag a producing kernel writes the dropped copy ``where(m, h *
(1/keep), 0)`` of its output and the consumer recovers the mask from its
zeros (``mask_from_x``). It draws the same masks as the explicit-mask path
and computes the same function, so the port's counterpart is its mask path
(explicit uint8 masks applied by the consumer): kernel 2's dropped copy is
the twin's h with the mask applied, kernel 9's is its y with the mask
applied, ``lstm_bwd_fused(mask_from_x=True)`` is the twins of kernels 3 and
3b with the masks, and the classifier and a train step under the three
backward schedules match the reference's.

The flags are set and restored by ``reference_flags`` of
``test_torch_lstm_bwd_v2``. Inputs are made with numpy from a seed; tiny
shapes, no exact zeros among the kept values (``mask_from_x`` would read
them as dropped)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_input import input_block_fused as jax_input_block
from eegflow.nn.pallas_lstm import lstm_bwd_fused
from eegflow.nn.pallas_lstm import lstm_fwd_fused_proj as pallas_fwd_proj
from eegflow_torch.nn.cuda_input import input_block_fused_plain
from eegflow_torch.nn.cuda_lstm import (apply_mask, lstm_bwd_plain, lstm_bwd_v2_plain,
                                        lstm_fwd_train_gates_plain, lstm_fwd_train_plain)
from test_torch_lstm_bwd_v2 import (BWD_REL_TOL, KEEP, SMALL, TILE, TWIN_TOL, TWO_PASS, _inputs,
                                    _pad, _rel, _t, classifier_matches_reference,
                                    reference_flags, train_step_matches_reference)
from torch_threads import one_torch_thread  # noqa: F401

# the output mask's keep (the stack's inter-layer rate d = 0.3, as ModelConfig)
OUT_KEEP = 0.7
# the reference's dropped-copy schedule: the fused input block, no explicit
# input masks (EEGFLOW_MASK_DROPOUT unset), the producing kernels writing
# the dropped copies from uint8 masks
DROPW = {"EEGFLOW_FWD_DROPW": "2", "EEGFLOW_FUSED_INPUT": "1", "EEGFLOW_MASK_DROPOUT": None}
SCHEDULE_FLAGS = {"fused": DROPW, "two_pass": dict(DROPW, **TWO_PASS),
                  "dualdir": dict(DROPW, EEGFLOW_BWD_DUALDIR="1")}
# kernel 9's twin against Pallas: as test_torch_input_block
INPUT_TOL = 2e-6


def _out_mask(rng, batch, steps, hidden):
    return (rng.random((batch, steps, hidden)) < OUT_KEEP).astype(np.uint8)


def _dropped(xs, ms, keep):
    """The parts as a producing kernel leaves them: where(m, x * (1/keep), 0)."""
    inv = np.float32(1.0 / keep)
    return tuple(np.where(m != 0, x * inv, np.float32(0)).astype(np.float32)
                 for x, m in zip(xs, ms))


@pytest.mark.parametrize("contract", ["planes", "gates"])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_fwd_dropped_copy_twin_matches_pallas(contract, n_parts, reverse):
    """The Pallas forward with ``out_mask`` against kernel 2's twin: h and
    the residuals as the twin's, and the dropped copy as the twin's h with
    the mask applied (what the next layer reads on the mask path)."""
    rng, p, xs, ms = _inputs(110 + n_parts, n_parts)
    batch, steps, _ = xs[0].shape
    hidden = p["w_hh"].shape[0]
    om = _out_mask(rng, batch, steps, hidden)
    with reference_flags(TWO_PASS if contract == "gates" else {}):
        h, c, z, _, _, _, hd = pallas_fwd_proj(
            tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
            jnp.asarray(p["w_hh"]), masks=tuple(_pad(m) for m in ms), keep=KEEP,
            out_keep=OUT_KEEP, out_mask=_pad(om), batch_tile=TILE, t_chunk=4,
            need_residuals=True, interpret=True, reverse=reverse)
    tp = _t(p)
    args = (tuple(torch.from_numpy(x) for x in xs), tp["w_ih"], tp["b"], tp["w_hh"], reverse,
            tuple(torch.from_numpy(m) for m in ms), KEEP)
    if contract == "gates":
        got, want = lstm_fwd_train_gates_plain(*args), (h, z, c)
    else:
        got, want = lstm_fwd_train_plain(*args), (h, z)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:batch], atol=TWIN_TOL, rtol=0)
    copy = apply_mask(got[0], torch.from_numpy(om), OUT_KEEP)
    np.testing.assert_allclose(copy.numpy(), np.asarray(hd)[:batch], atol=TWIN_TOL, rtol=0)
    assert (np.asarray(hd)[:batch][om == 0] == 0).all()


@pytest.mark.parametrize("bf16", [False, True])
def test_input_block_dropped_copy_twin_matches_pallas(bf16):
    """The Pallas input block with ``out_mask`` writes the dropped copy in
    y's place: kernel 9's twin's y with the mask applied."""
    rng = np.random.default_rng(120 + bf16)
    channels, hidden = 61, 32
    bound = 1 / np.sqrt(channels)
    proj = {"w": rng.uniform(-bound, bound, (channels, hidden)).astype(np.float32),
            "b": rng.uniform(-bound, bound, hidden).astype(np.float32)}
    norm = {"scale": (1 + 0.1 * rng.standard_normal(hidden)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(hidden)).astype(np.float32)}
    x = rng.standard_normal((3, 8, channels)).astype(np.float32)
    om = _out_mask(rng, 3, 8, hidden)
    want = np.asarray(jax_input_block({k: jnp.asarray(v) for k, v in proj.items()},
                                      {k: jnp.asarray(v) for k, v in norm.items()},
                                      jnp.asarray(x), bf16=bf16, out_keep=OUT_KEEP,
                                      out_mask=jnp.asarray(om)))
    y = input_block_fused_plain(_t(proj), _t(norm), torch.from_numpy(x), bf16)
    got = apply_mask(y, torch.from_numpy(om), OUT_KEEP)
    np.testing.assert_allclose(got.numpy(), want, atol=INPUT_TOL, rtol=0)
    assert (want[om == 0] == 0).all()


@pytest.mark.parametrize("kernel", ["3", "3b"])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_mask_from_x_twins_match_pallas(kernel, n_parts, reverse):
    """``lstm_bwd_fused(mask_from_x=True)`` on the dropped parts against the
    twins of kernels 3 and 3b on the undropped parts with their masks, on
    the same residuals (the reverse direction with the sibling's dx added)."""
    rng, p, xs, ms = _inputs(130 + n_parts + 2 * reverse, n_parts)
    xd = _dropped(xs, ms, KEEP)
    batch, steps, _ = xs[0].shape
    hidden = p["w_hh"].shape[0]
    g = (0.1 * rng.standard_normal((batch, steps, hidden))).astype(np.float32)
    add = (tuple(rng.standard_normal(x.shape).astype(np.float32) for x in xs)
           if reverse else None)
    with reference_flags(TWO_PASS if kernel == "3b" else {}):
        h, c, z, _, hb, cb, _ = pallas_fwd_proj(
            tuple(_pad(x) for x in xd), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
            jnp.asarray(p["w_hh"]), batch_tile=TILE, t_chunk=4, need_residuals=True,
            interpret=True, reverse=reverse)
        dxs, dwih, dwhh, db = lstm_bwd_fused(
            z, c, h, hb, cb, tuple(_pad(x) for x in xd), _pad(g), jnp.asarray(p["w_ih"]),
            jnp.asarray(p["w_hh"]), None, KEEP,
            dx_add=tuple(_pad(a) for a in add) if add else None, mask_from_x=True,
            batch_tile=TILE, t_chunk=4, interpret=True, reverse=reverse)
    cut = lambda a: torch.from_numpy(np.array(a)[:batch])  # noqa: E731
    tp = _t(p)
    rest = (cut(h), torch.from_numpy(g), tuple(torch.from_numpy(x) for x in xs), tp["w_ih"],
            tp["w_hh"], reverse, tuple(torch.from_numpy(m) for m in ms), KEEP,
            tuple(torch.from_numpy(a) for a in add) if add else None)
    if kernel == "3b":
        got = lstm_bwd_v2_plain(cut(z), cut(c), *rest)
    else:
        got = lstm_bwd_plain(cut(z), *rest)
    for a, b in zip(got[0], dxs):
        assert _rel(a.numpy(), np.asarray(b)[:batch]) < BWD_REL_TOL
    for a, b in zip(got[1:], (dwih, dwhh, db)):
        assert _rel(a.numpy(), b) < BWD_REL_TOL
    if add is None:  # a dropped position gets exactly zero input gradient on both sides
        for dx, b, m in zip(got[0], dxs, ms):
            assert (dx.numpy()[m == 0] == 0).all()
            assert (np.asarray(b)[:batch][m == 0] == 0).all()


@pytest.mark.parametrize("lstm_bwd,kw", [("fused", SMALL), ("two_pass", SMALL),
                                         ("dualdir", SMALL),
                                         ("fused", dict(SMALL, bidirectional=False))],
                         ids=["fused", "two_pass", "dualdir", "fused-unidirectional"])
def test_classifier_dropout_write_matches_the_reference_schedule(lstm_bwd, kw):
    """The port's classifier (masks, or select dropout under ``"dualdir"``)
    against the reference's under ``EEGFLOW_FWD_DROPW=2``."""
    with reference_flags(SCHEDULE_FLAGS[lstm_bwd]):
        classifier_matches_reference(lstm_bwd, kw, seeds=(12, 14, 36))


@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass", "dualdir"])
def test_train_step_dropout_write_matches_the_reference_step(lstm_bwd):
    """With dropout (the reference's masks from its step's key) under
    ``EEGFLOW_FWD_DROPW=2``: the loss and the params after one AdamW
    update."""
    with reference_flags(SCHEDULE_FLAGS[lstm_bwd]):
        params, jp = train_step_matches_reference(lstm_bwd, dropout=0.3)
    assert not np.array_equal(params["head3"]["w"].detach().numpy(), np.asarray(jp["head3"]["w"]))
