"""The reference's one-pass raw-gate backward (``EEGFLOW_ADJOINT_RES=0`` with
``EEGFLOW_BWD_V2`` unset: ``_bwd_fused_kernel``'s raw-gate branch), with and
without ``EEGFLOW_BWD_TC=1`` (its forward streams tanh(c) to the backward),
held to the port's ``"two_pass"`` schedule, whose kernel 3b computes the
same function: ``lstm_bwd_fused`` in interpret mode with explicit uint8
masks against ``lstm_bwd_v2_plain`` on the same gates and c, and one train
step of ``"two_pass"`` against the reference's step under
``EEGFLOW_ADJOINT_RES=0 EEGFLOW_MASK_DROPOUT=1``.

The flags are set and restored by ``reference_flags`` of
``test_torch_lstm_bwd_v2``. Inputs are made with numpy from a seed; tiny
shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_lstm import lstm_bwd_fused
from eegflow.nn.pallas_lstm import lstm_fwd_fused_proj as pallas_fwd_proj
from eegflow_torch.nn.cuda_lstm import lstm_bwd_v2_plain, lstm_fwd_train_gates_plain
from test_torch_lstm_bwd_v2 import (BWD_REL_TOL, KEEP, TILE, TWIN_TOL, _inputs, _pad, _rel, _t,
                                    reference_flags, train_step_matches_reference)
from torch_threads import one_torch_thread  # noqa: F401

# the reference's one-pass raw-gate backward with explicit masks: kernel
# 3's entry on the raw gates, BWD_V2 unset
ONE_PASS = {"EEGFLOW_ADJOINT_RES": "0", "EEGFLOW_BWD_V2": None, "EEGFLOW_BWD_DUALDIR": None,
            "EEGFLOW_RES_BF16": None, "EEGFLOW_MASK_DROPOUT": "1"}
TC = {"EEGFLOW_BWD_TC": "1"}
NO_TC = {"EEGFLOW_BWD_TC": None}

# the twin against the reference's kernel on the same gates and c, relative
# to each gradient's largest entry: BWD_REL_TOL, as kernel 3b's twin against
# its BWD_V2=1 kernel. Both sides compute dz alike; dh_carry's products sum
# in another order, and a last-bit difference can flip a later dz's bf16
# rounding. Over seeds 331-370 (160 cases of this test) the sound twin read
# 7.8e-8 to 5.9e-4, median 1.7e-7, above 1e-4 in 10 cases (seeds 331 and
# 332 read 8.9e-8 to 2.5e-7); copies of it with a precision fault read at
# least 4.5e-4 (db summing bf16(dz)), 6.2e-4 (dh_carry from float32 dz),
# 8.5e-4 (float32 W_hh) and 2.4e-3 (dc rounded to bf16), with a wrong term
# 0.10 (c for c_prev) and 0.15 (the carry dropped at the ends)
RAW_REL_TOL = BWD_REL_TOL


@pytest.mark.parametrize("bwd_tc", [False, True], ids=["recompute", "bwd_tc"])
@pytest.mark.parametrize("n_parts,reverse", [(1, False), (2, True)])
def test_one_pass_raw_gate_backward_is_kernel_3bs_function(n_parts, reverse, bwd_tc):
    """``lstm_bwd_fused`` under ``ADJOINT_RES=0`` (BWD_V2 unset) on the Pallas
    forward's raw gates, c and masks (and, with BWD_TC=1, its tanh(c)),
    the reverse direction adding a sibling's dx, against kernel 3b's twin on
    the same gates and c; the forward's gates and c against the raw-gate
    forward twin's, and its streamed tanh(c) against tanh of its c."""
    rng, p, xs, ms = _inputs(330 + n_parts, n_parts)
    batch, steps, _ = xs[0].shape
    hidden = p["w_hh"].shape[0]
    g = (0.1 * rng.standard_normal((batch, steps, hidden))).astype(np.float32)
    add = (tuple(rng.standard_normal(x.shape).astype(np.float32) for x in xs)
           if reverse else None)
    pad_ms = tuple(_pad(m) for m in ms)
    with reference_flags(dict(ONE_PASS, **(TC if bwd_tc else NO_TC))):
        h, c, z, tc, hb, cb, _ = pallas_fwd_proj(
            tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
            jnp.asarray(p["w_hh"]), masks=pad_ms, keep=KEEP, batch_tile=TILE, t_chunk=4,
            need_residuals=True, interpret=True, reverse=reverse)
        assert z.shape[-1] == 4 * hidden and (tc is not None) == bwd_tc
        dxs, dwih, dwhh, db = lstm_bwd_fused(
            z, c, h, hb, cb, tuple(_pad(x) for x in xs), _pad(g), jnp.asarray(p["w_ih"]),
            jnp.asarray(p["w_hh"]), pad_ms, KEEP,
            dx_add=tuple(_pad(a) for a in add) if add else None, tc_seq=tc, batch_tile=TILE,
            t_chunk=4, interpret=True, reverse=reverse)
    cut = lambda a: torch.from_numpy(np.array(a)[:batch])  # noqa: E731
    tp = _t(p)
    txs = tuple(torch.from_numpy(x) for x in xs)
    tms = tuple(torch.from_numpy(m) for m in ms)
    # the residuals the port's raw-gate forward writes for the same inputs
    h_t, gates_t, c_t = lstm_fwd_train_gates_plain(txs, tp["w_ih"], tp["b"], tp["w_hh"], reverse,
                                                   tms, KEEP)
    for got, want in ((h_t, h), (gates_t, z), (c_t, c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:batch], atol=TWIN_TOL, rtol=0)
    if bwd_tc:
        np.testing.assert_allclose(np.asarray(tc)[:batch], np.tanh(np.asarray(c)[:batch]),
                                   atol=1e-6, rtol=0)
    got = lstm_bwd_v2_plain(cut(z), cut(c), cut(h), torch.from_numpy(g), txs, tp["w_ih"],
                            tp["w_hh"], reverse, tms, KEEP,
                            tuple(torch.from_numpy(a) for a in add) if add else None)
    for a, b in zip(got[0], dxs):
        assert _rel(a.numpy(), np.asarray(b)[:batch]) < RAW_REL_TOL
    for a, b in zip(got[1:], (dwih, dwhh, db)):
        assert _rel(a.numpy(), b) < RAW_REL_TOL
    if add is None:  # dropped inputs get exactly zero input gradient
        for dx, m in zip(got[0], ms):
            assert (dx.numpy()[m == 0] == 0).all()


@pytest.mark.parametrize("bwd_tc", [False, True], ids=["recompute", "bwd_tc"])
def test_train_step_two_pass_matches_the_one_pass_reference_step(bwd_tc):
    """One ``"two_pass"`` step with dropout masks against the reference's
    step under ``ADJOINT_RES=0 MASK_DROPOUT=1`` with BWD_V2 unset: its
    raw-gate forwards and one-pass raw-gate backwards with the explicit
    masks, with or without the streamed tanh(c)."""
    flags = dict(ONE_PASS, EEGFLOW_FUSED_INPUT="1", **(TC if bwd_tc else NO_TC))
    with reference_flags(flags):
        params, jp = train_step_matches_reference("two_pass", dropout=0.3)
    assert not np.array_equal(params["head3"]["w"].detach().numpy(), np.asarray(jp["head3"]["w"]))
