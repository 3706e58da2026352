"""The ``res_bf16`` option (the reference's ``EEGFLOW_RES_BF16=1``) against
eegflow's Pallas kernels in interpret mode: kernel 2's twin storing its
planes or raw gates in bf16 against ``lstm_fwd_fused_proj``'s bf16 residual,
the twins of kernels 3, 3b and 4 on those bf16 residuals against
``lstm_bwd_fused`` and ``lstm_bwd_dualdir``, the classifier and a train step
against the reference's schedule under the three backward schedules (and
under ``EEGFLOW_FWD_DROPW=2`` too, whose counterpart is the port's mask
path), the bf16-residual step against the float32-residual one, and the
float32 policy's refusal.

The flags are set and restored by ``reference_flags`` of
``test_torch_lstm_bwd_v2``. Inputs are made with numpy from a seed; tiny
shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_lstm import lstm_bwd_dualdir as pallas_bwd_dualdir
from eegflow.nn.pallas_lstm import lstm_bwd_fused
from eegflow.nn.pallas_lstm import lstm_fwd_fused_proj as pallas_fwd_proj
from eegflow_torch.core import config as tcfg
from eegflow_torch.nn import losses as tlosses
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, lstm_bwd, lstm_bwd_dualdir,
                                        lstm_bwd_dualdir_plain, lstm_bwd_plain, lstm_bwd_v2,
                                        lstm_bwd_v2_plain, lstm_fwd_train,
                                        lstm_fwd_train_gates, lstm_fwd_train_gates_plain,
                                        lstm_fwd_train_plain)
from eegflow_torch.nn.model import classifier_apply, classifier_init, draw_dropout_masks
from eegflow_torch.train.steps import make_optimizer, make_train_step
from test_torch_dropout_write import DROPW
from test_torch_lstm_bwd_v2 import (BWD_REL_TOL, KEEP, SMALL, TILE, TWIN_TOL, TWO_PASS,
                                    _inputs, _pad, _rel, _t, _weights,
                                    classifier_matches_reference, reference_flags,
                                    train_step_matches_reference)
from torch_threads import one_torch_thread  # noqa: F401

RES16 = {"EEGFLOW_RES_BF16": "1", "EEGFLOW_FUSED_INPUT": "1"}
# the reference's schedules of the port's classifier with bf16 residuals:
# explicit uint8 masks under "fused" and "two_pass", select dropout under
# "dualdir" (EEGFLOW_FWD_DROPW unset, its CPU-inert default)
SCHEDULE_FLAGS = {"fused": dict(RES16, EEGFLOW_MASK_DROPOUT="1"),
                  "two_pass": dict(RES16, EEGFLOW_MASK_DROPOUT="1", **TWO_PASS),
                  "dualdir": dict(RES16, EEGFLOW_BWD_DUALDIR="1", EEGFLOW_MASK_DROPOUT=None,
                                  EEGFLOW_FWD_DROPW=None)}
# a bf16 residual of the twin against Pallas's: both round float32 values
# that agree within TWIN_TOL to bf16, and a value within that of a rounding
# boundary rounds the other way, by one bf16 ulp: 8 significant bits, so up
# to 2^-7 of the value (measured: one entry in 7,680 at 2^-9 off 0.34)
RES16_RTOL = 2.0 ** -7
# the bf16-residual step against the float32-residual step on the twins,
# each gradient relative to its largest entry: the residuals (gates in
# [-1, 1]) carry bf16's rounding (2^-9 relative, up to 2^-8), the
# reference's ~0.4 % error in the gate derivatives, into dz and through the
# adjoint's carries (measured 5.2e-3 "fused" and "dualdir", 6.2e-3
# "two_pass" at SMALL's widths); the forward, and so the loss, does not read
# them
RES16_STEP_REL_TOL = 2e-2


def _bf16_from_jax(a):
    """A JAX bf16 array as a torch bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("contract", ["planes", "gates"])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_fwd_res16_twin_matches_pallas(contract, n_parts, reverse):
    """Kernel 2's twin with ``res_bf16``: h (and c) against the Pallas
    forward's, the bf16 residual against its bf16 residual, and the residual
    equal to the float32 twin's rounded to nearest even, bit for bit."""
    _, p, xs, ms = _inputs(150 + n_parts, n_parts)
    batch = xs[0].shape[0]
    flags = dict(RES16, **TWO_PASS) if contract == "gates" else RES16
    with reference_flags(flags):
        h, c, z, _, _, _, _ = pallas_fwd_proj(
            tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
            jnp.asarray(p["w_hh"]), masks=tuple(_pad(m) for m in ms), keep=KEEP,
            batch_tile=TILE, t_chunk=4, need_residuals=True, interpret=True, reverse=reverse)
    assert z.dtype == jnp.bfloat16
    tp = _t(p)
    args = (tuple(torch.from_numpy(x) for x in xs), tp["w_ih"], tp["b"], tp["w_hh"], reverse,
            tuple(torch.from_numpy(m) for m in ms), KEEP)
    twin = lstm_fwd_train_gates_plain if contract == "gates" else lstm_fwd_train_plain
    wrapper = lstm_fwd_train_gates if contract == "gates" else lstm_fwd_train
    got = twin(*args, res_bf16=True)
    assert got[1].dtype == torch.bfloat16 and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(h)[:batch], atol=TWIN_TOL, rtol=0)
    if contract == "gates":
        assert got[2].dtype == torch.float32  # c stays float32
        np.testing.assert_allclose(got[2].numpy(), np.asarray(c)[:batch], atol=TWIN_TOL, rtol=0)
    np.testing.assert_allclose(got[1].float().numpy(),
                               np.asarray(z, np.float32)[:batch], atol=TWIN_TOL,
                               rtol=RES16_RTOL)
    f32 = twin(*args)
    assert torch.equal(got[1], f32[1].to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(got[:1] + got[2:], f32[:1] + f32[2:]))
    # on CPU tensors the wrapper runs the twin
    assert all(torch.equal(a, b) for a, b in zip(wrapper(*args, res_bf16=True), got))


@pytest.mark.parametrize("kernel", ["3", "3b"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_bwd_res16_twins_match_pallas_on_the_same_residuals(kernel, n_parts):
    """The twins of kernels 3 and 3b on the Pallas forward's bf16 residuals
    against ``lstm_bwd_fused`` on them (the reverse direction, the sibling's
    dx added, the masks of the forward)."""
    rng, p, xs, ms = _inputs(160 + n_parts, n_parts)
    batch, steps, _ = xs[0].shape
    hidden = p["w_hh"].shape[0]
    g = (0.1 * rng.standard_normal((batch, steps, hidden))).astype(np.float32)
    add = tuple(rng.standard_normal(x.shape).astype(np.float32) for x in xs)
    pad_ms = tuple(_pad(m) for m in ms)
    with reference_flags(dict(RES16, **TWO_PASS) if kernel == "3b" else RES16):
        h, c, z, _, hb, cb, _ = pallas_fwd_proj(
            tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
            jnp.asarray(p["w_hh"]), masks=pad_ms, keep=KEEP, batch_tile=TILE, t_chunk=4,
            need_residuals=True, interpret=True, reverse=True)
        assert z.dtype == jnp.bfloat16
        dxs, dwih, dwhh, db = lstm_bwd_fused(
            z, c, h, hb, cb, tuple(_pad(x) for x in xs), _pad(g), jnp.asarray(p["w_ih"]),
            jnp.asarray(p["w_hh"]), pad_ms, KEEP, dx_add=tuple(_pad(a) for a in add),
            batch_tile=TILE, t_chunk=4, interpret=True, reverse=True)
    cut = lambda a: torch.from_numpy(np.array(a)[:batch])  # noqa: E731
    z16 = _bf16_from_jax(np.asarray(z)[:batch])
    tp = _t(p)
    rest = (cut(h), torch.from_numpy(g), tuple(torch.from_numpy(x) for x in xs), tp["w_ih"],
            tp["w_hh"], True, tuple(torch.from_numpy(m) for m in ms), KEEP,
            tuple(torch.from_numpy(a) for a in add))
    if kernel == "3b":
        args, plain, wrapper = (z16, cut(c)) + rest, lstm_bwd_v2_plain, lstm_bwd_v2
    else:
        args, plain, wrapper = (z16,) + rest, lstm_bwd_plain, lstm_bwd
    got = plain(*args)
    for a, b in zip(got[0], dxs):
        assert _rel(a.numpy(), np.asarray(b)[:batch]) < BWD_REL_TOL
    for a, b in zip(got[1:], (dwih, dwhh, db)):
        assert _rel(a.numpy(), b) < BWD_REL_TOL
    # the twin widens the bf16 residual exactly: the same as on its float32 copy
    widened = plain(args[0].float(), *args[1:])
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1:], widened[0] + widened[1:]))
    wrapped = wrapper(*args)
    assert all(torch.equal(a, b) for a, b in zip(wrapped[0] + wrapped[1:], got[0] + got[1:]))


@pytest.mark.parametrize("n_parts", [1, 2])
def test_bwd_dualdir_res16_twin_matches_pallas(n_parts):
    """Kernel 4's twin on the Pallas forwards' bf16 planes (parts dropped by
    select dropout, mask_from_x) against ``lstm_bwd_dualdir`` on them."""
    rng, pf, xs, ms = _inputs(170 + n_parts, n_parts)
    pr = _weights(rng, xs[0].shape[-1] * n_parts, pf["w_hh"].shape[0])
    xs = tuple(np.where(m != 0, x / np.float32(KEEP), np.float32(0)).astype(np.float32)
               for x, m in zip(xs, ms))
    batch, steps, _ = xs[0].shape
    hidden = pf["w_hh"].shape[0]
    g_f, g_r = ((0.1 * rng.standard_normal((batch, steps, hidden))).astype(np.float32)
                for _ in range(2))
    with reference_flags(dict(RES16, EEGFLOW_BWD_DUALDIR="1")):
        res = []
        for p, reverse in ((pf, False), (pr, True)):
            h, c, z, _, hb, cb, _ = pallas_fwd_proj(
                tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
                jnp.asarray(p["w_hh"]), batch_tile=TILE, t_chunk=4, need_residuals=True,
                interpret=True, reverse=reverse)
            assert z.dtype == jnp.bfloat16
            res.append((z, c, h, hb, cb))
        dxs_f, dxs_r, want_f, want_r = pallas_bwd_dualdir(
            res[0], res[1], tuple(_pad(x) for x in xs), _pad(g_f), _pad(g_r),
            jnp.asarray(pf["w_ih"]), jnp.asarray(pf["w_hh"]), jnp.asarray(pr["w_ih"]),
            jnp.asarray(pr["w_hh"]), keep=KEEP, mask_from_x=True, batch_tile=TILE, t_chunk=4,
            interpret=True)
    cut = lambda a: torch.from_numpy(np.array(a)[:batch])  # noqa: E731
    tf, tr = _t(pf), _t(pr)
    args = (_bf16_from_jax(np.asarray(res[0][0])[:batch]), cut(res[0][2]),
            torch.from_numpy(g_f), _bf16_from_jax(np.asarray(res[1][0])[:batch]),
            cut(res[1][2]), torch.from_numpy(g_r), tuple(torch.from_numpy(x) for x in xs),
            (tf["w_ih"], tf["w_hh"]), (tr["w_ih"], tr["w_hh"]), KEEP, True)
    got_dx, got_f, got_r = lstm_bwd_dualdir_plain(*args)
    for dx, a, b in zip(got_dx, dxs_f, dxs_r):
        assert _rel(dx.numpy(), (np.asarray(a) + np.asarray(b))[:batch]) < BWD_REL_TOL
    for got, want in ((got_f, want_f), (got_r, want_r)):
        for a, b in zip(got, want):
            assert _rel(a.numpy(), b) < BWD_REL_TOL
    flat = lambda out: list(out[0]) + list(out[1]) + list(out[2])  # noqa: E731
    assert all(torch.equal(a, b)
               for a, b in zip(flat(lstm_bwd_dualdir(*args)), flat((got_dx, got_f, got_r))))


@pytest.mark.parametrize("lstm_bwd,flags", [
    ("fused", SCHEDULE_FLAGS["fused"]),
    ("two_pass", SCHEDULE_FLAGS["two_pass"]),
    ("dualdir", SCHEDULE_FLAGS["dualdir"]),
    ("fused", dict(DROPW, **RES16))],
    ids=["fused", "two_pass", "dualdir", "fused-dropout_write"])
def test_classifier_res16_matches_the_reference_schedule(lstm_bwd, flags):
    with reference_flags(flags):
        classifier_matches_reference(lstm_bwd, SMALL, seeds=(12, 14, 36), res_bf16=True)


@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass", "dualdir"])
def test_train_step_res16_matches_the_reference_step(lstm_bwd):
    with reference_flags(SCHEDULE_FLAGS[lstm_bwd]):
        params, jp = train_step_matches_reference(lstm_bwd, res_bf16=True)
    assert not np.array_equal(params["head3"]["w"].detach().numpy(), np.asarray(jp["head3"]["w"]))


@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass", "dualdir"])
def test_res16_step_against_the_float32_residual_step(lstm_bwd):
    """The same masks and params with bf16 and with float32 residuals, on the
    twins: the same loss (the forward never reads the residuals) and every
    gradient within RES16_STEP_REL_TOL of the float32-residual one."""
    cfg = tcfg.ModelConfig(**SMALL)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(6, 8, cfg.input_size, generator=gen)
    y = torch.randint(0, 2, (6,), generator=gen)
    masks = draw_dropout_masks(cfg, 6, 8, gen)
    out = []
    for res_bf16 in (False, True):
        params = classifier_init(cfg, torch.Generator().manual_seed(4), trainable=True)
        logits = classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16,
                                  lstm_impl="plain", train=True, masks=masks, lstm_bwd=lstm_bwd,
                                  res_bf16=res_bf16)
        loss = tlosses.cross_entropy_loss(logits, y)
        loss.backward()
        out.append((loss.item(), {n: q.grad for n, q in params.named_parameters()
                                  if q.grad is not None}))
    (loss_32, grads_32), (loss_16, grads_16) = out
    assert loss_16 == loss_32
    worst = max(_rel(grads_16[n].numpy(), g.numpy()) for n, g in grads_32.items())
    assert 0 < worst < RES16_STEP_REL_TOL


def test_the_float32_policy_refuses_res_bf16():
    cfg = tcfg.ModelConfig(**SMALL)
    params = classifier_init(cfg, trainable=True)
    with pytest.raises(ValueError, match="res_bf16 needs the bf16 policy"):
        classifier_apply(params, torch.zeros(2, 4, 5), cfg, train=True, res_bf16=True)
    train = tcfg.TrainConfig(bf16=False, lstm_impl="plain")
    opt = make_optimizer(list(params.parameters()), train, updates_per_epoch=1)
    with pytest.raises(ValueError, match="res_bf16 needs the bf16 policy"):
        make_train_step(cfg, train, opt, res_bf16=True)
    with pytest.raises(ValueError, match="res_bf16 needs the bf16 policy"):
        bilstm_layer(params["lstm"][0], torch.zeros(2, 4, 16), bf16=False, res_bf16=True)
