"""The ``"two_pass"`` backward schedule against eegflow's Pallas kernels in
interpret mode under ``EEGFLOW_ADJOINT_RES=0 EEGFLOW_BWD_V2=1``: the raw-gate
forward twin against ``lstm_fwd_fused_proj(need_residuals=True)``, the
kernel 3b twin against ``lstm_bwd_fused`` on the same residuals, the
``BiLSTMLayer`` Function against ``jax.grad`` of the reference's layers, the
classifier and a train step against the reference's fused schedule, and the
selector's errors.

The reference reads its ``EEGFLOW_*`` flags into module globals that its
jitted kernels' traces bake in, so :func:`reference_flags` sets them, calls
``refresh_flags()`` and ``jax.clear_caches()``, and on the way out restores
the environment first and refreshes again: no later test sees the flags.
Inputs are made with numpy from a seed; tiny shapes."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.core import config as jcfg
from eegflow.nn import losses as jlosses
from eegflow.nn import pallas_lstm
from eegflow.nn.layers import dropout_mask as jax_dropout_mask
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow.nn.model import classifier_init as jax_init
from eegflow.nn.pallas_lstm import (bilstm_layer_fused_parts, lstm_bwd_fused,
                                    lstm_layer_fused_parts)
from eegflow.nn.pallas_lstm import lstm_fwd_fused_proj as pallas_fwd_proj
from eegflow.train.steps import TrainState, make_optimizer as jax_make_optimizer
from eegflow.train.steps import make_train_step as jax_make_train_step
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.nn import losses as tlosses
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, lstm_bwd_v2, lstm_bwd_v2_plain,
                                        lstm_fwd_train_gates, lstm_fwd_train_gates_plain)
from eegflow_torch.nn.model import DropoutMasks, classifier_apply, classifier_init
from eegflow_torch.train.steps import make_optimizer, make_train_step

# twin vs Pallas kernel: the same masked, bf16-rounded operands and float32
# sums in another order; a last-bit difference can flip the bf16 rounding of
# h at the next step and carries through the recurrence (as test_torch_lstm_bwd)
TWIN_TOL = 1e-4
# kernel 3b twin vs Pallas on the SAME residuals, relative to each gradient's
# largest entry: dz is computed the same way on both sides (tanh(c)
# recomputed); the products sum in another order (the reference one
# contraction per block of rows x t_chunk), and a last-bit difference in dz
# can flip its bf16 rounding, carried on through dh_carry
BWD_REL_TOL = 1e-4
# the whole layer through autograd vs jax.grad through both Pallas kernels:
# the forward differences above feed the residuals of the backward
LAYER_REL_TOL = 1e-3
# the classifier, the port's schedule vs the reference's (twins vs Pallas
# kernels in interpret mode, the same bf16 rounding points): float32 sums in
# another order and the bf16 flips they cause (as test_torch_train)
FUSED_REL_TOL = 2e-3
KEEP = 0.75
TILE = 8
SMALL = dict(input_size=5, hidden_size=16, num_layers=2)
TWO_PASS = {"EEGFLOW_ADJOINT_RES": "0", "EEGFLOW_BWD_V2": "1"}
# the reference's schedule of the port's whole classifier: the fused input
# block and explicit uint8 masks
CLASSIFIER_TWO_PASS = dict(TWO_PASS, EEGFLOW_FUSED_INPUT="1", EEGFLOW_MASK_DROPOUT="1")


@contextlib.contextmanager
def reference_flags(flags):
    """The JAX package under ``flags`` (EEGFLOW_* -> value, None = unset)
    for the block."""
    saved = {k: os.environ.get(k) for k in flags}
    for k, v in flags.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    pallas_lstm.refresh_flags()
    jax.clear_caches()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        pallas_lstm.refresh_flags()
        jax.clear_caches()


@pytest.fixture
def two_pass():
    with reference_flags(TWO_PASS):
        yield


@pytest.fixture
def classifier_two_pass():
    with reference_flags(CLASSIFIER_TWO_PASS):
        yield


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
    """Pallas forward under the raw-gate contract on the batch padded to the
    tile -> (h, c, gates, h_bound, c_bound) of the padded batch."""
    h, c, z, tc, hb, cb, _ = pallas_fwd_proj(
        tuple(_pad(x) for x in xs), jnp.asarray(p["w_ih"]), jnp.asarray(p["b"]),
        jnp.asarray(p["w_hh"]), masks=tuple(_pad(m) for m in ms), keep=KEEP,
        batch_tile=TILE, t_chunk=4, need_residuals=True, interpret=True, reverse=reverse)
    assert tc is None
    return h, c, z, hb, cb


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return np.asarray(tree)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_fwd_train_gates_twin_matches_pallas(n_parts, reverse, two_pass):
    _, p, xs, ms = _inputs(60 + n_parts, n_parts)
    batch = xs[0].shape[0]
    hidden = p["w_hh"].shape[0]
    h_want, c_want, z_want, _, _ = _pallas_fwd(xs, ms, p, reverse)
    assert z_want.shape[-1] == 4 * hidden, "the raw-gate contract"
    tp = _t(p)
    txs = tuple(torch.from_numpy(x) for x in xs)
    tms = tuple(torch.from_numpy(m) for m in ms)
    h, gates, c = lstm_fwd_train_gates_plain(txs, tp["w_ih"], tp["b"], tp["w_hh"], reverse,
                                             tms, KEEP)
    for got, want in ((h, h_want), (gates, z_want), (c, c_want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:batch], atol=TWIN_TOL, rtol=0)
    # on CPU tensors the wrapper runs the twin
    again = lstm_fwd_train_gates(txs, tp["w_ih"], tp["b"], tp["w_hh"], reverse, tms, KEEP)
    assert all(torch.equal(a, b) for a, b in zip(again, (h, gates, c)))


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_v2_twin_matches_pallas_on_the_same_residuals(n_parts, reverse, two_pass):
    rng, p, xs, ms = _inputs(70 + n_parts, n_parts)
    batch, steps, _ = xs[0].shape
    hidden = p["w_hh"].shape[0]
    h_pad, c_pad, z_pad, hb, cb = _pallas_fwd(xs, ms, p, reverse)
    g = (0.1 * rng.standard_normal((batch, steps, hidden))).astype(np.float32)
    add = (tuple(rng.standard_normal(x.shape).astype(np.float32) for x in xs)
           if reverse else None)
    dxs, dwih, dwhh, db = lstm_bwd_fused(
        z_pad, c_pad, h_pad, hb, cb, tuple(_pad(x) for x in xs), _pad(g),
        jnp.asarray(p["w_ih"]), jnp.asarray(p["w_hh"]), tuple(_pad(m) for m in ms), KEEP,
        dx_add=tuple(_pad(a) for a in add) if add else None, batch_tile=TILE, t_chunk=4,
        interpret=True, reverse=reverse)
    tp = _t(p)
    cut = lambda a: torch.from_numpy(np.array(a)[:batch])  # noqa: E731
    args = (cut(z_pad), cut(c_pad), cut(h_pad), torch.from_numpy(g),
            tuple(torch.from_numpy(x) for x in xs), tp["w_ih"], tp["w_hh"], reverse,
            tuple(torch.from_numpy(m) for m in ms), KEEP,
            tuple(torch.from_numpy(a) for a in add) if add else None)
    got = lstm_bwd_v2_plain(*args)
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
    wrapped = lstm_bwd_v2(*args)
    assert all(torch.equal(a, b) for a, b in zip(wrapped[0] + wrapped[1:], got[0] + got[1:]))


@pytest.mark.parametrize("n_parts", [1, 2])
def test_bilstm_layer_two_pass_matches_jax_grad(n_parts, two_pass):
    rng, pf, xs, ms = _inputs(80 + n_parts, n_parts)
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
    hf, hb = bilstm_layer(layer, txs, tuple(torch.from_numpy(m) for m in ms), KEEP,
                          lstm_bwd="two_pass")
    loss = torch.tanh(hf).sum() + torch.cos(hb).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LAYER_REL_TOL * abs(float(want_loss))
    for direction, grads in (("fwd", gf), ("bwd", gb)):
        for k in ("w_ih", "w_hh", "b"):
            assert _rel(layer[direction][k].grad.numpy(), grads[k]) < LAYER_REL_TOL, (direction, k)
    for x, g in zip(txs, gx):
        assert _rel(x.grad.numpy(), g) < LAYER_REL_TOL


def test_unidirectional_layer_two_pass_matches_jax_grad(two_pass):
    """A unidirectional layer: one direction's kernel 3b, no dx_add."""
    _, p, xs, ms = _inputs(85, 2)

    def loss_jax(p_, xs_):
        h = lstm_layer_fused_parts(p_["w_ih"], p_["w_hh"], p_["b"], xs_, False, True,
                                   tuple(jnp.asarray(m) for m in ms), KEEP)
        return jnp.sum(jnp.tanh(h))

    want_loss, (gp, gx) = jax.value_and_grad(loss_jax, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, tuple(jnp.asarray(x) for x in xs))
    layer = {"fwd": {k: v.requires_grad_() for k, v in _t(p).items()}}
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    (h,) = bilstm_layer(layer, txs, tuple(torch.from_numpy(m) for m in ms), KEEP,
                        lstm_bwd="two_pass")
    loss = torch.tanh(h).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LAYER_REL_TOL * abs(float(want_loss))
    for k in ("w_ih", "w_hh", "b"):
        assert _rel(layer["fwd"][k].grad.numpy(), gp[k]) < LAYER_REL_TOL, k
    for x, g in zip(txs, gx):
        assert _rel(x.grad.numpy(), g) < LAYER_REL_TOL


def _part_masks(key, cfg, batch, steps):
    """The masks the reference draws from ``key`` for the explicit-mask and
    select paths (eegflow.nn.model / eegflow.nn.lstm: one mask per input
    part of each layer, folded in by layer then part), as DropoutMasks."""
    d, hidden = cfg.dropout, cfg.resolved_hidden()
    keys = {n: jax.random.fold_in(key, i) for i, n in enumerate(["inp", "lstm", "h1", "h2"])}
    t = lambda m: torch.from_numpy(np.array(m))  # noqa: E731
    n_dir = 2 if cfg.bidirectional else 1
    layers = tuple(
        tuple(t(jax_dropout_mask(jax.random.fold_in(jax.random.fold_in(keys["lstm"], idx), j),
                                 d, (batch, steps, hidden))) for j in range(n_dir))
        for idx in range(cfg.num_layers - 1))
    return DropoutMasks(
        input=t(jax_dropout_mask(keys["inp"], d / 2, (batch, steps, hidden))),
        layers=layers,
        head1=t(jax_dropout_mask(keys["h1"], d, (batch, hidden))),
        head2=t(jax_dropout_mask(keys["h2"], d, (batch, hidden // 2))))


def classifier_matches_reference(lstm_bwd, kw, seeds):
    """The port's classifier loss and gradients under ``lstm_bwd`` on the
    plain twins against ``jax.value_and_grad`` of the reference's
    ``classifier_apply(lstm_impl="pallas", compute_dtype=bfloat16)``, with
    the reference's masks from one key (the caller sets the flags).

    ``seeds`` = (params, windows, dropout key). The tolerance holds while
    both sides round the same values to the same bf16 operands; a value
    within float32 rounding of a bf16 tie can round the other way and move
    the gradients by 2e-3 to 2e-2 at these widths (test_torch_train), so the
    seeds are ones whose windows hold no such tie."""
    p_seed, x_seed, k_seed = seeds
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jax_init(jax.random.key(p_seed), jc)
    rng = np.random.default_rng(x_seed)
    x = rng.standard_normal((6, 8, jc.input_size)).astype(np.float32)
    y = rng.integers(0, 2, 6)
    key = jax.random.key(k_seed)

    def loss_fn(p):
        logits = jax_apply(p, jnp.asarray(x), jc, train=True, dropout_key=key,
                           compute_dtype=jnp.bfloat16, lstm_impl="pallas")
        return jlosses.cross_entropy_loss(logits, jnp.asarray(y))

    want_loss, want = jax.value_and_grad(loss_fn)(jp)
    params = params_from_jax(jp, trainable=True)
    logits = classifier_apply(params, torch.from_numpy(x), tc, compute_dtype=torch.bfloat16,
                              lstm_impl="plain", train=True,
                              masks=_part_masks(key, jc, 6, 8), lstm_bwd=lstm_bwd)
    loss = tlosses.cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < FUSED_REL_TOL * abs(float(want_loss))
    for name, p in params.named_parameters():
        if p.grad is None:  # the score bias, which softmax ignores
            np.testing.assert_array_equal(_leaf(want, name), 0.0)
        else:
            assert _rel(p.grad.numpy(), _leaf(want, name)) < FUSED_REL_TOL, name


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, bidirectional=False)],
                         ids=["bidirectional", "unidirectional"])
def test_classifier_two_pass_matches_the_reference_schedule(kw, classifier_two_pass):
    classifier_matches_reference("two_pass", kw, seeds=(12, 14, 36))


def train_step_matches_reference(lstm_bwd):
    """One ``make_train_step(..., lstm_bwd=...)`` step, dropout 0, against the
    reference's ``make_train_step`` on ``lstm_impl="pallas"`` under the flags
    the caller set: the loss, and the params after the update. Adam's first
    update is about lr sign(g), so a gradient that differs in its last bits
    can move an entry by up to ~lr (as test_train_steps_match_jax_make_train_step)."""
    kw = dict(SMALL, dropout=0.0)
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    train_kw = dict(accumulation_steps=1, learning_rate=1e-3, warmup_epochs=1, epochs=4,
                    bf16=True)
    jtrain = jcfg.TrainConfig(**train_kw, lstm_impl="pallas")
    ttrain = tcfg.TrainConfig(**train_kw, lstm_impl="plain")
    jp = jax_init(jax.random.key(12), jc)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((6, 8, 5)).astype(np.float32)
    y = rng.integers(0, 2, 6)
    cw = np.array([0.8, 1.2], np.float32)
    tx = jax_make_optimizer(jtrain, updates_per_epoch=1)
    jstep = jax_make_train_step(jc, jtrain, tx, class_weights=cw, donate=False)
    state, jm = jstep(TrainState(jp, tx.init(jp), jnp.asarray(0)), jnp.asarray(x),
                      jnp.asarray(y), jax.random.key(0))
    params = params_from_jax(jp, trainable=True)
    opt = make_optimizer(list(params.parameters()), ttrain, updates_per_epoch=1)
    tstep = make_train_step(tc, ttrain, opt, class_weights=torch.from_numpy(cw),
                            lstm_bwd=lstm_bwd)
    tm = tstep(params, torch.from_numpy(x), torch.from_numpy(y), None)
    assert abs(tm["loss"].item() - float(jm["loss"])) <= FUSED_REL_TOL * abs(float(jm["loss"]))
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(state.params, name),
                                   atol=2 * ttrain.learning_rate, rtol=0, err_msg=name)
    return params, jp


def test_train_step_two_pass_matches_the_reference_step(classifier_two_pass):
    params, jp = train_step_matches_reference("two_pass")
    # the step moved the params
    assert not np.array_equal(params["head3"]["w"].detach().numpy(), np.asarray(jp["head3"]["w"]))


@pytest.mark.parametrize("lstm_bwd", ["two_pass", "dualdir"])
def test_the_float32_policy_refuses_other_schedules(lstm_bwd):
    cfg = tcfg.ModelConfig(**SMALL)
    params = classifier_init(cfg, trainable=True)
    x = torch.zeros(2, 4, 5)
    with pytest.raises(ValueError, match="bf16 policy"):
        classifier_apply(params, x, cfg, train=True, lstm_bwd=lstm_bwd)
    train = tcfg.TrainConfig(bf16=False, lstm_impl="plain")
    opt = make_optimizer(list(params.parameters()), train, updates_per_epoch=1)
    with pytest.raises(ValueError, match="bf16 policy"):
        make_train_step(cfg, train, opt, lstm_bwd=lstm_bwd)
    with pytest.raises(ValueError, match="bf16 policy"):
        bilstm_layer(params["lstm"][0], torch.zeros(2, 4, 16), bf16=False, lstm_bwd=lstm_bwd)


def test_unknown_schedules_are_refused():
    cfg = tcfg.ModelConfig(**SMALL)
    params = classifier_init(cfg)
    with pytest.raises(ValueError, match="lstm_bwd must be one of"):
        classifier_apply(params, torch.zeros(2, 4, 5), cfg, compute_dtype=torch.bfloat16,
                         lstm_bwd="v2")
    with pytest.raises(ValueError, match="lstm_bwd must be one of"):
        bilstm_layer(params["lstm"][0], torch.zeros(2, 4, 16), lstm_bwd="v2")


def test_reference_flags_leave_nothing_behind():
    """The environment and the reference's flag globals are as before the
    block, for a flag set and for one unset inside it."""
    names = ("_ADJ_RES", "_BWD_V2", "_BWD_DUALDIR")
    keys = ("EEGFLOW_ADJOINT_RES", "EEGFLOW_BWD_V2", "EEGFLOW_BWD_DUALDIR",
            "EEGFLOW_MASK_DROPOUT")
    env_before = {k: os.environ.get(k) for k in keys}
    globals_before = {n: getattr(pallas_lstm, n) for n in names}
    with reference_flags(dict(TWO_PASS, EEGFLOW_BWD_DUALDIR="1", EEGFLOW_MASK_DROPOUT=None)):
        assert (pallas_lstm._ADJ_RES, pallas_lstm._BWD_V2, pallas_lstm._BWD_DUALDIR) == (0, 1, 1)
        assert "EEGFLOW_MASK_DROPOUT" not in os.environ
    assert {k: os.environ.get(k) for k in keys} == env_before
    assert {n: getattr(pallas_lstm, n) for n in names} == globals_before
