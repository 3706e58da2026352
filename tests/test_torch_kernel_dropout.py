"""The in-kernel Philox dropout of the bf16 LSTM stack (``kernel_dropout``;
the port's counterpart of the reference's ``EEGFLOW_KERNEL_DROPOUT=1``, the
default mode 1 of ``EEGFLOW_FWD_DROPW`` and the input block's ``out_seed``)
on the CPU: the twins of kernels 2, 3 and 3b fed a Philox source equal the
same twins fed the uint8 masks it expands to, bit for bit; one
bidirectional layer against the reference's ``bilstm_layer_fused_parts`` in
interpret mode fed those masks as explicit uint8 masks; the ``"fused"`` and
``"two_pass"`` train steps against the mask-path steps on the expanded
masks, bit for bit; the mesh's key and row offset; and the refusals (the
float32 policy, ``"dualdir"``, the explicit mesh step, the EEGFormer, a CPU
tensor on the kernels).

The TPU's hardware bits have no CPU lowering, so no test compares the two
streams; the port's bits are held to Random123 and to their statistics in
``tests/test_torch_philox.py``. Inputs are made with numpy from a seed; tiny
shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.nn.pallas_lstm import bilstm_layer_fused_parts
from eegflow_torch.core import config as tcfg
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.cuda_lstm import (bilstm_layer, counter, lstm_bwd, lstm_bwd_plain,
                                        lstm_bwd_v2, lstm_bwd_v2_plain, lstm_fwd_train,
                                        lstm_fwd_train_gates, lstm_fwd_train_gates_plain,
                                        lstm_fwd_train_plain)
from eegflow_torch.nn.model import (classifier_apply, classifier_init, draw_dropout_masks,
                                    expand_dropout_masks, train_step_launches)
from eegflow_torch.nn.philox import PhiloxSource, draw_keep_bits, philox_keep_mask
from eegflow_torch.train.loop import train_classifier
from eegflow_torch.train.mesh import DataMesh, make_spmd_train_step, shard_batch
from eegflow_torch.train.steps import make_optimizer, make_train_step
from test_torch_lstm_bwd_v2 import (BWD_REL_TOL, KEEP, SMALL, TWIN_TOL, TWO_PASS, _inputs,
                                    _rel, _t, _weights, reference_flags)
from torch_threads import one_torch_thread  # noqa: F401

KEY = torch.tensor([-987654321, 123456789], dtype=torch.int32)
TINY = dict(SMALL, dropout=0.4)


def _source(n_parts, row_offset=0):
    return PhiloxSource(KEY, tuple(1 + p for p in range(n_parts)), row_offset)


def _all_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("res_bf16", [False, True])
@pytest.mark.parametrize("contract", ["planes", "gates"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_kernel_2_twin_on_a_philox_source_is_the_twin_on_its_masks(contract, res_bf16, n_parts):
    """Kernel 2's twin (both contracts, with and without bf16 residuals)
    expands the source into the masks the kernel reads and applies them as
    the mask path does; on CPU tensors the wrapper, given the planes drawn
    for the parts, runs the twin."""
    _, p, xs, _ = _inputs(200 + n_parts, n_parts)
    tp, txs = _t(p), tuple(torch.from_numpy(x) for x in xs)
    src = _source(n_parts, row_offset=3)
    twin, wrapper = ((lstm_fwd_train_gates_plain, lstm_fwd_train_gates) if contract == "gates"
                     else (lstm_fwd_train_plain, lstm_fwd_train))
    head = (txs, tp["w_ih"], tp["b"], tp["w_hh"], True)
    got = twin(*head, src, KEEP, res_bf16=res_bf16)
    assert _all_equal(got, twin(*head, src.masks(txs, KEEP), KEEP, res_bf16=res_bf16))
    bits = draw_keep_bits(src, txs, KEEP)
    assert _all_equal(got, twin(*head, bits, KEEP, res_bf16=res_bf16))
    assert _all_equal(got, wrapper(*head, bits, KEEP, res_bf16=res_bf16))
    # the source drops: not the function without dropout
    assert not torch.equal(got[0], twin(*head, None, 1.0, res_bf16=res_bf16)[0])


@pytest.mark.parametrize("kernel", ["3", "3b"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_kernels_3_and_3b_twins_on_a_philox_source_are_the_twins_on_its_masks(kernel,
                                                                              n_parts):
    rng, p, xs, _ = _inputs(210 + n_parts, n_parts)
    tp, txs = _t(p), tuple(torch.from_numpy(x) for x in xs)
    src = _source(n_parts, row_offset=5)
    ms = src.masks(txs, KEEP)
    g = torch.from_numpy((0.1 * rng.standard_normal((5, 8, 32))).astype(np.float32))
    add = tuple(torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)) for x in xs)
    if kernel == "3b":
        h, gates, c = lstm_fwd_train_gates_plain(txs, tp["w_ih"], tp["b"], tp["w_hh"], True,
                                                 ms, KEEP)
        twin, wrapper, res = lstm_bwd_v2_plain, lstm_bwd_v2, (gates, c)
    else:
        h, planes = lstm_fwd_train_plain(txs, tp["w_ih"], tp["b"], tp["w_hh"], True, ms, KEEP)
        twin, wrapper, res = lstm_bwd_plain, lstm_bwd, (planes,)
    head = (*res, h, g, txs, tp["w_ih"], tp["w_hh"], True)
    flat = lambda out: list(out[0]) + list(out[1:])  # noqa: E731
    got = flat(twin(*head, src, KEEP, add))
    assert _all_equal(got, flat(twin(*head, ms, KEEP, add)))
    assert _all_equal(got, flat(wrapper(*head, draw_keep_bits(src, txs, KEEP), KEEP, add)))
    # dropped inputs get exactly zero input gradient from this direction
    for dx, m in zip(twin(*head, src, KEEP)[0], ms):
        assert bool((dx[m == 0] == 0).all())


@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass"])
def test_bidirectional_layer_on_philox_bits_matches_the_reference_on_the_same_masks(lstm_bwd):
    """One two-part bidirectional layer on a Philox source (streams 1 and 2,
    both directions sharing them) against ``jax.value_and_grad`` of the
    reference's ``bilstm_layer_fused_parts`` (interpret mode) fed the
    expanded masks as explicit uint8 masks: h within TWIN_TOL of the
    reference's, the gradients within BWD_REL_TOL of each one's largest
    entry."""
    rng, pf, xs, _ = _inputs(220, 2)
    pb = _weights(rng, 32, 32)
    txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
    src = _source(2)
    ms = tuple(m.numpy() for m in src.masks(txs, KEEP))

    def loss_jax(pf_, pb_, xs_):
        hf, hb = bilstm_layer_fused_parts(pf_, pb_, xs_, bf16=True,
                                          masks=tuple(jnp.asarray(m) for m in ms), keep=KEEP)
        return jnp.sum(jnp.tanh(hf)) + jnp.sum(jnp.cos(hb)), (hf, hb)

    jtree = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    with reference_flags(TWO_PASS if lstm_bwd == "two_pass" else {}):
        (want_loss, want_h), (gf, gb, gx) = jax.value_and_grad(
            loss_jax, argnums=(0, 1, 2), has_aux=True)(jtree(pf), jtree(pb),
                                                        tuple(jnp.asarray(x) for x in xs))
    layer = {"fwd": {k: v.requires_grad_() for k, v in _t(pf).items()},
             "bwd": {k: v.requires_grad_() for k, v in _t(pb).items()}}
    hf, hb = bilstm_layer(layer, txs, src, KEEP, lstm_bwd=lstm_bwd, kernel_dropout=True)
    for got, want in zip((hf, hb), want_h):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TWIN_TOL,
                                   rtol=0)
    loss = torch.tanh(hf).sum() + torch.cos(hb).sum()
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= BWD_REL_TOL * abs(float(want_loss))
    for direction, grads in (("fwd", gf), ("bwd", gb)):
        for k in ("w_ih", "w_hh", "b"):
            assert _rel(layer[direction][k].grad.numpy(), grads[k]) < BWD_REL_TOL, (direction, k)
    for x, g in zip(txs, gx):
        assert _rel(x.grad.numpy(), g) < BWD_REL_TOL


def _step_case(seed=30, batch=6, steps=8):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, steps, 5)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, batch))
    return x, y


def _run_step(cfg, lstm_bwd, masks, kernel_dropout, x, y, mesh=None):
    train = tcfg.TrainConfig(accumulation_steps=1, learning_rate=1e-3, warmup_epochs=1,
                             epochs=4, bf16=True, lstm_impl="plain")
    params = classifier_init(cfg, make_generator(31), trainable=True)
    opt = make_optimizer(list(params.parameters()), train, updates_per_epoch=1)
    step = make_train_step(cfg, train, opt, class_weights=torch.tensor([0.8, 1.2]),
                           lstm_bwd=lstm_bwd, kernel_dropout=kernel_dropout, mesh=mesh)
    m = step(params, x, y, masks)
    return m["loss"], [p.detach().clone() for p in params.parameters()]


@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass"])
def test_train_step_with_kernel_dropout_is_the_mask_path_step_on_the_expanded_masks(lstm_bwd):
    """A ``kernel_dropout`` train step equals the mask-path step on the masks
    its key expands to, bit for bit (loss and the params after the update);
    that step is held to the reference's by ``train_step_matches_reference``
    (tests/test_torch_lstm_bwd_v2.py)."""
    cfg = tcfg.ModelConfig(**TINY)
    x, y = _step_case()
    masks = draw_dropout_masks(cfg, 6, 8, torch.Generator().manual_seed(4), kernel_dropout=True)
    assert masks.input is None and masks.layers == () and masks.key.dtype == torch.int32
    expanded = expand_dropout_masks(masks, cfg, 6, 8)
    assert expanded.input.shape == (6, 8, 16) and len(expanded.layers) == 1
    assert torch.equal(expanded.layers[0][1], philox_keep_mask(masks.key, 2, (6, 8, 16), 0.6))
    loss_k, params_k = _run_step(cfg, lstm_bwd, masks, True, x, y)
    loss_m, params_m = _run_step(cfg, lstm_bwd, expanded, False, x, y)
    assert torch.equal(loss_k, loss_m) and _all_equal(params_k, params_m)
    # another key draws other masks and another step
    other = dataclasses.replace(masks, key=masks.key + 1)
    assert not torch.equal(_run_step(cfg, lstm_bwd, other, True, x, y)[0], loss_k)


def test_a_mesh_ranks_rows_take_the_whole_batchs_key_and_their_offset():
    """``shard_batch`` gives a rank its rows of the head masks and the whole
    key; the implicit mesh step sets the row offset to the rank's first row,
    so the rank's masks are its rows of the one-process masks."""
    cfg = tcfg.ModelConfig(**TINY)
    masks = draw_dropout_masks(cfg, 6, 8, torch.Generator().manual_seed(5), kernel_dropout=True)
    mesh = DataMesh(None, rank=1, world_size=2, device=torch.device("cpu"))
    mine = shard_batch(masks, mesh)
    assert torch.equal(mine.key, masks.key) and torch.equal(mine.head1, masks.head1[3:])
    whole = expand_dropout_masks(masks, cfg, 6, 8)
    rows = expand_dropout_masks(dataclasses.replace(mine, row_offset=3), cfg, 3, 8)
    assert torch.equal(rows.input, whole.input[3:])
    assert _all_equal(rows.layers[0], tuple(m[3:] for m in whole.layers[0]))


def test_the_launch_counts_name_the_philox_modes():
    cfg = tcfg.ModelConfig()
    got = train_step_launches(cfg, "two_pass", res_bf16=True, kernel_dropout=True)
    assert got[counter("lstm_bwd_v2", True, True)] == 6 == got["lstm_bwd_v2_res16_philox"]
    assert train_step_launches(cfg, kernel_dropout=True)["lstm_fwd_train_philox"] == 6
    # without dropout there is nothing to draw: the plain counters
    no_drop = tcfg.ModelConfig(dropout=0.0)
    assert train_step_launches(no_drop, kernel_dropout=True) == train_step_launches(no_drop)


@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass"])
def test_the_launch_counts_hold_one_draw_per_layer_and_pass(lstm_bwd):
    """With the Philox dropout each layer draws its keep-bit planes at the
    top of its forward and of its backward: 2 draws a layer; none without
    it or without dropout."""
    cfg = tcfg.ModelConfig()
    got = train_step_launches(cfg, lstm_bwd, kernel_dropout=True)
    assert got["philox_keep_bits"] == 2 * cfg.num_layers == 6
    assert "philox_keep_bits" not in train_step_launches(cfg, lstm_bwd)
    assert "philox_keep_bits" not in train_step_launches(tcfg.ModelConfig(dropout=0.0),
                                                         lstm_bwd, kernel_dropout=True)


@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass"])
def test_a_layer_on_the_kernels_draws_its_planes_once_per_pass(lstm_bwd, monkeypatch):
    """``BiLSTMLayer`` on the kernels' wrappers (their CPU twins here) draws
    the planes once for both directions' forwards and once for both
    backwards, and gives the twins' layer bit for bit."""
    from eegflow_torch.nn import cuda_lstm

    draws = []
    real = cuda_lstm.draw_keep_bits

    def counted(src, xs, keep):
        draws.append(len(xs))
        return real(src, xs, keep)

    monkeypatch.setattr(cuda_lstm, "draw_keep_bits", counted)
    rng, pf, xs, _ = _inputs(221, 2)
    pb = _weights(rng, 32, 32)
    out = []
    for kernel in (True, False):
        layer = {"fwd": {k: v.requires_grad_() for k, v in _t(pf).items()},
                 "bwd": {k: v.requires_grad_() for k, v in _t(pb).items()}}
        txs = tuple(torch.from_numpy(x).requires_grad_() for x in xs)
        hf, hb = bilstm_layer(layer, txs, _source(2), KEEP, kernel, lstm_bwd=lstm_bwd,
                              kernel_dropout=True)
        (torch.tanh(hf).sum() + torch.cos(hb).sum()).backward()
        out.append([hf.detach(), hb.detach(), *(x.grad for x in txs),
                    *(p.grad for d in ("fwd", "bwd") for p in layer[d].values())])
    assert draws == [2, 2]
    assert _all_equal(*out)


def test_the_kernels_argument_checks_take_drawn_planes_and_refuse_a_source():
    """The CUDA wrappers' checks (run here on CPU tensors) pass a drawn
    plane of the parts' size at its keep, and refuse planes of another size
    or keep and the Philox source itself (its caller draws the planes)."""
    from eegflow_torch.nn.cuda_lstm import _check_cuda_args
    from eegflow_torch.nn.philox import PhiloxBits

    _, w, xs, _ = _inputs(222, 2)
    txs = tuple(torch.from_numpy(x) for x in xs)
    tw = _t(w)
    args = (txs, tw["w_ih"], tw["b"], tw["w_hh"])
    src = _source(2)
    bits = draw_keep_bits(src, txs, KEEP)
    _check_cuda_args(*args, bits, KEEP)
    with pytest.raises(ValueError, match="draw_keep_bits"):
        _check_cuda_args(*args, src, KEEP)
    with pytest.raises(ValueError, match="keep"):
        _check_cuda_args(*args, bits, 0.5)
    short = PhiloxBits(src, KEEP, (bits.planes[0][:-4], bits.planes[1]))
    with pytest.raises(ValueError, match="planes"):
        _check_cuda_args(*args, short, KEEP)


def test_kernel_dropout_refusals():
    cfg = tcfg.ModelConfig(**TINY)
    params = classifier_init(cfg, trainable=True)
    x = torch.zeros(2, 4, 5)
    masks = draw_dropout_masks(cfg, 2, 4, torch.Generator().manual_seed(6), kernel_dropout=True)
    kw = dict(train=True, masks=masks, kernel_dropout=True)
    with pytest.raises(ValueError, match="bf16 policy"):
        classifier_apply(params, x, cfg, **kw)
    with pytest.raises(ValueError, match="'fused' or 'two_pass'"):
        classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16, lstm_bwd="dualdir", **kw)
    # a CPU tensor on the kernels
    with pytest.raises(ValueError, match="needs CUDA"):
        classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16, lstm_impl="kernel", **kw)
    # the masks and the keyword go together
    with pytest.raises(ValueError, match="kernel_dropout"):
        classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16, train=True, masks=masks)
    mask_path = draw_dropout_masks(cfg, 2, 4, torch.Generator().manual_seed(6))
    with pytest.raises(ValueError, match="kernel_dropout"):
        classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16, train=True,
                         masks=mask_path, kernel_dropout=True)
    layer = params["lstm"][0]
    with pytest.raises(ValueError, match="PhiloxSource"):
        bilstm_layer(layer, (torch.zeros(2, 4, 16),), None, 0.8, kernel_dropout=True)
    with pytest.raises(ValueError, match="bf16 policy"):
        bilstm_layer(layer, (torch.zeros(2, 4, 16),), _source(1), 0.8, bf16=False,
                     kernel_dropout=True)
    f32 = tcfg.TrainConfig(bf16=False, lstm_impl="plain")
    opt = make_optimizer(list(params.parameters()), f32, updates_per_epoch=1)
    with pytest.raises(ValueError, match="bf16 policy"):
        make_train_step(cfg, f32, opt, kernel_dropout=True)
    bf16 = tcfg.TrainConfig(lstm_impl="plain")
    with pytest.raises(ValueError, match="'fused' or 'two_pass'"):
        make_train_step(cfg, bf16, opt, lstm_bwd="dualdir", kernel_dropout=True)
    # the explicit mesh step takes kernel_dropout and refuses what the step
    # without a mesh refuses
    with pytest.raises(ValueError, match="bf16 policy"):
        make_spmd_train_step(cfg, f32, opt, None, kernel_dropout=True)
    with pytest.raises(ValueError, match="'fused' or 'two_pass'"):
        make_spmd_train_step(cfg, bf16, opt, None, lstm_bwd="dualdir", kernel_dropout=True)
    former = tcfg.TransformerConfig()
    with pytest.raises(ValueError, match="EEGFormer"):
        draw_dropout_masks(former, 2, 4, torch.Generator(), kernel_dropout=True)
    with pytest.raises(ValueError, match="EEGFormer"):
        make_train_step(former, bf16, opt, kernel_dropout=True)
    with pytest.raises(ValueError, match="EEGFormer"):
        make_spmd_train_step(former, bf16, opt, None, kernel_dropout=True)


def test_train_classifier_with_kernel_dropout_repeats_and_is_not_the_mask_path_run():
    """Two runs with the same seed give the same params (each step's key
    drawn from the epoch's generator); the mask path's run draws other
    masks from it."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((16, 8, 5)).astype(np.float32)
    y = np.arange(16) % 2
    cfg = tcfg.ModelConfig(**TINY)
    train = tcfg.TrainConfig(batch_size=8, epochs=1, warmup_epochs=1, accumulation_steps=1,
                             lstm_impl="plain", patience=5)

    def run(kernel_dropout):
        res = train_classifier(x, y, x[:4], y[:4], cfg, train, device="cpu", verbose=False,
                               kernel_dropout=kernel_dropout)
        return res.history["train_loss"], jax.tree_util.tree_leaves(res.params)

    (loss_a, leaves_a), (loss_b, leaves_b) = run(True), run(True)
    assert loss_a == loss_b and all(np.array_equal(a, b) for a, b in zip(leaves_a, leaves_b))
    assert run(False)[0] != loss_a
