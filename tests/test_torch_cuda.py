"""eegflow_torch CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips without a CUDA device (the check runs inside
the fixture, so every process collects the same tests). This file imports no
JAX; on a GPU machine without JAX, skip the suite's conftest (it sets JAX
up): ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from eegflow_torch import kernels
from eegflow_torch.core.config import CouplingConfig, ModelConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.couple.rollout import CoupledModel, predict_batch
from eegflow_torch.nn.cuda_attention import (attention_pool, attention_pool_plain,
                                             pool_head_bwd, pool_head_bwd_plain,
                                             pool_head_fused, pool_head_fused_plain)
from eegflow_torch.nn.cuda_input import (input_block_bwd, input_block_bwd_plain,
                                         input_block_fused, input_block_fused_plain)
from eegflow_torch.nn.cuda_lstm import (V2_CHUNK_BYTES, lstm_bwd, lstm_bwd_dualdir,
                                        lstm_bwd_dualdir_plain, lstm_bwd_plain, lstm_bwd_v2,
                                        lstm_bwd_v2_plain,
                                        lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain,
                                        lstm_fwd_train, lstm_fwd_train_gates,
                                        lstm_fwd_train_gates_plain, lstm_fwd_train_plain,
                                        lstm_recurrence, lstm_recurrence_backward,
                                        lstm_recurrence_backward_plain, lstm_recurrence_plain)
from eegflow_torch.nn.losses import cross_entropy_loss
from eegflow_torch.nn.model import classifier_apply, classifier_init, draw_dropout_masks
from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array

pytestmark = pytest.mark.cuda

# kernel vs twin: the same bf16-rounded products summed in float32 in another
# order (bf16 flips of h carry through the recurrence); measured about 2e-4
# at full width on an H100
LSTM_TOL = 1e-3
# pool head, float32: summation order only. Under bf16 a last-bit difference
# in a LayerNorm output can flip its bf16 rounding (one bf16 ulp, 2^-8
# relative), which moves a score by up to ~1e-3 at these weight scales.
POOL_TOL = {False: 1e-4, True: 2e-3}
# backward kernels vs twins, relative to each gradient's largest entry: the
# same bf16-rounded operands, float32 sums in another order, bf16 flips of dz
# carried through dh_carry (measured up to 1.2e-3 at full width on an H100)
BWD_REL_TOL = 5e-3
# a whole micro-step, kernel path vs plain path (as chip_smoke.py)
STEP_REL_TOL = 2e-2
# float32 kernels vs twins: the same float32 operations, sums in another order
# (the twins' products are cuBLAS float32, TF32 off)
F32_TOL = 1e-4
F32_REL_TOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dev):
    return torch.randn(shape, generator=gen).to(dev)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_fwd_kernel_matches_twin(dev, n_parts, reverse, batch, hidden):
    gen = make_generator(n_parts)
    d_part, steps, bound = 48, 40, hidden ** -0.5
    w_ih = (torch.rand(d_part * n_parts, 4 * hidden, generator=gen) * 2 - 1).to(dev) * bound
    w_hh = (torch.rand(hidden, 4 * hidden, generator=gen) * 2 - 1).to(dev) * bound
    b = (torch.rand(4 * hidden, generator=gen) * 2 - 1).to(dev) * bound
    xs = tuple(_randn(gen, batch, steps, d_part, dev=dev) for _ in range(n_parts))
    before = kernels.launch_counts["lstm_fwd"]
    got = lstm_fwd_fused_proj(xs, w_ih, b, w_hh, reverse)
    assert kernels.launch_counts["lstm_fwd"] == before + 1
    want = lstm_fwd_fused_proj_plain(xs, w_ih, b, w_hh, reverse)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= LSTM_TOL


def test_lstm_fwd_kernel_rejects_bad_shapes(dev):
    x = torch.zeros(2, 3, 8, device=dev)
    w = torch.zeros(8, 4 * 48, device=dev)
    with pytest.raises(ValueError, match="H % 32"):
        lstm_fwd_fused_proj((x,), w, torch.zeros(4 * 48, device=dev),
                            torch.zeros(48, 4 * 48, device=dev))
    with pytest.raises(ValueError, match="w_ih"):
        lstm_fwd_fused_proj((x,), torch.zeros(9, 128, device=dev),
                            torch.zeros(128, device=dev), torch.zeros(32, 128, device=dev))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_pool_head_kernel_matches_twin(dev, n_parts, use_ln, bf16):
    gen = make_generator(10 + n_parts)
    d_part, k, batch, steps = 64, 96, 6, 37
    d = d_part * n_parts
    ln = {"scale": 1 + 0.1 * _randn(gen, d, dev=dev), "bias": 0.1 * _randn(gen, d, dev=dev)}
    attn = {"proj": {"w": 0.2 * _randn(gen, d, k, dev=dev), "b": 0.2 * _randn(gen, k, dev=dev)},
            "score": {"w": 0.2 * _randn(gen, k, 1, dev=dev), "b": _randn(gen, 1, dev=dev)}}
    xs = tuple(torch.tanh(_randn(gen, batch, steps, d_part, dev=dev)) for _ in range(n_parts))
    got_ctx, got_s = pool_head_fused(ln if use_ln else None, attn, xs, use_ln, bf16)
    want_ctx, want_s = pool_head_fused_plain(ln if use_ln else None, attn, xs, use_ln, bf16)
    torch.cuda.synchronize()
    assert (got_s - want_s).abs().max().item() <= POOL_TOL[bf16]
    for g, w in zip(got_ctx, want_ctx):
        assert (g - w).abs().max().item() <= POOL_TOL[bf16]


def test_kernel_path_matches_plain_path(dev):
    cfg = ModelConfig(input_size=7, hidden_size=64, num_layers=2)
    params = classifier_init(cfg, make_generator(3), device=dev)
    x = np.random.default_rng(0).standard_normal((9, 32, 7)).astype(np.float32)
    model = CoupledModel(params, cfg, rates_to_array(DEFAULT_RATES, dev), CouplingConfig(),
                         device=dev)
    kernels.reset_launch_counts()
    got = predict_batch(model, x)
    assert kernels.launch_counts["lstm_fwd"] == 4
    assert kernels.launch_counts["pool_head_fwd"] == 1
    assert kernels.launch_counts["input_block_fwd"] == 1
    want = predict_batch(model, x, lstm_impl="plain")
    np.testing.assert_allclose(got["probs"], want["probs"], atol=LSTM_TOL, rtol=0)
    # the float32 policy runs on the kernels too
    xt = torch.from_numpy(x).to(dev)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got32 = classifier_apply(params, xt, cfg, lstm_impl="kernel")
        want32 = classifier_apply(params, xt, cfg, lstm_impl="plain")
    assert dict(kernels.launch_counts) == {"input_block_fwd": 1, "lstm_rec_fwd": 4,
                                           "pool_head_fwd": 1}
    assert (got32 - want32).abs().max().item() <= F32_TOL


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _lstm_case(gen, n_parts, batch, hidden, dev, d_part=48, steps=40, keep=0.7):
    bound = hidden ** -0.5
    w_ih = (torch.rand(d_part * n_parts, 4 * hidden, generator=gen) * 2 - 1).to(dev) * bound
    w_hh = (torch.rand(hidden, 4 * hidden, generator=gen) * 2 - 1).to(dev) * bound
    b = (torch.rand(4 * hidden, generator=gen) * 2 - 1).to(dev) * bound
    xs = tuple(_randn(gen, batch, steps, d_part, dev=dev) for _ in range(n_parts))
    ms = tuple((torch.rand(batch, steps, d_part, generator=gen) < keep).to(torch.uint8).to(dev)
               for _ in range(n_parts))
    return w_ih, w_hh, b, xs, ms, keep


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_fwd_train_kernel_matches_twin(dev, n_parts, reverse, batch, hidden, masked):
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(make_generator(20 + n_parts), n_parts, batch,
                                             hidden, dev)
    if not masked:
        ms, keep = None, 1.0
    before = kernels.launch_counts["lstm_fwd_train"]
    h, res = lstm_fwd_train(xs, w_ih, b, w_hh, reverse, ms, keep)
    assert kernels.launch_counts["lstm_fwd_train"] == before + 1
    h2, res2 = lstm_fwd_train_plain(xs, w_ih, b, w_hh, reverse, ms, keep)
    torch.cuda.synchronize()
    assert (h - h2).abs().max().item() <= LSTM_TOL
    assert (res - res2).abs().max().item() <= LSTM_TOL


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_bwd_kernel_matches_twin_and_repeats_bitwise(dev, n_parts, reverse, batch,
                                                          hidden):
    gen = make_generator(30 + n_parts)
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(gen, n_parts, batch, hidden, dev)
    h, res = lstm_fwd_train_plain(xs, w_ih, b, w_hh, reverse, ms, keep)
    g = 0.1 * _randn(gen, *h.shape, dev=dev)
    add = tuple(_randn(gen, *x.shape, dev=dev) for x in xs) if reverse else None
    before = kernels.launch_counts["lstm_bwd"]
    got = lstm_bwd(res, h, g, xs, w_ih, w_hh, reverse, ms, keep, add)
    again = lstm_bwd(res, h, g, xs, w_ih, w_hh, reverse, ms, keep, add)
    assert kernels.launch_counts["lstm_bwd"] == before + 2
    want = lstm_bwd_plain(res, h, g, xs, w_ih, w_hh, reverse, ms, keep, add)
    torch.cuda.synchronize()
    for a, w in zip(got[0], want[0]):
        assert _rel(a, w) <= BWD_REL_TOL
    for a, w in zip(got[1:], want[1:]):
        assert _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, c) for a, c in zip(got[0] + got[1:], again[0] + again[1:]))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_pool_head_bwd_kernel_matches_twin_and_repeats_bitwise(dev, n_parts, use_ln, bf16):
    gen = make_generator(40 + n_parts)
    d_part, k, batch, steps = 64, 96, 6, 37
    d = d_part * n_parts
    ln = {"scale": 1 + 0.1 * _randn(gen, d, dev=dev), "bias": 0.1 * _randn(gen, d, dev=dev)}
    attn = {"proj": {"w": 0.2 * _randn(gen, d, k, dev=dev), "b": 0.2 * _randn(gen, k, dev=dev)},
            "score": {"w": 0.2 * _randn(gen, k, 1, dev=dev)}}
    xs = tuple(torch.tanh(_randn(gen, batch, steps, d_part, dev=dev)) for _ in range(n_parts))
    w = torch.softmax(_randn(gen, batch, steps, dev=dev), dim=-1)
    gs = 0.01 * _randn(gen, batch, steps, dev=dev)
    gc = tuple(0.1 * _randn(gen, batch, d_part, dev=dev) for _ in range(n_parts))
    gctx = 0.1 * _randn(gen, batch, dev=dev)
    args = (ln if use_ln else None, attn, xs, w, gs, gc, gctx, use_ln, bf16)
    got, again, want = pool_head_bwd(*args), pool_head_bwd(*args), pool_head_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, c in zip(got[0], want[0]):
        assert _rel(a, c) <= POOL_TOL[bf16]
    for a, c in zip(got[1:], want[1:]):
        assert (a is None) == (c is None) and (a is None or _rel(a, c) <= POOL_TOL[bf16])
    flat = lambda out: list(out[0]) + [t for t in out[1:] if t is not None]  # noqa: E731
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


def test_training_micro_step_kernel_path_matches_plain_path(dev):
    cfg = ModelConfig(input_size=7, hidden_size=64, num_layers=2)
    params = classifier_init(cfg, make_generator(5), device=dev, trainable=True)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((9, 32, 7)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, 9)).to(dev)
    masks = draw_dropout_masks(cfg, 9, 32, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = list(params.parameters())

    def step(impl):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16, lstm_impl=impl,
                                  train=True, masks=masks)
        loss = cross_entropy_loss(logits, y)
        loss.backward()
        return loss.item(), [q.grad.clone() if q.grad is not None else None for q in leaves]

    kernels.reset_launch_counts()
    loss_k, grads_k = step("kernel")
    assert dict(kernels.launch_counts) == {"input_block_fwd": 1, "input_block_bwd": 1,
                                           "lstm_fwd_train": 4, "lstm_bwd": 4,
                                           "pool_head_fwd": 1, "pool_head_bwd": 1}
    loss_k2, grads_k2 = step("kernel")
    loss_p, grads_p = step("plain")
    assert abs(loss_k - loss_p) <= 1e-3 and loss_k == loss_k2
    for a, a2, c in zip(grads_k, grads_k2, grads_p):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, a2)
            assert _rel(a, c) <= STEP_REL_TOL


def _gates_case(gen, batch, hidden, dev, steps=40):
    """Gates of a one-part float32 projection, at the magnitudes the stack
    gives them."""
    bound = hidden ** -0.5
    w_ih = (torch.rand(hidden, 4 * hidden, generator=gen) * 2 - 1).to(dev) * bound
    w_hh = (torch.rand(hidden, 4 * hidden, generator=gen) * 2 - 1).to(dev) * bound
    x = torch.tanh(_randn(gen, batch, steps, hidden, dev=dev))
    return (x @ w_ih).contiguous(), w_hh


@pytest.mark.parametrize("collect_cell", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_rec_kernel_matches_twin(dev, reverse, collect_cell, batch, hidden):
    gates, w_hh = _gates_case(make_generator(50), batch, hidden, dev)
    name = "lstm_rec_fwd_train" if collect_cell else "lstm_rec_fwd"
    before = kernels.launch_counts[name]
    got = lstm_recurrence(gates, w_hh, reverse, collect_cell)
    assert kernels.launch_counts[name] == before + 1
    want = lstm_recurrence_plain(gates, w_hh, reverse, collect_cell)
    torch.cuda.synchronize()
    for a, w in zip(got if collect_cell else (got,), want if collect_cell else (want,)):
        assert (a - w).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_rec_bwd_kernel_matches_twin_and_repeats_bitwise(dev, reverse, batch, hidden):
    gen = make_generator(51)
    gates, w_hh = _gates_case(gen, batch, hidden, dev)
    h, c = lstm_recurrence_plain(gates, w_hh, reverse, True)
    g = 0.1 * _randn(gen, *h.shape, dev=dev)
    before = kernels.launch_counts["lstm_rec_bwd"]
    got = lstm_recurrence_backward(gates, h, c, w_hh, g, reverse)
    again = lstm_recurrence_backward(gates, h, c, w_hh, g, reverse)
    assert kernels.launch_counts["lstm_rec_bwd"] == before + 2
    want = lstm_recurrence_backward_plain(gates, h, c, w_hh, g, reverse)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert _rel(a, w) <= F32_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _input_case(gen, hidden, dev, batch=5, steps=37, channels=61):
    bound = channels ** -0.5
    proj = {"w": (torch.rand(channels, hidden, generator=gen) * 2 - 1).to(dev) * bound,
            "b": (torch.rand(hidden, generator=gen) * 2 - 1).to(dev) * bound}
    norm = {"scale": 1 + 0.1 * _randn(gen, hidden, dev=dev),
            "bias": 0.1 * _randn(gen, hidden, dev=dev)}
    return proj, norm, _randn(gen, batch, steps, channels, dev=dev)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hidden", [64, 256])
def test_input_block_kernels_match_twins_and_repeat_bitwise(dev, bf16, hidden):
    gen = make_generator(52)
    proj, norm, x = _input_case(gen, hidden, dev)
    before = dict(kernels.launch_counts)
    y = input_block_fused(proj, norm, x, bf16)
    dy = _randn(gen, *y.shape, dev=dev)
    got = input_block_bwd(proj, norm, x, dy, bf16)
    again = input_block_bwd(proj, norm, x, dy, bf16)
    assert kernels.launch_counts["input_block_fwd"] == before.get("input_block_fwd", 0) + 1
    assert kernels.launch_counts["input_block_bwd"] == before.get("input_block_bwd", 0) + 2
    want_y = input_block_fused_plain(proj, norm, x, bf16)
    want = input_block_bwd_plain(proj, norm, x, dy, bf16)
    torch.cuda.synchronize()
    assert (y - want_y).abs().max().item() <= F32_TOL
    for a, w in zip(got, want):
        assert _rel(a, w) <= (BWD_REL_TOL if bf16 else F32_REL_TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("batch,dim", [(3, 64), (16, 256)])
def test_attention_pool_kernel_matches_twin(dev, batch, dim):
    gen = make_generator(53)
    k = dim // 2
    w1 = 0.2 * _randn(gen, dim, k, dev=dev)
    b1, w2 = 0.2 * _randn(gen, k, dev=dev), 0.2 * _randn(gen, k, dev=dev)
    h = torch.tanh(_randn(gen, batch, 37, dim, dev=dev))
    before = kernels.launch_counts["attention_pool"]
    ctx, scores = attention_pool(h, w1, b1, w2)
    assert kernels.launch_counts["attention_pool"] == before + 1
    want_ctx, want_s = attention_pool_plain(h, w1, b1, w2)
    torch.cuda.synchronize()
    assert (ctx - want_ctx).abs().max().item() <= POOL_TOL[False]
    assert (scores - want_s).abs().max().item() <= POOL_TOL[False]


def test_f32_training_micro_step_kernel_path_matches_plain_path(dev):
    cfg = ModelConfig(input_size=7, hidden_size=64, num_layers=2)
    params = classifier_init(cfg, make_generator(6), device=dev, trainable=True)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((9, 32, 7)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, 9)).to(dev)
    masks = draw_dropout_masks(cfg, 9, 32, torch.Generator(device=dev).manual_seed(1), dev)
    leaves = list(params.parameters())

    def step(impl):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(params, x, cfg, lstm_impl=impl, train=True, masks=masks)
        loss = cross_entropy_loss(logits, y)
        loss.backward()
        return loss.item(), [q.grad.clone() if q.grad is not None else None for q in leaves]

    kernels.reset_launch_counts()
    loss_k, grads_k = step("kernel")
    assert dict(kernels.launch_counts) == {"input_block_fwd": 1, "input_block_bwd": 1,
                                           "lstm_rec_fwd_train": 4, "lstm_rec_bwd": 4,
                                           "pool_head_fwd": 1, "pool_head_bwd": 1}
    loss_k2, grads_k2 = step("kernel")
    loss_p, grads_p = step("plain")
    assert abs(loss_k - loss_p) <= F32_TOL and loss_k == loss_k2
    for a, a2, c in zip(grads_k, grads_k2, grads_p):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, a2)
            assert _rel(a, c) <= F32_REL_TOL


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_fwd_train_gates_kernel_matches_twin(dev, n_parts, reverse, batch, hidden,
                                                  masked):
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(make_generator(60 + n_parts), n_parts, batch,
                                             hidden, dev)
    if not masked:
        ms, keep = None, 1.0
    before = kernels.launch_counts["lstm_fwd_train_gates"]
    got = lstm_fwd_train_gates(xs, w_ih, b, w_hh, reverse, ms, keep)
    assert kernels.launch_counts["lstm_fwd_train_gates"] == before + 1
    want = lstm_fwd_train_gates_plain(xs, w_ih, b, w_hh, reverse, ms, keep)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert (a - w).abs().max().item() <= LSTM_TOL


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden,steps", [(5, 64, 40), (16, 256, 40), (32, 256, 600)])
def test_lstm_bwd_v2_kernel_matches_twin_and_repeats_bitwise(dev, n_parts, reverse, batch,
                                                             hidden, steps):
    """One chunk of all 40 steps, and at B=32, H=256 three chunks of at most
    256 steps (what V2_CHUNK_BYTES of bf16 dz holds), the last one 88 long."""
    t_chunk = V2_CHUNK_BYTES // (batch * 4 * hidden * 2)
    assert steps <= t_chunk or steps % t_chunk
    gen = make_generator(70 + n_parts)
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(gen, n_parts, batch, hidden, dev, steps=steps)
    h, gates, c = lstm_fwd_train_gates_plain(xs, w_ih, b, w_hh, reverse, ms, keep)
    g = 0.1 * _randn(gen, *h.shape, dev=dev)
    add = tuple(_randn(gen, *x.shape, dev=dev) for x in xs) if reverse else None
    args = (gates, c, h, g, xs, w_ih, w_hh, reverse, ms, keep, add)
    before = kernels.launch_counts["lstm_bwd_v2"]
    got = lstm_bwd_v2(*args)
    again = lstm_bwd_v2(*args)
    assert kernels.launch_counts["lstm_bwd_v2"] == before + 2
    want = lstm_bwd_v2_plain(*args)
    torch.cuda.synchronize()
    for a, w in zip(got[0] + got[1:], want[0] + want[1:]):
        assert _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, w) for a, w in zip(got[0] + got[1:], again[0] + again[1:]))
    # dropped inputs get exactly zero input gradient (before the sibling's dx)
    if add is None:
        for dx, m in zip(got[0], ms):
            assert (dx[m == 0] == 0).all()


@pytest.mark.parametrize("mask_from_x", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_bwd_dualdir_kernel_matches_twin_and_repeats_bitwise(dev, n_parts, batch, hidden,
                                                                  mask_from_x):
    gen = make_generator(80 + n_parts)
    w_f = _lstm_case(gen, n_parts, batch, hidden, dev)
    w_ih_r, w_hh_r, b_r = _lstm_case(gen, n_parts, batch, hidden, dev)[:3]
    w_ih_f, w_hh_f, b_f, xs, ms, keep = w_f
    if mask_from_x:  # the parts as select dropout leaves them
        xs = tuple(torch.where(m != 0, x / keep, torch.zeros((), device=dev))
                   for x, m in zip(xs, ms))
    else:
        keep = 1.0
    h_f, res_f = lstm_fwd_train_plain(xs, w_ih_f, b_f, w_hh_f, False)
    h_r, res_r = lstm_fwd_train_plain(xs, w_ih_r, b_r, w_hh_r, True)
    g_f, g_r = (0.1 * _randn(gen, *h_f.shape, dev=dev) for _ in range(2))
    args = (res_f, h_f, g_f, res_r, h_r, g_r, xs, (w_ih_f, w_hh_f), (w_ih_r, w_hh_r), keep,
            mask_from_x)
    before = kernels.launch_counts["lstm_bwd_dualdir"]
    got = lstm_bwd_dualdir(*args)
    again = lstm_bwd_dualdir(*args)
    assert kernels.launch_counts["lstm_bwd_dualdir"] == before + 2
    want = lstm_bwd_dualdir_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + list(out[1]) + list(out[2])  # noqa: E731
    for a, w in zip(flat(got), flat(want)):
        assert _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, w) for a, w in zip(flat(got), flat(again)))
    if mask_from_x:
        for dx, x in zip(got[0], xs):
            assert (dx[x == 0] == 0).all()
    else:
        # without dropout, one dual-direction launch is kernel 3 twice: the
        # forward direction, then the reverse one adding the first's dx
        dx_f, *gr_f = lstm_bwd(res_f, h_f, g_f, xs, w_ih_f, w_hh_f, False)
        dx, *gr_r = lstm_bwd(res_r, h_r, g_r, xs, w_ih_r, w_hh_r, True, dx_add=dx_f)
        for a, w in zip(flat(got), list(dx) + gr_f + gr_r):
            assert _rel(a, w) <= BWD_REL_TOL


@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass", "dualdir"])
def test_training_micro_step_schedules_kernel_path_match_plain_path(dev, lstm_bwd):
    cfg = ModelConfig(input_size=7, hidden_size=64, num_layers=2)
    params = classifier_init(cfg, make_generator(7), device=dev, trainable=True)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((9, 32, 7)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, 9)).to(dev)
    masks = draw_dropout_masks(cfg, 9, 32, torch.Generator(device=dev).manual_seed(2), dev)
    leaves = list(params.parameters())

    def step(impl):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16, lstm_impl=impl,
                                  train=True, masks=masks, lstm_bwd=lstm_bwd)
        loss = cross_entropy_loss(logits, y)
        loss.backward()
        return loss.item(), [q.grad.clone() if q.grad is not None else None for q in leaves]

    kernels.reset_launch_counts()
    loss_k, grads_k = step("kernel")
    fwd, bwd, n_bwd = {"fused": ("lstm_fwd_train", "lstm_bwd", 4),
                       "two_pass": ("lstm_fwd_train_gates", "lstm_bwd_v2", 4),
                       "dualdir": ("lstm_fwd_train", "lstm_bwd_dualdir", 2)}[lstm_bwd]
    assert dict(kernels.launch_counts) == {"input_block_fwd": 1, "input_block_bwd": 1,
                                           fwd: 4, bwd: n_bwd, "pool_head_fwd": 1,
                                           "pool_head_bwd": 1}
    loss_k2, grads_k2 = step("kernel")
    loss_p, grads_p = step("plain")
    assert abs(loss_k - loss_p) <= 1e-3 and loss_k == loss_k2
    for a, a2, c in zip(grads_k, grads_k2, grads_p):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, a2)
            assert _rel(a, c) <= STEP_REL_TOL
