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
from eegflow_torch.core.config import CouplingConfig, ModelConfig, TrainConfig, TransformerConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.kernels.ablate import (WIDE_EDGE_PARTS, input_block_bwd_f64,
                                          lstm_bwd_f64_holds, narrow_bwd_f64_holds,
                                          pool_head_bwd_f64, wide_head_case)
from eegflow_torch.couple.rollout import CoupledModel, predict_batch
from eegflow_torch.nn.cuda_attention import (attention_pool, attention_pool_plain,
                                             pool_head_bwd, pool_head_bwd_bf16_plan,
                                             pool_head_bwd_plain, pool_head_fused,
                                             pool_head_fused_plain)
from eegflow_torch.nn.cuda_input import (bwd_plan, input_block_bwd, input_block_bwd_bf16_plan,
                                         input_block_bwd_plain, input_block_fused,
                                         input_block_fused_plain)
from eegflow_torch.nn.cuda_lstm import (counter, lstm_bwd, lstm_bwd_dualdir,
                                        lstm_bwd_dualdir_plain,
                                        lstm_bwd_plain, lstm_bwd_v2, lstm_bwd_v2_plain,
                                        lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain,
                                        lstm_fwd_train, lstm_fwd_train_gates,
                                        lstm_fwd_train_gates_plain, lstm_fwd_train_plain,
                                        lstm_recurrence, lstm_recurrence_backward,
                                        lstm_recurrence_backward_plain, lstm_recurrence_plain)
from eegflow_torch.nn.losses import cross_entropy_loss
from eegflow_torch.nn.model import (classifier_apply, classifier_init, draw_dropout_masks,
                                    expand_dropout_masks, train_step_launches)
from eegflow_torch.nn.philox import (PhiloxSource, draw_keep_bits, philox_keep_bits,
                                     philox_keep_mask)
from eegflow_torch.ode.cuda_ode import (rk4_fit_loss, rk4_fit_loss_plain, rk4_trajectory,
                                        rk4_trajectory_plain, step_sizes)
from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array
from eegflow_torch.signal.filters import (MAX_SECTIONS, _sos_design, butter_bandpass,
                                          filtfilt_iir, sos_filtfilt, sos_filtfilt_plain)

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
# kernel 8 in bf16 mode vs twin, relative: LayerNorm and product sums in
# another order, and bf16 flips of y or u
POOL_BWD_REL_TOL = 1e-3
# kernel 11 vs twin: the same float32 RK4 steps, with FMA contraction and the
# field's 3-term sums in another order; the loss relative, the tangents'
# gradient relative to its largest entry, trajectories absolute
APF_LOSS_REL_TOL = 1e-5
APF_GRAD_REL_TOL = 1e-4
APF_TRAJ_TOL = 1e-6
# kernel 12 vs twin, relative to the output's scale: the same roundings
# (multiply-adds written out in both), so measured 0
SOS_REL_TOL = 1e-5
# kernel 12 vs scipy's float64 filtfilt: the float32 recursion floor
SOS_SCIPY_REL_TOL = 3e-4


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


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
    # training mode writes z over its gates: each call gets its own copy
    got = lstm_recurrence(gates.clone(), w_hh, reverse, collect_cell)
    assert kernels.launch_counts[name] == before + 1
    want = lstm_recurrence_plain(gates.clone(), w_hh, reverse, collect_cell)
    torch.cuda.synchronize()
    for a, w in zip(got if collect_cell else (got,), want if collect_cell else (want,)):
        assert (a - w).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_rec_bwd_kernel_matches_twin_and_repeats_bitwise(dev, reverse, batch, hidden):
    gen = make_generator(51)
    gates, w_hh = _gates_case(gen, batch, hidden, dev)
    h, c = lstm_recurrence_plain(gates, w_hh, reverse, True)  # z over the gates
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
    """Kernel 3b's chain walks all T steps in one launch: 40, and 600 at
    B=32, H=256 (bf16 dz of 39 MB, the whole sequence through HBM once)."""
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


@pytest.mark.parametrize("res_bf16", [False, True])
@pytest.mark.parametrize("batch", [96, 100])
def test_lstm_bwd_dualdir_on_48_row_tiles_is_two_lstm_bwd_launches_bit_for_bit(dev, batch,
                                                                              res_bf16):
    """Kernel 4 on the 48-row tiles it takes at B=512 (three m-tiles, paired
    warps), at a batch that fills them and at one that does not, without
    dropout: kernel 3 forward, then kernel 3 reverse adding the first's dx,
    bit for bit, with both residual types."""
    from eegflow_torch.nn import cuda_lstm

    gen = make_generator(97)
    w_ih_f, w_hh_f, b_f, xs, _, _ = _lstm_case(gen, 2, batch, 256, dev)
    w_ih_r, w_hh_r, b_r = _lstm_case(gen, 2, batch, 256, dev)[:3]
    h_f, res_f = lstm_fwd_train_plain(xs, w_ih_f, b_f, w_hh_f, False)
    h_r, res_r = lstm_fwd_train_plain(xs, w_ih_r, b_r, w_hh_r, True)
    if res_bf16:
        res_f, res_r = res_f.to(torch.bfloat16), res_r.to(torch.bfloat16)
    g_f, g_r = (0.1 * _randn(gen, *h_f.shape, dev=dev) for _ in range(2))
    cuda_lstm.restrict_plan_rows((48,))
    try:
        assert cuda_lstm.kernel_plan("bwd_dualdir", batch, 256, int(res_bf16)).rows == 48
        got = lstm_bwd_dualdir(res_f, h_f, g_f, res_r, h_r, g_r, xs, (w_ih_f, w_hh_f),
                               (w_ih_r, w_hh_r))
        dx_f, *gr_f = lstm_bwd(res_f, h_f, g_f, xs, w_ih_f, w_hh_f, False)
        dx, *gr_r = lstm_bwd(res_r, h_r, g_r, xs, w_ih_r, w_hh_r, True, dx_add=dx_f)
    finally:
        cuda_lstm.restrict_plan_rows()
    torch.cuda.synchronize()
    want = list(dx) + gr_f + gr_r
    assert all(torch.equal(a, w) for a, w in zip(list(got[0]) + list(got[1]) + list(got[2]),
                                                  want))


@pytest.mark.parametrize("res_bf16", [False, True])
@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass", "dualdir"])
def test_training_micro_step_schedules_kernel_path_match_plain_path(dev, lstm_bwd, res_bf16):
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
                                  train=True, masks=masks, lstm_bwd=lstm_bwd,
                                  res_bf16=res_bf16)
        loss = cross_entropy_loss(logits, y)
        loss.backward()
        return loss.item(), [q.grad.clone() if q.grad is not None else None for q in leaves]

    kernels.reset_launch_counts()
    loss_k, grads_k = step("kernel")
    assert dict(kernels.launch_counts) == train_step_launches(cfg, lstm_bwd, res_bf16)
    loss_k2, grads_k2 = step("kernel")
    loss_p, grads_p = step("plain")
    assert abs(loss_k - loss_p) <= 1e-3 and loss_k == loss_k2
    for a, a2, c in zip(grads_k, grads_k2, grads_p):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, a2)
            assert _rel(a, c) <= STEP_REL_TOL


# the option res_bf16 (kernels 2, 3, 3b and 4): a bf16 residual of the
# kernel against the twin's rounds float32 values that agree within LSTM_TOL,
# so a value near a rounding boundary may take the next bf16 (one ulp of 8
# significant bits: 2^-7 of the value at most)
RES16_RTOL = 2.0 ** -7


@pytest.mark.parametrize("contract", ["planes", "gates"])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_fwd_train_res16_kernel_matches_twin(dev, contract, n_parts, reverse, batch,
                                                  hidden):
    """Kernel 2 on bf16 residuals: h and c as in the float32 mode bit for
    bit, the residual that mode's rounded to bf16, and all against the twin."""
    gen = make_generator(200 + n_parts)
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(gen, n_parts, batch, hidden, dev)
    name = "lstm_fwd_train_gates" if contract == "gates" else "lstm_fwd_train"
    fwd = lstm_fwd_train_gates if contract == "gates" else lstm_fwd_train
    plain = lstm_fwd_train_gates_plain if contract == "gates" else lstm_fwd_train_plain
    args = (xs, w_ih, b, w_hh, reverse, ms, keep)
    before = kernels.launch_counts[counter(name, True)]
    got = fwd(*args, res_bf16=True)
    assert kernels.launch_counts[counter(name, True)] == before + 1
    f32 = fwd(*args)
    want = plain(*args, res_bf16=True)
    torch.cuda.synchronize()
    assert len(got) == len(f32) and got[1].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(got[:1] + got[2:], f32[:1] + f32[2:]))
    assert torch.equal(got[1], f32[1].to(torch.bfloat16))
    for a, w in zip(got, want):
        assert a.dtype == w.dtype
        assert torch.allclose(a.float(), w.float(), atol=LSTM_TOL,
                              rtol=RES16_RTOL if a.dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("kernel", ["3", "3b"])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_bwd_res16_kernel_matches_twin_and_repeats_bitwise(dev, kernel, n_parts, reverse,
                                                                batch, hidden):
    """Kernels 3 and 3b on bf16 residuals against their twins, each launch
    repeated."""
    gen = make_generator(220 + n_parts)
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(gen, n_parts, batch, hidden, dev)
    if kernel == "3b":
        h, gates, c = lstm_fwd_train_gates_plain(xs, w_ih, b, w_hh, reverse, ms, keep,
                                                 res_bf16=True)
        res, bwd, plain, name = (gates, c), lstm_bwd_v2, lstm_bwd_v2_plain, "lstm_bwd_v2"
    else:
        h, planes = lstm_fwd_train_plain(xs, w_ih, b, w_hh, reverse, ms, keep, res_bf16=True)
        res, bwd, plain, name = (planes,), lstm_bwd, lstm_bwd_plain, "lstm_bwd"
    g = 0.1 * _randn(gen, *h.shape, dev=dev)
    add = tuple(_randn(gen, *x.shape, dev=dev) for x in xs) if reverse else None
    args = (*res, h, g, xs, w_ih, w_hh, reverse, ms, keep, add)
    before = kernels.launch_counts[counter(name, True)]
    got = bwd(*args)
    again = bwd(*args)
    assert kernels.launch_counts[counter(name, True)] == before + 2
    want = plain(*args)
    torch.cuda.synchronize()
    for a, w in zip(got[0] + got[1:], want[0] + want[1:]):
        assert _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, w) for a, w in zip(got[0] + got[1:], again[0] + again[1:]))


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (16, 256)])
def test_lstm_bwd_dualdir_res16_kernel_matches_twin_and_repeats_bitwise(dev, n_parts, batch,
                                                                        hidden):
    gen = make_generator(230 + n_parts)
    w_ih_f, w_hh_f, b_f, xs, ms, keep = _lstm_case(gen, n_parts, batch, hidden, dev)
    w_ih_r, w_hh_r, b_r = _lstm_case(gen, n_parts, batch, hidden, dev)[:3]
    xs = tuple(torch.where(m != 0, x * (1.0 / keep), torch.zeros((), device=dev))
               for x, m in zip(xs, ms))
    h_f, res_f = lstm_fwd_train_plain(xs, w_ih_f, b_f, w_hh_f, False, res_bf16=True)
    h_r, res_r = lstm_fwd_train_plain(xs, w_ih_r, b_r, w_hh_r, True, res_bf16=True)
    g_f, g_r = (0.1 * _randn(gen, *h_f.shape, dev=dev) for _ in range(2))
    args = (res_f, h_f, g_f, res_r, h_r, g_r, xs, (w_ih_f, w_hh_f), (w_ih_r, w_hh_r), keep, True)
    name = counter("lstm_bwd_dualdir", True)
    before = kernels.launch_counts[name]
    got = lstm_bwd_dualdir(*args)
    again = lstm_bwd_dualdir(*args)
    assert kernels.launch_counts[name] == before + 2
    want = lstm_bwd_dualdir_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + list(out[1]) + list(out[2])  # noqa: E731
    for a, w in zip(flat(got), flat(want)):
        assert _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, w) for a, w in zip(flat(got), flat(again)))


# The cluster kernels (kernel 2's three modes, kernel 3) over the batch,
# width and length range: every B in {1, 5, 17, 64}, H in {64, 128, 256, 512}
# and T in {1, 7, 40} appears with one and two parts and both directions;
# d_part 37 takes the projection's unaligned path; B=600 and B=1000 take
# clusters of 32 and 48 rows. H=160 (2 CTAs of 80 units) and H=416 (4 of
# 104, the slice partly streamed) take CTAs of more than 8 warps. Each launch
# is repeated and must give the same bits.
CLUSTER_CASES = [(1, 64, 1, 48), (5, 128, 7, 48), (17, 256, 40, 48), (64, 512, 40, 48),
                 (64, 64, 7, 37), (17, 512, 1, 48), (5, 256, 40, 48), (1, 128, 40, 48),
                 (600, 256, 7, 48), (1000, 256, 3, 48), (5, 160, 7, 48), (17, 416, 40, 48)]
FWD_MODES = {"eval": (lstm_fwd_fused_proj, lstm_fwd_fused_proj_plain, "lstm_fwd"),
             "planes": (lstm_fwd_train, lstm_fwd_train_plain, "lstm_fwd_train"),
             "gates": (lstm_fwd_train_gates, lstm_fwd_train_gates_plain,
                       "lstm_fwd_train_gates")}


def _fwd_args(mode, w_ih, w_hh, b, xs, ms, keep, reverse):
    if mode == "eval":
        return (xs, w_ih, b, w_hh, reverse)
    return (xs, w_ih, b, w_hh, reverse, ms, keep)


@pytest.mark.parametrize("mode", list(FWD_MODES))
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden,steps,d_part", CLUSTER_CASES)
def test_cluster_lstm_fwd_matches_twin_and_repeats_bitwise(dev, mode, n_parts, reverse, batch,
                                                           hidden, steps, d_part):
    kfn, pfn, name = FWD_MODES[mode]
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(make_generator(90 + n_parts), n_parts, batch,
                                             hidden, dev, d_part=d_part, steps=steps)
    args = _fwd_args(mode, w_ih, w_hh, b, xs, ms, keep, reverse)
    before = kernels.launch_counts[name]
    got, again = kfn(*args), kfn(*args)
    assert kernels.launch_counts[name] == before + 2
    want = pfn(*args)
    torch.cuda.synchronize()
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)  # noqa: E731
    for a, a2, w in zip(as_tuple(got), as_tuple(again), as_tuple(want)):
        assert (a - w).abs().max().item() <= LSTM_TOL
        assert torch.equal(a, a2)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_cluster_lstm_fwd_eval_at_the_serving_bucket(dev, n_parts, reverse):
    """B=1024, the coupled-inference bucket: 48 rows a cluster."""
    w_ih, w_hh, b, xs, _, _ = _lstm_case(make_generator(95), n_parts, 1024, 256, dev,
                                         d_part=256, steps=40)
    got = lstm_fwd_fused_proj(xs, w_ih, b, w_hh, reverse)
    again = lstm_fwd_fused_proj(xs, w_ih, b, w_hh, reverse)
    want = lstm_fwd_fused_proj_plain(xs, w_ih, b, w_hh, reverse)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= LSTM_TOL and torch.equal(got, again)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden,steps,d_part", CLUSTER_CASES)
def test_cluster_lstm_bwd_matches_twin_and_repeats_bitwise(dev, n_parts, reverse, batch, hidden,
                                                           steps, d_part):
    gen = make_generator(96 + n_parts)
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(gen, n_parts, batch, hidden, dev, d_part=d_part,
                                             steps=steps)
    h, res = lstm_fwd_train_plain(xs, w_ih, b, w_hh, reverse, ms, keep)
    g = 0.1 * _randn(gen, *h.shape, dev=dev)
    add = tuple(_randn(gen, *x.shape, dev=dev) for x in xs) if reverse else None
    args = (res, h, g, xs, w_ih, w_hh, reverse, ms, keep, add)
    before = kernels.launch_counts["lstm_bwd"]
    got, again = lstm_bwd(*args), lstm_bwd(*args)
    assert kernels.launch_counts["lstm_bwd"] == before + 2
    want = lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, w in zip(got[0] + got[1:], want[0] + want[1:]):
        assert _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, c) for a, c in zip(got[0] + got[1:], again[0] + again[1:]))


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden,steps,d_part", CLUSTER_CASES)
def test_cluster_lstm_bwd_v2_matches_twin_and_repeats_bitwise(dev, n_parts, reverse, batch,
                                                              hidden, steps, d_part):
    """Kernel 3b on kernel 3's cluster chain, from the raw-gate residuals."""
    gen = make_generator(98 + n_parts)
    w_ih, w_hh, b, xs, ms, keep = _lstm_case(gen, n_parts, batch, hidden, dev, d_part=d_part,
                                             steps=steps)
    h, gates, c = lstm_fwd_train_gates_plain(xs, w_ih, b, w_hh, reverse, ms, keep)
    g = 0.1 * _randn(gen, *h.shape, dev=dev)
    add = tuple(_randn(gen, *x.shape, dev=dev) for x in xs) if reverse else None
    args = (gates, c, h, g, xs, w_ih, w_hh, reverse, ms, keep, add)
    before = kernels.launch_counts["lstm_bwd_v2"]
    got, again = lstm_bwd_v2(*args), lstm_bwd_v2(*args)
    assert kernels.launch_counts["lstm_bwd_v2"] == before + 2
    want = lstm_bwd_v2_plain(*args)
    torch.cuda.synchronize()
    for a, w in zip(got[0] + got[1:], want[0] + want[1:]):
        assert _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, c) for a, c in zip(got[0] + got[1:], again[0] + again[1:]))


def _rec_gates(gen, batch, hidden, dev, d_part, steps):
    """Gates of a float32 projection of one input part, with its W_hh."""
    w_ih, w_hh, b, xs, _, _ = _lstm_case(gen, 1, batch, hidden, dev, d_part=d_part, steps=steps)
    return (torch.tanh(xs[0]) @ w_ih + b).contiguous(), w_hh


@pytest.mark.parametrize("collect_cell", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden,steps,d_part", CLUSTER_CASES)
def test_cluster_lstm_rec_matches_twin_and_repeats_bitwise(dev, collect_cell, reverse, batch,
                                                           hidden, steps, d_part):
    """Kernel 1 with W_hh resident across a cluster, in float32: eval (h) and
    training (h, c) mode."""
    gates, w_hh = _rec_gates(make_generator(99), batch, hidden, dev, d_part, steps)
    name = "lstm_rec_fwd_train" if collect_cell else "lstm_rec_fwd"
    before = kernels.launch_counts[name]
    # training mode writes z over its gates: each call gets its own copy
    z, z2, zp = gates.clone(), gates.clone(), gates.clone()
    got = lstm_recurrence(z, w_hh, reverse, collect_cell)
    again = lstm_recurrence(z2, w_hh, reverse, collect_cell)
    assert kernels.launch_counts[name] == before + 2
    want = lstm_recurrence_plain(zp, w_hh, reverse, collect_cell)
    torch.cuda.synchronize()
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)  # noqa: E731
    for a, a2, w in zip(as_tuple(got) + (z,), as_tuple(again) + (z2,), as_tuple(want) + (zp,)):
        assert (a - w).abs().max().item() <= F32_TOL
        assert torch.equal(a, a2)
    if not collect_cell:  # eval mode leaves the gates as they are
        assert torch.equal(z, gates)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden,steps,d_part", CLUSTER_CASES)
def test_cluster_lstm_rec_bwd_matches_twin_and_repeats_bitwise(dev, reverse, batch, hidden,
                                                               steps, d_part):
    """Kernel 5 on kernel 1's clusters, from the z kernel 1's training mode
    leaves over the gates: dh_carry reduce-scattered through DSMEM."""
    gen = make_generator(101)
    z, w_hh = _rec_gates(gen, batch, hidden, dev, d_part, steps)
    h, c = lstm_recurrence(z, w_hh, reverse, True)
    g = 0.1 * _randn(gen, *h.shape, dev=dev)
    before = kernels.launch_counts["lstm_rec_bwd"]
    got = lstm_recurrence_backward(z, h, c, w_hh, g, reverse)
    again = lstm_recurrence_backward(z, h, c, w_hh, g, reverse)
    assert kernels.launch_counts["lstm_rec_bwd"] == before + 2
    want = lstm_recurrence_backward_plain(z, h, c, w_hh, g, reverse)
    torch.cuda.synchronize()
    for a, a2, w in zip(got, again, want):
        assert _rel(a, w) <= F32_REL_TOL
        assert torch.equal(a, a2)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden", [(5, 64), (17, 416), (600, 256)])
def test_lstm_rec_training_mode_writes_the_twins_z_over_the_gates(dev, reverse, batch, hidden):
    """Kernel 1 in training mode leaves z = gates + h_prev . W_hh in its gates
    (the residual kernel 5 reads), within float32 summation order of the
    twin's z, and the gates of eval mode untouched."""
    gates, w_hh = _rec_gates(make_generator(100), batch, hidden, dev, 48, 40)
    z = gates.clone()
    h, _ = lstm_recurrence(z, w_hh, reverse, True)
    z_twin = gates.clone()
    lstm_recurrence_plain(z_twin, w_hh, reverse, True)
    torch.cuda.synchronize()
    assert (z - z_twin).abs().max().item() <= F32_TOL
    shifted = torch.zeros_like(h)
    if reverse:
        shifted[:, :-1] = h[:, 1:]
    else:
        shifted[:, 1:] = h[:, :-1]
    assert (z - (gates + shifted @ w_hh)).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("ln_parts", [(False, 1), (True, 2)])
@pytest.mark.parametrize("batch,steps", [(3, 100), (2, 256)])
def test_pool_head_bwd_bf16_on_tensor_cores_matches_twin_and_repeats_bitwise(dev, ln_parts,
                                                                             batch, steps):
    """Kernel 8's bf16 mode at the classifier's widths (parts of 256, K=256;
    one part of 256 and K=128 without LN), B T not a multiple of its 64-row
    tile (T=100) and a whole number of tiles (T=256)."""
    use_ln, n_parts = ln_parts
    gen = make_generator(110 + n_parts)
    d_part, k = 256, 128 * n_parts
    d = d_part * n_parts
    ln = {"scale": 1 + 0.1 * _randn(gen, d, dev=dev), "bias": 0.1 * _randn(gen, d, dev=dev)}
    attn = {"proj": {"w": 0.05 * _randn(gen, d, k, dev=dev), "b": 0.1 * _randn(gen, k, dev=dev)},
            "score": {"w": 0.1 * _randn(gen, k, 1, dev=dev)}}
    xs = tuple(torch.tanh(_randn(gen, batch, steps, d_part, dev=dev)) for _ in range(n_parts))
    w = torch.softmax(_randn(gen, batch, steps, dev=dev), dim=-1)
    gs = 0.01 * _randn(gen, batch, steps, dev=dev)
    gc = tuple(0.1 * _randn(gen, batch, d_part, dev=dev) for _ in range(n_parts))
    gctx = 0.1 * _randn(gen, batch, dev=dev)
    args = (ln if use_ln else None, attn, xs, w, gs, gc, gctx, use_ln, True)
    before = kernels.launch_counts["pool_head_bwd"]
    got, again = pool_head_bwd(*args), pool_head_bwd(*args)
    assert kernels.launch_counts["pool_head_bwd"] == before + 2
    want = pool_head_bwd_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [t for t in out[1:] if t is not None]  # noqa: E731
    assert len(flat(got)) == len(flat(want)) == n_parts + (5 if use_ln else 3)
    for a, c in zip(flat(got), flat(want)):
        assert _rel(a, c) <= POOL_BWD_REL_TOL
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


def test_pool_head_bwd_bf16_rejects_widths_off_its_tiles(dev):
    for d, k in ((40, 64), (64, 40), (1056, 64), (64, 544)):
        x = torch.zeros(2, 5, d, device=dev)
        attn = {"proj": {"w": torch.zeros(d, k, device=dev), "b": torch.zeros(k, device=dev)},
                "score": {"w": torch.zeros(k, 1, device=dev)}}
        z2 = torch.zeros(2, 5, device=dev)
        with pytest.raises(ValueError, match="pool_head_bwd under bf16 needs D <= 1024 and K "
                                             "<= 512, both multiples of 32"):
            pool_head_bwd(None, attn, (x,), z2, z2, (torch.zeros(2, d, device=dev),),
                          torch.zeros(2, device=dev), False, True)


def _pool_bwd_case(gen, d_part, k, n_parts, batch, steps, dev, w_scale=0.05):
    d = d_part * n_parts
    ln = {"scale": 1 + 0.1 * _randn(gen, d, dev=dev), "bias": 0.1 * _randn(gen, d, dev=dev)}
    attn = {"proj": {"w": w_scale * _randn(gen, d, k, dev=dev),
                     "b": 0.1 * _randn(gen, k, dev=dev)},
            "score": {"w": 0.1 * _randn(gen, k, 1, dev=dev)}}
    xs = tuple(torch.tanh(_randn(gen, batch, steps, d_part, dev=dev)) for _ in range(n_parts))
    w = torch.softmax(_randn(gen, batch, steps, dev=dev), dim=-1)
    gs = 0.01 * _randn(gen, batch, steps, dev=dev)
    gc = tuple(0.1 * _randn(gen, batch, d_part, dev=dev) for _ in range(n_parts))
    gctx = 0.1 * _randn(gen, batch, dev=dev)
    return ln, attn, xs, w, gs, gc, gctx


@pytest.mark.parametrize("use_ln", [False, True])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("batch,steps", [(3, 45), (2, 256)])
def test_pool_head_bwd_bf16_takes_the_widths_of_hidden_512(dev, use_ln, n_parts, batch, steps):
    """Kernel 8's wide bf16 class: D = 1024 (two parts of 512, a hidden-512
    classifier) and one part of 512, K = 512, on its 16-row tiles, with and
    without LN, T not a multiple of the tile (45) and a whole number (256)."""
    gen = make_generator(240 + n_parts + 2 * int(use_ln))
    ln, attn, xs, w, gs, gc, gctx = _pool_bwd_case(gen, 512, 512, n_parts, batch, steps, dev,
                                                   w_scale=0.03)
    args = (ln if use_ln else None, attn, xs, w, gs, gc, gctx, use_ln, True)
    before = kernels.launch_counts["pool_head_bwd"]
    got, again = pool_head_bwd(*args), pool_head_bwd(*args)
    assert kernels.launch_counts["pool_head_bwd"] == before + 2
    want = pool_head_bwd_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [t for t in out[1:] if t is not None]  # noqa: E731
    assert len(flat(got)) == len(flat(want)) == n_parts + (5 if use_ln else 3)
    for a, c in zip(flat(got), flat(want)):
        assert bool(torch.isfinite(a).all()) and _rel(a, c) <= POOL_BWD_REL_TOL
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


@pytest.mark.parametrize("ln_parts", [(False, 1), (True, 2)])
@pytest.mark.parametrize("batch,steps", [(3, 100), (2, 256)])
def test_pool_head_fwd_bf16_on_tensor_cores_matches_twin_and_repeats_bitwise(dev, ln_parts,
                                                                             batch, steps):
    """Kernel 7's bf16 mode at the classifier's widths (parts of 256, K=256;
    one part of 256 and K=128 without LN), T not a multiple of its 64-row
    tile (T=100) and a whole number of tiles (T=256)."""
    use_ln, n_parts = ln_parts
    gen = make_generator(120 + n_parts)
    d_part, k = 256, 128 * n_parts
    d = d_part * n_parts
    ln = {"scale": 1 + 0.1 * _randn(gen, d, dev=dev), "bias": 0.1 * _randn(gen, d, dev=dev)}
    attn = {"proj": {"w": 0.05 * _randn(gen, d, k, dev=dev), "b": 0.1 * _randn(gen, k, dev=dev)},
            "score": {"w": 0.1 * _randn(gen, k, 1, dev=dev)}}
    xs = tuple(torch.tanh(_randn(gen, batch, steps, d_part, dev=dev)) for _ in range(n_parts))
    args = (ln if use_ln else None, attn, xs, use_ln, True)
    before = kernels.launch_counts["pool_head_fwd"]
    got, again = pool_head_fused(*args), pool_head_fused(*args)
    assert kernels.launch_counts["pool_head_fwd"] == before + 2
    want = pool_head_fused_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [out[1]]  # noqa: E731
    for a, c in zip(flat(got), flat(want)):
        assert bool(torch.isfinite(a).all()) and (a - c).abs().max().item() <= POOL_TOL[True]
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


def test_pool_head_fwd_bf16_rejects_widths_off_its_tiles(dev):
    for d, k in ((40, 64), (64, 40), (1056, 64), (64, 544)):
        x = torch.zeros(2, 5, d, device=dev)
        attn = {"proj": {"w": torch.zeros(d, k, device=dev), "b": torch.zeros(k, device=dev)},
                "score": {"w": torch.zeros(k, 1, device=dev)}}
        with pytest.raises(ValueError, match="pool_head_fwd under bf16 needs D <= 1024 and K "
                                             "<= 512, both multiples of 32"):
            pool_head_fused(None, attn, (x,), False, True)
        # so does the float32 mode (3xTF32 on the tensor cores)
        with pytest.raises(ValueError, match="pool_head_fwd in float32 needs"):
            pool_head_fused(None, attn, (x,), False, False)


@pytest.mark.parametrize("use_ln", [False, True])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("batch,steps", [(3, 100), (2, 256)])
def test_pool_head_fwd_bf16_takes_the_widths_of_hidden_512(dev, use_ln, n_parts, batch, steps):
    """Kernel 7's wide bf16 class: D = 1024 (two parts of 512, a hidden-512
    classifier) and one part of 512, K = 512, on 16 warps, with and without
    LN, T not a multiple of its 64-row tile (100) and a whole number (256)."""
    gen = make_generator(250 + n_parts + 2 * int(use_ln))
    ln, attn, xs = _pool_case(gen, 512, 512, n_parts, batch, steps, dev, w_scale=0.03)
    args = (ln if use_ln else None, attn, xs, use_ln, True)
    before = kernels.launch_counts["pool_head_fwd"]
    got, again = pool_head_fused(*args), pool_head_fused(*args)
    assert kernels.launch_counts["pool_head_fwd"] == before + 2
    want = pool_head_fused_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [out[1]]  # noqa: E731
    for a, c in zip(flat(got), flat(want)):
        assert bool(torch.isfinite(a).all()) and (a - c).abs().max().item() <= POOL_TOL[True]
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


# the wide bf16 classes' edges: kernels.ablate.WIDE_EDGE_PARTS (the widths)
# and wide_head_case (the draws), which kernels.ablate --calls head reads too;
# B = 1 (one cluster) and 67 (a second wave of one cluster at one CTA an SM);
# T = 1, 45 (a ragged tile) and 256 (four whole tiles); (1, 256) too, where
# kernel 8 is held to its function in float64, not to its twin
# (test_pool_head_bwd_wide_cluster_on_one_long_row)
WIDE_EDGE_SHAPES = [(1, 1), (1, 45), (67, 45), (67, 256)]


@pytest.mark.parametrize("use_ln", [False, True])
@pytest.mark.parametrize("widths,k", WIDE_EDGE_PARTS)
@pytest.mark.parametrize("batch,steps", WIDE_EDGE_SHAPES + [(1, 256)])
def test_pool_head_fwd_wide_class_at_its_edges(dev, use_ln, widths, k, batch, steps):
    """Kernel 7's wide bf16 class against its twin at the widths and shapes
    at the edges of kernel 8's cluster design, with and without LN: one
    launch a call, bitwise on repeat."""
    gen = make_generator(300 + sum(widths) + k + batch + steps + int(use_ln))
    ln, attn, xs, _ = wide_head_case(gen, widths, k, batch, steps, dev)
    args = (ln if use_ln else None, attn, xs, use_ln, True)
    before = kernels.launch_counts["pool_head_fwd"]
    got, again = pool_head_fused(*args), pool_head_fused(*args)
    assert kernels.launch_counts["pool_head_fwd"] == before + 2
    want = pool_head_fused_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [out[1]]  # noqa: E731
    for a, c in zip(flat(got), flat(want)):
        assert a.shape == c.shape and bool(torch.isfinite(a).all())
        assert (a - c).abs().max().item() <= POOL_TOL[True]
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


def test_pool_head_bwd_bf16_plan_covers_the_width_rule(dev):
    """Kernel 8's bf16 launch, as its C entry point reports it, for every
    width the bf16 rule takes: one CTA a batch row up to D = 512 and K = 256,
    a cluster of two above either (D = 544, K = 288 the narrowest such widths
    of the classifier's kind), 64-step tiles, a CTA's shared memory within
    what this card lets a block take, the row kernel named by the runtime."""
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for d in range(32, 1025, 32):
        for k in range(32, 513, 32):
            plan = pool_head_bwd_bf16_plan(d, k)
            assert plan.wide == (d > 512 or k > 256)
            assert (plan.cluster, plan.tile_rows) == ((2, 64) if plan.wide else (1, 64))
            assert 0 < plan.smem <= optin
            assert plan.kernel == ("pool_head_bwd_wide_kernel" if plan.wide
                                   else "pool_head_bwd_bf16_kernel")


@pytest.mark.parametrize("use_ln", [False, True])
@pytest.mark.parametrize("widths,k", WIDE_EDGE_PARTS)
@pytest.mark.parametrize("batch,steps", WIDE_EDGE_SHAPES)
def test_pool_head_bwd_wide_cluster_at_its_edges(dev, use_ln, widths, k, batch, steps):
    """Kernel 8's wide bf16 class against its twin at the edges of its
    cluster design, with and without LN: every gradient within the bf16
    tolerance of its largest entry, one launch a call, bitwise on repeat."""
    gen = make_generator(400 + sum(widths) + k + batch + steps + int(use_ln))
    ln, attn, xs, (w, gs, gc, gctx) = wide_head_case(gen, widths, k, batch, steps, dev)
    args = (ln if use_ln else None, attn, xs, w, gs, gc, gctx, use_ln, True)
    before = kernels.launch_counts["pool_head_bwd"]
    got, again = pool_head_bwd(*args), pool_head_bwd(*args)
    assert kernels.launch_counts["pool_head_bwd"] == before + 2
    want = pool_head_bwd_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [t for t in out[1:] if t is not None]  # noqa: E731
    assert len(flat(got)) == len(flat(want)) == len(widths) + (5 if use_ln else 3)
    for a, c in zip(flat(got), flat(want)):
        assert a.shape == c.shape and bool(torch.isfinite(a).all())
        assert _rel(a, c) <= POOL_BWD_REL_TOL
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


@pytest.mark.parametrize("use_ln", [False, True])
@pytest.mark.parametrize("widths,k", WIDE_EDGE_PARTS)
def test_pool_head_bwd_wide_cluster_on_one_long_row(dev, use_ln, widths, k):
    """Kernel 8's wide class at B = 1, T = 256 (one cluster, four whole
    tiles), held with the bf16 tolerance to its function in float64 (y, W1
    and u rounded to bf16 where the twin rounds them): with 256 rows in dW1,
    one y or u that a float32 side rounds the other way at a bf16 tie moves
    dW1 by ~1e-3 of its largest entry, on the twin's side as on the
    kernel's; an H100 read 1.56e-3 between the float32 twin and the float64
    function at (512, 512), K = 512 with LN, and 1.9e-4 or less from the
    kernel at every case here. One launch a call, bitwise on repeat."""
    gen = make_generator(400 + sum(widths) + k + 1 + 256 + int(use_ln))
    ln, attn, xs, (w, gs, gc, gctx) = wide_head_case(gen, widths, k, 1, 256, dev)
    args = (ln if use_ln else None, attn, xs, w, gs, gc, gctx, use_ln, True)
    before = kernels.launch_counts["pool_head_bwd"]
    got, again = pool_head_bwd(*args), pool_head_bwd(*args)
    assert kernels.launch_counts["pool_head_bwd"] == before + 2
    want = pool_head_bwd_f64(*args[:-1])
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [t for t in out[1:] if t is not None]  # noqa: E731
    assert len(flat(got)) == len(want) == len(widths) + (5 if use_ln else 3)
    for a, c in zip(flat(got), want):
        assert a.shape == c.shape and bool(torch.isfinite(a).all())
        assert _rel(a.double(), c) <= POOL_BWD_REL_TOL
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


@pytest.mark.parametrize("hidden", [64, 256])
@pytest.mark.parametrize("batch,steps", [(5, 37), (40, 256)])
def test_input_block_bwd_bf16_on_tensor_cores_matches_twin_and_repeats_bitwise(dev, hidden,
                                                                               batch, steps):
    """Kernel 10's bf16 mode on ragged rows (5 x 37 = 185, not a multiple of
    its 64-row tile) and on rows spanning more tiles than its persistent grid
    holds (40 x 256 = 10240 rows, 160 tiles on 132 CTAs)."""
    gen = make_generator(130 + hidden)
    proj, norm, x = _input_case(gen, hidden, dev, batch=batch, steps=steps)
    dy = _randn(gen, batch, steps, hidden, dev=dev)
    before = kernels.launch_counts["input_block_bwd"]
    got = input_block_bwd(proj, norm, x, dy, True)
    again = input_block_bwd(proj, norm, x, dy, True)
    assert kernels.launch_counts["input_block_bwd"] == before + 2
    want = input_block_bwd_plain(proj, norm, x, dy, True)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("channels,hidden", [(61, 512), (130, 512), (130, 256), (7, 288),
                                             (130, 32), (130, 64)])
@pytest.mark.parametrize("batch,steps", [(5, 37), (40, 256)])
def test_input_block_bwd_bf16_takes_kernel_9s_widths(dev, channels, hidden, batch, steps):
    """Kernel 10's wide bf16 class (a cluster of two CTAs a 64-row tile):
    H = 512 at the classifier's C = 61 and at C = 130 (three channel chunks:
    a pass over the tiles per chunk), C = 130 at H = 256 and H = 288 (not a
    multiple of 64) and at its narrowest halves, H = 32 and 64 (16 and 32
    columns a CTA: one z pair on warp 0, a 16- or 32-deep dx product), on
    ragged rows (185) and on rows spanning more tiles than its persistent
    grid holds (10240 rows: 160 tiles on 66 clusters)."""
    gen = make_generator(260 + channels + hidden)
    proj, norm, x = _input_case(gen, hidden, dev, batch=batch, steps=steps, channels=channels)
    dy = _randn(gen, batch, steps, hidden, dev=dev)
    before = kernels.launch_counts["input_block_bwd"]
    got = input_block_bwd(proj, norm, x, dy, True)
    again = input_block_bwd(proj, norm, x, dy, True)
    assert kernels.launch_counts["input_block_bwd"] == before + 2
    want = input_block_bwd_plain(proj, norm, x, dy, True)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all()) and _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_input_block_bwd_bf16_plan_reads_both_classes(dev):
    """Kernel 10's bf16 launch as its C entry point makes it: the narrow
    class at the classifier's C = 61, H = 256 (one CTA a 64-row tile) and
    the wide class at H = 512 (a cluster of two CTAs a 64-row tile, each
    under the 227 KB a CTA may have), as ``bwd_plan`` plans them, with the
    card holding every cluster of the plan at once."""
    narrow, wide = input_block_bwd_bf16_plan(61, 256), input_block_bwd_bf16_plan(61, 512)
    assert (narrow.wide, narrow.cluster, narrow.tile_rows) == (False, 1, 64)
    assert narrow.kernel == "input_block_bwd_bf16_kernel"
    assert (wide.wide, wide.cluster, wide.tile_rows) == (True, 2, 64)
    assert wide.kernel == "input_block_bwd_wide_kernel" and wide.smem <= 232_448
    plan = bwd_plan(512 * 256, 61, 512, True)
    assert (plan.cluster, plan.tile_rows) == (wide.cluster, wide.tile_rows)
    assert wide.held >= plan.clusters


@pytest.mark.parametrize("channels,hidden,batch,steps", [
    (61, 512, 1, 37), (61, 512, 1, 1), (61, 512, 300, 1), (61, 512, 67, 127),
    (130, 288, 5, 37), (130, 288, 40, 256), (130, 288, 1, 1)])
def test_input_block_bwd_wide_cluster_at_its_edges(dev, channels, hidden, batch, steps):
    """Kernel 10's wide class at the edges of its plan: B = 1 (one ragged
    tile of 37 rows; 1 row), T = 1 (300 rows: 5 tiles), a tile count odd
    against the 66 clusters (67 x 127 = 8509 rows: 133 tiles, cluster 0
    takes three), and H = 288 (halves of 144 columns, 9 z pairs a CTA) at
    C = 130 (three channel passes); against the twin, finite, one launch a
    call, bitwise on repeat."""
    gen = make_generator(500 + channels + hidden + batch + steps)
    proj, norm, x = _input_case(gen, hidden, dev, batch=batch, steps=steps, channels=channels)
    dy = _randn(gen, batch, steps, hidden, dev=dev)
    before = kernels.launch_counts["input_block_bwd"]
    got = input_block_bwd(proj, norm, x, dy, True)
    again = input_block_bwd(proj, norm, x, dy, True)
    assert kernels.launch_counts["input_block_bwd"] == before + 2
    want = input_block_bwd_plain(proj, norm, x, dy, True)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all()) and _rel(a, w) <= BWD_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_input_block_bwd_wide_on_one_long_row(dev, seed):
    """Kernel 10's wide class at B = 1, T = 256, C = 61, H = 512 (four row
    tiles on four clusters), held to its function in float64 (x, W and dz
    rounded to bf16 where the twin rounds them,
    ``kernels.ablate.input_block_bwd_f64``): with 256 rows in dW, a dz that a
    float32 side rounds the other way at a bf16 tie moves dW by ~1e-3 of its
    largest entry on either side. Bitwise on repeat."""
    gen = make_generator(700 + seed)
    proj, norm, x = _input_case(gen, 512, dev, batch=1, steps=256)
    dy = _randn(gen, 1, 256, 512, dev=dev)
    got, again = input_block_bwd(proj, norm, x, dy, True), input_block_bwd(proj, norm, x, dy, True)
    want = input_block_bwd_f64(proj, norm, x, dy)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all())
        assert _rel(a.double(), w) <= BWD_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("hidden", [32, 64])
def test_input_block_bwd_wide_at_its_narrowest_halves_on_one_long_row(dev, hidden):
    """Kernel 10's wide class at C = 130 (over the narrow class's 64
    channels) and H = 32 or 64, B = 1, T = 256, held to its float64 function
    (``kernels.ablate.input_block_bwd_f64``) with the bf16 tolerance: the plan
    is the wide class's, one launch a call, bitwise on repeat."""
    assert input_block_bwd_bf16_plan(130, hidden).wide
    gen = make_generator(720 + hidden)
    proj, norm, x = _input_case(gen, hidden, dev, batch=1, steps=256, channels=130)
    dy = _randn(gen, 1, 256, hidden, dev=dev)
    before = kernels.launch_counts["input_block_bwd"]
    got, again = input_block_bwd(proj, norm, x, dy, True), input_block_bwd(proj, norm, x, dy, True)
    assert kernels.launch_counts["input_block_bwd"] == before + 2
    want = input_block_bwd_f64(proj, norm, x, dy)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all())
        assert _rel(a.double(), w) <= BWD_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_lstm_bwd_kernels_on_one_long_row_hold_to_their_float64_functions(dev):
    """Kernels 3, 3b and 4 at B = 1, T = 256, H = 256 on two parts of 256,
    each on its own training forward's residuals, held to its function in
    float64 (``kernels.ablate.lstm_bwd_f64``, ``lstm_bwd_v2_f64``,
    ``lstm_bwd_dualdir_f64``: dz rounded to bf16 where the twin rounds it,
    float64 elsewhere) with the bf16 tolerance, relative to each gradient's
    largest entry: at B = 1 a bf16 tie that a float32 side rounds the other
    way moves a 256-row dW by ~1e-3 of its largest entry, so the twin is no
    yardstick there. Both sides' distances are printed."""
    kernels.reset_launch_counts()
    holds = lstm_bwd_f64_holds(dev)
    torch.cuda.synchronize()
    assert dict(kernels.launch_counts) == {"lstm_fwd_train": 3, "lstm_fwd_train_gates": 1,
                                           "lstm_bwd": 1, "lstm_bwd_v2": 1,
                                           "lstm_bwd_dualdir": 1}
    for name, (kernel, twin) in holds.items():
        print(f"{name} B=1 T=256 H=256 from its float64 function: kernel {kernel:.3e}, "
              f"twin {twin:.3e}")
        assert kernel <= BWD_REL_TOL, name


def test_narrow_bf16_bwd_classes_on_one_long_row_hold_to_their_float64_functions(dev):
    """The narrow bf16 classes of kernels 8 (the classifier's head at H =
    256: two parts of 256, K = 256, with and without LayerNorm) and 10 (C = 61, H =
    256) at B = 1, T = 256, held to ``kernels.ablate.pool_head_bwd_f64`` and
    ``input_block_bwd_f64`` with the bf16 tolerance; both sides' distances
    are printed."""
    assert not input_block_bwd_bf16_plan(61, 256).wide
    assert not pool_head_bwd_bf16_plan(512, 256).wide
    kernels.reset_launch_counts()
    holds = narrow_bwd_f64_holds(dev)
    torch.cuda.synchronize()
    assert dict(kernels.launch_counts) == {"pool_head_bwd": 2, "input_block_bwd": 1}
    for name, (kernel, twin) in holds.items():
        print(f"{name} B=1 T=256 narrow bf16 class from its float64 function: kernel "
              f"{kernel:.3e}, twin {twin:.3e}")
        assert kernel <= BWD_REL_TOL, name


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hidden", [32, 256, 512])
@pytest.mark.parametrize("batch,steps", [(5, 37), (40, 256)])
def test_input_block_fwd_on_persistent_tiles_matches_twin_and_repeats_bitwise(dev, bf16, hidden,
                                                                              batch, steps):
    """Kernel 9 on ragged rows (5 x 37 = 185, not a multiple of its 64- or
    32-row tile) and on rows spanning more tiles than its persistent grid
    holds (40 x 256 = 10240 rows: 160 tiles of 64, or 320 of 32 at H=512, on
    132 CTAs), at the narrowest width, the classifier's and the widest."""
    gen = make_generator(150 + hidden + int(bf16))
    proj, norm, x = _input_case(gen, hidden, dev, batch=batch, steps=steps)
    before = kernels.launch_counts["input_block_fwd"]
    got = input_block_fused(proj, norm, x, bf16)
    again = input_block_fused(proj, norm, x, bf16)
    assert kernels.launch_counts["input_block_fwd"] == before + 2
    want = input_block_fused_plain(proj, norm, x, bf16)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= F32_TOL
    assert torch.equal(got, again)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("channels", [7, 64, 130])
def test_input_block_fwd_takes_any_channel_count(dev, bf16, channels):
    """C below the 16-wide mma step, C = kCP (the resident W's rows) and C =
    130 (three channel chunks, W and x staged per chunk)."""
    gen = make_generator(160 + channels)
    proj, norm, x = _input_case(gen, 96, dev, batch=3, steps=50, channels=channels)
    got = input_block_fused(proj, norm, x, bf16)
    want = input_block_fused_plain(proj, norm, x, bf16)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= F32_TOL
    assert torch.equal(got, input_block_fused(proj, norm, x, bf16))


def test_input_block_fwd_reads_an_unaligned_input(dev):
    gen = make_generator(170)
    proj, norm, x = _input_case(gen, 64, dev, batch=2, steps=9)
    flat = torch.empty(x.numel() + 1, device=dev)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    for bf16 in (False, True):
        assert torch.equal(input_block_fused(proj, norm, shifted, bf16),
                           input_block_fused(proj, norm, x, bf16))


@pytest.mark.parametrize("ln_parts", [(False, 1), (True, 1), (False, 2), (True, 2)])
@pytest.mark.parametrize("batch,steps", [(3, 100), (2, 256)])
def test_pool_head_bwd_f32_on_tensor_cores_matches_twin_and_repeats_bitwise(dev, ln_parts,
                                                                            batch, steps):
    """Kernel 8's float32 mode (3xTF32) at the classifier's widths (parts of
    256, K=256; one part of 256 and K=128), T not a multiple of its 32-row
    tile (T=100) and a whole number of tiles (T=256), with and without LN."""
    use_ln, n_parts = ln_parts
    gen = make_generator(180 + n_parts + 2 * int(use_ln))
    d_part, k = 256, 128 * n_parts
    d = d_part * n_parts
    ln = {"scale": 1 + 0.1 * _randn(gen, d, dev=dev), "bias": 0.1 * _randn(gen, d, dev=dev)}
    attn = {"proj": {"w": 0.05 * _randn(gen, d, k, dev=dev), "b": 0.1 * _randn(gen, k, dev=dev)},
            "score": {"w": 0.1 * _randn(gen, k, 1, dev=dev)}}
    xs = tuple(torch.tanh(_randn(gen, batch, steps, d_part, dev=dev)) for _ in range(n_parts))
    w = torch.softmax(_randn(gen, batch, steps, dev=dev), dim=-1)
    gs = 0.01 * _randn(gen, batch, steps, dev=dev)
    gc = tuple(0.1 * _randn(gen, batch, d_part, dev=dev) for _ in range(n_parts))
    gctx = 0.1 * _randn(gen, batch, dev=dev)
    args = (ln if use_ln else None, attn, xs, w, gs, gc, gctx, use_ln, False)
    before = kernels.launch_counts["pool_head_bwd"]
    got, again = pool_head_bwd(*args), pool_head_bwd(*args)
    assert kernels.launch_counts["pool_head_bwd"] == before + 2
    want = pool_head_bwd_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [t for t in out[1:] if t is not None]  # noqa: E731
    assert len(flat(got)) == len(flat(want)) == n_parts + (5 if use_ln else 3)
    for a, c in zip(flat(got), flat(want)):
        assert bool(torch.isfinite(a).all()) and _rel(a, c) <= POOL_TOL[False]
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


@pytest.mark.parametrize("d_part,k", [(512, 512), (512, 96)])
def test_pool_head_bwd_f32_takes_the_widths_of_hidden_512(dev, d_part, k):
    """D = 1024 (two parts of 512) with K = 512 (a hidden-512 classifier) and
    with K = 96: the 16-row tiles of the float32 mode."""
    gen = make_generator(190 + k)
    d = 2 * d_part
    batch, steps = 2, 45
    ln = {"scale": 1 + 0.1 * _randn(gen, d, dev=dev), "bias": 0.1 * _randn(gen, d, dev=dev)}
    attn = {"proj": {"w": 0.03 * _randn(gen, d, k, dev=dev), "b": 0.1 * _randn(gen, k, dev=dev)},
            "score": {"w": 0.1 * _randn(gen, k, 1, dev=dev)}}
    xs = tuple(torch.tanh(_randn(gen, batch, steps, d_part, dev=dev)) for _ in range(2))
    w = torch.softmax(_randn(gen, batch, steps, dev=dev), dim=-1)
    gs = 0.01 * _randn(gen, batch, steps, dev=dev)
    gc = tuple(0.1 * _randn(gen, batch, d_part, dev=dev) for _ in range(2))
    gctx = 0.1 * _randn(gen, batch, dev=dev)
    args = (ln, attn, xs, w, gs, gc, gctx, True, False)
    got, again, want = pool_head_bwd(*args), pool_head_bwd(*args), pool_head_bwd_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + list(out[1:])  # noqa: E731
    for a, c in zip(flat(got), flat(want)):
        assert _rel(a, c) <= POOL_TOL[False]
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


def test_pool_head_bwd_f32_rejects_widths_off_its_tiles(dev):
    for d, k in ((40, 64), (64, 40), (1056, 64), (64, 544)):
        x = torch.zeros(2, 5, d, device=dev)
        attn = {"proj": {"w": torch.zeros(d, k, device=dev), "b": torch.zeros(k, device=dev)},
                "score": {"w": torch.zeros(k, 1, device=dev)}}
        z2 = torch.zeros(2, 5, device=dev)
        with pytest.raises(ValueError, match="multiples of 32"):
            pool_head_bwd(None, attn, (x,), z2, z2, (torch.zeros(2, d, device=dev),),
                          torch.zeros(2, device=dev), False, False)


@pytest.mark.parametrize("hidden", [64, 256, 512])
@pytest.mark.parametrize("batch,steps", [(5, 37), (40, 256)])
def test_input_block_bwd_f32_on_tensor_cores_matches_twin_and_repeats_bitwise(dev, hidden,
                                                                              batch, steps):
    """Kernel 10's float32 mode (dx and dW in 3xTF32) on ragged rows (5 x 37
    = 185, not a multiple of its 32- or 16-row tile) and on rows spanning
    more tiles than its persistent grid holds (40 x 256 = 10240 rows: 320
    tiles of 32, or 640 of 16 at H=512, on 132 CTAs)."""
    gen = make_generator(200 + hidden)
    proj, norm, x = _input_case(gen, hidden, dev, batch=batch, steps=steps)
    dy = _randn(gen, batch, steps, hidden, dev=dev)
    before = kernels.launch_counts["input_block_bwd"]
    got = input_block_bwd(proj, norm, x, dy, False)
    again = input_block_bwd(proj, norm, x, dy, False)
    assert kernels.launch_counts["input_block_bwd"] == before + 2
    want = input_block_bwd_plain(proj, norm, x, dy, False)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all()) and _rel(a, w) <= F32_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("channels", [7, 61, 130])
def test_input_block_bwd_f32_takes_any_channel_count(dev, channels):
    """C below one 8-wide n-tile, the classifier's C = 61 and C = 130 (three
    channel chunks: a pass over the tiles per chunk)."""
    gen = make_generator(210 + channels)
    proj, norm, x = _input_case(gen, 96, dev, batch=3, steps=50, channels=channels)
    dy = _randn(gen, 3, 50, 96, dev=dev)
    got = input_block_bwd(proj, norm, x, dy, False)
    want = input_block_bwd_plain(proj, norm, x, dy, False)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.shape == w.shape and _rel(a, w) <= F32_REL_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, input_block_bwd(proj, norm, x, dy, False)))


def _pool_case(gen, d_part, k, n_parts, batch, steps, dev, w_scale=0.05):
    d = d_part * n_parts
    ln = {"scale": 1 + 0.1 * _randn(gen, d, dev=dev), "bias": 0.1 * _randn(gen, d, dev=dev)}
    attn = {"proj": {"w": w_scale * _randn(gen, d, k, dev=dev),
                     "b": 0.1 * _randn(gen, k, dev=dev)},
            "score": {"w": 0.1 * _randn(gen, k, 1, dev=dev)}}
    xs = tuple(torch.tanh(_randn(gen, batch, steps, d_part, dev=dev)) for _ in range(n_parts))
    return ln, attn, xs


@pytest.mark.parametrize("ln_parts", [(False, 1), (True, 1), (False, 2), (True, 2)])
@pytest.mark.parametrize("batch,steps", [(3, 100), (2, 256)])
def test_pool_head_fwd_f32_on_tensor_cores_matches_twin_and_repeats_bitwise(dev, ln_parts,
                                                                            batch, steps):
    """Kernel 7's float32 mode (3xTF32) at the classifier's widths (parts of
    256, K=256; one part of 256 and K=128), T not a multiple of its 32-row
    tile (T=100) and a whole number of tiles (T=256), with and without LN."""
    use_ln, n_parts = ln_parts
    gen = make_generator(220 + n_parts + 2 * int(use_ln))
    ln, attn, xs = _pool_case(gen, 256, 128 * n_parts, n_parts, batch, steps, dev)
    args = (ln if use_ln else None, attn, xs, use_ln, False)
    before = kernels.launch_counts["pool_head_fwd"]
    got, again = pool_head_fused(*args), pool_head_fused(*args)
    assert kernels.launch_counts["pool_head_fwd"] == before + 2
    want = pool_head_fused_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [out[1]]  # noqa: E731
    for a, c in zip(flat(got), flat(want)):
        assert bool(torch.isfinite(a).all()) and (a - c).abs().max().item() <= POOL_TOL[False]
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


@pytest.mark.parametrize("d_part,k", [(512, 512), (512, 96)])
def test_pool_head_fwd_f32_takes_the_widths_of_hidden_512(dev, d_part, k):
    """D = 1024 (two parts of 512) with K = 512 (a hidden-512 classifier) and
    with K = 96: the 16-row tiles of the float32 mode."""
    gen = make_generator(230 + k)
    ln, attn, xs = _pool_case(gen, d_part, k, 2, 2, 45, dev, w_scale=0.03)
    args = (ln, attn, xs, True, False)
    got, again, want = pool_head_fused(*args), pool_head_fused(*args), pool_head_fused_plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + [out[1]]  # noqa: E731
    for a, c in zip(flat(got), flat(want)):
        assert (a - c).abs().max().item() <= POOL_TOL[False]
    assert all(torch.equal(a, c) for a, c in zip(flat(got), flat(again)))


def test_pool_head_fwd_f32_rejects_widths_off_its_tiles(dev):
    for d, k in ((40, 64), (64, 40), (1056, 64), (64, 544)):
        x = torch.zeros(2, 5, d, device=dev)
        attn = {"proj": {"w": torch.zeros(d, k, device=dev), "b": torch.zeros(k, device=dev)},
                "score": {"w": torch.zeros(k, 1, device=dev)}}
        with pytest.raises(ValueError, match="multiples of 32"):
            pool_head_fused(None, attn, (x,), False, False)
        with pytest.raises(ValueError, match="multiples of 32"):
            attention_pool(x, attn["proj"]["w"], attn["proj"]["b"], attn["score"]["w"][:, 0])


def test_input_block_bwd_rejects_widths_off_its_tiles(dev):
    gen = make_generator(140)
    for channels, hidden, bf16 in ((65, 48, True), (61, 544, True), (61, 48, True),
                                   (61, 48, False), (61, 544, False)):
        proj, norm, x = _input_case(gen, hidden, dev, channels=channels)
        dy = torch.zeros(*x.shape[:2], hidden, device=dev)
        with pytest.raises(ValueError):
            input_block_bwd(proj, norm, x, dy, bf16)


# the six architecture variants of the ablation stage
# (eegflow_torch.analyze.ablation.ABLATION_CONFIGS): (bidirectional,
# use_attention, num_layers)
ABLATION_VARIANTS = {"Full Model": (True, True, 3), "No Attention": (True, False, 3),
                     "Unidirectional": (False, True, 3), "1 Layer": (True, True, 1),
                     "2 Layers": (True, True, 2), "Minimal": (False, False, 1)}


@pytest.mark.parametrize("hidden", [256, 512])
@pytest.mark.parametrize("variant", list(ABLATION_VARIANTS))
def test_ablation_variant_micro_step_matches_plain_path(dev, variant, hidden):
    """A bf16 micro-step of each ablation variant at H = 256 and 512 (the
    wide classes of kernels 7, 8 and 10 at 512): its launches (one LSTM
    forward and backward a layer and direction, the pool-head pair only with
    attention), the loss and every gradient against the plain path, and a
    bitwise repeat."""
    bidirectional, use_attention, num_layers = ABLATION_VARIANTS[variant]
    cfg = ModelConfig(input_size=61, hidden_size=hidden, num_layers=num_layers, dropout=0.4,
                      bidirectional=bidirectional, use_attention=use_attention)
    params = classifier_init(cfg, make_generator(9), device=dev, trainable=True)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((6, 40, 61)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, 6)).to(dev)
    masks = draw_dropout_masks(cfg, 6, 40, torch.Generator(device=dev).manual_seed(3), dev)
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
    lstm = num_layers * (2 if bidirectional else 1)
    want = {"input_block_fwd": 1, "input_block_bwd": 1, "lstm_fwd_train": lstm, "lstm_bwd": lstm}
    if use_attention:
        want.update(pool_head_fwd=1, pool_head_bwd=1)
    assert dict(kernels.launch_counts) == want
    loss_k2, grads_k2 = step("kernel")
    loss_p, grads_p = step("plain")
    assert abs(loss_k - loss_p) <= 1e-3 and loss_k == loss_k2
    for a, a2, c in zip(grads_k, grads_k2, grads_p):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, a2)
            if c.abs().max() > 0:
                assert _rel(a, c) <= STEP_REL_TOL


def test_cluster_plans_query_the_card(dev):
    """The plans of the main path's shapes: whole slices resident, the
    kernels' own shared memory (checked inside kernel_plan), clusters of 4
    CTAs for the bf16 kernels and of 8 for kernels 1 and 5, one wave where the
    card holds enough of them (kernel 1's eval at B=1024 may take two)."""
    from eegflow_torch.nn.cuda_lstm import kernel_plan
    for kind, batch, mode in (("fwd", 512, 1), ("fwd", 1024, 0), ("bwd", 512, 0),
                              ("bwd_dualdir", 512, 0), ("bwd_v2", 512, 0), ("rec", 512, 1),
                              ("rec", 512, 0), ("rec", 1024, 0), ("rec_bwd", 512, 0)):
        p = kernel_plan(kind, batch, 256, mode)
        assert p.hc == (8 if kind.startswith("rec") else 4) and p.resident and p.max_clusters >= 1
        assert p.waves == 1 or (kind, batch) == ("rec", 1024) and p.waves == 2


@pytest.mark.parametrize("batch", [1, 37, 90])
@pytest.mark.parametrize("n_points,substeps", [(40, 16), (7, 3)])
def test_apf_rk4_kernel_matches_twin_and_repeats_bitwise(dev, batch, n_points, substeps):
    """Kernel 11's three modes (trajectory, loss, loss with tangents) against
    the twin, populations that are not multiples of 32 included."""
    rng = np.random.default_rng(batch + n_points)
    k = torch.tensor(rng.uniform(0.01, 0.5, (batch, 6)), dtype=torch.float32)
    y0 = torch.tensor(rng.dirichlet([2.0, 2.0, 2.0], batch), dtype=torch.float32)
    obs = torch.tensor(rng.dirichlet([2.0, 2.0, 2.0], n_points), dtype=torch.float32)
    h = step_sizes(0.0, float(n_points - 1), n_points, substeps)
    kernels.reset_launch_counts()
    got = rk4_trajectory(y0.to(dev), k.to(dev), n_points, substeps, h)
    again = rk4_trajectory(y0.to(dev), k.to(dev), n_points, substeps, h)
    want = rk4_trajectory_plain(y0, k, n_points, substeps, h)
    assert (got.cpu() - want).abs().max().item() <= APF_TRAJ_TOL
    assert torch.equal(got, again)
    start = obs[0] / obs[0].sum()
    want_l, want_g = rk4_fit_loss_plain(k, start, obs, substeps, h, 1e-3, grad=True)
    args = (k.to(dev), start.to(dev), obs.to(dev), substeps, h, 1e-3)
    got_l, got_g = rk4_fit_loss(*args, grad=True)
    again_l, again_g = rk4_fit_loss(*args, grad=True)
    plain_l, none = rk4_fit_loss(*args)
    torch.cuda.synchronize()
    assert none is None and kernels.launch_counts["apf_rk4"] == 5
    assert rel_err(got_l.cpu(), want_l) <= APF_LOSS_REL_TOL
    assert rel_err(got_g.cpu(), want_g) <= APF_GRAD_REL_TOL
    assert torch.equal(got_l, again_l) and torch.equal(got_g, again_g)
    # the modes with and without tangents are two compilations of the loss
    assert rel_err(plain_l, got_l) <= APF_LOSS_REL_TOL
    with pytest.raises(ValueError, match="no gradient"):
        rk4_trajectory(y0.to(dev), k.to(dev).requires_grad_(), n_points, substeps, h)


def test_fit_ode_rates_on_the_card_recovers_rates_and_repeats(dev):
    from eegflow_torch.core.config import ODEConfig
    from eegflow_torch.fit import fit_ode_rates
    from eegflow_torch.ode.integrate import solve

    true = {"k_ap": 0.12, "k_af": 0.06, "k_pa": 0.25, "k_pf": 0.18, "k_fa": 0.09, "k_fp": 0.22}
    _, obs = solve([0.6, 0.25, 0.15], (0.0, 60.0), 60, k=rates_to_array(true, dev),
                   method="expm")
    cfg = ODEConfig(de_maxiter=150, reg_weight=0.0)
    fitted, fx, info = fit_ode_rates(obs.cpu().numpy(), np.linspace(0, 60, 60), cfg, dev)
    assert fx < 1e-5 and info["generations"] <= 150
    assert fit_ode_rates(obs.cpu().numpy(), np.linspace(0, 60, 60), cfg, dev) == \
        (fitted, fx, info)


def _de_fit_loss(dev, n_points, seed, substeps=16):
    """A fit loss on the card at ``n_points`` proportion points (a noisy
    trajectory of the ODE from the default rates), 16 substeps unless
    ``substeps`` says otherwise."""
    from eegflow_torch.fit import make_fit_loss
    from eegflow_torch.ode.integrate import solve

    _, traj = solve([0.6, 0.25, 0.15], (0.0, float(n_points - 1)), n_points,
                    k=rates_to_array(DEFAULT_RATES, dev), method="expm")
    noise = np.random.default_rng(seed).normal(0.0, 0.02, (n_points, 3))
    obs = np.clip(traj.cpu().numpy() + noise, 1e-3, 1.0)
    obs = (obs / obs.sum(axis=1, keepdims=True)).astype(np.float32)
    return make_fit_loss(obs, 0.0, float(n_points - 1), n_points, substeps=substeps, device=dev)


def _de_bounds(dev):
    from eegflow_torch.core.config import ODEConfig
    bounds = ODEConfig().bounds
    return (torch.tensor([b[0] for b in bounds], device=dev),
            torch.tensor([b[1] for b in bounds], device=dev))


# (popsize, points, generations, tol): the fit's shape for all 1,000
# generations; a population that converges (at most one of the chunks of 64
# and 7 has a boundary there); 64 and 7 not dividing 100 and 150
# generations; n = 18 and 90; n = 1,026 (popsize 171, 33 CTAs of the grid
# class, chunks of at most 63 by the draws' byte budget) and n = 3,000
# (popsize 500, 94 CTAs, chunks of 7), each run through and converging
@pytest.mark.parametrize("popsize,n_points,maxiter,tol", [(15, 513, 1000, 1e-7),
                                                          (15, 513, 600, 5e-2),
                                                          (3, 513, 100, 1e-7),
                                                          (3, 60, 150, 1e-7),
                                                          (171, 513, 150, 1e-7),
                                                          (171, 60, 1000, 5e-2),
                                                          (500, 513, 40, 1e-7),
                                                          (500, 60, 1000, 5e-2)])
@pytest.mark.parametrize("chunk", [64, 7])
def test_apf_de_mode_is_its_twin_bit_for_bit(dev, popsize, n_points, maxiter, tol, chunk,
                                             monkeypatch):
    """Kernel 11's DE mode against its twin, the loop of generations driving
    the loss mode on the same card: the same generations, best member and
    loss, bit for bit, and again on a second run, with one loss-mode launch
    and one DE launch a chunk run (``de_chunk_length``: ``DE_CHUNK``, or
    fewer under the draws' byte budget); the best loss is the loss mode's on
    the best member, bit for bit."""
    from eegflow_torch.fit import evolution
    from eegflow_torch.fit.evolution import _de_minimize, _de_minimize_chunked, de_chunk_length

    monkeypatch.setattr(evolution, "DE_CHUNK", chunk)
    chunk = de_chunk_length(popsize * 6)
    loss = _de_fit_loss(dev, n_points, popsize)
    lo, hi = _de_bounds(dev)

    def run(fn, **kw):
        gen = torch.Generator(device=dev)
        gen.manual_seed(42)
        with torch.no_grad():
            return fn(loss, gen, lo, hi, popsize, maxiter, tol, **kw)

    twin = run(_de_minimize)
    kernels.reset_launch_counts()
    got = run(_de_minimize_chunked)
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    again = run(_de_minimize_chunked)
    assert got[2] == twin[2] == again[2]
    assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    stopped = got[2] < maxiter
    chunks = got[2] // chunk + 1 if stopped else -(-maxiter // chunk)
    assert launches == {"apf_rk4": 1, "apf_de": chunks}
    assert stopped == (tol > 1e-3) and got[2] > 0
    with torch.no_grad():
        assert torch.equal(loss(got[0]), got[1])


def test_apf_de_mode_losses_are_the_loss_modes_bit_for_bit(dev):
    """After a chunk of the DE mode every member's loss (the first
    population's from the loss mode, each replacement's from the DE mode's
    trial) equals the loss mode's on the final population, bit for bit."""
    from eegflow_torch.fit.evolution import _draw_generations, _latin_hypercube
    from eegflow_torch.ode.cuda_ode import de_generations

    loss = _de_fit_loss(dev, 513, 1)
    lo, hi = _de_bounds(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pop = _latin_hypercube(gen, 90, lo, hi).contiguous()
    with torch.no_grad():
        fit = loss(pop).contiguous()
        first = pop.clone()
        status = de_generations(pop, fit, lo, hi, _draw_generations(gen, 90, 6, 20, dev),
                                loss.y0, loss.observed, loss.substeps, loss.steps,
                                loss.reg_weight, 1e-7)
        assert status.tolist() == [20, 0] and not torch.equal(pop, first)
        assert torch.equal(fit, loss(pop))


def test_fit_launches_the_de_mode_a_chunk(dev):
    """differential_evolution_fit with a FitLoss on the card: one loss-mode
    launch for the first population, one DE launch a chunk of 64
    generations, then the polish's evaluations (loss mode)."""
    from eegflow_torch.fit import differential_evolution_fit
    from eegflow_torch.fit.evolution import DE_CHUNK

    from eegflow_torch.core.config import ODEConfig

    loss = _de_fit_loss(dev, 60, 2)
    kernels.reset_launch_counts()
    _, _, info = differential_evolution_fit(loss, ODEConfig().bounds, maxiter=130, tol=0.0,
                                            polish=False)
    assert info["generations"] == 130 and DE_CHUNK == 64
    assert dict(kernels.launch_counts) == {"apf_rk4": 1, "apf_de": 3}
    differential_evolution_fit(loss, ODEConfig().bounds, maxiter=10, tol=0.0)
    assert kernels.launch_counts["apf_de"] == 4 and kernels.launch_counts["apf_rk4"] > 2


@pytest.mark.parametrize("popsize", [5, 171])
def test_apf_de_mode_takes_other_substeps_bit_for_bit(dev, popsize):
    """The DE mode at 3 substeps an interval (the step in a loop, not the
    fit's 16 unrolled) against the loop of generations on the loss mode, bit
    for bit, one DE launch a chunk."""
    from eegflow_torch.fit.evolution import _de_minimize, _de_minimize_chunked, de_chunk_length

    loss = _de_fit_loss(dev, 40, popsize, substeps=3)
    lo, hi = _de_bounds(dev)

    def run(fn):
        gen = torch.Generator(device=dev)
        gen.manual_seed(popsize)
        with torch.no_grad():
            return fn(loss, gen, lo, hi, popsize, 70, 1e-7)

    twin = run(_de_minimize)
    kernels.reset_launch_counts()
    got = run(_de_minimize_chunked)
    assert dict(kernels.launch_counts) == {"apf_rk4": 1,
                                           "apf_de": -(-70 // de_chunk_length(popsize * 6))}
    assert got[2] == twin[2] == 70
    assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])


@pytest.mark.parametrize("popsize", [171, 500])
def test_fit_runs_a_large_population_in_the_de_mode(dev, popsize):
    """differential_evolution_fit with a FitLoss on the card at popsize 171
    and 500 (n = 1,026 and 3,000, over the one-CTA class's 1,024): one
    loss-mode launch and one DE launch a chunk, nothing else, and the loop's
    generations, best member and loss bit for bit."""
    from eegflow_torch.core.config import ODEConfig
    from eegflow_torch.fit import differential_evolution_fit
    from eegflow_torch.fit.evolution import _de_minimize, de_chunk_length

    loss = _de_fit_loss(dev, 60, popsize)
    kernels.reset_launch_counts()
    x, fx, info = differential_evolution_fit(loss, ODEConfig().bounds, seed=5, popsize=popsize,
                                             maxiter=70, tol=0.0, polish=False)
    assert dict(kernels.launch_counts) == {"apf_rk4": 1,
                                           "apf_de": -(-70 // de_chunk_length(popsize * 6))}
    lo, hi = _de_bounds(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    with torch.no_grad():
        best, best_fit, gens = _de_minimize(loss, gen, lo, hi, popsize, 70, 0.0)
    assert info["generations"] == gens == 70
    assert np.array_equal(x, best.cpu().numpy().astype(np.float64)) and fx == float(best_fit)


def test_apf_de_plan_comes_from_c(dev, monkeypatch):
    """Kernel 11's DE launch as its C entry makes it
    (``eegflow_apf_de_plan``): a cooperative grid of 64-thread CTAs, 32
    members each, the card holding every CTA at once up to popsize 500 (at
    least one CTA an SM), and the scratch of the second population buffer,
    the CTAs' best candidates and the stop flags; a plan the card cannot
    hold raises before any launch."""
    from eegflow_torch.ode import cuda_ode

    for n, ctas in ((3, 1), (90, 3), (1024, 32), (1026, 33), (3000, 94)):
        for substeps in (16, 3):
            plan = cuda_ode.de_plan(n, substeps)
            assert (plan.ctas, plan.threads, plan.kernel) == (ctas, 64, "apf_de_grid_kernel")
            assert plan.scratch == 7 * n + 4 * ctas + 2 and plan.smem > 0
            assert plan.held >= max(132, ctas)
    loss = _de_fit_loss(dev, 20, 3)
    lo, hi = _de_bounds(dev)
    pop, fit = torch.full((90, 6), 0.1, device=dev), torch.ones(90, device=dev)
    draws = cuda_ode.GenerationDraws(torch.rand(1, device=dev), torch.rand(1, 90, 90, device=dev),
                                     torch.rand(1, 90, 6, device=dev),
                                     torch.zeros(1, 90, dtype=torch.int64, device=dev))
    real = cuda_ode.de_plan
    monkeypatch.setattr(cuda_ode, "de_plan", lambda n, s: real(n, s)._replace(held=2))
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="the card holds 2"):
        cuda_ode.de_generations(pop, fit, lo, hi, draws, loss.y0, loss.observed, loss.substeps,
                                loss.steps, loss.reg_weight, 1e-7)
    assert kernels.launch_counts["apf_de"] == 0


def test_apf_de_mode_rejects_what_it_does_not_take(dev):
    """A population under 3, a wrong dtype, a tensor on another device and
    draws of another shape raise; nothing falls back. A population over the
    one-CTA class's 1,024 runs in the grid class."""
    from eegflow_torch.fit.evolution import _draw_generations
    from eegflow_torch.ode.cuda_ode import de_generations

    loss = _de_fit_loss(dev, 20, 3)
    lo, hi = _de_bounds(dev)
    gen = torch.Generator(device=dev)

    def call(n, pop_dtype=torch.float32, lo_=lo, draws_n=None):
        pop = torch.full((n, 6), 0.1, dtype=pop_dtype, device=dev)
        fit = torch.ones(n, device=dev)
        draws = _draw_generations(gen, draws_n or n, 6, 2, dev)
        return de_generations(pop, fit, lo_, hi, draws, loss.y0, loss.observed, loss.substeps,
                              loss.steps, loss.reg_weight, 1e-7)

    assert call(1024).tolist() == [0, 1]  # one loss everywhere: converged at once
    assert call(1026).tolist() == [0, 1]
    with pytest.raises(ValueError, match="population"):
        call(2)
    with pytest.raises(ValueError, match="pop must be"):
        call(18, pop_dtype=torch.float64)
    with pytest.raises(ValueError, match="lo must be"):
        call(18, lo_=lo.cpu())
    with pytest.raises(ValueError, match="draws.u must be"):
        call(18, draws_n=24)


# (rows, samples, order, band): 8 sections at 8-30 Hz and fs 250, where the
# order-16 (b, a) still factors into stable sections (at 1-45 Hz and fs 500
# tf2sos gives a pole at |p| = 1.06, in the reference's design path too)
# kernel 12 stages 64 samples a chunk and takes 32 rows a CTA: lengths
# off the chunk (1000, 130, 3000) and under one (40), rows off the group (5,
# 33, 61, 70) and over one group (33, 61, 64, 70), 1 to 8 sections
@pytest.mark.parametrize("rows,samples,order,band", [(61, 3000, 4, (1.0, 45.0, 500.0)),
                                                     (5, 200, 2, (1.0, 45.0, 500.0)),
                                                     (70, 1000, 8, (8.0, 30.0, 250.0)),
                                                     (5, 40, 1, (1.0, 45.0, 500.0)),
                                                     (33, 130, 2, (1.0, 45.0, 500.0)),
                                                     (64, 128, 4, (1.0, 45.0, 500.0))])
def test_sos_filtfilt_kernel_matches_twin_and_scipy(dev, rows, samples, order, band):
    from scipy.signal import filtfilt

    rng = np.random.default_rng(rows)
    x = np.cumsum(rng.standard_normal((rows, samples)), axis=1)
    b, a = butter_bandpass(*band, order)
    sos, zi, padlen = _sos_design(b, a)
    xt = torch.tensor(x, dtype=torch.float32)
    kernels.reset_launch_counts()
    got = sos_filtfilt(xt.to(dev), sos, zi, padlen)
    again = filtfilt_iir(xt.to(dev), b, a)
    torch.cuda.synchronize()
    assert kernels.launch_counts["sos_filtfilt"] == 2
    want = sos_filtfilt_plain(xt, sos, zi, padlen)
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= SOS_REL_TOL * scale
    assert torch.equal(got, again)
    ref = filtfilt(b, a, x, axis=1)
    assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() < SOS_SCIPY_REL_TOL


def test_sos_filtfilt_rejects_what_it_does_not_take(dev):
    b, a = butter_bandpass(1.0, 45.0, 500.0, 4)
    sos, zi, padlen = _sos_design(b, a)
    with pytest.raises(ValueError, match="sections"):
        sos_filtfilt(torch.zeros(2, 100, device=dev), np.tile(sos, (3, 1)), np.tile(zi, (3, 1)),
                     padlen)
    assert 3 * len(sos) > MAX_SECTIONS
    with pytest.raises(ValueError, match="padlen"):
        sos_filtfilt(torch.zeros(2, padlen, device=dev), sos, zi, padlen)
    with pytest.raises(ValueError, match="float32"):
        sos_filtfilt(torch.zeros(2, 100, device=dev, dtype=torch.float64), sos, zi, padlen)


# the EEGFormer at a small width the kernels take (D = 64, K = 32)
TINY_TF = TransformerConfig(input_size=61, d_model=64, num_layers=2, num_heads=4, mlp_ratio=2,
                            dropout=0.3)


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "float32"])
def test_transformer_micro_step_matches_plain_path(dev, bf16):
    """A transformer micro-step launches kernels 9, 10, 7 and 8 once each and
    no LSTM kernel; its loss and every gradient against the plain path and a
    bitwise repeat."""
    params = classifier_init(TINY_TF, make_generator(21), device=dev, trainable=True)
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((6, 40, 61)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, 6)).to(dev)
    masks = draw_dropout_masks(TINY_TF, 6, 40, torch.Generator(device=dev).manual_seed(4), dev)
    names, leaves = zip(*params.named_parameters())

    def step(impl):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(params, x, TINY_TF, lstm_impl=impl, train=True, masks=masks,
                                  compute_dtype=torch.bfloat16 if bf16 else None)
        loss = cross_entropy_loss(logits, y)
        loss.backward()
        return loss.item(), [q.grad.clone() if q.grad is not None else None for q in leaves]

    kernels.reset_launch_counts()
    loss_k, grads_k = step("kernel")
    assert dict(kernels.launch_counts) == {"input_block_fwd": 1, "input_block_bwd": 1,
                                           "pool_head_fwd": 1, "pool_head_bwd": 1}
    loss_k2, grads_k2 = step("kernel")
    loss_p, grads_p = step("plain")
    assert abs(loss_k - loss_p) <= 1e-3 and loss_k == loss_k2
    for name, a, a2, c in zip(names, grads_k, grads_k2, grads_p):
        assert (a is None) == (c is None)
        if a is None:
            continue
        assert torch.equal(a, a2)
        if name.endswith("mha.key.b"):
            # zero by symmetry (softmax over the keys ignores it): rounding noise
            assert a.abs().max() <= 1e-7 and c.abs().max() <= 1e-7
        elif c.abs().max() > 0:
            assert _rel(a, c) <= (STEP_REL_TOL if bf16 else F32_REL_TOL), name


def test_transformer_eval_at_the_1024_bucket(dev):
    """An eval batch of 1,024 windows launches kernels 9 and 7 once each;
    the probabilities against the plain path, the attention a simplex."""
    params = classifier_init(TINY_TF, make_generator(22), device=dev)
    x = np.random.default_rng(22).standard_normal((1024, 64, 61)).astype(np.float32)
    model = CoupledModel(params, TINY_TF, rates_to_array(DEFAULT_RATES, dev), CouplingConfig(),
                         device=dev)
    kernels.reset_launch_counts()
    got = predict_batch(model, x, batch_size=1024)
    assert dict(kernels.launch_counts) == {"input_block_fwd": 1, "pool_head_fwd": 1}
    want = predict_batch(model, x, batch_size=1024, lstm_impl="plain")
    np.testing.assert_allclose(got["probs"], want["probs"], atol=2e-3, rtol=0)
    np.testing.assert_allclose(got["attention"].sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("family", ["lstm", "transformer"])
def test_resume_is_bitwise_on_the_card(dev, tmp_path, family):
    """A 2-epoch toy run interrupted after epoch 1 and resumed from its
    snapshot ends with the uninterrupted run's train state byte for byte."""
    from eegflow_torch.train.loop import train_classifier

    class Interrupted(Exception):
        pass

    def stop_at_epoch_1(xd, epoch):
        if epoch == 1:
            raise Interrupted
        return xd

    cfg = TINY_TF if family == "transformer" else ModelConfig(input_size=61, hidden_size=64,
                                                              num_layers=2)
    train = TrainConfig(epochs=2, batch_size=32, eval_batch_size=64, warmup_epochs=1,
                        augment=False)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((200, 40, 61)).astype(np.float32)
    y = rng.integers(0, 2, 200)
    args = (x[:160], y[:160], x[160:], y[160:], cfg, train)
    full = train_classifier(*args, device=dev, verbose=False, checkpoint_dir=tmp_path / "full",
                            checkpoint_every=1)
    with pytest.raises(Interrupted):
        train_classifier(*args, device=dev, verbose=False, checkpoint_dir=tmp_path / "cut",
                         checkpoint_every=1, epoch_transform=stop_at_epoch_1)
    resumed = train_classifier(*args, device=dev, verbose=False, resume_from=tmp_path / "cut",
                               checkpoint_dir=tmp_path / "resumed", checkpoint_every=1)
    assert ((tmp_path / "resumed" / "train_state.msgpack").read_bytes()
            == (tmp_path / "full" / "train_state.msgpack").read_bytes())
    assert resumed.history["train_loss"] == full.history["train_loss"]


# the data mesh on the card (tests/mesh_workers.py spawns the ranks): one
# micro-step's launches on the default bf16 "fused" path
STEP_LAUNCHES = {"input_block_fwd": 1, "input_block_bwd": 1, "lstm_fwd_train": 6,
                 "lstm_bwd": 6, "pool_head_fwd": 1, "pool_head_bwd": 1}
# two ranks against one process: as chip_smoke.py phase 23 (the head's
# weights' gradients are rounded to bf16 once a rank)
MESH_LOSS_TOL = 1e-3
MESH_GRAD_REL_TOL = 2e-3
MESH_BF16_GRAD_REL_TOL = 1e-2


def _mesh_case(**kw):
    return dict(seed=31, batch=64, steps=64, micro_steps=4, **kw)


def test_mesh_nccl_world_size_1_is_the_step_without_a_mesh_bit_for_bit(dev):
    import mesh_workers as mw

    (res,) = mw.spawn(mw.card_steps, _mesh_case(devices=None, backend=None), world=1)
    got, want = res["mesh"], res["single"]
    assert torch.equal(got["loss"], want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(got["grads"], want["grads"])
               if b is not None)
    assert torch.equal(got["params"][0], want["params"])
    assert got["launches"] == STEP_LAUNCHES
    assert res["eval_launches"] == {"input_block_fwd": 1, "lstm_fwd": 6, "pool_head_fwd": 1}


def test_mesh_two_gloo_ranks_on_one_card_match_the_single_process_step(dev):
    import mesh_workers as mw
    from eegflow_torch.core.config import ModelConfig as MC
    from eegflow_torch.nn.model import classifier_init as init

    ranks = mw.spawn(mw.card_steps, _mesh_case(devices=["cuda:0", "cuda:0"], backend="gloo"))
    got, want = ranks[0]["mesh"], ranks[0]["single"]
    assert abs(got["loss"].item() - want["loss"].item()) <= MESH_LOSS_TOL
    names = [n for n, _ in init(MC()).named_parameters()]
    for name, a, b in zip(names, got["grads"], want["grads"]):
        if b is None:
            continue
        tol = MESH_BF16_GRAD_REL_TOL if name in ("head1.w", "head2.w", "head3.w") \
            else MESH_GRAD_REL_TOL
        assert rel_err(a, b) <= tol, name
    for r in ranks:
        assert r["mesh"]["launches"] == STEP_LAUNCHES
        assert r["eval_launches"] == {"input_block_fwd": 1, "lstm_fwd": 6, "pool_head_fwd": 1}
        rows = r["mesh"]["params"]
        assert torch.equal(rows[0], rows[1])


# The in-kernel Philox dropout of kernels 2, 3 and 3b (kernel_dropout): each
# mode against its twin (which expands the key into uint8 masks), a bitwise
# repeat, and the same kernel on those expanded masks, bit for bit: the bit
# replaces the mask byte and nothing else changes. Streams above 0 and a row
# offset (a mesh rank's) on the reverse direction.
PHILOX_FWD = {"planes": (lstm_fwd_train, lstm_fwd_train_plain, "lstm_fwd_train"),
              "gates": (lstm_fwd_train_gates, lstm_fwd_train_gates_plain,
                        "lstm_fwd_train_gates")}


def _philox_case(seed, n_parts, batch, hidden, dev, d_part, steps, reverse):
    gen = make_generator(seed)
    w_ih, w_hh, b, xs, _, keep = _lstm_case(gen, n_parts, batch, hidden, dev, d_part=d_part,
                                            steps=steps)
    key = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=gen, dtype=torch.int32).to(dev)
    src = PhiloxSource(key, tuple(3 + p for p in range(n_parts)), batch if reverse else 0)
    return gen, w_ih, w_hh, b, xs, keep, src


def test_philox_twin_draws_the_same_bits_on_the_card_as_on_the_cpu(dev):
    key = torch.tensor([-123456789, 987654321], dtype=torch.int32)
    for stream, shape, offset in ((0, (17, 40, 61), 0), (5, (64, 7, 256), 64), (2, (3, 5, 37), 9)):
        want = philox_keep_mask(key, stream, shape, 0.6, offset)
        got = philox_keep_mask(key.to(dev), stream, shape, 0.6, offset)
        assert torch.equal(got.cpu(), want)


# the draw kernel's cases: (B, T, D) parts, their streams, the row offset;
# element counts that are not a multiple of 8 or 32, a part that does not
# start at a block of four (35 elements a row), a layer's two 256-wide parts,
# and two rows whose counter passes 2^32 (element 2^34 opens the second)
PHILOX_BITS_CASES = [((5, 7, 61), (0,), 0), ((2, 5, 7), (4,), 1), ((3, 40, 256), (1, 2), 3),
                     ((64, 256, 256), (3, 4), 0), ((2, 256, 256), (5,), 2 ** 34 // 65536 - 1)]


@pytest.mark.parametrize("shape,streams,row_offset", PHILOX_BITS_CASES)
def test_philox_keep_bits_kernel_is_its_twin_bit_for_bit(dev, shape, streams, row_offset):
    key = torch.tensor([-123456789, 987654321], dtype=torch.int32, device=dev)
    src = PhiloxSource(key, streams, row_offset)
    xs = tuple(torch.empty(shape, device=dev) for _ in streams)
    before = kernels.launch_counts["philox_keep_bits"]
    got = draw_keep_bits(src, xs, 0.7)
    assert kernels.launch_counts["philox_keep_bits"] == before + 1
    torch.cuda.synchronize()
    for plane, stream in zip(got.planes, streams):
        assert torch.equal(plane, philox_keep_bits(key, stream, shape, 0.7, row_offset))


def test_a_layers_drawn_planes_serve_both_directions_and_a_source_is_refused(dev):
    """Kernel 2 in both directions on planes drawn once equals kernel 2 on
    the source's expanded masks; planes drawn at another keep, and the
    source itself, are refused."""
    _, w_ih, w_hh, b, xs, keep, src = _philox_case(131, 2, 17, 256, dev, 48, 40, False)
    bits = draw_keep_bits(src, xs, keep)
    for reverse in (False, True):
        got = lstm_fwd_train(xs, w_ih, b, w_hh, reverse, bits, keep)
        want = lstm_fwd_train(xs, w_ih, b, w_hh, reverse, src.masks(xs, keep), keep)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    with pytest.raises(ValueError, match="keep"):
        lstm_fwd_train(xs, w_ih, b, w_hh, False, draw_keep_bits(src, xs, 0.5), keep)
    with pytest.raises(ValueError, match="draw_keep_bits"):
        lstm_fwd_train(xs, w_ih, b, w_hh, False, src, keep)


@pytest.mark.parametrize("res_bf16", [False, True])
@pytest.mark.parametrize("mode", list(PHILOX_FWD))
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden,steps,d_part", CLUSTER_CASES)
def test_cluster_lstm_fwd_philox_matches_twin_and_the_expanded_masks(
        dev, res_bf16, mode, n_parts, reverse, batch, hidden, steps, d_part):
    kfn, pfn, name = PHILOX_FWD[mode]
    _, w_ih, w_hh, b, xs, keep, src = _philox_case(110 + n_parts, n_parts, batch, hidden, dev,
                                                   d_part, steps, reverse)
    args = (xs, w_ih, b, w_hh, reverse, draw_keep_bits(src, xs, keep), keep)
    label = counter(name, res_bf16, philox=True)
    before = kernels.launch_counts[label]
    got, again = kfn(*args, res_bf16=res_bf16), kfn(*args, res_bf16=res_bf16)
    assert kernels.launch_counts[label] == before + 2
    want = pfn(*args, res_bf16=res_bf16)
    on_masks = kfn(*args[:5], src.masks(xs, keep), keep, res_bf16=res_bf16)
    torch.cuda.synchronize()
    for a, a2, w, m in zip(got, again, want, on_masks):
        tol = dict(atol=LSTM_TOL, rtol=RES16_RTOL if a.dtype == torch.bfloat16 else 0)
        torch.testing.assert_close(a.float(), w.float(), **tol)
        assert torch.equal(a, a2) and torch.equal(a, m)


@pytest.mark.parametrize("kernel", ["3", "3b"])
@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("batch,hidden,steps,d_part", CLUSTER_CASES)
def test_cluster_lstm_bwd_philox_matches_twin_and_the_expanded_masks(dev, kernel, n_parts,
                                                                     reverse, batch, hidden,
                                                                     steps, d_part):
    gen, w_ih, w_hh, b, xs, keep, src = _philox_case(120 + n_parts, n_parts, batch, hidden,
                                                     dev, d_part, steps, reverse)
    ms = src.masks(xs, keep)
    if kernel == "3b":
        h, gates, c = lstm_fwd_train_gates_plain(xs, w_ih, b, w_hh, reverse, ms, keep)
        kfn, pfn, res, name = lstm_bwd_v2, lstm_bwd_v2_plain, (gates, c), "lstm_bwd_v2"
    else:
        h, planes = lstm_fwd_train_plain(xs, w_ih, b, w_hh, reverse, ms, keep)
        kfn, pfn, res, name = lstm_bwd, lstm_bwd_plain, (planes,), "lstm_bwd"
    g = 0.1 * _randn(gen, *h.shape, dev=dev)
    add = tuple(_randn(gen, *x.shape, dev=dev) for x in xs) if reverse else None
    head, tail = (*res, h, g, xs, w_ih, w_hh, reverse), (keep, add)
    bits = draw_keep_bits(src, xs, keep)
    label = counter(name, philox=True)
    before = kernels.launch_counts[label]
    got, again = kfn(*head, bits, *tail), kfn(*head, bits, *tail)
    assert kernels.launch_counts[label] == before + 2
    want = pfn(*head, bits, *tail)
    on_masks = kfn(*head, ms, *tail)
    torch.cuda.synchronize()
    flat = lambda out: list(out[0]) + list(out[1:])  # noqa: E731
    for a, a2, w, m in zip(flat(got), flat(again), flat(want), flat(on_masks)):
        assert _rel(a, w) <= BWD_REL_TOL
        assert torch.equal(a, a2) and torch.equal(a, m)


@pytest.mark.parametrize("res_bf16", [False, True])
@pytest.mark.parametrize("lstm_bwd", ["fused", "two_pass"])
def test_training_micro_step_philox_is_the_mask_path_on_the_expanded_masks(dev, lstm_bwd,
                                                                           res_bf16):
    cfg = ModelConfig(input_size=7, hidden_size=64, num_layers=3)
    params = classifier_init(cfg, make_generator(8), device=dev, trainable=True)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((9, 32, 7)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, 9)).to(dev)
    masks = draw_dropout_masks(cfg, 9, 32, torch.Generator(device=dev).manual_seed(3), dev,
                               kernel_dropout=True)
    expanded = expand_dropout_masks(masks, cfg, 9, 32)
    leaves = list(params.parameters())

    def step(impl, m, kernel_dropout):
        for q in leaves:
            q.grad = None
        logits = classifier_apply(params, x, cfg, compute_dtype=torch.bfloat16, lstm_impl=impl,
                                  train=True, masks=m, lstm_bwd=lstm_bwd, res_bf16=res_bf16,
                                  kernel_dropout=kernel_dropout)
        loss = cross_entropy_loss(logits, y)
        loss.backward()
        return loss.detach(), [q.grad.clone() if q.grad is not None else None for q in leaves]

    kernels.reset_launch_counts()
    loss_k, grads_k = step("kernel", masks, True)
    assert dict(kernels.launch_counts) == train_step_launches(cfg, lstm_bwd, res_bf16,
                                                              kernel_dropout=True)
    loss_m, grads_m = step("kernel", expanded, False)
    loss_p, grads_p = step("plain", masks, True)
    assert torch.equal(loss_k, loss_m) and abs(loss_k.item() - loss_p.item()) <= 1e-3
    for a, m, c in zip(grads_k, grads_m, grads_p):
        assert (a is None) == (m is None) == (c is None)
        if a is not None:
            assert torch.equal(a, m)
            assert _rel(a, c) <= STEP_REL_TOL
