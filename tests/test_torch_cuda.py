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
from eegflow_torch.nn.cuda_attention import (pool_head_bwd, pool_head_bwd_plain,
                                             pool_head_fused, pool_head_fused_plain)
from eegflow_torch.nn.cuda_lstm import (lstm_bwd, lstm_bwd_plain, lstm_fwd_fused_proj,
                                        lstm_fwd_fused_proj_plain, lstm_fwd_train,
                                        lstm_fwd_train_plain)
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
    want = predict_batch(model, x, lstm_impl="plain")
    np.testing.assert_allclose(got["probs"], want["probs"], atol=LSTM_TOL, rtol=0)
    with pytest.raises(NotImplementedError):
        classifier_apply(params, torch.from_numpy(x).to(dev), cfg, lstm_impl="kernel")


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


@pytest.mark.parametrize("use_ln", [True, False])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_pool_head_bwd_kernel_matches_twin_and_repeats_bitwise(dev, n_parts, use_ln):
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
    args = (ln if use_ln else None, attn, xs, w, gs, gc, gctx, use_ln, True)
    got, again, want = pool_head_bwd(*args), pool_head_bwd(*args), pool_head_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, c in zip(got[0], want[0]):
        assert _rel(a, c) <= POOL_TOL[True]
    for a, c in zip(got[1:], want[1:]):
        assert (a is None) == (c is None) and (a is None or _rel(a, c) <= POOL_TOL[True])
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
    assert kernels.launch_counts["lstm_fwd_train"] == 4
    assert kernels.launch_counts["lstm_bwd"] == 4
    assert kernels.launch_counts["pool_head_fwd"] == 1
    assert kernels.launch_counts["pool_head_bwd"] == 1
    loss_k2, grads_k2 = step("kernel")
    loss_p, grads_p = step("plain")
    assert abs(loss_k - loss_p) <= 1e-3 and loss_k == loss_k2
    for a, a2, c in zip(grads_k, grads_k2, grads_p):
        assert (a is None) == (c is None)
        if a is not None:
            assert torch.equal(a, a2)
            assert _rel(a, c) <= STEP_REL_TOL
