"""The float64 functions of the bf16 backward kernels
(``eegflow_torch.kernels.ablate``: ``lstm_bwd_f64``, ``lstm_bwd_v2_f64``,
``lstm_bwd_dualdir_f64``, ``pool_head_bwd_f64``, ``input_block_bwd_f64``),
which the card holds kernels 3, 3b, 4, 8 and 10 to at B = 1: here, on the
CPU at small shapes, each against its kernel's twin (the same bf16
roundings, float32 elsewhere). No JAX: the twins are held to the reference
in their own files."""

import pytest
import torch

from eegflow_torch.core.prng import make_generator
from eegflow_torch.kernels import ablate
from eegflow_torch.nn import cuda_lstm as cl
from eegflow_torch.nn.cuda_attention import pool_head_bwd_plain
from eegflow_torch.nn.cuda_input import input_block_bwd_plain
from torch_threads import one_torch_thread  # noqa: F401

# a twin against its float64 function: float32 rounding of every value
# between the bf16 roundings, and a bf16 tie that the float32 side rounds the
# other way (the card tests' BWD_REL_TOL)
BWD_REL_TOL = 5e-3
CPU = torch.device("cpu")


def _worst(got, want):
    assert len(got) == len(want)
    errs = []
    for a, c in zip(got, want):
        assert a.shape == c.shape and a.dtype == torch.float32 and c.dtype == torch.float64
        errs.append(((a.double() - c).abs().max() / c.abs().max()).item())
    return max(errs)


def _flat(out):
    return list(out[0]) + [t for part in out[1:]
                           for t in (part if isinstance(part, tuple) else (part,))
                           if t is not None]


@pytest.mark.parametrize("widths", [(16,), (16, 24)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("keep", [1.0, 0.7])
def test_kernel_3s_and_3bs_twins_are_their_float64_functions(widths, reverse, keep):
    gen = make_generator(31 + len(widths) + int(reverse) + int(10 * keep))
    xs, (w, b, whh), _, g, _ = ablate.lstm_bwd_case(gen, 32, widths, 3, 17, CPU)
    masks = None if keep == 1.0 else tuple(torch.rand(x.shape, generator=gen) < keep
                                           for x in xs)
    h, res = cl.lstm_fwd_train_plain(xs, w, b, whh, reverse, masks, keep)
    want = ablate.lstm_bwd_f64(res, h, g, xs, w, whh, reverse, masks, keep)
    assert _worst(_flat(cl.lstm_bwd_plain(res, h, g, xs, w, whh, reverse, masks, keep)),
                  _flat(want)) <= BWD_REL_TOL
    h, gates, c = cl.lstm_fwd_train_gates_plain(xs, w, b, whh, reverse, masks, keep)
    want = ablate.lstm_bwd_v2_f64(gates, c, h, g, xs, w, whh, reverse, masks, keep)
    got = cl.lstm_bwd_v2_plain(gates, c, h, g, xs, w, whh, reverse, masks, keep)
    assert _worst(_flat(got), _flat(want)) <= BWD_REL_TOL


def test_kernel_4s_twin_is_its_float64_function():
    gen = make_generator(40)
    xs, (wf, bf, hf), (wr, br, hr), g_f, g_r = ablate.lstm_bwd_case(gen, 32, (16, 16), 2, 19,
                                                                   CPU)
    h_f, res_f = cl.lstm_fwd_train_plain(xs, wf, bf, hf)
    h_r, res_r = cl.lstm_fwd_train_plain(xs, wr, br, hr, True)
    args = (res_f, h_f, g_f, res_r, h_r, g_r, xs, (wf, hf), (wr, hr))
    want = ablate.lstm_bwd_dualdir_f64(*args)
    assert _worst(_flat(cl.lstm_bwd_dualdir_plain(*args)), _flat(want)) <= BWD_REL_TOL
    # it is the two directions' float64 functions, dx summed
    f = ablate.lstm_bwd_f64(res_f, h_f, g_f, xs, wf, hf)
    r = ablate.lstm_bwd_f64(res_r, h_r, g_r, xs, wr, hr, reverse=True)
    assert all(torch.equal(a, b + c) for a, b, c in zip(want[0], f[0], r[0]))
    assert all(torch.equal(a, b) for a, b in zip(want[1] + want[2], f[1:] + r[1:]))


@pytest.mark.parametrize("use_ln", [False, True])
def test_kernel_8s_narrow_twin_is_its_float64_function(use_ln):
    gen = make_generator(50 + int(use_ln))
    ln, attn, xs, grads = ablate.wide_head_case(gen, (32, 32), 16, 2, 23, CPU)
    args = (ln if use_ln else None, attn, xs, *grads, use_ln)
    want = ablate.pool_head_bwd_f64(*args)
    assert _worst(_flat(pool_head_bwd_plain(*args, True)), want) <= BWD_REL_TOL


@pytest.mark.parametrize("hidden", [32, 64])
def test_kernel_10s_twin_is_its_float64_function(hidden):
    gen = make_generator(60 + hidden)
    proj, norm = ablate._input_params(gen, 13, hidden, CPU)
    x = torch.randn(2, 21, 13, generator=gen)
    dy = torch.randn(2, 21, hidden, generator=gen)
    want = ablate.input_block_bwd_f64(proj, norm, x, dy)
    assert _worst(list(input_block_bwd_plain(proj, norm, x, dy, True)), list(want)) <= BWD_REL_TOL
