"""eegflow_torch's host helpers against the JAX package's, on the CPU: the
wall-clock spans (``core/timing.py``), the metrics registry
(``core/registry.py``), the residual block (``nn/layers.py``), ``train
--profile`` (a ``torch.profiler`` Chrome trace) and the lazy import of the
figures (no matplotlib until a figure is drawn)."""

import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.core import registry as jax_registry
from eegflow.core.artifacts import save_processed
from eegflow.nn import layers as jax_layers
from eegflow_torch.cli.main import main as cli_main
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import Timer, registry, timed
from eegflow_torch.core.timing import GLOBAL_TIMER, torch_trace
from eegflow_torch.nn import layers

ROOT = Path(__file__).resolve().parents[1]
HIDDEN = 16
# eval mode, float32: the same operations, sums in another order
BLOCK_F32_TOL = 1e-6
# bf16 operands: a float32 rounding difference in the GELU output can round
# the other way to bf16 before fc2 (2^-8 relative on that operand, ~3e-3 on
# one unit before the LayerNorm at this width); measured 4.8e-7 over 20 seeds
BLOCK_BF16_TOL = 1e-2


def test_timer_registry():
    """tests/test_core.py::test_timer_registry on the port's Timer."""
    timer = Timer()

    @timed("work", timer)
    def work():
        return 1

    work()
    work()
    s = timer.summary()["work"]
    assert s["count"] == 2 and s["total_s"] >= 0


def test_timer_spans_nest_and_default_to_the_global_timer():
    timer = Timer()
    with timer.span("outer"):
        with timer.span("inner"):
            time.sleep(0.01)
    assert timer.total("outer") >= timer.total("inner") >= 0.01
    assert timer.total("absent") == 0

    @timed()
    def helper():
        return 2

    n = len(GLOBAL_TIMER.spans.get(helper.__qualname__, []))
    assert helper() == 2 and helper.__name__ == "helper"
    assert len(GLOBAL_TIMER.spans[helper.__qualname__]) == n + 1


LABELS = [
    (np.array([0, 1, 1, 0, 1]), np.array([0, 1, 0, 0, 1]), np.array([0.1, 0.9, 0.4, 0.2, 0.8])),
    (np.array([1, 1, 1, 1]), np.array([1, 0, 1, 1]), np.array([0.7, 0.3, 0.9, 0.6])),
    (np.array([0, 0, 1, 1, 0, 1]), np.array([1, 1, 0, 0, 1, 0]), None),
    (np.array([], int), np.array([], int), np.array([])),
]


@pytest.mark.parametrize("case", range(len(LABELS)))
def test_compute_metrics_matches_the_jax_registry(case):
    y_true, y_pred, y_prob = LABELS[case]
    assert registry.available_metrics() == jax_registry.available_metrics()
    names = registry.available_metrics()
    if not len(y_true):
        names = ["accuracy"]
    got = registry.compute_metrics(names, y_true, y_pred, y_prob)
    want = jax_registry.compute_metrics(names, y_true, y_pred, y_prob)
    assert list(got) == names
    np.testing.assert_equal(got, want)


def test_registry_lookup_and_registration():
    """tests/test_core.py::test_metrics_registry, then a metric of one's own."""
    y_true = np.array([0, 1, 1, 0, 1])
    y_pred = np.array([0, 1, 0, 0, 1])
    y_prob = np.array([0.1, 0.9, 0.4, 0.2, 0.8])
    out = registry.compute_metrics(["accuracy", "f1", "auc", "mcc"], y_true, y_pred, y_prob)
    assert out["accuracy"] == 0.8
    assert 0 < out["f1"] <= 1 and 0 <= out["auc"] <= 1
    with pytest.raises(KeyError, match="unknown metric"):
        registry.get_metric("nope")

    @registry.register_metric("errors")
    def _errors(y_true, y_pred, y_prob=None):
        return int((np.asarray(y_true) != np.asarray(y_pred)).sum())

    try:
        assert registry.compute_metrics(["errors"], y_true, y_pred) == {"errors": 1}
        assert "errors" in registry.available_metrics()
    finally:
        del registry._REGISTRY["errors"]


def _block(seed=0):
    jparams = jax_layers.residual_block_init(jax.random.key(seed), HIDDEN)
    x = np.random.default_rng(seed).standard_normal((6, HIDDEN)).astype(np.float32)
    return jparams, params_from_jax(jparams, torch.device("cpu")), x


@pytest.mark.parametrize("bf16", [False, True])
def test_residual_block_eval_matches_the_jax_block(bf16):
    jparams, params, x = _block()
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = np.asarray(jax_layers.residual_block_apply(jparams, jnp.asarray(x),
                                                      compute_dtype=jdt))
    got = layers.residual_block_apply(params, torch.from_numpy(x), compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BLOCK_BF16_TOL if bf16 else BLOCK_F32_TOL)
    # without masks, train mode applies no dropout, as the JAX block without a key
    np.testing.assert_array_equal(
        layers.residual_block_apply(params, torch.from_numpy(x), train=True,
                                    compute_dtype=tdt).numpy(), got.numpy())


def test_residual_block_params_carry_across():
    jparams, params, _ = _block(3)
    assert set(params) == {"fc1", "fc2", "norm"}
    for name in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(params[name][leaf].numpy(),
                                          np.asarray(jparams[name][leaf]))
    init = layers.residual_block_init(torch.Generator().manual_seed(0), HIDDEN)
    assert init["fc1"]["w"].shape == (HIDDEN, HIDDEN)
    assert init["fc1"]["w"].abs().max() <= HIDDEN ** -0.5
    np.testing.assert_array_equal(init["norm"]["scale"].numpy(), np.ones(HIDDEN))


def test_residual_block_train_mode_is_its_formula_with_explicit_masks():
    _, params, x = _block(1)
    rate = 0.3
    gen = torch.Generator().manual_seed(5)
    xt = torch.from_numpy(x)
    masks = [layers.dropout_mask(gen, rate, xt.shape) for _ in range(2)]
    got = layers.residual_block_apply(params, xt, rate, masks, train=True)
    h = torch.nn.functional.gelu(xt @ params["fc1"]["w"] + params["fc1"]["b"])
    h = torch.where(masks[0], h / (1 - rate), 0.0)
    h = h @ params["fc2"]["w"] + params["fc2"]["b"]
    h = torch.where(masks[1], h / (1 - rate), 0.0) + xt
    want = (h - h.mean(-1, keepdim=True)) / torch.sqrt(h.var(-1, unbiased=False,
                                                              keepdim=True) + 1e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert not torch.allclose(got, layers.residual_block_apply(params, xt))
    # eval mode ignores the masks; the LayerNorm output has zero mean per row
    np.testing.assert_array_equal(layers.residual_block_apply(params, xt, rate, masks).numpy(),
                                  layers.residual_block_apply(params, xt).numpy())
    np.testing.assert_allclose(got.mean(-1).numpy(), 0.0, atol=1e-5)
    # the keep share of the port's generator at this rate
    keep = layers.dropout_mask(torch.Generator().manual_seed(9), rate, (200_000,))
    assert abs(keep.float().mean().item() - (1 - rate)) < 5e-3


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_torch_trace_is_a_no_op_without_a_directory(device):
    with torch_trace(None, device):  # no profiler starts, so no card is needed
        assert not torch.autograd._profiler_enabled()


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    out = tmp_path_factory.mktemp("profile")
    rng = np.random.default_rng(0)
    arrays = {}
    for split, n in (("train", 32), ("val", 8), ("test", 8)):
        arrays[f"X_{split}"] = rng.standard_normal((n, 16, 3)).astype(np.float32)
        arrays[f"y_{split}"] = (np.arange(n) % 2).astype(np.int64)
    save_processed(out / "processed_data", arrays, {})
    (out / "cfg.json").write_text(json.dumps({
        "model": {"hidden_size": 8, "num_layers": 1},
        "train": {"batch_size": 16, "eval_batch_size": 16, "accumulation_steps": 1,
                  "bf16": False, "augment": False, "warmup_epochs": 1}}))
    return out


@pytest.mark.parametrize("profile", [True, False])
def test_train_profile_writes_a_chrome_trace(processed, tmp_path, monkeypatch, profile):
    """``train --profile DIR --device cpu`` writes one Chrome trace that
    parses and holds the training's operators; without ``--profile`` no
    trace directory is made."""
    from figure_records import patch_figures

    patch_figures(monkeypatch)
    trace_dir = tmp_path / "trace"
    argv = ["--output-dir", str(processed), "--config", str(processed / "cfg.json"),
            "train", "--epochs", "1", "--device", "cpu"]
    assert cli_main(argv + (["--profile", str(trace_dir)] if profile else [])) == 0
    if not profile:
        assert not trace_dir.exists()
        return
    traces = list(trace_dir.glob("torch_trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert any("lstm" in n.lower() or "mm" in n for n in names)


def test_imports_leave_matplotlib_out():
    """Importing the port, its plotting package, its figures module, its CLI
    and the explain summary (which reads the regions) imports no matplotlib."""
    code = ("import sys, eegflow_torch, eegflow_torch.viz, eegflow_torch.viz.figures, "
            "eegflow_torch.cli.main, eegflow_torch.explain.summary; "
            "print(sorted(n for n in sys.modules if n.split('.')[0] == 'matplotlib'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
