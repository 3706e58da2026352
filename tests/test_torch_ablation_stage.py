"""The port's ablation stage against the JAX package's on the CPU at a tiny
size: ``run_architecture_ablation`` on the toy set that
``tests/test_ablation.py`` learns, the statistics computed on the port's
predictions by both packages, and the ``ablate`` CLI stage of both packages
on one archive, each reading the other's JSON."""

import numpy as np
import pytest
import torch

from eegflow.analyze import ablation as jabl
from eegflow.cli.main import main as jax_cli_main
from eegflow.core import artifacts as jart
from eegflow_torch.analyze import ablation as tabl
from eegflow_torch.cli.main import main as cli_main
from figure_records import figure_files, patch_figures
from eegflow_torch.core import artifacts as tart
from torch_threads import one_torch_thread  # noqa: F401

T, C = 16, 4
STAGE_FILES = ["results_tables.txt", "sensitivity_analysis.json"]


@pytest.fixture(scope="module")
def toy():
    """tests/test_ablation.py's separable toy set (its rng fixture's seed)."""
    rng = np.random.default_rng(42)
    n, t, c = 256, 32, 4
    y = (rng.random(n) > 0.5).astype(np.int64)
    x = rng.standard_normal((n, t, c)).astype(np.float32)
    wave = np.sin(2 * np.pi * np.arange(t) / 8.0).astype(np.float32)
    x[y == 1] += 2.0 * wave[None, :, None]
    return x[:192], y[:192], x[192:], y[192:]


@pytest.fixture(scope="module")
def port_ablation(toy):
    """The port's ablation on the toy set with tests/test_ablation.py's
    settings, on the CPU."""
    x_tr, y_tr, x_te, y_te = toy
    # 450 steps of a 16-unit model: per-operation work too small to share out,
    # so one thread, not one per core of the cores the test workers share
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    configs = [
        {"name": "Full Model", "bidirectional": True, "use_attention": True, "num_layers": 2},
        {"name": "No Attention", "bidirectional": True, "use_attention": False, "num_layers": 2},
        {"name": "Unidirectional", "bidirectional": False, "use_attention": True,
         "num_layers": 2},
        {"name": "1 Layer", "bidirectional": True, "use_attention": True, "num_layers": 1},
        {"name": "Minimal", "bidirectional": False, "use_attention": False, "num_layers": 1},
    ]
    try:
        results, predictions = tabl.run_architecture_ablation(
            x_tr, y_tr, x_te, y_te, hidden_size=16, epochs=15, configs=configs, bf16=False,
            batch_size=32, lr=3e-3, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return results, predictions, y_te


def test_port_ablation_learns_the_toy_set(port_ablation):
    results, predictions, y_te = port_ablation
    assert list(results) == list(predictions) == ["Full Model", "No Attention",
                                                  "Unidirectional", "1 Layer", "Minimal"]
    for name, r in results.items():
        assert set(r["metrics"]) == {"accuracy", "f1", "mcc"}
        assert predictions[name].shape == y_te.shape
    assert results["Full Model"]["metrics"]["accuracy"] > 0.8


def test_statistics_on_the_ports_predictions_match_the_reference(port_ablation):
    results, predictions, y_te = port_ablation
    np.testing.assert_equal(tabl.run_statistical_comparison(y_te, predictions),
                            jabl.run_statistical_comparison(y_te, predictions))
    np.testing.assert_equal(tabl.compute_bootstrap_intervals(y_te, predictions, 200),
                            jabl.compute_bootstrap_intervals(y_te, predictions, 200))
    assert (tabl.analyze_component_contribution(results)
            == jabl.analyze_component_contribution(results))


def _shape(obj):
    """The key structure of a JSON document (dict keys, list lengths)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__ if obj is None else "value"


def test_ablate_stage_writes_what_the_reference_writes(tmp_path, monkeypatch):
    """``ablate --epochs 1 --hidden 32`` of both packages on one tiny archive
    (with the ``coupling_analysis.json`` that ``integrate`` writes): the same
    files and JSON structure, each package reads the other's file, and both
    draw fig25 from the same variants (recorded, not rasterised)."""
    rec = patch_figures(monkeypatch)
    rng = np.random.default_rng(3)
    arrays = {}
    for split, n in (("train", 24), ("val", 8), ("test", 30)):
        y = np.arange(n) % 2
        x = rng.standard_normal((n, T, C)).astype(np.float32)
        x[:, :, 0] += (y - 0.5).astype(np.float32)[:, None]
        arrays[f"X_{split}"], arrays[f"y_{split}"] = x, y.astype(np.int64)
    coupling = {"alphas": [0.0, 0.5], "accuracy": [0.5, 0.6]}
    for pkg in ("jax", "port"):
        jart.save_processed(tmp_path / pkg / "processed_data", arrays, {})
        jart.save_results(tmp_path / pkg / "results" / "coupling_analysis.json", coupling)
    argv = ["ablate", "--epochs", "1", "--hidden", "32"]
    assert jax_cli_main(["--output-dir", str(tmp_path / "jax")] + argv) in (0, None)
    assert cli_main(["--output-dir", str(tmp_path / "port")] + argv + ["--device", "cpu"]) == 0
    for name in STAGE_FILES:
        assert (tmp_path / "port" / "results" / name).exists(), name
        assert (tmp_path / "jax" / "results" / name).exists(), name
    jax_json = tmp_path / "jax" / "results" / "sensitivity_analysis.json"
    port_json = tmp_path / "port" / "results" / "sensitivity_analysis.json"
    want, got = jart.load_results(jax_json), tart.load_results(port_json)
    assert list(got) == ["ablation", "statistical_comparison", "bootstrap_cis",
                         "component_contributions", "coupling_sensitivity"]
    assert _shape(got) == _shape(want)
    assert got["coupling_sensitivity"] == coupling
    assert jart.load_results(port_json) == got
    assert _shape(tart.load_results(jax_json)) == _shape(want)
    for key in ("jax", "port"):
        assert figure_files(tmp_path / key) == ["fig25_ablation.pdf", "fig25_ablation.png"]
        (name, (results, cis, path), _), = rec[key]["calls"]
        assert name == "plot_ablation_results" and path == "fig25_ablation"
        assert list(results) == list(want["ablation"]) and list(cis) == list(results)
    tables = (tmp_path / "port" / "results" / "results_tables.txt").read_text()
    assert "Architecture ablation" in tables and "Statistical comparison" in tables
