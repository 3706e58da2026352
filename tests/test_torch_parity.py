"""eegflow_torch's parity module and stage (``analyze/parity.py``, ``parity``)
against the JAX package's: the report, its table and the dataset audit on
the same inputs, and ``parity --synthetic`` end to end on the CPU at the JAX
package's own test configuration (tests/test_pipeline.py)."""

import functools
import json

import pytest
import torch

from eegflow.analyze import parity as jpar
from eegflow_torch.analyze import parity as tpar
from eegflow_torch.baselines import classical as tcls
from eegflow_torch.cli.main import main as cli_main
from eegflow_torch.core.config import (DataConfig, ModelConfig, ODEConfig, PipelineConfig,
                                       TrainConfig)
from eegflow_torch.data.synthetic import generate_synthetic_dataset
from figure_records import STAGE_FIGURES, figure_files, patch_figures
from torch_threads import one_torch_thread  # noqa: F401

MEASURED = {
    "svm": {"accuracy": 0.381, "f1": 0.1, "auc": 0.5},
    "random_forest": {"accuracy": 0.6123456, "f1": 0.5, "auc": 0.7},
    "gradient_boosting": {"accuracy": 0.62, "f1": 0.63},
    "lstm_attention": {"accuracy": 0.549, "f1": 0.603, "auc": 0.596},
    "lstm_ode_integration": {"f1": 0.599},
    "not_in_the_table": {"accuracy": 0.9},
}


def test_the_published_table_is_the_jax_packages():
    assert tpar.REFERENCE_RESULTS == jpar.REFERENCE_RESULTS
    assert tpar.MODEL_KEYS == jpar.MODEL_KEYS
    assert tpar.PARITY_TOLERANCE_PP == jpar.PARITY_TOLERANCE_PP


@pytest.mark.parametrize("comparable", [True, False])
@pytest.mark.parametrize("measured", [MEASURED, {k: MEASURED[k] for k in ("svm",)}, {}],
                         ids=["mixed", "within", "empty"])
def test_report_and_table_match_jax(measured, comparable):
    got = tpar.compare_to_reference(measured, comparable=comparable)
    assert got == jpar.compare_to_reference(measured, comparable=comparable)
    assert tpar.format_parity_table(got) == jpar.format_parity_table(got)
    if not comparable:
        assert "NOT COMPARABLE" in got["verdict"]


def test_report_with_another_tolerance_matches_jax():
    got = tpar.compare_to_reference(MEASURED, tolerance_pp=1.5)
    assert got == jpar.compare_to_reference(MEASURED, tolerance_pp=1.5)
    assert got["models"]["random_forest"]["accuracy_within_tolerance"]


def _partial_tree(root):
    """One real subject and an annex placeholder of the second's, as the JAX
    package's test builds it."""
    generate_synthetic_dataset(root, n_subjects=1, duration_s=2.0, n_channels=4)
    stub = root / "sub-02" / "ses-session1" / "eeg" / "sub-02_ses-session1_task-eyesopen_eeg.vhdr"
    stub.parent.mkdir(parents=True)
    stub.write_text("annex stub")
    eeg = stub.with_suffix(".eeg")
    eeg.write_bytes(b"x" * 100)
    stub.with_suffix(".vmrk").write_text("not a marker file")
    return root


@pytest.mark.parametrize("n_subjects", [30, 2, None])
def test_audit_of_a_partial_tree_matches_jax(tmp_path, n_subjects):
    root = _partial_tree(tmp_path / "data")
    got = tpar.reference_dataset_audit(root, n_subjects=n_subjects)
    assert got == jpar.reference_dataset_audit(root, n_subjects=n_subjects)
    assert got["ok"] is False and got["present"] == 6
    assert any("placeholder" in m for m in got["missing"])
    assert any("not a BrainVision marker" in m for m in got["missing"])
    assert any("not BrainVision (bad header)" in m for m in got["missing"])


def test_audit_of_a_complete_tree_matches_jax(tmp_path):
    generate_synthetic_dataset(tmp_path, n_subjects=2, n_sessions=3, duration_s=2.0,
                               n_channels=4)
    got = tpar.reference_dataset_audit(tmp_path, n_subjects=2, tasks=("eyesopen",))
    assert got == jpar.reference_dataset_audit(tmp_path, n_subjects=2, tasks=("eyesopen",))
    assert got["ok"] and got["present"] == got["expected"] == 2 * 3 * 3


def test_expect_reference_on_an_incomplete_tree_returns_2(tmp_path, capsys):
    data, out = _partial_tree(tmp_path / "data"), tmp_path / "out"
    rc = cli_main(["--data-dir", str(data), "--output-dir", str(out), "parity",
                   "--expect-reference", "--device", "cpu"])
    assert rc == 2
    assert "INCOMPLETE" in capsys.readouterr().out
    audit = json.loads((out / "results" / "parity_audit.json").read_text())
    assert audit == json.loads(json.dumps(jpar.reference_dataset_audit(data, n_subjects=30)))
    assert audit["expected"] == 30 * 3 * 2 * 3
    assert not (out / "parity_config.json").exists()


def test_expect_reference_excludes_synthetic(tmp_path, capsys):
    rc = cli_main(["--data-dir", str(tmp_path / "d"), "--output-dir", str(tmp_path / "o"),
                   "parity", "--expect-reference", "--synthetic", "--device", "cpu"])
    assert rc == 2
    assert "mutually exclusive" in capsys.readouterr().out


@pytest.mark.parametrize("yes", [False, True])
def test_without_a_dataset_parity_returns_1(tmp_path, capsys, yes):
    """No data and no --synthetic: 1, asking for -y; with -y, 1 naming the
    download as the blocked step (this package cannot download)."""
    rc = cli_main(["--data-dir", str(tmp_path / "none"), "--output-dir", str(tmp_path / "out"),
                   "parity", *(["-y"] if yes else []), "--device", "cpu"])
    assert rc == 1
    said = capsys.readouterr().out
    if yes:
        assert "BLOCKED STEP" in said
    else:
        assert "pass -y" in said and "BLOCKED STEP" not in said
    assert not (tmp_path / "none").exists()


def test_parity_on_cuda_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--data-dir", str(tmp_path), "--output-dir", str(tmp_path / "o"), "parity",
                  "--synthetic"])


def test_parity_synthetic_end_to_end(tmp_path, monkeypatch):
    """tests/test_pipeline.py::test_parity_runner_synthetic's run on the port:
    4 subjects x 15 s x 8 channels, 2 epochs; the forest's and the boosted
    trees' grids cut to one candidate each (the chain is under test, not the
    grids); the figures of its five stages recorded, not rasterised."""
    patch_figures(monkeypatch)
    monkeypatch.setattr(tcls, "train_random_forest", functools.partial(
        tcls.train_random_forest, grid=[{"n_estimators": 20, "max_depth": None,
                                         "min_samples_split": 2}]))
    monkeypatch.setattr(tcls, "train_gradient_boosting", functools.partial(
        tcls.train_gradient_boosting, grid=[{"n_estimators": 20, "max_depth": 3,
                                             "learning_rate": 0.3}]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    data_dir, out = tmp_path / "data", tmp_path / "outputs"
    cfg = PipelineConfig(
        data=DataConfig(dataset_dir=str(data_dir), max_subjects=None),
        model=ModelConfig(input_size=8, hidden_size=16, num_layers=1, dropout=0.1),
        train=TrainConfig(epochs=2, batch_size=64, eval_batch_size=128, accumulation_steps=1,
                          learning_rate=3e-3, warmup_epochs=1, patience=10, bf16=False),
        ode=ODEConfig(de_maxiter=30),
    )
    cfg.to_json(tmp_path / "config.json")
    try:
        rc = cli_main(["--data-dir", str(data_dir), "--output-dir", str(out),
                       "--config", str(tmp_path / "config.json"), "parity", "--synthetic",
                       "--subjects", "4", "--duration", "15", "--channels", "8",
                       "--epochs", "2", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    assert len(list(data_dir.glob("sub-*/ses-*/eeg/*.vhdr"))) == 8
    report = json.loads((out / "results" / "parity_report.json").read_text())
    assert report["comparable"] is False and "NOT COMPARABLE" in report["verdict"]
    assert set(report["models"]) == {"svm", "random_forest", "gradient_boosting",
                                     "lstm_attention", "lstm_ode_integration"}
    for entry in report["models"].values():
        assert "accuracy" in entry and "delta" in entry["accuracy"]
    assert report["models"]["gradient_boosting"]["reference_row"] == "xgboost"
    pc = json.loads((out / "parity_config.json").read_text())
    assert pc["preprocess"]["filter_method"] == "filtfilt"
    assert pc["train"]["selection_metric"] == "mcc"  # f1 only on real data
    meta = json.loads((out / "processed_data" / "preprocessing_metadata.json").read_text())
    assert meta["filter"]["method"] == "filtfilt"
    for name in ("baseline_results.json", "lstm_results.json", "ode_results.json",
                 "integration_results.json", "coupling_analysis.json"):
        assert (out / "results" / name).exists()
    assert figure_files(out) == sorted(
        f"{n}.{e}" for stage in ("preprocess", "baselines", "train", "fit-ode", "integrate")
        for n in STAGE_FIGURES[stage] for e in ("png", "pdf"))
