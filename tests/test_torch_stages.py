"""The ``integrate``, ``explain``, ``forecast`` and ``export`` stages of the
port's CLI with ``--device cpu`` on artifacts the JAX package wrote (its
``save_processed``, ``save_checkpoint`` and ``save_results``, as its
``preprocess``, ``train`` and ``fit-ode`` stages write them, at a tiny
size): each writes the files the JAX package's stage writes on the same
artifacts, with the same keys; with ``--device cuda`` and no GPU each
raises."""

import json
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from eegflow.cli.main import main as jax_cli_main
from eegflow.core.artifacts import save_checkpoint, save_processed, save_results
from eegflow.core.config import ModelConfig as JaxModelConfig
from eegflow.nn.model import classifier_init as jax_classifier_init
from eegflow_torch.cli.main import build_parser
from eegflow_torch.cli.main import main as cli_main

T, C = 16, 5
RATES = {"k_ap": 0.2, "k_af": 0.03, "k_pa": 0.1, "k_pf": 0.05, "k_fa": 0.07, "k_fp": 0.2}
CHANNELS = ["O1", "O2", "Fz", "P7", "Cz"]
# what each stage writes under results/ (the JAX stages also draw figures)
WRITES = {
    "integrate": ["all_model_results.json", "coupling_analysis.json",
                  "integration_results.json"],
    "explain": ["explainability_summary.json"],
    "forecast": ["forecasting_results.json"],
    "export": ["participant_probabilities.csv", "test_sample_probabilities.csv",
               "three_state_summary.json", "train_sample_probabilities.csv",
               "val_sample_probabilities.csv"],
}
STAGE_ARGS = {"explain": ["--skip-shap"]}


def _split(rng, n):
    y = np.arange(n) % 2
    x = rng.standard_normal((n, T, C)).astype(np.float32)
    x[:, :, 0] += (y - 0.5).astype(np.float32)[:, None]
    return x, y.astype(np.int64)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One output directory of JAX-written artifacts -> (jax copy, port copy)."""
    root = tmp_path_factory.mktemp("stages")
    src = root / "src"
    rng = np.random.default_rng(0)
    arrays = {}
    for split, n in (("train", 24), ("val", 8), ("test", 40)):
        arrays[f"X_{split}"], arrays[f"y_{split}"] = _split(rng, n)
    save_processed(src / "processed_data", arrays, {"channel_names": CHANNELS})
    cfg = JaxModelConfig(input_size=C, hidden_size=16, num_layers=1)
    save_checkpoint(src / "models" / "lstm_attention",
                    jax_classifier_init(jax.random.key(3), cfg), cfg)
    attention = rng.dirichlet(np.ones(T), 40).astype(np.float32)
    np.save(src / "models" / "attention_weights.npy", attention)
    save_results(src / "results" / "ode_results.json", {"fitted_params": RATES})
    save_results(src / "results" / "lstm_results.json",
                 {"accuracy": 0.6, "f1": 0.5, "auc": 0.55, "mcc": 0.1,
                  "accuracy_ci_95": [0.5, 0.7]})
    shutil.copytree(src, root / "jax")
    shutil.copytree(src, root / "port")
    return root / "jax", root / "port"


def _shape(obj):
    """The key structure of a JSON document (dict keys, list lengths)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__ if obj is None else "value"


@pytest.fixture(scope="module")
def ran(artifacts):
    """Every stage of both packages, in pipeline order, on its copy ->
    (jax copy, port copy, {stage: the files the port's stage wrote})."""
    jax_out, port_out = artifacts
    written = {}
    for stage in WRITES:
        before = set((port_out / "results").iterdir())
        assert cli_main(["--output-dir", str(port_out), stage, *STAGE_ARGS.get(stage, []),
                         "--device", "cpu"]) == 0
        written[stage] = sorted(p.name for p in set((port_out / "results").iterdir()) - before)
        assert (jax_cli_main(["--output-dir", str(jax_out), stage,
                              *STAGE_ARGS.get(stage, [])]) or 0) == 0
    return jax_out, port_out, written


@pytest.mark.parametrize("stage", list(WRITES))
def test_stage_writes_what_the_jax_stage_writes(stage, ran):
    jax_out, port_out, written = ran
    assert written[stage] == WRITES[stage]
    for name in written[stage]:
        mine, theirs = port_out / "results" / name, jax_out / "results" / name
        if name.endswith(".json"):
            assert _shape(json.loads(mine.read_text())) == _shape(json.loads(theirs.read_text()))
        else:
            got, want = pd.read_csv(mine), pd.read_csv(theirs)
            assert list(got.columns) == list(want.columns)
            assert list(got.iloc[:, 0]) == list(want.iloc[:, 0])  # sample / participant ids


def test_explain_summary_reads_the_artifacts(ran):
    """The summary names the metadata's channels, the attention and ODE
    analyses of the stored weights and rates, and (with --skip-shap) two
    methods."""
    _, port_out, _ = ran
    summary = json.loads((port_out / "results" / "explainability_summary.json").read_text())
    assert summary["explainability_methods"] == ["gradient", "permutation"]
    assert summary["gradient"]["channels"] == CHANNELS
    np.testing.assert_allclose(sum(summary["gradient"]["importance"]), 1.0, atol=1e-9)
    assert summary["attention_patterns"]["peak_position"] in range(T)
    assert summary["ode_dynamics"]["params"] == RATES
    assert not (port_out / "results" / "shap_values.npy").exists()


@pytest.mark.parametrize("stage", list(WRITES))
def test_stage_on_cuda_without_a_gpu_raises(stage, artifacts):
    assert build_parser().parse_args([stage]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--output-dir", str(artifacts[1]), stage])
