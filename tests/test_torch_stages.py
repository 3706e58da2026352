"""The ``explore``, ``baselines``, ``integrate``, ``explain``, ``forecast``
and ``export`` stages of the port's CLI with ``--device cpu`` on artifacts
the JAX package wrote (its ``save_processed``, ``save_checkpoint`` and
``save_results``, as its ``preprocess``, ``train`` and ``fit-ode`` stages
write them, at a tiny size; a raw dataset its ``synth`` writes): each writes
the files the JAX package's stage writes on the same artifacts, with the
same keys; with ``--device cuda`` and no GPU each raises. Then the port's
``all`` on a tiny dataset writes every one of those files and the rest of
the JAX package's ``all``. The baselines' forest and boosted trees run a
one-candidate grid here (their default grids are held in
tests/test_torch_baselines.py)."""

import functools
import json
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from eegflow.baselines import classical as jax_classical
from eegflow.cli.main import main as jax_cli_main
from eegflow.data.synthetic import generate_synthetic_dataset as jax_synth
from eegflow.core.artifacts import save_checkpoint, save_processed, save_results
from eegflow.core.config import ModelConfig as JaxModelConfig
from eegflow.nn.model import classifier_init as jax_classifier_init
from eegflow_torch.baselines import classical as port_classical
from eegflow_torch.cli.main import build_parser
from eegflow_torch.cli.main import main as cli_main

T, C = 16, 5
RATES = {"k_ap": 0.2, "k_af": 0.03, "k_pa": 0.1, "k_pf": 0.05, "k_fa": 0.07, "k_fp": 0.2}
CHANNELS = ["O1", "O2", "Fz", "P7", "Cz"]
# what each stage writes under results/ (the JAX stages also draw figures)
WRITES = {
    "explore": ["eda_report.md", "eda_summary.json"],
    "baselines": ["baseline_results.json"],
    "integrate": ["all_model_results.json", "coupling_analysis.json",
                  "integration_results.json"],
    "explain": ["explainability_summary.json"],
    "forecast": ["forecasting_results.json"],
    "export": ["participant_probabilities.csv", "test_sample_probabilities.csv",
               "three_state_summary.json", "train_sample_probabilities.csv",
               "val_sample_probabilities.csv"],
}
STAGE_ARGS = {"explain": ["--skip-shap"]}
# what the baselines stage writes under models/
BASELINE_MODELS = ["baseline_models.pkl", "features_test.npz", "features_train.npz",
                   "features_val.npz"]
# what the ablate stage writes under results/ (held against the JAX package's
# stage in tests/test_torch_ablation_stage.py)
ABLATE_WRITES = ["results_tables.txt", "sensitivity_analysis.json"]
SMALL_RF = [{"n_estimators": 10, "max_depth": 4, "min_samples_split": 2}]
SMALL_GB = [{"n_estimators": 10, "max_depth": 3, "learning_rate": 0.3}]


@pytest.fixture(scope="module")
def small_grids():
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_classical, port_classical):
            mp.setattr(module, "train_random_forest",
                       functools.partial(module.train_random_forest, grid=SMALL_RF))
            mp.setattr(module, "train_gradient_boosting",
                       functools.partial(module.train_gradient_boosting, grid=SMALL_GB))
        yield


def _split(rng, n):
    y = np.arange(n) % 2
    x = rng.standard_normal((n, T, C)).astype(np.float32)
    x[:, :, 0] += (y - 0.5).astype(np.float32)[:, None]
    return x, y.astype(np.int64)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One output directory of JAX-written artifacts -> (jax copy, port copy);
    the raw dataset the explore stage reads is ``data`` beside them."""
    root = tmp_path_factory.mktemp("stages")
    jax_synth(root / "data", n_subjects=2, duration_s=4.0, n_channels=8)
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
def ran(artifacts, small_grids):
    """Every stage of both packages, in pipeline order, on its copy ->
    (jax copy, port copy, {stage: the files the port's stage wrote})."""
    jax_out, port_out = artifacts
    data = ["--data-dir", str(jax_out.parent / "data")]
    written = {}
    for stage in WRITES:
        before = set((port_out / "results").iterdir())
        assert cli_main(data + ["--output-dir", str(port_out), stage,
                                *STAGE_ARGS.get(stage, []), "--device", "cpu"]) == 0
        written[stage] = sorted(p.name for p in set((port_out / "results").iterdir()) - before)
        assert (jax_cli_main(data + ["--output-dir", str(jax_out), stage,
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
        elif name.endswith(".md"):
            assert mine.read_text() == theirs.read_text()
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


def test_explore_and_baselines_read_what_they_should(ran):
    """explore's census and biomarker come from the raw dataset; baselines
    caches the features and pickles the models under models/, as the JAX
    package's stage does."""
    jax_out, port_out, _ = ran
    summary = json.loads((port_out / "results" / "eda_summary.json").read_text())
    want = json.loads((jax_out / "results" / "eda_summary.json").read_text())
    assert summary["census"] == want["census"] and summary["statistics"] == want["statistics"]
    assert summary["census"]["n_recordings"] == 4
    # float32 Welch of two libraries (tests/test_torch_spectral.py's bound)
    assert summary["alpha_ratio"] == pytest.approx(want["alpha_ratio"], rel=1e-5)
    for out in (jax_out, port_out):
        assert sorted(p.name for p in (out / "models").iterdir()
                      if p.name in BASELINE_MODELS) == BASELINE_MODELS
    res = json.loads((port_out / "results" / "baseline_results.json").read_text())
    assert list(res) == ["svm", "random_forest", "gradient_boosting"]
    zoo = json.loads((port_out / "results" / "all_model_results.json").read_text())
    assert {"svm", "random_forest", "gradient_boosting"} <= set(zoo)


@pytest.mark.parametrize("stage", list(WRITES) + ["parity", "all"])
def test_stage_on_cuda_without_a_gpu_raises(stage, artifacts):
    assert build_parser().parse_args([stage]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--data-dir", str(artifacts[0].parent / "data"),
                  "--output-dir", str(artifacts[1]), stage])


def test_all_writes_every_file_of_the_jax_packages_all(ran, tmp_path_factory, small_grids):
    """``all --epochs 1 --skip-shap --hidden 16 --device cpu`` on a tiny
    dataset (one torch thread) runs the ten stages and writes every file the
    JAX package's stages wrote above, where its ``all`` writes them (the
    figures aside), and the ablate stage's: nothing missing, nothing more."""
    jax_out = ran[0]
    root = tmp_path_factory.mktemp("all")
    jax_synth(root / "data", n_subjects=4, duration_s=8.0, n_channels=4)
    (root / "cfg.json").write_text(json.dumps({
        "data": {"max_subjects": None},
        "model": {"hidden_size": 16, "num_layers": 1},
        "train": {"batch_size": 64, "eval_batch_size": 128, "accumulation_steps": 1,
                  "bf16": False, "warmup_epochs": 1},
        "ode": {"de_maxiter": 5}}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = cli_main(["--data-dir", str(root / "data"), "--output-dir", str(root / "out"),
                       "--config", str(root / "cfg.json"), "all", "--epochs", "1",
                       "--skip-shap", "--hidden", "16", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0

    def files(out):
        return {str(p.relative_to(out)) for p in out.rglob("*")
                if p.is_file() and p.relative_to(out).parts[0] != "figures"}

    want = files(jax_out) | {f"results/{name}" for name in ABLATE_WRITES}
    assert files(root / "out") == want
    ckpt = json.loads((root / "out" / "models" / "lstm_attention" / "checkpoint.json")
                      .read_text())
    assert ckpt["model_config"]["input_size"] == 4
    ablation = json.loads((root / "out" / "results" / "sensitivity_analysis.json").read_text())
    assert len(ablation["ablation"]) == 6
