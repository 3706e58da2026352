"""eegflow_torch's classical baselines (``baselines/classical.py``) against
the JAX package's: the feature caches read across packages, the estimators
(the same sklearn with the same seeds) on the same features, and
``run_all_baselines``' results, on the CPU. The grids are cut to one or two
candidates where a test is not about them (the default grids take a minute
of HistGradientBoosting fits)."""

import functools
import sys

import numpy as np
import pytest

from eegflow.baselines import classical as jcls
from eegflow.signal.features import extract_features as jax_extract
from eegflow_torch.baselines import classical as tcls
from eegflow_torch.cli.main import main as cli_main
from eegflow_torch.core.artifacts import save_processed
from torch_threads import one_torch_thread  # noqa: F401

T, C = 256, 4
SMALL_RF = [{"n_estimators": 10, "max_depth": 4, "min_samples_split": 2},
            {"n_estimators": 12, "max_depth": None, "min_samples_split": 5}]
SMALL_GB = [{"n_estimators": 10, "max_depth": 3, "learning_rate": 0.3},
            {"n_estimators": 15, "max_depth": 4, "learning_rate": 0.1}]
# the same estimators on the same features: equal up to float64 rounding of
# the results' own arithmetic (bootstrap CIs, AUC)
RESULTS_TOL = 1e-12


def _windows(rng, n):
    """Balanced labels; eyes-closed windows carry a 10 Hz rhythm."""
    y = np.arange(n) % 2
    x = rng.standard_normal((n, T, C)).astype(np.float32)
    alpha = np.sin(2 * np.pi * 10.0 * np.arange(T) / 500.0 + rng.uniform(0, 6.3, (n, 1)))
    x[:, :, :2] += (1.5 * y[:, None] * alpha).astype(np.float32)[:, :, None]
    return x, y.astype(np.int64)


@pytest.fixture(scope="module")
def splits():
    rng = np.random.default_rng(7)
    return {s: _windows(rng, n) for s, n in (("train", 60), ("val", 20), ("test", 30))}


@pytest.fixture(scope="module")
def scaled(splits):
    """The JAX package's features of each split, scaled as run_all_baselines
    scales them."""
    from sklearn.preprocessing import StandardScaler

    feats = {s: np.asarray(jax_extract(x)) for s, (x, _) in splits.items()}
    scaler = StandardScaler().fit(feats["train"])
    return {s: (scaler.transform(f), splits[s][1]) for s, f in feats.items()}


def _small_grids(mp, module):
    mp.setattr(module, "train_random_forest",
               functools.partial(module.train_random_forest, grid=SMALL_RF))
    mp.setattr(module, "train_gradient_boosting",
               functools.partial(module.train_gradient_boosting, grid=SMALL_GB))


def _assert_close(got, want, path="results"):
    """Equal structures; numbers within RESULTS_TOL; anything else equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=RESULTS_TOL, nan_ok=True), path
    else:
        assert got == want, path


def test_each_package_reads_the_others_cache(splits, tmp_path):
    x = splits["train"][0]
    jax_cache, port_cache = tmp_path / "jax.npz", tmp_path / "port.npz"
    written_by_jax = jcls.load_or_extract_features(x, jax_cache)
    written_by_port = tcls.load_or_extract_features(x, port_cache, device="cpu")
    assert set(np.load(jax_cache)) == set(np.load(port_cache)) == {"features"}
    # a cache that exists is read, not re-extracted: hand each the other's
    # file under garbage windows
    garbage = np.full_like(x[:3], np.nan)
    np.testing.assert_array_equal(tcls.load_or_extract_features(garbage, jax_cache),
                                  written_by_jax)
    np.testing.assert_array_equal(
        np.asarray(jcls.load_or_extract_features(garbage, port_cache)), written_by_port)
    np.testing.assert_allclose(written_by_port, written_by_jax, rtol=1e-5, atol=1e-5)


def test_uncached_extraction_runs_on_the_given_device(splits):
    x = splits["val"][0]
    np.testing.assert_array_equal(tcls.load_or_extract_features(x, None, device="cpu"),
                                  tcls.extract_features(x, device="cpu"))


@pytest.mark.parametrize("max_samples", [25, 50000])
def test_svm_matches_jax_and_caps_its_subsample(scaled, max_samples):
    (x, y), (xv, yv) = scaled["train"], scaled["val"]
    got, info = tcls.train_svm(x, y, xv, yv, max_samples=max_samples)
    want, j_info = jcls.train_svm(x, y, xv, yv, max_samples=max_samples)
    assert info == j_info and info["grid"] == "C in {1,10}"
    assert got.shape_fit_[0] == min(max_samples, len(x)) == want.shape_fit_[0]
    assert got.C == want.C
    np.testing.assert_array_equal(got.support_, want.support_)
    np.testing.assert_array_equal(got.dual_coef_, want.dual_coef_)
    np.testing.assert_array_equal(got.predict_proba(scaled["test"][0]),
                                  want.predict_proba(scaled["test"][0]))


def test_random_forest_matches_jax(scaled):
    (x, y), (xv, yv) = scaled["train"], scaled["val"]
    got, info = tcls.train_random_forest(x, y, xv, yv, n_jobs=1, grid=SMALL_RF)
    want, j_info = jcls.train_random_forest(x, y, xv, yv, n_jobs=1, grid=SMALL_RF)
    assert info == j_info and info["grid_size"] == len(SMALL_RF)
    assert got.get_params() == want.get_params()
    np.testing.assert_array_equal(got.predict_proba(scaled["test"][0]),
                                  want.predict_proba(scaled["test"][0]))


def test_gradient_boosting_backend_matches_jax(scaled):
    """xgboost where it imports, else the reference's own fallback under its
    name, with the same selection and the imbalance weight."""
    (x, y), (xv, yv) = scaled["train"], scaled["val"]
    keep = np.r_[np.nonzero(y == 0)[0], np.nonzero(y == 1)[0][:20]]  # 30 : 20
    got, info = tcls.train_gradient_boosting(x[keep], y[keep], xv, yv, grid=SMALL_GB)
    want, j_info = jcls.train_gradient_boosting(x[keep], y[keep], xv, yv, grid=SMALL_GB)
    try:
        import xgboost  # noqa: F401
        backend = "xgboost"
    except ImportError:
        backend = "sklearn_hist_gb"
    assert info == j_info and info["backend"] == backend
    assert info["scale_pos_weight"] == pytest.approx(1.5)
    if backend == "sklearn_hist_gb":
        assert got.max_bins == 63
    assert got.get_params() == want.get_params()
    np.testing.assert_array_equal(got.predict_proba(scaled["test"][0]),
                                  want.predict_proba(scaled["test"][0]))


def test_run_all_baselines_matches_jax_on_the_same_features(splits, tmp_path, monkeypatch):
    """The JAX package's features, cached where each package's stage caches
    them: the port's results equal the JAX package's, and both pickle the
    scaler and the three models."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    port_dir.mkdir()
    for split, (x, _) in splits.items():
        feats = jcls.load_or_extract_features(x, jax_dir / f"features_{split}.npz")
        np.savez_compressed(port_dir / f"features_{split}.npz", features=np.asarray(feats))
    _small_grids(monkeypatch, jcls)
    _small_grids(monkeypatch, tcls)
    args = [a for s in ("train", "val", "test") for a in splits[s]]
    got = tcls.run_all_baselines(*args, cache_dir=port_dir, device="cpu")
    want = jcls.run_all_baselines(*args, cache_dir=jax_dir)
    assert list(got) == ["svm", "random_forest", "gradient_boosting"]
    _assert_close(got, want)
    assert max(r["accuracy"] for r in got.values()) > 0.8  # the 10 Hz rhythm separates
    for d in (jax_dir, port_dir):
        assert (d / "baseline_models.pkl").exists()
    import pickle

    with open(port_dir / "baseline_models.pkl", "rb") as f:
        fitted = pickle.load(f)
    assert set(fitted) == {"scaler", "svm", "random_forest", "gradient_boosting"}


def test_without_sklearn_the_stage_raises(splits, tmp_path, monkeypatch):
    """sklearn is imported where the estimators are built; without it the
    stage raises ModuleNotFoundError and skips nothing silently."""
    arrays = {f"{k}_{s}": v for s, (x, y) in splits.items() for k, v in (("X", x), ("y", y))}
    save_processed(tmp_path / "processed_data", arrays, {})
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ModuleNotFoundError):
        cli_main(["--output-dir", str(tmp_path), "baselines", "--device", "cpu"])
    assert not (tmp_path / "results" / "baseline_results.json").exists()
    with pytest.raises(ModuleNotFoundError):
        tcls.train_svm(*splits["train"], *splits["val"])
