"""The port's statistics toolkit (``eegflow_torch.analyze.stats``) against
``eegflow.analyze.stats`` on seeded numpy inputs: every function gives
exactly the JAX package's result, both McNemar branches and their edges
included."""

import numpy as np
import pytest

from eegflow.analyze import stats as jstats
from eegflow_torch.analyze import stats as tstats


def _pair(seed, n, p_same):
    """Labels and two prediction vectors that agree with each other on about
    ``p_same`` of the windows."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    a = np.where(rng.random(n) < 0.8, y, 1 - y)
    b = np.where(rng.random(n) < p_same, a, 1 - a)
    return y, a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cohens_d_matches(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(40) + 0.3
    y = rng.standard_normal(55)
    assert tstats.cohens_d(x, y) == jstats.cohens_d(x, y)
    correct = (rng.random(50) < 0.7).astype(np.float64)
    other = (rng.random(50) < 0.6).astype(np.float64)
    assert tstats.cohens_d(correct, other) == jstats.cohens_d(correct, other)


def test_cohens_d_of_a_pooled_sd_of_zero_is_zero():
    x, y = np.ones(10), np.ones(7)
    assert tstats.cohens_d(x, y) == jstats.cohens_d(x, y) == 0.0
    assert isinstance(tstats.cohens_d(x, y), float)


@pytest.mark.parametrize("d", [0.0, 0.1, -0.19, 0.2, 0.49, -0.5, 0.79, 0.8, -2.5])
def test_interpret_cohens_d_matches(d):
    assert tstats.interpret_cohens_d(d) == jstats.interpret_cohens_d(d)


@pytest.mark.parametrize("n,p_same,method", [(30, 0.8, "exact"), (200, 0.95, "exact"),
                                             (400, 0.7, "chi2_cc"), (1000, 0.9, "chi2_cc")])
def test_mcnemar_matches_in_both_branches(n, p_same, method):
    y, a, b = _pair(n, n, p_same)
    got, want = tstats.mcnemar_test(y, a, b), jstats.mcnemar_test(y, a, b)
    assert got == want
    assert got["method"] == method
    assert (got["b"] + got["c"] < 25) == (method == "exact")


def test_mcnemar_without_disagreements():
    y, a, _ = _pair(5, 60, 1.0)
    got = tstats.mcnemar_test(y, a, a.copy())
    assert got == jstats.mcnemar_test(y, a, a.copy())
    assert got == {"statistic": 0.0, "p_value": 1.0, "b": 0, "c": 0, "method": "exact"}


@pytest.mark.parametrize("seed,confidence", [(42, 0.95), (7, 0.9)])
def test_bootstrap_metric_ci_matches(seed, confidence):
    y, a, _ = _pair(seed, 120, 0.9)
    got = tstats.bootstrap_metric_ci(np.mean, y, a, n_bootstrap=300, confidence=confidence,
                                     seed=seed)
    want = jstats.bootstrap_metric_ci(np.mean, y, a, n_bootstrap=300, confidence=confidence,
                                      seed=seed)
    assert got == want
    assert got[1] <= got[0] <= got[2]


@pytest.mark.parametrize("seed", [3, 4])
def test_paired_t_test_matches(seed):
    y, a, b = _pair(seed, 150, 0.85)
    ca, cb = (a == y).astype(np.float64), (b == y).astype(np.float64)
    assert tstats.paired_t_test(ca, cb) == jstats.paired_t_test(ca, cb)


def test_paired_t_test_of_identical_vectors_matches():
    c = (np.arange(20) % 3 == 0).astype(np.float64)
    got, want = tstats.paired_t_test(c, c.copy()), jstats.paired_t_test(c, c.copy())
    np.testing.assert_equal(got, want)  # nan on both sides
