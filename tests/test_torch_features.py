"""eegflow_torch's feature extractor (``signal/features.py``) against the JAX
package's and against a float64 oracle of the reference's semantics, on the
CPU."""

import numpy as np
import pytest
import torch

from eegflow.signal import features as jfeat
from eegflow_torch.signal import features as tfeat

ZCR = 8  # the zero-crossing rate's index among a channel's 20 features
# float32 against the JAX package's float32: the same operations, sums in
# another order (mean, skew and kurt cancel towards 0, hence the atol)
JAX_RTOL, JAX_ATOL = 1e-5, 1e-5
# against the float64 oracle: the JAX package's own bound
# (tests/test_signal.py::test_features_match_torch_semantics)
ORACLE_TOL = 2e-3
# the zcr is a count over 2 * T: a sample within float32 rounding of its
# window's mean may take the other sign (or 0) on one side and move its
# window's rate by a step of 1 / T or 2 / T; at these sizes no sample does
ZCR_MAX_FLIPS = 0


def oracle(x, fs=500.0):
    """The reference's torch semantics in float64 numpy, one channel at a time
    (ref 03:151-258; tests/test_signal.py's oracle)."""
    n, t, c = x.shape
    feats = np.zeros((n, c, 20))
    freqs = np.fft.rfftfreq(t, 1 / fs)
    masks = [(freqs >= lo) & (freqs < hi) for lo, hi in
             ((0.5, 4), (4, 8), (8, 13), (13, 30), (30, 45))]
    for ch in range(c):
        s = x[:, :, ch]
        mean = s.mean(1)
        std = s.std(1, ddof=1)
        var = s.var(1, ddof=1)
        mn, mx = s.min(1), s.max(1)
        cen = s - mean[:, None]
        m2, m3, m4 = (cen ** 2).mean(1), (cen ** 3).mean(1), (cen ** 4).mean(1)
        d1 = np.diff(s, axis=1)
        d2 = np.diff(d1, axis=1)
        mob = d1.std(1, ddof=1) / (std + 1e-10)
        comp = (d2.std(1, ddof=1) / (d1.std(1, ddof=1) + 1e-10)) / (mob + 1e-10)
        p = np.abs(np.fft.rfft(s, axis=1)) ** 2
        delta, theta, alpha, beta, gamma = (p[:, m].sum(1) for m in masks)
        tot = delta + theta + alpha + beta + gamma + 1e-10
        feats[:, ch] = np.stack(
            [mean, std, var, mn, mx, mx - mn, m3 / (m2 ** 1.5 + 1e-10),
             m4 / (m2 ** 2 + 1e-10) - 3,
             np.abs(np.diff(np.sign(cen), axis=1)).sum(1) / 2 / t, (s ** 2).mean(1), var,
             mob, comp, delta / tot, theta / tot, alpha / tot, beta / tot, gamma / tot,
             alpha / (theta + 1e-10), alpha / (beta + 1e-10)], axis=1)
    return feats.reshape(n, -1)


def split_zcr(f, channels):
    f = f.reshape(len(f), channels, 20)
    return f[..., ZCR], np.delete(f, ZCR, axis=-1)


def hold_zcr(got, want, t):
    """The differing zcr entries: at most ZCR_MAX_FLIPS, each by whole steps
    of 1 / T, at most two."""
    diff = np.abs(got - want)
    assert int((diff > 0.25 / t).sum()) <= ZCR_MAX_FLIPS
    assert diff.max() <= 2 / t + 1e-6
    steps = diff * t
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-3)


@pytest.mark.parametrize("n,t,c,fs", [(16, 256, 4, 500.0), (40, 256, 61, 500.0),
                                      (9, 128, 3, 250.0)])
def test_features_match_jax_and_the_oracle(rng, n, t, c, fs):
    x = rng.standard_normal((n, t, c)).astype(np.float32)
    x[:, :, 0] += 3.0 * np.sin(2 * np.pi * 10.0 * np.arange(t) / fs).astype(np.float32)
    got = tfeat.extract_features(x, fs=fs, device="cpu")
    assert got.shape == (n, c * tfeat.N_FEATURES_PER_CHANNEL) and got.dtype == np.float32
    want = np.asarray(jfeat.extract_features(x, fs=fs))
    z_got, rest_got = split_zcr(got, c)
    z_want, rest_want = split_zcr(want, c)
    np.testing.assert_allclose(rest_got, rest_want, rtol=JAX_RTOL, atol=JAX_ATOL)
    hold_zcr(z_got, z_want, t)
    z_oracle, rest_oracle = split_zcr(oracle(x.astype(np.float64), fs), c)
    np.testing.assert_allclose(rest_got, rest_oracle, rtol=ORACLE_TOL, atol=ORACLE_TOL)
    hold_zcr(z_got, z_oracle, t)


def test_chunked_equals_unchunked(rng):
    """Chunks of batch_size windows (the last one short) give the rows of one
    pass over all windows: every feature is a function of its own window."""
    x = rng.standard_normal((23, 256, 5)).astype(np.float32)
    whole = tfeat.extract_features(x, device="cpu")
    np.testing.assert_array_equal(tfeat.extract_features(x, batch_size=23, device="cpu"), whole)
    np.testing.assert_allclose(tfeat.extract_features(x, batch_size=7, device="cpu"), whole,
                               rtol=1e-6, atol=1e-7)


def test_zero_signal_is_scrubbed_finite():
    """A constant window: the moments' and Hjorth guards keep it finite, as
    the JAX package's test asks, and it equals the JAX package's."""
    x = np.zeros((4, 256, 2), np.float32)
    x[2:] = 1.5
    got = tfeat.extract_features(x, device="cpu")
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, np.asarray(jfeat.extract_features(x)))


def test_nonfinite_input_is_scrubbed(rng):
    x = rng.standard_normal((3, 256, 2)).astype(np.float32)
    x[1, 5, 0] = np.nan
    x[2, 7, 1] = np.inf
    got = tfeat.extract_features(x, device="cpu")
    want = np.asarray(jfeat.extract_features(x))
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_empty_input():
    got = tfeat.extract_features(np.zeros((0, 256, 4), np.float32), device="cpu")
    assert got.shape == np.asarray(jfeat.extract_features(np.zeros((0, 256, 4),
                                                                   np.float32))).shape


def test_feature_names_match_jax():
    names = tfeat.feature_names(["O1", "O2", "Fz"])
    assert names == jfeat.feature_names(["O1", "O2", "Fz"])
    assert len(names) == 60 and names[8] == "O1_zcr" and names[20] == "O2_mean"


def test_band_masks_match_jax():
    for t, fs in ((256, 500.0), (128, 250.0), (16, 500.0)):
        np.testing.assert_array_equal(tfeat._band_masks(t, fs), jfeat._band_masks(t, fs))


def test_defaults_to_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the default without one")
    with pytest.raises((RuntimeError, AssertionError)):
        tfeat.extract_features(rng.standard_normal((2, 256, 3)).astype(np.float32))
