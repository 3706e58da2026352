"""eegflow_torch's Welch PSD and band powers (``signal/spectral.py``) against
the JAX package's and scipy's on the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import torch
from scipy import signal as sps

from eegflow.signal import spectral as jspec
from eegflow_torch.signal import spectral as tspec

# against scipy's float64 welch: the JAX package's own bound
# (tests/test_signal.py::test_welch_matches_scipy)
SCIPY_RTOL, SCIPY_ATOL = 1e-3, 1e-8
# against the JAX package's float32 welch: rfft of two libraries and the
# segment means and sums in another order, relative to the largest bin
JAX_REL_TOL = 1e-5


def _alpha_pair(n=8192, fs=500.0):
    """The JAX test's eyes-open signal and its eyes-closed copy with a 10 Hz
    boost."""
    t = np.arange(n) / fs
    open_sig = np.random.default_rng(0).standard_normal(len(t))
    return open_sig, open_sig + 3.0 * np.sin(2 * np.pi * 10 * t)


@pytest.mark.parametrize("shape,nperseg", [((3, 4096), 1024), ((2, 5, 3000), 512),
                                           ((4, 2047), 255)])
def test_welch_matches_scipy_and_jax(rng, shape, nperseg):
    x = rng.standard_normal(shape)
    freqs, psd = tspec.welch_psd(x, 500.0, nperseg=nperseg, device="cpu")
    assert psd.dtype == np.float32 and psd.shape == shape[:-1] + (nperseg // 2 + 1,)
    j_freqs, j_psd = jspec.welch_psd(x, 500.0, nperseg=nperseg)
    np.testing.assert_array_equal(freqs, j_freqs)
    assert np.abs(psd - j_psd).max() <= JAX_REL_TOL * np.abs(j_psd).max()
    # the reference's step is nperseg // 2, scipy's default nperseg - nperseg // 2
    # (the same for even nperseg)
    f_ref, p_ref = sps.welch(x, fs=500.0, nperseg=nperseg, noverlap=nperseg - nperseg // 2)
    np.testing.assert_allclose(freqs, f_ref)
    np.testing.assert_allclose(psd, p_ref, rtol=SCIPY_RTOL, atol=SCIPY_ATOL)


def test_welch_of_a_tensor_runs_on_its_device(rng):
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    freqs, psd = tspec.welch_psd(torch.from_numpy(x), 250.0, nperseg=256)
    np.testing.assert_array_equal(psd, tspec.welch_psd(x, 250.0, 256, device="cpu")[1])
    np.testing.assert_array_equal(freqs, np.fft.rfftfreq(256, 1 / 250.0))


def test_welch_of_a_host_array_defaults_to_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the default without one")
    with pytest.raises((RuntimeError, AssertionError)):
        tspec.welch_psd(rng.standard_normal(2048), 500.0)


def test_input_shorter_than_nperseg(rng):
    """nperseg falls to the signal's length: one segment, as in the JAX
    package (and scipy, which warns)."""
    x = rng.standard_normal((2, 300))
    freqs, psd = tspec.welch_psd(x, 500.0, nperseg=1024, device="cpu")
    j_freqs, j_psd = jspec.welch_psd(x, 500.0, nperseg=1024)
    assert psd.shape == (2, 151)
    np.testing.assert_array_equal(freqs, j_freqs)
    assert np.abs(psd - j_psd).max() <= JAX_REL_TOL * np.abs(j_psd).max()
    with pytest.warns(UserWarning):
        f_ref, p_ref = sps.welch(x, fs=500.0, nperseg=1024)
    np.testing.assert_allclose(psd, p_ref, rtol=SCIPY_RTOL, atol=SCIPY_ATOL)


@pytest.mark.parametrize("band", list(tspec.CANONICAL_BANDS.values()) + [(10.0, 10.4)])
def test_band_power_matches_jax(rng, band):
    """The trapezoid over [lo, hi), and the plain sum under two bins."""
    freqs = np.fft.rfftfreq(1024, 1 / 500.0)
    psd = rng.random((3, len(freqs)))
    np.testing.assert_array_equal(tspec.band_power(freqs, psd, band),
                                  jspec.band_power(freqs, psd, band))


def test_band_power_summary_alpha_biomarker():
    """The eyes-closed alpha boost shows in the 8-13 Hz band power, as the
    JAX package's test asks, and every band equals the JAX package's."""
    open_sig, closed_sig = _alpha_pair()
    bp_open = tspec.band_power_summary(open_sig, 500.0, device="cpu")
    bp_closed = tspec.band_power_summary(closed_sig, 500.0, device="cpu")
    assert set(bp_open) == set(tspec.CANONICAL_BANDS) == set(jspec.CANONICAL_BANDS)
    assert bp_closed["alpha"] / bp_open["alpha"] > 3.0
    for got, sig in ((bp_open, open_sig), (bp_closed, closed_sig)):
        want = jspec.band_power_summary(sig, 500.0)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=JAX_REL_TOL)
