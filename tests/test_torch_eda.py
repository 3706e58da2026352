"""eegflow_torch's exploratory analysis (``eda/explore.py``) against the JAX
package's on a dataset the port's ``synth`` writes (byte for byte the JAX
package's), on the CPU."""

import re

import numpy as np
import pytest

from eegflow import eda as jeda
from eegflow_torch import eda as teda
from eegflow_torch.data import discover_recordings, read_brainvision
from eegflow_torch.data.synthetic import generate_synthetic_dataset

# band powers and PSDs: float32 Welch of two libraries (tests/test_torch_spectral.py)
SPECTRAL_RTOL = 1e-5


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("eda_ds")
    return generate_synthetic_dataset(root, n_subjects=3, duration_s=5.0, n_channels=8)


@pytest.fixture(scope="module")
def ds_with_a_broken_recording(tmp_path_factory):
    """Two subjects: the first recording's payload gone, the second's header
    with ``NumberOfChannels=0`` and the third's with ``SamplingInterval=0``
    (each reader divides by it); the fourth intact."""
    root = generate_synthetic_dataset(tmp_path_factory.mktemp("eda_broken"), n_subjects=2,
                                      duration_s=3.0, n_channels=4)
    recs = discover_recordings(root)
    recs[0]["vhdr_path"].with_suffix(".eeg").unlink()
    for rec, pattern in ((recs[1], r"NumberOfChannels=\d+"), (recs[2], r"SamplingInterval=[\d.]+")):
        vhdr = rec["vhdr_path"]
        text = vhdr.read_text()
        vhdr.write_text(re.sub(pattern, pattern.split("=")[0] + "=0", text, count=1))
    return root


@pytest.mark.parametrize("max_subjects", [None, 1, 2])
def test_census_matches_jax(ds, max_subjects):
    got = teda.dataset_census(ds, max_subjects)
    assert got == jeda.dataset_census(ds, max_subjects)
    if max_subjects is None:
        assert got["n_recordings"] == 6 and got["n_subjects"] == 3
        assert got["recordings_per_task"] == {"eyesopen": 3, "eyesclosed": 3}


@pytest.mark.parametrize("n_sample,crop", [(4, 3.0), (6, None)])
def test_recording_stats_match_jax(ds, n_sample, crop):
    rows = teda.analyze_recordings(ds, n_sample=n_sample, crop_seconds=crop)
    assert rows == jeda.analyze_recordings(ds, n_sample=n_sample, crop_seconds=crop)
    assert len(rows) == n_sample and all(r["n_channels"] == 8 for r in rows)
    stats = teda.basic_statistics(rows)
    assert stats == jeda.basic_statistics(rows)
    assert stats["n_recordings"] == n_sample and stats["sampling_rates"] == [500.0]


def test_unreadable_recording_is_isolated(ds_with_a_broken_recording):
    """The unreadable recording gets an error row; the others are read, as
    in the JAX package."""
    rows = teda.analyze_recordings(ds_with_a_broken_recording, n_sample=4)
    want = jeda.analyze_recordings(ds_with_a_broken_recording, n_sample=4)
    assert rows == want
    assert "error" in rows[0]
    assert [r.get("error", "ok") for r in rows[1:]] == [
        "integer division or modulo by zero", "float division by zero", "ok"]
    assert teda.basic_statistics(rows) == jeda.basic_statistics(want)
    assert teda.basic_statistics(rows)["n_recordings"] == 1


@pytest.mark.parametrize("rows", [[], [{"error": "x"}]])
def test_basic_statistics_empty(rows):
    assert teda.basic_statistics(rows) == jeda.basic_statistics(rows) == {"n_recordings": 0}


def _posterior_pair(ds):
    recs = discover_recordings(ds)
    open_data, header = read_brainvision(next(r for r in recs if r["label"] == 0)["vhdr_path"])
    closed_data, _ = read_brainvision(next(r for r in recs if r["label"] == 1)["vhdr_path"])
    names = [c["name"] for c in header["channels"]]
    # a posterior channel carries the alpha boost (tests/test_eda.py's list)
    ch = next(i for i, n in enumerate(names)
              if n in ("O1", "Oz", "O2", "POz", "Iz", "PO8", "P8"))
    return open_data[ch], closed_data[ch], header["sampling_rate"]


def test_spectral_summary_matches_jax(ds):
    open_sig, closed_sig, fs = _posterior_pair(ds)
    got = teda.spectral_summary(open_sig, closed_sig, fs, device="cpu")
    want = jeda.spectral_summary(open_sig, closed_sig, fs)
    assert got.keys() == want.keys() and got["bands"].keys() == want["bands"].keys()
    assert got["alpha_closed_open_ratio"] > 2.0
    np.testing.assert_allclose(got["alpha_closed_open_ratio"], want["alpha_closed_open_ratio"],
                               rtol=SPECTRAL_RTOL)
    for name, band in want["bands"].items():
        for key in ("open", "closed", "ratio"):
            np.testing.assert_allclose(got["bands"][name][key], band[key], rtol=SPECTRAL_RTOL)
    assert got["psd"]["freqs"] == want["psd"]["freqs"]
    for key in ("open", "closed"):
        got_psd, want_psd = np.asarray(got["psd"][key]), np.asarray(want["psd"][key])
        assert np.abs(got_psd - want_psd).max() <= SPECTRAL_RTOL * want_psd.max()


@pytest.mark.parametrize("with_spectral", [False, True])
def test_report_text_matches_jax(ds, tmp_path, with_spectral):
    census = teda.dataset_census(ds)
    stats = teda.basic_statistics(teda.analyze_recordings(ds, n_sample=2))
    spectral = None
    j_spectral = None
    if with_spectral:
        open_sig, closed_sig, fs = _posterior_pair(ds)
        spectral = teda.spectral_summary(open_sig, closed_sig, fs, device="cpu")
        j_spectral = jeda.spectral_summary(open_sig, closed_sig, fs)
    report = teda.generate_eda_report(census, stats, spectral, tmp_path / "r.md")
    assert (tmp_path / "r.md").read_text() == report
    assert report == jeda.generate_eda_report(jeda.dataset_census(ds), stats, j_spectral)
    assert report.startswith("# EEG Dataset")
    assert ("Alpha (8-13 Hz) closed/open power ratio" in report) == with_spectral
