"""eegflow_torch data layer against the JAX package: the synthetic generator
writes the same bytes, and the BrainVision reader, BIDS discovery and the
windows fixture give the same values (exact: numpy on both sides)."""

import numpy as np
import pytest

from eegflow.data import brainvision as jbv
from eegflow.data import bids as jbids
from eegflow.data import synthetic as jsyn
from eegflow_torch.data import brainvision as tbv
from eegflow_torch.data import bids as tbids
from eegflow_torch.data import synthetic as tsyn


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("n_channels", [61, 5])
def test_synthetic_dataset_is_byte_identical(tmp_path, n_channels):
    jsyn.generate_synthetic_dataset(tmp_path / "jax", n_subjects=2, duration_s=2.0,
                                    n_channels=n_channels, seed=7)
    tsyn.generate_synthetic_dataset(tmp_path / "torch", n_subjects=2, duration_s=2.0,
                                    n_channels=n_channels, seed=7)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert len(want) == 12  # 2 subjects x 2 tasks x (.vhdr, .vmrk, .eeg)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_generator_and_montage_match():
    assert tsyn.EEG_CHANNELS_61 == jsyn.EEG_CHANNELS_61
    for n in (4, 19, 61, 80):
        assert tsyn.montage_subset(n) == jsyn.montage_subset(n)
    np.testing.assert_array_equal(tsyn.generate_recording(True, 1.5, 250.0, seed=3),
                                  jsyn.generate_recording(True, 1.5, 250.0, seed=3))
    xt, yt = tsyn.synthetic_windows(n_per_class=8, seq_length=64, n_channels=6, seed=5)
    xj, yj = jsyn.synthetic_windows(n_per_class=8, seq_length=64, n_channels=6, seed=5)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)


def _write_raw(base, counts, fmt, orientation, resolution="0.5", unit="µV"):
    """A BrainVision triplet with samples ``counts (C, T)`` stored as ``fmt``
    in ``orientation``."""
    n_ch = counts.shape[0]
    payload = counts.T if orientation == "MULTIPLEXED" else counts
    payload.astype({"INT_16": np.int16, "INT_32": np.int32,
                    "IEEE_FLOAT_32": np.float32}[fmt]).reshape(-1).tofile(
        base.with_suffix(".eeg"))
    chans = "\n".join(f"Ch{i + 1}=E{i},,{resolution},{unit}" for i in range(n_ch))
    base.with_suffix(".vhdr").write_text(
        "Brain Vision Data Exchange Header File Version 1.0\n\n[Common Infos]\n"
        f"DataFile={base.stem}.eeg\nDataFormat=BINARY\nDataOrientation={orientation}\n"
        f"NumberOfChannels={n_ch}\nSamplingInterval=4000\n\n[Binary Infos]\n"
        f"BinaryFormat={fmt}\n\n[Channel Infos]\n{chans}\n", encoding="utf-8")
    return base.with_suffix(".vhdr")


@pytest.mark.parametrize("fmt,orientation,unit", [
    ("INT_16", "MULTIPLEXED", "µV"), ("INT_32", "MULTIPLEXED", "mV"),
    ("IEEE_FLOAT_32", "VECTORIZED", "uV"), ("INT_16", "VECTORIZED", "V")])
@pytest.mark.parametrize("crop", [None, 0.5])
def test_read_brainvision_matches_jax(tmp_path, rng, fmt, orientation, unit, crop):
    counts = np.round(rng.standard_normal((5, 400)) * 300)
    vhdr = _write_raw(tmp_path / "rec", counts, fmt, orientation, unit=unit)
    got, got_header = tbv.read_brainvision(vhdr, crop)
    want, want_header = jbv.read_brainvision(vhdr, crop)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got_header == want_header == jbv.read_vhdr(vhdr)


def test_writer_round_trip_matches_jax(tmp_path, rng):
    data = (rng.standard_normal((8, 900)) * 20e-6).astype(np.float32)
    names = jsyn.EEG_CHANNELS_61[:8]
    tbv.write_brainvision(tmp_path / "t" / "rec", data, names, 250.0)
    jbv.write_brainvision(tmp_path / "j" / "rec", data, names, 250.0)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    got, header = tbv.read_brainvision(tmp_path / "t" / "rec.vhdr")
    assert header["sampling_rate"] == pytest.approx(250.0)
    assert np.max(np.abs(got - data)) < 0.06e-6  # INT_16 at 0.1 uV
    with pytest.raises(ValueError, match="channel names"):
        tbv.write_brainvision(tmp_path / "bad", data, names[:3])


def test_discover_recordings_matches_jax(tmp_path):
    root = jsyn.generate_synthetic_dataset(tmp_path / "ds", n_subjects=4, n_sessions=2,
                                           duration_s=1.0, n_channels=3)
    fake = root / "sub-05" / "ses-session1" / "eeg"
    fake.mkdir(parents=True)
    (fake / "sub-05_ses-session1_task-eyesopen_eeg.vhdr").write_text("/annex/objects/x")
    for kw in ({}, {"max_subjects": 2}, {"tasks": ("eyesclosed",)}, {"max_subjects": None}):
        assert tbids.discover_recordings(root, **kw) == jbids.discover_recordings(root, **kw)
    assert len(tbids.discover_recordings(root)) == 16
    for p in sorted(root.rglob("*.vhdr")):
        assert tbids.is_real_data(p) == jbids.is_real_data(p)
    assert not tbids.is_real_data(fake / "sub-05_ses-session1_task-eyesopen_eeg.vhdr")
    assert not tbids.is_real_data(tmp_path / "missing.vhdr")
