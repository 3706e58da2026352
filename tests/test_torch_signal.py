"""eegflow_torch signal layer against the JAX package: the FFT bandpass, the
filtfilt recursion's plain twin (kernel 12's, on the CPU), windowing, the
subject split and the whole recording pipeline, on inputs made with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from eegflow.core.artifacts import load_processed as jax_load_processed
from eegflow.core.config import PreprocessConfig as JaxPreprocessConfig
from eegflow.data import discover_recordings as jax_discover
from eegflow.data import generate_synthetic_dataset as jax_generate
from eegflow.data import read_brainvision as jax_read
from eegflow.signal import filters as jfilt
from eegflow.signal import preprocess as jpre
from eegflow_torch.core.artifacts import save_processed
from eegflow_torch.core.config import PreprocessConfig
from eegflow_torch.data import discover_recordings, read_brainvision
from eegflow_torch.signal import filters as tfilt
from eegflow_torch.signal import preprocess as tpre

# the FFT filter: rfft/irfft of two libraries, float32
FFT_REL_TOL = 1e-5
# kernel 12's twin against the JAX scan: the same float32 operations with the
# same multiply-adds (measured 0.0), held to the stated 1e-5 of the scale
FILTFILT_REL_TOL = 1e-5
# against scipy's float64 filtfilt: the float32 recursion floor, the JAX
# package's own bound (tests/test_signal.py)
SCIPY_REL_TOL = 3e-4


def _eeg_like(rng, channels, seconds, fs=500.0):
    t = np.arange(int(fs * seconds)) / fs
    base = np.cumsum(rng.standard_normal((channels, len(t))), axis=1)
    base -= base.mean(axis=1, keepdims=True)
    return base + 5.0 * np.sin(2 * np.pi * 10.0 * t)[None, :]


@pytest.mark.parametrize("lowcut,highcut,order", [(1.0, 45.0, 4), (4.0, 30.0, 2)])
def test_fft_zero_phase_matches_jax(rng, lowcut, highcut, order):
    x = _eeg_like(rng, 6, 3.0).astype(np.float32)
    b, a = tfilt.butter_bandpass(lowcut, highcut, 500.0, order)
    jb, ja = jfilt.butter_bandpass(lowcut, highcut, 500.0, order)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)
    want = np.asarray(jfilt.fft_zero_phase(jnp.asarray(x), b, a))
    got = tfilt.fft_zero_phase(torch.from_numpy(x), b, a).numpy()
    assert np.abs(got - want).max() <= FFT_REL_TOL * np.abs(want).max()
    want = np.asarray(jfilt.bandpass_filter(jnp.asarray(x), lowcut, highcut, 500.0, order))
    got = tfilt.bandpass_filter(torch.from_numpy(x), lowcut, highcut, 500.0, order).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= FFT_REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("channels,seconds,order", [(8, 4.0, 4), (3, 1.0, 2)])
def test_filtfilt_twin_matches_jax_and_scipy(rng, channels, seconds, order):
    x = _eeg_like(rng, channels, seconds)
    b, a = tfilt.butter_bandpass(1.0, 45.0, 500.0, order)
    want = np.asarray(jfilt.filtfilt_iir(jnp.asarray(x, jnp.float32), b, a))
    got = tfilt.filtfilt_iir(torch.tensor(x, dtype=torch.float32), b, a).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= FILTFILT_REL_TOL * scale
    ref = sps.filtfilt(b, a, x, axis=1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < SCIPY_REL_TOL
    via = tfilt.bandpass_filter(torch.tensor(x, dtype=torch.float32), 1.0, 45.0, 500.0, order,
                                method="filtfilt").numpy()
    np.testing.assert_array_equal(via, got)


def test_filtfilt_batches_leading_axes_and_checks_length(rng):
    x = torch.tensor(_eeg_like(rng, 6, 0.4), dtype=torch.float32).reshape(2, 3, -1)
    b, a = tfilt.butter_bandpass(1.0, 45.0, 500.0, 4)
    got = tfilt.filtfilt_iir(x, b, a)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got[1].numpy(), tfilt.filtfilt_iir(x[1], b, a).numpy())
    with pytest.raises(ValueError, match="padlen"):
        tfilt.filtfilt_iir(torch.zeros(2, 27), b, a)
    with pytest.raises(ValueError, match="filter method"):
        tfilt.bandpass_filter(x, 1.0, 45.0, 500.0, method="iir")


def test_sos_twin_takes_the_sections_kernel_12_does(rng):
    x = torch.tensor(_eeg_like(rng, 2, 0.5), dtype=torch.float32)
    b, a = tfilt.butter_bandpass(1.0, 45.0, 500.0, 4)
    sos, zi, padlen = tfilt._sos_design(b, a)
    assert sos.shape == (4, 6) and zi.shape == (4, 2) and padlen == 27
    assert sos.dtype == zi.dtype == np.float32
    assert 4 <= tfilt.MAX_SECTIONS
    np.testing.assert_array_equal(tfilt.sos_filtfilt(x, sos, zi, padlen).numpy(),
                                  tfilt.sos_filtfilt_plain(x, sos, zi, padlen).numpy())


@pytest.mark.parametrize("rows,samples", [(1, 5), (5, 40), (32, 7), (33, 130), (61, 64),
                                          (70, 3)])
def test_sos_groups_stage_rows_in_padded_groups_of_32(rows, samples):
    """Kernel 12's layout, which its wrapper builds and undoes on the card:
    row r at sample t is group r // 32's [t, r % 32]; the last group's
    padding rows are zero; ungrouping gives the rows back exactly."""
    x = torch.arange(rows * samples, dtype=torch.float32).reshape(rows, samples) + 1
    xg = tfilt.sos_groups(x)
    groups = -(-rows // tfilt.SOS_GROUP)
    assert xg.shape == (groups, samples, tfilt.SOS_GROUP) and xg.is_contiguous()
    r = torch.arange(rows)
    assert torch.equal(xg[r // 32, :, r % 32], x)
    assert (xg.reshape(-1, tfilt.SOS_GROUP).abs().sum(0) > 0).sum() == min(rows, 32)
    assert torch.equal(xg.transpose(1, 2).reshape(-1, samples)[rows:],
                       torch.zeros(groups * 32 - rows, samples))
    assert torch.equal(tfilt.sos_ungroup(xg, rows), x)


@pytest.mark.parametrize("samples,overlap", [(1000, 0.5), (700, 0.25), (100, 0.5)])
def test_create_sequences_equals_jax(rng, samples, overlap):
    data = rng.standard_normal((5, samples)).astype(np.float32)
    want_x, want_y = jpre.create_sequences(data, 1, 256, overlap)
    got_x, got_y = tpre.create_sequences(torch.from_numpy(data), 1, 256, overlap)
    assert got_x.shape == want_x.shape and got_y.dtype == torch.int64
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_y.numpy(), want_y)
    np.testing.assert_array_equal(tpre.create_sequences(data, 1, 256, overlap)[0].numpy(),
                                  want_x)  # an array in, as the reference takes


def test_normalize_matches_jax(rng):
    data = (rng.standard_normal((4, 600)) * [[1.0], [2.0], [0.0], [1e-3]]).astype(np.float32)
    want, wm, ws = jpre.normalize(data, std_floor=1e-10)
    got, gm, gs = tpre.normalize(torch.from_numpy(data), std_floor=1e-10)
    np.testing.assert_allclose(gm.numpy(), wm, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    want2, _, _ = jpre.normalize(data, wm, ws)
    got2, _, _ = tpre.normalize(torch.from_numpy(data), torch.from_numpy(wm),
                                torch.from_numpy(ws))
    np.testing.assert_allclose(got2.numpy(), want2, atol=1e-4)


def _recs(subjects, sessions):
    return [{"subject": f"sub-{i:02d}", "session": f"ses-{j}", "label": (i + j) % 2}
            for i in range(subjects) for j in range(sessions)]


@pytest.mark.parametrize("recs,kw", [
    (_recs(20, 1), {}), (_recs(12, 2), {"seed": 3}), (_recs(3, 1), {}),
    (_recs(5, 1), {"train_frac": 0.6, "val_frac": 0.2}),
    (_recs(1, 6), {}), (_recs(2, 2), {}), (_recs(1, 1), {}), (_recs(1, 2), {})])
def test_split_subjects_equals_jax(recs, kw):
    """All three paths: by subject, by session (< 3 subjects) and the time
    fallback (< 3 sessions)."""
    assert tpre.split_subjects(recs, **kw) == jpre.split_subjects(recs, **kw)


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    jax_generate(root, n_subjects=4, duration_s=3.0, n_channels=6)
    return root


@pytest.mark.parametrize("method", ["fft", "filtfilt"])
def test_process_recordings_matches_jax(tiny_tree, tmp_path, method):
    """The whole recording pipeline on the tiny tree: arrays within 1e-4 abs
    (z-scored windows: float32 filter and statistics in another order),
    labels, splits and metadata equal, the normalisation to float32
    rounding; and the JAX package reads the archive the port writes."""
    def loaded(discover, read, split):
        splits = split(discover(tiny_tree))
        return {s: [(r, read(r["vhdr_path"])[0]) for r in splits.get(s, [])]
                for s in ("train", "val", "test")}

    want, want_meta = jpre.process_recordings(
        loaded(jax_discover, jax_read, jpre.split_subjects),
        JaxPreprocessConfig(filter_method=method, sequence_length=128))
    got, got_meta = tpre.process_recordings(
        loaded(discover_recordings, read_brainvision, tpre.split_subjects),
        PreprocessConfig(filter_method=method, sequence_length=128), device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
        if key.startswith("y_"):
            np.testing.assert_array_equal(got[key], want[key])
        elif want[key].size:
            assert np.abs(got[key] - want[key]).max() <= 1e-4
    norm, want_norm = got_meta.pop("normalization"), want_meta.pop("normalization")
    assert got_meta == want_meta
    assert want_meta["splits"]["val"]["n_sequences"] > 0
    np.testing.assert_allclose(norm["mean"], want_norm["mean"], rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(norm["std"], want_norm["std"], rtol=1e-5)

    npz = save_processed(tmp_path, got, dict(got_meta, normalization=norm))
    arrays, meta = jax_load_processed(npz)
    for key in got:
        np.testing.assert_array_equal(arrays[key], got[key])
    assert meta["splits"] == got_meta["splits"] and meta["normalization"] == norm
