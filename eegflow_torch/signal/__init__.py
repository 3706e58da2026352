"""Zero-phase bandpass filters, the preprocessing pipeline, the Welch PSD and
the baselines' feature extractor (``eegflow.signal``)."""

from eegflow_torch.signal.features import N_FEATURES_PER_CHANNEL, extract_features, feature_names
from eegflow_torch.signal.filters import (bandpass_filter, butter_bandpass, fft_zero_phase,
                                          filtfilt_iir, sos_filtfilt, sos_filtfilt_plain)
from eegflow_torch.signal.preprocess import (create_sequences, normalize, preprocess_recording,
                                             process_recordings, split_subjects)
from eegflow_torch.signal.spectral import (CANONICAL_BANDS, band_power, band_power_summary,
                                           welch_psd)

__all__ = ["CANONICAL_BANDS", "N_FEATURES_PER_CHANNEL", "band_power", "band_power_summary",
           "bandpass_filter", "butter_bandpass", "create_sequences", "extract_features",
           "feature_names", "fft_zero_phase", "filtfilt_iir", "normalize",
           "preprocess_recording", "process_recordings", "sos_filtfilt", "sos_filtfilt_plain",
           "split_subjects", "welch_psd"]
