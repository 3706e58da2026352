"""Zero-phase bandpass filters and the preprocessing pipeline
(``eegflow.signal``; the feature extractor and Welch PSD are not ported)."""

from eegflow_torch.signal.filters import (bandpass_filter, butter_bandpass, fft_zero_phase,
                                          filtfilt_iir, sos_filtfilt, sos_filtfilt_plain)
from eegflow_torch.signal.preprocess import (create_sequences, normalize, preprocess_recording,
                                             process_recordings, split_subjects)

__all__ = ["bandpass_filter", "butter_bandpass", "create_sequences", "fft_zero_phase",
           "filtfilt_iir", "normalize", "preprocess_recording", "process_recordings",
           "sos_filtfilt", "sos_filtfilt_plain", "split_subjects"]
