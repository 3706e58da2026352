"""Recording I/O and discovery (``eegflow.data``): the BrainVision reader and
writer, BIDS discovery and the synthetic ds004148-shaped generator. numpy
only; the ``download`` stage is not ported (no network)."""

from eegflow_torch.data.bids import discover_recordings, is_real_data
from eegflow_torch.data.brainvision import read_brainvision, read_vhdr, write_brainvision
from eegflow_torch.data.synthetic import (EEG_CHANNELS_61, generate_recording,
                                          generate_synthetic_dataset, synthetic_windows)

__all__ = ["EEG_CHANNELS_61", "discover_recordings", "generate_recording",
           "generate_synthetic_dataset", "is_real_data", "read_brainvision", "read_vhdr",
           "synthetic_windows", "write_brainvision"]
