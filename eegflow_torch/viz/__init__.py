"""Plotting helpers (``eegflow.viz``). Only the scalp regions of the montage
are ported; the figures are not."""

from eegflow_torch.viz.regions import CHANNEL_REGIONS, aggregate_by_region, region_of

__all__ = ["CHANNEL_REGIONS", "aggregate_by_region", "region_of"]
