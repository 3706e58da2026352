"""BrainVision reader and writer in numpy (``eegflow.data.brainvision``).

Parses the ``.vhdr`` INI header and decodes the binary ``.eeg`` payload with
one reshape and scale: BINARY data, MULTIPLEXED or VECTORIZED orientation,
INT_16 / INT_32 / IEEE_FLOAT_32 samples, per-channel resolution and unit
scaling to volts. The reference's optional native decode names a module
that does not exist, so it always takes this numpy decode; the port has
only that one.
"""

from __future__ import annotations

import configparser
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_BINARY_DTYPES = {
    "INT_16": np.int16,
    "INT_32": np.int32,
    "IEEE_FLOAT_32": np.float32,
}

_UNIT_TO_VOLTS = {
    "µV".lower(): 1e-6, "uv": 1e-6, "mv": 1e-3, "v": 1.0, "": 1e-6,
}


def read_vhdr(path: str | Path) -> Dict[str, object]:
    """Parse a BrainVision .vhdr header into a plain dict."""
    path = Path(path)
    text = path.read_text(encoding="utf-8", errors="replace")
    # the first line ("Brain Vision Data Exchange Header File ...") is not INI
    lines = [line for line in text.splitlines() if not line.startswith("Brain Vision")]
    cp = configparser.ConfigParser(interpolation=None, strict=False)
    cp.optionxform = str  # keep the keys' case
    cp.read_string("\n".join(lines))

    common = ({k.lower(): v for k, v in cp.items("Common Infos")}
              if cp.has_section("Common Infos") else {})
    binary = ({k.lower(): v for k, v in cp.items("Binary Infos")}
              if cp.has_section("Binary Infos") else {})

    channels: List[Dict[str, object]] = []
    if cp.has_section("Channel Infos"):
        for key, val in cp.items("Channel Infos"):
            if not re.fullmatch(r"Ch\d+", key):
                continue
            parts = val.split(",")
            name = parts[0].strip()
            resolution = float(parts[2]) if len(parts) > 2 and parts[2].strip() else 1.0
            unit = parts[3].strip() if len(parts) > 3 else "µV"
            channels.append({"name": name, "resolution": resolution, "unit": unit})

    sampling_interval_us = float(common.get("samplinginterval", 2000.0))
    return {
        "data_file": common.get("datafile"),
        "marker_file": common.get("markerfile"),
        "data_format": common.get("dataformat", "BINARY").upper(),
        "orientation": common.get("dataorientation", "MULTIPLEXED").upper(),
        "n_channels": int(common.get("numberofchannels", len(channels))),
        "sampling_interval_us": sampling_interval_us,
        "sampling_rate": 1e6 / sampling_interval_us,
        "binary_format": binary.get("binaryformat", "INT_16").upper(),
        "channels": channels,
    }


def read_brainvision(vhdr_path: str | Path, crop_seconds: Optional[float] = None
                     ) -> Tuple[np.ndarray, Dict[str, object]]:
    """Load a BrainVision recording -> (data (C, T) float32 volts, header);
    ``crop_seconds`` keeps the first seconds only."""
    vhdr_path = Path(vhdr_path)
    header = read_vhdr(vhdr_path)
    if header["data_format"] != "BINARY":
        raise ValueError(f"unsupported DataFormat {header['data_format']}")
    dtype = _BINARY_DTYPES.get(header["binary_format"])
    if dtype is None:
        raise ValueError(f"unsupported BinaryFormat {header['binary_format']}")

    eeg_path = vhdr_path.parent / (header["data_file"] or vhdr_path.with_suffix(".eeg").name)
    n_ch = header["n_channels"]

    raw = np.fromfile(eeg_path, dtype=dtype)
    raw = raw[:(len(raw) // n_ch) * n_ch]

    resolutions = np.asarray(
        [c["resolution"] for c in header["channels"]] or [1.0] * n_ch, np.float64)[:, None]
    units = np.asarray(
        [_UNIT_TO_VOLTS.get(str(c["unit"]).lower(), 1e-6) for c in header["channels"]]
        or [1e-6] * n_ch, np.float64)[:, None]

    if header["orientation"] == "MULTIPLEXED":
        counts = raw.reshape(-1, n_ch).T  # (C, T)
    elif header["orientation"] == "VECTORIZED":
        counts = raw.reshape(n_ch, -1)
    else:
        raise ValueError(f"unsupported DataOrientation {header['orientation']}")
    data = (counts.astype(np.float64) * resolutions * units).astype(np.float32)

    if crop_seconds is not None:
        data = data[:, :int(crop_seconds * header["sampling_rate"])]
    return data, header


def write_brainvision(out_base: str | Path, data: np.ndarray, channel_names: List[str],
                      sampling_rate: float = 500.0, resolution_uv: float = 0.1) -> Path:
    """Write (C, T) volts as a BrainVision triplet (.vhdr/.vmrk/.eeg), INT_16
    multiplexed, byte for byte as the JAX package writes it."""
    out_base = Path(out_base)
    out_base.parent.mkdir(parents=True, exist_ok=True)
    n_ch, n_t = data.shape
    if len(channel_names) != n_ch:
        raise ValueError(f"{len(channel_names)} channel names for {n_ch} channels")

    counts = np.round(data / (resolution_uv * 1e-6)).astype(np.int64)
    counts = np.clip(counts, -32768, 32767).astype(np.int16)
    counts.T.reshape(-1).tofile(out_base.with_suffix(".eeg"))  # multiplexed

    ch_lines = "\n".join(
        f"Ch{i+1}={name},,{resolution_uv},µV" for i, name in enumerate(channel_names)
    )
    vhdr = f"""Brain Vision Data Exchange Header File Version 1.0
; Generated by eegflow synthetic generator

[Common Infos]
Codepage=UTF-8
DataFile={out_base.stem}.eeg
MarkerFile={out_base.stem}.vmrk
DataFormat=BINARY
DataOrientation=MULTIPLEXED
NumberOfChannels={n_ch}
SamplingInterval={1e6 / sampling_rate:g}

[Binary Infos]
BinaryFormat=INT_16

[Channel Infos]
{ch_lines}
"""
    out_base.with_suffix(".vhdr").write_text(vhdr, encoding="utf-8")
    vmrk = f"""Brain Vision Data Exchange Marker File, Version 1.0

[Common Infos]
Codepage=UTF-8
DataFile={out_base.stem}.eeg

[Marker Infos]
Mk1=New Segment,,1,1,0
"""
    out_base.with_suffix(".vmrk").write_text(vmrk, encoding="utf-8")
    return out_base.with_suffix(".vhdr")
