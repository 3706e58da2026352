"""Read the JAX package's checkpoints and result JSONs.

The on-disk contract is ``eegflow.core.artifacts.save_checkpoint``: a
directory with ``checkpoint.json`` (embedded model config, history, extra,
backend) and ``params.msgpack`` (flax's msgpack serialization of the params
pytree). The machine this package serves on has neither ``msgpack`` nor
``flax``, so :func:`msgpack_unpack` decodes the subset flax writes: maps,
arrays, str, bin, int, float, nil, bool, and the ext types for ndarrays
(1) and numpy scalars (3), whose payload is ``packb((shape, dtype, bytes))``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from eegflow_torch.core.config import ModelConfig

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode()
    if b >= 0xE0:
        return b - 0x100
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        n = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b]
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        return r.unpack(fixed[b])
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return bytes(r.take(n)).decode()
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_decode(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> Dict[Any, Any]:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _ext(code: int, payload: bytes) -> Any:
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, raw = msgpack_unpack(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported in checkpoints")
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(tuple(shape))
    return arr[()] if code == _EXT_NPSCALAR else arr.copy()


def msgpack_unpack(data: bytes) -> Any:
    """Decode one msgpack object (the subset flax's serializer writes)."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack object")
    return out


def _restore_lists(tree: Any) -> Any:
    """msgpack stores Python lists as {"0": ..., "1": ...} dicts; undo that
    where the keys are exactly "0".."n-1" (``eegflow.core.artifacts``)."""
    if isinstance(tree, dict):
        restored = {k: _restore_lists(v) for k, v in tree.items()}
        keys = set(restored)
        if keys and keys == {str(i) for i in range(len(keys))}:
            return [restored[str(i)] for i in range(len(keys))]
        return restored
    return tree


def load_checkpoint(path: str | Path) -> Tuple[Any, ModelConfig, Dict, Dict]:
    """Load ``(params, ModelConfig, history, extra)`` from a checkpoint
    directory. ``params`` is the numpy pytree of ``classifier_init`` (lists
    for the LSTM stack); :func:`eegflow_torch.convert.params_from_jax`
    turns it into torch parameters."""
    path = Path(path)
    payload = json.loads((path / "checkpoint.json").read_text())
    model_type = payload.get("model_type", "ModelConfig")
    if model_type != "ModelConfig":
        raise NotImplementedError(f"model type {model_type!r} is not ported")
    if payload.get("backend") == "orbax":
        raise NotImplementedError("orbax checkpoints are not readable here; "
                                  "save with backend='msgpack'")
    cfg = ModelConfig(**payload["model_config"])
    params = _restore_lists(msgpack_unpack((path / "params.msgpack").read_bytes()))
    return params, cfg, payload.get("history", {}), payload.get("extra", {})


def load_results(path: str | Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())
