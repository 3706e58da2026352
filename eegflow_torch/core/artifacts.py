"""Read and write the JAX package's artifacts: processed-data archives,
classifier checkpoints and result JSONs.

The on-disk checkpoint contract is ``eegflow.core.artifacts.save_checkpoint``:
a directory with ``checkpoint.json`` (embedded model config, history, extra,
backend) and ``params.msgpack`` (flax's msgpack serialization of the params
pytree). The machine this package runs on has neither ``msgpack`` nor
``flax``, so :func:`msgpack_unpack` decodes and :func:`msgpack_pack` encodes
the subset flax writes: maps, arrays, str, bin, int, float, nil, bool, and
the ext types for ndarrays (1) and numpy scalars (3), whose payload is
``packb((shape, dtype, bytes))``. Lists of the params tree are stored as
``{"0": ..., "1": ...}`` maps and map keys are sorted, so
:func:`save_checkpoint` writes the bytes the JAX package's
``save_checkpoint`` writes for the same params (its pytree pass sorts the
keys before flax's ``to_bytes``), and ``eegflow.core.artifacts.load_checkpoint``
reads them.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from eegflow_torch.convert import params_to_jax
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


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n >= 0:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if n <= hi:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, lo in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                              (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if n >= lo:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: Optional[int], fix_max: int, codes) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, hi in codes:
        if n <= hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixed:
        head = bytes([fixed[len(payload)]])
    else:
        head = _pack_len(len(payload), None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                                 (0xC9, ">I", 0xFFFFFFFF)))
    return head + struct.pack(">b", code) + payload


def _encode(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        if arr.dtype.hasobject:
            raise ValueError("object arrays cannot be stored")
        out.append(_pack_ext(_EXT_NDARRAY, msgpack_pack(
            (list(arr.shape), arr.dtype.name, arr.tobytes("C")))))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        out.append(_pack_ext(_EXT_NPSCALAR, msgpack_pack(
            (list(arr.shape), arr.dtype.name, arr.tobytes("C")))))
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(_pack_len(len(raw), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                                  (0xDB, ">I", 0xFFFFFFFF))) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_pack_len(len(obj), None, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                                 (0xC6, ">I", 0xFFFFFFFF))) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                                  (0xDD, ">I", 0xFFFFFFFF))))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                                  (0xDF, ">I", 0xFFFFFFFF))))
        for k in sorted(obj):
            _encode(k, out)
            _encode(obj[k], out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def msgpack_pack(obj: Any) -> bytes:
    """Encode one object as msgpack in the form flax's serializer writes:
    the smallest int and length forms, float64 floats, str as str and bytes
    as bin, ndarrays and numpy scalars as ext types 1 and 3, map keys
    sorted."""
    out: list = []
    _encode(obj, out)
    return b"".join(out)


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` of a params tree: lists become {"0": ...}
    maps and leaves numpy arrays (a torch parameter tree is copied to the
    host first)."""
    if not isinstance(tree, (dict, list, tuple, np.ndarray, np.generic)):
        tree = params_to_jax(tree)
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_checkpoint(path: str | Path, params: Any, model_config: ModelConfig,
                    history: Optional[Dict[str, Any]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``params`` (a numpy pytree or a torch parameter tree), the
    config, the history and ``extra`` as ``eegflow.core.artifacts.save_checkpoint``
    does with its default msgpack backend."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "params.msgpack").write_bytes(msgpack_pack(_state_dict(params)))
    cfg = {f: getattr(model_config, f) for f in model_config.__dataclass_fields__}
    payload = {"model_config": cfg, "history": _jsonable(history or {}),
               "extra": _jsonable(extra or {}), "backend": "msgpack",
               "model_type": type(model_config).__name__}
    (path / "checkpoint.json").write_text(json.dumps(payload, indent=2))
    return path


def save_results(path: str | Path, results: Dict[str, Any]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(_jsonable(results), indent=2))
    return path


def load_processed(path: str | Path, mmap: bool = True
                   ) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, Any]]]:
    """The processed archive (``processed_sequences.npz``) and, if present,
    ``preprocessing_metadata.json`` beside it."""
    path = Path(path)
    data = np.load(path, mmap_mode="r" if mmap else None, allow_pickle=False)
    arrays = {k: data[k] for k in data.files}
    meta_path = path.parent / "preprocessing_metadata.json"
    metadata = json.loads(meta_path.read_text()) if meta_path.exists() else None
    return arrays, metadata


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj
