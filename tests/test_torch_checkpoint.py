"""The port's checkpoint writer against the JAX package: ``params.msgpack``
byte for byte as ``eegflow.core.artifacts.save_checkpoint`` writes it, read
back by
``eegflow.core.artifacts.load_checkpoint``, with the JAX forward on it equal
to the port's. Everything that moves bits is exact."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from eegflow.core import config as jcfg
from eegflow.core.artifacts import load_checkpoint as jax_load_checkpoint
from eegflow.core.artifacts import save_checkpoint as jax_save_checkpoint
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow_torch.convert import params_to_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.core.artifacts import (load_checkpoint, load_processed, msgpack_pack,
                                          msgpack_unpack, save_checkpoint, save_results)
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.model import classifier_apply, classifier_init

# the port's float32 eval forward against the JAX scan path on the same
# weights (as test_torch_rollout)
LOGITS_TOL = 1e-5


@pytest.mark.parametrize("kw", [dict(input_size=5, hidden_size=16, num_layers=2),
                                dict(input_size=5, hidden_size=16, num_layers=1,
                                     use_layer_norm=False, bidirectional=False)])
def test_port_checkpoint_is_read_by_jax(tmp_path, kw):
    cfg = tcfg.ModelConfig(**kw)
    params = classifier_init(cfg, make_generator(3), trainable=True)
    history = {"train_loss": [0.7, 0.5], "val_f1": [0.5, 0.75]}
    save_checkpoint(tmp_path / "ckpt", params, cfg, history=history,
                    extra={"best_val_f1": np.float64(0.75), "windows_per_sec": 12.5})
    tree = params_to_jax(params)
    # byte for byte what the JAX package's save_checkpoint writes for the
    # same pytree (flax's msgpack, map keys sorted)
    jax_save_checkpoint(tmp_path / "jax_ckpt", tree, jcfg.ModelConfig(**kw))
    assert ((tmp_path / "ckpt" / "params.msgpack").read_bytes()
            == (tmp_path / "jax_ckpt" / "params.msgpack").read_bytes())
    jparams, jconfig, jhist, jextra = jax_load_checkpoint(tmp_path / "ckpt")
    assert dataclasses.asdict(jconfig) == dataclasses.asdict(cfg)
    assert jhist == history and jextra == {"best_val_f1": 0.75, "windows_per_sec": 12.5}
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    x = np.random.default_rng(3).standard_normal((4, 12, 5)).astype(np.float32)
    want = jax_apply(jparams, jnp.asarray(x), jconfig, lstm_impl="scan")
    with torch.no_grad():
        got = classifier_apply(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_TOL, rtol=0)
    # and the port reads it back exactly
    back, back_cfg, back_hist, _ = load_checkpoint(tmp_path / "ckpt")
    assert back_cfg == cfg and back_hist == history
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_msgpack_encoder_matches_msgpack():
    obj = {
        "small": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129,
                  -2**15 - 1, -2**40],
        "floats": [0.5, -1.25e-30, 3.0e300],
        "none": None, "flags": [True, False],
        "str": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70000],
        "bin": [b"", b"\x00\x01" * 20, b"q" * 70000],
        "long_list": list(range(20)),
        "wide_map": {str(i): i for i in range(20)},
    }
    # msgpack keeps insertion order: give it the sorted maps the encoder writes
    ordered = {k: (dict(sorted(v.items())) if isinstance(v, dict) else v)
               for k, v in sorted(obj.items())}
    packed = msgpack_pack(obj)
    assert packed == msgpack.packb(ordered, use_bin_type=True)
    assert msgpack_unpack(packed) == msgpack.unpackb(packed, raw=False)


def test_msgpack_encoder_arrays_round_trip():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.array([1, -2], np.int32), "d": np.float64(2.5),
                  "e": np.zeros((0, 4), np.float64), "f": np.array([True, False])}}
    packed = msgpack_pack(tree)
    assert packed == serialization.to_bytes(tree)
    back = msgpack_unpack(packed)
    for k in ("c", "e", "f"):
        np.testing.assert_array_equal(back["b"][k], tree["b"][k])
        assert back["b"][k].dtype == tree["b"][k].dtype
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["b"]["d"] == 2.5
    with pytest.raises(TypeError):
        msgpack_pack({"x": object()})


def test_results_and_processed_archive(tmp_path):
    save_results(tmp_path / "r" / "out.json", {"acc": np.float32(0.5), "cm": np.eye(2)})
    assert json.loads((tmp_path / "r" / "out.json").read_text()) == {
        "acc": 0.5, "cm": [[1.0, 0.0], [0.0, 1.0]]}
    arrays = {"X_train": np.ones((2, 3, 4), np.float32), "y_train": np.array([0, 1])}
    np.savez_compressed(tmp_path / "processed_sequences.npz", **arrays)
    got, meta = load_processed(tmp_path / "processed_sequences.npz")
    assert meta is None
    np.testing.assert_array_equal(got["X_train"], arrays["X_train"])
    (tmp_path / "preprocessing_metadata.json").write_text(json.dumps({"fs": 128}))
    assert load_processed(tmp_path / "processed_sequences.npz")[1] == {"fs": 128}
