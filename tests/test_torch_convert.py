"""eegflow_torch weight bridge, configs and checkpoint reader against the JAX
package. Everything here is exact: the bridge and the reader move bits."""

import dataclasses
import json

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from eegflow.core import config as jcfg
from eegflow.core.artifacts import save_checkpoint
from eegflow.nn.model import classifier_init as jax_classifier_init
from eegflow_torch.convert import params_from_jax, params_to_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.core.artifacts import load_checkpoint, msgpack_unpack
from eegflow_torch.core.prng import make_generator
from eegflow_torch.nn.model import classifier_init

SMALL = dict(input_size=5, hidden_size=16, num_layers=2)


def _assert_tree_equal(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, use_attention=False),
                                dict(SMALL, use_layer_norm=False, bidirectional=False)])
def test_params_round_trip_exact(kw):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_classifier_init(jax.random.key(3), jcfg.ModelConfig(**kw)))
    params = params_from_jax(tree)
    _assert_tree_equal(params_to_jax(params), tree)
    assert params["lstm"][1]["fwd"]["w_ih"].shape == tree["lstm"][1]["fwd"]["w_ih"].shape


def test_state_dict_paths_mirror_the_pytree():
    tree = jax_classifier_init(jax.random.key(0), jcfg.ModelConfig(**SMALL))
    keys = set(params_from_jax(tree).state_dict())
    for path in ("lstm.0.fwd.w_ih", "lstm.1.bwd.w_hh", "lstm.0.fwd.b", "attention.proj.w",
                 "attention.score.b", "lstm_norm.scale", "input_proj.w", "head3.b"):
        assert path in keys


def test_classifier_init_matches_jax_structure():
    cfg = jcfg.ModelConfig(**SMALL)
    want = jax.tree_util.tree_map(np.asarray, jax_classifier_init(jax.random.key(0), cfg))
    got = params_to_jax(classifier_init(tcfg.ModelConfig(**SMALL), make_generator(0)))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: a.shape, t)  # noqa: E731
    assert shapes(got) == shapes(want)
    # torch-default uniform bounds: 1/sqrt(fan_in) for dense, 1/sqrt(H) for LSTM
    assert np.abs(got["input_proj"]["w"]).max() <= 1 / np.sqrt(5)
    assert np.abs(got["lstm"][0]["fwd"]["w_hh"]).max() <= 1 / np.sqrt(16)
    assert np.abs(got["lstm"][0]["fwd"]["b"]).max() <= 2 / np.sqrt(16)
    np.testing.assert_array_equal(got["lstm_norm"]["scale"], 1.0)
    again = params_to_jax(classifier_init(tcfg.ModelConfig(**SMALL), make_generator(0)))
    _assert_tree_equal(again, got)


@pytest.mark.parametrize("name", ["ModelConfig", "CouplingConfig", "TrainConfig"])
def test_config_defaults_match_reference(name):
    ref, port = getattr(jcfg, name), getattr(tcfg, name)
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert port_fields == ref_fields
    if name == "ModelConfig":
        for kw in ({}, {"input_size": 20}, {"hidden_size": 64}):
            assert port(**kw).resolved_hidden() == ref(**kw).resolved_hidden()


def test_load_checkpoint_reads_jax_checkpoint(tmp_path):
    cfg = jcfg.ModelConfig(**SMALL)
    params = jax_classifier_init(jax.random.key(7), cfg)
    history = {"val_f1": [0.5, 0.75], "epochs": 2}
    save_checkpoint(tmp_path / "ckpt", params, cfg, history=history, extra={"note": "x"})
    got, got_cfg, got_hist, got_extra = load_checkpoint(tmp_path / "ckpt")
    _assert_tree_equal(got, jax.tree_util.tree_map(np.asarray, params))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    assert got_hist == history and got_extra == {"note": "x"}
    # and it loads straight into torch parameters
    assert params_from_jax(got)["lstm"][1]["bwd"]["w_ih"].dtype == torch.float32


def test_msgpack_decoder_matches_msgpack():
    obj = {
        "small": [0, 1, 127, -1, -32, -33, 128, 255, 256, 65535, 65536, 2**32, -2**40],
        "floats": [0.5, -1.25e-30, 3.0e300],
        "none": None, "flags": [True, False],
        "str": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70000],
        "bin": [b"", b"\x00\x01" * 20, b"q" * 70000],
        "long_list": list(range(20)),
        "wide_map": {str(i): i for i in range(20)},
    }
    packed = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_unpack(packed) == msgpack.unpackb(packed, raw=False)
    with pytest.raises(ValueError):
        msgpack_unpack(packed + b"\x00")


def test_msgpack_decoder_reads_flax_arrays():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.array([1, -2], np.int32), "d": np.float64(2.5),
                  "e": np.zeros((0, 4), np.float64), "f": np.array([True, False])}}
    got = msgpack_unpack(serialization.to_bytes(tree))
    want = serialization.msgpack_restore(serialization.to_bytes(tree))
    for k in ("a",):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    for k in ("c", "e", "f"):
        np.testing.assert_array_equal(got["b"][k], want["b"][k])
        assert got["b"][k].dtype == want["b"][k].dtype
    assert got["b"]["d"] == 2.5


def test_orbax_checkpoint_raises(tmp_path):
    (tmp_path / "checkpoint.json").write_text(json.dumps(
        {"model_config": {}, "backend": "orbax", "model_type": "ModelConfig"}))
    with pytest.raises(NotImplementedError):
        load_checkpoint(tmp_path)
