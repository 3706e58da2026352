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


def test_transformer_params_round_trip_exact():
    """The EEGFormer's tree (``blocks`` a list) both ways, its state_dict
    paths, and the port's init in the reference's structure."""
    jc = jcfg.TransformerConfig(input_size=5, d_model=16, num_layers=2, num_heads=2)
    tree = jax.tree_util.tree_map(np.asarray, jax_classifier_init(jax.random.key(3), jc))
    params = params_from_jax(tree)
    _assert_tree_equal(params_to_jax(params), tree)
    keys = set(params.state_dict())
    for path in ("blocks.0.mha.query.w", "blocks.1.mha.out.b", "blocks.1.mlp2.w",
                 "blocks.0.ln1.scale", "final_norm.bias", "attention.score.b", "head2.w"):
        assert path in keys
    got = params_to_jax(classifier_init(tcfg.TransformerConfig(**dataclasses.asdict(jc)),
                                        make_generator(0)))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: a.shape, t)  # noqa: E731
    assert shapes(got) == shapes(tree)


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


@pytest.mark.parametrize("name", ["ModelConfig", "CouplingConfig", "TrainConfig", "DataConfig",
                                  "PreprocessConfig", "ODEConfig", "PipelineConfig",
                                  "TransformerConfig"])
def test_config_defaults_match_reference(name):
    ref, port = getattr(jcfg, name), getattr(tcfg, name)
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert port_fields == ref_fields
    if name == "ModelConfig":
        for kw in ({}, {"input_size": 20}, {"hidden_size": 64}):
            assert port(**kw).resolved_hidden() == ref(**kw).resolved_hidden()
    if name == "TransformerConfig":
        for kw in ({}, {"input_size": 20}, {"d_model": 64}):
            assert port(**kw).resolved_d_model() == ref(**kw).resolved_d_model()
    assert port().to_dict() == ref().to_dict() if name == "PipelineConfig" else \
        dataclasses.asdict(port()) == dataclasses.asdict(ref())
    if name == "ODEConfig":
        assert port().rates() == ref().rates()


def test_pipeline_config_reads_json_as_the_reference(tmp_path):
    """The same file gives field-for-field equal trees, tuples back as
    tuples, absent sections and fields at their defaults."""
    data = {"data": {"tasks": ["eyesclosed"], "max_subjects": None},
            "preprocess": {"filter_method": "filtfilt", "sequence_length": 128},
            "ode": {"bounds": [[0.0, 1.0]] * 6, "de_maxiter": 7},
            "coupling": {"coupling_strength": 0.8, "sweep_alphas": [0.0, 1.0]},
            "train": {"bf16": False}}
    (tmp_path / "cfg.json").write_text(json.dumps(data))
    got = tcfg.PipelineConfig.from_json(tmp_path / "cfg.json")
    want = jcfg.PipelineConfig.from_json(tmp_path / "cfg.json")
    assert got.to_dict() == want.to_dict()
    assert got.ode.bounds == ((0.0, 1.0),) * 6 and got.data.tasks == ("eyesclosed",)
    assert got.coupling.sweep_alphas == (0.0, 1.0) and got.model == tcfg.ModelConfig()
    got.to_json(tmp_path / "out.json")
    assert jcfg.PipelineConfig.from_json(tmp_path / "out.json") == want


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
