"""eegflow_torch inference server: health, predict, validation errors — over a
real HTTP socket on the CPU, mirroring tests/test_serve.py — and the CLI's
loading of the JAX package's artifacts."""

import json
import threading
from http.client import HTTPConnection

import jax
import numpy as np
import pytest
import torch

from eegflow.core.artifacts import save_checkpoint, save_results
from eegflow.core.config import ModelConfig as JaxModelConfig
from eegflow.nn.model import classifier_init as jax_classifier_init
from eegflow_torch.cli.main import build_parser, load_coupled_model, resolve_device, start_server
from eegflow_torch.cli.serve import serve
from eegflow_torch.convert import params_to_jax
from eegflow_torch.core.config import CouplingConfig, ModelConfig
from eegflow_torch.core.prng import make_generator
from eegflow_torch.couple.rollout import CoupledModel, predict_batch
from eegflow_torch.nn.model import classifier_init
from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array
from torch_threads import one_torch_thread  # noqa: F401

TOY_CFG = ModelConfig(input_size=4, hidden_size=16, num_layers=1, dropout=0.0)


@pytest.fixture(scope="module")
def server():
    model = CoupledModel(
        params=classifier_init(TOY_CFG, make_generator(0)),
        model_cfg=TOY_CFG,
        k_base=rates_to_array(DEFAULT_RATES),
        coupling=CouplingConfig(),
        device=torch.device("cpu"),
    )
    httpd = serve(model, host="127.0.0.1", port=0, warmup_seq_len=16)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address, model
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def _request(addr, method, path, payload=None):
    conn = HTTPConnection(*addr, timeout=30)
    body = json.dumps(payload) if payload is not None else None
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def test_health(server):
    addr, _ = server
    status, out = _request(addr, "GET", "/health")
    assert status == 200
    assert out["status"] == "ok"
    assert out["model"]["input_size"] == 4
    assert out["model"]["lstm_impl"] == "plain"
    assert out["model"]["device"] == "cpu"


def test_predict_matches_direct_rollout(server, rng):
    addr, model = server
    windows = rng.standard_normal((3, 16, 4)).astype(np.float32)
    status, out = _request(addr, "POST", "/predict", {"windows": windows.tolist()})
    assert status == 200
    direct = predict_batch(model, windows)
    np.testing.assert_allclose(out["probs"], direct["probs"], atol=1e-6)
    assert out["pred_binary"] == direct["pred_binary"].tolist()
    assert out["pred_three"] == direct["pred_three"].tolist()
    assert "trajectories" not in out


def test_predict_with_trajectories(server, rng):
    addr, _ = server
    windows = rng.standard_normal((2, 16, 4)).astype(np.float32)
    status, out = _request(addr, "POST", "/predict",
                           {"windows": windows.tolist(), "trajectories": True})
    assert status == 200
    traj = np.asarray(out["trajectories"])
    assert traj.shape == (2, 20, 3)
    np.testing.assert_allclose(traj.sum(-1), 1.0, atol=1e-5)


def test_predict_validation_errors(server):
    addr, _ = server
    status, out = _request(addr, "POST", "/predict", {"windows": [[1, 2]]})
    assert status == 400 and "N, T, C" in out["error"]
    status, out = _request(addr, "POST", "/predict",
                           {"windows": np.zeros((1, 16, 7)).tolist()})
    assert status == 400 and "channels" in out["error"]
    status, out = _request(addr, "POST", "/predict", {"wrong_key": 1})
    assert status == 400
    status, out = _request(addr, "GET", "/nope")
    assert status == 404


def test_cli_loads_jax_artifacts(tmp_path):
    """The serve command's loader reads the JAX package's checkpoint and
    ode_results.json and rebuilds the same model."""
    jcfg = JaxModelConfig(input_size=4, hidden_size=16, num_layers=1)
    params = jax_classifier_init(jax.random.key(1), jcfg)
    save_checkpoint(tmp_path / "models" / "lstm_attention", params, jcfg)
    rates = {"k_ap": 0.2, "k_af": 0.03, "k_pa": 0.1, "k_pf": 0.05, "k_fa": 0.07, "k_fp": 0.2}
    save_results(tmp_path / "results" / "ode_results.json", {"fitted_params": rates})
    model = load_coupled_model(tmp_path, torch.device("cpu"))
    assert model.model_cfg.hidden_size == 16 and model.model_cfg.num_layers == 1
    np.testing.assert_allclose(model.k_base.numpy(), [0.2, 0.03, 0.1, 0.05, 0.07, 0.2])
    got = params_to_jax(model.params)
    np.testing.assert_array_equal(got["lstm"][0]["bwd"]["w_hh"],
                                  np.asarray(params["lstm"][0]["bwd"]["w_hh"]))
    res = predict_batch(model, np.zeros((2, 16, 4), np.float32))
    assert res["probs"].shape == (2, 2)
    args = build_parser().parse_args(["--output-dir", str(tmp_path), "serve", "--port", "0"])
    assert args.device == "cuda" and args.port == 0


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_trainer_and_served_model_default_to_the_card():
    """As the CLI's --device: the entry points run on the card unless the
    caller asks for the CPU, as these tests do."""
    import inspect

    from eegflow_torch.train.loop import train_classifier

    assert inspect.signature(train_classifier).parameters["device"].default == "cuda"
    model = CoupledModel(params={}, model_cfg=TOY_CFG, k_base=torch.zeros(6),
                         coupling=CouplingConfig())
    assert model.device == torch.device("cuda")


def test_serve_applies_the_config(tmp_path, rng):
    """``--config`` reaches the served model: the coupling section (strength
    0.8, 30 forecast steps, floor and thresholds), train.lstm_impl and the
    warm-up length; /predict equals predict_batch with that coupling and
    differs from the default coupling's answer."""
    jcfg = JaxModelConfig(input_size=4, hidden_size=16, num_layers=1)
    save_checkpoint(tmp_path / "models" / "lstm_attention",
                    jax_classifier_init(jax.random.key(2), jcfg), jcfg)
    rates = {"k_ap": 0.2, "k_af": 0.03, "k_pa": 0.1, "k_pf": 0.05, "k_fa": 0.07, "k_fp": 0.2}
    save_results(tmp_path / "results" / "ode_results.json", {"fitted_params": rates})
    coupling = {"coupling_strength": 0.8, "forecast_steps": 30, "rate_floor": 2e-3,
                "init_threshold": 0.55, "fatigued_threshold": 0.45}
    (tmp_path / "cfg.json").write_text(json.dumps({
        "coupling": coupling, "train": {"lstm_impl": "plain"},
        "preprocess": {"sequence_length": 24}}))
    args = build_parser().parse_args(["--output-dir", str(tmp_path), "--config",
                                      str(tmp_path / "cfg.json"), "serve", "--port", "0",
                                      "--device", "cpu"])
    httpd, model = start_server(args)
    assert model.coupling == CouplingConfig(**coupling)
    assert model.lstm_impl == "plain"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        httpd.warmup_thread.join(timeout=60)
        assert not httpd.warmup_thread.is_alive()
        windows = rng.standard_normal((3, 24, 4)).astype(np.float32)
        status, out = _request(httpd.server_address, "POST", "/predict",
                               {"windows": windows.tolist(), "trajectories": True})
        status_h, health = _request(httpd.server_address, "GET", "/health")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert status == 200 and status_h == 200
    assert health["model"]["coupling_strength"] == 0.8
    want = predict_batch(model, windows)
    np.testing.assert_allclose(out["probs"], want["probs"], atol=1e-6)
    np.testing.assert_allclose(out["final_state"], want["final_state"], atol=1e-6)
    np.testing.assert_allclose(out["trajectories"], want["trajectories"], atol=1e-6)
    assert np.asarray(out["trajectories"]).shape == (3, 30, 3)
    default = CoupledModel(params=model.params, model_cfg=model.model_cfg,
                           k_base=model.k_base, coupling=CouplingConfig(),
                           device=torch.device("cpu"))
    assert np.abs(np.asarray(out["final_state"])
                  - predict_batch(default, windows)["final_state"]).max() > 1e-4
