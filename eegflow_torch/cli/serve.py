"""Inference server for the coupled LSTM-ODE model (``eegflow.cli.serve``).

Endpoints (JSON), the same contract as the JAX package's server:
  GET  /health            -> {"status": "ok", "model": {...}}
  POST /predict           -> {"probs": [[p_open, p_closed], ...],
                              "pred_binary": [...], "pred_three": [...],
                              "final_state": [[A, P, F], ...]}
      body: {"windows": [[[...]]]}  # (N, T, C) nested lists
      optional: {"trajectories": true} to include full (N, S, 3) rollouts

Start: ``python -m eegflow_torch.cli.main serve --port 8799 --device cuda``.

A checkpoint of either model family serves ``/predict``. ``/health`` reads
``resolved_hidden()``, which the EEGFormer's ``TransformerConfig`` lacks, so
on its checkpoint ``/health`` fails as the reference's handler does.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from eegflow_torch.couple.rollout import CoupledModel, predict_batch
from eegflow_torch.nn.model import resolve_lstm_impl


class InferenceServer:
    def __init__(self, model: CoupledModel, batch_size: int = 1024):
        self.model = model
        self.batch_size = batch_size
        self._lock = threading.Lock()

    def warmup(self, seq_len: int = 256) -> None:
        """Run one batch (builds the kernels on first use) before serving."""
        dummy = np.zeros((1, seq_len, self.model.model_cfg.input_size), np.float32)
        self.predict(dummy)

    def predict(self, windows: np.ndarray, with_trajectories: bool = False) -> dict:
        with self._lock:  # one device stream, serialized access
            res = predict_batch(self.model, windows.astype(np.float32),
                                batch_size=self.batch_size)
        out = {
            "probs": res["probs"].tolist(),
            "pred_binary": res["pred_binary"].tolist(),
            "pred_three": res["pred_three"].tolist(),
            "final_state": res["final_state"].tolist(),
        }
        if with_trajectories:
            out["trajectories"] = res["trajectories"].tolist()
        return out

    def handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    model = server.model
                    cfg = model.model_cfg
                    self._send(200, {"status": "ok", "model": {
                        "input_size": cfg.input_size,
                        "hidden_size": cfg.resolved_hidden(),
                        "num_layers": cfg.num_layers,
                        "lstm_impl": resolve_lstm_impl(model.lstm_impl, model.device),
                        "coupling_strength": model.coupling.coupling_strength,
                        "device": str(model.device),
                    }})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    windows = np.asarray(payload["windows"], np.float32)
                    if windows.ndim != 3:
                        raise ValueError(
                            f"windows must be (N, T, C); got shape {windows.shape}")
                    if windows.shape[2] != server.model.model_cfg.input_size:
                        raise ValueError(
                            f"expected {server.model.model_cfg.input_size} channels,"
                            f" got {windows.shape[2]}")
                    out = server.predict(windows, bool(payload.get("trajectories", False)))
                    self._send(200, out)
                except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})

        return Handler


class CoupledHTTPServer(ThreadingHTTPServer):
    """The HTTP server plus the thread running its warmup batch (``None``
    when no warmup was asked for)."""

    warmup_thread: Optional[threading.Thread] = None


def serve(
    model: CoupledModel,
    host: str = "127.0.0.1",
    port: int = 8799,
    warmup_seq_len: Optional[int] = 256,
) -> CoupledHTTPServer:
    """Create (and return) the HTTP server; the caller runs serve_forever().

    The socket binds at once and the warmup batch runs in a background
    thread, so /health answers while the kernels build; an early /predict
    waits for it on the server's lock.
    """
    inference = InferenceServer(model)
    httpd = CoupledHTTPServer((host, port), inference.handler_class())
    if warmup_seq_len:
        httpd.warmup_thread = threading.Thread(
            target=inference.warmup, args=(warmup_seq_len,), daemon=True)
        httpd.warmup_thread.start()
    return httpd
