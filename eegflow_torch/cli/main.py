"""eegflow_torch CLI: the ``serve`` subcommand.

Loads the JAX package's artifacts from ``--output-dir`` — the classifier
checkpoint ``models/lstm_attention`` (``checkpoint.json`` + ``params.msgpack``)
and the fitted rates in ``results/ode_results.json`` — and serves the
coupled model over HTTP:

    python -m eegflow_torch.cli.main --output-dir outputs serve --port 8799 --device cuda

``--device cuda`` without a usable GPU raises; it never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from eegflow_torch.convert import params_from_jax
from eegflow_torch.core.artifacts import load_checkpoint, load_results
from eegflow_torch.core.config import CouplingConfig
from eegflow_torch.couple.rollout import CoupledModel
from eegflow_torch.ode.field import rates_to_array

#: window length of the warmup batch (the preprocessing's sequence length)
WINDOW_LEN = 256


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def load_coupled_model(output_dir: str | Path, device: torch.device) -> CoupledModel:
    """The counterpart of ``eegflow.cli.main._load_coupled_model``."""
    out = Path(output_dir)
    params, model_cfg, _, _ = load_checkpoint(out / "models" / "lstm_attention")
    ode_results = load_results(out / "results" / "ode_results.json")
    return CoupledModel(
        params=params_from_jax(params, device), model_cfg=model_cfg,
        k_base=rates_to_array(ode_results["fitted_params"], device),
        coupling=CouplingConfig(), device=device)


def cmd_serve(args) -> None:
    from eegflow_torch.cli.serve import serve

    # float32 matmuls outside the kernels (dense layers, the ODE) stay float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_coupled_model(args.output_dir, resolve_device(args.device))
    httpd = serve(model, host=args.host, port=args.port,
                  warmup_seq_len=WINDOW_LEN)
    print(f"serving coupled LSTM-ODE model on http://{args.host}:{args.port} "
          f"(POST /predict, GET /health) on {model.device}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="eegflow_torch")
    parser.add_argument("--output-dir", default="outputs")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("serve", help="serve the coupled model over HTTP")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8799)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_serve)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
