"""eegflow_torch CLI: the ``synth``, ``preprocess``, ``train``, ``fit-ode``,
``integrate``, ``explain``, ``forecast``, ``export``, ``ablate`` and
``serve`` subcommands, which run the pipeline from raw recordings to a
served model, its analyses and its exports on the card:

    python -m eegflow_torch.cli.main --data-dir data/synth synth --subjects 12 --duration 120
    python -m eegflow_torch.cli.main --data-dir data/synth --output-dir outputs preprocess
    python -m eegflow_torch.cli.main --output-dir outputs train [--model transformer]
    python -m eegflow_torch.cli.main --output-dir outputs fit-ode
    python -m eegflow_torch.cli.main --output-dir outputs integrate
    python -m eegflow_torch.cli.main --output-dir outputs explain [--skip-shap]
    python -m eegflow_torch.cli.main --output-dir outputs forecast
    python -m eegflow_torch.cli.main --output-dir outputs export
    python -m eegflow_torch.cli.main --output-dir outputs ablate [--epochs N] [--hidden H]
    python -m eegflow_torch.cli.main --output-dir outputs --config cfg.json serve --port 8799

``synth`` writes a synthetic ds004148-shaped BIDS tree of BrainVision files
(host numpy; byte for byte the JAX package's). ``preprocess`` discovers and
splits the recordings, filters, z-scores and windows them on the device and
writes ``processed_data/processed_sequences.npz`` and its metadata.
``train`` reads that archive, trains the BiLSTM-attention classifier (or,
with ``--model transformer``, the EEGFormer: ``d_model`` the model
section's ``hidden_size``, its layers, heads and dropout), evaluates it on
the test split with attention and writes
``models/lstm_attention`` (``checkpoint.json`` + ``params.msgpack``),
``results/lstm_results.json`` and ``models/attention_weights.npy``.
``fit-ode`` maps the train and test eye states to cognitive-state
proportions, fits the six rates (DE and L-BFGS-B polish on kernel 11) and
writes ``results/ode_results.json``. ``integrate`` runs the coupled model on
the test split, sweeps the coupling strength and merges the model zoo's
results (``integration_results.json``, ``coupling_analysis.json``,
``all_model_results.json``). ``explain`` ranks the channels by input
gradients, permutation and (unless ``--skip-shap``) KernelSHAP and writes
``explainability_summary.json`` and ``shap_values.npy``. ``forecast``
forecasts P(closed) with the fitted ODE at 5, 10 and 20 steps
(``forecasting_results.json``). ``export`` writes the per-sample and
per-participant three-state probabilities (``{split}_sample_probabilities.csv``,
``participant_probabilities.csv``, ``three_state_summary.json``).
``ablate`` quick-trains the six architecture variants (full, no attention,
unidirectional, 1 and 2 layers, minimal; ``--hidden`` units, 10 epochs
unless ``--epochs``), compares each with the full model and writes
``sensitivity_analysis.json`` (with ``coupling_analysis.json`` reloaded
when ``integrate`` wrote one) and ``results_tables.txt``. ``serve`` loads
the checkpoint and the fitted rates and serves the coupled model over
HTTP. Every artifact is the JAX package's format, so either package reads
what the other writes; the stages after ``train`` take a checkpoint of
either model family.

``--config`` reads a ``PipelineConfig`` JSON (defaults for what it leaves
out); each stage reads its sections as the JAX package's does (``serve``:
``coupling``, ``train.lstm_impl`` and ``preprocess.sequence_length``). The
figures the JAX package's stages draw are not drawn: the plotting module is
not ported (fig01, fig04, fig07, fig08, fig10-12; fig13-fig23 of
``integrate``, ``explain`` and ``forecast``; and fig25 of ``ablate``).

``--device cuda`` (the default of every stage but ``synth``) without a
usable GPU raises; it never carries on on the CPU. ``--device cpu`` runs the
kernels' plain twins.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from eegflow_torch.convert import params_from_jax
from eegflow_torch.core.artifacts import (load_checkpoint, load_processed, load_results,
                                          save_checkpoint, save_processed, save_results)
from eegflow_torch.core.config import (CouplingConfig, PipelineConfig, TrainConfig,
                                       TransformerConfig)
from eegflow_torch.couple.rollout import CoupledModel
from eegflow_torch.ode.field import rates_to_array


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def load_config(path: Optional[str]) -> PipelineConfig:
    """The ``PipelineConfig`` JSON at ``path`` (defaults for what it leaves
    out), or the defaults without a file."""
    return PipelineConfig.from_json(path) if path else PipelineConfig()


def load_coupled_model(output_dir: str | Path, device: torch.device,
                       coupling: CouplingConfig = CouplingConfig(),
                       lstm_impl: str = "auto") -> CoupledModel:
    """The counterpart of ``eegflow.cli.main._load_coupled_model``: the
    classifier checkpoint and the fitted rates under ``output_dir``, with
    ``coupling`` and ``lstm_impl``."""
    out = Path(output_dir)
    params, model_cfg, _, _ = load_checkpoint(out / "models" / "lstm_attention")
    ode_results = load_results(out / "results" / "ode_results.json")
    return CoupledModel(
        params=params_from_jax(params, device), model_cfg=model_cfg,
        k_base=rates_to_array(ode_results["fitted_params"], device),
        coupling=coupling, lstm_impl=lstm_impl, device=device)


def load_splits(output_dir: str | Path) -> Tuple[Dict[str, np.ndarray], Optional[Dict]]:
    """The processed archive under ``output_dir`` as host arrays, and its
    metadata."""
    arrays, meta = load_processed(Path(output_dir) / "processed_data" /
                                  "processed_sequences.npz")
    return {k: np.asarray(v) for k, v in arrays.items()}, meta


def apply_small_subject_reg(train_cfg: TrainConfig, n_train_subj: Optional[int]) -> TrainConfig:
    """``eegflow.cli.main.apply_small_subject_reg``: below 12 training
    subjects add mixup + channel-dropout copies, below 20 add x2 fresh
    phase-surrogate copies, unless ``auto_small_subject_reg`` is off."""
    if not train_cfg.auto_small_subject_reg or n_train_subj is None:
        return train_cfg
    if (n_train_subj < 12 and not train_cfg.aug_mixup
            and train_cfg.aug_channel_dropout == 0.0):
        train_cfg = dataclasses.replace(train_cfg, aug_mixup=True, aug_channel_dropout=0.1)
        print(f"{n_train_subj} training subjects < 12: enabling mixup + "
              "channel-dropout regularizers")
    if n_train_subj < 20 and train_cfg.aug_phase_surrogates == 0:
        train_cfg = dataclasses.replace(train_cfg, aug_phase_surrogates=2,
                                        aug_fresh_surrogates=True)
        print(f"{n_train_subj} training subjects < 20: enabling x2 fresh "
              "phase-surrogate copies")
    return train_cfg


def _no_tf32() -> None:
    # float32 matmuls outside the kernels (dense layers, the ODE) stay float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cmd_train(args) -> None:
    from eegflow_torch.analyze.evaluate import evaluate_model
    from eegflow_torch.train.data import augment_data, make_surrogate_refresher
    from eegflow_torch.train.loop import train_classifier
    from eegflow_torch.train.steps import make_eval_step

    _no_tf32()
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    model_cfg, train_cfg = cfg.model, cfg.train
    out = Path(args.output_dir)
    models, results = out / "models", out / "results"
    models.mkdir(parents=True, exist_ok=True)
    results.mkdir(parents=True, exist_ok=True)
    arrays, meta = load_splits(out)
    x_train, y_train = arrays["X_train"], arrays["y_train"]
    x_val, y_val = arrays["X_val"], arrays["y_val"]
    if len(y_val) == 0:  # carve 15% from train, as the reference does
        n_val = max(1, int(0.15 * len(y_train)))
        x_val, y_val = x_train[-n_val:], y_train[-n_val:]
        x_train, y_train = x_train[:-n_val], y_train[:-n_val]
    if args.epochs:
        train_cfg = dataclasses.replace(train_cfg, epochs=args.epochs)
    model_cfg = dataclasses.replace(model_cfg, input_size=x_train.shape[2])
    if args.model == "transformer":
        # the EEGFormer family: its widths from the model section, as the
        # reference's stage derives them
        model_cfg = TransformerConfig(
            input_size=x_train.shape[2], d_model=cfg.model.hidden_size,
            num_layers=cfg.model.num_layers, num_heads=cfg.model.num_heads,
            dropout=cfg.model.dropout)
        print("model family: transformer (EEGFormer)")
    n_train_subj = len((meta or {}).get("splits", {}).get("train", {})
                       .get("subjects", [])) or None
    train_cfg = apply_small_subject_reg(train_cfg, n_train_subj)

    epoch_transform = None
    if train_cfg.augment:
        rng = np.random.default_rng(train_cfg.seed)
        n_orig = len(x_train)
        x_train, y_train = augment_data(x_train, y_train, rng, train_cfg.noise_std,
                                        train_cfg.max_shift, mixup=train_cfg.aug_mixup,
                                        channel_dropout=train_cfg.aug_channel_dropout,
                                        phase_surrogates=train_cfg.aug_phase_surrogates)
        print(f"augmented train set: {x_train.shape}")
        if train_cfg.aug_fresh_surrogates and train_cfg.aug_phase_surrogates:
            epoch_transform = make_surrogate_refresher(
                n_orig, train_cfg.aug_phase_surrogates, train_cfg.seed)
            print("per-epoch fresh surrogate refresh enabled")

    res = train_classifier(x_train, y_train, x_val, y_val, model_cfg, train_cfg,
                           device=device, epoch_transform=epoch_transform)
    print(f"best val F1 {res.best_val_f1:.4f} in {res.epochs_run} epochs "
          f"({res.wall_time_s:.0f}s, {res.windows_per_sec:.0f} windows/s) on {device}")

    params = params_from_jax(res.params, device)
    eval_attn = make_eval_step(model_cfg, bf16=train_cfg.bf16, return_attention=True,
                               lstm_impl=train_cfg.lstm_impl)
    probs_list, attn_list = [], []
    x_test = arrays["X_test"]
    for i in range(0, len(x_test), train_cfg.eval_batch_size):
        xb = torch.from_numpy(np.ascontiguousarray(x_test[i: i + train_cfg.eval_batch_size],
                                                   np.float32)).to(device)
        p, a = eval_attn(params, xb)
        probs_list.append(p.cpu().numpy())
        attn_list.append(a.cpu().numpy())
    probs = np.concatenate(probs_list) if probs_list else np.empty((0, 2))
    attention = np.concatenate(attn_list) if attn_list else np.empty((0, 1))
    y_test = arrays["y_test"]
    evaluation = evaluate_model(y_test, probs.argmax(1), probs[:, 1], "lstm_attention")
    print(f"test acc={evaluation['accuracy']:.4f} f1={evaluation['f1']:.4f} "
          f"auc={evaluation.get('auc', float('nan')):.4f}")

    save_checkpoint(models / "lstm_attention", res.params, model_cfg, history=res.history,
                    extra={"best_val_f1": res.best_val_f1,
                           "windows_per_sec": res.windows_per_sec})
    save_results(results / "lstm_results.json", evaluation)
    np.save(models / "attention_weights.npy", attention)


def cmd_synth(args) -> None:
    from eegflow_torch.data.synthetic import generate_synthetic_dataset

    root = generate_synthetic_dataset(
        args.data_dir, n_subjects=args.subjects, n_sessions=args.sessions,
        duration_s=args.duration, n_channels=args.channels, seed=args.seed)
    print(f"synthetic dataset written to {root}")


def cmd_preprocess(args) -> int:
    from eegflow_torch.data.bids import discover_recordings
    from eegflow_torch.data.brainvision import read_brainvision
    from eegflow_torch.signal.preprocess import process_recordings, split_subjects

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    recs = discover_recordings(args.data_dir, cfg.data.tasks, cfg.data.max_subjects)
    if not recs:
        print(f"no recordings found under {args.data_dir}")
        return 1
    print(f"found {len(recs)} recordings ({len({r['subject'] for r in recs})} subjects)")
    splits = split_subjects(recs, cfg.preprocess.train_frac, cfg.preprocess.val_frac,
                            cfg.preprocess.seed)
    loaded, n_skipped = {}, 0
    for split in ("train", "val", "test"):
        loaded[split] = []
        for r in splits.get(split, []):
            try:  # one unreadable recording does not stop the stage
                data, _ = read_brainvision(r["vhdr_path"], cfg.data.crop_seconds)
            except (OSError, ValueError) as e:
                print(f"  skipping {r['vhdr_path']}: {type(e).__name__}: {e}")
                n_skipped += 1
                continue
            loaded[split].append((r, data))
    if n_skipped:
        print(f"  skipped {n_skipped} unreadable recordings")
    arrays, meta = process_recordings(loaded, cfg.preprocess, device)
    meta["channel_names"] = [c["name"] for c in
                             read_brainvision(recs[0]["vhdr_path"])[1]["channels"]]
    npz = save_processed(Path(args.output_dir) / "processed_data", arrays, meta)
    for s in ("train", "val", "test"):
        print(f"  {s}: {arrays[f'X_{s}'].shape}")
    print(f"saved {npz}")
    return 0


def cmd_fit_ode(args) -> None:
    from eegflow_torch.fit.evolution import fit_ode_rates
    from eegflow_torch.ode.field import stability_analysis, steady_state, validate_rates
    from eegflow_torch.ode.mapping import map_eye_state_to_cognitive
    from eegflow_torch.ode.sensitivity import parameter_sensitivity

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    out = Path(args.output_dir)
    arrays, _ = load_processed(out / "processed_data" / "processed_sequences.npz")
    eye_states = np.concatenate([np.asarray(arrays["y_train"]), np.asarray(arrays["y_test"])])
    _, proportions = map_eye_state_to_cognitive(eye_states, cfg.ode.map_window_size)
    print(f"{len(eye_states)} eye states -> {len(proportions)} proportion windows")
    t = np.arange(len(proportions), dtype=np.float64)
    t_fit = time.perf_counter()
    rates, loss, info = fit_ode_rates(proportions, t, cfg.ode, device=device)
    print(f"fitted rates: { {k: round(v, 4) for k, v in rates.items()} } loss={loss:.6f} "
          f"({info}) in {time.perf_counter() - t_fit:.1f} s on {device}")
    validation = validate_rates(rates)
    for w in validation["warnings"]:
        print(f"  WARNING: {w}")
    k = rates_to_array(rates, device)
    save_results(out / "results" / "ode_results.json", {
        "fitted_params": rates,
        "fit_loss": loss,
        "fit_info": info,
        "steady_state": steady_state(k).cpu().tolist(),
        "stability": stability_analysis(k),
        "sensitivity": parameter_sensitivity(k),
        "validation": validation,
    })


def cmd_integrate(args) -> None:
    from eegflow_torch.analyze.evaluate import evaluate_model
    from eegflow_torch.analyze.tables import format_results_table, merge_all_model_results
    from eegflow_torch.couple.rollout import predict_batch
    from eegflow_torch.couple.sweep import coupling_strength_sweep

    _no_tf32()
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    results = Path(args.output_dir) / "results"
    arrays, _ = load_splits(args.output_dir)
    model = load_coupled_model(args.output_dir, device, cfg.coupling, cfg.train.lstm_impl)

    t0 = time.time()
    res = predict_batch(model, arrays["X_test"])
    dt = time.time() - t0
    n = len(arrays["y_test"])
    print(f"coupled inference: {n} samples in {dt:.2f}s ({n / max(dt, 1e-9):.0f}/s)")

    evaluation = evaluate_model(arrays["y_test"], res["pred_binary"],
                                res["probs"][:, 1], "lstm_ode_integration")
    print(f"integration acc={evaluation['accuracy']:.4f} f1={evaluation['f1']:.4f}")

    sweep = coupling_strength_sweep(model, arrays["X_test"], arrays["y_test"],
                                    cfg.coupling.sweep_alphas, cfg.coupling.forecast_steps)
    save_results(results / "integration_results.json",
                 {"evaluation": evaluation, "throughput_samples_per_sec": n / max(dt, 1e-9)})
    save_results(results / "coupling_analysis.json", sweep)

    # model-zoo comparison across all stages run so far (ref 06:636-777)
    baselines = lstm = None
    if (results / "baseline_results.json").exists():
        baselines = load_results(results / "baseline_results.json")
    if (results / "lstm_results.json").exists():
        lstm = load_results(results / "lstm_results.json")
    all_results = merge_all_model_results(baselines, lstm, {"evaluation": evaluation})
    save_results(results / "all_model_results.json", all_results)
    print(format_results_table(all_results))


def cmd_explain(args) -> None:
    from eegflow_torch.explain import (
        analyze_attention_patterns, analyze_ode_dynamics, build_summary,
        compare_importance_methods, gradient_channel_importance,
        kernel_shap_channel_importance, permutation_channel_importance,
    )

    _no_tf32()
    device = resolve_device(args.device)
    out = Path(args.output_dir)
    results = out / "results"
    arrays, meta = load_splits(out)
    params, model_cfg, _, _ = load_checkpoint(out / "models" / "lstm_attention")
    params = params_from_jax(params, device)
    channel_names = (meta or {}).get("channel_names") or None
    x_test, y_test = arrays["X_test"], arrays["y_test"]

    t0 = time.perf_counter()
    grad = gradient_channel_importance(params, model_cfg, x_test,
                                       channel_names=channel_names)
    t1 = time.perf_counter()
    perm = permutation_channel_importance(params, model_cfg, x_test, y_test,
                                          channel_names=channel_names)
    t2 = time.perf_counter()
    print(f"  gradient {t1 - t0:.0f}s | permutation {t2 - t1:.0f}s", flush=True)
    methods = [grad, perm]
    shap_light = None
    if not args.skip_shap:
        shap_res = kernel_shap_channel_importance(params, model_cfg, x_test,
                                                  channel_names=channel_names)
        print(f"  kernel-shap {time.perf_counter() - t2:.0f}s", flush=True)
        results.mkdir(parents=True, exist_ok=True)
        np.save(results / "shap_values.npy", shap_res["shap_values"])
        shap_light = {k: v for k, v in shap_res.items()
                      if k not in ("shap_values", "x_explain")}
        methods.append(shap_light)

    comparison = compare_importance_methods(methods)

    attn_path = out / "models" / "attention_weights.npy"
    attention_analysis = None
    if attn_path.exists():
        attention = np.load(attn_path)
        if len(attention) == len(y_test):
            attention_analysis = analyze_attention_patterns(attention, y_test)

    ode_analysis = None
    if (results / "ode_results.json").exists():
        ode_analysis = analyze_ode_dynamics(
            load_results(results / "ode_results.json")["fitted_params"])

    # reference-parity summary incl. region shares + clinical insights
    # (ref 07_explainability.py:1207-1273)
    summary = build_summary(
        grad, perm,
        {k: v for k, v in comparison.items() if k != "merged"},
        attention_analysis=attention_analysis,
        ode_analysis=ode_analysis,
        shap=shap_light,
    )
    save_results(results / "explainability_summary.json", summary)
    print(f"top channels: {summary['top_channels']}")


def cmd_forecast(args) -> None:
    from eegflow_torch.analyze.forecast import (evaluate_forecasts, multistep_forecast,
                                                rolling_forecast_evaluation)
    from eegflow_torch.train.loop import predict_probs

    _no_tf32()
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    out = Path(args.output_dir)
    arrays, _ = load_splits(out)
    params, model_cfg, _, _ = load_checkpoint(out / "models" / "lstm_attention")
    ode_results = load_results(out / "results" / "ode_results.json")
    k = rates_to_array(ode_results["fitted_params"], device)

    probs = predict_probs(params_from_jax(params, device), arrays["X_test"], model_cfg,
                          cfg.train.eval_batch_size)
    horizons = (5, 10, 20)
    results = multistep_forecast(probs[:, 1], k, horizons)
    metrics = evaluate_forecasts(results, horizons)
    rolling = rolling_forecast_evaluation(probs[:, 1], k)
    save_results(out / "results" / "forecasting_results.json",
                 {"metrics": {str(h): m for h, m in metrics.items()},
                  "rolling": rolling})
    for h, m in metrics.items():
        print(f"  h={h}: acc={m['accuracy']:.3f} mae={m['mae']:.3f} "
              f"rho={m['correlation']:.3f}")


def cmd_export(args) -> None:
    from eegflow_torch.analyze.export import (export_frames, participant_dataframe,
                                              sample_dataframe, three_state_probabilities)

    _no_tf32()
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    results = Path(args.output_dir) / "results"
    arrays, _ = load_splits(args.output_dir)
    model = load_coupled_model(args.output_dir, device, cfg.coupling, cfg.train.lstm_impl)

    frames = {}
    summary = {}
    for split in ("train", "val", "test"):
        x = arrays[f"X_{split}"]
        if len(x) == 0:
            continue
        res = three_state_probabilities(model, x)
        df = sample_dataframe(res["lstm_probs"], res["three_state_probs"],
                              res["predictions"], arrays[f"y_{split}"],
                              prefix=f"{split}_")
        frames[f"{split}_sample_probabilities"] = df
        summary[split] = {
            "n_samples": len(df),
            "mean_probs": res["three_state_probs"].mean(0).tolist(),
            "state_counts": {str(s): int((res["predictions"] == s).sum())
                             for s in (0, 1, 2)},
        }
        if split == "test":
            frames["participant_probabilities"] = participant_dataframe(
                df, n_participants=5  # ref 10:408-411
            )
    written = export_frames(results, frames)
    save_results(results / "three_state_summary.json", summary)
    for name, ps in written.items():
        print(f"  wrote {name}: {ps}")


def cmd_ablate(args) -> None:
    from eegflow_torch.analyze.ablation import (
        analyze_component_contribution, compute_bootstrap_intervals,
        run_architecture_ablation, run_statistical_comparison,
    )
    from eegflow_torch.analyze.tables import create_results_tables

    _no_tf32()
    device = resolve_device(args.device)
    results_dir = Path(args.output_dir) / "results"
    arrays, _ = load_splits(args.output_dir)
    t0 = time.perf_counter()
    results, predictions = run_architecture_ablation(
        arrays["X_train"], arrays["y_train"], arrays["X_test"], arrays["y_test"],
        hidden_size=args.hidden or 256, epochs=args.epochs or 10, device=device,
    )
    print(f"{len(results)} variants trained and evaluated in "
          f"{time.perf_counter() - t0:.1f} s on {device}")
    comparison = run_statistical_comparison(arrays["y_test"], predictions)
    cis = compute_bootstrap_intervals(arrays["y_test"], predictions)
    contributions = analyze_component_contribution(results)

    coupling = None
    coupling_path = results_dir / "coupling_analysis.json"
    if coupling_path.exists():
        coupling = load_results(coupling_path)  # reload (ref 09:424-461)

    save_results(results_dir / "sensitivity_analysis.json", {
        "ablation": results,
        "statistical_comparison": comparison,
        "bootstrap_cis": cis,
        "component_contributions": contributions,
        "coupling_sensitivity": coupling,
    })

    # manuscript tables (ref 09:671-703)
    all_path = results_dir / "all_model_results.json"
    all_results = load_results(all_path) if all_path.exists() else None
    tables = create_results_tables(all_results, results, comparison)
    (results_dir / "results_tables.txt").write_text("\n\n".join(tables))
    for t in tables:
        print("\n" + t)


def start_server(args):
    """The coupled model of ``--output-dir`` with the config's ``coupling``
    and ``train.lstm_impl``, served on ``--host``/``--port`` (warmed up at
    ``preprocess.sequence_length``) -> (server, model); the caller runs
    ``serve_forever``."""
    from eegflow_torch.cli.serve import serve

    _no_tf32()
    cfg = load_config(args.config)
    model = load_coupled_model(args.output_dir, resolve_device(args.device), cfg.coupling,
                               cfg.train.lstm_impl)
    return serve(model, host=args.host, port=args.port,
                 warmup_seq_len=cfg.preprocess.sequence_length), model


def cmd_serve(args) -> None:
    httpd, model = start_server(args)
    host, port = httpd.server_address[:2]
    print(f"serving coupled LSTM-ODE model on http://{host}:{port} "
          f"(POST /predict, GET /health) on {model.device}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="eegflow_torch")
    parser.add_argument("--data-dir", default="data/ds004148")
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--config", default=None, help="PipelineConfig JSON file")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("synth", help="generate a synthetic ds004148-shaped dataset")
    p.add_argument("--subjects", type=int, default=4)
    p.add_argument("--sessions", type=int, default=1)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--channels", type=int, default=61)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_synth)
    p = sub.add_parser("preprocess", help="filter, z-score and window the recordings")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_preprocess)
    p = sub.add_parser("train", help="train the BiLSTM-attention classifier")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--model", choices=["lstm", "transformer"], default="lstm",
                   help="model family: the BiLSTM or the EEGFormer attention encoder")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("fit-ode", help="fit the APF rates to the eye-state proportions")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_fit_ode)
    for name, fn, text in (
            ("integrate", cmd_integrate, "coupled inference, coupling sweep and model zoo"),
            ("forecast", cmd_forecast, "multi-horizon ODE forecasts of P(closed)"),
            ("export", cmd_export, "per-sample and per-participant three-state exports")):
        p = sub.add_parser(name, help=text)
        p.add_argument("--device", default="cuda")
        p.set_defaults(fn=fn)
    p = sub.add_parser("explain", help="gradient, permutation and KernelSHAP channel importance")
    p.add_argument("--skip-shap", action="store_true")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_explain)
    p = sub.add_parser("ablate", help="quick-train and compare the six architecture variants")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_ablate)
    p = sub.add_parser("serve", help="serve the coupled model over HTTP")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8799)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_serve)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
