"""eegflow_torch CLI: the ``synth``, ``explore``, ``preprocess``,
``baselines``, ``train``, ``fit-ode``, ``integrate``, ``explain``,
``forecast``, ``export``, ``ablate``, ``serve``, ``parity`` and ``all``
subcommands, which run the pipeline from raw recordings to a served model,
its analyses and its exports on the card:

    python -m eegflow_torch.cli.main --data-dir data/synth synth --subjects 12 --duration 120
    python -m eegflow_torch.cli.main --data-dir data/synth --output-dir outputs explore
    python -m eegflow_torch.cli.main --data-dir data/synth --output-dir outputs preprocess
    python -m eegflow_torch.cli.main --output-dir outputs baselines
    python -m eegflow_torch.cli.main --output-dir outputs train [--model transformer]
    python -m eegflow_torch.cli.main --output-dir outputs fit-ode
    python -m eegflow_torch.cli.main --output-dir outputs integrate
    python -m eegflow_torch.cli.main --output-dir outputs explain [--skip-shap]
    python -m eegflow_torch.cli.main --output-dir outputs forecast
    python -m eegflow_torch.cli.main --output-dir outputs export
    python -m eegflow_torch.cli.main --output-dir outputs ablate [--epochs N] [--hidden H]
    python -m eegflow_torch.cli.main --output-dir outputs --config cfg.json serve --port 8799
    python -m eegflow_torch.cli.main --data-dir D --output-dir outputs parity --synthetic
    python -m eegflow_torch.cli.main --data-dir D --output-dir outputs all [--epochs N]

``synth`` writes a synthetic ds004148-shaped BIDS tree of BrainVision files
(host numpy; byte for byte the JAX package's). ``explore`` counts the
recordings, summarises five of them and compares the Welch band powers
(on the device) of an eyes-open and an eyes-closed recording on a posterior
channel (O1, Oz, O2, POz or Pz): ``results/eda_report.md`` and
``results/eda_summary.json``. ``preprocess`` discovers and
splits the recordings, filters, z-scores and windows them on the device and
writes ``processed_data/processed_sequences.npz`` and its metadata.
``baselines`` extracts the 20 features a channel on the device (cached as
``models/features_{split}.npz``) and fits the SVM, random forest and
boosted trees on the host with sklearn, which must import (it raises
``ModuleNotFoundError`` otherwise): ``results/baseline_results.json`` and
``models/baseline_models.pkl``.
``train`` reads the processed archive, trains the BiLSTM-attention classifier (or,
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
HTTP. ``parity`` runs preprocess (with ``filter_method="filtfilt"``, the
one stage path to kernel 12) -> baselines -> train -> fit-ode -> integrate
and diffs the results against the reference's published table
(``parity_config.json``, ``results/parity_report.json``; ``--synthetic``
generates a synthetic set when none is on disk and marks the verdict not
comparable; ``--expect-reference`` audits the real ds004148 tree first,
``results/parity_audit.json``, and returns 2 when it is incomplete). This
package has no ``download`` stage: without a dataset, ``parity -y`` says the
download is the blocked step and returns 1. ``all`` runs explore ->
preprocess -> baselines -> train -> fit-ode -> integrate -> explain ->
forecast -> ablate -> export with ``--epochs``, ``--skip-shap``,
``--hidden`` and ``--device``, up to the first stage that fails. Every
artifact is the JAX package's format, so either package reads
what the other writes; the stages after ``train`` take a checkpoint of
either model family.

``--config`` reads a ``PipelineConfig`` JSON (defaults for what it leaves
out); each stage reads its sections as the JAX package's does (``serve``:
``coupling``, ``train.lstm_impl`` and ``preprocess.sequence_length``).
``train --profile DIR`` writes a ``torch.profiler`` Chrome trace of the
training into ``DIR``.

The stages draw the JAX package's figures under ``figures/`` (PNG and PDF
at 300 dpi, :mod:`eegflow_torch.viz.figures`): ``explore`` fig03 and fig02,
``preprocess`` fig01 and fig04, ``baselines`` fig05, ``train`` fig07 and
fig08, ``fit-ode`` fig10-fig12, ``integrate`` fig13-fig15, ``explain``
fig16-fig21 (fig21 unless ``--skip-shap``), ``forecast`` fig23 and
``ablate`` fig25. Where matplotlib does not import, a stage prints one line
saying it skipped its figures, skips their device work (fig04's filter,
fig10's solves) and writes everything else; the JAX package's stages raise
there. fig02 draws six channels and raises ``IndexError`` on fewer, as the
JAX package's does.

``--device cuda`` (the default of every stage but ``synth``) without a
usable GPU raises; it never carries on on the CPU. ``--device cpu`` runs the
kernels' plain twins.

Started by ``python -m torch.distributed.run --nproc-per-node N -m
eegflow_torch.cli.main <stage> ...`` (``WORLD_SIZE`` > 1), the CLI runs in a
data mesh of N ranks (:mod:`eegflow_torch.train.mesh`; ``--device cuda``
means ``cuda:LOCAL_RANK`` over NCCL, ``--device cpu`` gloo): ``train``,
``integrate``, ``explain`` (its permutation importance) and ``forecast``
share their batches out over the ranks, as the JAX package's stages share
them over its devices, and every other stage runs on rank 0 alone, one by
one or inside ``all``. Rank 0 alone prints the results and writes the
files; every stage ends at a barrier, whose timeout (:data:`MESH_TIMEOUT`)
bounds how long a stage may run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from datetime import timedelta
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


#: the process group's timeout under torch.distributed.run: every rank waits
#: at the end of each stage for rank 0, which runs the stages without a mesh
#: alone, so it is at least as long as the longest stage may run
MESH_TIMEOUT = timedelta(hours=6)


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


FIGURES_SKIPPED = "figures skipped"


def figures(stage: str):
    """The plotting package (:mod:`eegflow_torch.viz`) where matplotlib
    imports; else None, after one line saying that ``stage`` skipped its
    figures. Only matplotlib's absence is caught."""
    from eegflow_torch import viz
    from eegflow_torch.viz.figures import pyplot

    try:
        pyplot()
    except ModuleNotFoundError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        print(f"{stage}: {FIGURES_SKIPPED}: matplotlib does not import ({e})", flush=True)
        return None
    return viz


def _no_tf32() -> None:
    # float32 matmuls outside the kernels (dense layers, the ODE) stay float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def maybe_mesh(device: str):
    """This rank's :class:`~eegflow_torch.train.mesh.DataMesh` when the CLI
    runs under ``torch.distributed.run`` with ``WORLD_SIZE`` > 1 (``--device
    cuda``: ``cuda:LOCAL_RANK`` over NCCL; any other device, each rank on
    it), else None, as the JAX package's ``_maybe_mesh`` gives on one
    device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    from eegflow_torch.train.mesh import make_data_mesh

    resolve_device(device)
    return make_data_mesh(devices=None if device == "cuda" else [device] * world,
                          timeout=MESH_TIMEOUT)


def _writer(args) -> bool:
    """Whether this process prints the results and writes the files: rank 0
    of a mesh, or the one process without."""
    mesh = getattr(args, "mesh", None)
    return mesh is None or mesh.rank == 0


def cmd_train(args) -> None:
    from eegflow_torch.analyze.evaluate import evaluate_model
    from eegflow_torch.core.timing import torch_trace
    from eegflow_torch.train.data import augment_data, make_surrogate_refresher
    from eegflow_torch.train.loop import train_classifier
    from eegflow_torch.train.steps import make_eval_step

    _no_tf32()
    device = resolve_device(args.device)
    mesh = getattr(args, "mesh", None)
    viz = figures("train")
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
    if mesh is not None:
        print(f"data-parallel mesh over {mesh.world_size} devices")
        if epoch_transform is not None:
            # train_classifier refreshes on the single-device path only;
            # the static surrogate copies stay
            print("mesh path: per-epoch surrogate refresh disabled "
                  "(static surrogate copies keep working)")
            epoch_transform = None

    with torch_trace(getattr(args, "profile", None), device):
        res = train_classifier(x_train, y_train, x_val, y_val, model_cfg, train_cfg,
                               device=device, epoch_transform=epoch_transform, mesh=mesh)
    print(f"best val F1 {res.best_val_f1:.4f} in {res.epochs_run} epochs "
          f"({res.wall_time_s:.0f}s, {res.windows_per_sec:.0f} windows/s) on {device}")
    if not _writer(args):
        return

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
    if viz:
        figs = out / "figures"
        viz.plot_training_history(res.history, figs / "fig07_training")
        if len(attention) and len(y_test):
            viz.plot_attention_weights(attention, y_test, figs / "fig08_attention",
                                       cfg.preprocess.sampling_rate)


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
    viz = figures("preprocess")
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
    if viz:
        figs = Path(args.output_dir) / "figures"
        viz.plot_class_distribution({s: arrays[f"y_{s}"] for s in ("train", "val", "test")},
                                    figs / "fig01_class_distribution")
        if loaded["train"]:  # the stages of the first training recording
            from eegflow_torch.signal.filters import bandpass_filter
            from eegflow_torch.signal.preprocess import normalize

            p = cfg.preprocess
            raw = np.asarray(loaded["train"][0][1])
            filt = bandpass_filter(torch.from_numpy(np.ascontiguousarray(raw, np.float32))
                                   .to(device), p.lowcut, p.highcut, p.sampling_rate,
                                   p.filter_order, method=p.filter_method)
            norm, _, _ = normalize(filt)
            viz.plot_preprocessing_overview(raw, filt.cpu().numpy(), norm.cpu().numpy(),
                                            p.sampling_rate, figs / "fig04_preprocessing")
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
    viz = figures("fit-ode")
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
    analysis = {
        "fitted_params": rates,
        "fit_loss": loss,
        "fit_info": info,
        "steady_state": steady_state(k).cpu().tolist(),
        "stability": stability_analysis(k),
        "sensitivity": parameter_sensitivity(k),
        "validation": validation,
    }
    save_results(out / "results" / "ode_results.json", analysis)
    if viz:
        figs = out / "figures"
        viz.plot_ode_analysis(k.cpu().numpy(), figs / "fig10_ode_analysis",
                              analysis["sensitivity"], device=device)
        viz.plot_state_diagram(rates, figs / "fig11_state_diagram")
        viz.plot_sensitivity_heatmap(analysis["sensitivity"]["sensitivities"],
                                     figs / "fig12_sensitivity_heatmap")


def cmd_integrate(args) -> None:
    from eegflow_torch.analyze.evaluate import evaluate_model
    from eegflow_torch.analyze.tables import format_results_table, merge_all_model_results
    from eegflow_torch.couple.rollout import predict_batch
    from eegflow_torch.couple.sweep import coupling_strength_sweep

    _no_tf32()
    device = resolve_device(args.device)
    viz = figures("integrate")
    cfg = load_config(args.config)
    results = Path(args.output_dir) / "results"
    figs = Path(args.output_dir) / "figures"
    arrays, _ = load_splits(args.output_dir)
    model = load_coupled_model(args.output_dir, device, cfg.coupling, cfg.train.lstm_impl)
    mesh = getattr(args, "mesh", None)

    t0 = time.time()
    res = predict_batch(model, arrays["X_test"], mesh=mesh)
    dt = time.time() - t0
    n = len(arrays["y_test"])
    print(f"coupled inference: {n} samples in {dt:.2f}s ({n / max(dt, 1e-9):.0f}/s)")

    evaluation = evaluate_model(arrays["y_test"], res["pred_binary"],
                                res["probs"][:, 1], "lstm_ode_integration")
    print(f"integration acc={evaluation['accuracy']:.4f} f1={evaluation['f1']:.4f}")

    sweep = coupling_strength_sweep(model, arrays["X_test"], arrays["y_test"],
                                    cfg.coupling.sweep_alphas, cfg.coupling.forecast_steps,
                                    mesh=mesh)
    if not _writer(args):
        return
    save_results(results / "integration_results.json",
                 {"evaluation": evaluation, "throughput_samples_per_sec": n / max(dt, 1e-9)})
    save_results(results / "coupling_analysis.json", sweep)
    if viz:
        viz.plot_coupling_analysis(sweep, figs / "fig13_coupling")
        viz.plot_trajectory_examples(res["trajectories"], res["probs"],
                                     figs / "fig14_trajectories")

    # model-zoo comparison across all stages run so far (ref 06:636-777)
    baselines = lstm = None
    if (results / "baseline_results.json").exists():
        baselines = load_results(results / "baseline_results.json")
    if (results / "lstm_results.json").exists():
        lstm = load_results(results / "lstm_results.json")
    all_results = merge_all_model_results(baselines, lstm, {"evaluation": evaluation})
    save_results(results / "all_model_results.json", all_results)
    if viz:
        viz.plot_comprehensive_comparison(all_results, figs / "fig15_model_zoo")
    print(format_results_table(all_results))


def cmd_explain(args) -> None:
    from eegflow_torch.explain import (
        analyze_attention_patterns, analyze_ode_dynamics, build_summary,
        compare_importance_methods, gradient_channel_importance,
        kernel_shap_channel_importance, permutation_channel_importance,
    )

    _no_tf32()
    device = resolve_device(args.device)
    viz = figures("explain")
    out = Path(args.output_dir)
    results, figs = out / "results", out / "figures"
    arrays, meta = load_splits(out)
    params, model_cfg, _, _ = load_checkpoint(out / "models" / "lstm_attention")
    params = params_from_jax(params, device)
    channel_names = (meta or {}).get("channel_names") or None
    x_test, y_test = arrays["X_test"], arrays["y_test"]

    # under a mesh only the permutation importance shares its rows out, as
    # in the JAX package; rank 0 alone computes the rest
    writer = _writer(args)
    t0 = time.perf_counter()
    grad = (gradient_channel_importance(params, model_cfg, x_test, channel_names=channel_names)
            if writer else None)
    t1 = time.perf_counter()
    perm = permutation_channel_importance(params, model_cfg, x_test, y_test,
                                          channel_names=channel_names,
                                          mesh=getattr(args, "mesh", None))
    t2 = time.perf_counter()
    if not writer:
        return
    print(f"  gradient {t1 - t0:.0f}s | permutation {t2 - t1:.0f}s", flush=True)
    methods = [grad, perm]
    shap_light = None
    if not args.skip_shap:
        shap_res = kernel_shap_channel_importance(params, model_cfg, x_test,
                                                  channel_names=channel_names)
        print(f"  kernel-shap {time.perf_counter() - t2:.0f}s", flush=True)
        results.mkdir(parents=True, exist_ok=True)
        np.save(results / "shap_values.npy", shap_res["shap_values"])
        if viz:
            viz.plot_shap_analysis(shap_res["shap_values"], shap_res["x_explain"],
                                   shap_res["channels"], figs / "fig21_shap_analysis",
                                   gradient_importance=np.asarray(grad["importance"]))
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
            if viz:
                viz.plot_attention_explainability(attention, y_test,
                                                  figs / "fig18_attention_explainability")

    ode_analysis = None
    if (results / "ode_results.json").exists():
        fitted = load_results(results / "ode_results.json")["fitted_params"]
        ode_analysis = analyze_ode_dynamics(fitted)
        if viz:
            viz.plot_ode_explainability(fitted, figs / "fig20_ode_explainability")

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
    if viz:
        viz.plot_channel_importance(grad, figs / "fig16_gradient_importance")
        viz.plot_channel_importance(perm, figs / "fig17_permutation_importance")
        viz.plot_importance_comparison(comparison, figs / "fig19_importance_comparison")
    print(f"top channels: {summary['top_channels']}")


def cmd_forecast(args) -> None:
    from eegflow_torch.analyze.forecast import (evaluate_forecasts, multistep_forecast,
                                                rolling_forecast_evaluation)
    from eegflow_torch.train.loop import predict_probs

    _no_tf32()
    device = resolve_device(args.device)
    viz = figures("forecast")
    cfg = load_config(args.config)
    out = Path(args.output_dir)
    arrays, _ = load_splits(out)
    params, model_cfg, _, _ = load_checkpoint(out / "models" / "lstm_attention")
    ode_results = load_results(out / "results" / "ode_results.json")
    k = rates_to_array(ode_results["fitted_params"], device)

    mesh = getattr(args, "mesh", None)
    probs = predict_probs(params_from_jax(params, device), arrays["X_test"], model_cfg,
                          cfg.train.eval_batch_size, mesh=mesh)
    horizons = (5, 10, 20)
    results = multistep_forecast(probs[:, 1], k, horizons, mesh=mesh)
    metrics = evaluate_forecasts(results, horizons)
    rolling = rolling_forecast_evaluation(probs[:, 1], k, mesh=mesh)
    if not _writer(args):
        return
    save_results(out / "results" / "forecasting_results.json",
                 {"metrics": {str(h): m for h, m in metrics.items()},
                  "rolling": rolling})
    if viz and metrics:
        viz.plot_forecasting_results(results, metrics, list(metrics),
                                     out / "figures" / "fig23_forecasting")
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
    viz = figures("ablate")
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
    if viz:
        viz.plot_ablation_results(results, cis,
                                  Path(args.output_dir) / "figures" / "fig25_ablation")

    # manuscript tables (ref 09:671-703)
    all_path = results_dir / "all_model_results.json"
    all_results = load_results(all_path) if all_path.exists() else None
    tables = create_results_tables(all_results, results, comparison)
    (results_dir / "results_tables.txt").write_text("\n\n".join(tables))
    for t in tables:
        print("\n" + t)


def cmd_explore(args) -> None:
    from eegflow_torch.data.bids import discover_recordings
    from eegflow_torch.data.brainvision import read_brainvision
    from eegflow_torch.eda import (analyze_recordings, basic_statistics, dataset_census,
                                   generate_eda_report, spectral_summary)

    device = resolve_device(args.device)
    viz = figures("explore")
    cfg = load_config(args.config)
    results = Path(args.output_dir) / "results"
    census = dataset_census(args.data_dir, cfg.data.max_subjects)
    stats = basic_statistics(analyze_recordings(args.data_dir, n_sample=5,
                                                max_subjects=cfg.data.max_subjects))

    spectral = None
    recs = discover_recordings(args.data_dir, max_subjects=cfg.data.max_subjects)
    open_rec = next((r for r in recs if r["label"] == 0), None)
    closed_rec = next((r for r in recs if r["label"] == 1), None)
    if open_rec and closed_rec:
        open_data, header = read_brainvision(open_rec["vhdr_path"])
        closed_data, _ = read_brainvision(closed_rec["vhdr_path"])
        # a posterior alpha-carrying channel, like the reference's O1
        names = [c["name"] for c in header["channels"]]
        ch = next((names.index(w) for w in ("O1", "Oz", "O2", "POz", "Pz") if w in names),
                  len(open_data) - 1)
        spectral = spectral_summary(open_data[ch], closed_data[ch], header["sampling_rate"],
                                    device=device)
        if viz:
            figs = Path(args.output_dir) / "figures"
            viz.plot_spectral_analysis(spectral, figs / "fig03_spectral")
            viz.plot_sample_timeseries(open_data, header["sampling_rate"], names,
                                       figs / "fig02_timeseries")

    report = generate_eda_report(census, stats, spectral, results / "eda_report.md")
    save_results(results / "eda_summary.json",
                 {"census": census, "statistics": stats,
                  "alpha_ratio": spectral["alpha_closed_open_ratio"] if spectral else None})
    print(report)


def cmd_baselines(args) -> None:
    from eegflow_torch.baselines.classical import run_all_baselines

    device = resolve_device(args.device)
    viz = figures("baselines")
    cfg = load_config(args.config)
    out = Path(args.output_dir)
    arrays, _ = load_splits(out)
    t0 = time.perf_counter()
    results = run_all_baselines(
        arrays["X_train"], arrays["y_train"], arrays["X_val"], arrays["y_val"],
        arrays["X_test"], arrays["y_test"], fs=cfg.preprocess.sampling_rate,
        cache_dir=out / "models", device=device)
    print(f"{len(results)} baselines fitted and evaluated in {time.perf_counter() - t0:.1f} s "
          f"(features on {device})")
    save_results(out / "results" / "baseline_results.json", results)
    if viz:
        viz.plot_baseline_comparison(results, out / "figures" / "fig05_baselines")
    for name, r in results.items():
        print(f"  {name}: acc={r['accuracy']:.4f} f1={r['f1']:.4f} "
              f"auc={r.get('auc', float('nan')):.4f}")


def cmd_parity(args) -> int:
    """Real-data parity against the reference's published table (ref
    README.md:220-224, ±0.5 pp): preprocess with filter_method='filtfilt'
    -> baselines -> train -> fit-ode -> integrate -> every published number
    diffed. The dataset must be on disk (this package has no download stage);
    ``--synthetic`` runs the chain on the synthetic dataset, its results
    marked not comparable."""
    from eegflow_torch.analyze.parity import (compare_to_reference, format_parity_table,
                                              reference_dataset_audit)
    from eegflow_torch.data.bids import discover_recordings

    resolve_device(args.device)
    cfg = load_config(args.config)
    out = Path(args.output_dir)
    results = out / "results"
    if args.expect_reference:
        # the gate of the real check: audit the full manifest and list every
        # absent file, rather than train on whatever subset is on disk
        if args.synthetic:
            print("--expect-reference and --synthetic are mutually exclusive "
                  "(the audit is for the REAL ds004148 run)")
            return 2
        audit = reference_dataset_audit(args.data_dir, n_subjects=cfg.data.max_subjects,
                                        tasks=cfg.data.tasks)
        audit_path = save_results(results / "parity_audit.json", audit)
        if not audit["ok"]:
            print(f"reference dataset INCOMPLETE under {audit['data_dir']}: "
                  f"{audit['present']}/{audit['expected']} artifacts present, "
                  f"{len(audit['missing'])} missing (full list: {audit_path}):")
            for line in audit["missing"][:20]:
                print(f"  - {line}")
            if len(audit["missing"]) > 20:
                print(f"  ... and {len(audit['missing']) - 20} more")
            print("fix: `eegflow download -y` where network egress to OpenNeuro S3 exists, "
                  "then rerun this command")
            return 2
        print(f"reference dataset audit OK: {audit['present']}/{audit['expected']} "
              "artifacts real on disk")
    if not discover_recordings(args.data_dir, cfg.data.tasks, cfg.data.max_subjects):
        if args.synthetic:
            from eegflow_torch.data.synthetic import generate_synthetic_dataset

            generate_synthetic_dataset(args.data_dir, n_subjects=args.subjects,
                                       duration_s=args.duration, n_channels=args.channels)
            print(f"no recordings found; generated a synthetic dataset under {args.data_dir} "
                  "(results will be marked not-comparable)")
        elif args.yes:
            print("eegflow_torch has no download stage")
            print("BLOCKED STEP: downloading ds004148 requires network egress to OpenNeuro "
                  "S3 — rerun where the network allows, or pass --synthetic to exercise the "
                  "chain.")
            return 1
        else:
            print("dataset not found; pass -y to download ds004148 (the one "
                  "network-dependent step) or --synthetic for a dry run")
            return 1

    # the reference's filtfilt for the parity run (ref 02:114-131); on real
    # data also its val-F1 model selection (ref 04:572-584) in place of MCC
    cfg = dataclasses.replace(
        cfg, preprocess=dataclasses.replace(cfg.preprocess, filter_method="filtfilt"))
    if not args.synthetic:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, selection_metric="f1"))
    cfg_path = out / "parity_config.json"
    cfg_path.parent.mkdir(parents=True, exist_ok=True)
    cfg.to_json(cfg_path)
    stage_args = argparse.Namespace(
        data_dir=args.data_dir, output_dir=args.output_dir, config=str(cfg_path),
        epochs=args.epochs, model="lstm", profile=None, device=args.device)
    for fn in (cmd_preprocess, cmd_baselines, cmd_train, cmd_fit_ode, cmd_integrate):
        print(f"\n===== parity: {fn.__name__[4:]} =====")
        rc = fn(stage_args)
        if rc:
            return rc

    measured = dict(load_results(results / "baseline_results.json"))
    measured["lstm_attention"] = load_results(results / "lstm_results.json")
    measured["lstm_ode_integration"] = load_results(
        results / "integration_results.json")["evaluation"]
    report = compare_to_reference(measured, comparable=not args.synthetic)
    save_results(results / "parity_report.json", report)
    print()
    print(format_parity_table(report))
    return 0


def cmd_all(args) -> int:
    """explore -> preprocess -> baselines -> train -> fit-ode -> integrate ->
    explain -> forecast -> ablate -> export, up to the first stage that
    returns non-zero."""
    stage_args = argparse.Namespace(**vars(args), model="lstm")
    for fn in (cmd_explore, cmd_preprocess, cmd_baselines, cmd_train, cmd_fit_ode,
               cmd_integrate, cmd_explain, cmd_forecast, cmd_ablate, cmd_export):
        print(f"\n===== {fn.__name__[4:]} =====")
        rc = run_stage(fn, stage_args)
        if rc:
            return rc
    return 0


def run_stage(fn, args) -> int:
    """``fn(args)``'s return code. Under a mesh (``args.mesh``) the stages
    with mesh paths (train, integrate, explain, forecast) run on every rank
    and the others on rank 0 alone; then every rank meets the others in an
    all-reduce that carries rank 0's return code to all of them, so that no
    rank reads a file before rank 0 has written it."""
    mesh = getattr(args, "mesh", None)
    if mesh is None:
        return fn(args) or 0
    from eegflow_torch.train.mesh import all_reduce_sum

    rc = 0
    if mesh.rank == 0 or fn in (cmd_train, cmd_integrate, cmd_explain, cmd_forecast):
        rc = fn(args) or 0
    rc_t = torch.tensor([rc if mesh.rank == 0 else 0], device=mesh.device)
    return int(all_reduce_sum(rc_t, mesh).item())


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
    p = sub.add_parser("explore", help="census, recording statistics and the alpha biomarker")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_explore)
    p = sub.add_parser("preprocess", help="filter, z-score and window the recordings")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_preprocess)
    p = sub.add_parser("baselines", help="SVM, random forest and boosted trees on the features")
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_baselines)
    p = sub.add_parser("train", help="train the BiLSTM-attention classifier")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--model", choices=["lstm", "transformer"], default="lstm",
                   help="model family: the BiLSTM or the EEGFormer attention encoder")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace of the training to this directory")
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
    p = sub.add_parser("parity", help="real-data parity check vs the reference's published results")
    p.add_argument("-y", "--yes", action="store_true",
                   help="confirm the ds004148 download if absent (this package cannot download)")
    p.add_argument("--synthetic", action="store_true",
                   help="fall back to synthetic data (a dry run of the chain)")
    p.add_argument("--expect-reference", action="store_true",
                   help="audit the real ds004148 tree first and fail listing every absent file")
    p.add_argument("--subjects", type=int, default=24)
    p.add_argument("--duration", type=float, default=60.0)
    p.add_argument("--channels", type=int, default=61,
                   help="synthetic-mode channel count (real data is 61)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_parity)
    p = sub.add_parser("all", help="run the full pipeline")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--skip-shap", action="store_true")
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=cmd_all)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mesh = maybe_mesh(getattr(args, "device", "cpu"))
    if mesh is None:
        return args.fn(args) or 0
    args.mesh, args.device = mesh, str(mesh.device)
    with contextlib.ExitStack() as quiet:
        if mesh.rank != 0:  # rank 0 alone prints
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        return cmd_all(args) if args.fn is cmd_all else run_stage(args.fn, args)


if __name__ == "__main__":
    try:
        code = main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    sys.exit(code)
