"""The ranks of the data-parallel tests (a helper, not a test file).

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``'s
``spawn`` method, each with the environment ``torch.distributed.run`` would
give it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and one torch thread, runs ``target(rank, case)`` in each
and returns the ranks' results in rank order. A spawned child imports the
module that holds its target: this one imports torch and eegflow_torch
only, never a test module and never JAX, so no child imports JAX
(``tests/test_torch_mesh.py`` computes the JAX references in its own
process; ``tests/test_torch_cuda.py`` runs on the card, where there is no
JAX). The targets build their mesh with
:func:`eegflow_torch.train.mesh.make_data_mesh`.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import socket
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from eegflow_torch.convert import params_from_jax, params_to_jax
from eegflow_torch.core.config import CouplingConfig, ModelConfig, TrainConfig
from eegflow_torch.couple.rollout import CoupledModel, predict_batch
from eegflow_torch.couple.sweep import coupling_strength_sweep
from eegflow_torch.analyze.forecast import multistep_forecast, rolling_forecast_evaluation
from eegflow_torch.explain.permutation import permutation_channel_importance
from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array
from eegflow_torch.train.loop import predict_probs, train_classifier
from eegflow_torch.train.mesh import (all_gather_rows, make_data_mesh, make_spmd_eval_step,
                                      make_spmd_train_step, replicate_to_mesh, shard_batch)
from eegflow_torch.train.steps import make_optimizer, make_train_step


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank, target, world, port, out_dir, case):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        result = target(rank, case)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spawn(target, case, world: int = 2):
    """``[target(rank, case) for each rank]``, run in ``world`` spawned
    processes; a failure in any raises here."""
    with tempfile.TemporaryDirectory(prefix="eegflow_mesh_") as out_dir:
        mp.spawn(_child, args=(target, world, free_port(), out_dir, case), nprocs=world,
                 join=True)
        results = []
        for rank in range(world):
            with open(Path(out_dir) / f"rank{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results


def _grads(params):
    return {name: None if p.grad is None else p.grad.numpy().copy()
            for name, p in params.named_parameters()}


def steps(rank, case):
    """shard_batch and replicate_to_mesh; one implicit (``make_train_step``
    with the mesh) and one explicit (``make_spmd_train_step``) step from
    the same params on this rank's shard of ``case``'s batch."""
    mesh = make_data_mesh(devices=[case["device"]] * case["world"])
    out = {"shard": shard_batch((case["x"], case["y"]), mesh), "shape": mesh.shape}
    out["shard"] = tuple(t.cpu().numpy() for t in out["shard"])
    try:
        shard_batch(case["x"][:-1], mesh)
        out["odd_raises"] = False
    except ValueError:
        out["odd_raises"] = True
    mine = {"t": torch.full((3,), float(rank + 1)), "n": np.arange(4) * (rank + 1)}
    rep = replicate_to_mesh(mine, mesh)
    out["replicated"] = {k: v.cpu().numpy() for k, v in rep.items()}

    model_cfg, train_cfg = ModelConfig(**case["model"]), TrainConfig(**case["train"])
    cw = torch.from_numpy(case["cw"]).to(mesh.device)
    x, y = shard_batch((case["x"], case["y"]), mesh)
    makers = {
        "implicit": lambda opt: make_train_step(model_cfg, train_cfg, opt, class_weights=cw,
                                                mesh=mesh),
        "explicit": lambda opt: make_spmd_train_step(model_cfg, train_cfg, opt, mesh,
                                                     class_weights=cw)}
    for kind, make in makers.items():
        params = params_from_jax(case["params"], mesh.device, trainable=True)
        m = make(make_optimizer(list(params.parameters()), train_cfg, updates_per_epoch=1))(
            params, x, y, None)
        out[kind] = {"loss": float(m["loss"]), "correct": int(m["correct"]),
                     "count": m["count"], "grads": _grads(params),
                     "params": params_to_jax(params)}
    return out


def philox_steps(rank, case):
    """One bf16 ``make_train_step(mesh=, kernel_dropout=True)`` step on this
    rank's shard of ``case``'s batch with the whole batch's Philox key (the
    step sets the rank's row offset), and the mesh's mask-path step on the
    rank's rows of the masks that key expands to, from the same params."""
    from eegflow_torch.nn.model import DropoutMasks, expand_dropout_masks

    mesh = make_data_mesh(devices=[case["device"]] * case["world"])
    model_cfg, train_cfg = ModelConfig(**case["model"]), TrainConfig(**case["train"])
    cw = torch.from_numpy(case["cw"]).to(mesh.device)
    x, y = shard_batch((case["x"], case["y"]), mesh)
    masks = DropoutMasks(key=torch.from_numpy(case["key"]), head1=torch.from_numpy(case["head1"]),
                         head2=torch.from_numpy(case["head2"]))
    whole = expand_dropout_masks(masks, model_cfg, *case["x"].shape[:2])
    out = {}
    for kind, (m, kernel_dropout) in {"philox": (masks, True), "masks": (whole, False)}.items():
        params = params_from_jax(case["params"], mesh.device, trainable=True)
        step = make_train_step(model_cfg, train_cfg,
                               make_optimizer(list(params.parameters()), train_cfg,
                                              updates_per_epoch=1),
                               class_weights=cw, mesh=mesh, kernel_dropout=kernel_dropout)
        metrics = step(params, x, y, shard_batch(m, mesh))
        out[kind] = {"loss": float(metrics["loss"]), "grads": _grads(params),
                     "params": params_to_jax(params)}
    return out


def explicit_philox_steps(rank, case):
    """One bf16 ``make_spmd_train_step(kernel_dropout=True)`` step on this
    rank's shard of ``case``'s batch with ``case``'s key and one shard's
    head masks, the same on every rank (the reference's explicit step hands
    every shard one key), recording every Philox mask its layers draw
    (stream, keep, row offset, the mask); and the explicit mask-path step on
    the uint8 expansion of that key's rows 0 .. B / world - 1, from the same
    params."""
    from eegflow_torch.nn import philox
    from eegflow_torch.nn.model import DropoutMasks, expand_dropout_masks

    mesh = make_data_mesh(devices=[case["device"]] * case["world"])
    model_cfg, train_cfg = ModelConfig(**case["model"]), TrainConfig(**case["train"])
    cw = torch.from_numpy(case["cw"]).to(mesh.device)
    x, y = shard_batch((case["x"], case["y"]), mesh)
    masks = replicate_to_mesh(DropoutMasks(key=torch.from_numpy(case["key"]),
                                           head1=torch.from_numpy(case["head1"]),
                                           head2=torch.from_numpy(case["head2"])), mesh)
    drawn = []
    real = philox.philox_keep_mask

    def recording(key, stream, shape, keep, row_offset=0):
        mask = real(key, stream, shape, keep, row_offset)
        drawn.append((stream, keep, row_offset, mask.cpu().numpy()))
        return mask

    out = {}
    for kind in ("philox", "masks"):
        params = params_from_jax(case["params"], mesh.device, trainable=True)
        step = make_spmd_train_step(model_cfg, train_cfg,
                                    make_optimizer(list(params.parameters()), train_cfg,
                                                   updates_per_epoch=1),
                                    mesh, class_weights=cw, kernel_dropout=kind == "philox")
        if kind == "philox":
            philox.philox_keep_mask = recording
            try:
                metrics = step(params, x, y, masks)
            finally:
                philox.philox_keep_mask = real
        else:
            metrics = step(params, x, y,
                           expand_dropout_masks(masks, model_cfg, x.shape[0], x.shape[1]))
        out[kind] = {"loss": float(metrics["loss"]), "correct": int(metrics["correct"]),
                     "grads": _grads(params), "params": params_to_jax(params)}
    out["drawn"] = drawn
    return out


def inference(rank, case):
    """predict_probs, predict_batch, the coupling sweep, the permutation
    importance (sharded and not) and the forecasts, all with the mesh."""
    mesh = make_data_mesh(devices=[case["device"]] * case["world"])
    model_cfg = ModelConfig(**case["model"])
    params = params_from_jax(case["params"], mesh.device)
    model = CoupledModel(params, model_cfg, rates_to_array(DEFAULT_RATES, mesh.device),
                         CouplingConfig(), device=mesh.device)
    x, y = case["x"], case["y"]
    out = {"probs": predict_probs(params, x, model_cfg, batch_size=5, bf16=case["bf16"],
                                  mesh=mesh),
           "batch": predict_batch(model, x, mesh=mesh),
           "batch_chunked": predict_batch(model, x, batch_size=8, mesh=mesh),
           "sweep": coupling_strength_sweep(model, x, y, alphas=(0.0, 0.5, 1.0), mesh=mesh)}
    for n_samples in (len(x) - 1, len(x)):  # sharded (even n) and not (odd n)
        out[f"perm{n_samples}"] = permutation_channel_importance(
            params, model_cfg, x, y, n_permutations=2, n_samples=n_samples, mesh=mesh)
    k = rates_to_array(DEFAULT_RATES, mesh.device)
    out["forecast"] = multistep_forecast(case["p_closed"], k, mesh=mesh)
    out["rolling"] = rolling_forecast_evaluation(case["p_closed"], k, window_size=5,
                                                 horizon=2, mesh=mesh)
    return out


def trainer(rank, case):
    """train_classifier with the mesh on ``case``'s toy set, and its refusal
    of an epoch_transform."""
    mesh = make_data_mesh(devices=[case["device"]] * case["world"])
    model_cfg, train_cfg = ModelConfig(**case["model"]), TrainConfig(**case["train"])
    res = train_classifier(*case["data"], model_cfg, train_cfg, verbose=True, mesh=mesh)
    try:
        train_classifier(*case["data"], model_cfg, train_cfg, verbose=False, mesh=mesh,
                         epoch_transform=lambda x, epoch: x)
        refused = False
    except ValueError:
        refused = True
    return {"history": res.history, "params": res.params, "epochs_run": res.epochs_run,
            "best": res.best_val_f1, "transform_refused": refused}


def cli(rank, case):
    """The CLI's stages in ``case["argv"]`` (one argument list each) with
    their standard output captured and every file write recorded; the
    figures are not drawn."""
    import eegflow_torch.cli.main as cli_main

    writes = []

    def recording(fn):
        def wrapped(path, *args, **kwargs):
            writes.append(str(path))
            return fn(path, *args, **kwargs)
        return wrapped

    cli_main.figures = lambda stage: None
    for name in ("save_results", "save_checkpoint"):
        setattr(cli_main, name, recording(getattr(cli_main, name)))
    np.save = recording(np.save)
    outputs, rcs = [], []
    for argv in case["argv"]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs.append(cli_main.main(argv))
        outputs.append(buf.getvalue())
    return {"rcs": rcs, "outputs": outputs, "writes": writes}


# the card's ranks (tests/test_torch_cuda.py)

def card_steps(rank, case):
    """One bf16 micro-step on the kernels with the mesh (and, on rank 0,
    without it, at the whole batch) from the same params and global
    masks: losses, gradients, and each rank's params after the update of
    ``case["micro_steps"]`` micro-steps gathered from every rank."""
    from eegflow_torch import kernels
    from eegflow_torch.core.prng import make_generator
    from eegflow_torch.nn.model import classifier_init, draw_dropout_masks

    mesh = make_data_mesh(devices=case["devices"], backend=case["backend"])
    dev = mesh.device
    model_cfg, train_cfg = ModelConfig(), TrainConfig()
    rng = np.random.default_rng(case["seed"])
    b, t = case["batch"], case["steps"]
    x = rng.standard_normal((b, t, model_cfg.input_size), dtype=np.float32)
    y = rng.permutation(np.arange(b) % 2)
    cw = torch.tensor([1.0, 1.0], device=dev)
    masks = draw_dropout_masks(model_cfg, b, t,
                               torch.Generator(device=dev).manual_seed(case["seed"]), dev)

    def run(mesh_or_none):
        params = classifier_init(model_cfg, make_generator(case["seed"]), dev, trainable=True)
        opt = make_optimizer(list(params.parameters()), train_cfg, updates_per_epoch=1)
        step = make_train_step(model_cfg, train_cfg, opt, class_weights=cw, mesh=mesh_or_none)
        xs, ys, ms = ((torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), masks)
                      if mesh_or_none is None else shard_batch((x, y, masks), mesh))
        kernels.reset_launch_counts()
        m = step(params, xs, ys, ms)
        torch.cuda.synchronize(dev)
        launches = dict(kernels.launch_counts)
        out = {"loss": m["loss"].cpu(), "launches": launches,
               "grads": [p.grad.cpu() if p.grad is not None else None
                         for p in params.parameters()]}
        for _ in range(case["micro_steps"] - 1):
            step(params, xs, ys, ms)
        flat = torch.cat([p.detach().reshape(-1) for p in params.parameters()])
        out["params"] = (flat.cpu() if mesh_or_none is None
                         else all_gather_rows(flat[None], mesh).cpu())
        return out

    res = {"mesh": run(mesh)}
    if rank == 0:
        res["single"] = run(None)
    evaluate = make_spmd_eval_step(model_cfg, mesh)
    params = classifier_init(model_cfg, make_generator(case["seed"]), dev)
    kernels.reset_launch_counts()
    evaluate(params, shard_batch(x, mesh))
    torch.cuda.synchronize(dev)
    res["eval_launches"] = dict(kernels.launch_counts)
    return res
