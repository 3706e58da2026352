"""Data parallelism over ``torch.distributed`` (``eegflow.train.mesh``).

The JAX package's mesh is one process driving every device it sees. The
port runs one process a device, as PyTorch does: a :class:`DataMesh` is
this process's place in a 1-D data mesh, the default process group with
its rank, its world size and its device. NCCL carries the collectives
between GPUs, gloo on the CPU (and, asked for by name, between ranks that
share one GPU). Each rank runs the whole per-rank program on its shard, so
the hand-written kernels run under a mesh as they do without one: unlike
the JAX package's ``resolve_lstm_impl(..., mesh=)``, a mesh never sends the
port to the plain path.

The JAX package's layout holds: :func:`shard_batch` gives rank r the r-th
contiguous block of the leading axis, and raises ``ValueError`` when the
world size does not divide it, as ``jax.device_put`` does.

Two training steps, as in the JAX package:

* the implicit step is :func:`~eegflow_torch.train.steps.make_train_step`
  with ``mesh=``: the single-device function (one weighted mean over the
  whole batch, the gradients summed over the ranks);
* :func:`make_spmd_train_step` is the explicit step: each rank's weighted
  mean over its shard, the gradients averaged. Under class weights and
  shards whose weight sums differ this is another function, as
  ``eegflow.train.mesh.make_spmd_train_step`` is.

Every collective goes through :func:`all_reduce_sum`, :func:`all_gather_rows`
or :func:`replicate_to_mesh`; one process of the mesh that leaves the
program early leaves the others waiting in their next collective until the
group's timeout.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from eegflow_torch.core.config import ModelConfig, TrainConfig


@dataclass(frozen=True)
class DataMesh:
    """This process's place in a 1-D data mesh: the process group, its rank
    and world size, the device it computes on and the axis's name."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    axis_name: str = "data"

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis_name: world_size}``, as a JAX mesh's ``shape`` reads."""
        return {self.axis_name: self.world_size}


def make_data_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
                   devices: Optional[Sequence[Union[str, torch.device]]] = None,
                   backend: Optional[str] = None,
                   timeout: Optional[timedelta] = None) -> DataMesh:
    """This process's :class:`DataMesh`.

    Joins the default process group or, where none is initialised yet,
    initialises it from the environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, as ``torch.distributed.run`` sets
    them; ``timeout`` is the group's). ``devices``: one device a rank, in
    mesh order; without it a rank computes on ``cuda:LOCAL_RANK``.
    ``backend``: ``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU
    unless named; ``"gloo"`` on CUDA lets ranks share one card, which NCCL
    refuses. Nothing falls back: a missing backend, two NCCL ranks on one
    card or ``n_devices`` other than the world size raises. One all-reduce
    of a scalar on the rank's device brings such faults up here.
    """
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks")
    if devices is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group's backend is {dist.get_backend()}, "
                             f"not {backend}")
    else:
        kwargs = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                **kwargs)
    mesh = DataMesh(dist.group.WORLD, rank, world, device, axis_name)
    all_reduce_sum(torch.zeros(1, device=device), mesh)
    return mesh


def _map_leaves(fn: Callable, tree: Any, whole: Optional[Callable] = None) -> Any:
    """``tree`` with ``fn`` applied to each tensor or numpy array in it
    (tuples, lists, dicts and dataclasses walked; None, ints and floats
    kept). A dataclass field whose metadata marks it ``replicated`` (such as
    :class:`~eegflow_torch.nn.model.DropoutMasks`' Philox key) takes
    ``whole`` instead, where one is given."""
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, t, whole) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, whole) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(whole if whole is not None and f.metadata.get("replicated")
                                else fn, getattr(tree, f.name), whole)
            for f in dataclasses.fields(tree)})
    raise TypeError(f"shard_batch: cannot shard a {type(tree).__name__}")


def shard_batch(batch: Any, mesh: DataMesh) -> Any:
    """This rank's contiguous block of the leading axis of each tensor or
    array in ``batch`` (tuples, lists, dicts and dataclasses such as
    :class:`~eegflow_torch.nn.model.DropoutMasks` walked), as tensors on
    the rank's device: rows ``[r n / W, (r + 1) n / W)`` for rank r of W.
    A dataclass field marked ``replicated`` (the masks' Philox key) goes to
    the device whole. A leading axis that W does not divide raises
    ``ValueError``."""
    def block(a):
        n = a.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"shard_batch: a leading axis of {n} does not divide over "
                             f"{mesh.world_size} ranks")
        part = n // mesh.world_size
        a = a[mesh.rank * part: (mesh.rank + 1) * part]
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(mesh.device)

    def whole(a):
        return (torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
                else a).to(mesh.device)

    return _map_leaves(block, batch, whole)


@torch.no_grad()
def replicate_to_mesh(tree: Any, mesh: DataMesh) -> Any:
    """``tree`` (a module's parameters, or tensors in tuples, lists, dicts
    and dataclasses) on the rank's device, with rank 0's bits on every rank:
    each tensor broadcast from rank 0. A module is updated in place."""
    if isinstance(tree, nn.Module):
        tree.to(mesh.device)
        for p in tree.parameters():
            dist.broadcast(p.data, src=0, group=mesh.group)
        return tree

    def bcast(t):
        t = (torch.from_numpy(np.ascontiguousarray(t)) if isinstance(t, np.ndarray)
             else t).to(mesh.device).contiguous()
        dist.broadcast(t, src=0, group=mesh.group)
        return t

    return _map_leaves(bcast, tree)


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``t`` summed over the ranks, in place; every rank gets the same bits."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather_rows(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along the
    leading axis in rank order: the inverse of :func:`shard_batch`."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=0)


def reduce_gradients(params: Sequence[torch.Tensor], mesh: DataMesh, loss: torch.Tensor,
                     correct: torch.Tensor, average: bool):
    """The ``.grad`` of ``params`` summed over the ranks (averaged when
    ``average``), in place, in one all-reduce of a flat float32 buffer that
    also carries the scalars ``loss`` (summed, or averaged) and ``correct``
    (summed; exact below 2^24). A parameter without a gradient has none on
    every rank and stays without. -> (loss, correct) over the mesh."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1).to(torch.float32),
                        correct.reshape(1).to(torch.float32)])
    all_reduce_sum(flat, mesh)
    if average:
        flat[:-1] /= mesh.world_size
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-2], flat[-1].to(torch.int64)


def make_spmd_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, optimizer,
                         mesh: DataMesh, class_weights: Optional[torch.Tensor] = None,
                         lstm_bwd: str = "fused", *, res_bf16: bool = False,
                         kernel_dropout: bool = False) -> Callable:
    """The JAX package's explicit step: ``step(params, x, y, masks) ->
    {"loss", "correct", "count"}`` on this rank's shard ``x``, ``y`` and its
    rows of the dropout ``masks``. Each rank takes the weighted mean of its
    shard's cross-entropy; the gradients are averaged over the ranks (one
    all-reduce, then / world size) before ``optimizer.step()``; ``loss`` is
    the mean of the ranks' losses and ``correct`` their sum. Under class
    weights this is not :func:`~eegflow_torch.train.steps.make_train_step`'s
    function (see the module docstring). ``lstm_bwd`` and ``res_bf16`` as in
    ``make_train_step``.

    ``kernel_dropout``: the stack's in-kernel Philox dropout under the JAX
    package's rule for this step, which hands every shard the same dropout
    key (``in_specs`` ``P()``), so each shard's kernels draw from it over
    the shard's own rows: every rank draws the one-process bits of rows 0
    to B / world_size - 1 (the step sets the masks' ``row_offset`` to 0),
    and its head masks are the same on every rank too. ``masks`` is then
    one shard's draw, ``draw_dropout_masks(model_cfg, B // world_size, T,
    gen, kernel_dropout=True)``, given whole to every rank
    (``replicate_to_mesh``), not sharded. ``"dualdir"``, float32 and the
    EEGFormer raise with it, as in the step without a mesh. The implicit
    step, ``make_train_step(mesh=, kernel_dropout=True)``, draws the
    one-process step's masks instead."""
    from eegflow_torch.train.steps import _make_step

    return _make_step(model_cfg, train_cfg, optimizer, class_weights, None, lstm_bwd, mesh,
                      explicit=True, res_bf16=res_bf16, kernel_dropout=kernel_dropout)


def make_spmd_eval_step(model_cfg: ModelConfig, mesh: DataMesh, bf16: bool = True,
                        lstm_impl: str = "auto") -> Callable:
    """``evaluate(params, x) -> probs`` of this rank's shard ``x``, without
    gradients, through the eval kernels on the rank's device (the JAX
    package's per-device ``shard_map`` forward; :func:`all_gather_rows`
    puts the shards together)."""
    from eegflow_torch.train.steps import make_eval_step

    evaluate = make_eval_step(model_cfg, bf16=bf16, lstm_impl=lstm_impl)

    def spmd_eval(params, x: torch.Tensor) -> torch.Tensor:
        return evaluate(params, x.to(mesh.device))

    return spmd_eval
