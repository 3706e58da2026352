"""Weight bridge between the JAX params pytree and torch parameters.

Both sides hold the pytree of ``eegflow.nn.model.classifier_init``: nested
dicts, with ``lstm`` a list of ``{"fwd", "bwd"}`` dicts, and the JAX layouts
(dense ``w`` is (in, out); LSTM ``w_ih`` (D, 4H), ``w_hh`` (H, 4H), gate order
i, f, g, o, one fused bias ``b``).

On the torch side the tree becomes an ``nn.ModuleDict`` of ``nn.ModuleList``
and ``nn.ParameterDict`` nodes. Indexing it reads like the JAX pytree
(``params["lstm"][0]["fwd"]["w_ih"]``) and its ``state_dict`` paths mirror it
(``lstm.0.fwd.w_ih``, ``attention.proj.w``). The round trip is exact.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn


def _is_leaf(v: Any) -> bool:
    return isinstance(v, (np.ndarray, np.generic, torch.Tensor))


def _leaf_tensor(v: Any) -> torch.Tensor:
    """A float32 copy of one leaf (numpy or torch) that owns its memory."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32).clone()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def module_from_tree(tree: Any, device: Optional[torch.device] = None) -> nn.Module:
    """Nested dict/list of arrays -> ModuleDict / ModuleList / ParameterDict.
    Parameters are float32 and do not require grad (the path is inference)."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([module_from_tree(v, device) for v in tree])
    if not isinstance(tree, dict):
        raise TypeError(f"expected a dict or list node, got {type(tree).__name__}")
    if tree and all(_is_leaf(v) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(_leaf_tensor(v).to(device), requires_grad=False)
            for k, v in tree.items()})
    if any(_is_leaf(v) for v in tree.values()):
        raise TypeError("a params node mixes arrays and sub-trees: "
                        f"{sorted(tree)}")
    return nn.ModuleDict({k: module_from_tree(v, device) for k, v in tree.items()})


def params_from_jax(tree: Any, device: Optional[torch.device | str] = None) -> nn.ModuleDict:
    """JAX params pytree (numpy or jax arrays) -> torch parameter tree."""
    tree = _to_numpy_tree(tree)
    return module_from_tree(tree, torch.device(device) if device else None)


def params_to_jax(params: Any) -> Any:
    """Torch parameter tree (or plain nested dict of tensors) -> numpy
    pytree in ``classifier_init``'s structure."""
    if isinstance(params, (nn.ModuleList, list, tuple)):
        return [params_to_jax(v) for v in params]
    if isinstance(params, (nn.ModuleDict, nn.ParameterDict, dict)):
        return {k: params_to_jax(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy().copy()
    raise TypeError(f"unexpected params node {type(params).__name__}")


def _to_numpy_tree(tree: Any) -> Any:
    if isinstance(tree, (list, tuple)):
        return [_to_numpy_tree(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
