"""The port's ablation module (``eegflow_torch.analyze.ablation``) against
``eegflow.analyze.ablation`` on the CPU at a tiny size: the six variants and
one quick-train step of each (plain CE, AdamW without clipping) against
``optax.adamw(1e-3)`` over the JAX package's Pallas schedule (interpret
mode, ``EEGFLOW_FUSED_INPUT=1``). The stage itself is held in
``tests/test_torch_ablation_stage.py``."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eegflow.analyze import ablation as jabl
from eegflow.core import config as jcfg
from eegflow.nn import losses as jlosses
from eegflow.nn import pallas_lstm
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow.nn.model import classifier_init as jax_init
from eegflow_torch.analyze import ablation as tabl
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.nn.model import draw_dropout_masks
from eegflow_torch.train.steps import AdamW, make_train_step
from torch_threads import one_torch_thread  # noqa: F401

C, H, T, B = 4, 32, 16, 6
LR = 1e-3
# float32 on both sides, the same operations (the port's twins against the
# Pallas kernels in interpret mode): float32 sums in another order, through
# up to 3 layers x 2 directions (as tests/test_torch_f32.py)
GRAD_REL_TOL = 1e-4
# one AdamW update from those gradients: its first step moves an entry by
# lr * g / (|g| + eps) (+ weight decay), about lr * sign(g) wherever
# |g| >> eps, so the updated parameters agree far closer than the gradients;
# where |g| is near eps (rounding noise on both sides) the map's slope
# lr eps / (|g| + eps)^2 scales the gradients' difference up, and that much
# more is allowed there (at most 2 lr)
PARAM_TOL = 1e-5
ADAM_EPS = 1e-8


@contextlib.contextmanager
def reference_flags(flags):
    """The JAX package under ``flags`` (EEGFLOW_* -> value) for the block; its
    Pallas flags are read into module globals baked into jitted traces, so
    they are refreshed and the caches cleared on the way in and out."""
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    pallas_lstm.refresh_flags()
    jax.clear_caches()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        pallas_lstm.refresh_flags()
        jax.clear_caches()


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return np.asarray(tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_ablation_configs_match_the_reference():
    assert tabl.ABLATION_CONFIGS == jabl.ABLATION_CONFIGS


@pytest.mark.parametrize("variant", [c["name"] for c in jabl.ABLATION_CONFIGS])
def test_quick_train_step_matches_optax_adamw(variant):
    """One step of each variant from the same converted parameters: the
    gradient of the plain cross-entropy and the parameters after
    ``optax.adamw(1e-3)``, float32, dropout 0."""
    spec = next(c for c in jabl.ABLATION_CONFIGS if c["name"] == variant)
    kw = dict(input_size=C, hidden_size=H, num_layers=int(spec["num_layers"]), dropout=0.0,
              bidirectional=bool(spec["bidirectional"]),
              use_attention=bool(spec["use_attention"]))
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jp = jax_init(jax.random.key(11), jc)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    y = rng.integers(0, 2, B)

    with reference_flags({"EEGFLOW_FUSED_INPUT": "1"}):
        def loss_fn(p):
            logits = jax_apply(p, jnp.asarray(x), jc, train=True,
                               dropout_key=jax.random.key(0), lstm_impl="pallas")
            return jlosses.cross_entropy_loss(logits, jnp.asarray(y))

        want_grads = jax.jit(jax.grad(loss_fn))(jp)
        tx = optax.adamw(LR)
        updates, _ = tx.update(want_grads, tx.init(jp), jp)
        want_params = optax.apply_updates(jp, updates)

    params = params_from_jax(jp, trainable=True)
    optimizer = AdamW(list(params.parameters()), LR, max_norm=None)
    step = make_train_step(tc, tcfg.TrainConfig(bf16=False, lstm_impl="plain"), optimizer)
    masks = draw_dropout_masks(tc, B, T, torch.Generator().manual_seed(0))
    step(params, torch.from_numpy(x), torch.from_numpy(y), masks)
    for name, p in params.named_parameters():
        want_g = _leaf(want_grads, name)
        if name == "attention.score.b":
            # softmax ignores it: zero up to rounding on both sides, which Adam
            # scales up against eps = 1e-8 (as test_torch_train's step test)
            got = 0.0 if p.grad is None else np.abs(p.grad.numpy()).max()
            assert got < 1e-6 and np.abs(want_g).max() < 1e-6
            atol = 2 * LR
        else:
            g = p.grad.numpy()
            assert _rel(g, want_g) < GRAD_REL_TOL, name
            small = np.minimum(np.abs(g), np.abs(want_g)) + ADAM_EPS
            atol = PARAM_TOL + np.minimum(2 * LR, LR * ADAM_EPS * np.abs(g - want_g) / small ** 2)
        diff = np.abs(p.detach().numpy() - _leaf(want_params, name))
        assert (diff <= atol).all(), (name, diff.max())
