"""The float32 policy end to end against the JAX package's kernel schedule:
``classifier_apply(compute_dtype=None)`` on the port's plain twins against
``eegflow.nn.model.classifier_apply(lstm_impl="pallas", compute_dtype=None)``
with the fused input block (``EEGFLOW_FUSED_INPUT=1``) and, in training,
explicit uint8 dropout masks (``EEGFLOW_MASK_DROPOUT=1``); a float32 train
step against ``make_train_step`` on that schedule; the coupled rollout with
``bf16=False``; and the ``train`` CLI stage with ``"bf16": false``. Pallas
runs in interpret mode; inputs come from numpy seeds; tiny shapes."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.core import config as jcfg
from eegflow.couple.rollout import coupled_rollout as jax_rollout
from eegflow.nn import losses as jlosses
from eegflow.nn.layers import dropout_mask as jax_dropout_mask
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow.nn.model import classifier_init as jax_init
from eegflow.ode.field import rates_to_array as jax_rates
from eegflow.train.steps import TrainState, make_optimizer as jax_make_optimizer
from eegflow.train.steps import make_train_step as jax_make_train_step
from eegflow_torch.cli.main import main as cli_main
from figure_records import patch_figures
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.couple.rollout import coupled_rollout
from eegflow_torch.nn import losses as tlosses
from eegflow_torch.nn.model import DropoutMasks, classifier_apply
from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array
from eegflow_torch.train.steps import make_optimizer, make_train_step

SMALL = dict(input_size=5, hidden_size=32, num_layers=2)
# float32 on both sides, the same operations: float32 sums in another order
# through the input block, 2 layers x 2 directions and the pool head
LOGIT_TOL = 1e-5
# gradients, relative to each leaf's largest entry (as tests/test_pallas_lstm.py
# holds the float32 kernels to the scan)
GRAD_REL_TOL = 1e-4


@pytest.fixture
def kernel_schedule(monkeypatch):
    """The JAX package's schedule that the port runs: the fused input block
    and the explicit-mask dropout of the LSTM kernels."""
    monkeypatch.setenv("EEGFLOW_FUSED_INPUT", "1")
    monkeypatch.setenv("EEGFLOW_MASK_DROPOUT", "1")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return np.asarray(tree)


def _models(kw, seed):
    jc = jcfg.ModelConfig(**kw)
    jp = jax_init(jax.random.key(seed), jc)
    return jp, jc, tcfg.ModelConfig(**kw)


def _mask_mode_masks(key, cfg, batch, steps):
    """The masks the reference's explicit-mask mode draws from ``key`` (the
    names and fold_in order of eegflow.nn.model / eegflow.nn.lstm: one mask
    per input part of each layer), as the port's DropoutMasks."""
    d, hidden = cfg.dropout, cfg.resolved_hidden()
    keys = {n: jax.random.fold_in(key, i) for i, n in enumerate(["inp", "lstm", "h1", "h2"])}
    t = lambda m: torch.from_numpy(np.array(m))  # noqa: E731
    n_dir = 2 if cfg.bidirectional else 1
    layers = tuple(
        tuple(t(jax_dropout_mask(jax.random.fold_in(jax.random.fold_in(keys["lstm"], idx), j),
                                 d, (batch, steps, hidden))) for j in range(n_dir))
        for idx in range(cfg.num_layers - 1))
    return DropoutMasks(
        input=t(jax_dropout_mask(keys["inp"], d / 2, (batch, steps, hidden))),
        layers=layers,
        head1=t(jax_dropout_mask(keys["h1"], d, (batch, hidden))),
        head2=t(jax_dropout_mask(keys["h2"], d, (batch, hidden // 2))))


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, use_attention=False),
                                dict(SMALL, use_layer_norm=False)],
                         ids=["flagship", "mean_pool", "no_ln"])
def test_classifier_f32_matches_pallas_schedule(kw, kernel_schedule):
    jp, jc, tc = _models(kw, seed=21)
    x = np.random.default_rng(21).standard_normal((5, 16, 5)).astype(np.float32)
    want_logits, want_attn = jax_apply(jp, jnp.asarray(x), jc, return_attention=True,
                                       lstm_impl="pallas")
    logits, attn = classifier_apply(params_from_jax(jp), torch.from_numpy(x), tc,
                                    return_attention=True, lstm_impl="plain")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_f32_training_forward_and_gradients_match_pallas_with_masks(bidirectional,
                                                                     kernel_schedule):
    kw = dict(SMALL, bidirectional=bidirectional)
    jp, jc, tc = _models(kw, seed=22)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((6, 16, 5)).astype(np.float32)
    y = rng.integers(0, 2, 6)
    key = jax.random.key(23)

    def loss_fn(p):
        logits = jax_apply(p, jnp.asarray(x), jc, train=True, dropout_key=key,
                           lstm_impl="pallas")
        return jlosses.cross_entropy_loss(logits, jnp.asarray(y)), logits

    (want_loss, want_logits), want = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    params = params_from_jax(jp, trainable=True)
    logits = classifier_apply(params, torch.from_numpy(x), tc, lstm_impl="plain", train=True,
                              masks=_mask_mode_masks(key, jc, 6, 16))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=LOGIT_TOL, rtol=0)
    loss = tlosses.cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < GRAD_REL_TOL * abs(float(want_loss))
    for name, p in params.named_parameters():
        if p.grad is None:  # the score bias, which softmax ignores
            np.testing.assert_array_equal(_leaf(want, name), 0.0)
        else:
            assert _rel(p.grad.numpy(), _leaf(want, name)) < GRAD_REL_TOL, name


def test_f32_train_steps_match_jax_make_train_step_on_the_kernel_schedule(kernel_schedule):
    """Dropout 0, identical params and batches, bf16 off, the JAX step on
    ``lstm_impl="pallas"``: the first step's gradient against ``jax.grad`` on
    that schedule, the loss of each of 2 steps, and the params after each
    update."""
    kw = dict(SMALL, hidden_size=16, dropout=0.0)
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    train_kw = dict(accumulation_steps=1, learning_rate=1e-3, warmup_epochs=1, epochs=4,
                    bf16=False)
    jtrain = jcfg.TrainConfig(**train_kw, lstm_impl="pallas")
    ttrain = tcfg.TrainConfig(**train_kw, lstm_impl="plain")
    jp = jax_init(jax.random.key(24), jc)
    rng = np.random.default_rng(24)
    batches = [(rng.standard_normal((8, 8, 5)).astype(np.float32), rng.integers(0, 2, 8))
               for _ in range(2)]
    cw = np.array([0.8, 1.2], np.float32)
    want_grads = jax.grad(lambda p: jlosses.cross_entropy_loss(
        jax_apply(p, jnp.asarray(batches[0][0]), jc, train=True, lstm_impl="pallas"),
        jnp.asarray(batches[0][1]), jnp.asarray(cw)))(jp)
    tx = jax_make_optimizer(jtrain, updates_per_epoch=1)
    jstep = jax_make_train_step(jc, jtrain, tx, class_weights=cw, donate=False)
    state = TrainState(jp, tx.init(jp), jnp.asarray(0))
    params = params_from_jax(jp, trainable=True)
    opt = make_optimizer(list(params.parameters()), ttrain, updates_per_epoch=1)
    tstep = make_train_step(tc, ttrain, opt, class_weights=torch.from_numpy(cw))
    for i, (x, y) in enumerate(batches):
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y), jax.random.key(i))
        tm = tstep(params, torch.from_numpy(x), torch.from_numpy(y), None)
        assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert int(tm["correct"]) == int(jm["correct"])
        for name, p in params.named_parameters():
            g = _leaf(want_grads, name)
            if i == 0 and name != "attention.score.b":
                assert _rel(p.grad.numpy(), g) < GRAD_REL_TOL, name
            # Adam's first update is lr g / (|g| + 1e-8): about lr sign(g)
            # where |g| >> 1e-8, where float32 agreement carries over (1e-6);
            # an entry whose gradient is near 1e-8 (the score bias's is
            # rounding noise) moves by anything up to lr per update
            atol = np.where(np.abs(g) >= 1e-6, 1e-6, (i + 1) * ttrain.learning_rate)
            assert (np.abs(p.detach().numpy() - _leaf(state.params, name)) <= atol).all(), name


def test_coupled_rollout_f32_matches_pallas_schedule(kernel_schedule):
    jp, jc, tc = _models(SMALL, seed=25)
    x = np.random.default_rng(25).standard_normal((4, 16, 5)).astype(np.float32)
    want = jax_rollout(jp, jnp.asarray(x), jax_rates(DEFAULT_RATES), jc, bf16=False,
                       lstm_impl="pallas")
    got = coupled_rollout(params_from_jax(jp), torch.from_numpy(x),
                          rates_to_array(DEFAULT_RATES), tc, bf16=False, lstm_impl="plain")
    for name in ("probs", "attention", "trajectories", "final_state"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=LOGIT_TOL,
                                   rtol=0, err_msg=name)


def test_train_cli_runs_the_float32_policy(tmp_path, monkeypatch):
    """``"bf16": false`` in --config: the stage trains and evaluates under
    the float32 policy (the plain twins on the CPU), and the JAX float32
    forward on its checkpoint gives its test probabilities (the figures
    recorded, not rasterised)."""
    patch_figures(monkeypatch)
    from eegflow.core.artifacts import load_checkpoint as jax_load_checkpoint

    rng = np.random.default_rng(26)
    arrays = {}
    for split, n in (("train", 48), ("val", 16), ("test", 12)):
        y = rng.permutation(np.arange(n) % 2)
        x = rng.standard_normal((n, 16, 5)).astype(np.float32)
        x[:, :, 0] += (1.5 * (2 * y - 1))[:, None]
        arrays[f"X_{split}"], arrays[f"y_{split}"] = x, y
    (tmp_path / "processed_data").mkdir()
    np.savez_compressed(tmp_path / "processed_data" / "processed_sequences.npz", **arrays)
    cfg = {"model": {"hidden_size": 32, "num_layers": 2},
           "train": {"batch_size": 16, "accumulation_steps": 2, "eval_batch_size": 32,
                     "warmup_epochs": 1, "learning_rate": 3e-3, "bf16": False}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    rc = cli_main(["--output-dir", str(tmp_path), "--config", str(tmp_path / "cfg.json"),
                   "train", "--epochs", "2", "--device", "cpu"])
    assert rc == 0
    params, mcfg, history, _ = jax_load_checkpoint(tmp_path / "models" / "lstm_attention")
    assert len(history["train_loss"]) == 2 and all(np.isfinite(history["train_loss"]))
    results = json.loads((tmp_path / "results" / "lstm_results.json").read_text())
    want = jax.nn.softmax(jax_apply(params, jnp.asarray(arrays["X_test"]), mcfg,
                                    lstm_impl="scan"), -1)
    np.testing.assert_array_equal(np.asarray(results["y_pred"]), np.asarray(want).argmax(-1))
    got = torch.softmax(classifier_apply(params_from_jax(params),
                                         torch.from_numpy(arrays["X_test"]),
                                         tcfg.ModelConfig(**dataclasses.asdict(mcfg))), -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=0)
