"""The port's training path against eegflow.train: losses, schedule, the
optimizer against optax, the train-mode forward with the reference's dropout
masks fed in, train steps against ``make_train_step``, the trainer, the data
plumbing and the ``train`` CLI stage. Inputs are made with numpy from a seed;
tiny shapes."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eegflow.analyze import evaluate as jeval
from eegflow.core import config as jcfg
from eegflow.nn import losses as jlosses
from eegflow.nn.layers import dropout_mask as jax_dropout_mask
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow.nn.model import classifier_init as jax_init
from eegflow.nn.pallas_input import input_block_fused as jax_input_block
from eegflow.train import data as jdata
from eegflow.train import schedule as jsched
from eegflow.train.steps import TrainState, make_optimizer as jax_make_optimizer
from eegflow.train.steps import make_train_step as jax_make_train_step
from eegflow_torch.analyze import evaluate as teval
from eegflow_torch.cli.main import main as cli_main
from eegflow_torch.convert import params_from_jax, params_to_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.nn import losses as tlosses
from eegflow_torch.nn.cuda_input import input_block_fused_plain
from eegflow_torch.nn.model import DropoutMasks, classifier_apply, draw_dropout_masks
from eegflow_torch.train import data as tdata
from eegflow_torch.train import schedule as tsched
from eegflow_torch.train.loop import train_classifier
from eegflow_torch.train.steps import make_optimizer, make_train_step
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(input_size=5, hidden_size=16, num_layers=2)
# float32 policy: the eager stack against the scan, float32 sums in another
# order through 2 layers of 16 steps (as test_torch_lstm)
F32_TOL = 1e-5
# bf16 policy: the fused schedule (tanh-form sigmoid, bf16 operands inside
# the pool head) against the reference's scan path (exp-form sigmoid, bf16
# dense layers in the additive attention); the JAX package holds its own
# fused kernels to the scan at this relative tolerance
# (tests/test_pallas_lstm.py, test_fully_fused_amp_layer_grads_close_to_scan)
BF16_REL_TOL = 2e-2
# the port's fused schedule against the reference's fused schedule (twins vs
# Pallas kernels in interpret mode, the same bf16 rounding points): float32
# sums in another order and the bf16 flips they cause (as
# test_torch_lstm_bwd / test_torch_pool_head_bwd)
FUSED_REL_TOL = 2e-3
# optimizer on identical gradient streams: the same float32 arithmetic in
# the same order, except the global norm's sum over leaves (JAX sorts them)
OPT_REL_TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(weighted):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((7, 3)).astype(np.float32)
    y = rng.integers(0, 3, 7)
    w = np.array([0.5, 1.2, 2.0], np.float32) if weighted else None
    want = jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(y),
                                      None if w is None else jnp.asarray(w))
    got = tlosses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(y),
                                     None if w is None else torch.from_numpy(w))
    assert abs(got.item() - float(want)) < 1e-6


@pytest.mark.parametrize("alpha", [False, True])
def test_focal_loss_matches_jax(alpha):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((9, 2)).astype(np.float32)
    y = rng.integers(0, 2, 9)
    a = np.array([0.25, 0.75], np.float32) if alpha else None
    want = jlosses.focal_loss(jnp.asarray(logits), jnp.asarray(y), 2.0,
                              None if a is None else jnp.asarray(a))
    got = tlosses.focal_loss(torch.from_numpy(logits), torch.from_numpy(y), 2.0,
                             None if a is None else torch.from_numpy(a))
    assert abs(got.item() - float(want)) < 1e-6


def test_schedule_matches_jax():
    want = jsched.warmup_cosine_schedule(3e-4, 20, 5, 3)
    got = tsched.warmup_cosine_schedule(3e-4, 20, 5, 3)
    for step in range(60):
        assert abs(got(step) - float(want(step))) <= 1e-6 * float(want(step))
    np.testing.assert_allclose(tsched.lr_trace(3e-4, 20, 5), jsched.lr_trace(3e-4, 20, 5),
                               rtol=1e-12)


def test_optimizer_matches_optax_multisteps():
    """clip_by_global_norm + adamw inside MultiSteps(4) on identical gradient
    streams, including a leaf that never gets a gradient (decay only)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "score_b": (1,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cfg = tcfg.TrainConfig(learning_rate=1e-2, weight_decay=1e-2, epochs=6, warmup_epochs=2)
    tx = jax_make_optimizer(jcfg.TrainConfig(**dataclasses.asdict(cfg)), updates_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    opt = make_optimizer(list(tp.values()), cfg, updates_per_epoch=2)
    for i in range(16):
        scale = 3.0 if i % 3 else 0.05   # some updates clipped, some not
        g = {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        g["score_b"] = np.zeros(1, np.float32)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = None if k == "score_b" else torch.from_numpy(g[k])
        changed = opt.step()
        assert changed == ((i + 1) % 4 == 0)
        for k in shapes:
            assert _rel(tp[k].numpy(), jp[k]) <= OPT_REL_TOL, (i, k)
    # weight decay shrank the leaf that never had a gradient: 4 updates
    assert abs(tp["score_b"].item()) < abs(p0["score_b"][0])


def test_score_bias_decays_in_a_train_step():
    """The attention score bias gets no gradient (softmax ignores it); the
    step still applies AdamW's decay to it, as optax decays every leaf."""
    cfg = tcfg.ModelConfig(**SMALL)
    tcfg_train = tcfg.TrainConfig(accumulation_steps=1, learning_rate=1e-2, weight_decay=0.1,
                                  warmup_epochs=1, epochs=3)
    params = params_from_jax(jax_init(jax.random.key(0), jcfg.ModelConfig(**SMALL)),
                             trainable=True)
    before = params["attention"]["score"]["b"].detach().clone()
    opt = make_optimizer(list(params.parameters()), tcfg_train, updates_per_epoch=1)
    step = make_train_step(cfg, tcfg_train, opt)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((6, 12, 5)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, 6))
    masks = draw_dropout_masks(cfg, 6, 12, torch.Generator().manual_seed(0))
    step(params, x, y, masks)
    assert params["attention"]["score"]["b"].grad is None
    lr = opt.schedule(0)
    want = before + torch.tensor(-lr, dtype=torch.float32) * (0.1 * before)
    assert torch.equal(params["attention"]["score"]["b"].detach(), want)


def _jax_masks(key, cfg, batch, steps):
    """The masks the reference's scan path draws from ``key`` (names and
    fold_in order of eegflow.nn.model / eegflow.nn.lstm), as the port's
    DropoutMasks: the concatenated inter-layer mask split into the parts."""
    d, hidden = cfg.dropout, cfg.resolved_hidden()
    keys = {n: jax.random.fold_in(key, i) for i, n in enumerate(["inp", "lstm", "h1", "h2"])}
    t = lambda m: torch.from_numpy(np.array(m))  # noqa: E731
    n_dir = 2 if cfg.bidirectional else 1
    layers = []
    for idx in range(cfg.num_layers - 1):
        m = t(jax_dropout_mask(jax.random.fold_in(keys["lstm"], idx), d,
                               (batch, steps, n_dir * hidden)))
        layers.append(tuple(m.split(hidden, dim=-1)))
    return DropoutMasks(
        input=t(jax_dropout_mask(keys["inp"], d / 2, (batch, steps, hidden))),
        layers=tuple(layers),
        head1=t(jax_dropout_mask(keys["h1"], d, (batch, hidden))),
        head2=t(jax_dropout_mask(keys["h2"], d, (batch, hidden // 2))))


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_train_forward_matches_jax_scan_with_its_masks(bf16, bidirectional):
    jc = jcfg.ModelConfig(**SMALL, bidirectional=bidirectional)
    tc = tcfg.ModelConfig(**SMALL, bidirectional=bidirectional)
    jp = jax_init(jax.random.key(5), jc)
    x = np.random.default_rng(5).standard_normal((6, 16, 5)).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jax_apply(jp, jnp.asarray(x), jc, train=True, dropout_key=key,
                                compute_dtype=jnp.bfloat16 if bf16 else None,
                                lstm_impl="scan"))
    masks = _jax_masks(key, jc, 6, 16)
    got = classifier_apply(params_from_jax(jp), torch.from_numpy(x), tc,
                           compute_dtype=torch.bfloat16 if bf16 else None,
                           train=True, masks=masks).numpy()
    if bf16:
        assert _rel(got, want) < BF16_REL_TOL
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    # the masks matter: eval mode gives other logits
    eval_logits = classifier_apply(params_from_jax(jp), torch.from_numpy(x), tc,
                                   compute_dtype=torch.bfloat16 if bf16 else None).numpy()
    assert np.abs(eval_logits - got).max() > 1e-3


@pytest.mark.parametrize("kw", [dict(use_attention=False), dict(bidirectional=False),
                                dict(use_layer_norm=False)])
def test_ablation_gradients_match_the_jax_fused_path(kw, monkeypatch):
    """The ablation switches through the differentiable bf16 schedule (mean
    pooling after the fused stack, a unidirectional stack, the pool head
    without LayerNorm) against jax.grad of the reference's own fused path
    (Pallas kernels in interpret mode, the fused input block included, as
    the port runs it), dropout 0.

    The tolerance holds while both sides round the same values to the same
    bf16 operands. The two sides agree to float32 rounding (the input blocks
    to ~5e-7), so a value within that distance of a bf16 rounding tie can
    round the other way, and one such flip moves the gradients by 2e-3 to
    2e-2 at these widths (measured: the windows of seeds 12, 13 and 16 each
    hold one, in the input block or in the stack). The windows here (seed
    14) hold none; the test checks the input block's part of that first."""
    monkeypatch.setenv("EEGFLOW_FUSED_INPUT", "1")
    mk = dict(SMALL, dropout=0.0, **kw)
    jc, tc = jcfg.ModelConfig(**mk), tcfg.ModelConfig(**mk)
    jp = jax_init(jax.random.key(12), jc)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((6, 8, 5)).astype(np.float32)
    y = rng.integers(0, 2, 6)
    params = params_from_jax(jp, trainable=True)

    bf16_ops = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16))  # noqa: E731
    block_want = jax_input_block(jp["input_proj"], jp["input_norm"], jnp.asarray(x), bf16=True)
    with torch.no_grad():
        block_got = input_block_fused_plain(params["input_proj"], params["input_norm"],
                                            torch.from_numpy(x), bf16=True)
    np.testing.assert_array_equal(bf16_ops(block_got.numpy()), bf16_ops(block_want))

    def loss_fn(p):
        logits = jax_apply(p, jnp.asarray(x), jc, train=True, compute_dtype=jnp.bfloat16,
                           lstm_impl="pallas")
        return jlosses.cross_entropy_loss(logits, jnp.asarray(y))

    want_loss, want = jax.value_and_grad(loss_fn)(jp)
    logits = classifier_apply(params, torch.from_numpy(x), tc, compute_dtype=torch.bfloat16,
                              train=True, masks=draw_dropout_masks(tc, 6, 8, None))
    loss = tlosses.cross_entropy_loss(logits, torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < FUSED_REL_TOL * abs(float(want_loss))
    for name, p in params.named_parameters():
        g = want
        for part in name.split("."):
            g = g[int(part)] if isinstance(g, list) else g[part]
        if p.grad is None:  # the score bias, which softmax ignores
            np.testing.assert_array_equal(np.asarray(g), 0.0)
        else:
            assert _rel(p.grad.numpy(), g) < FUSED_REL_TOL, name


def _jax_loss_and_grads(jp, x, y, cw, bf16, cfg):
    def loss_fn(p):
        logits = jax_apply(p, jnp.asarray(x), cfg, train=True, dropout_key=None,
                           compute_dtype=jnp.bfloat16 if bf16 else None, lstm_impl="scan")
        return jlosses.cross_entropy_loss(logits, jnp.asarray(y), jnp.asarray(cw))
    return jax.value_and_grad(loss_fn)(jp)


@pytest.mark.parametrize("bf16", [False, True])
def test_train_steps_match_jax_make_train_step(bf16):
    """Dropout 0, identical params and batches: the gradient of the first
    step, the loss of each of 3 steps, and the params after 1 and 3 updates."""
    kw = dict(SMALL, dropout=0.0)
    jc, tc = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    train_kw = dict(accumulation_steps=1, learning_rate=1e-3, warmup_epochs=1, epochs=4,
                    bf16=bf16)
    jtrain = jcfg.TrainConfig(**train_kw, lstm_impl="scan")
    ttrain = tcfg.TrainConfig(**train_kw, lstm_impl="plain")
    jp = jax_init(jax.random.key(6), jc)
    rng = np.random.default_rng(6)
    batches = [(rng.standard_normal((8, 16, 5)).astype(np.float32), rng.integers(0, 2, 8))
               for _ in range(3)]
    cw = np.array([0.8, 1.2], np.float32)
    tol = BF16_REL_TOL if bf16 else 1e-4

    want_loss, want_grads = _jax_loss_and_grads(jp, *batches[0], cw, bf16, jc)
    tx = jax_make_optimizer(jtrain, updates_per_epoch=1)
    jstep = jax_make_train_step(jc, jtrain, tx, class_weights=cw, donate=False)
    state = TrainState(jp, tx.init(jp), jnp.asarray(0))

    params = params_from_jax(jp, trainable=True)
    opt = make_optimizer(list(params.parameters()), ttrain, updates_per_epoch=1)
    tstep = make_train_step(tc, ttrain, opt, class_weights=torch.from_numpy(cw))
    for i, (x, y) in enumerate(batches):
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(y), jax.random.key(i))
        tm = tstep(params, torch.from_numpy(x), torch.from_numpy(y), None)
        assert abs(tm["loss"].item() - float(jm["loss"])) <= tol * abs(float(jm["loss"]))
        assert int(tm["correct"]) == int(jm["correct"]) or bf16
        if i == 0:
            for name, p in params.named_parameters():
                g = want_grads
                for part in name.split("."):
                    g = g[int(part)] if isinstance(g, list) else g[part]
                if name == "attention.score.b":
                    # softmax ignores it: zero up to rounding on both sides
                    got = 0.0 if p.grad is None else np.abs(p.grad.numpy()).max()
                    assert got < 1e-6 and np.abs(np.asarray(g)).max() < 1e-6
                else:
                    assert _rel(p.grad.numpy(), g) < tol, name
        if i in (0, 2):
            # Adam's update is about lr * sign(g) wherever |g| >> eps, so a
            # gradient that differs in its last bits can move an entry by up
            # to ~lr per update; float32 agrees far closer
            loose = (i + 1) * 2 * ttrain.learning_rate
            for name, p in params.named_parameters():
                want = state.params
                for part in name.split("."):
                    want = want[int(part)] if isinstance(want, list) else want[part]
                # the score bias's gradient is rounding noise (~1e-10) on
                # both sides, which Adam scales up against eps = 1e-8
                atol = loose if bf16 or name == "attention.score.b" else 1e-6
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), atol=atol,
                                           rtol=0, err_msg=name)


def test_accumulation_leaves_params_until_the_kth_micro_step():
    cfg = tcfg.ModelConfig(**SMALL)
    train = tcfg.TrainConfig(accumulation_steps=4, lstm_impl="plain")
    params = params_from_jax(jax_init(jax.random.key(7), jcfg.ModelConfig(**SMALL)),
                             trainable=True)
    start = params_to_jax(params)
    opt = make_optimizer(list(params.parameters()), train, updates_per_epoch=1)
    step = make_train_step(cfg, train, opt)
    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(1)
    for i in range(4):
        x = torch.from_numpy(rng.standard_normal((4, 8, 5)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 2, 4))
        step(params, x, y, draw_dropout_masks(cfg, 4, 8, gen))
        same = all(np.array_equal(a, b) for a, b in zip(_leaves(params_to_jax(params)),
                                                        _leaves(start)))
        assert same == (i < 3)


def test_dropout_masks_shapes_and_rates():
    cfg = tcfg.ModelConfig(input_size=5, hidden_size=32, num_layers=3, dropout=0.4)
    m = draw_dropout_masks(cfg, 64, 32, torch.Generator().manual_seed(0))
    assert m.input.shape == (64, 32, 32) and m.input.dtype == torch.bool
    assert len(m.layers) == 2 and all(len(parts) == 2 for parts in m.layers)
    assert m.head1.shape == (64, 32) and m.head2.shape == (64, 16)
    assert abs(m.input.float().mean().item() - 0.8) < 0.01
    assert abs(torch.cat([p.flatten() for ps in m.layers for p in ps]).float().mean().item()
               - 0.6) < 0.01
    again = draw_dropout_masks(cfg, 64, 32, torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[1][0], m.layers[1][0])
    none = draw_dropout_masks(dataclasses.replace(cfg, dropout=0.0), 4, 4,
                              torch.Generator().manual_seed(0))
    assert none.input is None and none.layers == ()


def _toy_set(rng, n, steps=16, channels=5):
    y = rng.permutation(np.arange(n) % 2)
    x = rng.standard_normal((n, steps, channels)).astype(np.float32)
    x[:, :, 0] += (1.5 * (2 * y - 1))[:, None]
    return x, y


def test_train_classifier_learns_and_is_bitwise_deterministic():
    rng = np.random.default_rng(8)
    x_tr, y_tr = _toy_set(rng, 96)
    x_va, y_va = _toy_set(rng, 32)
    model_cfg = tcfg.ModelConfig(input_size=5, hidden_size=16, num_layers=2)
    # 6 epochs: whether 4 reach the thresholds depends on the dropout-mask
    # stream (one of 8 toy sets under the stream of one generator for the
    # run, four under per-epoch generators); 6 reach them on all 8
    train_cfg = tcfg.TrainConfig(epochs=6, batch_size=16, accumulation_steps=2,
                                 eval_batch_size=32, learning_rate=3e-3, warmup_epochs=1,
                                 patience=10)
    # a 16-unit model: per-operation work too small to share out, so one thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = [train_classifier(x_tr, y_tr, x_va, y_va, model_cfg, train_cfg, device="cpu",
                                 verbose=False) for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    a, b = runs
    for k in ("train_loss", "val_loss", "val_acc", "val_f1", "learning_rates"):
        assert a.history[k] == b.history[k], k
    for la, lb in zip(_leaves(a.params), _leaves(b.params)):
        assert np.array_equal(la, lb)
    assert a.epochs_run == 6 and len(a.history["train_loss"]) == 6
    assert a.history["val_acc"][-1] >= 0.9 and a.best_val_f1 > 0.8
    assert a.history["train_loss"][-1] < a.history["train_loss"][0]
    assert a.windows_per_sec > 0


def _write_processed(tmp_path, seed=9):
    rng = np.random.default_rng(seed)
    arrays = {}
    for split, n in (("train", 48), ("val", 16), ("test", 12)):
        arrays[f"X_{split}"], arrays[f"y_{split}"] = _toy_set(rng, n)
    (tmp_path / "processed_data").mkdir()
    np.savez_compressed(tmp_path / "processed_data" / "processed_sequences.npz", **arrays)
    cfg = {"model": {"hidden_size": 16, "num_layers": 2},
           "train": {"batch_size": 16, "accumulation_steps": 2, "eval_batch_size": 32,
                     "warmup_epochs": 1, "learning_rate": 3e-3}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    return arrays


def test_train_cli_writes_the_artifacts_and_jax_reads_them(tmp_path, monkeypatch):
    from eegflow.core.artifacts import load_checkpoint as jax_load_checkpoint
    from figure_records import patch_figures

    patch_figures(monkeypatch)  # the figures recorded, not rasterised
    arrays = _write_processed(tmp_path)
    # a toy model: per-operation work too small to share out, so one thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = cli_main(["--output-dir", str(tmp_path), "--config", str(tmp_path / "cfg.json"),
                       "train", "--epochs", "2", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    results = json.loads((tmp_path / "results" / "lstm_results.json").read_text())
    assert results["model_name"] == "lstm_attention" and len(results["y_pred"]) == 12
    attn = np.load(tmp_path / "models" / "attention_weights.npy")
    assert attn.shape == (12, 16) and np.allclose(attn.sum(-1), 1.0, atol=1e-5)
    params, cfg, history, extra = jax_load_checkpoint(tmp_path / "models" / "lstm_attention")
    assert cfg.hidden_size == 16 and cfg.input_size == 5 and len(history["train_loss"]) == 2
    assert "windows_per_sec" in extra
    # the JAX forward on the port's checkpoint gives the port's probabilities
    x = arrays["X_test"]
    want = jax.nn.softmax(jax_apply(params, jnp.asarray(x), cfg, lstm_impl="scan"), -1)
    got = torch.softmax(classifier_apply(params_from_jax(params), torch.from_numpy(x),
                                         tcfg.ModelConfig(**dataclasses.asdict(cfg))), -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)


def test_train_cli_cuda_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write_processed(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--output-dir", str(tmp_path), "train", "--epochs", "1", "--device", "cuda"])


def test_data_plumbing_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((12, 16, 3)).astype(np.float32)
    y = np.array([0] * 9 + [1] * 3)
    np.testing.assert_array_equal(tdata.class_weight_array(y), jdata.class_weight_array(y))
    np.testing.assert_array_equal(
        tdata.weighted_epoch_indices(y, np.random.default_rng(1)),
        jdata.weighted_epoch_indices(y, np.random.default_rng(1)))
    kw = dict(noise_std=0.05, max_shift=3, mixup=True, channel_dropout=0.2, phase_surrogates=1)
    gx, gy = tdata.augment_data(x, y, np.random.default_rng(2), **kw)
    wx, wy = jdata.augment_data(x, y, np.random.default_rng(2), **kw)
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    got = list(tdata.padded_eval_batches(x, y, 5))
    want = list(jdata.padded_eval_batches(x, y, 5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert [len(b[0]) for b in tdata.batch_iterator(x, y, 5, drop_last=False)] == [5, 5, 2]


def test_surrogate_refresh_keeps_the_amplitude_spectrum():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((4, 32, 3)).astype(np.float32))
    full = torch.cat([x, x, x], dim=0)          # 4 originals + 2 surrogate copies
    refresh = tdata.make_surrogate_refresher(4, 2, seed=3)
    a, b = refresh(full, 0), refresh(full, 1)
    assert torch.equal(a[:4], x) and a.shape == full.shape
    spec = torch.fft.rfft(x, dim=1).abs()
    for copy in (a[4:8], a[8:12], b[4:8]):
        np.testing.assert_allclose(torch.fft.rfft(copy, dim=1).abs().numpy(), spec.numpy(),
                                   atol=1e-4)
    assert not torch.equal(a[4:8], b[4:8])      # fresh phases each epoch
    assert torch.equal(refresh(full, 0), a)     # and repeatable


def test_evaluate_model_matches_jax():
    rng = np.random.default_rng(12)
    y = rng.integers(0, 2, 50)
    prob = np.clip(y * 0.6 + rng.random(50) * 0.5, 0, 1)
    pred = (prob > 0.5).astype(int)
    got = teval.evaluate_model(y, pred, prob, "m", n_bootstrap=200)
    want = jeval.evaluate_model(y, pred, prob, "m", n_bootstrap=200)
    assert got == want
