"""The port's EEGFormer (``eegflow_torch.nn.transformer``) against
``eegflow.nn.transformer`` on the CPU at a toy size: positions, multi-head
attention, eval and training forwards and their gradients, one train step
against ``make_train_step`` with optax, the FLOP count, checkpoints both
ways, the family learnt and explained through the port's entry points, and
``train --model transformer`` through the CLI with ``integrate``,
``forecast``, ``export`` and ``/predict`` on its checkpoint. On the CPU the
input block and the pool head run their kernels' plain twins."""

import json
import threading
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eegflow.core import config as jcfg
from eegflow.core.artifacts import load_checkpoint as jax_load_checkpoint
from eegflow.core.artifacts import save_checkpoint as jax_save_checkpoint
from eegflow.nn import attention as jatt
from eegflow.nn import transformer as jtf
from eegflow.nn.layers import dropout_mask as jax_dropout_mask
from eegflow.nn.losses import cross_entropy_loss as jax_ce
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow.nn.model import classifier_init as jax_init
from eegflow.nn.model import model_flops_per_window as jax_flops
from eegflow.train.steps import TrainState
from eegflow.train.steps import make_optimizer as jax_make_optimizer
from eegflow.train.steps import make_train_step as jax_make_train_step
from eegflow_torch.cli.main import build_parser, main as cli_main, start_server
from figure_records import patch_figures
from eegflow_torch.convert import params_from_jax, params_to_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.core.artifacts import (load_checkpoint, load_results, save_checkpoint,
                                          save_processed, save_results)
from eegflow_torch.core.prng import make_generator
from eegflow_torch.couple.rollout import predict_batch
from eegflow_torch.explain.gradient import gradient_channel_importance
from eegflow_torch.explain.kernelshap import kernel_shap_channel_importance
from eegflow_torch.explain.permutation import permutation_channel_importance
from eegflow_torch.nn import attention as tatt
from eegflow_torch.nn import transformer as ttf
from eegflow_torch.nn.losses import cross_entropy_loss
from eegflow_torch.nn.model import classifier_apply, classifier_init, model_flops_per_window
from eegflow_torch.train.loop import predict_probs, train_classifier
from eegflow_torch.train.steps import make_optimizer, make_train_step
from torch_threads import one_torch_thread  # noqa: F401

TOY = dict(input_size=4, d_model=16, num_layers=2, num_heads=2, mlp_ratio=2, dropout=0.1)
B, T = 6, 32
# the same float32 operations in another order (two-pass against
# E[x^2] - mean^2 LayerNorm statistics in the pool head, the GEMMs' sums)
LOGITS_TOL = 1e-5
GRAD_REL_TOL = 1e-4
# bf16: the reference's pool scores are dense(score, tanh(.)) on bf16
# operands, the pool head's a float32 sum of tanh(.) * w2 (measured 1.9e-4
# in probabilities on this model); its weight gradients are bf16 products
# rounded to bf16 (ROADMAP.md section 3, "bf16 gradients": about 0.4 %,
# measured 5.0e-3)
BF16_PROBS_TOL = 5e-4
BF16_GRAD_REL_TOL = 2e-2
# the positions: XLA's pow and sin against torch's differ by up to one
# float32 rounding of values in [-1, 1] (measured 6.0e-8)
POS_TOL = 2 ** -23
# one AdamW update (as tests/test_torch_ablation.py): parameters 1e-5 plus
# Adam's slope lr eps / (|g| + eps)^2 times the gradients' difference
LR, PARAM_TOL, ADAM_EPS = 1e-3, 1e-5, 1e-8
# gradients zero by symmetry (softmax ignores the key bias and the score
# bias): rounding noise on both sides
ZERO_GRAD_LEAVES = ("mha.key.b", "attention.score.b")
ZERO_GRAD_TOL = 1e-7
POLICIES = [pytest.param(None, None, id="float32"),
            pytest.param(jnp.bfloat16, torch.bfloat16, id="bf16")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Toy widths: per-operation work too small to share out, so one thread,
    not one per core of the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    kw = dict(TOY, **kw)
    return jcfg.TransformerConfig(**kw), tcfg.TransformerConfig(**kw)


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return np.asarray(tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _zero_by_symmetry(name):
    return name.endswith(ZERO_GRAD_LEAVES)


@pytest.fixture(scope="module")
def model():
    jc, tc = _configs()
    jp = jax_init(jax.random.key(3), jc)
    x = np.random.default_rng(0).standard_normal((B, T, 4)).astype(np.float32)
    return jc, tc, jp, x


def _jax_masks(key, tc, batch, steps):
    """The JAX transformer's masks, from fold_in(key, i) at its indices."""
    d, dim, layers = tc.dropout, tc.resolved_d_model(), tc.num_layers

    def draw(i, rate, shape):
        return torch.from_numpy(np.array(jax_dropout_mask(jax.random.fold_in(key, i), rate,
                                                            shape)))

    return ttf.TransformerDropoutMasks(
        input=draw(0, d / 2, (batch, steps, dim)),
        blocks=tuple((draw(1 + 2 * li, d, (batch, steps, dim)),
                      draw(2 + 2 * li, d, (batch, steps, dim))) for li in range(layers)),
        head1=draw(1 + 2 * layers, d, (batch, dim // 2)))


@pytest.mark.parametrize("steps,dim", [(32, 16), (256, 256), (32, 7), (5, 33), (17, 1)])
def test_sinusoidal_positions_match_the_reference(steps, dim):
    want = np.asarray(jtf.sinusoidal_positions(steps, dim))
    got = ttf.sinusoidal_positions(steps, dim).numpy()
    assert got.shape == want.shape == (steps, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=POS_TOL, rtol=0)
    if dim % 2:
        assert (got[:, -1] == 0).all()


@pytest.mark.parametrize("jdt,tdt", POLICIES)
def test_multihead_attention_matches_the_reference(model, jdt, tdt):
    _, _, jp, _ = model
    h = np.random.default_rng(1).standard_normal((B, T, 16)).astype(np.float32)
    want_out, want_w = jatt.multihead_attention_apply(jp["blocks"][0]["mha"], jnp.asarray(h),
                                                      2, jdt)
    mha = params_from_jax(jp)["blocks"][0]["mha"]
    with torch.no_grad():
        out, w = tatt.multihead_attention_apply(mha, torch.from_numpy(h), 2, tdt)
    assert out.shape == (B, T, 16) and w.shape == (B, T)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("jdt,tdt", POLICIES)
def test_eval_logits_and_attention_match_the_reference(model, jdt, tdt):
    jc, tc, jp, x = model
    want, want_attn = jtf.transformer_apply(jp, jnp.asarray(x), jc, return_attention=True,
                                            compute_dtype=jdt)
    with torch.no_grad():
        got, attn = classifier_apply(params_from_jax(jp), torch.from_numpy(x), tc,
                                     return_attention=True, compute_dtype=tdt)
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, atol=1e-6)
    if tdt is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_TOL, rtol=0)
        np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=LOGITS_TOL, rtol=0)
    else:
        probs = torch.softmax(got, -1).numpy()
        np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(want)), atol=BF16_PROBS_TOL,
                                   rtol=0)
        np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=BF16_PROBS_TOL,
                                   rtol=0)


@pytest.mark.parametrize("jdt,tdt", POLICIES)
def test_training_forward_and_gradients_match_jax_grad(model, jdt, tdt):
    """The training-mode forward on the reference's own dropout masks, and
    the gradients of the weighted loss in every parameter and the input."""
    jc, tc, jp, x = model
    key = jax.random.key(7)
    y = np.random.default_rng(2).integers(0, 2, B)
    cw = np.array([0.8, 1.2], np.float32)

    def loss_fn(p, xx):
        logits = jax_apply(p, xx, jc, train=True, dropout_key=key, compute_dtype=jdt)
        return jax_ce(logits, jnp.asarray(y), jnp.asarray(cw))

    want_loss, (want_g, want_gx) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    params = params_from_jax(jp, trainable=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = classifier_apply(params, xt, tc, compute_dtype=tdt, train=True,
                              masks=_jax_masks(key, tc, B, T))
    loss = cross_entropy_loss(logits, torch.from_numpy(y), torch.from_numpy(cw))
    loss.backward()
    tol = GRAD_REL_TOL if tdt is None else BF16_GRAD_REL_TOL
    assert abs(loss.item() - float(want_loss)) <= tol * abs(float(want_loss))
    for name, p in params.named_parameters():
        want = _leaf(want_g, name)
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        if _zero_by_symmetry(name):
            assert np.abs(got).max() < ZERO_GRAD_TOL and np.abs(want).max() < ZERO_GRAD_TOL
        else:
            assert _rel(got, want) < tol, name
    assert _rel(xt.grad.numpy(), want_gx) < tol


def test_train_step_matches_jax_make_train_step(model):
    """One update of the reference's optimizer (clip, AdamW on the
    warmup-cosine schedule) from the same parameters, batch and masks,
    float32."""
    jc, tc, jp, x = model
    train_kw = dict(accumulation_steps=1, learning_rate=LR, warmup_epochs=1, epochs=4,
                    bf16=False)
    jtrain, ttrain = jcfg.TrainConfig(**train_kw), tcfg.TrainConfig(**train_kw)
    y = np.random.default_rng(3).integers(0, 2, B)
    cw = np.array([0.8, 1.2], np.float32)
    key = jax.random.key(5)

    tx = jax_make_optimizer(jtrain, updates_per_epoch=1)
    jstep = jax_make_train_step(jc, jtrain, tx, class_weights=cw, donate=False)

    def loss_fn(p):
        logits = jax_apply(p, jnp.asarray(x), jc, train=True, dropout_key=key)
        return jax_ce(logits, jnp.asarray(y), jnp.asarray(cw))

    want_grads = jax.jit(jax.grad(loss_fn))(jp)
    state, jm = jstep(TrainState(jp, tx.init(jp), jnp.asarray(0)), jnp.asarray(x),
                      jnp.asarray(y), key)

    params = params_from_jax(jp, trainable=True)
    opt = make_optimizer(list(params.parameters()), ttrain, updates_per_epoch=1)
    tstep = make_train_step(tc, ttrain, opt, class_weights=torch.from_numpy(cw))
    tm = tstep(params, torch.from_numpy(x), torch.from_numpy(y), _jax_masks(key, tc, B, T))
    assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-5
    for name, p in params.named_parameters():
        want_g = _leaf(want_grads, name)
        g = np.zeros_like(want_g) if p.grad is None else p.grad.numpy()
        small = np.minimum(np.abs(g), np.abs(want_g)) + ADAM_EPS
        atol = PARAM_TOL + np.minimum(2 * LR, LR * ADAM_EPS * np.abs(g - want_g) / small ** 2)
        diff = np.abs(p.detach().numpy() - _leaf(state.params, name))
        assert (diff <= atol).all(), (name, diff.max())


@pytest.mark.parametrize("cfg", [jcfg.TransformerConfig(), jcfg.TransformerConfig(**TOY),
                                 jcfg.TransformerConfig(input_size=20, mlp_ratio=2),
                                 jcfg.ModelConfig(), jcfg.ModelConfig(bidirectional=False,
                                                                      num_layers=1)])
def test_model_flops_per_window_matches_the_reference(cfg):
    port_cfg = getattr(tcfg, type(cfg).__name__)(**{f: getattr(cfg, f)
                                                    for f in cfg.__dataclass_fields__})
    for seq_len in (256, 32):
        assert model_flops_per_window(port_cfg, seq_len) == jax_flops(cfg, seq_len)


def test_jax_checkpoint_serves_the_same_logits(tmp_path, model):
    jc, tc, jp, x = model
    jax_save_checkpoint(tmp_path / "ckpt", jp, jc, history={"val_f1": [0.5]})
    params, cfg, hist, _ = load_checkpoint(tmp_path / "ckpt")
    assert cfg == tc and hist == {"val_f1": [0.5]}
    assert len(params["blocks"]) == TOY["num_layers"]
    want = jtf.transformer_apply(jp, jnp.asarray(x), jc)
    with torch.no_grad():
        got = classifier_apply(params_from_jax(params), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_TOL, rtol=0)


def test_port_checkpoint_loads_in_the_reference(tmp_path, model):
    jc, tc, _, x = model
    params = classifier_init(tc, make_generator(4))
    save_checkpoint(tmp_path / "ckpt", params, tc, extra={"best_val_f1": 0.5})
    tree = params_to_jax(params)
    jax_save_checkpoint(tmp_path / "jax_ckpt", tree, jc)
    assert ((tmp_path / "ckpt" / "params.msgpack").read_bytes()
            == (tmp_path / "jax_ckpt" / "params.msgpack").read_bytes())
    jparams, jconfig, _, extra = jax_load_checkpoint(tmp_path / "ckpt")
    assert isinstance(jconfig, jcfg.TransformerConfig) and jconfig == jc
    assert extra == {"best_val_f1": 0.5}
    want = jtf.transformer_apply(jparams, jnp.asarray(x), jconfig)
    with torch.no_grad():
        got = classifier_apply(params, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_TOL, rtol=0)


def _toy_data(rng, n, t=32, c=4):
    y = (rng.random(n) > 0.5).astype(np.int64)
    x = rng.standard_normal((n, t, c)).astype(np.float32)
    return x, y, np.sin(2 * np.pi * np.arange(t) / 8.0).astype(np.float32)


TOY_TRAIN = tcfg.TrainConfig(epochs=12, batch_size=32, eval_batch_size=64,
                             accumulation_steps=1, learning_rate=1e-3, warmup_epochs=2,
                             patience=10, bf16=False, augment=False)


def test_train_classifier_learns_separable():
    """``tests/test_transformer.py::test_train_classifier_learns_separable``
    through the port's trainer."""
    x, y, wave = _toy_data(np.random.default_rng(0), 512)
    x[y == 1] += 2.0 * wave[None, :, None]
    tc = tcfg.TransformerConfig(**TOY)
    res = train_classifier(x[:384], y[:384], x[384:], y[384:], tc, TOY_TRAIN, device="cpu",
                           verbose=False)
    assert res.best_val_f1 > 0.9
    probs = predict_probs(params_from_jax(res.params), x[384:], tc, batch_size=64, bf16=False)
    assert (probs.argmax(1) == y[384:]).mean() > 0.9


def test_explain_stack_finds_signal_channel():
    """``tests/test_transformer.py::test_explain_stack_finds_signal_channel``
    through the port's explainers: only channel 2 carries the signal; and
    KernelSHAP runs on the family too."""
    x, y, wave = _toy_data(np.random.default_rng(1), 384)
    x[y == 1, :, 2] += 2.5 * wave
    tc = tcfg.TransformerConfig(**TOY)
    res = train_classifier(x[:256], y[:256], x[256:], y[256:], tc, TOY_TRAIN, device="cpu",
                           verbose=False)
    assert res.best_val_f1 > 0.8
    params = params_from_jax(res.params)
    perm = permutation_channel_importance(params, tc, x[256:], y[256:], n_permutations=3,
                                          n_samples=128)
    assert int(np.argmax(perm["importance"])) == 2
    grad = gradient_channel_importance(params, tc, x[256:], n_samples=64)
    imp = np.asarray(grad["importance"])
    assert imp.shape == (4,) and np.all(np.isfinite(imp))
    np.testing.assert_allclose(imp.sum(), 1.0, atol=1e-6)
    shap = kernel_shap_channel_importance(params, tc, x[256:], n_background=16, n_explain=8,
                                          nsamples=16)
    assert shap["shap_values"].shape == (8, 4) and np.all(np.isfinite(shap["shap_values"]))


def _request(addr, method, path, payload=None):
    conn = HTTPConnection(*addr, timeout=30)
    body = json.dumps(payload) if payload is not None else None
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def test_cli_trains_integrates_and_serves_a_transformer(tmp_path, monkeypatch):
    """``train --model transformer --device cpu`` writes a TransformerConfig
    checkpoint the reference reads; ``integrate``, ``forecast``, ``export``
    and ``/predict`` run on it; the stages' figures are recorded, not
    rasterised."""
    patch_figures(monkeypatch)
    rng = np.random.default_rng(4)
    arrays = {}
    for split, n in (("train", 96), ("val", 24), ("test", 40)):
        x, y, wave = _toy_data(rng, n, t=16)
        x[y == 1] += wave[None, :, None]
        arrays[f"X_{split}"], arrays[f"y_{split}"] = x, y
    save_processed(tmp_path / "processed_data", arrays, {})
    save_results(tmp_path / "results" / "ode_results.json", {"fitted_params": {
        "k_ap": 0.2, "k_af": 0.03, "k_pa": 0.1, "k_pf": 0.05, "k_fa": 0.07, "k_fp": 0.2}})
    (tmp_path / "cfg.json").write_text(json.dumps({
        "model": {"hidden_size": 32, "num_layers": 1, "num_heads": 2},
        "train": {"batch_size": 16, "eval_batch_size": 32, "accumulation_steps": 1},
        "preprocess": {"sequence_length": 16}}))
    base = ["--output-dir", str(tmp_path), "--config", str(tmp_path / "cfg.json")]
    assert cli_main(base + ["train", "--model", "transformer", "--epochs", "1",
                            "--device", "cpu"]) == 0
    _, jconfig, _, _ = jax_load_checkpoint(tmp_path / "models" / "lstm_attention")
    assert jconfig == jcfg.TransformerConfig(input_size=4, d_model=32, num_layers=1,
                                             num_heads=2, dropout=0.4)
    assert np.load(tmp_path / "models" / "attention_weights.npy").shape == (40, 16)
    for stage in ("integrate", "forecast", "export"):
        assert cli_main(base + [stage, "--device", "cpu"]) == 0, stage
    assert load_results(tmp_path / "results" / "integration_results.json")["evaluation"]
    assert load_results(tmp_path / "results" / "forecasting_results.json")["metrics"]
    summary = load_results(tmp_path / "results" / "three_state_summary.json")
    assert summary["test"]["n_samples"] == 40

    args = build_parser().parse_args(base + ["serve", "--port", "0", "--device", "cpu"])
    httpd, served = start_server(args)
    assert isinstance(served.model_cfg, tcfg.TransformerConfig)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        httpd.warmup_thread.join(timeout=60)
        assert not httpd.warmup_thread.is_alive()
        windows = arrays["X_test"][:3]
        status, out = _request(httpd.server_address, "POST", "/predict",
                               {"windows": windows.tolist()})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert status == 200
    want = predict_batch(served, windows)
    np.testing.assert_allclose(out["probs"], want["probs"], atol=1e-6)
    np.testing.assert_allclose(out["final_state"], want["final_state"], atol=1e-6)
