"""The port's data mesh (``eegflow_torch.train.mesh`` and the ``mesh=``
paths) on two gloo ranks on the CPU, against the JAX package's mesh on two
of the conftest's virtual devices and against the port without a mesh.

Each fixture spawns the two ranks once (``tests/mesh_workers.py``, whose
children import no JAX); the tests read their results. Tiny shapes; inputs
made with numpy from a seed.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_workers as mw
from eegflow.core import config as jcfg
from eegflow.couple.rollout import CoupledModel as JaxCoupledModel
from eegflow.couple.rollout import predict_batch as jax_predict_batch
from eegflow.nn import losses as jlosses
from eegflow.nn.model import classifier_apply as jax_apply
from eegflow.nn.model import classifier_init as jax_init
from eegflow.ode.field import rates_to_array as jax_rates
from eegflow.train import mesh as jmesh
from eegflow.train.loop import predict_probs as jax_predict_probs
from eegflow.train.steps import TrainState, make_optimizer as jax_make_optimizer
from eegflow.train.steps import make_train_step as jax_make_train_step
from eegflow_torch.analyze.forecast import multistep_forecast, rolling_forecast_evaluation
from eegflow_torch.cli import main as cli_main
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.core.artifacts import load_checkpoint, save_results
from eegflow_torch.couple.rollout import CoupledModel, predict_batch
from eegflow_torch.couple.sweep import coupling_strength_sweep
from eegflow_torch.explain.permutation import permutation_channel_importance
from eegflow_torch.ode.field import DEFAULT_RATES, rates_to_array
from eegflow_torch.train.loop import predict_probs, train_classifier
from eegflow_torch.train.steps import make_optimizer, make_train_step

SMALL = dict(input_size=5, hidden_size=16, num_layers=2, dropout=0.0)
TRAIN = dict(accumulation_steps=1, learning_rate=1e-3, warmup_epochs=1, epochs=4, bf16=False)
CW = np.array([0.8, 1.2], np.float32)
# the port's float32 step against the JAX package's scan (as
# tests/test_torch_train.py: float32 sums in another order through 2 layers)
JAX_REL_TOL = 1e-4
# the port with the mesh against the port without it: the same float32
# operations, the batch's sums split over two ranks (measured 2.0e-6)
MESH_REL_TOL = 1e-5
# eval probabilities: the float32 policy's sums in another order; the bf16
# rollout: the port's fused schedule against the JAX scan path (~2e-4,
# ROADMAP §3)
PROBS_F32_TOL = 1e-5
ROLLOUT_BF16_TOL = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _leaf(tree, name):
    """The leaf at the dotted path ``name`` of a params tree, or the entry
    ``name`` of a flat {name: gradient} dict."""
    if name in tree:
        return np.asarray(tree[name])
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return np.asarray(tree)


def _names(jp):
    return [n for n, _ in params_from_jax(jp).named_parameters()]


@pytest.fixture(scope="module")
def step_case():
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.key(21),
                                                     jcfg.ModelConfig(**SMALL)))
    rng = np.random.default_rng(21)
    x = rng.standard_normal((8, 12, 5)).astype(np.float32)
    # unequal class balance in the two shards: rank 0 holds 0 0 0 1, rank 1 1 1 1 0
    y = np.array([0, 0, 0, 1, 1, 1, 1, 0])
    case = dict(device="cpu", world=2, model=SMALL, params=jp, x=x, y=y, cw=CW,
                train=dict(TRAIN, lstm_impl="plain"))
    return case, mw.spawn(mw.steps, case)


def test_shard_batch_gives_the_jax_shards_and_refuses_a_ragged_axis(step_case):
    case, ranks = step_case
    mesh = jmesh.make_data_mesh(2)
    xs, ys = jmesh.shard_batch((jnp.asarray(case["x"]), jnp.asarray(case["y"])), mesh)
    for arr, which in ((xs, 0), (ys, 1)):
        by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for rank, device in enumerate(mesh.devices):
            np.testing.assert_array_equal(ranks[rank]["shard"][which], by_device[device])
    with pytest.raises(ValueError):
        jmesh.shard_batch(jnp.asarray(case["x"][:-1]), mesh)
    assert all(r["odd_raises"] for r in ranks)


def test_replicate_to_mesh_gives_every_rank_rank_0s_bits(step_case):
    _, ranks = step_case
    for r in ranks:
        assert r["shape"] == dict(jmesh.make_data_mesh(2).shape) == {"data": 2}
        np.testing.assert_array_equal(r["replicated"]["t"], np.ones(3, np.float32))
        np.testing.assert_array_equal(r["replicated"]["n"], np.arange(4))


def _jax_state_and_tx(jp):
    jtrain = jcfg.TrainConfig(**TRAIN, lstm_impl="scan")
    tx = jax_make_optimizer(jtrain, updates_per_epoch=1)
    return jtrain, tx, TrainState(jp, tx.init(jp), jnp.asarray(0))


def _jax_grads(jp, x, y):
    def loss_fn(p):
        logits = jax_apply(p, jnp.asarray(x), jcfg.ModelConfig(**SMALL), lstm_impl="scan")
        return jlosses.cross_entropy_loss(logits, jnp.asarray(y), jnp.asarray(CW))
    return jax.value_and_grad(loss_fn)(jp)


def _hold_step(got, want_loss, want_grads, want_params, tol, names):
    assert abs(got["loss"] - float(want_loss)) <= tol * abs(float(want_loss))
    for name in names:
        g = got["grads"][name]
        if name == "attention.score.b":
            # softmax ignores it: zero up to rounding on both sides
            assert (g is None or np.abs(g).max() < 1e-6)
            continue
        assert _rel(g, _leaf(want_grads, name)) < tol, name
        # Adam's first update is about lr * sign(g): a gradient that differs
        # in its last bits can move an entry by up to ~lr
        np.testing.assert_allclose(_leaf(got["params"], name), _leaf(want_params, name),
                                   atol=2 * TRAIN["learning_rate"] if tol > MESH_REL_TOL
                                   else 1e-6, rtol=0, err_msg=name)


def test_implicit_step_is_the_single_device_function(step_case):
    """make_train_step(mesh=) under class weights and shards of unequal
    balance against the JAX implicit sharded step and the port's step
    without a mesh; the ranks' params bitwise equal after the update."""
    case, ranks = step_case
    jp, x, y = case["params"], case["x"], case["y"]
    names = _names(jp)
    jtrain, tx, state = _jax_state_and_tx(jp)
    mesh = jmesh.make_data_mesh(2)
    jstep = jax_make_train_step(jcfg.ModelConfig(**SMALL), jtrain, tx,
                                class_weights=jnp.asarray(CW), donate=False, mesh=mesh)
    xs, ys = jmesh.shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    jstate, jm = jstep(jmesh.replicate_to_mesh(state, mesh), xs, ys, jax.random.key(0))
    want_loss, want_grads = _jax_grads(jp, x, y)
    assert float(jm["loss"]) == pytest.approx(float(want_loss), rel=1e-6)
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params)

    ttrain = tcfg.TrainConfig(**TRAIN, lstm_impl="plain")
    params = params_from_jax(jp, trainable=True)
    opt = make_optimizer(list(params.parameters()), ttrain, updates_per_epoch=1)
    m = make_train_step(tcfg.ModelConfig(**SMALL), ttrain, opt,
                        class_weights=torch.from_numpy(CW))(
        params, torch.from_numpy(x), torch.from_numpy(y), None)
    single = {"loss": m["loss"].item(), "params": mw.params_to_jax(params),
              "grads": mw._grads(params)}

    for r in ranks:
        got = r["implicit"]
        assert got["count"] == 8 and got["correct"] == int(jm["correct"])
        _hold_step(got, jm["loss"], want_grads, jparams, JAX_REL_TOL, names)
        _hold_step(got, single["loss"], single["grads"], single["params"], MESH_REL_TOL, names)
    for name in names:
        np.testing.assert_array_equal(_leaf(ranks[0]["implicit"]["params"], name),
                                      _leaf(ranks[1]["implicit"]["params"], name))


def test_explicit_step_is_the_jax_explicit_step_and_not_the_implicit_one(step_case):
    """make_spmd_train_step against eegflow.train.mesh.make_spmd_train_step:
    the mean of the shards' weighted means, the shards' gradients averaged.
    With class weights and shards of unequal balance that is another loss
    than the implicit step's."""
    case, ranks = step_case
    jp, x, y = case["params"], case["x"], case["y"]
    names = _names(jp)
    jtrain, tx, state = _jax_state_and_tx(jp)
    jstep = jmesh.make_spmd_train_step(jcfg.ModelConfig(**SMALL), jtrain, tx,
                                       jmesh.make_data_mesh(2), class_weights=CW)
    jstate, jm = jstep(state, jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params)
    shard_grads = [_jax_grads(jp, x[i: i + 4], y[i: i + 4]) for i in (0, 4)]
    want_loss = 0.5 * (shard_grads[0][0] + shard_grads[1][0])
    want_grads = jax.tree_util.tree_map(lambda a, b: 0.5 * (a + b), shard_grads[0][1],
                                        shard_grads[1][1])
    assert float(jm["loss"]) == pytest.approx(float(want_loss), rel=1e-6)
    for r in ranks:
        got = r["explicit"]
        assert got["count"] == 8 and got["correct"] == int(jm["correct"])
        _hold_step(got, jm["loss"], want_grads, jparams, JAX_REL_TOL, names)
        # the reference's explicit step is not its implicit one here
        assert abs(got["loss"] - r["implicit"]["loss"]) > 1e-3 * abs(r["implicit"]["loss"])
        assert max(_rel(got["grads"][n], r["implicit"]["grads"][n]) for n in names
                   if got["grads"][n] is not None) > 1e-3
    for name in names:
        np.testing.assert_array_equal(_leaf(ranks[0]["explicit"]["params"], name),
                                      _leaf(ranks[1]["explicit"]["params"], name))


@pytest.fixture(scope="module")
def inference_case():
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.key(22),
                                                     jcfg.ModelConfig(**SMALL)))
    rng = np.random.default_rng(22)
    x = rng.standard_normal((13, 12, 5)).astype(np.float32)  # 13: odd, pads
    x[:, :, 0] += np.where(np.arange(13) % 2, 2.0, -2.0)[:, None]
    y = (np.arange(13) % 2).astype(np.int64)
    case = dict(device="cpu", world=2, model=SMALL, params=jp, x=x, y=y, bf16=False,
                p_closed=rng.uniform(0.0, 1.0, 37))
    return case, mw.spawn(mw.inference, case)


def _port_model(case):
    params = params_from_jax(case["params"])
    return params, CoupledModel(params, tcfg.ModelConfig(**SMALL),
                                rates_to_array(DEFAULT_RATES), tcfg.CouplingConfig(),
                                device=torch.device("cpu"))


def test_predict_probs_with_the_mesh(inference_case):
    """N = 13 over two ranks (batches of 5 rounded up to 6, the last padded)
    against the JAX package's predict_probs on its mesh and the port's
    without one; every rank returns every row."""
    case, ranks = inference_case
    x = case["x"]
    want = jax_predict_probs(case["params"], x, jcfg.ModelConfig(**SMALL), batch_size=5,
                             bf16=False, mesh=jmesh.make_data_mesh(2))
    params, _ = _port_model(case)
    single = predict_probs(params, x, tcfg.ModelConfig(**SMALL), batch_size=5, bf16=False)
    for r in ranks:
        assert r["probs"].shape == (13, 2)
        np.testing.assert_allclose(r["probs"], want, atol=PROBS_F32_TOL, rtol=0)
        np.testing.assert_allclose(r["probs"], single, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ranks[0]["probs"], ranks[1]["probs"])


def test_predict_batch_with_the_mesh(inference_case):
    """The bucket rule with a mesh (13 -> 16, and chunks of 8 -> 8, 5 -> 8)
    against the JAX package's predict_batch on its mesh (bf16 scan path)
    and the port's without one."""
    case, ranks = inference_case
    x = case["x"]
    jmodel = JaxCoupledModel(case["params"], jcfg.ModelConfig(**SMALL),
                             jax_rates(DEFAULT_RATES), jcfg.CouplingConfig())
    want = jax_predict_batch(jmodel, x, mesh=jmesh.make_data_mesh(2))
    _, model = _port_model(case)
    single = predict_batch(model, x)
    for r in ranks:
        for got in (r["batch"], r["batch_chunked"]):
            assert set(got) == set(single)
            for k in ("probs", "attention", "trajectories", "final_state"):
                np.testing.assert_allclose(got[k], want[k], atol=ROLLOUT_BF16_TOL, rtol=0,
                                           err_msg=k)
                np.testing.assert_allclose(got[k], single[k], atol=1e-6, rtol=0, err_msg=k)
            for k in ("pred_binary", "pred_three"):
                np.testing.assert_array_equal(got[k], single[k], err_msg=k)


def test_sweep_permutation_and_forecasts_with_the_mesh(inference_case):
    """The coupling sweep (13 probabilities padded to 14), the permutation
    importance sharded (n = 12) and not (n = 13), and the forecasts (17
    start states padded to 18 with [1, 0, 0]) with the mesh against the
    port without it."""
    case, ranks = inference_case
    x, y = case["x"], case["y"]
    params, model = _port_model(case)
    cfg = tcfg.ModelConfig(**SMALL)
    sweep = coupling_strength_sweep(model, x, y, alphas=(0.0, 0.5, 1.0))
    perms = {n: permutation_channel_importance(params, cfg, x, y, n_permutations=2,
                                               n_samples=n) for n in (12, 13)}
    k = rates_to_array(DEFAULT_RATES)
    forecast = multistep_forecast(case["p_closed"], k)
    rolling = rolling_forecast_evaluation(case["p_closed"], k, window_size=5, horizon=2)
    assert len(forecast[5]["predictions"]) == 17
    for r in ranks:
        assert r["sweep"] == sweep
        for n, want in perms.items():
            got = r[f"perm{n}"]
            assert got["baseline_accuracy"] == want["baseline_accuracy"]
            np.testing.assert_allclose(got["importance"], want["importance"], atol=1e-9,
                                       rtol=0)
            assert got["ranking"] == want["ranking"]
        for h in (5, 10, 20):
            np.testing.assert_allclose(r["forecast"][h]["predictions"],
                                       forecast[h]["predictions"], atol=1e-6, rtol=0)
            np.testing.assert_array_equal(r["forecast"][h]["actuals"], forecast[h]["actuals"])
        assert len(r["rolling"]) == len(rolling)
        for a, b in zip(r["rolling"], rolling):
            assert a["window"] == b["window"] and a["accuracy"] == b["accuracy"]
            assert a["mae"] == pytest.approx(b["mae"], abs=1e-6)


def _toy_set(rng, n, steps=12, channels=5):
    y = rng.permutation(np.arange(n) % 2)
    x = rng.standard_normal((n, steps, channels)).astype(np.float32)
    x[:, :, 0] += (1.5 * (2 * y - 1))[:, None]
    return x, y


TOY_MODEL = dict(input_size=5, hidden_size=16, num_layers=2)
# trained weights with the mesh against without it: float32 roundings of the
# split sums, which AdamW turns into steps of up to ~lr where a gradient is
# near eps (measured 3.5e-5 after 3 toy epochs, 2.8e-4 after the CLI's 3
# epochs on 144 windows); the results the CLI writes from those weights
# (probabilities, metrics, importances) measured 6.1e-4 apart
TRAINED_ATOL = 1e-3
CLI_TRAINED_ATOL = 3e-3
TOY_TRAIN = dict(epochs=3, batch_size=16, accumulation_steps=2, eval_batch_size=32,
                 learning_rate=3e-3, warmup_epochs=1, patience=10, lstm_impl="plain")


@pytest.fixture(scope="module")
def trainer_case():
    rng = np.random.default_rng(23)
    data = (*_toy_set(rng, 64), *_toy_set(rng, 24))
    case = dict(device="cpu", world=2, model=TOY_MODEL, train=TOY_TRAIN, data=data)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = train_classifier(*data, tcfg.ModelConfig(**TOY_MODEL),
                                  tcfg.TrainConfig(**TOY_TRAIN), device="cpu", verbose=False)
    finally:
        torch.set_num_threads(threads)
    return case, single, mw.spawn(mw.trainer, case)


def test_train_classifier_with_the_mesh_is_the_single_device_run(trainer_case):
    """bf16 training with dropout on two ranks (each takes its rows of the
    batch and of the masks) against the run without a mesh: the same
    batches and masks, the sums split over two ranks. The first epoch's
    train loss to float32 rounding of its sums (measured 1.9e-8), every
    epoch's decisions, and the best params to TRAINED_ATOL."""
    _, single, ranks = trainer_case
    for r in ranks:
        assert r["epochs_run"] == single.epochs_run == 3
        assert r["history"]["train_loss"][0] == pytest.approx(
            single.history["train_loss"][0], rel=1e-5)
        assert r["history"]["learning_rates"] == single.history["learning_rates"]
        assert r["history"]["val_acc"] == single.history["val_acc"]
        assert r["best"] == single.best_val_f1
        for a, b in zip(jax.tree_util.tree_leaves(r["params"]),
                        jax.tree_util.tree_leaves(single.params)):
            np.testing.assert_allclose(a, b, atol=TRAINED_ATOL, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(ranks[0]["params"]),
                    jax.tree_util.tree_leaves(ranks[1]["params"])):
        np.testing.assert_array_equal(a, b)
    assert ranks[0]["history"] == {**ranks[1]["history"],
                                   "epoch_time_s": ranks[0]["history"]["epoch_time_s"]}


def test_train_classifier_with_the_mesh_refuses_an_epoch_transform(trainer_case):
    _, _, ranks = trainer_case
    assert all(r["transform_refused"] for r in ranks)


def _processed(tmp_path):
    rng = np.random.default_rng(24)
    arrays = {}
    for split, n in (("train", 48), ("val", 16), ("test", 40)):
        arrays[f"X_{split}"], arrays[f"y_{split}"] = _toy_set(rng, n)
    (tmp_path / "processed_data").mkdir(parents=True)
    np.savez_compressed(tmp_path / "processed_data" / "processed_sequences.npz", **arrays)
    save_results(tmp_path / "results" / "ode_results.json", {"fitted_params": DEFAULT_RATES})
    cfg = {"model": {"hidden_size": 16, "num_layers": 2},
           "train": {"batch_size": 16, "accumulation_steps": 2, "eval_batch_size": 32,
                     "warmup_epochs": 1, "learning_rate": 3e-3}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))


STAGES = (["train", "--epochs", "3"], ["integrate"], ["explain", "--skip-shap"], ["forecast"])


def _argv(root):
    return [["--output-dir", str(root), "--config", str(root / "cfg.json"), *stage,
             "--device", "cpu"] for stage in STAGES]


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    single_dir = tmp_path_factory.mktemp("single")
    mesh_dir = tmp_path_factory.mktemp("mesh")
    for d in (single_dir, mesh_dir):
        _processed(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_main, "figures", lambda stage: None)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for argv in _argv(single_dir):
                assert cli_main.main(argv) == 0
        finally:
            torch.set_num_threads(threads)
    ranks = mw.spawn(mw.cli, {"argv": _argv(mesh_dir)})
    return single_dir, mesh_dir, ranks


RESULT_FILES = ("lstm_results.json", "integration_results.json", "coupling_analysis.json",
                "all_model_results.json", "explainability_summary.json",
                "forecasting_results.json")


def test_cli_stages_under_two_ranks_write_each_file_once_from_rank_0(cli_case):
    _, mesh_dir, ranks = cli_case
    assert all(r["rcs"] == [0, 0, 0, 0] for r in ranks)
    assert ranks[1]["writes"] == [] and ranks[1]["outputs"] == ["", "", "", ""]
    written = [str(mesh_dir / "models" / "lstm_attention")] + [
        str(mesh_dir / "results" / name) for name in RESULT_FILES]
    written.insert(2, str(mesh_dir / "models" / "attention_weights.npy"))
    assert sorted(ranks[0]["writes"]) == sorted(written)
    out = ranks[0]["outputs"]
    assert "data-parallel mesh over 2 devices" in out[0] and "best val F1" in out[0]
    assert "coupled inference" in out[1] and "top channels" in out[2] and "h=5" in out[3]


def _numbers(a, b, path=""):
    """Every number of the JSON trees ``a`` and ``b`` side by side (the keys
    and strings equal)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _numbers(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            yield from _numbers(u, v, f"{path}[{i}]")
    elif isinstance(a, (int, float)) and not isinstance(a, bool):
        yield path, float(a), float(b)
    else:
        assert a == b, path


def test_cli_stages_under_two_ranks_write_the_single_process_files(cli_case):
    """The files of train -> integrate -> explain -> forecast on two ranks
    against the same stages in one process: the training sums split over
    two ranks, so the weights and every probability, metric and importance
    written from them sit within CLI_TRAINED_ATOL."""
    single_dir, mesh_dir, _ = cli_case
    p1, _, h1, _ = load_checkpoint(single_dir / "models" / "lstm_attention")
    p2, _, h2, _ = load_checkpoint(mesh_dir / "models" / "lstm_attention")
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(b, a, atol=CLI_TRAINED_ATOL, rtol=0)
    # the epoch's mean loss runs over four updates, after which the weights
    # differ by that much
    assert h1["train_loss"][0] == pytest.approx(h2["train_loss"][0], rel=1e-3)
    np.testing.assert_allclose(np.load(mesh_dir / "models" / "attention_weights.npy"),
                               np.load(single_dir / "models" / "attention_weights.npy"),
                               atol=CLI_TRAINED_ATOL, rtol=0)
    for name in RESULT_FILES:
        a = json.loads((single_dir / "results" / name).read_text())
        b = json.loads((mesh_dir / "results" / name).read_text())
        for path, u, v in _numbers(a, b, name):
            # the throughput is a timing; a Spearman rho and a direction
            # accuracy rank and sign differences between nearly equal
            # forecasts, so a shift of 1e-4 can reorder them
            if any(k in path for k in ("throughput", "correlation", "direction_accuracy")):
                continue
            assert v == pytest.approx(u, abs=CLI_TRAINED_ATOL, nan_ok=True), path
