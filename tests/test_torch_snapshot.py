"""The port's crash-recovery snapshots against ``eegflow.train.loop``: the
``train_state.msgpack`` layout of optax's state (with and without gradient
accumulation), each package resuming the other's snapshot, an interrupted
and resumed run equal to the uninterrupted one bit for bit, and the
reference's resume semantics (the ``extra`` keys, the history cut, the best
score kept only under the same selection metric), for both model families.

A run is interrupted by an ``epoch_transform`` that raises at the start of
an epoch, after the previous epoch's snapshot was written."""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from eegflow.core import config as jcfg
from eegflow.core.artifacts import jax_to_numpy
from eegflow.nn.model import classifier_init as jax_init
from eegflow.train.loop import train_classifier as jax_train_classifier
from eegflow.train.steps import make_optimizer as jax_make_optimizer
from eegflow_torch.convert import params_from_jax
from eegflow_torch.core import config as tcfg
from eegflow_torch.core.artifacts import load_checkpoint, msgpack_unpack, save_train_state
from eegflow_torch.nn.model import classifier_init
from eegflow_torch.train.loop import restore_train_state, train_classifier
from eegflow_torch.train.steps import leaf_at, make_optimizer, optimizer_state_dict
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = {
    "lstm": ("ModelConfig", dict(input_size=4, hidden_size=16, num_layers=2, dropout=0.2)),
    "transformer": ("TransformerConfig", dict(input_size=4, d_model=16, num_layers=2,
                                              num_heads=2, mlp_ratio=2, dropout=0.1)),
}
# 96 training windows in batches of 16: 6 micro-steps an epoch, so with
# accumulation 4 an epoch ends between updates (mini_step 2 after epochs 1
# and 3) and the snapshot carries a partial acc_grads
TRAIN = dict(epochs=3, batch_size=16, eval_batch_size=64, accumulation_steps=4,
             warmup_epochs=1, patience=10, bf16=False, augment=False)
# both packages' float32 training from the same snapshot, dropout 0: the same
# operations in another order through 12 micro-steps of AdamW
CROSS_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Toy widths: per-operation work too small to share out, so one thread,
    not one per core of the cores the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Interrupted(Exception):
    pass


def interrupt_at(epoch_index):
    """An ``epoch_transform`` that stops the run when epoch ``epoch_index``
    (0-based) starts."""
    def transform(x, epoch):
        if int(epoch) == epoch_index:
            raise Interrupted
        return x
    return transform


def _configs(family, **kw):
    name, base = FAMILIES[family]
    base = dict(base, **kw)
    return getattr(jcfg, name)(**base), getattr(tcfg, name)(**base)


def _data(seed=0, n=120):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(np.int64)
    x = rng.standard_normal((n, 16, 4)).astype(np.float32)
    x[y == 1] += 0.4
    return x[:96], y[:96], x[96:], y[96:]


def _layout(tree, prefix=""):
    """{path: (shape, dtype)} of a state-dict tree; an empty map is a leaf."""
    if isinstance(tree, dict):
        if not tree:
            return {prefix: "{}"}
        out = {}
        for k, v in tree.items():
            out.update(_layout(v, f"{prefix}/{k}"))
        return out
    arr = np.asarray(tree)
    return {prefix: (arr.shape, arr.dtype.str)}


@pytest.mark.parametrize("accumulation", [1, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_state_layout_matches_optax(tmp_path, family, accumulation):
    """The keys, shapes and dtypes of ``train_state.msgpack`` are those the
    reference writes from ``tx.init`` of its optimizer (``optax.MultiSteps``
    with accumulation, the bare chain without)."""
    jc, tc = _configs(family)
    jp = jax_init(jax.random.key(1), jc)
    tx = jax_make_optimizer(jcfg.TrainConfig(accumulation_steps=accumulation), 3)
    want = msgpack_unpack(serialization.to_bytes(
        jax_to_numpy({"params": jp, "opt_state": tx.init(jp)})))
    params = params_from_jax(jp, trainable=True)
    names = [n for n, _ in params.named_parameters()]
    opt = make_optimizer(list(params.parameters()),
                         tcfg.TrainConfig(accumulation_steps=accumulation), 3)
    save_train_state(tmp_path, params, optimizer_state_dict(opt, names))
    got = msgpack_unpack((tmp_path / "train_state.msgpack").read_bytes())
    assert _layout(got) == _layout(want)
    assert ("mini_step" in got["opt_state"]) == (accumulation > 1)
    for name in names:
        np.testing.assert_array_equal(leaf_at(got["params"], name),
                                      leaf_at(want["params"], name))


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_interrupted_and_resumed_equals_uninterrupted(tmp_path, family, bf16):
    """Interrupted after epoch 1 of 3 and resumed from its snapshot, a run
    ends with the uninterrupted run's train state (params and every optimizer
    leaf, byte for byte) and training-loss history; dropout on."""
    _, tc = _configs(family)
    train = tcfg.TrainConfig(**dict(TRAIN, bf16=bf16))
    args = (*_data(), tc, train)
    full = train_classifier(*args, device="cpu", verbose=False,
                            checkpoint_dir=tmp_path / "full", checkpoint_every=1)
    with pytest.raises(Interrupted):
        train_classifier(*args, device="cpu", verbose=False, checkpoint_dir=tmp_path / "cut",
                         checkpoint_every=1, epoch_transform=interrupt_at(1))
    resumed = train_classifier(*args, device="cpu", verbose=False,
                               checkpoint_dir=tmp_path / "resumed", checkpoint_every=1,
                               resume_from=tmp_path / "cut")
    assert resumed.epochs_run == full.epochs_run == 3
    assert ((tmp_path / "resumed" / "train_state.msgpack").read_bytes()
            == (tmp_path / "full" / "train_state.msgpack").read_bytes())
    for key in ("train_loss", "train_acc", "val_loss", "val_f1", "learning_rates"):
        assert resumed.history[key] == full.history[key], key


@pytest.fixture(scope="module", params=list(FAMILIES))
def crossed(request, tmp_path_factory):
    """Dropout 0, float32: the port's run interrupted after epoch 1, the
    reference resumed from its snapshot to epoch 3 (writing its own
    snapshots), and the port's uninterrupted run."""
    family = request.param
    d = tmp_path_factory.mktemp(f"snap_{family}")
    jc, tc = _configs(family, dropout=0.0)
    data = _data()
    port_train = tcfg.TrainConfig(**TRAIN, lstm_impl="plain")
    full = train_classifier(*data, tc, port_train, device="cpu", verbose=False,
                            checkpoint_dir=d / "full", checkpoint_every=1)
    with pytest.raises(Interrupted):
        train_classifier(*data, tc, port_train, device="cpu", verbose=False,
                         checkpoint_dir=d / "cut", checkpoint_every=1,
                         epoch_transform=interrupt_at(1))
    shutil.copytree(d / "cut", d / "cut_kept")
    ref = jax_train_classifier(*data, jc, jcfg.TrainConfig(**TRAIN), verbose=False,
                               checkpoint_dir=d / "jax", checkpoint_every=1,
                               resume_from=d / "cut")
    return family, d, tc, jc, full, ref


def test_reference_resumes_a_port_snapshot(crossed):
    """``eegflow.train.loop.train_classifier(resume_from=...)`` on the port's
    epoch-1 snapshot: flax restores it into the reference's own target, the
    history is cut there, and the two resumed epochs train as the port's
    uninterrupted run does (wrong counts or moments would not)."""
    family, d, tc, jc, full, ref = crossed
    raw = (d / "cut_kept" / "train_state.msgpack").read_bytes()
    jp = jax_init(jax.random.key(0), jc)
    tx = jax_make_optimizer(jcfg.TrainConfig(**TRAIN), 1)
    restored = serialization.from_bytes({"params": jp, "opt_state": tx.init(jp)}, raw)
    want = msgpack_unpack(raw)
    assert int(restored["opt_state"].mini_step) == 2
    assert int(restored["opt_state"].gradient_step) == 1
    for path, leaf in jax.tree_util.tree_leaves_with_path(restored["params"]):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf), leaf_at(want["params"], name))
    assert ref.epochs_run == 3
    assert ref.history["train_loss"][0] == full.history["train_loss"][0]
    np.testing.assert_allclose(ref.history["train_loss"][1:], full.history["train_loss"][1:],
                               rtol=CROSS_LOSS_RTOL)


def test_port_restores_a_jax_snapshot_exactly(crossed):
    """The reference's epoch-3 snapshot (written after resuming the port's):
    params, mu, nu, acc_grads, mini_step and count restored bit for bit, and
    the port's loop trains on from it."""
    family, d, tc, jc, full, ref = crossed
    snap = serialization.msgpack_restore((d / "jax" / "train_state.msgpack").read_bytes())
    params = classifier_init(tc, trainable=True)
    train = tcfg.TrainConfig(**TRAIN)
    opt = make_optimizer(list(params.parameters()), train, 1)
    assert restore_train_state(d / "jax", params, opt)
    adam = snap["opt_state"]["inner_opt_state"]["1"]["0"]
    assert opt.mini_step == int(snap["opt_state"]["mini_step"]) == 2
    assert opt.count == int(adam["count"]) == int(snap["opt_state"]["gradient_step"]) == 4
    for i, (name, p) in enumerate(params.named_parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), leaf_at(snap["params"], name))
        for got, tree in ((opt.mu[i], adam["mu"]), (opt.nu[i], adam["nu"]),
                          (opt.acc[i], snap["opt_state"]["acc_grads"])):
            np.testing.assert_array_equal(got.numpy(), leaf_at(tree, name))
    more = train_classifier(*_data(), tc, dataclasses.replace(train, epochs=4), device="cpu",
                            verbose=False, resume_from=d / "jax")
    assert more.epochs_run == 4 and len(more.history["train_loss"]) == 4
    assert more.history["train_loss"][:3] == ref.history["train_loss"]


def test_snapshot_extra_and_history_match_the_reference(crossed):
    """Both packages' epoch-3 snapshots: the same ``extra`` keys and counts,
    the history of every epoch, the model family."""
    family, d, tc, jc, full, ref = crossed
    port = json.loads((d / "full" / "checkpoint.json").read_text())
    jax_side = json.loads((d / "jax" / "checkpoint.json").read_text())
    assert port["extra"].keys() == jax_side["extra"].keys() == {
        "epoch", "best_val_f1", "selection_metric", "step", "resumable"}
    for key in ("epoch", "selection_metric", "step", "resumable"):
        assert port["extra"][key] == jax_side["extra"][key]
    assert port["extra"]["epoch"] == 3 and port["extra"]["step"] == 18
    assert port["model_type"] == jax_side["model_type"] == type(tc).__name__
    assert port["history"].keys() == jax_side["history"].keys()
    assert all(len(v) == 3 for v in port["history"].values())
    # the cut: the reference's first epoch is the port's snapshot's
    cut = json.loads((d / "cut_kept" / "checkpoint.json").read_text())
    assert cut["extra"]["epoch"] == 1 and cut["extra"]["best_val_f1"] == float("-inf")
    for key, vals in cut["history"].items():
        assert jax_side["history"][key][:1] == vals


@pytest.mark.parametrize("family", list(FAMILIES))
def test_resume_keeps_the_best_only_under_the_same_metric(tmp_path, family):
    """The snapshot's best score (set here to 2.0, which no MCC reaches) is
    kept under the same selection metric, so a frozen resumed run returns
    ``params.msgpack``'s params; under another metric the comparison
    restarts from -inf and the snapshot's current params win. A directory
    without ``train_state.msgpack`` starts afresh."""
    _, tc = _configs(family)
    train = tcfg.TrainConfig(**TRAIN)
    data = _data(seed=1)
    with pytest.raises(Interrupted):
        train_classifier(*data, tc, train, device="cpu", verbose=False,
                         checkpoint_dir=tmp_path / "cut", checkpoint_every=1,
                         epoch_transform=interrupt_at(1))
    payload = json.loads((tmp_path / "cut" / "checkpoint.json").read_text())
    payload["extra"]["best_val_f1"] = 2.0
    (tmp_path / "cut" / "checkpoint.json").write_text(json.dumps(payload))
    best = load_checkpoint(tmp_path / "cut")[0]
    current = msgpack_unpack((tmp_path / "cut" / "train_state.msgpack").read_bytes())["params"]
    frozen = dataclasses.replace(train, learning_rate=0.0)
    same = train_classifier(*data, tc, frozen, device="cpu", verbose=False,
                            resume_from=tmp_path / "cut")
    other = train_classifier(*data, tc, dataclasses.replace(frozen, selection_metric="f1"),
                             device="cpu", verbose=False, resume_from=tmp_path / "cut")
    assert same.best_val_f1 == 2.0 and other.best_val_f1 <= 1.0
    names = [n for n, _ in classifier_init(tc).named_parameters()]
    for name in names:
        np.testing.assert_array_equal(leaf_at(_named(same.params), name),
                                      leaf_at(_named(best), name))
        np.testing.assert_array_equal(leaf_at(_named(other.params), name),
                                      leaf_at(current, name))
    (tmp_path / "cut" / "train_state.msgpack").unlink()
    fresh = train_classifier(*data, tc, train, device="cpu", verbose=False,
                             resume_from=tmp_path / "cut")
    again = train_classifier(*data, tc, train, device="cpu", verbose=False)
    assert fresh.history["train_loss"] == again.history["train_loss"]


def _named(tree):
    """A params pytree with lists as {"0": ...} maps, for ``leaf_at``."""
    if isinstance(tree, list):
        return {str(i): _named(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _named(v) for k, v in tree.items()}
    return tree
