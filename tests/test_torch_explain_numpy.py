"""The numpy and pure-Python modules the explain and integrate stages use,
against the JAX package's on the same inputs, exactly: ``analyze/tables``,
``explain/{attention,compare,ode_interp,summary}``, ``viz/regions``, and
KernelSHAP's coalition samplers and ``kernel_shap_values``."""

import numpy as np
import pytest
import torch

from eegflow.analyze import tables as jtables
from eegflow.explain import attention as jattention
from eegflow.explain import compare as jcompare
from eegflow.explain import kernelshap as jshap
from eegflow.explain import ode_interp as jode
from eegflow.explain import summary as jsummary
from eegflow.viz import regions as jregions
from eegflow_torch.analyze import tables as ttables
from eegflow_torch.explain import attention as tattention
from eegflow_torch.explain import compare as tcompare
from eegflow_torch.explain import kernelshap as tshap
from eegflow_torch.explain import ode_interp as tode
from eegflow_torch.explain import summary as tsummary
from eegflow_torch.kernels import HostCopy
from eegflow_torch.viz import regions as tregions

RATES = {"k_ap": 0.02, "k_af": 0.095, "k_pa": 0.02, "k_pf": 0.626, "k_fa": 0.139,
         "k_fp": 0.02}
RECOVERING = {"k_ap": 0.1, "k_af": 0.02, "k_pa": 0.3, "k_pf": 0.05, "k_fa": 0.4,
              "k_fp": 0.2}


def _zoo():
    baselines = {"svm": {"accuracy": 0.5, "f1": 0.4, "auc": 0.5, "mcc": 0.0,
                         "accuracy_ci_95": [0.45, 0.55]},
                 "rf": {"accuracy": 0.61, "f1": None, "auc": float("nan"), "mcc": 0.2}}
    lstm = {"accuracy": 0.7, "f1": 0.68, "auc": 0.75, "mcc": 0.4, "accuracy_ci_95": [0.65, 0.75]}
    integ = {"evaluation": {"accuracy": 0.71, "f1": 0.69, "auc": 0.74, "mcc": 0.41,
                            "accuracy_ci_95": [0.66, 0.76]}}
    ablation = {"Full Model": {"config": {"bidirectional": True, "use_attention": True,
                                          "num_layers": 3},
                               "metrics": {"accuracy": 0.9, "f1": 0.89, "mcc": 0.8}}}
    comparison = {"No Attention": {"mcnemar": {"p_value": 0.03, "method": "exact"},
                                   "cohens_d": 0.4, "effect_size": "small",
                                   "paired_t": {"p_value": 0.05}}}
    return baselines, lstm, integ, ablation, comparison


@pytest.mark.parametrize("which", ["all", "lstm_only", "none"])
def test_tables_equal_the_reference(which):
    baselines, lstm, integ, ablation, comparison = _zoo()
    args = {"all": (baselines, lstm, integ), "lstm_only": (None, lstm, None),
            "none": (None, None, None)}[which]
    merged = ttables.merge_all_model_results(*args)
    assert merged == jtables.merge_all_model_results(*args)
    assert ttables.format_results_table(merged) == jtables.format_results_table(merged)
    assert (ttables.create_results_tables(merged, ablation, comparison)
            == jtables.create_results_tables(merged, ablation, comparison))
    assert ttables.format_ablation_table(ablation) == jtables.format_ablation_table(ablation)
    assert (ttables.format_statistical_table(comparison)
            == jtables.format_statistical_table(comparison))


def test_attention_compare_and_ode_analyses_equal_the_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((40, 16))
    attn = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y = rng.integers(0, 2, 40)
    assert (tattention.analyze_attention_patterns(attn, y)
            == jattention.analyze_attention_patterns(attn, y))
    assert (tattention.analyze_attention_patterns(attn, np.zeros(40, int))
            == jattention.analyze_attention_patterns(attn, np.zeros(40, int)))
    chans = ["c1", "c2", "c3", "c4"]
    methods = [{"method": m, "channels": chans, "importance": list(rng.random(4))}
               for m in ("gradient", "permutation", "kernel_shap")]
    assert (tcompare.compare_importance_methods(methods)
            == jcompare.compare_importance_methods(methods))
    for rates in (RATES, RECOVERING):
        assert tode.analyze_ode_dynamics(rates) == jode.analyze_ode_dynamics(rates)
    assert tode.INTERPRETATIONS == jode.INTERPRETATIONS


def test_regions_equal_the_reference():
    assert tregions.CHANNEL_REGIONS == jregions.CHANNEL_REGIONS
    chans = ["O1", "Fz", "P7", "Iz", "Cz", "TP9", "POz", "xx"]
    assert [tregions.region_of(c) for c in chans] == [jregions.region_of(c) for c in chans]
    scores = np.linspace(0.1, 0.8, len(chans))
    assert (tregions.aggregate_by_region(chans, scores)
            == jregions.aggregate_by_region(chans, scores))


@pytest.mark.parametrize("with_extras", [True, False], ids=["attention_ode_shap", "bare"])
def test_build_summary_equals_the_reference(with_extras):
    chans = ["O1", "O2", "Oz", "F3", "P7", "Cz"]
    imp = [0.3, 0.2, 0.1, 0.15, 0.15, 0.1]
    order = list(np.argsort(imp)[::-1])
    grad = {"method": "gradient", "channels": chans, "importance": imp,
            "ranking": [chans[i] for i in order]}
    perm = {"method": "permutation", "channels": chans, "importance": imp[::-1],
            "ranking": [chans[i] for i in np.argsort(imp)]}
    comparison = {k: v for k, v in jcompare.compare_importance_methods([grad, perm]).items()
                  if k != "merged"}
    kw = {}
    if with_extras:
        kw = dict(attention_analysis=jattention.analyze_attention_patterns(
            np.full((8, 16), 1 / 16.0), np.array([0, 1] * 4)),
            ode_analysis=jode.analyze_ode_dynamics(RECOVERING),
            shap=dict(grad, method="kernel_shap"))
    got = tsummary.build_summary(grad, perm, comparison, **kw)
    assert got == jsummary.build_summary(grad, perm, comparison, **kw)


@pytest.mark.parametrize("c, nsamples", [(5, 40), (9, 60), (61, 100)])
def test_coalition_samplers_are_bit_identical(c, nsamples):
    np.testing.assert_array_equal(
        tshap._sample_coalitions(np.random.RandomState(7), c, nsamples),
        jshap._sample_coalitions(np.random.RandomState(7), c, nsamples))
    for got, want in zip(tshap._stratified_coalitions(np.random.RandomState(7), c, nsamples),
                         jshap._stratified_coalitions(np.random.RandomState(7), c, nsamples)):
        np.testing.assert_array_equal(got, want)
    if c <= 9:
        for got, want in zip(tshap._enumerate_coalitions(c), jshap._enumerate_coalitions(c)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c, nsamples, as_list", [(5, 100, False), (8, 30, True), (12, 10, False)],
                         ids=["enumerated", "stratified_chunks", "sampled"])
def test_kernel_shap_values_are_bit_identical(c, nsamples, as_list):
    """The three coalition tiers, with f_batch returning an array or a list
    of chunks, as the model hooks do."""
    rng = np.random.default_rng(c)
    w = rng.standard_normal(c)
    bg, xs = rng.standard_normal((7, c)), rng.standard_normal((4, c))

    def model(rows):
        return np.tanh(rows @ w) + 0.1 * rows[:, 0] * rows[:, -1]

    def f(rows):
        out = model(rows)
        return [out[: len(out) // 2], out[len(out) // 2:]] if as_list else out

    got = tshap.kernel_shap_values(f, xs, bg, nsamples=nsamples, seed=3)
    want = jshap.kernel_shap_values(f, xs, bg, nsamples=nsamples, seed=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(1), model(xs) - model(bg).mean(), atol=1e-12)


def test_host_copy_reads_like_an_array():
    t = torch.arange(6, dtype=torch.float32)
    copy = HostCopy(t[2:5])
    np.testing.assert_array_equal(np.asarray(copy, np.float64), [2.0, 3.0, 4.0])
    assert np.asarray(copy).dtype == np.float32
