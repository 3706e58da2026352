"""Records of the figures both packages draw, for the port's figure tests.

:func:`figure_record` reads a figure's artist data (per axes: the title,
labels and tick labels, the lines' data, the patches' geometry, the image
arrays, the scatter offsets, the filled polygons and the texts) without
rasterising it. :func:`patch_figures` replaces ``save_figure`` in both
packages' figure modules with one that records the figure, writes empty
``name.png`` and ``name.pdf`` files (so the stages' file names can be held)
and closes it, and wraps every plot function of ``eegflow.viz`` and
``eegflow_torch.viz`` so that the arguments of each call are kept before it
runs: the JAX stages import their plot functions from ``eegflow.viz`` at
call time, the port's stages call them through ``eegflow_torch.viz``.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
from matplotlib.collections import PathCollection, PolyCollection
from matplotlib.patches import Circle, Rectangle

import eegflow.viz as jax_viz
import eegflow.viz.figures as jax_figures
import eegflow_torch.viz as port_viz
import eegflow_torch.viz.figures as port_figures

PLOT_FUNCTIONS = sorted(n for n in dir(jax_figures) if n.startswith("plot_"))
# the figures each stage of the JAX package draws (eegflow/cli/main.py), in order
STAGE_FIGURES = {
    "explore": ["fig03_spectral", "fig02_timeseries"],
    "preprocess": ["fig01_class_distribution", "fig04_preprocessing"],
    "baselines": ["fig05_baselines"],
    "train": ["fig07_training", "fig08_attention"],
    "fit-ode": ["fig10_ode_analysis", "fig11_state_diagram", "fig12_sensitivity_heatmap"],
    "integrate": ["fig13_coupling", "fig14_trajectories", "fig15_model_zoo"],
    "explain": ["fig21_shap_analysis", "fig18_attention_explainability",
                "fig20_ode_explainability", "fig16_gradient_importance",
                "fig17_permutation_importance", "fig19_importance_comparison"],
    "forecast": ["fig23_forecasting"],
    "ablate": ["fig25_ablation"],
}


def _patch(p):
    if isinstance(p, Rectangle):
        return ("rect", np.array([p.get_x(), p.get_y(), p.get_width(), p.get_height()], float))
    if isinstance(p, Circle):
        return ("circle", np.array([*p.center, p.radius], float))
    return (type(p).__name__,)


def _data(v):
    """Line data as floats, or as strings on a categorical axis."""
    a = np.asarray(v)
    return a.astype(float) if a.dtype.kind in "biuf" else [str(x) for x in a]


def figure_record(fig) -> dict:
    """The artist data of ``fig``, axes by axes."""
    axes = []
    for ax in fig.axes:
        axes.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
            "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
            "lines": [(_data(ln.get_xdata()), _data(ln.get_ydata())) for ln in ax.lines],
            "patches": [_patch(p) for p in ax.patches],
            "images": [np.asarray(im.get_array(), float) for im in ax.images],
            "scatter": [np.asarray(c.get_offsets(), float) for c in ax.collections
                        if isinstance(c, PathCollection)],
            "fills": [[np.asarray(p.vertices, float) for p in c.get_paths()]
                      for c in ax.collections if isinstance(c, PolyCollection)],
            "texts": [t.get_text() for t in ax.texts],
        })
    suptitle = fig._suptitle.get_text() if fig._suptitle is not None else None
    return {"suptitle": suptitle, "axes": axes}


def assert_close(got, want, rtol=1e-6, atol=1e-12, where="record"):
    """``got`` equal to ``want`` in structure (dict keys, sequence lengths,
    strings, array shapes), numbers within ``atol + rtol * |want|``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, list(got), list(want))
        for k in want:
            assert_close(got[k], want[k], rtol, atol, f"{where}.{k}")
    elif isinstance(want, (str, type(None), bool)):
        assert got == want, (where, got, want)
    elif isinstance(want, (list, tuple)) and not all(
            isinstance(v, (bool, int, float, np.number)) for v in want):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, rtol, atol, f"{where}[{i}]")
    else:
        g, w = np.asarray(got, float), np.asarray(want, float)
        assert g.shape == w.shape, (where, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=where)


def _recording_save_figure(figures, records):
    plt = figures.pyplot() if hasattr(figures, "pyplot") else figures.plt

    def save_figure(fig, path_base, formats=("png", "pdf")):
        path_base = Path(path_base)
        records.append((path_base.name, figure_record(fig)))
        path_base.parent.mkdir(parents=True, exist_ok=True)
        written = []
        for ext in formats:
            p = path_base.with_suffix(f".{ext}")
            p.write_bytes(b"")
            written.append(str(p))
        plt.close(fig)
        return written

    return save_figure


def _arg(v):
    if isinstance(v, Path):
        return v.name
    if hasattr(v, "cpu") and hasattr(v, "numpy"):
        return v.detach().cpu().numpy().copy()
    if isinstance(v, np.ndarray) or type(v).__module__.startswith("jax"):
        return np.array(v)
    if isinstance(v, dict):
        return {k: _arg(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_arg(x) for x in v)
    return v


def _recording_plot(fn, name, calls):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        kept = {k: _arg(v) for k, v in kwargs.items() if k != "device"}
        calls.append((name, [_arg(a) for a in args], kept))
        return fn(*args, **kwargs)

    return wrapper


def patch_figures(mp):
    """Patch both packages on the ``pytest.MonkeyPatch`` ``mp`` -> ``{"jax":
    {"figures": [...], "calls": [...]}, "port": {...}}``, lists the patched
    functions append to: (file name, :func:`figure_record`) per saved figure,
    (plot function, args, kwargs) per plot call."""
    out = {}
    for key, viz, figures in (("jax", jax_viz, jax_figures), ("port", port_viz, port_figures)):
        out[key] = {"figures": [], "calls": []}
        mp.setattr(figures, "save_figure", _recording_save_figure(figures, out[key]["figures"]))
        for name in PLOT_FUNCTIONS:
            mp.setattr(viz, name, _recording_plot(getattr(figures, name), name,
                                                  out[key]["calls"]))
    return out


def figure_files(out) -> list:
    """The file names under ``out / "figures"``."""
    return sorted(p.name for p in (out / "figures").glob("*")) if (out / "figures").exists() \
        else []


def call_name(call):
    """A recorded plot call's function and figure file name."""
    return call[0], next(a for a in call[1] if isinstance(a, str) and a.startswith("fig"))

