"""Wall-clock spans and an optional ``torch.profiler`` trace
(``eegflow.core.timing``).

:class:`Timer` collects named spans, :func:`timed` records each call of a
function under a name, and :func:`torch_trace`, the counterpart of the JAX
package's ``jax_trace``, wraps a block in a ``torch.profiler`` session that
writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch


class Timer:
    """Collects named wall-clock spans; supports nesting via context manager."""

    def __init__(self) -> None:
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.spans.get(name, []))

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": sum(v), "count": len(v), "mean_s": sum(v) / len(v)}
            for k, v in self.spans.items()
        }


GLOBAL_TIMER = Timer()


def timed(name: Optional[str] = None, timer: Timer = GLOBAL_TIMER) -> Callable:
    """Decorator recording wall time of each call under ``name``."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with timer.span(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def torch_trace(logdir: Optional[str | Path] = None,
                device: Optional[torch.device | str] = None):
    """Wrap a block in a ``torch.profiler`` session (CPU activity, and CUDA
    activity when ``device`` is a CUDA device) and write its Chrome trace
    into ``logdir`` as ``torch_trace_<time>_<pid>.json``; a no-op when
    ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = Path(logdir) / f"torch_trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    with profile(activities=activities) as prof:
        yield
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
