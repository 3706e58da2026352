"""Seeded generators.

The JAX package threads explicit ``jax.random`` keys; here every random draw
takes an explicit ``torch.Generator``. The two libraries give different
numbers from the same seed, so tests that compare the packages make their
inputs with numpy and hand them to both.
"""

from __future__ import annotations

import torch


def make_generator(seed: int = 42) -> torch.Generator:
    """A CPU generator seeded with ``seed``. Parameters are drawn on the CPU
    and then moved, so one seed gives the same weights on every device."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return gen
