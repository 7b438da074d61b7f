"""Generator seeds derived from a run's ``--seed`` (any whole number) and a salt."""

from __future__ import annotations

import numpy as np


def word(seed: int) -> int:
    """``seed`` as the unsigned 64-bit word that numpy's seeding takes."""
    return int(seed) % (1 << 64)


def derive(seed: int, *salts: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``seed`` and ``salts``."""
    words = [word(x) for x in (seed, *salts)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
