"""Independent random streams from one ``--seed``."""

from __future__ import annotations

import zlib

import numpy as np


def stream_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` (weights, rows, order, check, ...)
    from the run's seed: the same pair always gives the same stream, and
    every seed up to 2**64 is taken whole."""
    seq = np.random.SeedSequence([int(seed) % 2**64,
                                  zlib.crc32(purpose.encode())])
    return int(seq.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, purpose))
