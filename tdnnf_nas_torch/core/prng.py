"""Seed discipline (port of ``tdnnf_nas_tpu.core.prng``).

Every random draw of the port (dropout masks, Gumbel noise, uniform path
samples, egs shuffling) comes from an explicit ``torch.Generator`` or a
numpy ``RandomState`` seeded from an integer, never from a global
generator.  Keys are integer seeds: ``KeySeq`` hands out a reproducible
sequence of them for host-side set-up, and ``fold_in_step`` derives the
seed of a training step's draws from a key and the step alone, as the
reference's ``fold_in(key, state.step)`` does, so a run resumed from a
checkpoint draws at step k what an unbroken run draws there.

The reference's ``jax.random`` key streams are not reproduced: the same
integer seed gives other numbers here than there.  Parity tests pass the
JAX package's draws into the port instead.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


def _derive(key: int, index: int) -> int:
    """A 64-bit seed that depends on (key, index) alone."""
    return int(np.random.SeedSequence([int(key), int(index)]).generate_state(
        1, np.uint64)[0])


class KeySeq:
    """A mutable sequence of integer keys for host-side set-up code:
    ``next()`` gives the next key, ``take(n)`` the next n, and iterating
    gives them without end.  Each key is a function of the seed and its
    place in the sequence, and seeds a ``torch.Generator`` or a numpy
    ``RandomState`` (``% 2**32``)."""

    def __init__(self, seed: int):
        self._seed = int(seed)
        self._count = 0

    def next(self) -> int:
        key = _derive(self._seed, self._count)
        self._count += 1
        return key

    def take(self, n: int) -> List[int]:
        return [self.next() for _ in range(n)]

    def __iter__(self) -> Iterator[int]:
        while True:
            yield self.next()


def fold_in_step(key: int, step: int) -> int:
    """The seed of the draws of step ``step`` under ``key``: a function of
    (key, step) alone."""
    return _derive(key, step)
