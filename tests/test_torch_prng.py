"""The port's integer-key PRNG (``core/prng.py``): ``KeySeq`` hands out
keys that depend on the seed and their place alone, and ``fold_in_step``
is the trainer's per-step seed, so a resumed run draws what the unbroken
run draws.  JAX's key streams are not reproduced, so nothing here is
compared with the reference's numbers."""

import numpy as np
import torch

from tdnnf_nas_torch.core.prng import KeySeq, fold_in_step
from tdnnf_nas_torch.train.trainer import step_seed


def test_keyseq_and_fold_in_step():
    """Keys depend on the seed and their place alone; fold_in_step is the
    trainer's step seed."""
    a, b = KeySeq(7), KeySeq(7)
    first = a.take(3)
    assert first == [b.next(), b.next(), b.next()]
    assert len(set(first)) == 3 and first != KeySeq(8).take(3)
    it = iter(KeySeq(7))
    assert [next(it) for _ in range(3)] == first
    assert fold_in_step(5, 11) == step_seed(5, 11)
    assert fold_in_step(5, 11) != fold_in_step(5, 12)
    g1 = torch.Generator().manual_seed(first[0])
    g2 = torch.Generator().manual_seed(KeySeq(7).next())
    assert torch.equal(torch.rand(4, generator=g1),
                       torch.rand(4, generator=g2))


def test_keys_seed_numpy_and_torch_generators():
    """A key seeds a numpy RandomState (mod 2**32) and a torch generator;
    equal keys give equal draws, the next key other draws."""
    k0, k1 = KeySeq(0).take(2)
    a = np.random.RandomState(k0 % 2**32).randn(5)
    assert np.array_equal(a, np.random.RandomState(k0 % 2**32).randn(5))
    assert not np.array_equal(a, np.random.RandomState(k1 % 2**32).randn(5))
    assert 0 <= k0 < 2**64 and 0 <= k1 < 2**64


def test_fold_in_step_resumes():
    """The draws of step k depend on (key, k) alone: a generator reseeded
    at step 5 of a fresh run equals step 5 of the unbroken run."""
    def draws(steps, key=3):
        out = []
        g = torch.Generator()
        for s in steps:
            g.manual_seed(fold_in_step(key, s))
            out.append(torch.rand(3, generator=g))
        return out

    unbroken = draws(range(8))
    resumed = draws(range(5, 8))
    for a, b in zip(unbroken[5:], resumed):
        assert torch.equal(a, b)
