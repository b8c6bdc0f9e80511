"""Numpy copy of ``tdnnf_nas_tpu.graphs.fsa`` (dense state-emitting graphs).

Graphs are normalized on the host into a state-emitting form: a dense
transition matrix ``trans[S, S]``, the pdf each state emits
``state_pdf[S]``, and initial / final probabilities.  The forward
recursion is then ``alpha' = (alpha @ trans) * obs`` per frame (see
``ops/fwdbwd.forward_score`` and the dense-den kernels of
``ops/dense_den_cuda.py``), Kaldi's scaled-probability scheme batched over
the minibatch.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StateGraph:
    """Dense state-emitting probabilistic FSA.

    ``trans`` rows are stochastic on their own (sum to 1 for reachable
    states); ``final`` is a separate weight applied at the last frame.
    Chunked LF-MMI training uses ``final == 1`` everywhere for numerator and
    denominator (chunks are cut mid-utterance, as in Kaldi chain).  ``init``
    sums to 1.
    """

    trans: np.ndarray  # [S, S] float32
    state_pdf: np.ndarray  # [S] int32
    init: np.ndarray  # [S] float32
    final: np.ndarray  # [S] float32
    num_pdfs: int

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    def validate(self, stochastic: bool = True) -> None:
        s = self.num_states
        assert self.trans.shape == (s, s)
        assert self.state_pdf.shape == (s,)
        assert self.init.shape == (s,)
        assert self.final.shape == (s,)
        assert (self.state_pdf >= 0).all() and (self.state_pdf < self.num_pdfs).all()
        assert abs(self.init.sum() - 1.0) < 1e-4, self.init.sum()
        if stochastic:
            row = self.trans.sum(axis=1)
            reachable = (self.init > 0) | (self.trans.sum(axis=0) > 0)
            assert np.allclose(row[reachable], 1.0, atol=1e-4), row[reachable]

    def normalize(self) -> "StateGraph":
        """Make trans row-stochastic (final left as-is)."""
        row = self.trans.sum(axis=1)
        row = np.where(row > 0, row, 1.0)
        return StateGraph(
            trans=(self.trans / row[:, None]).astype(np.float32),
            state_pdf=self.state_pdf,
            init=(self.init / self.init.sum()).astype(np.float32),
            final=self.final.astype(np.float32),
            num_pdfs=self.num_pdfs,
        )


def stationary_init(
    trans: np.ndarray,
    iters: int = 100,
    start: np.ndarray | None = None,
    average: bool = False,
) -> np.ndarray:
    """Denominator-graph initial probs by power iteration.

    Mirrors Kaldi `chain-den-graph.cc` SetInitialProbs: iterate the
    transition matrix ``iters`` times and (with ``average=True``, the Kaldi
    semantics) average the per-iteration occupancies starting from the
    graph's true initial distribution, so utterance-early (BOS-context)
    states keep ~1/iters mass.  ``start=None`` starts from uniform.  Used
    both as alpha(0) and as the leaky-HMM destination distribution.
    """
    s = trans.shape[0]
    p = (np.full((s,), 1.0 / s, dtype=np.float64) if start is None
         else np.asarray(start, np.float64) / max(np.asarray(start).sum(), 1e-30))
    t = trans.astype(np.float64)
    acc = p.copy() if average else None
    for _ in range(iters):
        p = p @ t
        tot = p.sum()
        if tot <= 0:
            raise ValueError("transition matrix has no probability mass")
        p /= tot
        if average:
            acc += p
    out = acc / acc.sum() if average else p
    return out.astype(np.float32)
