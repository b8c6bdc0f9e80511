"""Least work of the dense den pair (forward scan and its adjoint) for
one step, from the den's nonzero transitions (its arcs), not from the
dense [S, S] matrix the kernels multiply by.

Per frame and sequence the forward recursion adds the leaky term (S),
multiplies and adds along every arc (2 A), weighs each state by its
observation and sums for the renormalisation (2 S); the adjoint does
the same work twice over.  Bytes: each state's log-observation read once
in float32, each gradient written once in float32, the arcs (12 bytes)
and the per-state init and final weights read once.
"""

from __future__ import annotations


def ops_bytes(batch: int, frames: int, states: int, arcs: int):
    fwd = batch * frames * (2.0 * arcs + 3.0 * states)
    ops = 3.0 * fwd
    nbytes = batch * frames * states * 8.0 + 12.0 * arcs + 8.0 * states
    return ops, nbytes
