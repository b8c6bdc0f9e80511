"""Least work of the blocked den pair (forward scan and its adjoint) for
one step, from the den graph's own states and arcs, not from the padded
blocks the kernels lay them out in.

Per frame and sequence the forward recursion adds each position's state
masses (S additions), multiplies and adds along every arc (2 A), weighs
each state by its observation and sums for the renormalisation (2 S);
the adjoint does the same work twice over (its transposed product and
the observation gradient).  Bytes: each state observation read once
(``obs_bytes`` each: 2 for bf16 observations), each observation
gradient written once in float32, the arcs (source, destination,
weight: 12 bytes) and the per-state init and final weights read once.
"""

from __future__ import annotations


def ops_bytes(batch: int, frames: int, states: int, arcs: int,
              obs_bytes: int = 4):
    fwd = batch * frames * (2.0 * arcs + 3.0 * states)
    ops = 3.0 * fwd
    nbytes = (batch * frames * states * (obs_bytes + 4.0) + 12.0 * arcs
              + 8.0 * states)
    return ops, nbytes
