"""Model finalization: batchnorm stats recompute, checkpoint combination,
parameter shrinkage (port of ``tdnnf_nas_tpu.train.finalize``,
`train/finalize.py:25-111` there), on the port's ``TrainState`` and
tensors.

  recompute_bn_stats  ``RecomputeStats`` before decode
                      (`nnet-utils.cc:541-551`): the BN statistics
                      re-accumulated over batches with frozen params
  combine_states      ``nnet3-chain-combine`` (`train.py:572-585`): the
                      best state by a validation objective, the uniform
                      average, or the greedy weighted average
  shrink_params       per-iteration shrinkage (`train.py:484-500`)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from tdnnf_nas_torch.train.optimizer import tree_paths, tree_unflatten
from tdnnf_nas_torch.train.trainer import TrainState


def recompute_bn_stats(apply_train_fn, state: TrainState, batches,
                       max_batches: int = 20) -> TrainState:
    """Refresh ``state.bn_state`` by forwards in train mode over at most
    ``max_batches`` of ``batches``, starting from the stored stats.

    apply_train_fn(params, bn_state, batch) -> new bn_state (one forward
    in train mode).
    """
    bn = state.bn_state
    for i, batch in enumerate(batches):
        if i >= max_batches:
            break
        bn = apply_train_fn(state.params, bn, batch)
    return dataclasses.replace(state, bn_state=bn)


def _average(param_sets):
    """The leafwise float32 mean of same-structured param trees."""
    paths = [p for p, _ in tree_paths(param_sets[0])]
    columns = zip(*([x for _, x in tree_paths(ps)] for ps in param_sets))
    return tree_unflatten([
        (p, sum(x.float() for x in xs) / len(xs))
        for p, xs in zip(paths, columns)])


def combine_states(states: Sequence[TrainState], valid_objf_fn: Callable,
                   mode: str = "best"):
    """Final model combination over checkpoint states; returns (state,
    the validation objective of each input state).

    "best": the state with the highest validation objective
    (get_best_nnet_model, `common.py:167`).  "average": the uniform
    param average of all states, with the best state's BN and optimizer
    state (get_average_nnet_model, `common.py:144`).  "weighted": start
    from the best state and add the others, in objective order, to a
    uniform average while the validation objective improves, so it never
    returns a model worse than the best single state.
    """
    objfs = [float(valid_objf_fn(s)) for s in states]
    best = int(np.argmax(objfs))
    if mode == "best":
        return states[best], objfs
    if mode == "average":
        return dataclasses.replace(
            states[best], params=_average([s.params for s in states])), objfs
    if mode != "weighted":
        raise ValueError(f"unknown combination mode {mode!r}")
    order = list(np.argsort(objfs)[::-1])
    chosen = [states[order[0]].params]
    cur, cur_objf = states[order[0]], objfs[order[0]]
    for idx in order[1:]:
        cand = dataclasses.replace(
            states[best], params=_average(chosen + [states[idx].params]))
        cand_objf = float(valid_objf_fn(cand))
        if cand_objf > cur_objf:
            chosen.append(states[idx].params)
            cur, cur_objf = cand, cand_objf
    return cur, objfs


@torch.no_grad()
def shrink_params(params, shrink: float,
                  skip_substrings=("lda", "output_")):
    """``params`` scaled by ``shrink`` (< 1), except the leaves whose
    "/"-joined key path contains one of ``skip_substrings`` (the fixed
    LDA and the output layers): the chain shrinkage for saturated ReLU
    models."""
    return tree_unflatten([
        (p, x if any(s in "/".join(p) for s in skip_substrings)
         else x * shrink)
        for p, x in tree_paths(params)])
