"""Converters between the JAX package's state and the port's tensors.

The JAX package keeps ``params``, ``bn_state`` and Adam's ``m``/``v`` as
nested dicts of arrays; callers hand them over as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, tree)``), so this module never sees a
JAX array.  Keys and layouts carry over one to one, including the
[K, F, D] spliced-weight layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tdnnf_nas_torch.train.trainer import TrainState


def tree_to_torch(tree, device="cpu"):
    """Nested dict of numpy arrays -> same structure of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def tree_to_numpy(tree):
    """Nested dict of tensors -> same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def train_state_from_numpy(params, bn_state, opt_state, step: int,
                           device="cpu") -> TrainState:
    """TrainState from the JAX package's (numpy) params, bn_state and Adam
    state ``{"m": ..., "v": ...}``."""
    return TrainState(
        params=tree_to_torch(params, device),
        bn_state=tree_to_torch(bn_state, device),
        opt_state={"m": tree_to_torch(opt_state["m"], device),
                   "v": tree_to_torch(opt_state["v"], device)},
        step=int(step))


def train_state_to_numpy(state: TrainState):
    """(params, bn_state, {"m", "v"}, step) as numpy, the inverse of
    :func:`train_state_from_numpy`."""
    return (tree_to_numpy(state.params), tree_to_numpy(state.bn_state),
            {"m": tree_to_numpy(state.opt_state["m"]),
             "v": tree_to_numpy(state.opt_state["v"])},
            state.step)


def batch_to_torch(batch: dict, device="cpu"):
    """Host numpy batch (``data.egs.batch_iterator``) -> tensors on device."""

    def dev(a):
        return torch.as_tensor(a).to(device)

    sup = batch["sup"]
    out = {
        "feats": dev(batch["feats"]),
        "sup": dataclasses.replace(
            sup, trans=dev(sup.trans), state_pdf=dev(sup.state_pdf),
            init=dev(sup.init), final=dev(sup.final), mask=dev(sup.mask),
            next_w=None if sup.next_w is None else dev(sup.next_w)),
    }
    if batch.get("ivectors") is not None:
        out["ivectors"] = dev(batch["ivectors"])
    return out
