"""Converters between the JAX package's state and the port's tensors.

The JAX package keeps ``params``, ``bn_state``, a supernet's ``alphas``
and each Adam state's ``m``/``v`` as nested dicts of arrays; callers
hand them over as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, tree)``), so this module never sees a JAX
array.  Keys and layouts carry over one to one, including the
[K, F, D] spliced-weight layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.train.trainer import TrainState


def tree_to_torch(tree, device=DEFAULT_DEVICE):
    """Nested dict of numpy arrays -> same structure of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def tree_to_numpy(tree):
    """Nested dict of tensors -> same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _adam_to_torch(opt_state, device):
    return {"m": tree_to_torch(opt_state["m"], device),
            "v": tree_to_torch(opt_state["v"], device)}


def _adam_to_numpy(opt_state):
    return {"m": tree_to_numpy(opt_state["m"]),
            "v": tree_to_numpy(opt_state["v"])}


def train_state_from_numpy(params, bn_state, opt_state, step: int,
                           device=DEFAULT_DEVICE) -> TrainState:
    """TrainState from the JAX package's (numpy) params, bn_state and Adam
    state ``{"m": ..., "v": ...}``."""
    return TrainState(params=tree_to_torch(params, device),
                      bn_state=tree_to_torch(bn_state, device),
                      opt_state=_adam_to_torch(opt_state, device),
                      step=int(step))


def train_state_to_numpy(state: TrainState):
    """(params, bn_state, {"m", "v"}, step) as numpy, the inverse of
    :func:`train_state_from_numpy`."""
    return (tree_to_numpy(state.params), tree_to_numpy(state.bn_state),
            _adam_to_numpy(state.opt_state), state.step)


def supernet_state_from_numpy(params, alphas, bn_state, opt_state,
                              alpha_opt_state, step: int,
                              device=DEFAULT_DEVICE) -> TrainState:
    """TrainState of a supernet from the JAX package's (numpy) fields, in
    the order of its TrainState: params, alphas, bn_state, the params'
    and the alphas' Adam states ``{"m", "v"}``, step."""
    return dataclasses.replace(
        train_state_from_numpy(params, bn_state, opt_state, step, device),
        alphas=tree_to_torch(alphas, device),
        alpha_opt_state=_adam_to_torch(alpha_opt_state, device))


def supernet_state_to_numpy(state: TrainState):
    """(params, alphas, bn_state, opt_state, alpha_opt_state, step) as
    numpy, the inverse of :func:`supernet_state_from_numpy`."""
    return (tree_to_numpy(state.params), tree_to_numpy(state.alphas),
            tree_to_numpy(state.bn_state), _adam_to_numpy(state.opt_state),
            _adam_to_numpy(state.alpha_opt_state), state.step)


_SUP_ARRAYS = ("trans", "state_pdf", "init", "final", "mask", "next_w")


def map_batch(fn, batch: dict) -> dict:
    """``{"feats", "sup", "ivectors"?}`` with ``fn(key, array)`` applied to
    each array: "feats", "ivectors" and "sup.<field>" for every array of
    the supervision (a None ``next_w`` stays None)."""
    sup = batch["sup"]
    out = {
        "feats": fn("feats", batch["feats"]),
        "sup": dataclasses.replace(sup, **{
            f: fn(f"sup.{f}", getattr(sup, f)) for f in _SUP_ARRAYS
            if getattr(sup, f) is not None}),
    }
    if batch.get("ivectors") is not None:
        out["ivectors"] = fn("ivectors", batch["ivectors"])
    return out


def batch_to_torch(batch: dict, device=DEFAULT_DEVICE):
    """Host numpy batch (``data.egs.batch_iterator``) -> tensors on device."""
    device = resolve_device(device)
    return map_batch(lambda _, a: torch.as_tensor(a).to(device), batch)
