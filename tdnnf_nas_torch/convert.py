"""Converters between the JAX package's state and the port's tensors.

The JAX package keeps ``params``, ``bn_state``, a supernet's ``alphas``
and each optimizer state (of any kind), the RNNLM's parameters and the LHUC
logits as nested dicts of arrays, and the GMM ladder's models as numpy
arrays; callers
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


def tree_to_device(tree, device):
    """Nested dict of tensors -> the same on ``device`` (no copy of a
    tensor already there)."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def tree_to_numpy(tree):
    """Nested dict of tensors -> same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def opt_state_from_numpy(opt_state, device=DEFAULT_DEVICE):
    """The JAX package's optimizer state of any kind, as numpy -> the same
    nested dicts of tensors on ``device`` (``train/optimizer``'s layout):
    adam ``{"m", "v"}``, sgd ``{}`` or ``{"m"}``, adafactor ``{"f"}``, ng
    ``{"ng"}`` whose per-leaf dicts may be empty (kept empty)."""
    return tree_to_torch(opt_state, device)


def opt_state_to_numpy(opt_state):
    """Inverse of :func:`opt_state_from_numpy`."""
    return tree_to_numpy(opt_state)


def train_state_from_numpy(params, bn_state, opt_state, step: int,
                           device=DEFAULT_DEVICE) -> TrainState:
    """TrainState from the JAX package's (numpy) params, bn_state and
    optimizer state of any kind (:func:`opt_state_from_numpy`)."""
    return TrainState(params=tree_to_torch(params, device),
                      bn_state=tree_to_torch(bn_state, device),
                      opt_state=opt_state_from_numpy(opt_state, device),
                      step=int(step))


def train_state_to_numpy(state: TrainState):
    """(params, bn_state, opt_state, step) as numpy, the inverse of
    :func:`train_state_from_numpy`."""
    return (tree_to_numpy(state.params), tree_to_numpy(state.bn_state),
            opt_state_to_numpy(state.opt_state), state.step)


def supernet_state_from_numpy(params, alphas, bn_state, opt_state,
                              alpha_opt_state, step: int,
                              device=DEFAULT_DEVICE) -> TrainState:
    """TrainState of a supernet from the JAX package's (numpy) fields, in
    the order of its TrainState: params, alphas, bn_state, the params'
    and the alphas' optimizer states (any kind), step."""
    return dataclasses.replace(
        train_state_from_numpy(params, bn_state, opt_state, step, device),
        alphas=tree_to_torch(alphas, device),
        alpha_opt_state=opt_state_from_numpy(alpha_opt_state, device))


def supernet_state_to_numpy(state: TrainState):
    """(params, alphas, bn_state, opt_state, alpha_opt_state, step) as
    numpy, the inverse of :func:`supernet_state_from_numpy`."""
    return (tree_to_numpy(state.params), tree_to_numpy(state.alphas),
            tree_to_numpy(state.bn_state),
            opt_state_to_numpy(state.opt_state),
            opt_state_to_numpy(state.alpha_opt_state), state.step)


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


def rnnlm_params_from_numpy(params, device=DEFAULT_DEVICE):
    """The JAX package's RNNLM parameters as numpy (``init_rnnlm`` /
    ``train_rnnlm``: embed, lstm.{wx, wh, b} and the optional lstm.wp,
    out.{w, b}, and the optional tdnn.{w, b}) -> the same dict of
    float32 tensors on ``device`` (``lm/rnnlm``'s layout)."""
    return tree_to_torch(params, device)


def rnnlm_params_to_numpy(params):
    """Inverse of :func:`rnnlm_params_from_numpy`."""
    return tree_to_numpy(params)


def lhuc_from_numpy(lhuc, device=DEFAULT_DEVICE):
    """The JAX package's LHUC logits ``{layer: [hidden]}`` as numpy ->
    float32 tensors on ``device`` (``models/lhuc``)."""
    return tree_to_torch(lhuc, device)


def lhuc_to_numpy(lhuc):
    """Inverse of :func:`lhuc_from_numpy`."""
    return tree_to_numpy(lhuc)


def am_gmm_from_jax(am, device=DEFAULT_DEVICE):
    """The JAX package's ``gmm.AmGmm`` (per-state numpy GMMs) as the
    port's ``gmm.AmGmm`` (padded float64 tensors on ``device``)."""
    from tdnnf_nas_torch.gmm.gmm import AmGmm

    dev = resolve_device(device)
    return AmGmm.from_gmms(
        am.gmms, am.num_phones, am.states_per_phone, am.self_loop_prob,
        tie_table=(None if am.tie_table is None
                   else np.asarray(am.tie_table, np.int64)),
        device=dev)


def ladder_result_from_jax(res, device=DEFAULT_DEVICE):
    """The JAX package's ``gmm.GmmLadderResult`` as the port's: the model
    on ``device``, the transforms and alignments copied as they are."""
    from tdnnf_nas_torch.gmm.ladder import GmmLadderResult

    dev = resolve_device(device)
    return GmmLadderResult(
        am=am_gmm_from_jax(res.am, dev),
        transform=np.array(res.transform, np.float64),
        fmllr={k: np.array(v, np.float64) for k, v in res.fmllr.items()},
        begins=[list(b) for b in res.begins],
        ends=[list(e) for e in res.ends],
        mono_ll=list(res.mono_ll), mllt_aux=list(res.mllt_aux),
        fmllr_gain=float(res.fmllr_gain))
