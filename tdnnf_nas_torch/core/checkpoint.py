"""Checkpoints of the port's ``TrainState`` in the JAX package's format
(port of ``tdnnf_nas_tpu.core.checkpoint``, `core/checkpoint.py:32-101`
there).

``ckpt_{step:08d}.npz`` holds ``leaf_0 .. leaf_{n-1}`` and
``ckpt_{step:08d}.json`` holds ``step``, ``num_leaves``, ``treedef`` and
``meta``.  The leaves come in the order of the reference's flattened
``TrainState``: params, alphas, bn_state, opt_state, alpha_opt_state,
step (`train/trainer.py:67-72` there), each nested dict in sorted-key
order, and ``step`` a 0-d int32 leaf.  That is not the order in which the
port's dataclass declares its fields, so the two packages load each
other's checkpoints.  Empty dicts add no leaves: a plain model's
``alphas`` and ``alpha_opt_state`` contents, plain SGD's ``{}`` state, and
the per-leaf ``ng`` states of leaves with no preconditioned side.  So the
optimizer state of every kind crosses as it is (``train/optimizer``
builds the reference's structure: adam ``m, v``; sgd ``m`` or nothing;
adafactor ``vc, vr`` or ``v`` per leaf; ng ``cl, cr, pl, pr`` per leaf,
each in sorted-key order), and ``like_state`` must come from an
optimizer of the checkpoint's kind.  ``treedef`` is a description of the
port's own; the reference reads only ``num_leaves`` and the shapes.

A step's random draws are a function of (seed, state.step)
(``train/trainer.make_train_step``), so a checkpoint needs no generator
state to resume exactly.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import List, Optional

import numpy as np
import torch

from tdnnf_nas_torch.train.optimizer import tree_paths
from tdnnf_nas_torch.train.trainer import TrainState

# the reference's leaf order (tdnnf_nas_tpu/train/trainer.py:67-72)
_TREES = ("params", "alphas", "bn_state", "opt_state", "alpha_opt_state")
_NAME = re.compile(r"ckpt_(\d+)\.npz$")


def _leaves(state: TrainState) -> List:
    out = []
    for name in _TREES:
        out.extend(leaf for _, leaf in tree_paths(getattr(state, name)))
    return out + [state.step]


def _treedef(state: TrainState) -> str:
    counts = ", ".join(f"{name}: {len(tree_paths(getattr(state, name)))}"
                       for name in _TREES)
    return f"tdnnf_nas_torch TrainState({counts}, step: 1)"


def _write_atomic(path: str, write) -> None:
    """write(f) into a temporary file beside ``path``, then rename it."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(directory: str, step: int, state: TrainState,
                    meta: Optional[dict] = None, keep: int = 2) -> str:
    """Write ``state`` as checkpoint ``step`` and keep the newest ``keep``
    checkpoints.  The .json is written before the .npz, each under a
    temporary name first, so a listed checkpoint is always complete.
    Returns the path without its extension."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    for i, leaf in enumerate(_leaves(state)):
        if isinstance(leaf, torch.Tensor):
            arrays[f"leaf_{i}"] = leaf.detach().cpu().numpy()
        else:  # the host step counter
            arrays[f"leaf_{i}"] = np.asarray(leaf, np.int32)
    path = os.path.join(directory, f"ckpt_{step:08d}")
    info = {"step": step, "num_leaves": len(arrays),
            "treedef": _treedef(state), "meta": meta or {}}
    _write_atomic(path + ".json",
                  lambda f: f.write(json.dumps(info).encode()))
    _write_atomic(path + ".npz", lambda f: np.savez(f, **arrays))
    _cleanup(directory, keep)
    return path


def _cleanup(directory: str, keep: int) -> None:
    """Keep the newest ``keep`` checkpoints (all of them if ``keep`` <= 0)."""
    steps = sorted(int(m.group(1)) for fn in os.listdir(directory)
                   if (m := _NAME.match(fn)))
    for s in steps[:-keep] if keep > 0 else []:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(directory, f"ckpt_{s:08d}{ext}"))
            except FileNotFoundError:
                pass


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpoint's step in ``directory``, None if it has none."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(directory)
             if (m := _NAME.match(fn))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, like_state: TrainState,
                    step: Optional[int] = None):
    """Load checkpoint ``step`` (the newest if None) into the structure of
    ``like_state``; each tensor goes to the device of its counterpart
    there.  Raises ValueError if the leaf count or a shape differs.
    Returns (state, step, meta)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}")
    with open(path + ".json") as f:
        info = json.load(f)
    like = _leaves(like_state)
    if len(like) != info["num_leaves"]:
        raise ValueError(f"checkpoint has {info['num_leaves']} leaves, "
                         f"expected {len(like)}")
    with np.load(path + ".npz") as data:
        got = [data[f"leaf_{i}"] for i in range(len(like))]
    for i, (a, want) in enumerate(zip(got, like)):
        if tuple(a.shape) != tuple(np.shape(want)):
            raise ValueError(f"leaf {i} shape {a.shape} != expected "
                             f"{tuple(np.shape(want))}")
    arrays = iter(got)
    fields = {name: _fill(getattr(like_state, name), arrays)
              for name in _TREES}
    return (TrainState(step=int(next(arrays)), **fields), info["step"],
            info.get("meta", {}))


def _fill(like, arrays):
    """``like``'s nested dicts (empty ones included) with its tensors
    replaced, in sorted-key order, by the next arrays of ``arrays``."""
    if isinstance(like, dict):
        filled = {k: _fill(like[k], arrays) for k in sorted(like)}
        return {k: filled[k] for k in like}
    return torch.from_numpy(next(arrays)).to(like.device)
