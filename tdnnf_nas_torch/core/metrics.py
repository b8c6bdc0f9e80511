"""Metrics logging (port of ``tdnnf_nas_tpu.core.metrics``).

A structured in-process recorder of scalar series keyed by name, with
JSONL persistence and a progress report, in place of the reference's
per-iteration compute_prob logs, `accuracy.report` and the `log_alpha`
print.  ``log()`` is deferred: values may be live device tensors and are
not converted until ``flush()`` (every ``flush_every`` records, or on
``last()``/``report()``/``series``/``close()``), so the train loop never
waits for the device per step.  At flush each series of tensors is
stacked on its device and fetched once.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _materialize(vals) -> np.ndarray:
    """A list of scalars (device tensors or host numbers) as one float64
    array, with one device-to-host copy for a series of tensors."""
    if isinstance(vals[0], torch.Tensor):
        stacked = torch.stack([v.detach().reshape(()).float() for v in vals])
        return stacked.cpu().numpy().astype(np.float64)
    return np.asarray([float(v) for v in vals], np.float64)


class MetricsLogger:
    def __init__(self, log_path: Optional[str] = None,
                 flush_every: int = 256):
        self._series = defaultdict(list)
        self.log_path = log_path
        self.flush_every = flush_every
        self._pending: List[Tuple[int, float, Dict[str, object]]] = []
        self._fh = None
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            self._fh = open(log_path, "a")

    @property
    def series(self):
        """{name: [(step, value)]}; flushes pending records first."""
        self.flush()
        return self._series

    def log(self, step: int, metrics: Dict[str, object]) -> None:
        """Record a step's metrics without synchronizing the device."""
        self._pending.append((int(step), time.time(), dict(metrics)))
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        pend, self._pending = self._pending, []
        if not pend:
            return
        cols: Dict[str, List] = defaultdict(list)
        idx: Dict[str, List[int]] = defaultdict(list)
        for j, (_, _, m) in enumerate(pend):
            for k, v in m.items():
                cols[k].append(v)
                idx[k].append(j)
        vals = {k: _materialize(v) for k, v in cols.items()}
        recs = [{"step": s, "time": t} for s, t, _ in pend]
        for k, js in idx.items():
            for pos, j in enumerate(js):
                v = float(vals[k][pos])
                recs[j][k] = v
                self._series[k].append((pend[j][0], v))
        if self._fh:
            for rec in recs:
                self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def last(self, name: str) -> Optional[float]:
        self.flush()
        s = self._series.get(name)
        return s[-1][1] if s else None

    def report(self) -> str:
        """accuracy.report-style summary (`train.py:617-624`)."""
        self.flush()
        lines = []
        for name, s in sorted(self._series.items()):
            vals = [v for _, v in s]
            lines.append(f"{name}: first={vals[0]:.4f} last={vals[-1]:.4f} "
                         f"best={max(vals):.4f} n={len(vals)}")
        return "\n".join(lines)

    def close(self):
        self.flush()
        if self._fh:
            self._fh.close()
            self._fh = None
