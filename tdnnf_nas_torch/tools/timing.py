"""Timing and output helpers shared by the profile and bench tools
(``profile_components``, ``profile_den``, ``bench_triphone_den``,
``bench_sparse_decode``, ``bench_scaling``, ``bench_dense_den``).

A figure is timed in several rounds in one process; each round runs the
function ``n`` times after a warm-up and closes with
``torch.cuda.synchronize()`` on a CUDA device, so a round's mean is the
device's time, not the enqueue's.  A tool writes the median round under
the reference's key and every round under ``rounds``, and prints the
range.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Callable, Optional

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def time_rounds(fn: Callable[[], object], device: torch.device, n: int = 10,
                rounds: int = 3, warmup: int = 2) -> list:
    """ms per call of ``fn()`` in each of ``rounds`` rounds of ``n`` calls,
    after ``warmup`` calls; each round ends in a synchronize."""
    for _ in range(warmup):
        fn()
    sync(device)
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync(device)
        out.append((time.perf_counter() - t0) / n * 1e3)
    return out


class Figures:
    """The figures of one tool run: ``values`` {key: the reference's
    figure}, ``rounds`` {key: ms of each round}; ``timed`` records a
    timing under ``key`` (its median round), prints ``label`` with the
    range and returns the median."""

    def __init__(self, device: torch.device):
        self.device = device
        self.values: dict = {}
        self.rounds: dict = {}

    def timed(self, key: str, label: str, fn: Callable[[], object],
              n: int = 10, rounds: int = 3, warmup: int = 2) -> float:
        ms = time_rounds(fn, self.device, n=n, rounds=rounds, warmup=warmup)
        med = statistics.median(ms)
        self.values[key] = med
        self.rounds[key] = ms
        print(f"{label}: {med:8.3f} ms (rounds {min(ms):.3f}-{max(ms):.3f}, "
              f"{n} calls each)", flush=True)
        return med

    def as_json(self, **extra) -> dict:
        return {**self.values, **extra, "device": device_name(self.device),
                "rounds": self.rounds}


def write_json(out_dir: Optional[str], name: str, obj: dict) -> None:
    """``obj`` as ``out_dir/name`` (nothing without ``out_dir``), and as
    one line on stdout."""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(obj, f, indent=2)
    print(json.dumps(obj), flush=True)
