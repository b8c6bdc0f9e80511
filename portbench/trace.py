"""The traced run's profiled window: device kernels from torch.profiler,
the card's busy time and idle share, and the breakdown the result line
carries.

Kernels are sorted into classes by name: the blocked den pair
(``fwd_scan``/``bwd_scan`` of ``csrc/blocked_den.cu``), the dense den pair
(``scan`` of ``csrc/dense_den.cu``), cuBLAS/CUTLASS GEMMs, and the rest.
"""

from __future__ import annotations

import re
import time

import numpy as np

GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce", re.I)
BLOCKED_DEN = re.compile(r"(?<![A-Za-z0-9_])(fwd_scan|bwd_scan)\b")
DENSE_DEN = re.compile(r"(?<![A-Za-z0-9_])scan[<(]")
COPIES = ("Memset", "Memcpy")


def kernel_class(name: str) -> str:
    if BLOCKED_DEN.search(name):
        return "blocked_den"
    if DENSE_DEN.search(name):
        return "dense_den"
    if GEMM.search(name):
        return "gemm"
    return "other"


def busy_and_window(spans):
    """(busy us, window us) of [(start, end)] spans: the union of the spans
    over the window from the first start to the last end (the method of
    ``chip_smoke._idle_share``)."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


def gaps(spans):
    """[(start, end)] of the idle gaps between the union's runs."""
    spans = sorted(spans)
    out, cur_e = [], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            out.append((cur_e, s))
        cur_e = max(cur_e, e)
    return out


def host_ops_at(ops, times):
    """For each time, the name of the innermost host op (name, start, end)
    running then ("host: none" where none is)."""
    if not ops:
        return ["host: none"] * len(times)
    names = [n for n, _, _ in ops]
    s = np.array([a for _, a, _ in ops], np.float64)
    e = np.array([b for _, _, b in ops], np.float64)
    out = []
    for t in times:
        dur = np.where((s <= t) & (t <= e), e - s, np.inf)
        i = int(np.argmin(dur))
        out.append(names[i] if np.isfinite(dur[i]) else "host: none")
    return out


def summarise(kernels, copies, host_ops, steps: int) -> dict:
    """The record a traced run's readers take.  ``kernels`` and ``copies``:
    [(name, start us, end us)] device events; ``host_ops``: the host's
    aten ops the same way."""
    if not kernels:
        return None
    by_class = {}
    for name, s, e in kernels:
        k = kernel_class(name)
        by_class.setdefault(k, []).append(e - s)
    busy, window = busy_and_window([(s, e) for _, s, e in kernels])
    ops = {}
    for name, s, e in kernels + copies:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    idle = {}
    holes = gaps([(s, e) for _, s, e in kernels])
    for (s, e), name in zip(holes, host_ops_at(
            host_ops, [(s + e) / 2 for s, e in holes])):
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv:
                                                -kv[1])[:10]]
    return {"steps": steps, "kernels": len(kernels),
            "class_us": {k: sum(v) for k, v in by_class.items()},
            "class_count": {k: len(v) for k, v in by_class.items()},
            "busy_s": busy / 1e6, "window_s": window / 1e6,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def profile_steps(fn, device, steps: int) -> dict:
    """Run ``fn()`` (``steps`` train steps, returning the state) under
    torch.profiler; the summary of its device events and host ops, with
    the state under "state".  On the CPU there is no device trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {"state": fn(), "summary": None}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = fn()
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    kernels, copies, host = [], [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (copies if e.name.startswith(COPIES) else kernels).append(span)
        elif e.name.startswith("aten::"):
            host.append(span)
    summary = summarise(kernels, copies, host, steps)
    if summary is not None:
        summary["read_s"] = time.perf_counter() - t0
    return {"state": state, "summary": summary}
