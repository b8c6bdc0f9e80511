"""Median step time of the steps that apply the semi-orthogonal
constraint less the median of the others, from the window's step-end
events."""

import statistics


def read(rec):
    n = rec["semiorth_interval"]
    if n <= 0:
        return None
    on = [t for k, t in zip(rec["step_index"], rec["step_ms"]) if k % n == 0]
    off = [t for k, t in zip(rec["step_index"], rec["step_ms"]) if k % n]
    if not on or not off:
        return None
    return statistics.median(on) - statistics.median(off)
