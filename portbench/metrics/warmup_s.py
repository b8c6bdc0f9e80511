"""Seconds from the end of the host set-up to the end of the warm-up:
kernel build or load, weights, batches to the card, and the first steps,
from the harness's span."""


def read(rec):
    return rec["spans"].get("warmup_s")
