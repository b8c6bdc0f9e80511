"""The blocked den pair's share of its roofline: the least time of the
step's den work (the larger of its operations at the TF32 tensor-core
peak and its bytes at the HBM bandwidth) over the pair's device time."""

from portbench.metrics._classes import den_roofline


def read(rec):
    return den_roofline(rec, "blocked_den")
