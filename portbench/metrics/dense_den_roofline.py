"""The dense den pair's share of its roofline, as for the blocked pair."""

from portbench.metrics._classes import den_roofline


def read(rec):
    return den_roofline(rec, "dense_den")
