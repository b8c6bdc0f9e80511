"""Device milliseconds a step spends in kernels that are neither GEMMs
nor the den pair: elementwise passes, reductions, the numerator, Adam."""

from portbench.metrics._classes import per_step_ms


def read(rec):
    return per_step_ms(rec, "other")
