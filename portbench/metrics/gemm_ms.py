"""Device milliseconds a step spends in GEMM kernels (cuBLAS, CUTLASS),
from the profiled steps' trace."""

from portbench.metrics._classes import per_step_ms


def read(rec):
    return per_step_ms(rec, "gemm")
