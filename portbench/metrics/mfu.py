"""The step's share of the card's bf16 dense peak: the operations the
configuration requires a step (``portbench/flops``: the model's GEMMs
forward and backward and the den's least operations) over the window's
mean step time, outside the profiled steps."""

from portbench.peaks import H100_SXM


def read(rec):
    if not rec["steps"]:
        return None
    ops = rec["flops"]["model"] + rec["flops"]["den_ops"]
    step_s = rec["window_s"] / rec["steps"]
    return 100.0 * ops / (step_s * H100_SXM["bf16_flops"])
