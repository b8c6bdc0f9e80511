"""Operations a step of the context-offset supernet's stage A requires.

Under uniform one-hot sampling a TDNN-F sublayer needs its share branch
and the sampled one, which is the share branch itself once in K draws:
1 + (K-1)/K branch products on average, each of 2*M*F*D operations, with
M = batch x the frames that sublayer computes (every layer runs at the
full rate; each sublayer's K offsets span K-1 frames).  The other
branches carry a zero coefficient and are not required.  Forward and
backward as in ``flops.tdnnf``.  ``branches=K`` counts what a program that
computes every branch launches (the cross-check against a GEMM count).
"""

from __future__ import annotations

from portbench.flops.tdnnf import head_gemms, input_frames, input_gemms


def forward_flops(m: dict, batch: int, width: int, branches=None):
    """(forward operations, the first layer's)."""
    k = m["max_stride"] + 1
    live = 1 + (k - 1) / k if branches is None else branches
    layers = len(m["time_strides"])
    h, bd, fs = m["hidden_dim"], m["bottleneck_dim"], m["frame_subsampling_factor"]
    t_in = input_frames(m, width, 1 + (k - 1) * layers)
    first, tdnn1, t = input_gemms(m, batch, t_in)
    fl = lambda g: 2.0 * g[0] * g[1] * g[2]
    total = fl(first) + fl(tdnn1)
    for _ in range(layers):
        t_b = t - (k - 1)
        t = t_b - (k - 1)
        total += live * (fl((batch * t_b, h, bd)) + fl((batch * t, bd, h)))
    if len(range(0, t, fs)) != width:
        raise ValueError(f"{len(range(0, t, fs))} output frames, "
                         f"expected {width}")
    total += sum(fl(g) for g in head_gemms(m, batch * width))
    return total, fl(first)


def train_flops(m: dict, batch: int, width: int, branches=None) -> float:
    fwd, first = forward_flops(m, batch, width, branches)
    return 3.0 * fwd - first
