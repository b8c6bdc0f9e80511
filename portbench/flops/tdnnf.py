"""Operations a TDNN-F training step requires, counted from the
configuration and the cell's shapes alone.

Each layer is a GEMM of 2*M*K*N operations (M = batch x frames the layer
computes, K x N its weight, the K offsets of a spliced layer stacked
into K); the backward pass takes the same again for the weight's
gradient and for the input's, except at the first layer, whose input
(the features) needs no gradient.  Frames follow the network's valid
convolutions: each spliced layer computes the frames its output needs,
and layers from the first one whose later strides are all multiples of
the frame-subsampling factor run at the subsampled rate.  Elementwise
work, batchnorm and the optimizer are not counted.
"""

from __future__ import annotations


def input_frames(m: dict, width: int, context: int) -> int:
    return 2 * context + (width - 1) * m["frame_subsampling_factor"] + 1


def head_gemms(m: dict, rows: int):
    h, big, small = m["hidden_dim"], m["prefinal_big"], m["prefinal_small"]
    out = [(rows, h, small)]
    for _ in ("chain", "xent"):
        out += [(rows, small, big), (rows, big, small),
                (rows, small, m["num_pdfs"])]
    return out


def input_gemms(m: dict, batch: int, t_in: int):
    """(first layer's GEMM, tdnn1's GEMM, frames after them)."""
    t = t_in - 2
    lda = 3 * m["feat_dim"] + m["ivector_dim"]
    return (batch * t, lda, lda), (batch * t, lda, m["hidden_dim"]), t


def forward_gemms(m: dict, batch: int, width: int):
    """[(M, K, N)] of the forward pass, the first layer first."""
    fs = m["frame_subsampling_factor"]
    strides = list(m["time_strides"])
    h, bd = m["hidden_dim"], m["bottleneck_dim"]
    t_in = input_frames(m, width, 1 + sum(strides))
    first, tdnn1, t = input_gemms(m, batch, t_in)
    out = [first, tdnn1]
    sub_at = len(strides)
    while sub_at > 0 and strides[sub_at - 1] % fs == 0:
        sub_at -= 1
    pos, rate, left_total = 1, 1, 1 + sum(strides)
    for i, s in enumerate(strides):
        if i == sub_at and fs > 1:
            t = len(range((left_total - pos) % fs, t, fs))
            rate = fs
        q = s // rate
        k = 2 if q else 1
        out += [(batch * (t - q), k * h, bd), (batch * (t - 2 * q), k * bd, h)]
        t -= 2 * q
        pos += s
    if rate == 1 and fs > 1:
        t = len(range(0, t, fs))
    if t != width:
        raise ValueError(f"{t} output frames, expected {width}")
    return out + head_gemms(m, batch * width)


def train_flops(m: dict, batch: int, width: int) -> float:
    g = forward_gemms(m, batch, width)
    fwd = sum(2.0 * a * b * c for a, b, c in g)
    first = 2.0 * g[0][0] * g[0][1] * g[0][2]
    return 3.0 * fwd - first
