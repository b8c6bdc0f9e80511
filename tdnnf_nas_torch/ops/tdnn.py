"""Time-delay (spliced) linear ops (port of ``tdnnf_nas_tpu.ops.tdnn``).

y[t] = sum_k x[t + offset_k] @ W_k + b, one GEMM per offset on a
contiguous time slice of x (no concatenated copy), summed on the output.
Valid-convolution semantics: each layer shrinks time by the offset span.
The products go to ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def splice(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """[B, T, F] -> [B, T - span, K*F] by stacking shifted slices
    (offsets sorted ascending; output frame t is input frame
    t - offsets[0])."""
    offsets = tuple(offsets)
    span = offsets[-1] - offsets[0]
    t_out = x.shape[1] - span
    if t_out <= 0:
        raise ValueError(
            f"time dim {x.shape[1]} too short for offsets {offsets}")
    return torch.cat([x[:, o - offsets[0]: o - offsets[0] + t_out]
                      for o in offsets], dim=-1)


def spliced_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    offsets: Sequence[int],
    bias: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Spliced (time-delay) linear layer.

    x: [B, T, F]; w: [K, F, D] per-offset weights (K = len(offsets));
    bias: optional [D].  Products run in ``compute_dtype``; the per-offset
    results are summed in float32.  Returns [B, T - span, D] float32.
    """
    offsets = tuple(offsets)
    k = w.shape[0]
    if k != len(offsets):
        raise ValueError(f"weight {tuple(w.shape)} vs offsets {offsets}")
    t_out = x.shape[1] - (offsets[-1] - offsets[0])
    xc = x.to(compute_dtype)
    wc = w.to(compute_dtype)
    out = None
    for i, o in enumerate(offsets):
        part = xc[:, o - offsets[0]: o - offsets[0] + t_out]
        y = torch.matmul(part, wc[i]).float()
        out = y if out is None else out + y
    if bias is not None:
        out = out + bias.float()
    return out
