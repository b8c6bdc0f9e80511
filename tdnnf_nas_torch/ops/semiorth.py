"""Semi-orthogonal constraint (port of ``tdnnf_nas_tpu.ops.semiorth``).

Kaldi's ``ConstrainOrthonormal`` (`src/nnet3/nnet-utils.cc:914-1077`):
nudge the constrained weight toward M M^T = scale^2 I via

    M <- M - 4 * speed * (1/scale^2) * (M M^T - scale^2 I) M

with the floating scale (orthonormal_constraint < 0) choosing
scale^2 = tr((MM^T)^2)/tr(MM^T) and slowing down when far from
orthonormal.  Everything stays on the device (no host sync).
"""

from __future__ import annotations

import torch


def semi_orthogonal_step(w: torch.Tensor, scale: float = -1.0) -> torch.Tensor:
    """One constraint update on a 2-D weight w [in, out] (y = x @ w); the
    constrained matrix M is w^T or w, whichever has rows <= cols."""
    if w.ndim != 2:
        raise ValueError(f"expected a 2-D weight, got {tuple(w.shape)}")
    transposed = w.shape[0] >= w.shape[1]
    m = (w.T if transposed else w).float()
    p = m @ m.T
    rows = p.shape[0]
    trace_p = torch.trace(p)
    trace_p_p = torch.sum(p * p)
    if scale < 0.0:
        scale2 = trace_p_p / trace_p
        ratio = trace_p_p * rows / (trace_p * trace_p)
        speed = torch.where(
            ratio > 1.1, 0.125 * 0.125,
            torch.where(ratio > 1.02, 0.5 * 0.125, 0.125))
    else:
        scale2 = torch.tensor(scale * scale, device=w.device)
        speed = torch.tensor(0.125, device=w.device)
    eye = torch.eye(rows, dtype=torch.float32, device=w.device)
    p_minus = p - scale2 * eye
    m_new = m - (4.0 * speed / scale2) * (p_minus @ m)
    return (m_new.T if transposed else m_new).to(w.dtype)


def semi_orthogonal_step_3d(w: torch.Tensor, scale: float = -1.0) -> torch.Tensor:
    """Apply to a [K, F, D] spliced weight treated as one [K*F, D] matrix."""
    k, f, d = w.shape
    return semi_orthogonal_step(w.reshape(k * f, d), scale).reshape(k, f, d)


def orthonormality_error(w: torch.Tensor) -> torch.Tensor:
    """||M M^T / scale^2 - I||_F / rows diagnostic (floating scale)."""
    m = (w.T if w.shape[0] >= w.shape[1] else w).float()
    p = m @ m.T
    scale2 = torch.sum(p * p) / torch.trace(p)
    eye = torch.eye(p.shape[0], dtype=torch.float32, device=w.device)
    return torch.sqrt(torch.mean((p / scale2 - eye) ** 2))
