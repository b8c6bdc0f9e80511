"""3-way speed perturbation (0.9 / 1.0 / 1.1) (port of
``tdnnf_nas_tpu.frontend.speed_perturb``).

The reference's `utils/data/perturb_data_dir_speed_3way.sh` step
(`Prepare_NAS_data.sh:10-30`) resamples audio with sox; here the resample
is a linear-interpolation gather on the device.  ``speed_perturb`` is the
reference's per-waveform function; ``speed_perturb_batch`` does a padded
batch of waveforms of different lengths in one pass, each row as
``speed_perturb`` would.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def speed_perturb(wav: torch.Tensor, factor: float,
                  out_len: int) -> torch.Tensor:
    """Resample [..., N] waveform by `factor` (playback speed).

    factor=0.9 -> slower/longer, 1.1 -> faster/shorter (as sox `speed`).
    out_len is the output length (callers take perturbed_length).  Linear
    interpolation, positions in float32 as in the reference.
    """
    n = wav.shape[-1]
    pos = torch.arange(out_len, dtype=torch.float32,
                       device=wav.device) * factor
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = pos - lo.to(torch.float32)
    out = wav[..., lo] * (1.0 - frac) + wav[..., hi] * frac
    valid = (pos <= (n - 1)).to(wav.dtype)
    return out * valid


def perturbed_length(n: int, factor: float) -> int:
    return int(np.floor(n / factor))


def speed_perturb_batch(wavs: torch.Tensor, lengths: Sequence[int],
                        factor: float) -> Tuple[torch.Tensor, list]:
    """A zero-padded batch [B, N_max] of waveforms of ``lengths`` ->
    (perturbed batch [B, max out_len], out lengths), zero-padded: row i
    is ``speed_perturb(wavs[i, :lengths[i]], factor,
    perturbed_length(lengths[i], factor))``."""
    out_lens = [perturbed_length(int(n), factor) for n in lengths]
    out_max = max(out_lens)
    dev = wavs.device
    n = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)[:, None]
    pos = torch.arange(out_max, dtype=torch.float32, device=dev) * factor
    lo = torch.minimum(torch.floor(pos).to(torch.int64)[None, :], n - 1)
    lo = torch.clamp(lo, min=0)
    hi = torch.minimum(lo + 1, n - 1)
    frac = pos[None, :] - lo.to(torch.float32)
    out = (torch.gather(wavs, 1, lo) * (1.0 - frac)
           + torch.gather(wavs, 1, hi) * frac)
    keep = (pos[None, :] <= (n - 1)) & (
        torch.arange(out_max, device=dev)[None, :]
        < torch.as_tensor(out_lens, device=dev)[:, None])
    return out * keep.to(wavs.dtype), out_lens
