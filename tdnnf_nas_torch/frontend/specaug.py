"""SpecAugment-style time/frequency masking (port of
``tdnnf_nas_tpu.frontend.specaug``): the reference fork's
`SpecMaskOnlineComponent` (`nnet-simple-component.h:3244`, on-the-fly
freq/time masking inside the network) as a transform on feature batches.

The draws (``spec_augment_draws``: mask widths, then starts, for
frequency, then time, from four generator calls) are apart from the
masking, so a caller can pass in its own (the parity tests pass the JAX
package's ``randint`` draws).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tdnnf_nas_torch.core.config import Config


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig(Config):
    num_freq_masks: int = 2
    freq_mask_width: int = 8  # max bins per mask
    num_time_masks: int = 2
    time_mask_width: int = 20  # max frames per mask
    mask_value: float = 0.0


def _randint_below(hi: torch.Tensor, generator) -> torch.Tensor:
    """Per element uniform integers in [0, hi)."""
    u = torch.rand(hi.shape, generator=generator, device=hi.device)
    return torch.minimum((u * hi).to(torch.int64), hi - 1)


def spec_augment_draws(b: int, t: int, f: int, cfg: SpecAugmentConfig,
                       generator: torch.Generator
                       ) -> Tuple[torch.Tensor, ...]:
    """(freq widths, freq starts, time widths, time starts), [B, M] each
    on the generator's device: widths uniform in [0, max width], starts
    uniform in [0, max(size - width, 1))."""
    dev = generator.device
    fw = torch.randint(0, cfg.freq_mask_width + 1, (b, cfg.num_freq_masks),
                       generator=generator, device=dev)
    fs = _randint_below(torch.clamp(f - fw, min=1), generator)
    tw = torch.randint(0, cfg.time_mask_width + 1, (b, cfg.num_time_masks),
                       generator=generator, device=dev)
    ts = _randint_below(torch.clamp(t - tw, min=1), generator)
    return fw, fs, tw, ts


def _band_keep(starts, widths, size):
    """[B, M] starts/widths -> [B, size] keep-mask (outside every band)."""
    idx = torch.arange(size, device=starts.device)[None, None, :]
    inside = ((idx >= starts[..., None])
              & (idx < (starts + widths)[..., None]))
    return ~torch.any(inside, dim=1)


def spec_augment(feats: torch.Tensor, cfg: SpecAugmentConfig,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Tuple[torch.Tensor, ...]] = None
                 ) -> torch.Tensor:
    """[B, T, F] -> masked copy; masks drawn independently per sequence
    from ``generator`` (or the given ``draws``, as
    :func:`spec_augment_draws` returns them)."""
    b, t, f = feats.shape
    if draws is None:
        if generator is None:
            raise ValueError("spec_augment needs a generator or its draws")
        draws = spec_augment_draws(b, t, f, cfg, generator)
    fw, fs, tw, ts = (d.to(feats.device) for d in draws)
    keep = (_band_keep(ts, tw, t)[:, :, None]
            & _band_keep(fs, fw, f)[:, None, :])
    return torch.where(keep, feats, torch.full((), cfg.mask_value,
                                               dtype=feats.dtype,
                                               device=feats.device))
