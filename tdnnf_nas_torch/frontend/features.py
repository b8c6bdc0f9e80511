"""Feature front end (port of ``tdnnf_nas_tpu.frontend.features``):
Kaldi-compatible log-mel filterbank (fbank) and MFCC, CMVN and sliding
CMN.

The reference's feature extraction (`steps/make_fbank_40.sh` over
``compute-fbank-feats`` with `conf/fbank_40.conf`: 8 kHz, 40 mel bins,
hamming window, 64-3800 Hz, dither; and `conf/mfcc_hires.conf`: 40-dim
high-res MFCC).  A whole batch of utterances is a few tensor ops on the
device: framing is a strided view (``unfold``, the snip-edges frames
without a gather), the spectrum ``torch.fft.rfft`` (cuFFT on the card;
the reference's is XLA's rfft, no Pallas kernel), the mel projection and
the DCT one matmul each.  The tables (mel bank, window, DCT, lifter) are
built once per config in numpy, as the reference builds them.

Pipeline per frame (Kaldi's compute-fbank-feats defaults):
  dither -> remove DC -> (optional raw-energy) -> preemphasis -> window
  -> pad to FFT size -> |rfft|^2 -> mel filterbank -> log.

Dither noise is drawn per frame over the frames' shape, so overlapping
frames get independent noise, as in the reference; it comes from a
``torch.Generator`` or is passed in (``noise``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from tdnnf_nas_torch.core.config import Config


@dataclasses.dataclass(frozen=True)
class FbankConfig(Config):
    """Matches `conf/fbank_40.conf` defaults (reference
    `conf/fbank_40.conf:1-8`)."""

    sample_freq: int = 8000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 40
    low_freq: float = 64.0
    high_freq: float = 3800.0  # absolute; <=0 means offset from Nyquist
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "hamming"  # hamming | povey | hanning | rectangular
    round_to_power_of_two: bool = True
    use_log_fbank: bool = True
    use_energy: bool = False
    energy_floor: float = 0.0
    snip_edges: bool = True

    @property
    def frame_length(self) -> int:
        return int(self.sample_freq * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_freq * self.frame_shift_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        n = self.frame_length
        if self.round_to_power_of_two:
            return 1 << (n - 1).bit_length()
        return n


@dataclasses.dataclass(frozen=True)
class MfccConfig(FbankConfig):
    """Matches `conf/mfcc_hires.conf` (8 kHz, 40 bins, 40 cepstra,
    40-3800 Hz)."""

    num_ceps: int = 40
    num_mel_bins: int = 40
    low_freq: float = 40.0
    high_freq: float = -200.0
    cepstral_lifter: float = 22.0
    use_energy: bool = False


@dataclasses.dataclass(frozen=True)
class FrontendConfig(Config):
    fbank: FbankConfig = dataclasses.field(default_factory=FbankConfig)
    cmvn: str = "utterance"  # none | utterance | sliding
    cmvn_window: int = 600
    norm_vars: bool = False


def num_frames(num_samples: int, cfg: FbankConfig) -> int:
    """Number of frames for snip-edges=true framing."""
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def _mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq) / 700.0)


def mel_filterbank(cfg: FbankConfig) -> np.ndarray:
    """[num_mel_bins, fft_size//2+1] triangular mel weights, Kaldi-style.

    Bin m has a triangle between mel centers m-1 .. m+1 over the
    mel-warped FFT bin frequencies; low/high cutoffs per config (high<=0
    is Nyquist+high, as in Kaldi and `conf/mfcc_hires.conf:8`).
    """
    nyquist = cfg.sample_freq / 2.0
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    low = cfg.low_freq
    if not (0 <= low < high <= nyquist):
        raise ValueError(f"bad mel range [{low}, {high}] for nyquist "
                         f"{nyquist}")
    nfft = cfg.fft_size
    nbins = nfft // 2 + 1
    mel_low, mel_high = _mel_scale(low), _mel_scale(high)
    # M+2 edge points -> M triangles
    edges = np.linspace(mel_low, mel_high, cfg.num_mel_bins + 2)
    fft_freqs = np.arange(nbins) * (cfg.sample_freq / nfft)
    mel_freqs = _mel_scale(fft_freqs)
    weights = np.zeros((cfg.num_mel_bins, nbins), dtype=np.float32)
    for m in range(cfg.num_mel_bins):
        left, center, right = edges[m], edges[m + 1], edges[m + 2]
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        weights[m] = np.maximum(0.0, np.minimum(up, down))
    return weights


def _window(cfg: FbankConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n)
    if cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {cfg.window_type}")
    return w.astype(np.float32)


def _dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """DCT-II with orthonormal scaling, rows = cepstra (Kaldi
    ComputeDctMatrix)."""
    m = np.zeros((num_ceps, num_bins), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / num_bins)
    for k in range(1, num_ceps):
        m[k, :] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi / num_bins * (np.arange(num_bins) + 0.5) * k)
    return m.astype(np.float32)


def _lifter_coeffs(q: float, num_ceps: int) -> np.ndarray:
    i = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _host_tables(cfg: FbankConfig):
    """The config's numpy tables, built once: window, mel bank^T and, for
    MFCC, DCT^T and the lifter (None where the config has none)."""
    dct = lifter = None
    if isinstance(cfg, MfccConfig):
        dct = _dct_matrix(cfg.num_ceps, cfg.num_mel_bins).T.copy()
        if cfg.cepstral_lifter > 0:
            lifter = _lifter_coeffs(cfg.cepstral_lifter, cfg.num_ceps)
    return _window(cfg), mel_filterbank(cfg).T.copy(), dct, lifter


def _tables(cfg: FbankConfig, device):
    return tuple(None if a is None else torch.as_tensor(a, device=device)
                 for a in _host_tables(cfg))


def frame_signal(wav: torch.Tensor, cfg: FbankConfig,
                 n_frames: int) -> torch.Tensor:
    """[..., N] samples -> [..., n_frames, frame_length] (snip-edges
    framing), a strided view of ``wav``."""
    frames = wav.unfold(-1, cfg.frame_length, cfg.frame_shift)
    if frames.shape[-2] < n_frames:
        raise ValueError(f"{wav.shape[-1]} samples hold "
                         f"{frames.shape[-2]} frames, not {n_frames}")
    return frames[..., :n_frames, :]


def _power_spectrum(frames: torch.Tensor, cfg: FbankConfig, window,
                    generator: Optional[torch.Generator],
                    noise: Optional[torch.Tensor]):
    """Shared fbank/mfcc front: (power_spec [..., T, nfft//2+1],
    log_energy [..., T])."""
    frames = frames.float()
    if cfg.dither > 0.0 and (noise is not None or generator is not None):
        if noise is None:
            noise = torch.randn(frames.shape, generator=generator,
                                device=frames.device)
        frames = frames + cfg.dither * noise
    if cfg.remove_dc_offset:
        frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    log_energy = torch.log(torch.clamp(torch.sum(frames * frames, dim=-1),
                                       min=1e-15))
    if cfg.preemph_coeff > 0.0:
        first = frames[..., :1] * (1.0 - cfg.preemph_coeff)
        rest = frames[..., 1:] - cfg.preemph_coeff * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    spec = torch.fft.rfft(frames * window, n=cfg.fft_size, dim=-1)
    return spec.real ** 2 + spec.imag ** 2, log_energy


def compute_fbank(wav: torch.Tensor, cfg: FbankConfig, n_frames: int,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Log-mel filterbank features on ``wav``'s device.

    wav: [..., N] waveform (any float/int scale; Kaldi uses int16 range);
    n_frames: frame count (see num_frames); ``generator`` draws the
    dither noise, or ``noise`` [..., n_frames, frame_length] is it; with
    neither there is no dither (deterministic eval).

    Returns [..., n_frames, num_mel_bins] float32 (+1 leading column of
    log-energy if cfg.use_energy, as Kaldi does).
    """
    window, mel_t, _, _ = _tables(cfg, wav.device)
    power, log_energy = _power_spectrum(frame_signal(wav, cfg, n_frames),
                                        cfg, window, generator, noise)
    feats = power @ mel_t
    if cfg.use_log_fbank:
        feats = torch.log(torch.clamp(feats, min=1e-15))
    if cfg.use_energy:
        feats = torch.cat([log_energy[..., None], feats], dim=-1)
    return feats


def compute_mfcc(wav: torch.Tensor, cfg: MfccConfig, n_frames: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """High-resolution MFCC (`conf/mfcc_hires.conf`): log-mel -> DCT ->
    lifter; arguments as :func:`compute_fbank`."""
    window, mel_t, dct_t, lifter = _tables(cfg, wav.device)
    power, log_energy = _power_spectrum(frame_signal(wav, cfg, n_frames),
                                        cfg, window, generator, noise)
    logmel = torch.log(torch.clamp(power @ mel_t, min=1e-15))
    ceps = logmel @ dct_t
    if lifter is not None:
        ceps = ceps * lifter
    if cfg.use_energy:
        ceps = torch.cat([log_energy[..., None], ceps[..., 1:]], dim=-1)
    return ceps


def cmvn(feats: torch.Tensor, norm_vars: bool = False,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-utterance cepstral mean (and optional variance) normalization;
    mask: optional [..., T] validity mask for padded frames."""
    if mask is None:
        mean = torch.mean(feats, dim=-2, keepdim=True)
        var = torch.mean(feats ** 2, dim=-2, keepdim=True) - mean ** 2
    else:
        m = mask[..., None].to(feats.dtype)
        denom = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
        mean = torch.sum(feats * m, dim=-2, keepdim=True) / denom
        var = (torch.sum(feats ** 2 * m, dim=-2, keepdim=True) / denom
               - mean ** 2)
    out = feats - mean
    if norm_vars:
        out = out * torch.rsqrt(torch.clamp(var, min=1e-10))
    return out


def sliding_cmn(feats: torch.Tensor, window: int = 600,
                center: bool = True) -> torch.Tensor:
    """Sliding-window cepstral mean normalization (apply-cmvn-sliding
    equivalent), by cumulative sums: O(T).  feats: [..., T, D]."""
    t = feats.shape[-2]
    cs = torch.cumsum(feats, dim=-2)
    cs = torch.cat([torch.zeros_like(cs[..., :1, :]), cs], dim=-2)
    idx = np.arange(t)
    if center:
        lo = np.maximum(idx - window // 2, 0)
        hi = np.minimum(idx + (window + 1) // 2, t)
        # widen truncated edge windows to min(window, t) frames, like Kaldi
        lo = np.minimum(lo, np.maximum(hi - window, 0))
        hi = np.maximum(hi, np.minimum(lo + window, t))
    else:
        lo = np.maximum(idx + 1 - window, 0)
        hi = idx + 1
    count = torch.as_tensor((hi - lo).astype(np.float32)[:, None],
                            device=feats.device)
    lo_t = torch.as_tensor(lo, device=feats.device)
    hi_t = torch.as_tensor(hi, device=feats.device)
    mean = (cs[..., hi_t, :] - cs[..., lo_t, :]) / count
    return feats - mean
