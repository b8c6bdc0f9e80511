"""Real-audio ingestion: wav files -> batched features on the card (port
of ``tdnnf_nas_tpu.data.audio``).

The entry point for real corpora (Switchboard-style): reads PCM wav
(stdlib ``wave``), pads a batch of utterances to one length and runs the
fbank/MFCC pipeline, with optional speed perturbation and masked CMVN,
on the device: the role of the reference's `steps/make_fbank_40.sh` /
``compute-fbank-feats`` per-utterance C++ jobs.  The JAX package
speed-perturbs each utterance on its own on the host
(`data/audio.py:61-67` there); here one batched resample does the whole
padded batch (``frontend.speed_perturb.speed_perturb_batch``), with the
same lengths, frame counts and features.
"""

from __future__ import annotations

import wave
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.frontend.features import (FbankConfig, cmvn,
                                               compute_fbank, compute_mfcc,
                                               num_frames)
from tdnnf_nas_torch.frontend.speed_perturb import speed_perturb_batch


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM wav file -> (float32 samples in int16 range,
    sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
        ch = w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) * 256.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def featurize_batch(
    wavs: Sequence[np.ndarray],
    cfg: FbankConfig,
    generator: Optional[torch.Generator] = None,
    mfcc: bool = False,
    apply_cmvn: bool = True,
    speed_factor: Optional[float] = None,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, List[int]]:
    """Pad a list of waveforms to one length and featurize them on
    ``device``: speed perturbation (``speed_factor``), fbank or MFCC, and
    CMVN over each utterance's own frames.  ``generator`` (on ``device``)
    draws the dither; without one, no dither.

    Returns (feats [B, T_max, D] float32 on ``device``, frame_counts);
    callers mask/slice with frame_counts.
    """
    dev = resolve_device(device)
    lengths = [len(w) for w in wavs]
    batch = np.zeros((len(wavs), max(lengths)), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    x = torch.from_numpy(batch).to(dev)
    if speed_factor and speed_factor != 1.0:
        x, lengths = speed_perturb_batch(x, lengths, speed_factor)
    counts = [num_frames(n, cfg) for n in lengths]
    t_max = num_frames(x.shape[1], cfg)
    fn = compute_mfcc if mfcc else compute_fbank
    feats = fn(x, cfg, t_max, generator)
    if apply_cmvn:
        mask = (torch.arange(t_max, device=dev)[None, :]
                < torch.as_tensor(counts, device=dev)[:, None])
        feats = cmvn(feats, mask=mask.to(torch.float32))
    return feats, counts
