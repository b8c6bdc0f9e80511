"""The port's feature front end, speed perturbation, SpecAugment and wav
ingestion against the JAX package (CPU, float32).  Dither noise and the
SpecAugment masks: the JAX package's draws, passed in."""

import importlib
import wave

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu.data import audio as jaudio
from tdnnf_nas_tpu.frontend import features as jfeat
from tdnnf_nas_tpu.frontend import specaug as jspec
from tdnnf_nas_torch.data import audio as taudio
from tdnnf_nas_torch.frontend import features as tfeat
from tdnnf_nas_torch.frontend import specaug as tspec

# the packages' __init__ re-export the function speed_perturb under its
# module's name
jsp = importlib.import_module("tdnnf_nas_tpu.frontend.speed_perturb")
tsp = importlib.import_module("tdnnf_nas_torch.frontend.speed_perturb")

torch.set_num_threads(1)

# log-mel values are O(10), MFCC's c0 O(100): the two FFTs and the mel and
# DCT products round differently in float32 (seen: 2e-5 fbank, 9e-5
# MFCC); 2e-4 absolute is ~1e-5 of the values
_FEAT_TOL = dict(rtol=0, atol=2e-4)


def _cfgs(**kw):
    return ((jfeat.FbankConfig(**kw), tfeat.FbankConfig(**kw)),
            (jfeat.MfccConfig(**kw), tfeat.MfccConfig(**kw)))


def _wav(n, seed=0, batch=()):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 8000.0
    tone = 3000 * np.sin(2 * np.pi * (300 + 200 * rng.rand()) * t)
    x = tone + 400 * rng.randn(*batch, n)
    return x.astype(np.float32)


@pytest.mark.parametrize("window", ["hamming", "hanning", "povey",
                                    "rectangular"])
def test_tables_equal_jax(window):
    """mel_filterbank (fbank and MFCC ranges), _window, the DCT and
    lifter tables, num_frames: equal arrays."""
    for jc, tc in _cfgs(window_type=window):
        np.testing.assert_array_equal(tfeat.mel_filterbank(tc),
                                      jfeat.mel_filterbank(jc))
        np.testing.assert_array_equal(tfeat._window(tc), jfeat._window(jc))
        for n in (0, 199, 200, 4000):
            assert tfeat.num_frames(n, tc) == jfeat.num_frames(n, jc)
    np.testing.assert_array_equal(tfeat._dct_matrix(40, 40),
                                  jfeat._dct_matrix(40, 40))
    np.testing.assert_array_equal(tfeat._lifter_coeffs(22.0, 40),
                                  jfeat._lifter_coeffs(22.0, 40))


def test_frame_signal_equals_jax():
    wav = _wav(3000, batch=(2,))
    cfg = tfeat.FbankConfig()
    n = tfeat.num_frames(3000, cfg)
    got = tfeat.frame_signal(torch.from_numpy(wav), cfg, n)
    ref = jfeat.frame_signal(jnp.asarray(wav), jfeat.FbankConfig(), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        tfeat.frame_signal(torch.from_numpy(wav), cfg, n + 1)


@pytest.mark.parametrize("kind", ["fbank", "mfcc"])
@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("dither", [False, True])
def test_features_match_jax(kind, use_energy, dither):
    """compute_fbank / compute_mfcc on a [2, N] batch, with and without
    the energy column, without dither and with JAX's dither noise."""
    (jfb, tfb), (jmf, tmf) = _cfgs(use_energy=use_energy,
                                   dither=1.0 if dither else 0.0)
    jc, tc = (jfb, tfb) if kind == "fbank" else (jmf, tmf)
    wav = _wav(4000, seed=1, batch=(2,))
    n = tfeat.num_frames(4000, tc)
    key = jax.random.PRNGKey(3) if dither else None
    jfn = jfeat.compute_fbank if kind == "fbank" else jfeat.compute_mfcc
    tfn = tfeat.compute_fbank if kind == "fbank" else tfeat.compute_mfcc
    ref = np.asarray(jfn(jnp.asarray(wav), jc, n, key))
    noise = (torch.from_numpy(np.array(jax.random.normal(
        key, (2, n, tc.frame_length), jnp.float32))) if dither else None)
    got = tfn(torch.from_numpy(wav), tc, n, noise=noise)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **_FEAT_TOL)


def test_cmvn_and_sliding_cmn_match_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 50, 6) * 3 + 5).astype(np.float32)
    mask = (np.arange(50)[None, :] < np.array([50, 31, 7])[:, None]
            ).astype(np.float32)
    for norm_vars in (False, True):
        for m in (None, mask):
            ref = jfeat.cmvn(jnp.asarray(x), norm_vars,
                             None if m is None else jnp.asarray(m))
            got = tfeat.cmvn(torch.from_numpy(x), norm_vars,
                             None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=2e-5)
    for window, center in ((20, True), (21, True), (20, False), (80, True)):
        ref = jfeat.sliding_cmn(jnp.asarray(x), window, center)
        got = tfeat.sliding_cmn(torch.from_numpy(x), window, center)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("factor", [0.9, 1.1])
def test_speed_perturb_matches_jax(factor):
    """Single waveforms equal JAX's bit for bit (positions in float32 in
    both); the batched form gives each row's single-waveform result and
    length."""
    lengths = [3001, 2500, 1999]
    wavs = [_wav(n, seed=i) for i, n in enumerate(lengths)]
    for w in wavs:
        ol = tsp.perturbed_length(len(w), factor)
        assert ol == jsp.perturbed_length(len(w), factor)
        ref = np.asarray(jsp.speed_perturb(jnp.asarray(w), factor, ol))
        got = tsp.speed_perturb(torch.from_numpy(w), factor, ol)
        np.testing.assert_array_equal(got.numpy(), ref)
    batch = np.zeros((3, max(lengths)), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    out, out_lens = tsp.speed_perturb_batch(torch.from_numpy(batch), lengths,
                                            factor)
    assert out_lens == [tsp.perturbed_length(n, factor) for n in lengths]
    assert out.shape == (3, max(out_lens))
    for i, w in enumerate(wavs):
        one = tsp.speed_perturb(torch.from_numpy(w), factor, out_lens[i])
        assert torch.equal(out[i, :out_lens[i]], one)
        assert not out[i, out_lens[i]:].any()


def test_spec_augment_with_jax_draws():
    """The JAX package's four randint draws (jax.random.split(key, 4))
    passed in mask exactly as JAX masks; the port's own draws keep each
    start below max(size - width, 1)."""
    cfg_kw = dict(num_freq_masks=2, freq_mask_width=5, num_time_masks=3,
                  time_mask_width=9, mask_value=-1.5)
    jcfg, tcfg = jspec.SpecAugmentConfig(**cfg_kw), tspec.SpecAugmentConfig(
        **cfg_kw)
    b, t, f = 4, 40, 12
    x = np.random.RandomState(5).randn(b, t, f).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref = np.asarray(jspec.spec_augment(jnp.asarray(x), jcfg, key))
    k = jax.random.split(key, 4)
    fw = jax.random.randint(k[0], (b, 2), 0, 6)
    fs = jax.random.randint(k[1], (b, 2), 0, jnp.maximum(f - fw, 1))
    tw = jax.random.randint(k[2], (b, 3), 0, 10)
    ts = jax.random.randint(k[3], (b, 3), 0, jnp.maximum(t - tw, 1))
    draws = tuple(torch.from_numpy(np.array(d)) for d in (fw, fs, tw, ts))
    got = tspec.spec_augment(torch.from_numpy(x), tcfg, draws=draws)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == -1.5).any()
    fw, fs, tw, ts = tspec.spec_augment_draws(
        64, t, f, tcfg, torch.Generator().manual_seed(0))
    assert int(fw.max()) <= 5 and int(tw.max()) <= 9
    assert bool((fs < torch.clamp(f - fw, min=1)).all())
    assert bool((ts < torch.clamp(t - tw, min=1)).all())
    assert bool((fs >= 0).all() and (ts >= 0).all())


def _write_wav(path, samples, sr=8000):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(samples, "<i2").tobytes())


@pytest.mark.parametrize("speed", [None, 0.9, 1.1])
@pytest.mark.parametrize("kind", ["fbank", "mfcc"])
def test_featurize_batch_matches_jax(tmp_path, speed, kind):
    """Wavs written as 16-bit files, read back by both packages' read_wav
    (equal samples), featurized with CMVN (and speed perturbation): equal
    frame counts, features at the front end's bar on the valid frames."""
    lengths = (8000, 6000, 7201)
    paths = []
    for i, n in enumerate(lengths):
        p = str(tmp_path / f"u{i}.wav")
        _write_wav(p, np.clip(_wav(n, seed=10 + i), -32768, 32767))
        paths.append(p)
    wavs = []
    for p in paths:
        (a, sr), (b, sr2) = taudio.read_wav(p), jaudio.read_wav(p)
        np.testing.assert_array_equal(a, b)
        assert sr == sr2 == 8000
        wavs.append(a)
    (jfb, tfb), (jmf, tmf) = _cfgs(dither=0.0)
    jc, tc = (jfb, tfb) if kind == "fbank" else (jmf, tmf)
    ref, jcounts = jaudio.featurize_batch(wavs, jc, mfcc=kind == "mfcc",
                                          speed_factor=speed)
    got, counts = taudio.featurize_batch(wavs, tc, mfcc=kind == "mfcc",
                                         speed_factor=speed, device="cpu")
    assert counts == jcounts and tuple(got.shape) == ref.shape
    for i, c in enumerate(counts):
        np.testing.assert_allclose(got[i, :c].numpy(), ref[i, :c],
                                   **_FEAT_TOL)
