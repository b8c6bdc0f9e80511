"""The port's i-vector extractor against the JAX package's (CPU, float32):
UBM EM, the padded statistics, T-matrix EM and extraction, on the
speaker-shifted corpus of tests/test_ivector.py."""

import numpy as np
import pytest
import torch

from tdnnf_nas_tpu.data import ivector as jiv
from tdnnf_nas_torch.data import ivector as tiv

torch.set_num_threads(1)


def _speaker_corpus(num_spk=4, utts_per_spk=6, d=12, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(8, d) * 2.0
    spk_shift = rng.randn(num_spk, d) * 1.5
    utts, labels = [], []
    for s in range(num_spk):
        for _ in range(utts_per_spk):
            t = rng.randint(40, 80)
            comp = rng.randint(0, 8, t)
            utts.append((centers[comp] + spk_shift[s]
                         + rng.randn(t, d) * 0.4).astype(np.float32))
            labels.append(s)
    return utts, np.asarray(labels)


@pytest.fixture(scope="module")
def world():
    utts, labels = _speaker_corpus()
    pooled = np.concatenate(utts)
    ucfg = jiv.UbmConfig(num_gauss=16, em_iters=4)
    jubm = jiv.train_ubm(pooled, ucfg)
    tubm = tiv.train_ubm(pooled, tiv.UbmConfig(num_gauss=16, em_iters=4),
                         device="cpu")
    return dict(utts=utts, labels=labels, pooled=pooled, jubm=jubm,
                tubm=tubm)


def test_ubm_em_matches_jax(world):
    """Same seeded init (numpy) and 4 EM steps: float32 agreement within
    rtol 1e-4 (both sum posteriors over ~1,400 frames in float32)."""
    for k in ("means", "vars", "weights"):
        assert world["tubm"][k].dtype == np.float32
        np.testing.assert_allclose(world["tubm"][k], world["jubm"][k],
                                   rtol=1e-4, atol=1e-5)


def test_stats_match_jax(world):
    """Zeroth/first-order stats over groups padded with a mask, on the
    same (JAX) UBM; more than one group of 256 on a tiled corpus."""
    utts = world["utts"] * 11  # 264 utterances: two groups
    jn, jf = jiv._collect_stats(utts, world["jubm"])
    tn, tf = tiv._collect_stats(utts, world["jubm"], torch.device("cpu"))
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-5, atol=1e-3)


def test_extractor_and_extraction_match_jax(world):
    """T-matrix EM (3 iterations) and extraction from the same UBM: T
    within rtol 1e-3 (each iteration inverts [R, R] precisions and
    solves per component in float32), each i-vector at cosine >= 0.9999
    with JAX's and within 1e-3 relative to its norm."""
    utts, ubm = world["utts"], world["jubm"]
    cfg = jiv.IvectorConfig(dim=8, em_iters=3)
    jt = jiv.train_ivector_extractor(utts, ubm, cfg)
    tt = tiv.train_ivector_extractor(
        utts, ubm, tiv.IvectorConfig(dim=8, em_iters=3), device="cpu")
    assert tt.shape == jt.shape == (16, 12, 8)
    np.testing.assert_allclose(tt, jt, rtol=1e-3, atol=1e-4)
    jv = jiv.extract_ivectors(utts, ubm, jt)
    tv = tiv.extract_ivectors(utts, ubm, jt, device="cpu")
    assert tv.shape == (len(utts), 8)
    cos = np.sum(tv * jv, 1) / (np.linalg.norm(tv, axis=1)
                                * np.linalg.norm(jv, axis=1))
    assert cos.min() >= 0.9999
    err = np.linalg.norm(tv - jv, axis=1) / np.linalg.norm(jv, axis=1)
    assert err.max() <= 1e-3


def test_port_ivectors_separate_speakers(world):
    """The whole port pipeline on its own UBM: same-speaker i-vectors are
    closer than cross-speaker ones (the reference's test)."""
    utts, labels = world["utts"], world["labels"]
    t_mat = tiv.train_ivector_extractor(
        utts, world["tubm"], tiv.IvectorConfig(dim=8, em_iters=3),
        device="cpu")
    iv = tiv.extract_ivectors(utts, world["tubm"], t_mat, device="cpu")
    d = np.linalg.norm(iv[:, None] - iv[None], axis=-1)
    same = labels[:, None] == labels[None]
    off = ~np.eye(len(utts), dtype=bool)
    assert d[same & off].mean() < d[~same].mean()
