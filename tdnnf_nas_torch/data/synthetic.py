"""Numpy copy of ``tdnnf_nas_tpu.data.synthetic`` (HMM-generated corpus).

Utterances are sampled from a random phone Markov chain with per-pdf
Gaussian emissions, at the input frame rate (frame_subsampling_factor
frames per output frame).  Only the phone corpus of the slice is copied;
the word corpus waits for the decode port.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from tdnnf_nas_torch.core.config import Config
from tdnnf_nas_torch.graphs.topology import ChainTopology, ContextIndependentTree

@dataclasses.dataclass(frozen=True)
class SyntheticCorpusConfig(Config):
    num_phones: int = 8
    feat_dim: int = 20
    num_utts: int = 64
    min_phones: int = 4
    max_phones: int = 12
    mean_dur: float = 4.0  # output frames per phone (geometric-ish)
    frame_subsampling_factor: int = 3
    emission_noise: float = 0.5
    # left-context coloring: emission mean += context_shift * shift[l1]
    # (makes context-dependent trees acoustically learnable — the analogue
    # of real speech coarticulation that triphone trees exist to model)
    context_shift: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class Utterance:
    feats: np.ndarray  # [T_in, F]
    phones: List[int]
    begins: List[int]  # output-frame phone starts
    ends: List[int]  # output-frame phone ends (inclusive)
    pdf_align: np.ndarray  # [T_out] int32
    words: List[int] = dataclasses.field(default_factory=list)
    speaker: int = 0


def make_synthetic_corpus(cfg: SyntheticCorpusConfig):
    """Returns (utterances, phone_seqs, tree, topo)."""
    rng = np.random.RandomState(cfg.seed)
    tree = ContextIndependentTree(cfg.num_phones)
    topo = ChainTopology(cfg.num_phones)
    # random (peaky) phone bigram for generation
    gen_lm = rng.dirichlet(np.ones(cfg.num_phones) * 0.5, size=cfg.num_phones)
    # well-separated pdf emission means
    means = rng.randn(tree.num_pdfs, cfg.feat_dim) * 2.0
    ctx_shift = rng.randn(cfg.num_phones + 1, cfg.feat_dim)  # [l1+1, D]
    fs = cfg.frame_subsampling_factor

    utts: List[Utterance] = []
    for _ in range(cfg.num_utts):
        n = rng.randint(cfg.min_phones, cfg.max_phones + 1)
        phones = [rng.randint(cfg.num_phones)]
        for _ in range(n - 1):
            phones.append(rng.choice(cfg.num_phones, p=gen_lm[phones[-1]]))
        begins, ends, pdfs, lctx = [], [], [], []
        t = 0
        prev = -1
        for p in phones:
            dur = 1 + rng.geometric(1.0 / cfg.mean_dur)
            begins.append(t)
            ends.append(t + dur - 1)
            pdfs.append(tree.forward_pdf(p))
            pdfs.extend([tree.self_loop_pdf(p)] * (dur - 1))
            lctx.extend([prev] * dur)
            t += dur
            prev = p
        pdf_align = np.asarray(pdfs, np.int32)
        t_out = len(pdf_align)
        feats = (
            means[np.repeat(pdf_align, fs)]
            + rng.randn(t_out * fs, cfg.feat_dim) * cfg.emission_noise
        )
        if cfg.context_shift > 0.0:
            feats = feats + cfg.context_shift * ctx_shift[
                np.repeat(np.asarray(lctx) + 1, fs)]
        utts.append(Utterance(feats.astype(np.float32), phones, begins, ends,
                              pdf_align))
    phone_seqs = [u.phones for u in utts]
    return utts, phone_seqs, tree, topo
