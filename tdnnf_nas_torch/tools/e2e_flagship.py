"""The whole flagship run in one process on the card (port of
``scripts/e2e_flagship.py``).

Stages, as the reference numbers them:

  1 the GMM ladder on a stratified subset, then every training
    utterance aligned (``bootstrap_stage``);
  2 the left-2 triphone tree from those alignments, and the composed
    4-gram den (``prepare_data``: its blocked export, so training
    launches the blocked-den kernels);
  3 UBM, T-matrix and per-utterance i-vectors on the card;
  4 LF-MMI training of the flagship 7q;
  5 the trigram HCLG and the beam decode with lattices;
  6 4-gram lattice rescoring, then an RNNLM trained on the LM text and
    its 20-best rescoring;
  7 per-speaker LHUC (``lhuc_adapt_and_decode``), with the i-vector
    model and with a model trained without i-vectors;
  8 bf16 against float32 at equal budget (``tools/e2e_search.bf16_ab``);
  9 ("search") the two-stage DARTS search on the 7q supernet and the
    searched / random / manual table (``tools/e2e_search.run_search``).

``E2eSizes`` holds every size the reference's ``FLAGSHIP_SMOKE`` switches:
``full()`` is the reference's run, ``smoke()`` its smoke run.  The
run writes the reference's three files, with its keys and its
rounding, into ``--out``: ``e2e_flagship.json`` (stages 1-8),
``bf16_parity.json`` (stage 8) and ``search_table_flagship.json``
(stage 9).  Each stage prints its seconds.

Where the port differs from the reference:

- a failing stage raises: the reference's ``except Exception: ...
  skipped`` around stages 6-8 is not kept, so no stage can fail unseen;
- the files go to ``--out``, never to ``docs/`` (the reference's own
  figures) or ``/tmp``;
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step;
- the bootstrap cache is kept only under ``--cache-dir`` and is keyed on
  the corpus config, every bootstrap size and the corpus fingerprint
  (the reference keys on the corpus config and fingerprint in a fixed
  ``.cache/`` file); ``gmm.train_subset`` reports the subset that ran
  (the reference writes 800 in its smoke run too), and the A/B note
  names the budget that ran.

``chip_smoke.py`` phase 14 runs ``main(["all", "--smoke", ...])``; phase
9 drives ``lhuc_adapt_and_decode`` and phase 10 ``bootstrap_stage`` with
the +-1 tree.

Usage:
    python3 -m tdnnf_nas_torch.tools.e2e_flagship [base|search|all]
        [--smoke] --out DIR [--cache-dir DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.egs import EgsConfig, batch_iterator, make_egs
from tdnnf_nas_torch.data.ivector import (IvectorConfig, UbmConfig,
                                          extract_ivectors,
                                          train_ivector_extractor, train_ubm)
from tdnnf_nas_torch.data.synthetic import WordCorpusConfig, make_word_corpus
from tdnnf_nas_torch.decode.beam import beam_decode_sparse
from tdnnf_nas_torch.decode.graph_sparse import build_hclg_sparse
from tdnnf_nas_torch.decode.lattice import lattice_nbest, rescore_lattice
from tdnnf_nas_torch.decode.rescore import rescore_nbest_rnnlm_batched
from tdnnf_nas_torch.decode.scoring import score_corpus
from tdnnf_nas_torch.decode.wfst import Lexicon
from tdnnf_nas_torch.gmm import GmmLadderConfig, MonoHmmConfig
from tdnnf_nas_torch.graphs.tree_cluster import (
    accumulate_cross_triphone_stats, accumulate_triphone_stats,
    build_clustered_cross_triphone_tree, build_clustered_triphone_tree)
from tdnnf_nas_torch.lm.ngram import estimate_ngram_lm
from tdnnf_nas_torch.lm.rnnlm import RnnLMConfig, RnnLMScorer, train_rnnlm
from tdnnf_nas_torch.models import TdnnfModelConfig, count_params
from tdnnf_nas_torch.models.lhuc import adapt_lhuc, apply_model_lhuc
from tdnnf_nas_torch.models.tdnnf import model_context
from tdnnf_nas_torch.recipes.chain_recipes import (bootstrap_alignments_gmm,
                                                   decode_corpus_words,
                                                   den_on_device,
                                                   prepare_data, train_model)
from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                   TrainerConfig)

# the reference's enrollment batch and batch cap (scripts/e2e_flagship.py:517-528)
LHUC_BATCH = 16
LHUC_MAX_BATCHES = 8
NUM_PHONES = 46
IVECTOR_DIM = 100  # scripts/e2e_flagship.py:181, 233
DROPOUT_SCHEDULE = ((0.0, 0.0), (0.2, 0.3), (0.5, 0.3), (1.0, 0.0))

TREE_KINDS = {
    # the reference flagship's left-2 tree, and the +-1 tree of tri5_7d
    "left2": (accumulate_triphone_stats, build_clustered_triphone_tree),
    "pm1": (accumulate_cross_triphone_stats,
            build_clustered_cross_triphone_tree),
}


@dataclasses.dataclass(frozen=True)
class E2eSizes:
    """Every size ``FLAGSHIP_SMOKE`` switches in the reference (its line in
    ``scripts/e2e_flagship.py`` beside each field).  ``model_overrides``
    are ``TdnnfModelConfig`` fields set on top of the 7q; the presets
    leave it empty (the tests' small preset narrows the model with it)."""

    n_test: int  # :47
    vocab_size: int  # :71
    num_utts: int  # :72
    num_text_sents: int  # :75
    tri_leaves: int  # :151
    train_subset: int  # :154
    tree_leaves: int  # :168
    ubm_utts: int  # :176
    ubm_gauss: int  # :177
    tmat_utts: int  # :180
    extra_lm_states: int  # :219
    train_steps: int  # :289
    rnnlm_embed: int  # :351
    rnnlm_hidden: int  # :352
    rnnlm_proj: int  # :353
    rnnlm_splice: bool  # :354
    rnnlm_steps: int  # :357
    noiv_steps: int  # :411
    ab_steps: int  # :436
    pretrain_steps: int  # :597
    cv_steps: int  # :598
    child_steps: int  # :668
    topic_successors: bool = False  # :46, FLAGSHIP_TOPIC_SUCC
    model_overrides: tuple = ()  # ((field, value), ...)

    @classmethod
    def full(cls) -> "E2eSizes":
        return cls(n_test=200, vocab_size=30000, num_utts=4200,
                   num_text_sents=120000, tri_leaves=500, train_subset=800,
                   tree_leaves=6034 - NUM_PHONES, ubm_utts=150, ubm_gauss=64,
                   tmat_utts=600, extra_lm_states=2000, train_steps=1600,
                   rnnlm_embed=1024, rnnlm_hidden=2048, rnnlm_proj=512,
                   rnnlm_splice=True, rnnlm_steps=4000, noiv_steps=1000,
                   ab_steps=600, pretrain_steps=700, cv_steps=1000,
                   child_steps=1000)

    @classmethod
    def smoke(cls) -> "E2eSizes":
        return cls(n_test=20, vocab_size=2500, num_utts=220,
                   num_text_sents=4000, tri_leaves=120, train_subset=80,
                   tree_leaves=400, ubm_utts=50, ubm_gauss=16, tmat_utts=100,
                   extra_lm_states=500, train_steps=120, rnnlm_embed=128,
                   rnnlm_hidden=256, rnnlm_proj=0, rnnlm_splice=False,
                   rnnlm_steps=150, noiv_steps=120, ab_steps=60,
                   pretrain_steps=80, cv_steps=60, child_steps=100)


class Report:
    """What a run writes and what it counted.  ``e2e``, ``bf16`` and
    ``search`` are the contents of the reference's three files, each
    written to ``out_dir`` (when given; only those named in ``files``)
    under its name in ``names`` (default ``FILES``) as it grows;
    ``seconds`` holds
    each stage's seconds; ``steps`` the model steps each stage took
    (from its metrics), ``lhuc_steps`` the LHUC steps and
    ``valid_batches`` the batches stage 9's valid steps scored."""

    FILES = {"e2e": "e2e_flagship.json", "bf16": "bf16_parity.json",
             "search": "search_table_flagship.json"}

    def __init__(self, out_dir: Optional[str] = None, files=None,
                 names: Optional[dict] = None):
        self.out_dir = out_dir
        self.names = dict(self.FILES if names is None else names)
        self.files = tuple(self.names) if files is None else files
        self.e2e: dict = {}
        self.bf16: dict = {}
        self.search: dict = {}
        self.seconds: dict = {}
        self.steps: dict = {}
        self.lhuc_steps = 0
        self.valid_batches = 0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def save(self, what: str = "e2e") -> None:
        if self.out_dir and what in self.files:
            with open(os.path.join(self.out_dir, self.names[what]), "w") as f:
                json.dump(getattr(self, what), f, indent=2)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Times the block as stage ``name`` and prints its seconds."""
        t0 = time.perf_counter()
        yield
        self.seconds[name] = time.perf_counter() - t0
        print(f"[e2e] stage {name}: {self.seconds[name]:.1f} s", flush=True)

    def trained(self, name: str, metrics) -> list:
        """Records the steps of one ``train_model`` run; returns its objf
        series."""
        hist = [v for _, v in metrics.series["objf_mmi"]]
        self.steps[name] = len(hist)
        return hist


@dataclasses.dataclass
class Setup:
    """Stages 1-3 and the den (``scripts/e2e_flagship.py:226-227``'s
    tuple)."""

    sizes: E2eSizes
    cfg: WordCorpusConfig
    utts: list
    prons: dict
    word_seqs: list
    text: list
    bundle: object
    tree: object
    topo: object
    test: list
    train: list
    iv_test: np.ndarray
    iv_train: np.ndarray


@dataclasses.dataclass
class BaseRun:
    """Stage 4's model and state, and stage 5's HCLG, which ``run_search``
    decodes on (``:465``)."""

    model_cfg: TdnnfModelConfig
    state: object
    g: object


def word_corpus_config(sizes: E2eSizes) -> WordCorpusConfig:
    """The reference's corpus (``:70-84``): 46 phones, 40-dim features,
    40 speakers, lookahead lags and 8 topics."""
    return WordCorpusConfig(
        vocab_size=sizes.vocab_size, num_phones=NUM_PHONES, feat_dim=40,
        num_utts=sizes.num_utts, min_words=6, max_words=14, min_pron=3,
        max_pron=7, mean_dur=3.5, emission_noise=4.5, context_shift=1.0,
        num_speakers=40, speaker_shift=1.0,
        num_text_sents=sizes.num_text_sents,
        lookahead_lags=(3, 8, 14, 20, 26, 32, 38, 44), lookahead_dim=12,
        lookahead_scale=2.5, num_topics=8,
        topic_successors=sizes.topic_successors, seed=0)


def ladder_config(sizes: E2eSizes) -> GmmLadderConfig:
    """The reference's GMM ladder (``:149-154``)."""
    return GmmLadderConfig(
        mono=MonoHmmConfig(num_iters=8, max_mix=2, mix_up_iters=(4,)),
        tri_leaves=sizes.tri_leaves, tri_em_iters=6, splice_context=2,
        lda_dim=36, lda_mllt_em_iters=5, sat_em_iters=4,
        train_subset=sizes.train_subset)


def bootstrap_stage(train, train_phones, num_phones: int, ladder_cfg,
                    num_leaves: int, tree_kind: str = "left2",
                    speakers=None, frame_subsampling_factor: int = 3,
                    device=DEFAULT_DEVICE):
    """E2e stages 1-2: the GMM ladder on ``device`` replaces the training
    utterances' begins and ends (``bootstrap_alignments_gmm``), then the
    ``tree_kind`` tree ("left2" or "pm1") of ``num_leaves`` forward leaves
    is clustered on the host from the new alignments.  Returns (tree,
    ladder result, {"gmm": s, "tree": s})."""
    if tree_kind not in TREE_KINDS:
        raise ValueError(f"tree_kind must be one of {sorted(TREE_KINDS)}, "
                         f"got {tree_kind!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    _, ladder = bootstrap_alignments_gmm(
        train, train_phones, num_phones,
        speakers=speakers, ladder_cfg=ladder_cfg, device=dev)
    t_gmm = time.perf_counter() - t0
    accumulate, build = TREE_KINDS[tree_kind]
    t0 = time.perf_counter()
    stats = accumulate([u.feats for u in train], train_phones,
                       [u.begins for u in train], num_phones,
                       frame_subsampling_factor)
    tree = build(stats, num_leaves=num_leaves)
    return tree, ladder, {"gmm": t_gmm, "tree": time.perf_counter() - t0}


def _cache_key(sizes: E2eSizes, cfg: WordCorpusConfig, utts, frames: int):
    """(file name, key) of the bootstrap cache: the corpus config and the
    bootstrap's sizes, and the reference's corpus fingerprint (``:119``:
    a code change in the corpus generator can change the corpus under an
    equal config)."""
    boot = (repr(cfg), sizes.tri_leaves, sizes.train_subset,
            sizes.tree_leaves, sizes.ubm_utts, sizes.ubm_gauss,
            sizes.tmat_utts)
    fp = (f"{frames}:{float(np.sum(np.abs(utts[0].feats[:8]))):.3f}:"
          f"{list(utts[0].phones[:6])}")
    digest = hashlib.sha1(repr(boot).encode()).hexdigest()[:16]
    return f"e2e_setup_{digest}.pkl", (repr(boot), fp)


def build_setup(sizes: E2eSizes, cache_dir: Optional[str] = None,
                device=DEFAULT_DEVICE, report: Optional[Report] = None
                ) -> Setup:
    """Stages 1-3 and the den (``:59-227``): the word corpus, the GMM
    ladder on ``device`` and the left-2 tree, i-vectors on ``device`` and
    their within/between-speaker cosines, then ``prepare_data`` (4-gram
    den, 5% dev).  With ``cache_dir`` the bootstrap (alignments, tree,
    i-vectors) is read from and written to a pickle there; without, it is
    always computed.  Fills ``report.e2e``'s corpus, gmm, ivectors,
    tree_pdfs and den_states."""
    dev = resolve_device(device)
    report = report if report is not None else Report()
    out = report.e2e
    cfg = word_corpus_config(sizes)
    with report.stage("0 corpus"):
        utts, prons, word_seqs, _, _, topo, text = make_word_corpus(cfg)
    test, train = utts[:sizes.n_test], utts[sizes.n_test:]
    train_phones = [u.phones for u in train]
    frames = sum(len(u.pdf_align) for u in utts)
    print(f"[0] corpus: {len(utts)} utts, {frames} out-frames "
          f"(~{frames * 0.03 / 3600:.1f} h), vocab {cfg.vocab_size}",
          flush=True)
    out["corpus"] = {"vocab": cfg.vocab_size, "phones": cfg.num_phones,
                     "train_utts": len(train), "test_utts": len(test),
                     "audio_hours": round(frames * 0.03 / 3600, 2),
                     "noise": cfg.emission_noise,
                     "speakers": cfg.num_speakers,
                     "lm_text_sents": len(text)}
    cached, cache_path = None, None
    if cache_dir:
        name, key = _cache_key(sizes, cfg, utts, frames)
        cache_path = os.path.join(cache_dir, name)
        if os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                cached = pickle.load(f)
            if cached.get("key") != key:
                cached = None
    if cached is not None:
        for u, b, e in zip(train, cached["begins"], cached["ends"]):
            u.begins, u.ends = b, e
        tree, ivecs = cached["tree"], cached["ivecs"]
        out["gmm"], out["ivectors"] = cached["gmm"], cached["iv_diag"]
        print(f"[1-3] bootstrap restored from {cache_path}", flush=True)
    else:
        with report.stage("1-2 bootstrap"):
            tree, ladder, secs = bootstrap_stage(
                train, train_phones, cfg.num_phones, ladder_config(sizes),
                sizes.tree_leaves, speakers=[u.speaker for u in train],
                frame_subsampling_factor=cfg.frame_subsampling_factor,
                device=dev)
        print(f"[1] GMM ladder: fmllr_gain={ladder.fmllr_gain:.3f} "
              f"({secs['gmm']:.0f}s); [2] tree: {tree.num_pdfs} pdfs "
              f"({secs['tree']:.0f}s)", flush=True)
        out["gmm"] = {"fmllr_gain": round(ladder.fmllr_gain, 3),
                      "train_subset": sizes.train_subset,
                      "seconds": round(secs["gmm"])}
        report.save()
        with report.stage("3 ivectors"):
            pool = np.concatenate(
                [u.feats for u in train[:sizes.ubm_utts]])[::2]
            ubm = train_ubm(pool, UbmConfig(num_gauss=sizes.ubm_gauss,
                                            em_iters=6), device=dev)
            t_mat = train_ivector_extractor(
                [u.feats for u in train[:sizes.tmat_utts]], ubm,
                IvectorConfig(dim=IVECTOR_DIM, em_iters=4), device=dev)
            ivecs = extract_ivectors([u.feats for u in utts], ubm, t_mat,
                                     device=dev)
        # speaker separability: mean within/between-speaker cosine
        spk = np.asarray([u.speaker for u in utts])
        ivn = ivecs / np.linalg.norm(ivecs, axis=1, keepdims=True)
        cos = ivn @ ivn.T
        same = spk[:, None] == spk[None, :]
        off = ~np.eye(len(utts), dtype=bool)
        out["ivectors"] = {"dim": IVECTOR_DIM,
                           "within_spk_cos": round(float(
                               cos[same & off].mean()), 3),
                           "between_spk_cos": round(float(
                               cos[~same].mean()), 3)}
    print(f"[3] i-vectors: within-spk cos {out['ivectors']['within_spk_cos']}"
          f" vs between {out['ivectors']['between_spk_cos']}", flush=True)
    report.save()
    if cache_path and cached is None:
        os.makedirs(cache_dir, exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump({"key": key,
                         "begins": [list(u.begins) for u in train],
                         "ends": [list(u.ends) for u in train],
                         "tree": tree, "ivecs": np.asarray(ivecs),
                         "gmm": out["gmm"], "iv_diag": out["ivectors"]}, f)
        print(f"[1-3] bootstrap cached to {cache_path}", flush=True)
    iv_test, iv_train = ivecs[:sizes.n_test], ivecs[sizes.n_test:]
    with report.stage("2b den"):
        bundle = prepare_data(train, train_phones, tree, topo,
                              cfg.num_phones, dev_fraction=0.05,
                              phone_lm_order=4,
                              num_extra_lm_states=sizes.extra_lm_states,
                              ivectors=list(iv_train))
    print(f"[2b] den: S={bundle.den_fsa.num_states} "
          f"({type(bundle.den_arrays).__name__})", flush=True)
    out["tree_pdfs"] = int(tree.num_pdfs)
    out["den_states"] = int(bundle.den_fsa.num_states)
    report.save()
    return Setup(sizes=sizes, cfg=cfg, utts=utts, prons=prons,
                 word_seqs=word_seqs, text=text, bundle=bundle, tree=tree,
                 topo=topo, test=test, train=train, iv_test=iv_test,
                 iv_train=iv_train)


def model_config(tree, cfg, dtype: str = "bfloat16",
                 overrides=()) -> TdnnfModelConfig:
    """The flagship 7q with i-vectors (``:230-234``), ``overrides`` on
    top (``E2eSizes.model_overrides``)."""
    return TdnnfModelConfig(feat_dim=cfg.feat_dim, ivector_dim=IVECTOR_DIM,
                            num_pdfs=tree.num_pdfs,
                            compute_dtype=dtype).replace(**dict(overrides))


def trainer_config(num_steps: int, lr0: float = 1e-3,
                   lr1: float = 1e-4) -> TrainerConfig:
    """Adam with the dropout schedule (``:237-245``)."""
    return TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=lr0, lr_final=lr1,
                                  num_steps=num_steps),
        dropout_schedule=DROPOUT_SCHEDULE)


def build_graph(cfg, prons, word_seqs, text, n_test: int):
    """(word_sym, trigram, 4-gram) (``:248-268``): the first-pass trigram
    from the training transcripts and a tenth of the LM text, the
    rescoring 4-gram from all of it."""
    word_sym = [f"w{w}" for w in range(cfg.vocab_size)]
    trans_text = [[word_sym[w] for w in ws] for ws in word_seqs[n_test:]]
    full_text = [[word_sym[w] for w in ws] for ws in text] + trans_text
    tg_text = ([[word_sym[w] for w in ws]
                for ws in text[: len(text) // 10]] + trans_text)
    lm3 = estimate_ngram_lm(tg_text, order=3)
    lm4 = estimate_ngram_lm(full_text, order=4)
    print(f"[5] LMs: tg {len(lm3.logprobs)} ngrams ({len(tg_text)} sents), "
          f"fg {len(lm4.logprobs)} ({len(full_text)} sents)", flush=True)
    return word_sym, lm3, lm4


def build_hclg(setup: Setup, lm3, word_sym):
    """The trigram HCLG with the compact unigram junction (``:310-311``;
    the exact per-left-phone split costs 2.2x the states at 30k words)."""
    return build_hclg_sparse(Lexicon(setup.prons), lm3, word_sym,
                             setup.topo, setup.tree, split_unigram=False)


def decode(setup: Setup, mc, state, g, utts=None, lattice=False,
           use_iv=True, device=DEFAULT_DEVICE) -> dict:
    """``decode_corpus_words`` of ``utts`` (a prefix of the test set, all
    of it by default) as every stage calls it (beam 16, max_active
    10,000, 2 forked workers; lattice beam 8)."""
    utts = setup.test if utts is None else utts
    ivs = list(setup.iv_test[:len(utts)]) if use_iv else None
    return decode_corpus_words(setup.bundle, mc, state, g, utts,
                               acoustic_scale=1.0, beam=16.0,
                               max_active=10000, lattice=lattice,
                               lattice_beam=8.0, num_workers=2,
                               ivectors=ivs, device=device)


def run_base(setup: Setup, report: Optional[Report] = None,
             device=DEFAULT_DEVICE) -> BaseRun:
    """Stages 4-8 on ``setup`` (``:271-465``): training, the trigram
    decode, 4-gram and RNNLM rescoring, LHUC with and without
    i-vectors, and the bf16 A/B.  Every stage's failure propagates."""
    from tdnnf_nas_torch.tools.e2e_search import bf16_ab

    dev = resolve_device(device)
    report = report if report is not None else Report()
    out, sizes, bundle = report.e2e, setup.sizes, setup.bundle
    mc = model_config(setup.tree, setup.cfg,
                      overrides=sizes.model_overrides)
    n_steps = sizes.train_steps
    tc = trainer_config(n_steps)
    with report.stage("4 train"):
        state, metrics = train_model(bundle, mc, tc, n_steps, batch_size=64,
                                     chunk_width=50, seed=0, log_every=100,
                                     device=dev)
        report.trained("train", metrics)
    objf = metrics.last("objf_mmi")
    print(f"[4] train objf_mmi={objf:.4f} "
          f"params={count_params(state.params):,}", flush=True)
    out["train"] = {"steps": n_steps, "objf_mmi": round(float(objf), 4),
                    "params": int(count_params(state.params)),
                    "seconds": round(report.seconds["4 train"]),
                    "egs_stats": dict(bundle.egs_stats)}
    report.save()

    with report.stage("5 LMs"):
        word_sym, lm3, lm4 = build_graph(setup.cfg, setup.prons,
                                         setup.word_seqs, setup.text,
                                         sizes.n_test)
    with report.stage("5 HCLG"):
        g = build_hclg(setup, lm3, word_sym)
    print(f"[5] HCLG: {g.num_states} states, {g.num_arcs} arcs", flush=True)
    out["hclg"] = {"states": int(g.num_states), "arcs": int(g.num_arcs),
                   "build_s": round(report.seconds["5 HCLG"])}
    with report.stage("5 decode"):
        rep = decode(setup, mc, state, g, lattice=True, device=dev)
    print(f"[5] first-pass (tg) WER={rep['wer']:.2f}%", flush=True)
    out["wer_first_pass_tg"] = round(rep["wer"], 2)
    report.save()

    wtt = lambda w: word_sym[w]
    refs = [list(u.words) for u in setup.test]
    with report.stage("6 4-gram rescore"):
        hyps4 = []
        for lat in rep["lattices"]:
            best = rescore_lattice(lat, lm3, lm4, lm_scale=1.0,
                                   word_to_token=wtt, n=1)
            hyps4.append(best[0][0] if best else [])
    out["wer_4gram_rescore"] = round(score_corpus(refs, hyps4)["wer"], 2)
    print(f"[6] +4-gram rescore WER={out['wer_4gram_rescore']:.2f}%",
          flush=True)
    report.save()

    with report.stage("6 rnnlm"):
        # the reference rescorer's 1024 / 2048 / rpd-512 TDNN-LSTM shape,
        # trained on the whole LM text and the training transcripts
        rl_cfg = RnnLMConfig(vocab_size=setup.cfg.vocab_size,
                             embed_dim=sizes.rnnlm_embed,
                             hidden_dim=sizes.rnnlm_hidden,
                             proj_dim=sizes.rnnlm_proj,
                             tdnn_splice=sizes.rnnlm_splice)
        rnn_params, rnn_ppl = train_rnnlm(
            setup.text + setup.word_seqs[sizes.n_test:], rl_cfg,
            num_steps=sizes.rnnlm_steps, batch_size=64, seed=0, device=dev)
        scorer = RnnLMScorer(rl_cfg, rnn_params)
        nbests = [lattice_nbest(lat, n=20) for lat in rep["lattices"]]
        bests = rescore_nbest_rnnlm_batched(nbests, lm3, scorer,
                                            lm_scale=1.0, interp_weight=0.5,
                                            word_to_token=wtt)
    out["wer_rnnlm_rescore"] = round(
        score_corpus(refs, [b[0] for b in bests])["wer"], 2)
    print(f"[6] RNNLM ppl~{rnn_ppl:.1f}; +RNNLM rescore "
          f"WER={out['wer_rnnlm_rescore']:.2f}%", flush=True)
    del scorer, rnn_params
    report.save()

    def count_lhuc(_):
        report.lhuc_steps += 1

    def lhuc_pass(mc_l, state_l, use_iv, base_hyps):
        res = lhuc_adapt_and_decode(bundle, setup.topo, setup.tree, g,
                                    setup.test, refs, setup.iv_test,
                                    tc.objective, mc_l, state_l, use_iv,
                                    base_hyps, on_step=count_lhuc,
                                    device=dev)
        return {"speakers": res["speakers"], "utts": res["utts"],
                "wer_before": round(res["wer_before"], 2),
                "wer_after": round(res["wer_after"], 2)}

    # stage 7: LHUC on the i-vector model, then a model trained without
    # i-vectors, where the per-speaker shift is left to LHUC
    with report.stage("7 lhuc"):
        out["lhuc"] = lhuc_pass(mc, state, True, rep["hyps"])
    report.save()
    with report.stage("7b lhuc no-iv"):
        mc_niv = mc.replace(ivector_dim=0)
        st_niv, m_niv = train_model(bundle, mc_niv,
                                    trainer_config(sizes.noiv_steps),
                                    sizes.noiv_steps, batch_size=64,
                                    chunk_width=50, seed=3, log_every=200,
                                    device=dev)
        report.trained("noiv", m_niv)
        rep_niv = decode(setup, mc_niv, st_niv, g, use_iv=False, device=dev)
        print(f"[7b] no-iv model: WER {rep_niv['wer']:.2f}", flush=True)
        out["lhuc_noiv"] = lhuc_pass(mc_niv, st_niv, False, rep_niv["hyps"])
        out["lhuc_noiv"]["wer_unadapted_full"] = round(rep_niv["wer"], 2)
    del st_niv
    report.save()

    with report.stage("8 bf16 A/B"):
        report.bf16 = bf16_ab(setup, g, report, device=dev)
    report.save("bf16")
    out["bf16_parity"] = {"delta_wer": report.bf16["delta_wer"]}
    report.save()
    print(json.dumps(out), flush=True)
    return BaseRun(model_cfg=mc, state=state, g=g)


def lhuc_batches(chunks):
    """Host batches of one speaker's chunks, as the reference takes them:
    ``batch_iterator`` shuffled by ``RandomState(0)`` without dropping
    the last, at most ``LHUC_MAX_BATCHES``.  A short batch is padded to
    ``LHUC_BATCH`` by repeating its first chunk.  The reference does so
    for one jit shape, but the repeated chunk also enters the loss and
    its gradient a second time, so the port keeps it to compute the same
    objective.  No chunks raise ValueError (the reference's endless
    ``batch_iterator`` would never yield)."""
    if not chunks:
        raise ValueError("no chunks to adapt on")
    out = []
    for b in batch_iterator(chunks, LHUC_BATCH, np.random.RandomState(0),
                            drop_last=False):
        n_b = b["feats"].shape[0]
        if n_b < LHUC_BATCH:
            b = convert.map_batch(lambda _, a: np.concatenate(
                [a, np.repeat(a[:1], LHUC_BATCH - n_b, 0)]), b)
        out.append(b)
        if len(out) >= LHUC_MAX_BATCHES:
            break
    return out


def lhuc_adapt_and_decode(bundle, topo, tree, g, test, refs, iv_test,
                          objective_cfg, mc_l, state_l, use_iv: bool,
                          base_hyps, num_steps: int = 24, lr: float = 0.2,
                          l2: float = 0.0, on_step=None,
                          device=DEFAULT_DEVICE) -> dict:
    """E2e stage 7 (``:468-560``): per-speaker LHUC enrollment and the
    adapted decode of the speakers' test utterances.

    For each test speaker, up to 10 of the speaker's training utterances
    are cut into 50-frame chunks and up to 8 batches of 16; ``num_steps``
    SGD steps train the LHUC logits of the frozen model through the chain
    objective (``models/lhuc.adapt_lhuc``; against a blocked den each step
    launches the blocked forward and adjoint kernels once); then the
    speaker's test utterances are decoded with the adapted scales through
    ``decode/beam.beam_decode_sparse``.  The reference adapts supervised,
    on the speaker's training utterances.

    Returns {"speakers", "utts", "wer_before", "wer_after"} over the
    decoded utterances (``base_hyps``: their unadapted hypotheses) and
    "max_abs_logit", each speaker's largest adapted |logit| (0 would mean
    LHUC left the model as it was).  ``on_step(metrics)`` sees every LHUC
    step's metrics.  ``l2`` decays the logits toward unit scales."""
    dev = resolve_device(device)
    t0 = time.time()
    left, right = model_context(mc_l)
    fs = mc_l.frame_subsampling_factor
    params = convert.tree_to_device(state_l.params, dev)
    bn_state = convert.tree_to_device(state_l.bn_state, dev)
    den = den_on_device(bundle, dev)
    spk_train = {}
    for i, u in enumerate(bundle.train_utts):
        spk_train.setdefault(u.speaker, []).append(i)
    hyps_l = [None] * len(test)
    max_abs_logit = []
    # one decode length for the stage: every utterance padded to the test
    # set's longest output, rounded up to 64, with repeated edge frames
    t_max = max(len(u.pdf_align) for u in test)
    t_pad_all = ((t_max + 63) // 64) * 64
    need = left + (t_pad_all - 1) * fs + 1 + right
    egs_cfg = EgsConfig(chunk_width=50, left_context=left,
                        right_context=right, max_phones_per_chunk=40)
    speakers = [s for s in sorted({u.speaker for u in test})
                if spk_train.get(s)]
    for spk in speakers:
        idx = spk_train[spk][:10]
        sutts = [bundle.train_utts[i] for i in idx]
        sivs = [bundle.train_ivectors[i] for i in idx] if use_iv else None
        chunks = make_egs(sutts, bundle.lm, topo, tree, egs_cfg,
                          den_fsa=bundle.den_fsa, ivectors=sivs)
        batches = [convert.batch_to_torch(b, dev)
                   for b in lhuc_batches(chunks)]
        lhuc, _ = adapt_lhuc(mc_l, params, bn_state, den, objective_cfg,
                             batches, num_steps=num_steps, lr=lr, l2=l2,
                             on_step=on_step, device=dev)
        max_abs_logit.append(max(float(v.abs().max())
                                 for v in lhuc.values()))
        for i, u in enumerate(test):
            if u.speaker != spk:
                continue
            feats = np.concatenate([
                np.repeat(u.feats[:1], left, 0), u.feats,
                np.repeat(u.feats[-1:], need, 0)])[None, :need]
            iv = (torch.as_tensor(np.asarray(iv_test[i], np.float32)[None],
                                  device=dev) if use_iv else None)
            with torch.inference_mode():
                chain, _, _ = apply_model_lhuc(
                    mc_l, params, bn_state, lhuc,
                    torch.as_tensor(feats, device=dev), iv, train=False)
            obs = chain[0].float().cpu().numpy()
            hyps_l[i] = beam_decode_sparse(
                obs[: len(u.pdf_align)], g, beam=16.0, max_active=10000,
                retry_beam=64.0).words
    done = [i for i, h in enumerate(hyps_l) if h is not None]
    wer_after = score_corpus([refs[i] for i in done],
                             [hyps_l[i] for i in done])["wer"]
    wer_before = score_corpus([refs[i] for i in done],
                              [base_hyps[i] for i in done])["wer"]
    print(f"[lhuc] iv={use_iv} l2={l2} steps={num_steps} ({len(speakers)} "
          f"speakers, {len(done)} utts): WER {wer_before:.2f} -> "
          f"{wer_after:.2f} ({time.time() - t0:.0f}s)", flush=True)
    return {"speakers": len(speakers), "utts": len(done),
            "wer_before": wer_before, "wer_after": wer_after,
            "max_abs_logit": max_abs_logit}


@dataclasses.dataclass
class E2eResult:
    """What ``main`` ran: the setup, stage 4's run (None in "search"
    mode) and the report."""

    setup: Setup
    base: Optional[BaseRun]
    report: Report


def main(argv=None, device=DEFAULT_DEVICE,
         sizes: Optional[E2eSizes] = None) -> E2eResult:
    """``[base|search|all] [--smoke] --out DIR [--cache-dir DIR]``
    (``:718-730``): "all" hands ``run_base``'s model, HCLG and LMs to
    ``run_search``; "search" alone builds its own graph.  ``sizes``
    replaces the preset ``--smoke`` picks."""
    from tdnnf_nas_torch.tools.e2e_search import run_search

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="all",
                    choices=("base", "search", "all"))
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's FLAGSHIP_SMOKE=1 sizes")
    ap.add_argument("--out", required=True,
                    help="directory for the three JSON files")
    ap.add_argument("--cache-dir",
                    help="read and write the bootstrap cache here")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    if sizes is None:
        sizes = E2eSizes.smoke() if args.smoke else E2eSizes.full()
    # a search-only run writes no e2e_flagship.json: its setup's part
    # must not overwrite a base run's file (the reference's :724-729)
    report = Report(args.out, files=(("search",) if args.mode == "search"
                                     else tuple(Report.FILES)))
    setup = build_setup(sizes, cache_dir=args.cache_dir, device=dev,
                        report=report)
    base = None
    if args.mode in ("base", "all"):
        base = run_base(setup, report, device=dev)
    if args.mode in ("search", "all"):
        run_search(setup, base, report, device=dev)
    print("[e2e] stage seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in report.seconds.items()), flush=True)
    return E2eResult(setup=setup, base=base, report=report)


if __name__ == "__main__":
    main()
