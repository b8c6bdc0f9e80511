"""Searched, random and manual architectures under one budget on the
planted-lookahead word corpus (port of ``scripts/search_planted_table.py``).

The corpus writes each phone pair's identity into its last 10 feature
dims late by a ladder of lags (2, 5, ..., 17 output frames), so a child
resolves a pair only when its lookahead (lda splice 1 + its affine
strides + the numerator's 2) reaches the pair's lag.  Set-up uses the
generator's alignments (the GMM bootstrap is ``tools/e2e_wer_pipeline``'s):
the 400-leaf left-2 tree, ``prepare_data`` (4-gram phone LM, 500 extra
states, 8% dev: a blocked den, so every step launches the blocked-den
kernels), the trigram of the training transcripts and its HCLG.  Then
``search_table``: uniform pretraining of the offsets supernet (5 layers,
strides 0-3), a gumbel alpha-only cv-update on the dev split
(``alpha_lr_scale`` 30), top-1 extraction, and the searched, a random
(``RandomState(123)``) and the manual (1, 1, 3, 3, 3) child, each
retrained at one budget, scored on the first 4 dev batches and decoded.
Writes ``search_table.json`` with the reference's keys and rounding into
``--out``.

Where the port differs from the reference:

- the sizes are an argument (``TableSizes.preset(quick)``: 240
  utterances and 120 / 200 / 150 steps, else 720 and 500 / 700 / 700),
  not a read of ``sys.argv``;
- the file goes to ``--out``, never to ``docs/``;
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step;
- a dev split with fewer chunks than the cv-update's batch of 48 caps
  the batch there and prints it (the reference's ``train_model``
  raises).

Usage:
    python3 -m tdnnf_nas_torch.tools.search_planted_table [quick] --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.synthetic import WordCorpusConfig, make_word_corpus
from tdnnf_nas_torch.decode.graph_sparse import build_hclg_sparse
from tdnnf_nas_torch.decode.wfst import Lexicon
from tdnnf_nas_torch.graphs.tree_cluster import (accumulate_triphone_stats,
                                                 build_clustered_triphone_tree)
from tdnnf_nas_torch.lm.ngram import estimate_ngram_lm
from tdnnf_nas_torch.models import (DartsModelConfig, SearchMode,
                                    TdnnfModelConfig)
from tdnnf_nas_torch.nas import child_config_from_arch, extract_offsets
from tdnnf_nas_torch.recipes.chain_recipes import (decode_corpus_words,
                                                   prepare_data, train_model)
from tdnnf_nas_torch.tools.e2e_flagship import Report
from tdnnf_nas_torch.tools.e2e_search import (MAX_STRIDE, SEARCH_BATCH,
                                              alpha_arrays, child_row,
                                              cv_batch_size, mean_entropy,
                                              rand_arch)
from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                   TrainerConfig)

N_TEST = 60  # :43
LAGS = (2, 5, 8, 11, 14, 17)  # :44
CHUNK = 24  # :114, 126, 165
VALID_BATCHES = 4  # :170
BASE_OPT = dict(kind="adam", lr_initial=1.5e-3, lr_final=2e-4)  # :103
FILE = "search_table.json"
DIAGNOSIS_ROUND3 = (
    "The round-3 table (searched 2.85 > random 2.24 > manual 1.83 "
    "WER) came from a corpus with NO temporal structure: alpha "
    "stayed at entropy 1.381 vs uniform 1.386, so the extracted "
    "top-1 was posterior noise (it even drew a (0,0) final layer) "
    "and 'searched' was a worse-than-average random draw.  With "
    "per-phone-class lookahead lags planted (the structure real "
    "speech has), the same pipeline concentrates alpha and the "
    "searched child must beat manual; see this table.")  # :200-208


@dataclasses.dataclass(frozen=True)
class TableSizes:
    """The table's utterance and step counts (the reference's line beside
    each field).  ``n_decode`` decodes only the first utterances of the
    test split (None: all of it); ``model_overrides`` are
    ``TdnnfModelConfig`` fields set on top of the manual model.  The
    presets leave both unset."""

    num_utts: int  # :70
    n_test: int  # :43
    pretrain_steps: int  # :107
    cv_steps: int  # :107
    child_steps: int  # :107
    n_decode: Optional[int] = None
    model_overrides: tuple = ()  # ((field, value), ...)

    @classmethod
    def preset(cls, quick: bool) -> "TableSizes":
        steps = (120, 200, 150) if quick else (500, 700, 700)
        return cls(240 if quick else 720, N_TEST, *steps)

    @property
    def steps(self) -> tuple:
        return self.pretrain_steps, self.cv_steps, self.child_steps


def corpus_config(num_utts: int) -> WordCorpusConfig:
    """The planted-lookahead corpus (``:69-75``)."""
    return WordCorpusConfig(
        vocab_size=300, num_phones=30, feat_dim=32, num_utts=num_utts,
        min_words=4, max_words=12, min_pron=2, max_pron=5, mean_dur=3.5,
        emission_noise=1.3, context_shift=1.0, num_speakers=8,
        speaker_shift=1.0,
        lookahead_lags=LAGS, lookahead_dim=10, lookahead_scale=2.0, seed=0)


def model_config(num_pdfs: int, feat_dim: int,
                 overrides=()) -> TdnnfModelConfig:
    """The manual 5-layer TDNN-F, strides (1, 1, 3, 3, 3) (``:98-102``;
    ``scripts/e2e_wer_pipeline.py:99-106`` too), ``overrides`` on top
    (the tests narrow it)."""
    return TdnnfModelConfig(
        feat_dim=feat_dim, ivector_dim=0, hidden_dim=512,
        bottleneck_dim=128, time_strides=(1, 1, 3, 3, 3),
        num_pdfs=num_pdfs, prefinal_big=512, prefinal_small=192,
        compute_dtype="bfloat16").replace(**dict(overrides))


@dataclasses.dataclass
class TableSetup:
    """The corpus, its oracle-alignment tree and den, and the HCLG."""

    cfg: WordCorpusConfig
    test: list
    train: list
    tree: object
    bundle: object
    g: object


def build_setup(cfg: WordCorpusConfig, n_test: int = N_TEST,
                report: Optional[Report] = None) -> TableSetup:
    """``:69-96`` on the host: the corpus, the 400-leaf left-2 tree from
    the generator's alignments, ``prepare_data`` (8% dev, 4-gram, 500
    extra LM states), the trigram of the training transcripts and the
    HCLG."""
    report = report if report is not None else Report()
    with report.stage("corpus"):
        utts, prons, word_seqs, _, _, topo = make_word_corpus(cfg)
    test, train = utts[:n_test], utts[n_test:]
    train_phones = [u.phones for u in train]
    p = cfg.num_phones
    with report.stage("tree"):
        stats = accumulate_triphone_stats(
            [u.feats for u in train], train_phones,
            [u.begins for u in train], p, cfg.frame_subsampling_factor)
        tree = build_clustered_triphone_tree(stats, num_leaves=400)
    with report.stage("den"):
        bundle = prepare_data(train, train_phones, tree, topo, p,
                              dev_fraction=0.08, phone_lm_order=4,
                              num_extra_lm_states=500)
    print(f"[setup] tree {tree.num_pdfs} pdfs, den S="
          f"{bundle.den_fsa.num_states}", flush=True)
    with report.stage("HCLG"):
        word_sym = [f"w{w}" for w in range(cfg.vocab_size)]
        lm3 = estimate_ngram_lm(
            [[word_sym[w] for w in ws] for ws in word_seqs[n_test:]],
            order=3)
        g = build_hclg_sparse(Lexicon(prons), lm3, word_sym, topo, tree)
    return TableSetup(cfg=cfg, test=test, train=train, tree=tree,
                      bundle=bundle, g=g)


@dataclasses.dataclass
class TableSearch:
    """What ``search_table`` found: the cv-update's alphas (linear,
    affine), their mean entropy and its uniform value, the affine softmax
    per layer, the top-1's log-probability and the table of children."""

    alphas: tuple
    ent: float
    uniform_ent: float
    p_aff: np.ndarray
    top1_logprob: float
    table: dict


def search_table(bundle, mc: TdnnfModelConfig, decode_fn, steps,
                 alpha_lr_scale: float, report: Report, tag: str,
                 device=DEFAULT_DEVICE) -> TableSearch:
    """The two-stage search and its table at batch 48, 24-frame chunks
    (``:106-185``; ``scripts/e2e_wer_pipeline.py:264-340``): ``steps`` =
    (pretrain, cv-update, child) steps; ``decode_fn(ccfg, state)`` decodes
    a child.  Steps are recorded as ``supernet``, ``cv`` and
    ``child_<name>``, stage seconds under ``tag``."""
    n_pre, n_cv, n_child = steps
    darts = DartsModelConfig(base=mc, search_offsets=True,
                             max_stride=MAX_STRIDE)
    pre_tc = TrainerConfig(
        train_theta=True, train_alpha=False, search_mode=SearchMode.UNIFORM,
        optimizer=OptimizerConfig(num_steps=n_pre, **BASE_OPT))
    with report.stage(f"{tag} pretrain"):
        sup, m = train_model(bundle, darts, pre_tc, n_pre,
                             batch_size=SEARCH_BATCH, chunk_width=CHUNK,
                             seed=0, supernet=True, log_every=100,
                             device=device)
        report.trained("supernet", m)
    cv_tc = TrainerConfig(
        train_theta=False, train_alpha=True, bn_frozen=True,
        search_mode=SearchMode.GUMBEL,
        optimizer=OptimizerConfig(num_steps=n_cv,
                                  alpha_lr_scale=alpha_lr_scale, **BASE_OPT))
    with report.stage(f"{tag} cv-update"):
        sup, m = train_model(bundle, darts, cv_tc, n_cv,
                             batch_size=cv_batch_size(bundle, darts, CHUNK,
                                                      tag),
                             chunk_width=CHUNK, seed=1, supernet=True,
                             init_state=sup, dev=True, log_every=100,
                             device=device)
        report.trained("cv", m)
    a_lin, a_aff = alpha_arrays(sup)
    del sup
    p_aff = np.exp(a_aff) / np.exp(a_aff).sum(-1, keepdims=True)
    ent = (mean_entropy(a_lin) + mean_entropy(a_aff)) / 2
    uniform_ent = float(np.log(a_lin.shape[-1]))
    print(f"[{tag}] alpha entropy {ent:.3f} vs uniform {uniform_ent:.3f}; "
          f"affine softmax per layer:\n{np.round(p_aff, 3)}", flush=True)

    archs = extract_offsets(a_lin, a_aff, top_k=1)
    top1 = archs[0][0]
    contenders = {
        "searched_top1": child_config_from_arch(mc, stride_pairs=top1),
        "random_arch": child_config_from_arch(
            mc, stride_pairs=rand_arch(123, len(top1))),
        "manual_baseline": mc,
    }
    table = {}
    for name, ccfg in contenders.items():
        tc = TrainerConfig(
            objective=ChainObjectiveConfig(),
            optimizer=OptimizerConfig(num_steps=n_child, **BASE_OPT))
        with report.stage(f"{tag} child {name}"):
            table[name] = child_row(bundle, ccfg, tc, n_child, report, name,
                                    batch_size=SEARCH_BATCH,
                                    chunk_width=CHUNK,
                                    valid_batches=VALID_BATCHES,
                                    decode_fn=decode_fn, device=device)
        print(f"[{tag}] {name}: {table[name]}", flush=True)
    return TableSearch(alphas=(a_lin, a_aff), ent=ent,
                       uniform_ent=uniform_ent, p_aff=p_aff,
                       top1_logprob=float(archs[0][1]), table=table)


@dataclasses.dataclass
class TableResult:
    """What ``main`` ran: its set-up, the manual model config, the search
    and the report (``search`` holds the file)."""

    setup: TableSetup
    model_cfg: TdnnfModelConfig
    search: TableSearch
    report: Report


def main(quick: bool = False, out=None, device=DEFAULT_DEVICE,
         sizes: Optional[TableSizes] = None) -> TableResult:
    """The table (``:47-215``) at the ``quick`` or the full sizes, or at
    ``sizes`` where given; writes ``search_table.json`` into ``out`` when
    given."""
    dev = resolve_device(device)
    t_all = time.time()
    report = Report(out, names={"search": FILE})
    sizes = TableSizes.preset(quick) if sizes is None else sizes
    cfg = corpus_config(sizes.num_utts)
    setup = build_setup(cfg, sizes.n_test, report=report)
    mc = model_config(setup.tree.num_pdfs, cfg.feat_dim,
                      sizes.model_overrides)
    test = setup.test[:sizes.n_decode]

    def decode(ccfg, st):
        return decode_corpus_words(setup.bundle, ccfg, st, setup.g, test,
                                   acoustic_scale=1.0, beam=15.0,
                                   num_workers=2, device=dev)

    res = search_table(setup.bundle, mc, decode, sizes.steps, 30.0, report,
                       "table", device=dev)
    report.search = {
        "corpus": {"vocab": cfg.vocab_size, "phones": cfg.num_phones,
                   "lookahead_lags": list(cfg.lookahead_lags),
                   "lookahead_dim": cfg.lookahead_dim,
                   "train_utts": len(setup.train),
                   "test_utts": len(test)},
        "alpha_entropy": round(res.ent, 3),
        "alpha_entropy_uniform": round(res.uniform_ent, 3),
        "affine_softmax": [[round(float(x), 3) for x in row]
                           for row in res.p_aff],
        "top1_logprob": res.top1_logprob,
        "table": res.table,
        "diagnosis_round3": DIAGNOSIS_ROUND3,
        "seconds": round(time.time() - t_all),
    }
    report.save("search")
    print(json.dumps(report.search), flush=True)
    return TableResult(setup=setup, model_cfg=mc, search=res, report=report)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("preset", nargs="?", choices=("quick",),
                    help="the reference's quick step counts and 240 utts")
    ap.add_argument("--out", required=True,
                    help="directory for search_table.json")
    args = ap.parse_args()
    main(quick=args.preset == "quick", out=args.out)
