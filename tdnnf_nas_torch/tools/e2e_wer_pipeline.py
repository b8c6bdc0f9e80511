"""The word-level WER pipeline and its search table on the card (port of
``scripts/e2e_wer_pipeline.py``).

Stages, as the reference numbers them:

  1 the GMM ladder (mono -> tri -> LDA+MLLT -> SAT/fMLLR) on the
    training utterances, whose alignments replace the generator's;
  2 the 400-leaf left-2 tree from those alignments and ``prepare_data``
    (4-gram phone LM, 500 extra states, 8% dev): a blocked den, so every
    step launches the blocked-den kernels;
  3 LF-MMI training of the 5-layer TDNN-F (900 steps, dropout schedule);
  4 the trigram of half the training transcripts, its HCLG (with
    optional silence in the ``sil`` variant) and the decode with
    lattices;
  5 4-gram lattice rescoring (the 4-gram of all transcripts), then an
    RNNLM (TDNN-splice LSTMP, 400 steps) and its lattice rescoring;
  6 ("search") the two-stage search (``tools/search_planted_table
    .search_table``, gumbel ``alpha_lr_scale`` 10) and the searched /
    random / manual table.

``--variant`` takes the place of the reference's environment switches
(``E2E_HARD``, ``E2E_SILENCE``): ``default``, ``hard`` (1-3 phone
pronunciations, emission noise 3.6) or ``sil`` (optional silence, 31
phones), and fixes the file names the reference writes for it:
``e2e_wer{,_hard,_sil}.json`` (stages 1-5) and
``search_table_e2e{,_hard}.json`` (stage 6; ``sil`` writes the default's
name, as the reference does).  ``E2eWerSizes`` holds the step counts,
utterance counts and the RNNLM's sizes; ``full()`` is the reference's.

Where the port differs from the reference:

- a failing stage raises: the reference's ``except Exception: ...
  skipped`` around the RNNLM stage (``:178-197``) is not kept;
- the files go to ``--out``, never to ``docs/``;
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step;
- the lattices are RNNLM-rescored together by the frontier-batched
  ``rescore_lattices_rnnlm`` (one device call a lattice level), whose
  results are ``rescore_lattice_rnnlm``'s, lattice by lattice (tested);
- a dev split with fewer chunks than the cv-update's batch of 48 caps
  the batch there and prints it (the reference's ``train_model``
  raises).

Kept as the reference has it: "search" alone builds its trigram from all
the training transcripts (``:242-243``), where "all" hands over
``run_base``'s half-transcript trigram and its HCLG.

Usage:
    python3 -m tdnnf_nas_torch.tools.e2e_wer_pipeline [base|search|all]
        [--variant default|hard|sil] --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.synthetic import WordCorpusConfig, make_word_corpus
from tdnnf_nas_torch.decode.graph_sparse import build_hclg_sparse
from tdnnf_nas_torch.decode.lattice import (rescore_lattice,
                                            rescore_lattices_rnnlm)
from tdnnf_nas_torch.decode.scoring import score_corpus
from tdnnf_nas_torch.decode.wfst import Lexicon
from tdnnf_nas_torch.gmm import GmmLadderConfig, MonoHmmConfig
from tdnnf_nas_torch.graphs.tree_cluster import (accumulate_triphone_stats,
                                                 build_clustered_triphone_tree)
from tdnnf_nas_torch.lm.ngram import estimate_ngram_lm
from tdnnf_nas_torch.lm.rnnlm import RnnLMConfig, RnnLMScorer, train_rnnlm
from tdnnf_nas_torch.recipes.chain_recipes import (bootstrap_alignments_gmm,
                                                   decode_corpus_words,
                                                   prepare_data, train_model)
from tdnnf_nas_torch.tools.e2e_flagship import DROPOUT_SCHEDULE, Report
from tdnnf_nas_torch.tools.e2e_search import SEARCH_BATCH
from tdnnf_nas_torch.tools.search_planted_table import (CHUNK, model_config,
                                                        search_table)
from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                   TrainerConfig)

VARIANTS = ("default", "hard", "sil")
SIL_PROB = 0.3  # :67, 153, 246


@dataclasses.dataclass(frozen=True)
class E2eWerSizes:
    """The reference's step counts, utterance counts and RNNLM sizes (its
    line in ``scripts/e2e_wer_pipeline.py`` beside each field).
    ``model_overrides`` are ``TdnnfModelConfig`` fields set on top of the
    5-layer model; ``full()`` leaves it empty."""

    n_test: int  # :37
    num_utts: int  # :62
    train_steps: int  # :131, 134
    rnnlm_embed: int  # :183
    rnnlm_hidden: int  # :184
    rnnlm_proj: int  # :184
    rnnlm_steps: int  # :185
    rnnlm_batch: int  # :186
    pretrain_steps: int  # :257, 259
    cv_steps: int  # :268, 270
    child_steps: int  # :305, 307
    model_overrides: tuple = ()  # ((field, value), ...)

    @classmethod
    def full(cls) -> "E2eWerSizes":
        return cls(n_test=60, num_utts=720, train_steps=900, rnnlm_embed=64,
                   rnnlm_hidden=128, rnnlm_proj=64, rnnlm_steps=400,
                   rnnlm_batch=32, pretrain_steps=500, cv_steps=400,
                   child_steps=700)


def file_names(variant: str) -> dict:
    """The two files a variant writes (``:216-218``, ``:350-351``)."""
    return {"e2e": {"default": "e2e_wer.json", "hard": "e2e_wer_hard.json",
                    "sil": "e2e_wer_sil.json"}[variant],
            "search": ("search_table_e2e_hard.json" if variant == "hard"
                       else "search_table_e2e.json")}


def corpus_config(variant: str, sizes: E2eWerSizes) -> WordCorpusConfig:
    """The variant's corpus (``:60-67``)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    hard, sil = variant == "hard", variant == "sil"
    return WordCorpusConfig(
        vocab_size=300, num_phones=31 if sil else 30, feat_dim=24,
        num_utts=sizes.num_utts,
        min_words=4, max_words=12,
        min_pron=1 if hard else 2, max_pron=3 if hard else 5, mean_dur=3.5,
        emission_noise=3.6 if hard else 1.3,
        context_shift=1.0, num_speakers=8,
        speaker_shift=1.0, silence_prob=SIL_PROB if sil else 0.0, seed=0)


def ladder_config() -> GmmLadderConfig:
    """The GMM ladder (``:77-80``)."""
    return GmmLadderConfig(
        mono=MonoHmmConfig(num_iters=8, max_mix=2, mix_up_iters=(4,)),
        tri_leaves=120, tri_em_iters=6, splice_context=2, lda_dim=20,
        lda_mllt_em_iters=5, sat_em_iters=4)


def trainer_config(num_steps: int) -> TrainerConfig:
    """Stage 3's Adam with the dropout schedule (``:128-132``)."""
    return TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1.5e-3,
                                  lr_final=2e-4, num_steps=num_steps),
        dropout_schedule=DROPOUT_SCHEDULE)


@dataclasses.dataclass
class WerSetup:
    """Stages 1-2 (``build_setup``'s tuple, ``:96``)."""

    variant: str
    sizes: E2eWerSizes
    cfg: WordCorpusConfig
    prons: dict
    word_seqs: list
    bundle: object
    tree: object
    topo: object
    test: list
    train: list
    fmllr_gain: float


@dataclasses.dataclass
class WerBase:
    """Stage 3's model and state, and stage 4's HCLG, which
    ``run_search`` decodes on in "all" mode (``:221``)."""

    model_cfg: object
    state: object
    g: object


def build_setup(variant: str, sizes: E2eWerSizes,
                report: Optional[Report] = None,
                device=DEFAULT_DEVICE) -> WerSetup:
    """Stages 1-2 (``:47-96``): the corpus, the GMM ladder on ``device``
    over the training utterances, the tree and ``prepare_data`` from the
    bootstrapped alignments."""
    dev = resolve_device(device)
    report = report if report is not None else Report()
    cfg = corpus_config(variant, sizes)
    with report.stage("0 corpus"):
        utts, prons, word_seqs, _, _, topo = make_word_corpus(cfg)
    test, train = utts[:sizes.n_test], utts[sizes.n_test:]
    train_phones = [u.phones for u in train]
    with report.stage("1 GMM ladder"):
        _, ladder = bootstrap_alignments_gmm(
            train, train_phones, cfg.num_phones,
            speakers=[u.speaker for u in train], ladder_cfg=ladder_config(),
            device=dev)
    print(f"[1] GMM ladder: fmllr_gain={ladder.fmllr_gain:.3f} "
          f"({report.seconds['1 GMM ladder']:.0f}s)", flush=True)
    with report.stage("2 tree and den"):
        stats = accumulate_triphone_stats(
            [u.feats for u in train], train_phones,
            [u.begins for u in train], cfg.num_phones,
            cfg.frame_subsampling_factor)
        tree = build_clustered_triphone_tree(stats, num_leaves=400)
        bundle = prepare_data(train, train_phones, tree, topo,
                              cfg.num_phones, dev_fraction=0.08,
                              phone_lm_order=4, num_extra_lm_states=500)
    print(f"[2] tree {tree.num_pdfs} pdfs; den S="
          f"{bundle.den_fsa.num_states}", flush=True)
    return WerSetup(variant=variant, sizes=sizes, cfg=cfg, prons=prons,
                    word_seqs=word_seqs, bundle=bundle, tree=tree,
                    topo=topo, test=test, train=train,
                    fmllr_gain=float(ladder.fmllr_gain))


def word_symbols(cfg: WordCorpusConfig) -> list:
    return [f"w{w}" for w in range(cfg.vocab_size)]


def build_hclg(setup: WerSetup, lm3, word_sym):
    """The trigram HCLG, silence-aware in the ``sil`` variant
    (``:151-153``, ``:244-246``)."""
    sil = setup.variant == "sil"
    return build_hclg_sparse(Lexicon(setup.prons), lm3, word_sym,
                             setup.topo, setup.tree,
                             sil_phone=setup.cfg.silence_phone,
                             sil_prob=SIL_PROB if sil else 0.0)


def decode(setup: WerSetup, mc, state, g, lattice: bool = False,
           device=DEFAULT_DEVICE) -> dict:
    """``decode_corpus_words`` of the test set as both stages call it
    (beam 15, 2 forked workers; with ``lattice``, lattice beam 8)."""
    kw = dict(lattice=True, lattice_beam=8.0) if lattice else {}
    return decode_corpus_words(setup.bundle, mc, state, g, setup.test,
                               acoustic_scale=1.0, beam=15.0, num_workers=2,
                               device=device, **kw)


def run_base(setup: WerSetup, report: Optional[Report] = None,
             device=DEFAULT_DEVICE) -> WerBase:
    """Stages 3-5 on ``setup`` (``:109-221``); writes the variant's
    ``e2e_wer*.json``.  Every stage's failure propagates."""
    dev = resolve_device(device)
    report = report if report is not None else Report()
    sizes, cfg = setup.sizes, setup.cfg
    mc = model_config(setup.tree.num_pdfs, cfg.feat_dim,
                      sizes.model_overrides)
    n = sizes.train_steps
    with report.stage("3 train"):
        state, metrics = train_model(setup.bundle, mc, trainer_config(n), n,
                                     batch_size=SEARCH_BATCH,
                                     chunk_width=CHUNK, seed=0,
                                     log_every=100, device=dev)
        report.trained("train", metrics)
    objf = metrics.last("objf_mmi")
    print(f"[3] train objf_mmi={objf:.4f}", flush=True)

    # the first-pass trigram sees half the transcripts, the rescoring
    # 4-gram all of them (the reference's sw1_tg vs sw1_fsh_fg split,
    # :142-149)
    word_sym = word_symbols(cfg)
    train_text = [[word_sym[w] for w in ws]
                  for ws in setup.word_seqs[sizes.n_test:]]
    lm3 = estimate_ngram_lm(train_text[: len(train_text) // 2], order=3)
    lm4 = estimate_ngram_lm(train_text, order=4)
    with report.stage("4 HCLG"):
        g = build_hclg(setup, lm3, word_sym)
    print(f"[4] HCLG: {g.num_states} states, {g.num_arcs} arcs", flush=True)
    with report.stage("4 decode"):
        rep = decode(setup, mc, state, g, lattice=True, device=dev)
    print(f"[4] first-pass (tg) WER={rep['wer']:.2f}%", flush=True)

    wtt = lambda w: word_sym[w]
    refs = [list(u.words) for u in setup.test]
    with report.stage("5 4-gram rescore"):
        hyps4 = []
        for lat in rep["lattices"]:
            best = rescore_lattice(lat, lm3, lm4, lm_scale=1.0,
                                   word_to_token=wtt, n=1)
            hyps4.append(best[0][0] if best else [])
    wer_fg = score_corpus(refs, hyps4)["wer"]
    print(f"[5] +4-gram rescore WER={wer_fg:.2f}%", flush=True)

    with report.stage("5 rnnlm"):
        # the TDNN-LSTMP rescorer's shape (embed / cell / rpd + splice) at
        # reduced scale
        rl_cfg = RnnLMConfig(vocab_size=cfg.vocab_size,
                             embed_dim=sizes.rnnlm_embed,
                             hidden_dim=sizes.rnnlm_hidden,
                             proj_dim=sizes.rnnlm_proj, tdnn_splice=True)
        rnn_params, _ = train_rnnlm(setup.word_seqs[sizes.n_test:], rl_cfg,
                                    num_steps=sizes.rnnlm_steps,
                                    batch_size=sizes.rnnlm_batch, seed=0,
                                    device=dev)
        bests = rescore_lattices_rnnlm(rep["lattices"], lm3,
                                       RnnLMScorer(rl_cfg, rnn_params),
                                       lm_scale=1.0, interp_weight=0.5,
                                       word_to_token=wtt, n=1)
        hyps_r = [b[0][0] if b else [] for b in bests]
    wer_rnn = score_corpus(refs, hyps_r)["wer"]
    print(f"[5] +RNNLM rescore WER={wer_rnn:.2f}%", flush=True)

    report.e2e = {
        "corpus": {"vocab": cfg.vocab_size, "phones": cfg.num_phones,
                   "train_utts": len(setup.train),
                   "test_utts": len(setup.test),
                   "noise": cfg.emission_noise,
                   "speakers": cfg.num_speakers},
        "gmm_bootstrap": True,
        "silence": setup.variant == "sil",
        "tree_pdfs": int(setup.tree.num_pdfs),
        "den_states": int(setup.bundle.den_fsa.num_states),
        "train_objf_mmi": round(float(objf), 4),
        "hclg_states": int(g.num_states),
        "wer_first_pass_tg": round(rep["wer"], 2),
        "wer_4gram_rescore": round(wer_fg, 2),
        "wer_rnnlm_rescore": round(wer_rnn, 2),
    }
    report.save("e2e")
    print(json.dumps(report.e2e), flush=True)
    return WerBase(model_cfg=mc, state=state, g=g)


def run_search(setup: WerSetup, base: Optional[WerBase] = None,
               report: Optional[Report] = None,
               device=DEFAULT_DEVICE) -> dict:
    """Stage 6 (``:224-354``) on ``setup``, with ``base``'s HCLG; without
    one, the trigram of all the training transcripts and its HCLG.
    Writes and returns the variant's ``search_table_e2e*.json``."""
    dev = resolve_device(device)
    report = report if report is not None else Report()
    sizes = setup.sizes
    if base is None:
        word_sym = word_symbols(setup.cfg)
        lm3 = estimate_ngram_lm(
            [[word_sym[w] for w in ws]
             for ws in setup.word_seqs[sizes.n_test:]], order=3)
        with report.stage("6 HCLG"):
            g = build_hclg(setup, lm3, word_sym)
    else:
        g = base.g
    mc = model_config(setup.tree.num_pdfs, setup.cfg.feat_dim,
                      sizes.model_overrides)
    res = search_table(
        setup.bundle, mc,
        lambda ccfg, st: decode(setup, ccfg, st, g, device=dev),
        (sizes.pretrain_steps, sizes.cv_steps, sizes.child_steps), 10.0,
        report, "6", device=dev)
    table = {name: {k: v for k, v in row.items() if k != "lookahead_reach"}
             for name, row in res.table.items()}
    report.search = {
        "alpha_entropy": round(res.ent, 3),
        "alpha_entropy_uniform": round(res.uniform_ent, 3),
        "top1_logprob": res.top1_logprob,
        "table": table,
    }
    report.save("search")
    print(json.dumps(report.search), flush=True)
    return report.search


@dataclasses.dataclass
class WerResult:
    """What ``main`` ran: the set-up, stage 3-5's run (None in "search"
    mode) and the report."""

    setup: WerSetup
    base: Optional[WerBase]
    report: Report


def main(argv=None, device=DEFAULT_DEVICE,
         sizes: Optional[E2eWerSizes] = None) -> WerResult:
    """``[base|search|all] [--variant V] --out DIR`` (``:358-363``): "all"
    hands ``run_base``'s HCLG (of its half-transcript trigram) to
    ``run_search``.  ``sizes``
    replaces ``E2eWerSizes.full()``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="all",
                    choices=("base", "search", "all"))
    ap.add_argument("--variant", default="default", choices=VARIANTS,
                    help="the reference's E2E_HARD=1 (hard) or "
                    "E2E_SILENCE=1 (sil) corpus, or neither")
    ap.add_argument("--out", required=True,
                    help="directory for the variant's JSON files")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    sizes = E2eWerSizes.full() if sizes is None else sizes
    files = {"base": ("e2e",), "search": ("search",),
             "all": ("e2e", "search")}[args.mode]
    report = Report(args.out, files=files, names=file_names(args.variant))
    setup = build_setup(args.variant, sizes, report, device=dev)
    base = None
    if args.mode in ("base", "all"):
        base = run_base(setup, report, device=dev)
    if args.mode in ("search", "all"):
        run_search(setup, base, report, device=dev)
    print("[e2e-wer] stage seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in report.seconds.items()), flush=True)
    return WerResult(setup=setup, base=base, report=report)


if __name__ == "__main__":
    main()
