"""Left-1, left-2 and +-1 triphone trees at one leaf budget on the card
(port of ``scripts/context_compare.py``).

On one word corpus, one set of alignments, one model and one training
budget, only the tree differs, and with it the den composition and the
decoding graph:

  left1  the biphone tree (``build_clustered_tree``);
  left2  the left-2 triphone tree (``build_clustered_triphone_tree``);
  pm1    the +-1 cross-triphone tree, whose committed den carries the
         wildcard term (``build_clustered_cross_triphone_tree``).

Each contender takes the trigram-composed den (300 extra LM states), so
every step launches the blocked-den kernels; each row reports the
clustering data log-likelihood a frame, the den's and the HCLG's size,
the train and dev objf (6 valid batches of 16, chunks of at most 40
phones), the first-pass WER of the first 60 utterances and the seconds.
``--mode`` takes the place of the reference's ``sys.argv[1]``:
``default`` (the left-coloured corpus), ``sym`` (symmetric +-1
coarticulation) or ``symhard`` (the same at emission noise 3.2 and 1-3
phone pronunciations), and picks the reference's file name for it
(``FILES``).  ``CompareSizes`` holds the utterance counts, the leaf
budget and the steps; ``full()`` is the reference's.

The contender loop is written once here (``contender_host`` then
``contender_row``) and shared with ``tools/wpd_compare``, which differs
in the ``ContenderPlan`` it passes.  ``build_world`` is the whole host
set-up (corpus, trigram, each contender's tree, den and HCLG); ``main``
takes it prebuilt (``chip_smoke.py`` builds it in a worker process).

Where the port differs from the reference:

- the file goes to ``--out``, never to ``docs/``;
- the resume from an existing file in ``--out`` (``:127-133``) is kept,
  but a file that exists and cannot be read raises (the reference
  ignores it and starts over); only the missing contenders' trees are
  built;
- each contender's HCLG is built with its tree, before training (it
  depends on neither the model nor the steps); ``seconds`` counts the
  den, the HCLG, training, the valid steps and the decode, as the
  reference's does;
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step.

Usage:
    python3 -m tdnnf_nas_torch.tools.context_compare
        [--mode default|sym|symhard] --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.synthetic import WordCorpusConfig, make_word_corpus
from tdnnf_nas_torch.decode.graph_sparse import build_hclg_sparse
from tdnnf_nas_torch.decode.wfst import Lexicon
from tdnnf_nas_torch.graphs.tree_cluster import (
    _loglike, accumulate_cross_triphone_stats, accumulate_tree_stats,
    accumulate_triphone_stats, build_clustered_cross_triphone_tree,
    build_clustered_tree, build_clustered_triphone_tree)
from tdnnf_nas_torch.lm.ngram import estimate_ngram_lm
from tdnnf_nas_torch.models import TdnnfModelConfig
from tdnnf_nas_torch.recipes.chain_recipes import (decode_corpus_words,
                                                   prepare_data, train_model)
from tdnnf_nas_torch.tools.e2e_flagship import Report
from tdnnf_nas_torch.tools.e2e_search import dev_objf
from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                   TrainerConfig)

MODES = ("default", "sym", "symhard")
FILES = {"default": "context_compare.json",  # :124-126
         "sym": "context_compare_sym.json",
         "symhard": "context_compare_symhard.json"}
CONTENDERS = ("left1", "left2", "pm1")  # :107-116

# tree kind: (statistics, clustering)
TREES = {
    "left1": (accumulate_tree_stats, build_clustered_tree),
    "left2": (accumulate_triphone_stats, build_clustered_triphone_tree),
    "pm1": (accumulate_cross_triphone_stats,
            build_clustered_cross_triphone_tree),
}


@dataclasses.dataclass(frozen=True)
class ContenderPlan:
    """What the comparison drivers' contender loops differ in: the leaf
    budget, ``prepare_data``'s dev share and extra LM states (trigram
    phone LM in both), the batch and chunk, the valid batches and their
    chunks' phone cap, the decode beam, the training log interval, the
    row's fields and whether its seconds count the tree."""

    leaves: int
    dev_fraction: float
    extra_lm_states: int
    batch_size: int
    chunk_width: int
    valid_batches: int
    valid_max_phones: int
    beam: float
    log_every: int
    fields: tuple
    seconds_with_tree: bool


ROW_FIELDS = ("pdfs", "cluster_ll_per_frame", "den_states", "den_arcs",
              "train_objf", "dev_objf", "hclg_states", "wer", "seconds")


@dataclasses.dataclass(frozen=True)
class CompareSizes:
    """The reference's sizes (its line in ``scripts/context_compare.py``
    beside each field); ``model_overrides`` are ``TdnnfModelConfig``
    fields set on top of the contenders' model."""

    num_utts: int  # :66
    n_test: int  # :74
    leaves: int  # :30
    steps: int  # :31
    model_overrides: tuple = ()  # ((field, value), ...)

    @classmethod
    def full(cls) -> "CompareSizes":
        return cls(num_utts=720, n_test=60, leaves=400, steps=800)


def plan(sizes: CompareSizes) -> ContenderPlan:
    """This driver's contender loop (``:138-176``; 6 valid batches,
    ``:158``)."""
    return ContenderPlan(
        leaves=sizes.leaves, dev_fraction=0.05, extra_lm_states=300,
        batch_size=48, chunk_width=40, valid_batches=6,
        valid_max_phones=40, beam=16.0, log_every=200, fields=ROW_FIELDS,
        seconds_with_tree=False)


def corpus_config(mode: str, num_utts: int) -> WordCorpusConfig:
    """The mode's corpus (``:65-72``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    sym, hard = mode in ("sym", "symhard"), mode == "symhard"
    return WordCorpusConfig(
        vocab_size=300, num_phones=30, feat_dim=24, num_utts=num_utts,
        min_words=4, max_words=12,
        min_pron=1 if hard else 2, max_pron=3 if hard else 5, mean_dur=3.5,
        emission_noise=3.2 if hard else 1.3,
        context_shift=0.8 if sym else 1.0,
        right_context_shift=0.8 if sym else 0.0,
        num_speakers=8, speaker_shift=1.0, seed=0)


def corpus_note(mode: str) -> str:
    """The file's ``corpus`` string (``:119-122``)."""
    if mode == "default":
        return "e2e_wer 300-vocab (left-1 coarticulation only)"
    return ("300-vocab, symmetric +-1 coarticulation"
            + (", hard (noise 3.2, prons 1-3)" if mode == "symhard" else ""))


def model_config(num_pdfs: int, overrides=()) -> TdnnfModelConfig:
    """The contenders' bf16 TDNN-F (``:141-145``)."""
    return TdnnfModelConfig(
        feat_dim=24, ivector_dim=0, num_pdfs=num_pdfs, hidden_dim=512,
        bottleneck_dim=64, prefinal_big=512, prefinal_small=192,
        time_strides=(1, 1, 3, 3, 3)).replace(**dict(overrides))


def trainer_config(steps: int) -> TrainerConfig:
    """Adam 1e-3 -> 1e-4 (``:146-149``)."""
    return TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=1e-4, num_steps=steps))


def cluster_ll(stats, table) -> float:
    """Data log-likelihood a frame of the clustered leaves (``:87-105``):
    the forward-state statistics grouped by their leaf in the flat table."""
    p, rest = stats.counts.shape[0], int(np.prod(stats.counts.shape[1:]))
    d = stats.sums.shape[-1]
    table = np.asarray(table).ravel()
    cnt = stats.counts.reshape(p * rest)
    sm = stats.sums.reshape(p * rest, d)
    ssq = stats.sumsqs.reshape(p * rest, d)
    ll, n_tot = 0.0, 0.0
    leaves = {}
    for i in range(p * rest):
        if cnt[i] > 0:
            leaves.setdefault(int(table[i]), []).append(i)
    for ids in leaves.values():
        n = float(cnt[ids].sum())
        ll += _loglike(n, sm[ids].sum(0), ssq[ids].sum(0))
        n_tot += n
    return ll / max(n_tot, 1.0)


def build_tree(kind: str, train, num_phones: int, fs: int, leaves: int):
    """(tree, clustering log-likelihood a frame) of tree ``kind`` from the
    training utterances' alignments."""
    accumulate, build = TREES[kind]
    stats = accumulate([u.feats for u in train], [u.phones for u in train],
                       [u.begins for u in train], num_phones, fs)
    tree = build(stats, num_leaves=leaves)
    return tree, cluster_ll(stats, tree._fwd_table)


@dataclasses.dataclass
class ContenderHost:
    """A contender's host set-up: its tree and the tree's clustering
    log-likelihood a frame, the ``prepare_data`` bundle, the HCLG, and
    each piece's seconds ({"tree", "den", "hclg"})."""

    tree: object
    cluster_ll: float
    bundle: object
    g: object
    seconds: dict


def contender_host(kind: str, train, prons, topo, num_phones: int, fs: int,
                   lm3, word_sym, cplan: ContenderPlan) -> ContenderHost:
    """The host half of a contender: tree ``kind``, ``prepare_data``
    (trigram phone LM, the plan's extra states and dev share: a blocked
    den, with the wildcard term for ``pm1``) and the trigram HCLG."""
    secs = {}
    t0 = time.perf_counter()
    tree, ll = build_tree(kind, train, num_phones, fs, cplan.leaves)
    secs["tree"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = prepare_data(train, [u.phones for u in train], tree, topo,
                          num_phones, dev_fraction=cplan.dev_fraction,
                          phone_lm_order=3,
                          num_extra_lm_states=cplan.extra_lm_states)
    secs["den"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = build_hclg_sparse(Lexicon(prons), lm3, word_sym, topo, tree)
    secs["hclg"] = time.perf_counter() - t0
    return ContenderHost(tree=tree, cluster_ll=ll, bundle=bundle, g=g,
                         seconds=secs)


def contender_row(host: ContenderHost, mc, tc, steps: int, test,
                  cplan: ContenderPlan, report: Report, name: str,
                  device=DEFAULT_DEVICE) -> dict:
    """The device half of a contender: ``steps`` of ``train_model``
    (seed 0), the dev objf over the plan's valid batches, the first-pass
    decode of ``test`` (max_active 7,000, 2 forked workers).  Returns the
    row with the plan's fields, rounded as the references write them; its
    steps are recorded as ``name``."""
    t0 = time.perf_counter()
    bundle = host.bundle
    state, mets = train_model(bundle, mc, tc, steps,
                              batch_size=cplan.batch_size,
                              chunk_width=cplan.chunk_width, seed=0,
                              log_every=cplan.log_every, device=device)
    report.trained(name, mets)
    d_objf = dev_objf(bundle, mc, tc, state, report, cplan.chunk_width,
                      cplan.valid_batches, cplan.valid_max_phones,
                      device=device)
    rep = decode_corpus_words(bundle, mc, state, host.g, test,
                              acoustic_scale=1.0, beam=cplan.beam,
                              max_active=7000, num_workers=2, device=device)
    secs = (time.perf_counter() - t0 + host.seconds["den"]
            + host.seconds["hclg"]
            + (host.seconds["tree"] if cplan.seconds_with_tree else 0.0))
    row = {
        "pdfs": int(host.tree.num_pdfs),
        "cluster_ll_per_frame": round(host.cluster_ll, 4),
        "den_states": int(bundle.den_fsa.num_states),
        "den_arcs": int(len(bundle.den_fsa.arc_w)),
        "train_objf": round(mets.last("objf_mmi"), 4),
        "dev_objf": round(d_objf, 4),
        "hclg_states": int(host.g.num_states),
        "wer": round(rep["wer"], 2),
        "seconds": round(secs),
    }
    return {k: row[k] for k in cplan.fields}


@dataclasses.dataclass
class CompareWorld:
    """The host set-up of a run: the corpus config, the test and training
    utterances, the trigram of the training transcripts, and each
    contender's ``ContenderHost`` (only those asked for)."""

    mode: str
    cfg: WordCorpusConfig
    test: list
    train: list
    hosts: dict


def word_trigram(cfg, word_seqs):
    """(word symbols, the trigram of ``word_seqs``) (``:83-85``)."""
    word_sym = [f"w{w}" for w in range(cfg.vocab_size)]
    lm3 = estimate_ngram_lm([[word_sym[w] for w in ws] for ws in word_seqs],
                            order=3)
    return word_sym, lm3


def build_world(mode: str, sizes: CompareSizes,
                names=CONTENDERS) -> CompareWorld:
    """The corpus, the trigram and the contenders ``names``' host
    set-ups (``:65-116``), all on the host."""
    cfg = corpus_config(mode, sizes.num_utts)
    utts, prons, word_seqs, _, _, topo = make_word_corpus(cfg)[:6]
    test, train = utts[:sizes.n_test], utts[sizes.n_test:]
    word_sym, lm3 = word_trigram(cfg, word_seqs[sizes.n_test:])
    cplan = plan(sizes)
    hosts = {}
    for name in names:
        hosts[name] = contender_host(name, train, prons, topo,
                                     cfg.num_phones,
                                     cfg.frame_subsampling_factor, lm3,
                                     word_sym, cplan)
        print(f"[{mode}] {name} host set-up: "
              + ", ".join(f"{k} {v:.1f} s"
                          for k, v in hosts[name].seconds.items()),
              flush=True)
    return CompareWorld(mode=mode, cfg=cfg, test=test, train=train,
                        hosts=hosts)


def read_resume(path: str) -> dict:
    """The finished rows of an earlier run's file (``:127-133``), none if
    there is no file; a file that cannot be read raises."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return dict(json.load(f).get("table", {}))


@dataclasses.dataclass
class CompareResult:
    """What ``main`` ran: the report (``search`` holds the file) and the
    world (the contenders it trained)."""

    report: Report
    world: CompareWorld


def main(argv=None, device=DEFAULT_DEVICE,
         sizes: Optional[CompareSizes] = None,
         world: Optional[CompareWorld] = None) -> CompareResult:
    """``[--mode default|sym|symhard] --out DIR`` (``:42-181``): each
    contender not in the file already is trained, scored and decoded, and
    the file is written after each.  ``sizes`` replaces the reference's;
    ``world`` is its host set-up, built here when not given."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="default", choices=MODES)
    ap.add_argument("--out", required=True,
                    help="directory for the mode's JSON file")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    sizes = sizes if sizes is not None else CompareSizes.full()
    mode, name_ = args.mode, FILES[args.mode]
    report = Report(args.out, names={"search": name_})
    out = report.search
    out.update({"leaves": sizes.leaves, "steps": sizes.steps,
                "corpus": corpus_note(mode), "table": {}})
    if args.out:
        out["table"].update(read_resume(os.path.join(args.out, name_)))
    todo = [n for n in CONTENDERS if n not in out["table"]]
    for n in CONTENDERS:
        if n not in todo:
            print(f"{n}: kept from {name_}", flush=True)
    if world is None:
        with report.stage("host set-up"):
            world = build_world(mode, sizes, todo)
    elif world.mode != mode:
        raise ValueError(f"the world is of mode {world.mode!r}, not "
                         f"{mode!r}")
    cplan = plan(sizes)
    for n in todo:
        host = world.hosts[n]
        mc = model_config(host.tree.num_pdfs, sizes.model_overrides)
        with report.stage(n):
            out["table"][n] = contender_row(
                host, mc, trainer_config(sizes.steps), sizes.steps,
                world.test, cplan, report, n, device=dev)
        print(n, json.dumps(out["table"][n]), flush=True)
        report.save("search")
    return CompareResult(report=report, world=world)


if __name__ == "__main__":
    main()
