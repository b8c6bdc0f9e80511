"""Word-position-marked phones against +-1 context on the card (port of
``scripts/wpd_compare.py``).

On a corpus with word-boundary allophony (``boundary_shift`` colours
each phone's emissions by its position in the word), three contenders
at one leaf budget:

  left1      the biphone tree over unmarked phones;
  left1_wpd  the biphone tree over _B/_E/_I/_S-marked phones
             (``graphs/wpd``: ``mark_lexicon``, ``mark_word_stream``,
             ``num_marked_phones``), the prepare_lang configuration;
  pm1        the +-1 cross-triphone tree over unmarked phones (its
             committed den carries the wildcard term).

Each takes the trigram-composed den (200 extra LM states), so every step
launches the blocked-den kernels, trains a float32 TDNN-F for 500 steps
at B = 32, chunk 24, and is scored on 4 valid batches of 16 and by its
first-pass WER on the first 50 utterances.  The contender loop is
``tools/context_compare``'s (``contender_host``, ``contender_row``) with
this driver's ``ContenderPlan``.  ``WpdSizes`` holds the utterance
counts, the leaf budget and the steps; ``full()`` is the reference's.

Where the port differs from the reference:

- the file goes to ``--out``, never to ``docs/``;
- each contender's HCLG is built with its tree, before training;
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step.

Kept as the reference has it: the file's ``corpus`` string says
``boundary_shift=1.2`` while the corpus is generated at 1.5
(``:249`` against ``:317``).

Usage:
    python3 -m tdnnf_nas_torch.tools.wpd_compare --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.synthetic import WordCorpusConfig, make_word_corpus
from tdnnf_nas_torch.graphs.topology import ChainTopology
from tdnnf_nas_torch.graphs.wpd import (mark_lexicon, mark_word_stream,
                                        num_marked_phones)
from tdnnf_nas_torch.models import TdnnfModelConfig
from tdnnf_nas_torch.tools.context_compare import (ContenderPlan,
                                                   contender_host,
                                                   contender_row,
                                                   word_trigram)
from tdnnf_nas_torch.tools.e2e_flagship import Report
from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                   TrainerConfig)

FILE = "wpd_compare.json"
# contender: (marked phones, tree kind) (:320-325)
CONTENDERS = {"left1": (False, "left1"), "left1_wpd": (True, "left1"),
              "pm1": (False, "pm1")}
CORPUS_NOTE = ("150-vocab, boundary_shift=1.2 (word-boundary allophony) "
               "+ left coarticulation 0.5")  # :317-318, kept verbatim
ROW_FIELDS = ("pdfs", "den_states", "train_objf", "dev_objf", "wer",
              "seconds")


@dataclasses.dataclass(frozen=True)
class WpdSizes:
    """The reference's sizes (its line in ``scripts/wpd_compare.py``
    beside each field); ``model_overrides`` are ``TdnnfModelConfig``
    fields set on top of the contenders' model."""

    num_utts: int  # :247
    n_test: int  # :251
    leaves: int  # :218
    steps: int  # :217
    model_overrides: tuple = ()  # ((field, value), ...)

    @classmethod
    def full(cls) -> "WpdSizes":
        return cls(num_utts=360, n_test=50, leaves=260, steps=500)


def plan(sizes: WpdSizes) -> ContenderPlan:
    """This driver's contender loop (``:268-314``; 4 valid batches,
    ``:299``)."""
    return ContenderPlan(
        leaves=sizes.leaves, dev_fraction=0.08, extra_lm_states=200,
        batch_size=32, chunk_width=24, valid_batches=4,
        valid_max_phones=24, beam=15.0, log_every=0, fields=ROW_FIELDS,
        seconds_with_tree=True)


def corpus_config(num_utts: int) -> WordCorpusConfig:
    """The boundary-allophony corpus (``:246-249``)."""
    return WordCorpusConfig(
        vocab_size=150, num_phones=14, feat_dim=24, num_utts=num_utts,
        min_words=3, max_words=9, min_pron=2, max_pron=5, mean_dur=3.0,
        emission_noise=2.2, context_shift=0.5, boundary_shift=1.5, seed=0)


def model_config(num_pdfs: int, feat_dim: int,
                 overrides=()) -> TdnnfModelConfig:
    """The contenders' float32 TDNN-F (``:283-287``)."""
    return TdnnfModelConfig(
        feat_dim=feat_dim, ivector_dim=0, num_pdfs=num_pdfs, hidden_dim=256,
        bottleneck_dim=64, prefinal_big=256, prefinal_small=128,
        time_strides=(1, 1, 3),
        compute_dtype="float32").replace(**dict(overrides))


def trainer_config(steps: int) -> TrainerConfig:
    """Adam 1e-3 -> 2e-4 (``:288-291``)."""
    return TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=1e-3,
                                  lr_final=2e-4, num_steps=steps))


def marked_corpus(utts, prons, num_phones: int):
    """The word-position-marked twin (``:259-266``): the same audio and
    durations with marked phone ids, the marked lexicon, the marked
    phone count and its topology."""
    prons_m = mark_lexicon(prons)
    utts_m = [dataclasses.replace(u, phones=mark_word_stream(u.words, prons))
              for u in utts]
    p_m = num_marked_phones(num_phones)
    return utts_m, prons_m, p_m, ChainTopology(p_m)


@dataclasses.dataclass
class WpdWorld:
    """The host set-up of a run: the corpus config, each contender's test
    utterances and ``ContenderHost``."""

    cfg: WordCorpusConfig
    tests: dict
    hosts: dict


def build_world(sizes: WpdSizes) -> WpdWorld:
    """The corpus and its marked twin, the trigram of the training
    transcripts and each contender's host set-up, all on the host."""
    cfg = corpus_config(sizes.num_utts)
    utts, prons, word_seqs, _, _, topo = make_word_corpus(cfg)
    word_sym, lm3 = word_trigram(cfg, word_seqs[sizes.n_test:])
    utts_m, prons_m, p_m, topo_m = marked_corpus(utts, prons,
                                                 cfg.num_phones)
    worlds = {False: (utts, prons, topo, cfg.num_phones),
              True: (utts_m, prons_m, topo_m, p_m)}
    cplan = plan(sizes)
    tests, hosts = {}, {}
    for name, (marked, kind) in CONTENDERS.items():
        c_utts, c_prons, c_topo, c_p = worlds[marked]
        tests[name] = c_utts[:sizes.n_test]
        hosts[name] = contender_host(kind, c_utts[sizes.n_test:], c_prons,
                                     c_topo, c_p,
                                     cfg.frame_subsampling_factor, lm3,
                                     word_sym, cplan)
        print(f"[wpd] {name} host set-up: "
              + ", ".join(f"{k} {v:.1f} s"
                          for k, v in hosts[name].seconds.items()),
              flush=True)
    return WpdWorld(cfg=cfg, tests=tests, hosts=hosts)


@dataclasses.dataclass
class WpdResult:
    """What ``main`` ran: the report (``search`` holds the file) and the
    world."""

    report: Report
    world: WpdWorld


def main(argv=None, device=DEFAULT_DEVICE, sizes: Optional[WpdSizes] = None,
         world: Optional[WpdWorld] = None) -> WpdResult:
    """``--out DIR`` (``:221-329``): the three contenders in turn, then the
    file.  ``sizes`` replaces the reference's; ``world`` is its host
    set-up, built here when not given."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory for " + FILE)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    sizes = sizes if sizes is not None else WpdSizes.full()
    report = Report(args.out, names={"search": FILE})
    if world is None:
        with report.stage("host set-up"):
            world = build_world(sizes)
    out = report.search
    out.update({"leaves": sizes.leaves, "steps": sizes.steps,
                "corpus": CORPUS_NOTE, "table": {}})
    cplan = plan(sizes)
    for name in CONTENDERS:
        host = world.hosts[name]
        mc = model_config(host.tree.num_pdfs, world.cfg.feat_dim,
                          sizes.model_overrides)
        with report.stage(name):
            out["table"][name] = contender_row(
                host, mc, trainer_config(sizes.steps), sizes.steps,
                world.tests[name], cplan, report, name, device=dev)
        print(name, json.dumps(out["table"][name]), flush=True)
    report.save("search")
    print(json.dumps(out), flush=True)
    return WpdResult(report=report, world=world)


if __name__ == "__main__":
    main()
