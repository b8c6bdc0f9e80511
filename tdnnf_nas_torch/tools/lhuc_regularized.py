"""The no-i-vector LHUC enrollment sweep on the card (port of
``scripts/lhuc_regularized.py``).

With ~10 enrollment utterances a speaker, point-estimate LHUC overfits;
this run sweeps the identity-prior decay ``l2`` (``models/lhuc``) and
the step count at the flagship's stage 7b: the model trained without
i-vectors (the 7q with ``ivector_dim=0``, 1,000 steps, seed 3) is
decoded on the test set, then adapted and decoded per speaker three
ways (``lhuc_adapt_and_decode``):

  unregularized_24  24 SGD steps at lr 0.2, l2 = 0;
  l2_2.0_24         24 steps, l2 = 2.0;
  l2_0.5_12         12 steps, l2 = 0.5.

Every training and LHUC step launches the blocked-den kernels (the
flagship's 4-gram den; LHUC at B = 16).  Writes ``lhuc_noiv_reg.json``
(the unadapted WER, each variant's row and ``best_variant``, the first
variant of least ``wer_after``) into ``--out``, and when
``e2e_flagship.json`` is there, replaces its ``lhuc_noiv`` row with the
best variant's.  ``LhucSizes`` holds the no-i-vector model's steps.

Where the port differs from the reference:

- the files are read and written in ``--out``, never in ``docs/``;
- the set-up is ``tools/e2e_flagship.build_setup`` at the full
  ``E2eSizes`` (``--topic-successors``: the topic-successor corpus, the
  reference's ``FLAGSHIP_TOPIC_SUCC``), or a prebuilt ``Setup`` passed
  to ``main`` (``chip_smoke.py`` hands over its flagship run's); the
  reference builds its own;
- with no ``e2e_flagship.json`` in ``--out`` the patch is skipped and
  said so; a file there that cannot be read or patched raises (the
  reference prints "skipped" for any exception, ``:80-92``);
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step.

Usage:
    python3 -m tdnnf_nas_torch.tools.lhuc_regularized [--topic-successors]
        --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.recipes.chain_recipes import (decode_corpus_words,
                                                   train_model)
from tdnnf_nas_torch.tools.e2e_flagship import (E2eSizes, Report, Setup,
                                                build_graph, build_hclg,
                                                build_setup,
                                                lhuc_adapt_and_decode,
                                                model_config, trainer_config)

FILE = "lhuc_noiv_reg.json"
E2E_FILE = "e2e_flagship.json"
# variant: lhuc_adapt_and_decode's keywords (:62-66)
VARIANTS = (
    ("unregularized_24", dict(num_steps=24, lr=0.2, l2=0.0)),
    ("l2_2.0_24", dict(num_steps=24, lr=0.2, l2=2.0)),
    ("l2_0.5_12", dict(num_steps=12, lr=0.2, l2=0.5)),
)
PATCH_NOTE = ("regularized enrollment (identity-prior decay); full sweep "
              "in docs/lhuc_noiv_reg.json")  # :86-88, kept verbatim


@dataclasses.dataclass(frozen=True)
class LhucSizes:
    """The reference's sizes (its line in ``scripts/lhuc_regularized.py``
    beside each field)."""

    noiv_steps: int = 1000  # :47


def best_variant(variants: dict) -> str:
    """The first variant of least ``wer_after`` (``:72-74``)."""
    best = None
    for name, row in variants.items():
        if best is None or row["wer_after"] < variants[best]["wer_after"]:
            best = name
    return best


def patch_e2e(out_dir: str, result: dict) -> bool:
    """Replaces the ``lhuc_noiv`` row of ``out_dir``'s
    ``e2e_flagship.json`` with the best variant's (``:79-90``); False when
    there is no such file.  A file that cannot be read or patched
    raises."""
    path = os.path.join(out_dir, E2E_FILE)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        e2e = json.load(f)
    best = result["best_variant"]
    row = dict(result["variants"][best])
    row["wer_unadapted_full"] = result["wer_unadapted_full"]
    row["regularization"] = best
    row["note"] = PATCH_NOTE
    e2e["lhuc_noiv"] = row
    with open(path, "w") as f:
        json.dump(e2e, f, indent=2)
    return True


@dataclasses.dataclass
class LhucResult:
    """What ``main`` ran: the report (``search`` holds the file, its
    ``steps`` the model's and ``lhuc_steps`` the LHUC steps) and whether
    ``e2e_flagship.json`` was patched."""

    report: Report
    patched: bool


def main(argv=None, device=DEFAULT_DEVICE,
         sizes: Optional[LhucSizes] = None,
         setup: Optional[Setup] = None) -> LhucResult:
    """``[--topic-successors] --out DIR`` (``:30-93``).  ``setup`` is the
    flagship set-up (built here at the full ``E2eSizes`` when not given);
    ``sizes`` replaces the reference's step count."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topic-successors", action="store_true",
                    help="the topic-successor corpus (FLAGSHIP_TOPIC_SUCC)")
    ap.add_argument("--out", required=True, help="directory for " + FILE)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    sizes = sizes if sizes is not None else LhucSizes()
    report = Report(args.out, names={"search": FILE})
    if setup is None:
        setup = build_setup(dataclasses.replace(
            E2eSizes.full(), topic_successors=args.topic_successors),
            device=dev)
    e2e_sizes = setup.sizes
    mc = model_config(setup.tree, setup.cfg,
                      overrides=e2e_sizes.model_overrides)
    refs = [list(u.words) for u in setup.test]
    with report.stage("HCLG"):
        word_sym, lm3, _ = build_graph(setup.cfg, setup.prons,
                                       setup.word_seqs, setup.text,
                                       e2e_sizes.n_test)
        g = build_hclg(setup, lm3, word_sym)

    # the stage-7b no-i-vector model (same seed and budget)
    n_noiv = sizes.noiv_steps
    mc_niv = mc.replace(ivector_dim=0)
    tc = trainer_config(n_noiv)
    t0 = time.time()
    with report.stage("no-iv model"):
        st_niv, m_niv = train_model(setup.bundle, mc_niv, tc, n_noiv,
                                    batch_size=64, chunk_width=50, seed=3,
                                    log_every=250, device=dev)
        report.trained("noiv", m_niv)
        rep_niv = decode_corpus_words(setup.bundle, mc_niv, st_niv, g,
                                      setup.test, acoustic_scale=1.0,
                                      beam=16.0, max_active=10000,
                                      num_workers=2, device=dev)
    print(f"[base] no-iv WER {rep_niv['wer']:.2f} "
          f"({time.time() - t0:.0f}s)", flush=True)

    def count_lhuc(_):
        report.lhuc_steps += 1

    out = report.search
    out.update({"wer_unadapted_full": round(rep_niv["wer"], 2),
                "variants": {}})
    for name, kw in VARIANTS:
        with report.stage(name):
            res = lhuc_adapt_and_decode(
                setup.bundle, setup.topo, setup.tree, g, setup.test, refs,
                setup.iv_test, tc.objective, mc_niv, st_niv, False,
                rep_niv["hyps"], on_step=count_lhuc, device=dev, **kw)
        row = {"speakers": res["speakers"], "utts": res["utts"],
               "wer_before": round(res["wer_before"], 2),
               "wer_after": round(res["wer_after"], 2), **kw}
        out["variants"][name] = row
    out["best_variant"] = best_variant(out["variants"])
    report.save("search")
    patched = bool(args.out) and patch_e2e(args.out, out)
    if not patched:
        print(f"[lhuc] no {E2E_FILE} in --out: its lhuc_noiv row is not "
              "patched", flush=True)
    print(json.dumps(out), flush=True)
    return LhucResult(report=report, patched=patched)


if __name__ == "__main__":
    main()
