"""Does the two-stage search find a planted context offset?  (Port of
``scripts/search_sanity_planted.py``.)

The planted corpus (``make_planted_corpus``) pairs phones that share
identical emissions in a first feature block and writes the full phone
identity into a second block ``K_LAG`` = 6 output frames late.  A model
sees lda splice (+1) + the affine stride s + the numerator's +-2
tolerance ahead, so of the candidates s in {0..3} only 2 and 3 reach the
evidence.  The run: uniform supernet pretraining of the one-layer
offsets supernet (8 phones, CI tree, bigram LM: a dense den of 16 states
and 16 pdfs, so every step launches the dense-den kernels), a softmax
alpha-only cv-update on the dev split with theta and batchnorm frozen
(``alpha_lr_scale`` 30), top-1 extraction, then the searched child
against a child without lookahead at one budget, each scored on the
first 4 dev batches.  Writes ``search_sanity.json`` with the reference's
keys and rounding into ``--out``.

Where the port differs from the reference:

- the file goes to ``--out``, never to ``docs/`` (the reference's own
  figures);
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step;
- a dev split with fewer chunks than the cv-update's batch of 16 caps
  the batch there and prints it (the reference's ``train_model``
  raises); at the reference's sizes it holds enough.

Usage:
    python3 -m tdnnf_nas_torch.tools.search_sanity_planted --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.synthetic import Utterance
from tdnnf_nas_torch.graphs.topology import (ChainTopology,
                                             ContextIndependentTree)
from tdnnf_nas_torch.models import (DartsModelConfig, SearchMode,
                                    TdnnfModelConfig)
from tdnnf_nas_torch.nas import child_config_from_arch, extract_offsets
from tdnnf_nas_torch.recipes.chain_recipes import prepare_data, train_model
from tdnnf_nas_torch.tools.e2e_flagship import Report
from tdnnf_nas_torch.tools.e2e_search import (alpha_arrays, child_row,
                                              cv_batch_size)
from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                   TrainerConfig)

# planted lookahead (output frames): reachable only at affine stride 3
# (and 2 through the numerator tolerance) (:45-50)
K_LAG = 6
BATCH, CHUNK = 16, 20  # :128, 137, 160
VALID_BATCHES = 4  # :167
OPT = dict(kind="adam", lr_initial=2e-3, lr_final=5e-4)  # :121
FILE = "search_sanity.json"


def make_planted_corpus(num_phones=8, num_utts=160, feat_dim=24,
                        noise=0.35, mean_dur=1.15, seed=0):
    """The planted corpus, a numpy copy of
    ``scripts/search_sanity_planted.py:53-97``: (utterances, phone
    sequences, CI tree, topology)."""
    rng = np.random.RandomState(seed)
    tree = ContextIndependentTree(num_phones)
    topo = ChainTopology(num_phones)
    half = feat_dim // 2
    # block 1: PAIRED means -- phones 2i and 2i+1 are identical here, and
    # forward/self-loop pdfs of a pair collapse onto the pair mean
    pair_mean = rng.randn(num_phones // 2, half) * 2.0
    # block 2: full phone identity, but written with a K-frame DELAY
    ident = rng.randn(num_phones, feat_dim - half) * 2.0
    fs = 3

    utts = []
    for _ in range(num_utts):
        n = rng.randint(10, 22)
        phones = rng.randint(0, num_phones, size=n).tolist()
        begins, ends, pdfs, frame_phone = [], [], [], []
        t = 0
        for p in phones:
            dur = 1 + rng.geometric(1.0 / mean_dur)
            begins.append(t)
            ends.append(t + dur - 1)
            pdfs.append(tree.forward_pdf(p))
            pdfs.extend([tree.self_loop_pdf(p)] * (dur - 1))
            frame_phone.extend([p] * dur)
            t += dur
        pdf_align = np.asarray(pdfs, np.int32)
        fp = np.asarray(frame_phone)
        t_out = len(fp)
        # delayed identity: frame t shows the phone of frame t - K_LAG
        delayed = np.concatenate([np.full(K_LAG, fp[0]), fp[:-K_LAG]]) \
            if t_out > K_LAG else np.full(t_out, fp[0])
        block1 = pair_mean[fp // 2]
        block2 = ident[delayed]
        out_feats = np.concatenate([block1, block2], axis=1)
        feats = (np.repeat(out_feats, fs, axis=0)
                 + rng.randn(t_out * fs, feat_dim) * noise)
        utts.append(Utterance(feats.astype(np.float32), phones, begins,
                              ends, pdf_align))
    return utts, [u.phones for u in utts], tree, topo


def planted_bundle():
    """The planted corpus's CI tree and its ``prepare_data`` bundle (bigram
    LM, 12% dev: a dense den of 16 states), ``:112-114``."""
    utts, phone_seqs, tree, topo = make_planted_corpus()
    return tree, prepare_data(utts, phone_seqs, tree, topo, tree.num_phones,
                              dev_fraction=0.12)


def model_config(num_pdfs: int) -> TdnnfModelConfig:
    """The one-layer float32 TDNN-F the supernet searches (``:116-119``)."""
    return TdnnfModelConfig(
        feat_dim=24, ivector_dim=0, hidden_dim=64, bottleneck_dim=16,
        time_strides=(1,), num_pdfs=num_pdfs, prefinal_big=64,
        prefinal_small=32, compute_dtype="float32")


def entropies(alphas) -> dict:
    """Each alpha table's mean softmax entropy, rounded to 3 places
    (``_entropies``, ``:197-203``); ``alphas``: (linear, affine)."""
    out = {}
    for k, a in zip(("offsets_linear", "offsets_affine"), alphas):
        p = np.exp(a) / np.exp(a).sum(-1, keepdims=True)
        out[k] = round(float(np.mean(-(p * np.log(p + 1e-20)).sum(-1))), 3)
    return out


@dataclasses.dataclass
class SanityResult:
    """What ``main`` ran: the report (``search`` holds the file), the
    bundle and the base model config, and the cv-update's alphas."""

    report: Report
    bundle: object
    base: TdnnfModelConfig
    alphas: tuple


def main(pretrain_steps: int = 320, cv_steps: int = 800,
         child_steps: int = 260, out=None,
         device=DEFAULT_DEVICE) -> SanityResult:
    """The sanity run (``:100-194``) at the reference's step counts by
    default; writes ``search_sanity.json`` into ``out`` when given."""
    dev = resolve_device(device)
    t0 = time.time()
    report = Report(out, names={"search": FILE})
    with report.stage("corpus and den"):
        tree, bundle = planted_bundle()
    base = model_config(tree.num_pdfs)
    darts = DartsModelConfig(base=base, search_offsets=True, max_stride=3)

    pre_tc = TrainerConfig(train_theta=True, train_alpha=False,
                           search_mode=SearchMode.UNIFORM,
                           optimizer=OptimizerConfig(num_steps=pretrain_steps,
                                                     **OPT))
    with report.stage("pretrain"):
        sup, m = train_model(bundle, darts, pre_tc, pretrain_steps,
                             batch_size=BATCH, chunk_width=CHUNK, seed=0,
                             supernet=True, device=dev)
        report.trained("supernet", m)
    ent0 = entropies(alpha_arrays(sup))

    cv_tc = TrainerConfig(train_theta=False, train_alpha=True,
                          bn_frozen=True, search_mode=SearchMode.SOFTMAX,
                          optimizer=OptimizerConfig(num_steps=cv_steps,
                                                    alpha_lr_scale=30.0,
                                                    **OPT))
    with report.stage("cv-update"):
        sup, m = train_model(bundle, darts, cv_tc, cv_steps,
                             batch_size=cv_batch_size(bundle, darts, CHUNK,
                                                      "cv", BATCH),
                             chunk_width=CHUNK, seed=1, supernet=True,
                             init_state=sup, dev=True, device=dev)
        report.trained("cv", m)
    a_lin, a_aff = alpha_arrays(sup)
    del sup
    ent1 = entropies((a_lin, a_aff))
    p_aff = np.exp(a_aff) / np.exp(a_aff).sum(-1, keepdims=True)
    archs = extract_offsets(a_lin, a_aff, top_k=1)
    top1 = archs[0][0]
    found = int(top1[0][1])
    mass_reach = float(p_aff[0, 2] + p_aff[0, 3])
    print(f"planted lag K={K_LAG}: affine softmax {np.round(p_aff[0], 3)} "
          f"-> top1 affine stride {found} "
          f"(reachable mass {mass_reach:.3f})", flush=True)

    # child A/B: the planted stride vs a no-lookahead child, equal budget
    table = {}
    for name, pairs in (("searched_top1", top1),
                        ("no_lookahead", ((int(top1[0][0]), 0),))):
        ccfg = child_config_from_arch(base, stride_pairs=pairs)
        tc = TrainerConfig(objective=ChainObjectiveConfig(),
                           optimizer=OptimizerConfig(num_steps=child_steps,
                                                     **OPT))
        with report.stage(f"child {name}"):
            row = child_row(bundle, ccfg, tc, child_steps, report, name,
                            batch_size=BATCH, chunk_width=CHUNK,
                            valid_batches=VALID_BATCHES, log_every=0,
                            device=dev)
        table[name] = {"pairs": row["strides"],
                       "train_objf": row["train_objf"],
                       "dev_objf": row["dev_objf"]}
        print(f"{name}: {table[name]}", flush=True)

    report.search = {
        "planted_lag": K_LAG,
        "alpha_entropy_uniform": round(float(np.log(a_aff.shape[-1])), 3),
        "alpha_entropy_after_pretrain": ent0,
        "alpha_entropy_after_cvupdate": ent1,
        "affine_softmax": [round(float(x), 4) for x in p_aff[0]],
        "top1_affine_stride": found,
        "reachable_strides": [2, 3],
        "reachable_mass": round(mass_reach, 4),
        "planted_reach_found": bool(found in (2, 3) and mass_reach > 0.8),
        "child_table": table,
        "dev_objf_gap": round(table["searched_top1"]["dev_objf"]
                              - table["no_lookahead"]["dev_objf"], 4),
        "seconds": round(time.time() - t0),
    }
    report.save("search")
    print(json.dumps(report.search), flush=True)
    return SanityResult(report=report, bundle=bundle, base=base,
                        alphas=(a_lin, a_aff))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="directory for search_sanity.json")
    main(out=ap.parse_args().out)
