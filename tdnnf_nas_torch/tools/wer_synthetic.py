"""The end-to-end WER demo on the card (port of
``scripts/wer_synthetic.py``).

A 160-utterance word corpus (40 words, 14 phones) with its
context-independent tree and bigram phone LM, so ``prepare_data`` gives
the dense den and every step launches the dense-den kernels; 300 Adam
steps of a 4-layer TDNN-F at B = 16, chunk 20; then, for each dev
utterance, its whole-utterance forward (one utterance at a time, padded
to a multiple of 32 output frames), the exact 10-best of the dense
bigram decoding graph, rescored by a 4-gram and by an RNNLM (300 steps)
of the training transcripts, and the native lattice (beam 16, lattice
beam 8), rescored by the same two LMs, with its oracle WER.  Writes
``wer_synthetic.json`` with the reference's nine keys into ``--out``.
``train_steps`` is the reference's ``sys.argv[1]``; ``WerSizes`` holds
the model fields set on top of the reference's.

Where the port differs from the reference:

- the file goes to ``--out``, never to ``docs/``;
- the lattices always come from the native generator, which is built at
  first use and raises if it cannot be (the reference falls back to the
  Python ``generate_lattice`` when the library is missing, ``:74-75``);
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step.

Usage:
    python3 -m tdnnf_nas_torch.tools.wer_synthetic [TRAIN_STEPS] --out DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.native import generate_lattice_native
from tdnnf_nas_torch.data.synthetic import WordCorpusConfig, make_word_corpus
from tdnnf_nas_torch.decode.lattice import (lattice_oracle_wer,
                                            rescore_lattice,
                                            rescore_lattice_rnnlm)
from tdnnf_nas_torch.decode.nbest import nbest_decode
from tdnnf_nas_torch.decode.rescore import rescore_nbest
from tdnnf_nas_torch.decode.scoring import score_corpus
from tdnnf_nas_torch.decode.wfst import (Lexicon, build_decoding_graph,
                                         estimate_word_lm)
from tdnnf_nas_torch.lm.ngram import estimate_ngram_lm
from tdnnf_nas_torch.lm.rnnlm import RnnLMConfig, RnnLMScorer, train_rnnlm
from tdnnf_nas_torch.models import TdnnfModelConfig, apply_model, model_context
from tdnnf_nas_torch.recipes.chain_recipes import prepare_data, train_model
from tdnnf_nas_torch.tools.e2e_flagship import Report
from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                   TrainerConfig)

FILE = "wer_synthetic.json"
BATCH, CHUNK = 16, 20  # :149
BUCKET = 32  # :77
NBEST = 10  # :89
NUM_UTTS = 160  # :33
RNNLM_STEPS = 300  # :63


@dataclasses.dataclass(frozen=True)
class WerSizes:
    """``model_overrides``: ``TdnnfModelConfig`` fields set on top of the
    reference's model."""

    model_overrides: tuple = ()  # ((field, value), ...)


def corpus_config() -> WordCorpusConfig:
    """The word corpus (``:33-37``)."""
    return WordCorpusConfig(
        vocab_size=40, num_phones=14, feat_dim=24, num_utts=NUM_UTTS,
        min_words=3, max_words=8, emission_noise=1.2, seed=0)


def model_config(num_pdfs: int, feat_dim: int,
                 overrides=()) -> TdnnfModelConfig:
    """The 4-layer TDNN-F (``:41-45``)."""
    return TdnnfModelConfig(
        feat_dim=feat_dim, ivector_dim=0, hidden_dim=128, bottleneck_dim=32,
        time_strides=(1, 1, 3, 3), num_pdfs=num_pdfs, prefinal_big=128,
        prefinal_small=64).replace(**dict(overrides))


def trainer_config(train_steps: int) -> TrainerConfig:
    """Adam 2e-3 -> 4e-4 (``:46-50``)."""
    return TrainerConfig(
        objective=ChainObjectiveConfig(),
        optimizer=OptimizerConfig(kind="adam", lr_initial=2e-3,
                                  lr_final=4e-4, num_steps=train_steps))


def rnnlm_config(vocab_size: int) -> RnnLMConfig:
    """The rescoring RNNLM (``:61-62``)."""
    return RnnLMConfig(vocab_size=vocab_size, embed_dim=32, hidden_dim=64,
                       dropout=0.0)


def utterance_obs(mc, state, utt, device) -> np.ndarray:
    """One utterance's chain outputs [T_out, P] (``:80-91``): the
    features edge-repeated by the model's context and padded to a
    multiple of ``BUCKET`` output frames, one forward in test mode."""
    left, right = model_context(mc)
    t_out = len(utt.pdf_align)
    t_pad = ((t_out + BUCKET - 1) // BUCKET) * BUCKET
    need = left + (t_pad - 1) * 3 + 1 + right
    feats = np.concatenate([
        np.repeat(utt.feats[:1], left, 0), utt.feats,
        np.repeat(utt.feats[-1:], need, 0),
    ])[None][:, :need]
    with torch.inference_mode():
        chain, _, _ = apply_model(mc, state.params, state.bn_state,
                                  torch.as_tensor(feats, device=device),
                                  train=False)
    return chain[0].float().cpu().numpy()[:t_out]


@dataclasses.dataclass
class WerResult:
    """What ``main`` ran: the report (``search`` holds the file), the
    bundle and the model config."""

    report: Report
    bundle: object
    model_cfg: TdnnfModelConfig


def main(argv=None, device=DEFAULT_DEVICE,
         sizes: Optional[WerSizes] = None) -> WerResult:
    """``[TRAIN_STEPS] --out DIR`` (``:20-118``; 300 steps by default)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("train_steps", nargs="?", type=int, default=300)
    ap.add_argument("--out", required=True, help="directory for " + FILE)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    sizes = sizes if sizes is not None else WerSizes()
    n_steps = args.train_steps
    report = Report(args.out, names={"search": FILE})
    cfg = corpus_config()
    with report.stage("corpus and den"):
        utts, prons, word_seqs, phone_seqs, tree, topo = make_word_corpus(cfg)
        bundle = prepare_data(utts, phone_seqs, tree, topo, cfg.num_phones,
                              dev_fraction=0.15)
    mc = model_config(tree.num_pdfs, cfg.feat_dim, sizes.model_overrides)
    with report.stage("train"):
        state, metrics = train_model(bundle, mc, trainer_config(n_steps),
                                     num_steps=n_steps, batch_size=BATCH,
                                     chunk_width=CHUNK, seed=0, device=dev)
        report.trained("train", metrics)
    print(f"train objf: {metrics.last('objf_mmi'):.4f}", flush=True)

    # word LMs: the first-pass bigram of the training transcripts, the
    # 4-gram and the RNNLM of the same text
    train_words = [u.words for u in bundle.train_utts]
    with report.stage("LMs"):
        wlm = estimate_word_lm(train_words, cfg.vocab_size)
        dg = build_decoding_graph(Lexicon(prons), wlm, topo, tree)
        fourgram = estimate_ngram_lm(
            [[str(w) for w in s] for s in train_words], order=4)
        rnn_cfg = rnnlm_config(cfg.vocab_size)
        rnn_params, ppl = train_rnnlm(train_words, rnn_cfg,
                                      num_steps=RNNLM_STEPS,
                                      batch_size=16, lr=5e-3, device=dev)
        rnn = RnnLMScorer(rnn_cfg, rnn_params)
    print(f"rnnlm ppl: {ppl:.1f}", flush=True)

    refs, first, four_h, rnn_h = [], [], [], []
    lat_four_h, lat_rnn_h, oracle_errs, ref_words_total = [], [], 0, 0
    with report.stage("decode"):
        for utt in bundle.dev_utts:
            obs = utterance_obs(mc, state, utt, dev)
            nb = nbest_decode(obs, dg, n=NBEST)
            if not nb:
                continue
            refs.append(utt.words)
            first.append(nb[0][0])
            four_h.append(rescore_nbest(nb, wlm, fourgram,
                                        lm_scale=1.0)[0][0])
            rnn_h.append(rescore_nbest(nb, wlm, rnn, lm_scale=1.0,
                                       word_to_token=lambda w: w)[0][0])
            lat = generate_lattice_native(obs, dg, beam=16.0,
                                          lattice_beam=8.0)
            lat_four_h.append(rescore_lattice(lat, wlm, fourgram,
                                              lm_scale=1.0, n=1)[0][0])
            lat_rnn_h.append(rescore_lattice_rnnlm(lat, wlm, rnn,
                                                   lm_scale=1.0, n=1)[0][0])
            oracle_errs += lattice_oracle_wer(lat, utt.words)
            ref_words_total += len(utt.words)
    report.search = {
        "first_pass_wer": score_corpus(refs, first)["wer"],
        "fourgram_rescored_wer": score_corpus(refs, four_h)["wer"],
        "rnnlm_rescored_wer": score_corpus(refs, rnn_h)["wer"],
        "lattice_fourgram_wer": score_corpus(refs, lat_four_h)["wer"],
        "lattice_rnnlm_wer": score_corpus(refs, lat_rnn_h)["wer"],
        "lattice_oracle_wer": 100.0 * oracle_errs / max(ref_words_total, 1),
        "num_utts": len(refs),
        "train_objf": metrics.last("objf_mmi"),
        "rnnlm_ppl": ppl,
    }
    print(json.dumps(report.search, indent=1), flush=True)
    report.save("search")
    return WerResult(report=report, bundle=bundle, model_cfg=mc)


if __name__ == "__main__":
    main()
