"""RNNLM rescoring at the flagship's scale, done the reference's way, on
the card (port of ``scripts/rnnlm_fair_fight.py``).

The flagship's acoustic model (1,600 steps, seed 0, as the base run)
decodes the test set with trigram (tg) lattices; 30-best lists drawn
from them get their tg scores swapped for the full 4-gram's (fg), and
the oracle, the dev / eval halves and a bigger 4-gram follow: extra
text from the same generator (``make_word_corpus(extra_text_sents=)``),
the 4-gram re-estimated on it and the lists rescored again.  Then the
reference rescorer's RNNLM (embed 1,024, cell 2,048, projection 512,
TDNN splice) trains on all the text with a held-out slice for early
stopping, its held-out perplexities beside the big 4-gram's, the
interpolation weight is swept on the dev half and reported on the eval
half, and every lattice is rescored by the frontier-batched pruned
RNNLM rescorer at the chosen weight.  Writes ``rnnlm_rescore.json``
with the reference's keys into ``--out``.  Every AM step launches the
blocked-den kernels.

``FairFightSizes`` holds the AM's steps and the n-best size;
``--rnnlm-steps`` and ``--extra-text`` take the place of the reference's
``RNNLM_STEPS`` and ``RNNLM_EXTRA_TEXT`` environment switches, with
their defaults (48,000 and 700,000; ``docs/rnnlm_rescore.json`` was
written at 24,000 and 500,000).

Where the port differs from the reference:

- the file goes to ``--out``, never to ``docs/``;
- the set-up is ``tools/e2e_flagship.build_setup`` at the full
  ``E2eSizes`` (``--topic-successors``: the topic-successor corpus, the
  reference's ``FLAGSHIP_TOPIC_SUCC``; the corpus variant and the test
  set's size come from its ``topic_successors`` and ``n_test``), or a
  prebuilt ``Setup`` passed to ``main``; the reference builds its own;
- the n-best lists and the RNNLM's parameters are cached (and the
  bootstrap with them) only under an explicit ``--cache-dir``, in the
  reference's file names; the reference always uses ``.cache/``;
- initial weights and every random draw come from seeded torch
  generators, so the trajectories follow the port's streams and are not
  expected to match JAX step for step.

Kept as the reference has it: the ``early_stopping`` string says "every
1500" while the held-out slice is scored every 3,000 steps
(``:184`` against ``:219``).

Usage:
    python3 -m tdnnf_nas_torch.tools.rnnlm_fair_fight [--topic-successors]
        --out DIR [--rnnlm-steps N] [--extra-text N] [--cache-dir DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pickle
import time
from typing import Optional

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data.synthetic import make_word_corpus
from tdnnf_nas_torch.decode.lattice import (lattice_nbest,
                                            rescore_lattices_rnnlm)
from tdnnf_nas_torch.decode.rescore import (_old_lm_token_logprobs,
                                            rescore_nbest_rnnlm_batched)
from tdnnf_nas_torch.decode.scoring import score_corpus
from tdnnf_nas_torch.lm.ngram import estimate_ngram_lm
from tdnnf_nas_torch.lm.rnnlm import RnnLMConfig, RnnLMScorer, train_rnnlm
from tdnnf_nas_torch.recipes.chain_recipes import train_model
from tdnnf_nas_torch.tools.e2e_flagship import (E2eSizes, Report, Setup,
                                                build_graph, build_hclg,
                                                build_setup, decode,
                                                model_config, trainer_config)

FILE = "rnnlm_rescore.json"
INTERP_WEIGHTS = (0.2, 0.35, 0.5, 0.65, 0.8)  # :225
EVAL_EVERY = 3000  # :184, held-out perplexity every 3,000 steps
RNNLM_STEPS = 48000  # :161, RNNLM_STEPS: --rnnlm-steps
EXTRA_TEXT = 700000  # :129, RNNLM_EXTRA_TEXT: --extra-text
NOTE = ("headline comparison: wer_rnnlm_eval_at_dev_weight vs "
        "wer_4gram_nbest_eval_half (same eval half, weight chosen on the dev "
        "half)")  # :240-242


@dataclasses.dataclass(frozen=True)
class FairFightSizes:
    """The reference's sizes (its line in ``scripts/rnnlm_fair_fight.py``
    beside each field)."""

    am_steps: int = 1600  # :71
    nbest: int = 30  # :88


def rnnlm_config(vocab_size: int) -> RnnLMConfig:
    """The reference rescorer's shape (``:162-163``)."""
    return RnnLMConfig(vocab_size=vocab_size, embed_dim=1024,
                       hidden_dim=2048, proj_dim=512, tdnn_splice=True)


def swap_lm(nbests, old_lm, new_lm, wtt):
    """Each list's scores with ``old_lm``'s log-probs replaced by
    ``new_lm``'s, best first (``:87-97``, ``:144-152``)."""
    out = []
    for hyps in nbests:
        swapped = []
        for words, total in hyps:
            old = sum(_old_lm_token_logprobs(list(words), old_lm, wtt))
            new = sum(_old_lm_token_logprobs(list(words), new_lm, wtt))
            swapped.append((list(words), total - old + new))
        swapped.sort(key=lambda h: -h[1])
        out.append(swapped)
    return out


def oracle_wer(refs, nbests) -> float:
    """WER of each list's best hypothesis against its reference
    (``:111-113``)."""
    return score_corpus(
        refs, [min(h, key=lambda x: score_corpus([r], [x[0]])["wer"])[0]
               if h else [] for h, r in zip(nbests, refs)])["wer"]


def held_out_split(lm_all):
    """(held-out slice, training text): every 40th sentence, at most
    512, and the text without any sentence equal to one of them
    (``:164-167``)."""
    lm_held = lm_all[::40][:512]
    held_set = set(tuple(int(w) for w in s) for s in lm_held)
    return lm_held, [s for s in lm_all
                     if tuple(int(w) for w in s) not in held_set]


def _read_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _write_pickle(path, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


@dataclasses.dataclass
class FairFightResult:
    """What ``main`` ran: the report (``search`` holds the file, ``steps``
    the AM's) and the seconds ``lattice_nbest`` took over the lattices."""

    report: Report
    nbest_seconds: float


def main(argv=None, device=DEFAULT_DEVICE,
         sizes: Optional[FairFightSizes] = None,
         setup: Optional[Setup] = None) -> FairFightResult:
    """``[--topic-successors] --out DIR [--rnnlm-steps N] [--extra-text N]
    [--cache-dir DIR]`` (``:29-275``).  ``setup`` is the flagship set-up
    (built here at the full ``E2eSizes`` when not given); ``sizes``
    replaces the reference's, and the two flags replace its RNNLM steps
    and extra sentences."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topic-successors", action="store_true",
                    help="the topic-successor corpus (FLAGSHIP_TOPIC_SUCC)")
    ap.add_argument("--out", required=True, help="directory for " + FILE)
    ap.add_argument("--rnnlm-steps", type=int, default=RNNLM_STEPS,
                    help="RNNLM steps (the reference's RNNLM_STEPS)")
    ap.add_argument("--extra-text", type=int, default=EXTRA_TEXT,
                    help="extra LM sentences (RNNLM_EXTRA_TEXT)")
    ap.add_argument("--cache-dir",
                    help="read and write the n-best lists, the RNNLM and "
                         "the flagship bootstrap here")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    sizes = sizes if sizes is not None else FairFightSizes()
    report = Report(args.out, names={"search": FILE})
    if setup is None:
        setup = build_setup(dataclasses.replace(
            E2eSizes.full(), topic_successors=args.topic_successors),
            cache_dir=args.cache_dir, device=dev)
    cfg, e2e_sizes = setup.cfg, setup.sizes
    tsucc, n_test = e2e_sizes.topic_successors, e2e_sizes.n_test
    mc = model_config(setup.tree, cfg, overrides=e2e_sizes.model_overrides)
    wtt = lambda w: f"w{w}"
    refs = [list(u.words) for u in setup.test]
    # the interpolation weight is tuned on the dev half and reported on
    # the eval half
    n_dev = len(setup.test) // 2
    nb_cache = (os.path.join(args.cache_dir, "rnnlm_fight_nbests_tsucc.pkl"
                             if tsucc else "rnnlm_fight_nbests_v2.pkl")
                if args.cache_dir else None)
    cached_nb = (_read_pickle(nb_cache)
                 if nb_cache and os.path.exists(nb_cache) else None)
    word_sym, lm3, lm4 = build_graph(cfg, setup.prons, setup.word_seqs,
                                     setup.text, n_test)
    nbest_seconds = 0.0
    if cached_nb is None:
        # the AM of the flagship base run (same seed and budget)
        with report.stage("am"):
            state, m = train_model(setup.bundle, mc,
                                   trainer_config(sizes.am_steps),
                                   sizes.am_steps, batch_size=64,
                                   chunk_width=50, seed=0, log_every=400,
                                   device=dev)
            report.trained("am", m)
        with report.stage("HCLG"):
            g = build_hclg(setup, lm3, word_sym)
        with report.stage("decode"):
            rep = decode(setup, mc, state, g, lattice=True, device=dev)
        del state
        print(f"[decode] tg WER={rep['wer']:.2f}", flush=True)
        wer_tg = rep["wer"]
        lattices = rep["lattices"]
        t0 = time.perf_counter()
        nbests_tg = [lattice_nbest(lat, n=sizes.nbest) for lat in lattices]
        nbest_seconds = time.perf_counter() - t0
        # n-best with tg scores -> the full 4-gram's
        nbests_fg = swap_lm(nbests_tg, lm3, lm4, wtt)
        if nb_cache:
            _write_pickle(nb_cache, {"nbests_fg": nbests_fg,
                                     "wer_tg": wer_tg,
                                     "lattices": lattices})
    else:
        nbests_fg = cached_nb["nbests_fg"]
        wer_tg = cached_nb["wer_tg"]
        lattices = cached_nb.get("lattices")
        print("[decode] n-best restored from cache", flush=True)
    hyps_fg = [(h[0][0] if h else []) for h in nbests_fg]
    wer_fg = score_corpus(refs, hyps_fg)["wer"]
    wer_fg_eval = score_corpus(refs[n_dev:], hyps_fg[n_dev:])["wer"]
    oracle = oracle_wer(refs, nbests_fg)
    print(f"[fg] 4-gram n-best rescore WER={wer_fg:.2f} "
          f"(eval half {wer_fg_eval:.2f}, oracle {oracle:.2f})", flush=True)

    # extra LM text for both contenders, from the same generator
    # (appended draws: the corpus stays as it was), and the 4-gram
    # re-estimated on it; the first-pass trigram stays small
    with report.stage("extra text"):
        extra = make_word_corpus(cfg, extra_text_sents=args.extra_text)[7]
    with report.stage("big 4-gram"):
        sym_text = [[wtt(w) for w in ws] for ws in extra]
        base_text = ([[wtt(w) for w in ws] for ws in setup.text]
                     + [[wtt(w) for w in ws]
                        for ws in setup.word_seqs[n_test:]])
        lm4_big = estimate_ngram_lm(base_text + sym_text, order=4)
    print(f"[fg+] 4-gram re-estimated on {len(base_text) + len(sym_text)} "
          "sents", flush=True)
    nbests_fg2 = swap_lm(nbests_fg, lm4, lm4_big, wtt)
    hyps2 = [(h[0][0] if h else []) for h in nbests_fg2]
    wer_fg2 = score_corpus(refs, hyps2)["wer"]
    wer_fg2_eval = score_corpus(refs[n_dev:], hyps2[n_dev:])["wer"]
    print(f"[fg+] big 4-gram n-best WER={wer_fg2:.2f} "
          f"(eval half {wer_fg2_eval:.2f})", flush=True)

    # the RNNLM: the reference's shape, lr decay, held-out early stopping
    n_steps = args.rnnlm_steps
    rl_cfg = rnnlm_config(cfg.vocab_size)
    lm_all = setup.text + setup.word_seqs[n_test:] + extra
    lm_held, lm_train = held_out_split(lm_all)
    rnn_cache = (os.path.join(
        args.cache_dir, f"rnnlm_params_{'tsucc' if tsucc else 'base'}"
        f"_{n_steps}_{len(lm_train)}.pkl") if args.cache_dir else None)
    with report.stage("rnnlm"):
        if rnn_cache and os.path.exists(rnn_cache):
            np_params, ppl = _read_pickle(rnn_cache)
            rnn_params = convert.rnnlm_params_from_numpy(np_params, dev)
            print(f"[rnnlm] params restored from {rnn_cache} "
                  f"(ppl {ppl:.1f})", flush=True)
        else:
            rnn_params, ppl = train_rnnlm(
                lm_train, rl_cfg, num_steps=n_steps, batch_size=64, lr=2e-3,
                lr_final=1e-4, seed=0, heldout=lm_held,
                eval_every=EVAL_EVERY, device=dev)
            print(f"[rnnlm] trained {n_steps} steps, best held-out ppl "
                  f"{ppl:.1f}", flush=True)
            if rnn_cache:
                _write_pickle(rnn_cache,
                              (convert.rnnlm_params_to_numpy(rnn_params),
                               ppl))
    scorer = RnnLMScorer(rl_cfg, rnn_params)

    # perplexities on the test utterances' word sequences (in neither
    # LM's text), both in natural log (score() is log10)
    held = [list(u.words) for u in setup.test]
    lp_rnn = sum(scorer.score(ws) for ws in held) * math.log(10.0)
    lp_fg = sum(sum(_old_lm_token_logprobs(ws, lm4_big, wtt))
                for ws in held)
    n_tok = sum(len(ws) + 1 for ws in held)
    ppl_rnn_held = float(math.exp(-lp_rnn / n_tok))
    ppl_fg_held = float(math.exp(-lp_fg / n_tok))
    print(f"[ppl] test-utterance held-out: rnnlm {ppl_rnn_held:.1f} vs "
          f"big 4-gram {ppl_fg_held:.1f}", flush=True)

    out = report.search
    out.update({
        "corpus_variant": "topic_successors" if tsucc else "base",
        "wer_first_pass_tg": round(wer_tg, 2),
        "wer_4gram_small_nbest": round(wer_fg, 2),
        "wer_4gram_nbest": round(wer_fg2, 2),
        "wer_4gram_nbest_eval_half": round(wer_fg2_eval, 2),
        "oracle_nbest_wer": round(oracle, 2),
        "lm_text": {"base_sents": len(base_text),
                    "fisher_analogue_extra": len(sym_text)},
        "rnnlm": {"embed": 1024, "cell": 2048, "rpd": 512,
                  "steps": n_steps, "lr_decay": "2e-3->1e-4",
                  "early_stopping": "held-out text slice, every 1500",
                  "ppl_heldout_text": round(ppl, 1),
                  "ppl_testutts": round(ppl_rnn_held, 1),
                  "ppl_testutts_4gram": round(ppl_fg_held, 1)},
        "sweep_dev_half": {}, "sweep_eval_half": {}})
    best_w, best_dev = None, None
    with report.stage("sweep"):
        for w in INTERP_WEIGHTS:
            bests = rescore_nbest_rnnlm_batched(nbests_fg2, lm4_big, scorer,
                                                lm_scale=1.0,
                                                interp_weight=w,
                                                word_to_token=wtt)
            hyp = [b[0] for b in bests]
            wer_dev = score_corpus(refs[:n_dev], hyp[:n_dev])["wer"]
            wer_eval = score_corpus(refs[n_dev:], hyp[n_dev:])["wer"]
            out["sweep_dev_half"][str(w)] = round(wer_dev, 2)
            out["sweep_eval_half"][str(w)] = round(wer_eval, 2)
            print(f"[rnnlm] interp={w}: dev={wer_dev:.2f} "
                  f"eval={wer_eval:.2f}", flush=True)
            if best_dev is None or wer_dev < best_dev:
                best_dev, best_w = wer_dev, w
    out["interp_weight_dev_choice"] = best_w
    out["wer_rnnlm_eval_at_dev_weight"] = out["sweep_eval_half"][str(best_w)]
    out["note"] = NOTE

    # the pruned lattice rescoring, frontier-batched over the test set
    if lattices is not None:
        t0 = time.time()
        lat_out = rescore_lattices_rnnlm(
            lattices, lm3, scorer, lm_scale=1.0, n=1, word_to_token=wtt,
            interp_weight=best_w, beam=10.0, max_states_per_node=8,
            hist_len=2)
        dt = time.time() - t0
        hyp = [(o[0][0] if o else []) for o in lat_out]
        wer_lat = score_corpus(refs, hyp)["wer"]
        out["lattice_rescore"] = {
            "wer_rnnlm_lattice_over_tg": round(wer_lat, 2),
            "interp_weight": best_w,
            "seconds_total": round(dt, 1),
            "seconds_per_lattice": round(dt / max(len(lattices), 1), 2),
            "num_lattices": len(lattices),
        }
        print(f"[lattice] batched rescore: WER={wer_lat:.2f} ({dt:.1f}s = "
              f"{dt / max(len(lattices), 1):.2f}s/lattice)", flush=True)
    report.save("search")
    print(json.dumps(out), flush=True)
    return FairFightResult(report=report, nbest_seconds=nbest_seconds)


if __name__ == "__main__":
    main()
