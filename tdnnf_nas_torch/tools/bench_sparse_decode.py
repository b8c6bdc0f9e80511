"""The sparse HCLG and the beam decoder at a real vocabulary's scale, on
the host (port of ``scripts/bench_sparse_decode.py``).

From ``RandomState(0)``, in the reference's order: a lexicon of
``vocab`` random pronunciations, Zipf-and-successor training text, its
trigram, the biphone HCLG (``decode/graph_sparse.build_hclg_sparse``), and
test utterances whose observations are a noisy one-hot of their pdf
alignment.  Each utterance is decoded by the C++ beam search with
lattices and by the numpy one, and the file holds the graph's size, the
build times, the WER, the real-time factors of both searches, the mean
active tokens and how many lattice best paths equal the one-best.  The
default is the reference's 5k-word run; ``30k`` is its 30,000-word
variant (``:137``).

Where it differs from the reference:

- the C++ decoder's library is built from ``native/`` as it is, and a
  failed build raises (the reference falls back to numpy); a hypothesis
  on which the two searches differ is printed as the reference does, and
  counted under ``native_python_mismatches``;
- the file goes to ``--out DIR`` (``sparse_decode_bench.json`` or
  ``sparse_decode_bench_30k.json``), never to ``docs/``.

It runs no kernel and uses no card, as the reference used no TPU.

Usage: python3 -m tdnnf_nas_torch.tools.bench_sparse_decode [30k]
       --out DIR
"""

from __future__ import annotations

import argparse
import time

import numpy as np

# the reference's two runs (scripts/bench_sparse_decode.py:24-26, 137-150)
PRESETS = {
    "5k": dict(vocab_size=5000, num_phones=42, n_train_sents=30000,
               n_test=20, out_name="sparse_decode_bench.json", noise=0.75,
               pron_len=(3, 7), beam=14.0, max_active=7000),
    "30k": dict(vocab_size=30000, num_phones=42, n_train_sents=150000,
                n_test=20, out_name="sparse_decode_bench_30k.json",
                noise=0.5, pron_len=(4, 9), beam=18.0, max_active=14000),
}


def _sentence(rng, zipf, succ, n: int) -> list:
    """n words: a Zipf draw, then its successor list 70% of the time."""
    vocab = len(zipf)
    s = [int(rng.choice(vocab, p=zipf))]
    for _ in range(n - 1):
        if rng.rand() < 0.7:
            s.append(int(succ[s[-1], rng.randint(20)]))
        else:
            s.append(int(rng.choice(vocab, p=zipf)))
    return s


def run(out_dir=None, vocab_size=5000, num_phones=42, n_train_sents=30000,
        n_test=20, out_name="sparse_decode_bench.json", noise=0.75,
        pron_len=(3, 7), beam=14.0, max_active=7000):
    """Builds, decodes and scores; returns (figures, hypotheses)."""
    from tdnnf_nas_torch.decode.beam import beam_decode_sparse
    from tdnnf_nas_torch.decode.graph_sparse import build_hclg_sparse
    from tdnnf_nas_torch.decode.lattice import lattice_best_path
    from tdnnf_nas_torch.decode.scoring import score_corpus
    from tdnnf_nas_torch.decode.wfst import Lexicon
    from tdnnf_nas_torch.graphs.topology import BiphoneTree, ChainTopology
    from tdnnf_nas_torch.lm.ngram import estimate_ngram_lm
    from tdnnf_nas_torch.tools.timing import write_json

    rng = np.random.RandomState(0)
    prons, seen = {}, set()
    while len(prons) < vocab_size:
        n = rng.randint(*pron_len)
        pron = tuple(rng.randint(0, num_phones, size=n).tolist())
        if pron in seen:
            continue
        seen.add(pron)
        prons[len(prons)] = pron
    lex = Lexicon(prons)
    word_sym = [f"w{w}" for w in range(vocab_size)]
    zipf = 1.0 / np.arange(1, vocab_size + 1)
    zipf /= zipf.sum()
    succ = rng.randint(0, vocab_size, size=(vocab_size, 20))
    sents = [[word_sym[x] for x in _sentence(rng, zipf, succ,
                                             rng.randint(4, 14))]
             for _ in range(n_train_sents)]
    t0 = time.perf_counter()
    lm = estimate_ngram_lm(sents, order=3)
    t_lm = time.perf_counter() - t0
    n_ngrams = len(lm.logprobs)
    print(f"trigram LM: {n_ngrams} ngrams in {t_lm:.1f}s", flush=True)

    topo = ChainTopology(num_phones)
    tree = BiphoneTree(num_phones)
    t0 = time.perf_counter()
    g = build_hclg_sparse(lex, lm, word_sym, topo, tree)
    t_graph = time.perf_counter() - t0
    print(f"HCLG: {g.num_states} states, {g.num_arcs} arcs in "
          f"{t_graph:.1f}s", flush=True)

    fs_sec = 0.03  # 30 ms per output frame (10 ms x subsampling 3)
    refs, hyps, act = [], [], []
    lat_ok = mismatches = 0
    t_total = t_total_py = audio_total = 0.0
    kw = dict(beam=beam, max_active=max_active, lattice=True,
              lattice_beam=7.0, retry_beam=4 * beam)
    for i in range(n_test):
        words = _sentence(rng, zipf, succ, rng.randint(8, 16))
        phones = [p for wd in words for p in prons[wd]]
        pdfs, prev = [], -1
        for p in phones:
            dur = 1 + rng.geometric(1.0 / 3.0)
            pdfs.append(tree.forward_pdf(p, prev))
            pdfs.extend([tree.self_loop_pdf(p)] * (dur - 1))
            prev = p
        t_len = len(pdfs)
        obs = np.full((t_len, tree.num_pdfs), -8.0, np.float32)
        obs[np.arange(t_len), pdfs] = 0.0
        obs += noise * rng.randn(t_len, tree.num_pdfs).astype(np.float32)

        t0 = time.perf_counter()
        res = beam_decode_sparse(obs, g, **kw)
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_py = beam_decode_sparse(obs, g, native=False, **kw)
        dt_py = time.perf_counter() - t0
        if res_py.words != res.words:
            mismatches += 1
            print(f"# WARNING: native/python hyp mismatch on utt {i}",
                  flush=True)
        t_total += dt
        t_total_py += dt_py
        audio_total += t_len * fs_sec
        act.append(res.num_active_mean)
        refs.append(words)
        hyps.append(res.words)
        lat_ok += int(lattice_best_path(res.lattice)[0] == res.words)
    rep = score_corpus(refs, hyps)
    rtf = t_total / audio_total
    out = {
        "vocab": vocab_size,
        "lm_ngrams": n_ngrams,
        "graph_states": int(g.num_states),
        "graph_arcs": int(g.num_arcs),
        "lm_build_s": round(t_lm, 1),
        "graph_build_s": round(t_graph, 1),
        "wer": rep["wer"],
        "obs_noise": noise,
        "beam": beam,
        "rtf": round(rtf, 4),
        "rtf_python": round(t_total_py / audio_total, 4),
        "xrt_speedup": round(1.0 / rtf, 1),
        "mean_active": round(float(np.mean(act)), 1),
        "lattice_bestpath_match": f"{lat_ok}/{n_test}",
        "utterances": n_test,
        "native_python_mismatches": mismatches,
    }
    write_json(out_dir, out_name, out)
    return out, hyps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", nargs="?", default="5k", choices=list(PRESETS))
    ap.add_argument("--out", required=True, help="directory for the file")
    args = ap.parse_args(argv)
    run(args.out, **PRESETS[args.preset])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
