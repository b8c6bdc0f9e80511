"""The committed +-1 denominator at the bench's scale, on the host.

The bench setup of ``chip_smoke.py`` phase 1 (``bench.py:113-157``): 768
synthetic utterances of 46 phones, the 4-gram phone LM with 2,000 extra
states, but a +-1 triphone tree of 6,034 - 46 forward leaves in place of
the left-2 one.  Builds the tree, the LM, the committed composition and
its blocked export, printing each step's seconds and the process's peak
memory; the composition and the export run under a deadline
(``--deadline`` seconds from the start, 600 by default) and, if it
passes, the line says which step was cut (an export over its size
budget is reported with the budget's message).  On success prints the den's
states, arcs, wildcard positions, R, C/NSRC/NDP and W's bytes, and a JSON
line of them last.  Host numpy only: no card needed.

Usage:
    python -m tdnnf_nas_torch.tools.pm1_den_scale [--deadline S]
"""

from __future__ import annotations

import argparse
import json
import resource
import signal
import time


class _Deadline(Exception):
    pass


def _peak_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--deadline", type=float, default=600.0)
    args = ap.parse_args()

    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)
    from tdnnf_nas_torch.graphs import (ChainTopology,
                                        accumulate_cross_triphone_stats,
                                        build_clustered_cross_triphone_tree,
                                        compile_denominator_fsa,
                                        estimate_ngram_phone_lm)

    t_start = time.perf_counter()
    out = {"deadline_s": args.deadline}

    def step(name, t0):
        out[f"{name}_s"] = round(time.perf_counter() - t0, 1)
        print(f"[pm1 scale] {name}: {out[f'{name}_s']} s (peak "
              f"{_peak_gib():.2f} GiB)", flush=True)

    num_phones = 46
    t0 = time.perf_counter()
    cfg = SyntheticCorpusConfig(
        num_utts=768, num_phones=num_phones, feat_dim=40, min_phones=10,
        max_phones=30, mean_dur=4.0, context_shift=1.0, seed=0)
    utts, phone_seqs, _, _ = make_synthetic_corpus(cfg)
    stats = accumulate_cross_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
        num_phones, cfg.frame_subsampling_factor)
    tree = build_clustered_cross_triphone_tree(
        stats, num_leaves=6034 - num_phones)
    out["pdfs"] = tree.num_pdfs
    step("tree", t0)
    t0 = time.perf_counter()
    lm = estimate_ngram_phone_lm(phone_seqs, num_phones, order=4,
                                 num_extra_lm_states=2000)
    out["lm_states"] = int(lm.probs.shape[0])
    step("lm", t0)

    def on_alarm(signum, frame):
        raise _Deadline()

    left = args.deadline - (time.perf_counter() - t_start)
    signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, max(left, 1.0))
    stage = "compile"
    try:
        t0 = time.perf_counter()
        fsa = compile_denominator_fsa(lm, ChainTopology(num_phones), tree)
        out.update(states=fsa.num_states, arcs=len(fsa.arc_dst),
                   positions=fsa.num_positions,
                   wildcard_positions=len(fsa.wildcard_positions))
        step("compile", t0)
        stage = "to_blocked"
        t0 = time.perf_counter()
        try:
            blk = fsa.to_blocked()
        except ValueError as e:  # over the export's size budget
            signal.setitimer(signal.ITIMER_REAL, 0)
            step("to_blocked", t0)
            out.update(to_blocked_error=str(e),
                       peak_gib=round(_peak_gib(), 2))
            print(f"[pm1 scale] to_blocked refused: {e}", flush=True)
            print(json.dumps(out))
            return 0
        step("to_blocked", t0)
    except _Deadline:
        signal.setitimer(signal.ITIMER_REAL, 0)
        out["cut_in"] = stage
        out["peak_gib"] = round(_peak_gib(), 2)
        print(f"[pm1 scale] the deadline of {args.deadline:.0f} s passed in "
              f"{stage} after {time.perf_counter() - t0:.1f} s of it",
              flush=True)
        print(json.dumps(out))
        return 0
    signal.setitimer(signal.ITIMER_REAL, 0)
    c, nsrc, ndp = blk.shape
    out.update(c=c, nsrc=nsrc, ndp=ndp, r=int(blk.bcast_sel.shape[1]),
               w_bytes=4 * c * nsrc * ndp, peak_gib=round(_peak_gib(), 2),
               total_s=round(time.perf_counter() - t_start, 1))
    print(f"[pm1 scale] {out['pdfs']} pdfs; den {out['states']} states, "
          f"{out['arcs']} arcs, {out['wildcard_positions']} wildcard "
          f"positions, R={out['r']}, C/NSRC/NDP={c}/{nsrc}/{ndp}, W "
          f"{out['w_bytes'] / 1e6:.1f} MB, in {out['total_s']} s",
          flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
