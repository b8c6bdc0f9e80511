"""Phase 1's left-2 tree and phase 12's +-1 tree through the port and a
reference, timed: the flagship corpus of ``chip_smoke.py`` (768
utterances, 46 phones, seed 0), its left-2 and +-1 statistics, and
``build_clustered_triphone_tree`` / ``build_clustered_cross_triphone_tree``
at 6,034 - 46 forward leaves, once through the port's vectorised
clustering and once through the reference: the JAX package's pure-Python
heap, or with ``--reference FILE`` another ``tree_cluster.py`` (an older
port's, on a host without JAX).  Prints one JSON line a tree: each side's
seconds, the forward leaves and whether the tables are equal; exits 1 if
any table differs.  Not a test (about three minutes on the CPU):

    JAX_PLATFORMS=cpu OMP_NUM_THREADS=2 python tests/flagship_tree_timing.py
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tdnnf_nas_torch.graphs import tree_cluster as ttc  # noqa: E402

TREES = (("left2", "accumulate_triphone_stats",
          "build_clustered_triphone_tree"),
         ("pm1", "accumulate_cross_triphone_stats",
          "build_clustered_cross_triphone_tree"))


def _reference(path):
    if path is None:
        from tdnnf_nas_tpu.graphs import tree_cluster
        return tree_cluster
    spec = importlib.util.spec_from_file_location("reference_tree_cluster",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", help="a tree_cluster.py to hold the "
                    "port against (default: the JAX package's)")
    args = ap.parse_args(argv)
    ref = _reference(args.reference)
    num_phones = 46
    utts, phone_seqs, _ = chip_smoke._flagship_corpus()
    ok = True
    for name, accumulate, build in TREES:
        stats = getattr(ttc, accumulate)(
            [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
            num_phones, 3)
        out, tables = {"tree": name}, {}
        for side, mod in (("port", ttc), ("reference", ref)):
            st = mod.TriphoneStats(stats.counts, stats.sums, stats.sumsqs)
            t0 = time.perf_counter()
            tree = getattr(mod, build)(st, num_leaves=6034 - num_phones)
            out[f"{side}_s"] = time.perf_counter() - t0
            out[f"{side}_fwd_leaves"] = tree._n_fwd
            tables[side] = tree._fwd_table
        out["tables_equal"] = bool(np.array_equal(tables["port"],
                                                  tables["reference"]))
        out["speedup"] = out["reference_s"] / out["port_s"]
        print(json.dumps(out), flush=True)
        ok = ok and out["tables_equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
