"""The port's three native libraries under AddressSanitizer and
UndefinedBehaviorSanitizer, on the CPU.

``data/native.py`` builds each library (``csrc/egs_loader.cc``;
``native/egs_builder.cc``; ``native/decoder.cc``, ``lattice.cc`` and
``beam_sparse.cc``) with its own flags plus ``-fsanitize=address,undefined
-fno-omit-frame-pointer -g`` into a temporary directory, through its own
``build(..., flags=)``.  A subprocess with the sanitizer's runtime
preloaded (Python itself is not instrumented; leaks are not checked, as
the interpreter keeps memory to its exit) then drives every binding as the
port's tests do: the loader over several passes, closed while its producer
waits and on a shard cut short; the supervision builder against the
Python builder, bit for bit, with the unaligned mode and the edit
distance; the sparse beam search with lattices against the numpy one, its
search death, and the dense lattice and n-best decoders.  Any report of
either sanitizer fails the test.
"""

import os
import subprocess
import sys
from pathlib import Path

SAN_FLAGS = ("-fsanitize=address,undefined", "-fno-omit-frame-pointer",
             "-g")
_REPO = Path(__file__).resolve().parent.parent
_DONE = "native drive done"


def _drive(work: str) -> None:
    """Builds the sanitized libraries into ``work`` and drives them (run in
    the subprocess)."""
    import threading

    import numpy as np

    from tdnnf_nas_torch import graphs as tgraphs
    from tdnnf_nas_torch.data import native
    from tdnnf_nas_torch.data import synthetic as tsyn
    from tdnnf_nas_torch.data.egs_file import NativeEgsLoader, write_egs_file
    from tdnnf_nas_torch.decode import beam as tbeam
    from tdnnf_nas_torch.decode import graph_sparse as tgs
    from tdnnf_nas_torch.decode import wfst as twfst
    from tdnnf_nas_torch.decode.scoring import edit_distance
    from tdnnf_nas_torch.graphs.supervision import make_chunk_supervision
    from tdnnf_nas_torch.lm import ngram as tng
    from tests.test_torch_egs_loader_copy import _chunks

    native.BUILD_DIR = Path(work) / "_build"
    plain_build = native.build

    def build(srcs=(native.SOURCE,), stem="egs_loader",
              flags=native.CXX_FLAGS):
        return plain_build(srcs, stem, tuple(flags) + SAN_FLAGS)

    native.build = build
    for lib in (native.get_lib(), native.get_builder_lib(),
                native.get_decoder_lib()):
        assert Path(lib._name).parent == native.BUILD_DIR, lib._name

    # the loader: three passes, closes at a full queue, a truncated shard
    shard = os.path.join(work, "egs.tegs")
    write_egs_file(_chunks(37), shard)
    loader = NativeEgsLoader(shard, batch_size=8, queue_depth=3, seed=5)
    for i, batch in enumerate(loader):
        assert batch["feats"].shape == (8, 30, 40)
        if i == 13:
            break
    loader.close()
    for i in range(20):
        loader = NativeEgsLoader(shard, batch_size=2, queue_depth=1, seed=i)
        if i % 2:
            next(iter(loader))
        loader.close()
    cut = os.path.join(work, "cut.tegs")
    write_egs_file(_chunks(16, t_in=40), cut)
    size = os.path.getsize(cut)
    with open(cut, "r+b") as f:
        f.truncate(size - 100)
    got = []

    def consume():
        lo = NativeEgsLoader(cut, batch_size=5, queue_depth=2, seed=0)
        try:
            got.extend(lo)
        finally:
            lo.close()

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    th.join(60.0)
    assert not th.is_alive() and len(got) <= 3

    # the supervision builder against the Python builder, bit for bit
    rng = np.random.RandomState(0)
    seqs = [rng.randint(0, 6, size=8).tolist() for _ in range(30)]
    lm = tgraphs.estimate_phone_lm(seqs, 6)
    topo = tgraphs.ChainTopology(6)
    tree = tgraphs.ContextIndependentTree(6)
    den = tgraphs.build_denominator_graph(lm, topo, tree)
    cases = [([1, 3, 0, 2], [0, 3, 7, 11], [2, 6, 10, 13]),
             ([5, 4], [0, 8], [7, 13]), ([2, 2, 1], [1, 5, 9], [4, 8, 13])]
    fwd, slf = native.tree_tables(tree, 6)
    de, dl = native.den_init_tables(den, 6)
    out = native.build_supervision_batch_native(
        [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases],
        lm.probs, fwd, slf, de, dl, topo.self_loop_prob, 2, 14, 12)
    init_fn = tgraphs.den_init_lookup(den, 6)
    for i, (ph, bg, en) in enumerate(cases):
        ref = make_chunk_supervision(ph, bg, en, lm, topo, tree, 14, 12,
                                     tol=2, den_init_fn=init_fn)
        for f in ("trans", "state_pdf", "init", "final", "mask"):
            assert np.array_equal(out[f][i], getattr(ref, f)), f
    native.build_supervision_batch_native(
        [[0, 1, 2]], None, None, lm.probs, fwd, slf, None, None,
        topo.self_loop_prob, 2, 10, 8)
    refs = [rng.randint(0, 5, size=rng.randint(0, 12)).tolist()
            for _ in range(25)]
    hyps = [rng.randint(0, 5, size=rng.randint(1, 12)).tolist()
            for _ in range(25)]
    ed = native.edit_distance_batch_native(refs, hyps)
    for i, (r, h) in enumerate(zip(refs, hyps)):
        c = edit_distance(r, h)
        assert ed[i, 0] + ed[i, 1] + ed[i, 2] == c["sub"] + c["ins"] + c["del"]

    # the decoders: sparse beam search with lattices, its death, and the
    # dense lattice and n-best decoders
    def noisy(utt, num_pdfs, noise):
        t = len(utt.pdf_align)
        obs = np.full((t, num_pdfs), -5.0, np.float32)
        obs[np.arange(t), utt.pdf_align] = 0.0
        return obs + rng.randn(t, num_pdfs).astype(np.float32) * noise

    corpus = tsyn.make_word_corpus(tsyn.WordCorpusConfig(
        vocab_size=40, num_phones=10, feat_dim=16, num_utts=24, min_words=2,
        max_words=6, seed=3))
    sym = [f"w{w}" for w in range(40)]
    lm3 = tng.estimate_ngram_lm([[sym[w] for w in ws] for ws in corpus[2]],
                                order=3)
    hclg = tgs.build_hclg_sparse(twfst.Lexicon(corpus[1]), lm3, sym,
                                 corpus[5], corpus[4])
    for utt in corpus[0][:3]:
        obs = noisy(utt, corpus[4].num_pdfs, 0.5)
        nat = tbeam.beam_decode_sparse(obs, hclg, beam=16.0, lattice=True,
                                       lattice_beam=8.0)
        py = tbeam.beam_decode_sparse(obs, hclg, beam=16.0, lattice=True,
                                      lattice_beam=8.0, native=False)
        assert nat.words == py.words
        assert nat.lattice.num_arcs == py.lattice.num_arcs
        tbeam.beam_decode_sparse(obs, hclg, beam=6.0, max_active=40,
                                 retry_beam=48.0, lattice=True,
                                 lattice_beam=4.0)
    try:
        tbeam.beam_decode_sparse(np.full_like(obs, -1e30), hclg)
        raise AssertionError("the search did not die")
    except tbeam.BeamSearchDied:
        pass
    small = tsyn.make_word_corpus(tsyn.WordCorpusConfig(
        num_utts=10, num_phones=8, feat_dim=16, seed=0))
    dense = twfst.build_decoding_graph(
        twfst.Lexicon(small[1]), twfst.estimate_word_lm(small[2], 12),
        small[5], small[4])
    for utt in small[0][:3]:
        obs = noisy(utt, small[4].num_pdfs, 0.3)
        for lattice_beam in (3.0, 12.0):
            native.generate_lattice_native(obs, dense, beam=14.0,
                                           lattice_beam=lattice_beam)
        native.nbest_decode_native(obs, dense, n=5, acoustic_scale=0.8)
    print(_DONE, flush=True)


def test_native_libraries_under_sanitizers(tmp_path):
    runtime = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True,
                             check=True).stdout.strip()
    assert os.path.isabs(runtime) and os.path.exists(runtime), (
        f"no AddressSanitizer runtime beside g++: {runtime!r}")
    env = dict(os.environ, LD_PRELOAD=runtime,
               ASAN_OPTIONS="detect_leaks=0:halt_on_error=1",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1",
               OMP_NUM_THREADS="2", PYTHONPATH=str(_REPO))
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; from tests.test_torch_native_asan"
         " import _drive; _drive(sys.argv[1])", str(tmp_path)],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=900)
    reports = [line for line in proc.stderr.splitlines()
               if "AddressSanitizer" in line or "runtime error:" in line
               or "UndefinedBehaviorSanitizer" in line]
    assert proc.returncode == 0 and _DONE in proc.stdout and not reports, (
        f"rc {proc.returncode}; sanitizer reports: {reports[:20]}\n"
        f"stderr tail:\n{proc.stderr[-4000:]}")
