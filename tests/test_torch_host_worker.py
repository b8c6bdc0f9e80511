"""``chip_smoke.py``'s host worker on the CPU: its five pickles, built
in order of need, against the same set-ups built in this process (phase
1's flagship set-up, phase 10's CPU ladder, phase 12's +-1 tree and
factored den, phase 16's ``context_compare`` and ``wpd_compare``
worlds); the hand-over (the worker sees no card, its threads are capped,
its directory goes with it); a worker that dies or hangs failing the
phase by name; ``close`` stopping one that still runs."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tdnnf_nas_torch.tools import context_compare as tcc
from tdnnf_nas_torch.tools import wpd_compare as twpd

torch.set_num_threads(2)

_POPEN = subprocess.Popen


def _smoke_module():
    import chip_smoke

    return chip_smoke


def _tiny_flagship_corpus():
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)

    cfg = SyntheticCorpusConfig(num_utts=40, num_phones=46, feat_dim=8,
                                min_phones=6, max_phones=12, mean_dur=3.0,
                                context_shift=1.0, seed=0)
    utts, phones, _, topo = make_synthetic_corpus(cfg)
    return utts, phones, topo


def _tiny_worker(cs, monkeypatch):
    """The worker's set-ups cut to a few seconds: a 40-utterance flagship
    corpus, a 100-utterance tri5_7d corpus, a 60-leaf +-1 tree, and small
    comparison worlds."""
    monkeypatch.setattr(cs, "_flagship_corpus", _tiny_flagship_corpus)
    monkeypatch.setattr(cs, "PM1_CORPUS", dict(cs.PM1_CORPUS, num_utts=100))
    monkeypatch.setattr(cs, "FACTORED_LEAVES", 60)
    monkeypatch.setattr(cs, "CC_SMOKE", dict(num_utts=60, n_test=3,
                                             steps=1, leaves=30))
    monkeypatch.setattr(cs, "WPD_SMOKE", dict(num_utts=60, n_test=3,
                                              steps=1, leaves=20))


def _same_host(a, b):
    """Two ContenderHosts hold the same tree, den and HCLG."""
    np.testing.assert_array_equal(a.tree._fwd_table, b.tree._fwd_table)
    assert a.cluster_ll == b.cluster_ll
    for f in ("w_blocks", "perm", "pdf_virtual"):
        np.testing.assert_array_equal(getattr(a.bundle.den_arrays, f),
                                      getattr(b.bundle.den_arrays, f))
    assert (a.g.num_states, a.g.num_arcs) == (b.g.num_states, b.g.num_arcs)
    assert len(a.bundle.train_utts) == len(b.bundle.train_utts)


def test_worker_pickles_equal_the_in_process_setups(tmp_path, monkeypatch):
    """The worker's five pickles, in order of need: phase 1's set-up (the
    corpus, the left-2 tree, the blocked den), phase 10's CPU ladder,
    phase 12's set-up (the +-1 tree, the den, its refusal and host
    seconds) and phase 16's
    worlds, each equal to the same set-up built in this process."""
    cs = _smoke_module()
    _tiny_worker(cs, monkeypatch)
    assert cs._host_worker_main(str(tmp_path)) == 0
    assert sorted(os.listdir(tmp_path)) == [
        "context_compare.pkl", "flagship.pkl", "pm1_factored.pkl",
        "tri5_7d_cpu_ladder.pkl", "wpd_compare.pkl"]
    load = lambda n: pickle.load(open(tmp_path / f"{n}.pkl", "rb"))
    flagship, here = load("flagship"), cs._flagship_host_setup()
    assert flagship["phone_seqs"] == here["phone_seqs"]
    np.testing.assert_array_equal(flagship["tree"]._fwd_table,
                                  here["tree"]._fwd_table)
    for f in ("w_blocks", "perm", "pdf_virtual"):
        np.testing.assert_array_equal(
            getattr(flagship["bundle"].den_arrays, f),
            getattr(here["bundle"].den_arrays, f))
    ladder = load("tri5_7d_cpu_ladder")
    here = cs._tri5_7d_cpu_ladder()
    assert ladder["begins"] == here["begins"] and len(ladder["begins"]) == 40
    assert ladder["fmllr_gain"] == here["fmllr_gain"]
    pm1 = load("pm1_factored")
    utts, phones, topo = _tiny_flagship_corpus()
    here = cs._pm1_factored_setup(utts, phones, topo)
    np.testing.assert_array_equal(pm1["tree"]._fwd_table,
                                  here["tree"]._fwd_table)
    assert (pm1["bundle"].den_fsa.num_states
            == here["bundle"].den_fsa.num_states)
    assert set(pm1["secs"]) == set(here["secs"]) >= {"tree",
                                                     "prepare_data"}
    assert len(pm1["refusal"]) == 1 and pm1["refusal"] == here["refusal"]
    assert pm1["seconds"] > 0
    cc_w = load("context_compare")["world"]
    here = tcc.build_world(cs.CC_SMOKE_MODE, cs._cc_sizes(tcc))
    assert cc_w.mode == "symhard" and set(cc_w.hosts) == set(tcc.CONTENDERS)
    for k in tcc.CONTENDERS:
        _same_host(cc_w.hosts[k], here.hosts[k])
    wpd_w = load("wpd_compare")["world"]
    here = twpd.build_world(cs._wpd_sizes(twpd))
    for k in twpd.CONTENDERS:
        _same_host(wpd_w.hosts[k], here.hosts[k])
        assert [u.words for u in wpd_w.tests[k]] == [
            u.words for u in here.tests[k]]


class _Popen:
    """subprocess.Popen with the worker's command swapped for ``code``
    (its directory as ``sys.argv[1]``); records the environment it was
    given."""

    def __init__(self, code):
        self.code, self.env = code, None

    def __call__(self, args, **kw):
        assert args[-2] == "--host-worker"
        self.env = kw["env"]
        return _POPEN([sys.executable, "-c", self.code, args[-1]], **kw)


def test_worker_handover_and_environment(monkeypatch):
    """A worker that writes its file: ``take`` returns it and ``finish``
    checks its exit code; the worker sees no card and capped threads;
    ``close`` removes its directory."""
    cs = _smoke_module()
    code = ("import os, pickle, sys; d = sys.argv[1]; "
            "pickle.dump({'seconds': 1.5, 'x': 7}, "
            "open(os.path.join(d, '.a.tmp'), 'wb')); "
            "os.replace(os.path.join(d, '.a.tmp'), os.path.join(d, 'a.pkl'))")
    popen = _Popen(code)
    monkeypatch.setattr(cs.subprocess, "Popen", popen)
    w = cs._HostWorker()
    try:
        assert w.take("a", "a test")["x"] == 7
        w.finish()
    finally:
        w.close()
    assert popen.env["CUDA_VISIBLE_DEVICES"] == ""
    assert popen.env["OMP_NUM_THREADS"] == str(cs.HOST_WORKER_THREADS)
    assert not os.path.exists(w.dir)


@pytest.mark.parametrize("code, rc", [("import sys; sys.exit(3)", 3),
                                      ("pass", 0)])
def test_worker_that_dies_fails_the_phase_by_name(code, rc, monkeypatch):
    """A worker that exits, with an error or without writing the file, is
    named in the failure with its exit code; nothing is built in its
    place."""
    cs = _smoke_module()
    monkeypatch.setattr(cs.subprocess, "Popen", _Popen(code))
    w = cs._HostWorker()
    try:
        with pytest.raises(RuntimeError, match=f"the host worker exited with "
                           f"code {rc} before writing pm1_factored"):
            w.take("pm1_factored", "phase 12's +-1 tree and den")
    finally:
        w.close()


def test_worker_that_hangs_fails_the_phase_by_name(monkeypatch):
    """A worker still running when the wait's limit passes is named in
    the failure, with its log; nothing is built in its place."""
    cs = _smoke_module()
    monkeypatch.setattr(cs, "HOST_WORKER_WAIT_S", 0.5)
    monkeypatch.setattr(cs.subprocess, "Popen", _Popen(
        "import time; print('stuck in set-up', flush=True); "
        "time.sleep(60)"))
    w = cs._HostWorker()
    try:
        with pytest.raises(RuntimeError, match=r"(?s)the host worker was "
                           r"still running after \d+ s before writing "
                           r"pm1_factored\.pkl.*stuck in set-up"):
            w.take("pm1_factored", "phase 12's +-1 tree and den")
    finally:
        w.close()
    assert w.proc.poll() is not None


def test_worker_close_stops_a_running_worker(monkeypatch):
    cs = _smoke_module()
    monkeypatch.setattr(cs.subprocess, "Popen",
                        _Popen("import time; time.sleep(60)"))
    w = cs._HostWorker()
    assert w.proc.poll() is None
    w.close()
    assert w.proc.poll() is not None and not os.path.exists(w.dir)
