"""Data parallel over ``torch.distributed`` on the CPU: two gloo ranks,
each in its own process started through ``initialize_from_env`` with
its own timeout, train the flagship-shaped model (float32, dropout on)
and a uniform-path offsets supernet from one replicated state on their
halves of each global batch, against one process on the whole batch, as
tests/test_parallel.py:49-70 holds the reference's SPMD step: objf of the
first step within rtol 1e-5, the 12-step trajectory within 5e-4
(__graft_entry__.py:119) and the parameters after the last step within
atol 5e-4; and ``train_model(mesh=)`` against one process's
``train_model``, with checkpoints written by rank 0 alone.  Also the
single-process helpers: ``host_sharded_iterator``
equals plain batching (tests/test_parallel.py:84), the shard range, the
mesh's preconditions and the integer-key PRNG."""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tdnnf_nas_torch import parallel
from tdnnf_nas_torch.train.optimizer import tree_paths

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STEPS, _GLOBAL_B = 12, 8
_RECIPE_STEPS, _CKPT_EVERY = 6, 3
_RANK_TIMEOUT_S = 240


def _world():
    """(chunks, bigram dense den on the CPU, model cfg, supernet cfg)."""
    from tdnnf_nas_torch import data, graphs, models
    from tdnnf_nas_torch.models.nas import DartsModelConfig
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays

    corpus_cfg = data.SyntheticCorpusConfig(num_utts=24, num_phones=5,
                                            feat_dim=10)
    utts, phone_seqs, tree, topo = data.make_synthetic_corpus(corpus_cfg)
    lm = graphs.estimate_phone_lm(phone_seqs, 5)
    den = graphs.build_denominator_graph(lm, topo, tree)
    cfg = models.TdnnfModelConfig(
        feat_dim=10, ivector_dim=0, hidden_dim=24, bottleneck_dim=8,
        time_strides=(1, 2), num_pdfs=tree.num_pdfs, prefinal_big=24,
        prefinal_small=12, compute_dtype="float32", dropout_proportion=0.2)
    scfg = DartsModelConfig(base=cfg, max_stride=2, sample_per_sequence=True)
    left, right = models.nas.supernet_context(scfg)
    egs_cfg = data.EgsConfig(chunk_width=12, left_context=left,
                             right_context=right, max_phones_per_chunk=10)
    chunks = data.make_egs(utts, lm, topo, tree, egs_cfg,
                           den_init_fn=graphs.den_init_lookup(den, 5))
    return chunks, DenGraphArrays.from_graph(den, "cpu"), cfg, scfg


def _train(mesh=None):
    """{kind: (objf per step, params as numpy)} of _STEPS steps of the
    plain model and of the supernet on the first global batches, on
    ``mesh``'s rows or, without one, on the whole batch."""
    from tdnnf_nas_torch import convert
    from tdnnf_nas_torch.data import batch_iterator
    from tdnnf_nas_torch.models.nas import SearchMode
    from tdnnf_nas_torch.train import (OptimizerConfig, TrainerConfig,
                                       init_train_state, make_train_step)

    chunks, den, cfg, scfg = _world()
    it = batch_iterator(chunks, batch_size=_GLOBAL_B,
                        rng=np.random.RandomState(0))
    batches = [next(it) for _ in range(3)]
    out = {}
    for kind, model_cfg, supernet, mode in (
            ("plain", cfg, False, SearchMode.FIXED),
            ("supernet", scfg, True, SearchMode.UNIFORM)):
        tc = TrainerConfig(optimizer=OptimizerConfig(num_steps=_STEPS),
                           search_mode=mode)
        state = init_train_state(model_cfg, tc,
                                 torch.Generator().manual_seed(0), "cpu",
                                 supernet=supernet)
        if mesh is not None:
            state = parallel.put_replicated(state, mesh)
        step = make_train_step(model_cfg, tc, den, seed=1,
                               supernet=supernet, mesh=mesh)
        objf = []
        for i in range(_STEPS):
            b = batches[i % 3]
            b = (convert.batch_to_torch(b, "cpu") if mesh is None
                 else parallel.put_batch(b, mesh))
            state, m = step(state, b)
            objf.append(float(m["objf_mmi"]))
        out[kind] = (objf, {"/".join(p): x.numpy()
                            for p, x in tree_paths(state.params)})
    return out


def _recipe(ckpt_dir: str, mesh=None):
    """(objf per step, final params as numpy) of ``train_model`` on a
    small bundle, global batch _GLOBAL_B, dropout on, checkpoints every
    _CKPT_EVERY steps into ``ckpt_dir``; on ``mesh``'s rows of each
    global batch, or on the whole batch without one."""
    from tdnnf_nas_torch import data
    from tdnnf_nas_torch.recipes.chain_recipes import (prepare_data,
                                                       train_model)
    from tdnnf_nas_torch.train import TrainerConfig

    corpus_cfg = data.SyntheticCorpusConfig(num_utts=40, num_phones=5,
                                            feat_dim=10)
    utts, phone_seqs, tree, topo = data.make_synthetic_corpus(corpus_cfg)
    bundle = prepare_data(utts, phone_seqs, tree, topo, 5, phone_lm_order=2)
    cfg = dataclasses.replace(_world()[2], num_pdfs=tree.num_pdfs)
    state, log = train_model(bundle, cfg, TrainerConfig(), _RECIPE_STEPS,
                             batch_size=_GLOBAL_B, chunk_width=12, seed=2,
                             ckpt_dir=ckpt_dir, ckpt_interval=_CKPT_EVERY,
                             max_phones_per_chunk=10, device="cpu",
                             mesh=mesh)
    return (np.asarray(log.series["objf_mmi"]),
            {"/".join(p): x.numpy() for p, x in tree_paths(state.params)})


def _rank_main(out_path: str) -> None:
    """One rank of the two-process run (started by the test below)."""
    torch.set_num_threads(1)
    assert parallel.initialize_from_env(device="cpu")
    mesh = parallel.make_mesh(device="cpu")
    assert mesh.size == 2 and torch.distributed.get_backend() == "gloo"
    res = _train(mesh)
    recipe = _recipe(os.path.join(os.path.dirname(out_path),
                                  f"ckpt_rank{mesh.rank}"), mesh)
    if mesh.rank == 0:
        np.savez(out_path, **{f"{k}|objf": np.asarray(v[0])
                              for k, v in res.items()},
                 **{f"{k}|{p}": x for k, v in res.items()
                    for p, x in v[1].items()},
                 **{"recipe|objf": recipe[0]},
                 **{f"recipe|{p}": x for p, x in recipe[1].items()})
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp") / "rank0.npz")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "from tests.test_torch_parallel import "
             f"_rank_main; _rank_main({out!r})"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return dict(np.load(out)), _train(None), os.path.dirname(out)


@pytest.mark.parametrize("kind", ["plain", "supernet"])
def test_two_gloo_ranks_match_one_process(two_ranks, kind):
    got, want, _ = two_ranks
    objf = got[f"{kind}|objf"]
    ref_objf, ref_params = want[kind]
    assert np.all(np.isfinite(objf))
    np.testing.assert_allclose(objf[0], ref_objf[0], rtol=1e-5)
    assert np.max(np.abs(objf - np.asarray(ref_objf))) < 5e-4
    for p, x in ref_params.items():
        np.testing.assert_allclose(got[f"{kind}|{p}"], x, rtol=0, atol=5e-4,
                                   err_msg=p)


def test_train_model_on_two_gloo_ranks(two_ranks, tmp_path):
    """``train_model(mesh=)`` on both ranks equals one process's
    ``train_model`` (objf of the first step within rtol 1e-5, the
    trajectory within 5e-4, params within atol 5e-4), and only rank 0
    writes checkpoints: its newest holds the state it returned, bit for
    bit."""
    from tdnnf_nas_torch.core.checkpoint import latest_step

    got, _, work = two_ranks
    ref_objf, ref_params = _recipe(str(tmp_path / "one"))
    objf = got["recipe|objf"]
    assert len(objf) == _RECIPE_STEPS and np.all(np.isfinite(objf))
    np.testing.assert_allclose(objf[0], ref_objf[0], rtol=1e-5)
    assert np.max(np.abs(objf - ref_objf)) < 5e-4
    for p, x in ref_params.items():
        np.testing.assert_allclose(got[f"recipe|{p}"], x, rtol=0, atol=5e-4,
                                   err_msg=p)
    rank0 = os.path.join(work, "ckpt_rank0")
    assert latest_step(rank0) == _RECIPE_STEPS
    assert sorted(os.listdir(rank0)) == sorted(
        f"ckpt_{s:08d}{e}" for s in (_CKPT_EVERY, _RECIPE_STEPS)
        for e in (".json", ".npz"))
    assert not os.path.exists(os.path.join(work, "ckpt_rank1"))
    ckpt = np.load(os.path.join(rank0, f"ckpt_{_RECIPE_STEPS:08d}.npz"))
    # the params are the checkpoint's first leaves, in tree_paths' order
    for i, x in enumerate(got[f"recipe|{p}"] for p in ref_params):
        np.testing.assert_array_equal(ckpt[f"leaf_{i}"], x)


def test_host_sharded_iterator_one_process_equals_batching():
    """Outside a process group the shard is the whole list, and the
    batches are batch_iterator's with the same rng."""
    from tdnnf_nas_torch.data import batch_iterator

    chunks = _world()[0]
    assert parallel.local_shard_range(len(chunks)) == (0, len(chunks))
    mesh = parallel.Mesh(group=None, rank=0, size=1,
                         device=torch.device("cpu"))
    got = parallel.host_sharded_iterator(chunks, 4, mesh,
                                         np.random.RandomState(3), epochs=1)
    want = batch_iterator(chunks, 4, rng=np.random.RandomState(3), epochs=1)
    n = 0
    for a, b in zip(got, want):
        assert torch.equal(a["feats"], torch.from_numpy(b["feats"]))
        assert torch.equal(a["sup"].mask, torch.from_numpy(b["sup"].mask))
        n += 1
    assert n == len(chunks) // 4


def test_mesh_rows_and_preconditions():
    mesh = parallel.Mesh(group=None, rank=1, size=2,
                         device=torch.device("cpu"))
    assert mesh.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(7)
    batch = {"feats": np.arange(8 * 3, dtype=np.float32).reshape(8, 3, 1),
             "sup": _world()[0][0].sup.__class__(
                 trans=np.zeros((8, 1, 1), np.float32),
                 state_pdf=np.arange(8, dtype=np.int32)[:, None],
                 init=np.ones((8, 1), np.float32),
                 final=np.ones((8, 1), np.float32),
                 mask=np.ones((8, 2, 1), np.uint8),
                 next_w=np.zeros((8, 0), np.float32))}
    local = parallel.put_batch(batch, mesh)
    assert local["feats"].shape == (4, 3, 1)
    assert local["sup"].state_pdf[:, 0].tolist() == [4, 5, 6, 7]
    with pytest.raises(RuntimeError, match="initialised process group"):
        parallel.make_mesh(device="cpu")


def test_initialize_from_env_without_coordinator(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert parallel.initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()
