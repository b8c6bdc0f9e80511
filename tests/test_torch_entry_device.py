"""The port's device rule: every entry point runs on the card unless its
caller passes ``device="cpu"``; without a CUDA device, a call that leaves
``device`` out raises at once instead of running on the CPU."""

import inspect

import numpy as np
import pytest
import torch

from tdnnf_nas_torch import convert
from tdnnf_nas_torch.core.device import DEFAULT_DEVICE, resolve_device
from tdnnf_nas_torch.data import audio, ivector
from tdnnf_nas_torch.decode import align, wfst
from tdnnf_nas_torch.gmm import gmm as gmm_mod
from tdnnf_nas_torch.gmm import ladder
from tdnnf_nas_torch.lm import rnnlm
from tdnnf_nas_torch.models import bayes, cnn, lhuc, nas, tdnnf
from tdnnf_nas_torch.ops import extras
from tdnnf_nas_torch.parallel import mesh as mesh_mod
from tdnnf_nas_torch.parallel import multihost
from tdnnf_nas_torch.recipes import chain_recipes
from tdnnf_nas_torch.tools import (bench_dense_den, bench_scaling,
                                   bench_triphone_den, context_compare,
                                   e2e_flagship, e2e_search, e2e_wer_pipeline,
                                   lhuc_regularized, profile_components,
                                   profile_den, rnnlm_fair_fight,
                                   search_planted_table,
                                   search_sanity_planted, wer_synthetic,
                                   wpd_compare)
from tdnnf_nas_torch.train import trainer
from tdnnf_nas_torch.train.optimizer import tree_paths

# (function, positional arguments that are never reached: the device is
# resolved before any of them is used)
_ENTRY_POINTS = {
    "train_model": (chain_recipes.train_model, (None, None, None, 1)),
    "profile_components": (profile_components.run, ()),
    "profile_den": (profile_den.run, ()),
    "bench_triphone_den": (bench_triphone_den.run, ()),
    "bench_scaling": (bench_scaling.run, ()),
    "bench_dense_den": (bench_dense_den.run, ()),
    "run_offset_search_pipeline": (
        chain_recipes.run_offset_search_pipeline, (None, None)),
    "run_bottleneck_search_pipeline": (
        chain_recipes.run_bottleneck_search_pipeline, (None, None)),
    "init_train_state": (trainer.init_train_state, (None, None, None)),
    "init_model": (tdnnf.init_model, (None, None)),
    "init_supernet": (nas.init_supernet, (None, None)),
    "tree_to_torch": (convert.tree_to_torch, ({},)),
    "batch_to_torch": (convert.batch_to_torch, ({},)),
    "forward_corpus": (chain_recipes.forward_corpus, (None, None, None, [])),
    "decode_corpus": (chain_recipes.decode_corpus, (None, None, None)),
    "decode_corpus_words": (chain_recipes.decode_corpus_words,
                            (None, None, None, None, [])),
    "align_corpus": (align.align_corpus, (None, None, None, [])),
    "align_utterance": (align.align_utterance, (None, [0], None, None, None)),
    "decode_words": (wfst.decode_words, (None, None)),
    "train_ubm": (ivector.train_ubm, (None, None)),
    "train_ivector_extractor": (ivector.train_ivector_extractor,
                                (None, None, None)),
    "extract_ivectors": (ivector.extract_ivectors, (None, None, None)),
    "init_rnnlm": (rnnlm.init_rnnlm, (None, None)),
    "train_rnnlm": (rnnlm.train_rnnlm, (None, None)),
    "init_lhuc": (lhuc.init_lhuc, (None,)),
    "adapt_lhuc": (lhuc.adapt_lhuc, (None,) * 6),
    "lhuc_adapt_and_decode": (e2e_flagship.lhuc_adapt_and_decode,
                              (None,) * 12),
    "rnnlm_params_from_numpy": (convert.rnnlm_params_from_numpy, ({},)),
    "lhuc_from_numpy": (convert.lhuc_from_numpy, ({},)),
    "run_gmm_ladder": (ladder.run_gmm_ladder, (None, None, None)),
    "train_mono": (gmm_mod.train_mono, (None, None, None)),
    "bootstrap_alignments_gmm": (chain_recipes.bootstrap_alignments_gmm,
                                 (None, None, None)),
    "bootstrap_stage": (e2e_flagship.bootstrap_stage, (None,) * 5),
    "build_setup": (e2e_flagship.build_setup, (None,)),
    "run_base": (e2e_flagship.run_base, (None,)),
    "run_search": (e2e_search.run_search, (None,)),
    "e2e_main": (e2e_flagship.main, (["all", "--out", "unused"],)),
    "search_sanity_main": (search_sanity_planted.main, ()),
    "search_table_main": (search_planted_table.main, ()),
    "e2e_wer_main": (e2e_wer_pipeline.main, (["all", "--out", "unused"],)),
    "e2e_wer_build_setup": (e2e_wer_pipeline.build_setup, ("sil", None)),
    "e2e_wer_run_base": (e2e_wer_pipeline.run_base, (None,)),
    "e2e_wer_run_search": (e2e_wer_pipeline.run_search, (None,)),
    "lhuc_regularized_main": (lhuc_regularized.main, (["--out", "unused"],)),
    "rnnlm_fair_fight_main": (rnnlm_fair_fight.main, (["--out", "unused"],)),
    "context_compare_main": (context_compare.main, (["--out", "unused"],)),
    "wpd_compare_main": (wpd_compare.main, (["--out", "unused"],)),
    "wer_synthetic_main": (wer_synthetic.main, (["--out", "unused"],)),
    "featurize_batch": (audio.featurize_batch, ([np.zeros(400)], None)),
    "init_bayes_model": (bayes.init_bayes_model, (None, None)),
    "init_cnn_frontend": (cnn.init_cnn_frontend, (None, None)),
    "init_cnn_tdnnf": (cnn.init_cnn_tdnnf, (None, None)),
    "normal_rand": (extras.normal_rand, (2, 3, None)),
    "opt_state_from_numpy": (convert.opt_state_from_numpy, ({},)),
    "am_gmm_from_jax": (convert.am_gmm_from_jax, (None,)),
    "ladder_result_from_jax": (convert.ladder_result_from_jax, (None,)),
    "make_mesh": (mesh_mod.make_mesh, ()),
    "global_mesh": (multihost.global_mesh, ()),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    fn, _ = _ENTRY_POINTS[name]
    default = inspect.signature(fn).parameters["device"].default
    assert default == DEFAULT_DEVICE == "cuda"
    assert torch.device(default).type == "cuda"


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_without_cuda_raises(name, monkeypatch):
    """Holds on any host: CUDA is hidden, so the default cannot be met."""
    fn, args = _ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args)


def test_dense_den_converter_needs_a_device():
    """DenGraphArrays.from_graph has no default device, as
    BlockedDenGraph.from_host has none: leaving it out raises TypeError;
    an explicit "cpu" copies every array there."""
    from tdnnf_nas_torch.graphs.fsa import StateGraph
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays

    trans = np.full((3, 3), 1.0 / 3, np.float32)
    g = StateGraph(trans=trans, state_pdf=np.arange(3, dtype=np.int32),
                   init=np.full(3, 1.0 / 3, np.float32),
                   final=np.ones(3, np.float32), num_pdfs=3)
    with pytest.raises(TypeError):
        DenGraphArrays.from_graph(g)
    arrays = DenGraphArrays.from_graph(g, "cpu")
    assert arrays.trans.device.type == "cpu"
    assert all(getattr(arrays, f).device.type == "cpu" for f in (
        "state_pdf", "init", "final"))


def test_explicit_cpu_runs_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tdnnf.TdnnfModelConfig(
        feat_dim=8, ivector_dim=0, hidden_dim=16, bottleneck_dim=4,
        time_strides=(1,), num_pdfs=5, prefinal_big=16, prefinal_small=4)
    params, _ = tdnnf.init_model(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    leaves = tree_paths(params)
    assert leaves and all(v.device.type == "cpu" for _, v in leaves)
    tree = convert.tree_to_torch({"a": np.ones(3, np.float32)}, device="cpu")
    assert tree["a"].device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


def test_initialize_from_env_defaults_to_nccl_on_the_card(monkeypatch):
    """With the coordinator's address set, the default device picks the
    NCCL backend, and without a card it raises before any connection is
    tried; no other backend is tried."""
    assert (inspect.signature(multihost.initialize_from_env)
            .parameters["device"].default == DEFAULT_DEVICE)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize_from_env()
    assert calls == []
    assert multihost.initialize_from_env(device="cpu") is True
    assert calls[-1]["backend"] == "gloo"
    assert calls[-1]["init_method"] == "tcp://localhost:1"
    assert multihost.initialize_from_env(backend="nccl",
                                         device="cpu") is True
    assert calls[-1]["backend"] == "nccl"


def test_train_model_mesh_takes_the_mesh_device():
    """train_model's mesh argument defaults to None (one process on
    ``device``); a mesh brings its own device, which make_mesh resolved
    from its own card default."""
    params = inspect.signature(chain_recipes.train_model).parameters
    assert params["mesh"].default is None
    assert params["device"].default == DEFAULT_DEVICE
    assert (inspect.signature(trainer.make_train_step)
            .parameters["mesh"].default is None)


def test_factored_and_sparse_den_converters_need_a_device():
    """The factored and sparse dens' device copies, and den_on_device,
    have no default device, as BlockedDenGraph.from_host has none."""
    from tdnnf_nas_torch.ops.fwdbwd import FactoredDenGraph, SparseDenGraph

    for fn in (FactoredDenGraph.from_host, SparseDenGraph.from_graph,
               SparseDenGraph.from_arcs, chain_recipes.den_on_device):
        dev = inspect.signature(fn).parameters["device"]
        assert dev.default is inspect.Parameter.empty, fn.__qualname__
