"""The plain TDNN-F (7q) trained with LF-MMI against a composed n-gram
den through the blocked den kernels.

Host set-up, as ``tdnnf_nas_torch.tools.profile_den.production_setup``
builds it, sized by the configuration's ``corpus``, ``tree`` and ``den``
sections: the synthetic corpus, the clustered left-context tree, the
n-gram phone LM composed into the den (``prepare_data``) and the chunks.
The reference takes the den as its positions and arcs (``den_fsa``), and
each chunk's numerator as its dense graph.
"""

from __future__ import annotations

import numpy as np

from portbench.flops import blocked_den as den_flops
from portbench.flops import tdnnf as model_flops

DEN_CLASS = "blocked_den"


def host_setup(config: dict) -> dict:
    from tdnnf_nas_torch.data import (SyntheticCorpusConfig,
                                      make_synthetic_corpus)
    from tdnnf_nas_torch.graphs import (accumulate_triphone_stats,
                                        build_clustered_triphone_tree)
    from tdnnf_nas_torch.recipes.chain_recipes import prepare_data

    corpus = SyntheticCorpusConfig(**config["corpus"])
    utts, phone_seqs, _, topo = make_synthetic_corpus(corpus)
    stats = accumulate_triphone_stats(
        [u.feats for u in utts], phone_seqs, [u.begins for u in utts],
        corpus.num_phones, corpus.frame_subsampling_factor)
    tree = build_clustered_triphone_tree(
        stats, num_leaves=config["tree"]["num_leaves"])
    bundle = prepare_data(utts, phone_seqs, tree, topo, corpus.num_phones,
                          **config["den"])
    model_cfg = model_config(config)
    if tree.num_pdfs != model_cfg.num_pdfs:
        raise ValueError(f"the tree has {tree.num_pdfs} pdfs, the "
                         f"configuration {model_cfg.num_pdfs}")
    chunks = bundle.egs(model_cfg, **config["egs"])
    return {"bundle": bundle, "chunks": chunks}


def build_kernels(device) -> None:
    if device.type == "cuda":
        from tdnnf_nas_torch.ops import cuda_build

        cuda_build.build()


def model_config(config: dict):
    from tdnnf_nas_torch.models import TdnnfModelConfig

    m = dict(config["model"])
    m["time_strides"] = tuple(m["time_strides"])
    return TdnnfModelConfig(**m)


def trainer_config(config: dict, **extra):
    from tdnnf_nas_torch.train import (ChainObjectiveConfig, OptimizerConfig,
                                       TrainerConfig)

    t = config["training"]
    return TrainerConfig(objective=ChainObjectiveConfig(**t["objective"]),
                         optimizer=OptimizerConfig(**t["optimizer"]),
                         semiorth_interval=t["semiorth_interval"], **extra)


def weights_spec(config: dict):
    """[(path, shape, init)] of the 7q's parameters: N(0, 1/fan_in)
    weights (the output layers too, so that every layer has a gradient
    at the first step), zero biases, identity lda."""
    m = config["model"]
    h, bd = m["hidden_dim"], m["bottleneck_dim"]
    lda = 3 * m["feat_dim"] + m["ivector_dim"]
    spec = [(("lda", "w"), (lda, lda), "eye"), (("lda", "b"), (lda,), "zeros"),
            (("tdnn1", "w"), (lda, h), lda), (("tdnn1", "b"), (h,), "zeros")]
    for i, s in enumerate(m["time_strides"]):
        k = 2 if s > 0 else 1
        spec += [((f"tdnnf{i + 2}", "linear"), (k, h, bd), k * h),
                 ((f"tdnnf{i + 2}", "affine"), (k, bd, h), k * bd),
                 ((f"tdnnf{i + 2}", "affine_b"), (h,), "zeros")]
    return spec + head_spec(m)


def head_spec(m: dict):
    h, big, small = m["hidden_dim"], m["prefinal_big"], m["prefinal_small"]
    spec = [(("prefinal_l",), (h, small), h)]
    for head in ("chain", "xent"):
        spec += [((f"prefinal_{head}", "affine_w"), (small, big), small),
                 ((f"prefinal_{head}", "affine_b"), (big,), "zeros"),
                 ((f"prefinal_{head}", "linear"), (big, small), big),
                 ((f"output_{head}", "w"), (small, m["num_pdfs"]), small),
                 ((f"output_{head}", "b"), (m["num_pdfs"],), "zeros")]
    return spec


def program(config: dict, setup: dict, params: dict, seed: int, device):
    """The program's step (``make_train_step``) and its state on the
    benchmark's weights."""
    from tdnnf_nas_torch.models.tdnnf import _init_bn_state
    from tdnnf_nas_torch.recipes.chain_recipes import den_on_device
    from tdnnf_nas_torch.train import TrainState, make_train_step
    from tdnnf_nas_torch.train.optimizer import make_optimizer
    from tdnnf_nas_torch.train.trainer import _wd_scale

    model_cfg = model_config(config)
    trainer_cfg = trainer_config(config)
    den = den_on_device(setup["bundle"], device)
    opt_init, _ = make_optimizer(trainer_cfg.optimizer, _wd_scale)
    state = TrainState(params=params, bn_state=_init_bn_state(model_cfg,
                                                              device),
                       opt_state=opt_init(params), step=0)
    return {"step": make_train_step(model_cfg, trainer_cfg, den),
            "state": state}


def reference_den(fsa, device) -> dict:
    import torch

    from portbench.reference.den import dense_from_positions

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return {"trans": dense_from_positions(fsa.seg_bounds, fsa.arc_src_pos,
                                          fsa.arc_dst, fsa.arc_w,
                                          fsa.num_states, device),
            "state_pdf": t(fsa.state_pdf, torch.int64), "init": t(fsa.init),
            "final": t(fsa.final)}


def reference(config: dict, setup: dict, seed: int, device, prec=None):
    from portbench.reference.model import F32
    from portbench.reference.train import tdnnf_forward_fn

    return (tdnnf_forward_fn(config["model"], prec or F32),
            reference_den(setup["bundle"].den_fsa, device))


def den_size(setup: dict):
    fsa = setup["bundle"].den_fsa
    return int(fsa.num_states), int(len(fsa.arc_dst))


def flops(config: dict, traffic: dict, setup: dict) -> dict:
    """Required operations a step: the model's GEMMs forward and backward
    and the den pair's operations and bytes."""
    b, w = traffic["batch"], config["egs"]["chunk_width"]
    s, a = den_size(setup)
    obs_bytes = 2 if config["training"]["objective"].get("den_obs_bf16") else 4
    ops, nbytes = den_flops.ops_bytes(b, w, s, a, obs_bytes)
    return {"model": model_flops.train_flops(config["model"], b, w),
            "den_ops": ops, "den_bytes": nbytes, "den_class": DEN_CLASS}
