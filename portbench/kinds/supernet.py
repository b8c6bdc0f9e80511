"""The DARTS context-offset supernet over the 7q, stage A (uniform
one-hot path sampling, theta trained), against the left-biphone dense
den through the dense den kernels.

Host set-up as ``tdnnf_nas_torch.tools.search_flagship`` builds it, sized
by the configuration's ``corpus`` section: the synthetic corpus, the
left-biphone tree, the bigram phone LM, the dense den and the chunks with
the supernet's full context.  The reference takes the den's dense
transition, and draws each step's path samples again from the run's
seed.
"""

from __future__ import annotations

import numpy as np

from portbench.flops import dense_den as den_flops
from portbench.flops import supernet as model_flops
from portbench.kinds import tdnnf

DEN_CLASS = "dense_den"
build_kernels = tdnnf.build_kernels


def host_setup(config: dict) -> dict:
    from tdnnf_nas_torch.data import (EgsConfig, SyntheticCorpusConfig,
                                      make_egs, make_synthetic_corpus)
    from tdnnf_nas_torch.graphs import (BiphoneTree, build_denominator_graph,
                                        den_init_lookup, estimate_phone_lm)
    from tdnnf_nas_torch.models import supernet_context

    corpus = SyntheticCorpusConfig(**config["corpus"])
    utts, phone_seqs, _, topo = make_synthetic_corpus(corpus)
    tree = BiphoneTree(corpus.num_phones, num_leaves=config["tree"][
        "num_leaves"])
    if tree.num_pdfs != config["model"]["num_pdfs"]:
        raise ValueError(f"the tree has {tree.num_pdfs} pdfs, the "
                         f"configuration {config['model']['num_pdfs']}")
    lm = estimate_phone_lm(phone_seqs, corpus.num_phones)
    den = build_denominator_graph(lm, topo, tree)
    left, right = supernet_context(model_config(config))
    egs_cfg = EgsConfig(left_context=left, right_context=right,
                        **config["egs"])
    chunks = make_egs(utts, lm, topo, tree, egs_cfg,
                      den_init_fn=den_init_lookup(den, corpus.num_phones))
    return {"den": den, "chunks": chunks}


def model_config(config: dict):
    from tdnnf_nas_torch.models import DartsModelConfig

    m = dict(config["model"])
    k = m.pop("max_stride")
    base = tdnnf.model_config({"model": m})
    return DartsModelConfig(base=base, search_offsets=True, max_stride=k)


def weights_spec(config: dict):
    """The supernet's parameters: per TDNN-F layer K = max_stride + 1
    linear and affine branch weights, drawn N(0, 1/fan_in) with the fan-in
    of two live branches (as the system initialises them)."""
    m = config["model"]
    h, bd, k = m["hidden_dim"], m["bottleneck_dim"], m["max_stride"] + 1
    lda = 3 * m["feat_dim"] + m["ivector_dim"]
    spec = [(("lda", "w"), (lda, lda), "eye"), (("lda", "b"), (lda,), "zeros"),
            (("tdnn1", "w"), (lda, h), lda), (("tdnn1", "b"), (h,), "zeros")]
    for i in range(len(m["time_strides"])):
        spec += [((f"tdnnf{i + 2}", "linear"), (k, h, bd), 2 * h),
                 ((f"tdnnf{i + 2}", "affine"), (k, bd, h), 2 * bd),
                 ((f"tdnnf{i + 2}", "affine_b"), (h,), "zeros")]
    return spec + tdnnf.head_spec(m)


def program(config: dict, setup: dict, params: dict, seed: int, device):
    import torch

    from tdnnf_nas_torch.models import SearchMode
    from tdnnf_nas_torch.models.tdnnf import _init_bn_state
    from tdnnf_nas_torch.ops.fwdbwd import DenGraphArrays
    from tdnnf_nas_torch.train import TrainState, make_train_step
    from tdnnf_nas_torch.train.optimizer import make_optimizer
    from tdnnf_nas_torch.train.trainer import _wd_scale

    model_cfg = model_config(config)
    trainer_cfg = tdnnf.trainer_config(config,
                                       search_mode=SearchMode.UNIFORM)
    den = DenGraphArrays.from_graph(setup["den"], device)
    opt_init, _ = make_optimizer(trainer_cfg.optimizer, _wd_scale)
    a_init, _ = make_optimizer(trainer_cfg.optimizer)
    k, layers = model_cfg.num_candidates, model_cfg.num_layers
    alphas = {"offsets_linear": torch.zeros(layers, k, device=device),
              "offsets_affine": torch.zeros(layers, k, device=device)}
    state = TrainState(params=params,
                       bn_state=_init_bn_state(model_cfg.base, device),
                       opt_state=opt_init(params), step=0, alphas=alphas,
                       alpha_opt_state=a_init(alphas))
    return {"step": make_train_step(model_cfg, trainer_cfg, den, seed=seed,
                                    supernet=True),
            "state": state}


def reference(config: dict, setup: dict, seed: int, device, prec=None):
    import torch

    from portbench.reference.model import F32
    from portbench.reference.train import supernet_forward_fn

    g = setup["den"]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    den = {"trans": t(g.trans), "state_pdf": t(g.state_pdf, torch.int64),
           "init": t(g.init), "final": t(g.final)}
    return supernet_forward_fn(config["model"], seed, prec or F32), den


def flops(config: dict, traffic: dict, setup: dict) -> dict:
    b, w = traffic["batch"], config["egs"]["chunk_width"]
    trans = np.asarray(setup["den"].trans)
    ops, nbytes = den_flops.ops_bytes(b, w, trans.shape[0],
                                      int(np.count_nonzero(trans)))
    return {"model": model_flops.train_flops(config["model"], b, w),
            "den_ops": ops, "den_bytes": nbytes, "den_class": DEN_CLASS}
