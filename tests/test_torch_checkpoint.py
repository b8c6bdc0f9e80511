"""The port's checkpoints and config JSON vs the JAX package (CPU): JAX
checkpoints of a plain and of a supernet state load into the port and
the port's load into JAX, leaf for leaf; keep-2 cleanup; an exact resume
of a sampling supernet run; every config through JSON.

Small configs: the 2-layer model of tests/test_egs_file.py and the
3-layer supernets of tests/test_torch_nas_train_step.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tdnnf_nas_tpu import models as jmodels
from tdnnf_nas_tpu import train as jtrain
from tdnnf_nas_tpu.core import checkpoint as jckpt
from tdnnf_nas_torch import convert
from tdnnf_nas_torch import models as tmodels
from tdnnf_nas_torch import train as ttrain
from tdnnf_nas_torch.core import checkpoint as tckpt
from tdnnf_nas_torch.train.optimizer import tree_paths
from tests.test_torch_nas_train_step import _cfgs

torch.set_num_threads(1)

_PLAIN = dict(feat_dim=10, ivector_dim=0, hidden_dim=24, bottleneck_dim=8,
              time_strides=(1, 2), num_pdfs=12, prefinal_big=24,
              prefinal_small=12, compute_dtype="float32")


def _configs(kind):
    """(JAX cfg, port cfg, supernet) of a plain model or a supernet that
    searches offsets and bottlenecks (alphas of three kinds)."""
    if kind == "plain":
        return (jmodels.TdnnfModelConfig(**_PLAIN),
                tmodels.TdnnfModelConfig(**_PLAIN), False)
    both = dict(search_bottleneck=True, bottleneck_groups=(2, 2))
    return (_cfgs(jmodels, 12, "offsets").replace(**both),
            _cfgs(tmodels, 12, "offsets").replace(**both), True)


def _random_jax_state(jcfg, supernet, step=5):
    """A JAX TrainState whose every leaf is distinct seeded data, so that
    a swapped leaf shows."""
    st = jtrain.init_train_state(jcfg, jtrain.TrainerConfig(),
                                 jax.random.PRNGKey(0), supernet=supernet)
    rng = np.random.RandomState(1)
    rand = lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32))
    return dataclasses.replace(
        jax.tree.map(rand, dataclasses.replace(st, step=None)),
        step=jnp.asarray(step, jnp.int32))


def _port_like(tcfg, supernet):
    return ttrain.init_train_state(tcfg, ttrain.TrainerConfig(),
                                   torch.Generator().manual_seed(9), "cpu",
                                   supernet=supernet)


def _from_jax(jst, supernet):
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    if supernet:
        return convert.supernet_state_from_numpy(
            *(np_tree(t) for t in (jst.params, jst.alphas, jst.bn_state,
                                   jst.opt_state, jst.alpha_opt_state)),
            int(jst.step), device="cpu")
    return convert.train_state_from_numpy(
        np_tree(jst.params), np_tree(jst.bn_state), np_tree(jst.opt_state),
        int(jst.step), device="cpu")


def _assert_states_equal(a, b):
    for name in ("params", "alphas", "bn_state", "opt_state",
                 "alpha_opt_state"):
        pa, pb = tree_paths(getattr(a, name)), tree_paths(getattr(b, name))
        assert [p for p, _ in pa] == [p for p, _ in pb], name
        for (p, x), (_, y) in zip(pa, pb):
            assert x.dtype == y.dtype and torch.equal(x, y), (name, p)
    assert a.step == b.step


@pytest.mark.parametrize("kind", ["plain", "supernet"])
def test_jax_checkpoint_loads_into_port(tmp_path, kind):
    """A JAX ``save_checkpoint`` loads into the port equal to
    ``convert.*_state_from_numpy`` of the same arrays; the leaf order is
    JAX's (params, alphas, bn_state, opt_state, alpha_opt_state, step)."""
    jcfg, tcfg, supernet = _configs(kind)
    jst = _random_jax_state(jcfg, supernet)
    jckpt.save_checkpoint(str(tmp_path), 5, jst, meta={"note": kind})
    state, step, meta = tckpt.load_checkpoint(str(tmp_path),
                                              _port_like(tcfg, supernet))
    assert step == 5 and meta == {"note": kind}
    _assert_states_equal(state, _from_jax(jst, supernet))
    if not supernet:
        assert state.alphas == {} and state.alpha_opt_state == {
            "m": {}, "v": {}}


@pytest.mark.parametrize("kind", ["plain", "supernet"])
def test_port_checkpoint_loads_into_jax(tmp_path, kind):
    """A port ``save_checkpoint`` loads through JAX's ``load_checkpoint``
    equal to the port's arrays, and through the port's own equal to the
    saved state."""
    jcfg, tcfg, supernet = _configs(kind)
    tst = _from_jax(_random_jax_state(jcfg, supernet, step=3), supernet)
    path = tckpt.save_checkpoint(str(tmp_path), 3, tst, meta={"k": [1, 2]})
    with open(path + ".json") as f:
        info = json.load(f)
    assert info["step"] == 3 and info["meta"] == {"k": [1, 2]}
    jlike = jtrain.init_train_state(jcfg, jtrain.TrainerConfig(),
                                    jax.random.PRNGKey(4), supernet=supernet)
    jst, step, _ = jckpt.load_checkpoint(str(tmp_path), jlike)
    assert step == 3 and int(jst.step) == 3
    for name in ("params", "alphas", "bn_state", "opt_state",
                 "alpha_opt_state"):
        got = jax.tree_util.tree_leaves(getattr(jst, name))
        ref = [x.numpy() for _, x in tree_paths(getattr(tst, name))]
        assert len(got) == len(ref) and (len(ref) > 0) == (
            supernet or name not in ("alphas", "alpha_opt_state")), name
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(x), y, err_msg=name)
    back, _, _ = tckpt.load_checkpoint(str(tmp_path),
                                       _port_like(tcfg, supernet))
    _assert_states_equal(back, tst)


def test_keep_two_latest_step_and_checks(tmp_path):
    """Keep-2 cleanup, ``latest_step``, loading a named step, and the leaf
    count and shape checks."""
    jcfg, tcfg, _ = _configs("plain")
    tst = _from_jax(_random_jax_state(jcfg, False), False)
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(d, tst)
    for s in (7, 8, 9):
        tckpt.save_checkpoint(d, s, dataclasses.replace(tst, step=s))
    assert tckpt.latest_step(d) == 9
    assert sorted(os.listdir(d)) == [f"ckpt_{s:08d}{e}" for s in (8, 9)
                                     for e in (".json", ".npz")]
    st, step, meta = tckpt.load_checkpoint(d, tst, step=8)
    assert step == 8 and st.step == 8 and meta == {}
    tckpt.save_checkpoint(d, 10, tst, keep=0)
    assert tckpt.latest_step(d) == 10 and len(os.listdir(d)) == 6
    _, scfg, _ = _configs("supernet")
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_checkpoint(d, _port_like(scfg, True))
    wide = tmodels.TdnnfModelConfig(**dict(_PLAIN, hidden_dim=32))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(d, _port_like(wide, False))


def _supernet_batches(n):
    from tests.test_torch_dense_train_step import _build
    from tdnnf_nas_torch.data import batch_iterator

    bundle, _, _ = _build("torch")
    cfg = _cfgs(tmodels, bundle.tree.num_pdfs, "offsets")
    chunks = bundle.egs(None, chunk_width=16, max_phones_per_chunk=12,
                        supernet_cfg=cfg)
    it = batch_iterator(chunks, batch_size=4, rng=np.random.RandomState(0))
    return bundle, cfg, [convert.batch_to_torch(next(it), device="cpu")
                         for _ in range(n)]


def test_resumed_run_equals_unbroken_run(tmp_path):
    """Uniform path sampling with dropout on: 2 steps, save, load into a
    fresh state, 2 more steps (a new step function, as a new process
    builds) equal 4 unbroken steps bit for bit, since each step's draws
    depend on (seed, state.step) alone; another seed draws otherwise."""
    bundle, cfg, batches = _supernet_batches(4)
    tc = ttrain.TrainerConfig(
        search_mode="uniform", dropout_schedule=((0.0, 0.2), (1.0, 0.2)),
        optimizer=ttrain.OptimizerConfig(lr_initial=2e-3, lr_final=1e-3,
                                         num_steps=4))
    den = bundle.den_arrays

    def fresh(seed):
        return ttrain.init_train_state(cfg, tc,
                                       torch.Generator().manual_seed(seed),
                                       "cpu", supernet=True)

    def run(state, bs, seed=11):
        step = ttrain.make_train_step(cfg, tc, den, seed=seed, supernet=True)
        for b in bs:
            state, _ = step(state, b)
        return state

    unbroken = run(fresh(0), batches)
    half = run(fresh(0), batches[:2])
    tckpt.save_checkpoint(str(tmp_path), 2, half)
    loaded, _, _ = tckpt.load_checkpoint(str(tmp_path), fresh(5))
    assert loaded.step == 2
    resumed = run(loaded, batches[2:])
    _assert_states_equal(resumed, unbroken)
    other = run(tckpt.load_checkpoint(str(tmp_path), fresh(5))[0],
                batches[2:], seed=12)
    assert not torch.equal(other.params["tdnnf2"]["linear"],
                           unbroken.params["tdnnf2"]["linear"])


def test_step_seed_depends_on_seed_and_step_alone():
    seeds = {ttrain.trainer.step_seed(s, k) for s in (0, 1) for k in (0, 1)}
    assert len(seeds) == 4
    assert ttrain.trainer.step_seed(3, 7) == ttrain.trainer.step_seed(3, 7)


def _all_configs(pkg_models, pkg_train, pkg_data):
    """One config of each kind with non-default values everywhere a tuple
    or a nested config can go."""
    base = pkg_models.TdnnfModelConfig(
        hidden_dim=64, time_strides_asym=((1, 2), (0, 3)),
        bottleneck_dims=(8, 16), dropout_proportion=0.1)
    return [
        base,
        pkg_models.DartsModelConfig(base=base, search_offsets=False,
                                    fixed_strides=((1, 1), (3, 3)),
                                    search_bottleneck=True,
                                    bottleneck_groups=(2, 4)),
        pkg_train.OptimizerConfig(lr_initial=3e-3, alpha_lr_scale=2.0),
        pkg_train.ChainObjectiveConfig(den_obs_bf16=True),
        pkg_train.TrainerConfig(
            objective=pkg_train.ChainObjectiveConfig(xent_regularize=0.2),
            optimizer=pkg_train.OptimizerConfig(num_steps=7),
            search_mode="gumbel",
            dropout_schedule=((0.0, 0.0), (0.5, 0.3), (1.0, 0.0))),
        pkg_data.EgsConfig(chunk_width=50, extra_chunk_widths=(40, 60)),
        pkg_data.SyntheticCorpusConfig(num_utts=11),
    ]


def test_configs_round_trip_through_json():
    """Every port config equals itself after ``to_json``/``from_json``
    (lists come back as tuples), and its JSON equals the JAX package's
    ``asdict_config`` of the same config."""
    from tdnnf_nas_tpu import data as jdata
    from tdnnf_nas_tpu.core.config import asdict_config as jasdict
    from tdnnf_nas_torch import data as tdata
    from tdnnf_nas_torch.core.config import asdict_config, config_from_dict

    tcs = _all_configs(tmodels, ttrain, tdata)
    jcs = _all_configs(jmodels, jtrain, jdata)
    for tc, jc in zip(tcs, jcs):
        name = type(tc).__name__
        back = type(tc).from_json(tc.to_json())
        assert back == tc, name
        assert hash(back) == hash(tc), name
        assert json.loads(tc.to_json()) == jasdict(jc), name
        # a JAX config's dict (e.g. a JAX checkpoint's meta) builds the
        # same port config
        assert config_from_dict(type(tc), jasdict(jc)) == tc, name
        assert asdict_config(tc) == jasdict(jc), name
    with pytest.raises(ValueError, match="unknown config field"):
        config_from_dict(ttrain.OptimizerConfig, {"no_such": 1})
