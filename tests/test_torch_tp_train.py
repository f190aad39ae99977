"""The "model" axis computing in training, on the CPU: the train step on a
``(data, model)`` mesh, its gradients, and checkpoints across meshes.

Gloo worlds (``tests/_torch_dist.py``): 2 ranks on ``make_host_mesh(1, 2)``
(every config of ``TP_ARCHS``) and 4 ranks on ``make_host_mesh(2, 2)``
(the dense, mamba and hybrid configs: an MoE routes each data rank's
tokens on their own, ``tests/test_torch_dp_train.py``).  Each rank trains
its slice of the same f32 state (``state_from_jax`` of NumPy drawn from a
seed, then ``shard_state``) 3 steps on batches of 4 rows x 8 tokens:

* loss, CE and gnorm within ``TOL`` relative of the single-process
  step's, the lr equal, mu and nu within ``TOL`` of each leaf's max
  |single|, and the new params AdamW's update of the previous ones by the
  new moments (``tests/_torch_train.py``'s rules), after every step;
* each step's clipped gradient (gathered over the model group) within
  ``TOL`` of each leaf's max |single|;
  falcon-mamba-7b's gradient at 2 ways is held on its own: B13's backward
  returns dB and dC summed over a rank's own channels, and without the
  sum over the model group its ``x_proj`` and ``in_proj`` gradients are
  wrong;
* every rank holds the same gathered state bit for bit; the state
  gathered onto rank 0 alone (a checkpoint's writer) is the full one, on
  the host, bit for bit, and None on the other ranks; a model axis of 1
  (a replicated ``(1, 1)`` mesh in the same world) is the plain step bit
  for bit;
* ``train_loop`` on ``(1, 2)`` writes a checkpoint that one process
  restores bit for bit (the state the ranks gathered), and restores a
  checkpoint one process wrote, bit for bit.

The ranks sum partial products in another order than one device: ``TOL =
1e-5``.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import tree as trees
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenStream
from repro_torch.launch import steps, train

from _torch_dist import (TP_ARCHS, start_worlds, tp_config, tp_params_np,
                         tp_train_run)
from _torch_train import batches, check_metrics, check_moments, check_update

TOL = 1e-5
STEPS = 3
#: the configs of the data x model world
DM_ARCHS = ("llama3.2-1b", "falcon-mamba-7b", "hymba-1.5b:split")
WORLDS = {"m2": (2, 2, TP_ARCHS), "d2m2": (4, 2, DM_ARCHS)}


def state_np(name):
    """The f32 ``TrainState`` of ``name`` as NumPy (params from the seed,
    zero moments)."""
    cfg = tp_config(name).with_(dtype="float32")
    params = tp_params_np(cfg)
    zeros = trees.tree_map(np.zeros_like, params)
    return steps.TrainState(params=params, opt=steps.AdamWState(
        step=np.int32(0), mu=zeros, nu=trees.tree_map(np.copy, zeros)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    cfg0 = tp_config(TP_ARCHS[0])
    data = TokenStream(vocab=cfg0.vocab, seq_len=8, global_batch=4)
    single_ckpt, _ = train.train_loop(
        cfg0, data, steps=2, ckpt_dir=os.path.join(ckpt, "single"),
        verbose=False, device="cpu")
    states = {name: state_np(name) for name in TP_ARCHS}
    data_np = {name: batches(tp_config(name), STEPS) for name in TP_ARCHS}
    worlds = start_worlds(tmp_path_factory.mktemp("tp_train"), {
        key: ("tp_train_scenario", world, dict(
            states_np={n: states[n] for n in names},
            batches_np={n: data_np[n] for n in names}, model=model,
            ckpt=ckpt if key == "m2" else None))
        for key, (world, model, names) in WORLDS.items()})
    single = {name: tp_train_run(tp_config(name),
                                 steps.state_from_jax(states[name]),
                                 data_np[name], total_steps=10)
              for name in TP_ARCHS}
    return dict(single=single, ckpt=ckpt, single_ckpt=single_ckpt,
                worlds=worlds, init={name: steps.state_from_jax(states[name])
                                     for name in TP_ARCHS})


@pytest.fixture(scope="module")
def ranks(setup):
    return setup["worlds"].join()


def leafwise(got, want):
    """The worst ``max|got - want| / max|want|`` over the leaves."""
    worst = 0.0
    for a, b in zip(trees.leaves(got), trees.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        ref = b.double().abs().max().item()
        worst = max(worst, (a.double() - b.double()).abs().max().item()
                    / max(ref, 1e-30))
    return worst


def cases():
    return [(key, name) for key, (_, _, names) in WORLDS.items()
            for name in names]


@pytest.mark.parametrize("key,name", cases())
def test_train_steps_match_single_process(setup, ranks, key, name):
    got_states, metrics, _ = ranks[key][0][name]
    states, want_metrics, _ = setup["single"][name]
    prev = setup["init"][name].params
    for m, g, got, want in zip(want_metrics, metrics, got_states, states):
        check_metrics(m, g)
        check_moments(want, got)
        check_update(prev, got, g["lr"])
        prev = got.params
    assert int(got_states[-1].opt.step) == STEPS


@pytest.mark.parametrize("key,name", cases())
def test_gradients_match_single_process(setup, ranks, key, name):
    grads = ranks[key][0][name][2]
    want = setup["single"][name][2]
    assert len(grads) == len(want) == STEPS
    for g, w in zip(grads, want):
        assert leafwise(g, w) <= TOL


def test_mamba_gradient_sums_db_dc_over_the_model_group(setup, ranks):
    """x_proj carries dt | B | C: its gradient and in_proj's (below it)
    need the dB / dC cotangents of every rank's channels."""
    name = "falcon-mamba-7b"
    got = ranks["m2"][0][name][2][0]["segments"][0]["mixer"]
    want = setup["single"][name][2][0]["segments"][0]["mixer"]
    for leaf in ("x_proj", "in_proj", "conv_w", "dt_proj", "A_log"):
        assert leafwise(got[leaf], want[leaf]) <= TOL, leaf


@pytest.mark.parametrize("key", list(WORLDS))
def test_ranks_hold_the_same_state(ranks, key):
    first = ranks[key][0]
    for other in ranks[key][1:]:
        for name in WORLDS[key][2]:
            for a, b in zip(trees.leaves(first[name][0][-1]),
                            trees.leaves(other[name][0][-1])):
                assert torch.equal(a, b), name


@pytest.mark.parametrize("key", WORLDS)
def test_state_gathers_onto_rank_0_alone(setup, ranks, key):
    first = WORLDS[key][2][0]
    got = [r["onto_rank0"] for r in ranks[key]]
    assert all(g is None for g in got[1:])
    for a, b in zip(trees.leaves(got[0]), trees.leaves(setup["init"][first])):
        assert a.device.type == "cpu"
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_model_axis_of_one_is_the_plain_step(setup, ranks):
    name = TP_ARCHS[0]
    state, metrics, grads = ranks["m2"][0]["ones"]
    want_state, want_metrics, want_grads = setup["single"][name]
    assert metrics == want_metrics
    for a, b in zip(trees.leaves((state, grads)),
                    trees.leaves((want_state, want_grads))):
        assert torch.equal(a, b)


def test_mesh_checkpoint_restores_bitwise_on_one_rank(setup, ranks):
    """``train_loop`` on ``(1, 2)`` wrote the whole state, rank 0's file,
    which one process restores bit for bit."""
    written = ranks["m2"][0]["written"]
    cfg = tp_config(TP_ARCHS[0])
    like = steps.make_train_state_init(cfg)(torch.Generator().manual_seed(1),
                                            "cpu")
    step, got = CheckpointManager(os.path.join(
        setup["ckpt"], "mesh")).restore_latest(like)
    assert step == 2
    for a, b in zip(trees.leaves(got), trees.leaves(written)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_one_rank_checkpoint_restores_bitwise_on_the_mesh(setup, ranks):
    for r in ranks["m2"]:
        for a, b in zip(trees.leaves(r["restored"]),
                        trees.leaves(setup["single_ckpt"])):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", TP_ARCHS[:-1])
def test_train_steps_match_jax(setup, ranks, name):
    """The 2-way steps of one config of each family against the JAX
    package's unsharded steps from the same state on the same batches
    (the MoE: ``repro``'s transformer on ``first_c_moe_ffn``, ROADMAP C):
    the metrics, the moments and the update rule, after every step."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.optim.adamw import AdamWState

    from _torch_zoo import reference
    st = state_np(name)
    js = jsteps.TrainState(
        params=jax.tree.map(jnp.asarray, st.params),
        opt=AdamWState(step=jnp.int32(0),
                       mu=jax.tree.map(jnp.asarray, st.opt.mu),
                       nu=jax.tree.map(jnp.asarray, st.opt.nu)))
    # train.build(total_steps=10)'s schedule
    jstep = jax.jit(jsteps.make_train_step(
        jconfigs.get_smoke(name), peak_lr=1e-3, warmup_steps=10,
        total_steps=10))
    got_states, metrics, _ = ranks["m2"][0][name]
    with reference():
        for b, got, m in zip(batches(tp_config(name), STEPS), got_states,
                             metrics):
            js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
            check_metrics({k: float(v) for k, v in jm.items()}, m)
            check_moments(jax.tree.map(np.asarray, js), got)
