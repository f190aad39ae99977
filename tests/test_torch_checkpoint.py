"""repro_torch.checkpoint against repro.checkpoint (CPU): twins of
``tests/test_checkpoint.py``'s six tests on the port; a SMOKE
``TrainState`` saved by either package and restored by the other (the
same npz keys, values bitwise); ``save_async``'s host snapshot untouched
by what the caller does after it returns; a worker's error raised at
``wait()``; a bf16 leaf refused by name."""
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.checkpoint import manager as jmgr
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager, restore, save
from repro_torch.checkpoint import manager as mgr
from repro_torch.launch import steps


def _tree(v=0.0):
    return {"params": {"w": torch.full((4, 3), 1.5 + v),
                       "b": torch.zeros((3,))},
            "step_arr": torch.tensor([7], dtype=torch.int32)}


# twins of tests/test_checkpoint.py

def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    save(d, 42, _tree())
    step, got = restore(d, _tree(99.0))
    assert step == 42
    torch.testing.assert_close(got["params"]["w"], torch.full((4, 3), 1.5))
    assert got["step_arr"].dtype == torch.int32
    assert int(got["step_arr"]) == 7


def test_incomplete_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_00000002"))   # crashed mid-save
    assert mgr.latest_step(d) == 1
    assert restore(d, _tree())[0] == 1


def test_latest_pointer_recovery(tmp_path):
    d = str(tmp_path)
    save(d, 3, _tree())
    save(d, 7, _tree())
    os.remove(os.path.join(d, "LATEST"))
    assert mgr.latest_step(d) == 7


def test_retention_gc(tmp_path):
    d = str(tmp_path)
    man = CheckpointManager(d, keep=2)
    for s in (1, 2, 3, 4):
        man.save_blocking(s, _tree(float(s)))
    steps_ = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                    if n.startswith("step_"))
    assert steps_ == [3, 4]


def test_async_save(tmp_path):
    man = CheckpointManager(str(tmp_path))
    man.save_async(11, _tree())
    man.wait()
    step, got = man.restore_latest(_tree(5.0))
    assert step == 11
    torch.testing.assert_close(got["params"]["w"], torch.full((4, 3), 1.5))


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), _tree())


# the layout and keys of the JAX package

def test_same_layout_and_keys(tmp_path):
    jt = jax.tree.map(lambda t: np.asarray(t), _tree())
    jmgr.save(str(tmp_path / "j"), 5, jax.tree.map(jax.numpy.asarray, jt))
    save(str(tmp_path / "t"), 5, _tree())
    for side in ("j", "t"):
        assert sorted(os.listdir(tmp_path / side)) == ["LATEST",
                                                       "step_00000005"]
        assert sorted(os.listdir(tmp_path / side / "step_00000005")) == [
            "DONE", "META.json", "shard_0.npz"]
    a = np.load(tmp_path / "j" / "step_00000005" / "shard_0.npz")
    b = np.load(tmp_path / "t" / "step_00000005" / "shard_0.npz")
    assert sorted(a.files) == sorted(b.files) == [
        "k:params//k:b", "k:params//k:w", "k:step_arr"]
    assert (tmp_path / "j" / "step_00000005" / "META.json").read_text() == \
        (tmp_path / "t" / "step_00000005" / "META.json").read_text()


@pytest.fixture(scope="module")
def states():
    """A SMOKE TrainState (hymba: attention and SSM leaves, a list of
    segments, the NamedTuple optimizer) after two reference steps, in
    both packages."""
    arch = "hymba-1.5b"
    jcfg = jconfigs.get_smoke(arch)
    js = jsteps.make_train_state_init(jcfg)(jax.random.PRNGKey(0))
    step = jax.jit(jsteps.make_train_step(jcfg, peak_lr=1e-3,
                                          warmup_steps=1))
    rs = np.random.RandomState(0)
    for _ in range(2):
        toks = rs.randint(0, jcfg.vocab, (2, 9)).astype(np.int32)
        js, _ = step(js, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    js = jax.tree.map(np.asarray, js)
    ts = steps.state_from_jax(js)
    like = steps.make_train_state_init(configs.get_smoke(arch))(
        torch.Generator().manual_seed(9), "cpu")
    return js, ts, like


def _pairs(jtree, ttree):
    jflat = jmgr._flatten(jtree)
    tflat = mgr._flatten(ttree)
    assert jflat.keys() == tflat.keys()
    return [(k, jflat[k], tflat[k]) for k in jflat]


def _bitwise(jtree, ttree):
    for k, a, b in _pairs(jtree, ttree):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_flatten_keys_equal(states):
    js, ts, _ = states
    _bitwise(js, ts)
    keys = set(mgr._flatten(ts))
    assert "n:opt//n:step" in keys
    assert "n:params//k:segments//i:0//k:ssm//k:A_log" in keys
    assert "n:opt//n:mu//k:embed//k:table" in keys


def test_jax_saves_port_restores(states, tmp_path):
    js, ts, like = states
    jmgr.save(str(tmp_path), 2, jax.tree.map(jax.numpy.asarray, js))
    step, got = restore(str(tmp_path), like)
    assert step == 2 and isinstance(got, steps.TrainState)
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 2
    _bitwise(js, got)


def test_port_saves_jax_restores(states, tmp_path):
    js, ts, _ = states
    CheckpointManager(str(tmp_path)).save_blocking(2, ts)
    jlike = jax.tree.map(lambda a: jax.numpy.zeros(a.shape, a.dtype), js)
    step, got = jmgr.restore(str(tmp_path), jlike)
    assert step == 2
    _bitwise(jax.tree.map(np.asarray, got), ts)


def test_async_snapshot_taken_before_return(tmp_path):
    """The snapshot is the tree as it stood at the call: neither rebinding
    the caller's names nor writing into the tensors after the call reaches
    the checkpoint."""
    tree = _tree()
    man = CheckpointManager(str(tmp_path))
    man.save_async(1, tree)
    tree["params"]["w"].fill_(-3.0)
    tree["params"] = {"w": torch.zeros(4, 3), "b": torch.ones(3)}
    man.wait()
    _, got = restore(str(tmp_path), _tree())
    torch.testing.assert_close(got["params"]["w"], torch.full((4, 3), 1.5))
    torch.testing.assert_close(got["params"]["b"], torch.zeros(3))


def test_worker_error_surfaces_at_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    man = CheckpointManager(str(blocker))
    man.save_async(1, _tree())          # returns: the error is the worker's
    with pytest.raises(OSError):
        man.wait()
    man.wait()                          # raised once, then cleared


def test_bf16_leaf_refused_by_name(tmp_path):
    tree = {"a": {"w": torch.zeros(2, dtype=torch.bfloat16)}}
    with pytest.raises(TypeError, match="k:a//k:w"):
        save(str(tmp_path), 1, tree)
    with pytest.raises(TypeError, match="k:a//k:w"):
        CheckpointManager(str(tmp_path)).save_async(1, tree)
