"""``repro_torch.launch.train`` (CPU, SMOKE configs): a run the JAX
package checkpointed, resumed by either package to the same state (within
``tests/_torch_train.py``'s tolerances); the port's crash-resume bitwise
and its loss decreasing (twins of ``tests/test_system.py``'s two slow
LM tests); the command line.  On 2 gloo ranks (``tests/_torch_dist.py``)
``--mesh host``'s mesh trains data parallel: 4 straight steps equal 2, a
checkpoint rank 0 wrote, and 2 resumed, bit for bit; the production
meshes name the 256 / 512 ranks they need."""
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import TokenStream as JTokenStream
from repro.launch import train as jtrain
from repro_torch import configs
from repro_torch.data import TokenStream
from repro_torch.launch import train

from _torch_dist import run_worlds
from _torch_train import check_metrics, check_moments, check_update, flat

ARCH = "llama3.2-1b"


def test_resume_a_reference_checkpoint(tmp_path):
    """``repro`` trains 2 of 4 steps into a checkpoint; each package
    resumes a copy of it to step 4, and one to step 3, so that each
    step's update is held to the rule of ``tests/_torch_train.py``."""
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    kw = dict(vocab=cfg.vocab, seq_len=16, global_batch=4)
    base = str(tmp_path / "base")
    jtrain.train_loop(jcfg, JTokenStream(**kw), steps=2, ckpt_dir=base,
                      ckpt_every=2, verbose=False)
    for side in ("j3", "j", "t3", "t"):
        shutil.copytree(base, tmp_path / side)
    from repro.checkpoint import manager as jmgr
    like = jtrain.steps_lib.make_train_state_init(jcfg)(
        jax.random.PRNGKey(1))
    _, at2 = jmgr.restore(base, like)
    runs = {}
    for side, n in (("j3", 3), ("j", 4)):
        js, jl = jtrain.train_loop(jcfg, JTokenStream(**kw), steps=n,
                                   ckpt_dir=str(tmp_path / side),
                                   verbose=False)
        runs[side] = jax.tree.map(np.asarray, js), jl
    for side, n in (("t3", 3), ("t", 4)):
        runs[side] = train.train_loop(cfg, TokenStream(**kw), steps=n,
                                      ckpt_dir=str(tmp_path / side),
                                      verbose=False, device="cpu")
    (js3, _), (js, jl) = runs["j3"], runs["j"]
    (ts3, _), (ts, tl) = runs["t3"], runs["t"]
    assert len(jl) == len(tl) == 2
    for a, b in zip(jl, tl):
        check_metrics({"loss": a, "ce": a, "gnorm": 1.0, "lr": 1.0},
                      {"loss": b, "ce": b, "gnorm": 1.0, "lr": 1.0})
    check_moments(js3, ts3)
    check_moments(js, ts)
    # steps 2 and 3 moved the params, at lr 2e-4 and 3e-4 (warmup 10)
    prev = jax.tree.map(np.asarray, at2).params
    for s3, s4 in ((js3, js), (ts3, ts)):
        check_update(prev, s3, 2e-4)
        check_update(s3.params, s4, 3e-4)
    assert train.CheckpointManager(str(tmp_path / "t")).latest_step() == 4


def _leaves(state):
    return list(flat(state.params).values()) + \
        list(flat(state.opt.mu).values()) + \
        list(flat(state.opt.nu).values()) + [state.opt.step]


def test_checkpoint_crash_resume_bitwise(tmp_path):
    """Interrupted training resumes to the same final state, bit for bit
    (``tests/test_system.py::test_checkpoint_crash_resume_bitwise``)."""
    cfg = configs.get_smoke(ARCH)
    data = TokenStream(vocab=cfg.vocab, seq_len=16, global_batch=4)
    full, _ = train.train_loop(cfg, data, steps=8, ckpt_dir=None,
                               verbose=False, device="cpu")
    d = str(tmp_path / "ck")
    train.train_loop(cfg, data, steps=4, ckpt_dir=d, ckpt_every=4,
                     verbose=False, device="cpu")
    resumed, _ = train.train_loop(cfg, data, steps=8, ckpt_dir=d,
                                  ckpt_every=100, resume=True,
                                  verbose=False, device="cpu")
    for a, b in zip(_leaves(full), _leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(resumed.opt.step) == 8


def test_lm_loss_decreases():
    """``tests/test_system.py::test_lm_loss_decreases`` on the port."""
    cfg = configs.get_smoke("qwen2-1.5b")
    data = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=8)
    _, losses = train.train_loop(cfg, data, steps=30, ckpt_dir=None,
                                 verbose=False, ckpt_every=10 ** 9,
                                 device="cpu")
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])


def test_mesh_is_a12b(tmp_path):
    """A12b: ``train_loop`` on ``--mesh host``'s mesh over a world of 2
    gloo ranks resumes bitwise through rank 0's checkpoint, and every rank
    holds the same state."""
    ranks = run_worlds(tmp_path, {"t": ("train_loop_scenario", 2, dict(
        ckpt=str(tmp_path / "ck")))})["t"]
    for out in ranks:
        assert out["mesh"] == "Mesh(data=2, model=1, group)"
        assert out["files"] == ["DONE", "META.json", "shard_0.npz"]
        for a, b in zip(_state_leaves(out["straight"]),
                        _state_leaves(out["resumed"])):
            assert torch.equal(a, b)
    for a, b in zip(_state_leaves(ranks[0]["resumed"]),
                    _state_leaves(ranks[1]["resumed"])):
        assert torch.equal(a, b)
    assert ranks[0]["losses"] == ranks[1]["losses"]


def _state_leaves(state):
    from repro_torch import tree as trees
    return (trees.leaves(state.params) + trees.leaves(state.opt.mu)
            + trees.leaves(state.opt.nu) + [state.opt.step])


def test_cli(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    train.main(["--steps", "3", "--torch-device", "cpu", "--ckpt", ck,
                "--simulate-host-loss", "28", "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("[elastic] lost 28 hosts -> mesh (16, 16) (degraded "
                      "to single pod); restore latest checkpoint into the "
                      "new mesh and continue.")
    assert out[1].startswith("[train] step     0 loss ")
    assert out[-1].startswith("[train] 3 steps in ")
    assert train.CheckpointManager(ck).latest_step() == 3
    train.main(["--steps", "4", "--torch-device", "cpu", "--ckpt", ck,
                "--seq", "16"])
    assert "[train] resumed from step 3" in capsys.readouterr().out
    for mesh, ranks in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks; the "
                                             f"world has 1"):
            train.main(["--mesh", mesh, "--torch-device", "cpu"])
