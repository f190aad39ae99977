"""End-to-end fault-tolerant training driver, as ``repro.launch.train``
runs it, on one device or data parallel over the ranks of a process
group:

  deterministic data -> train_step -> health monitor (stragglers)
  -> async checkpoints -> crash-resume (bitwise, thanks to step-indexed data)
  -> elastic remesh planning on simulated host loss.

Runs on the card unless ``--torch-device cpu`` asks for the CPU::

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 20
    python -m repro_torch.launch.train --steps 3 --torch-device cpu \\
        --ckpt /tmp/ck --simulate-host-loss 28
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --mesh host --torch-device cpu --steps 3

Under ``torchrun`` the driver initializes the default process group from
the environment (NCCL on the cards, gloo with ``--torch-device cpu``), and
``--mesh host`` trains data parallel over all its ranks
(``make_host_mesh(world, 1)``); rank 0 writes the checkpoints.  ``--mesh
single|multi`` build the production meshes, which need 256 / 512 ranks
(16-way tensor / expert parallel on their "model" axis).
:func:`train_loop` takes any ``(data, model)`` mesh, e.g.
``make_host_mesh(2, 2)`` under ``torchrun --nproc-per-node 4``.  As in
``repro.launch.train``, ``--smoke`` is always on: the arch's SMOKE config
trains.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenStream
from repro_torch.engine.spec import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                    world_size)
from repro_torch.runtime import HealthMonitor, plan_remesh


def build(cfg, *, microbatches=1, peak_lr=1e-3, total_steps=1000,
          mesh=None):
    """``(init_fn, step_fn)``: :func:`steps.make_train_state_init` and the
    train step (data parallel over ``mesh``), warmup ``max(10,
    total_steps // 20)``."""
    init_fn = steps_lib.make_train_state_init(cfg)
    step_fn = steps_lib.make_train_step(cfg, microbatches=microbatches,
                                        peak_lr=peak_lr,
                                        warmup_steps=max(10, total_steps // 20),
                                        total_steps=total_steps, mesh=mesh)
    return init_fn, step_fn


def train_loop(cfg, data: TokenStream, *, steps: int, ckpt_dir: Optional[str],
               ckpt_every: int = 50, resume: bool = True, mesh=None,
               microbatches: int = 1, log_every: int = 10,
               monitor: Optional[HealthMonitor] = None, verbose=True,
               device=None):
    """Returns (final_state, losses). Restart-safe around ``ckpt_dir``.

    Trains on ``device`` (None: the card) from parameters drawn with seed
    0 there.  With ``mesh`` (every rank of the process group calls this
    with the same arguments) each step's global batch is
    ``data.batch_at(step)``, whatever the world size, and each rank
    computes its rows of it (:func:`steps.make_train_step`); on a "model"
    axis of several ranks each rank trains its slice of the state
    (:func:`steps.shard_state` of the full seed-0 or restored state).
    Checkpoints hold the full state, the same npz keys at any mesh: it is
    gathered onto rank 0 alone over its model group, leaf by leaf to the
    host (:func:`steps.gather_state` with ``dst=0``), and rank 0 writes
    it; every rank restores it and takes its slice.  Each rank records
    its step times under its rank."""
    dev = resolve_device(device)
    init_fn, step_fn = build(cfg, microbatches=microbatches,
                             total_steps=steps, mesh=mesh)
    rank = dist.get_rank() if mesh is not None and mesh.has_group else 0

    def fresh():
        return init_fn(torch.Generator(device=dev).manual_seed(0), dev)

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    state = None
    if manager and resume and manager.latest_step() is not None:
        start, state = manager.restore_latest(fresh())
        if verbose:
            print(f"[train] resumed from step {start}")
    if state is None:
        state = fresh()
    state = steps_lib.shard_state(state, mesh)
    writer = manager if rank == 0 else None

    def full(state):
        return steps_lib.gather_state(state, mesh, dst=0)

    monitor = monitor or HealthMonitor()
    losses = []
    for step in range(start, steps):
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        monitor.record_step(rank, time.monotonic() - t0)
        losses.append(loss)
        if verbose and step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['gnorm']):.2f}")
        if manager and (step + 1) % ckpt_every == 0:
            whole = full(state)
            if writer:
                writer.save_async(step + 1, whole)
    if manager:
        whole = full(state)
        if writer:
            writer.save_blocking(steps, whole)
    if manager and mesh is not None and mesh.has_group:
        dist.barrier()              # every rank past rank 0's last save
    return state, losses


def init_from_env(device) -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` set) initialize the default
    process group from the environment: NCCL on the cards (this rank's
    card is ``LOCAL_RANK``), gloo on the CPU.  Returns whether it did."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def mesh_for(name: str):
    """``--mesh``: ``host`` -> :func:`make_host_mesh` over every rank;
    ``single`` / ``multi`` -> the production meshes (256 / 512 ranks)."""
    if name == "host":
        return make_host_mesh(world_size(), 1)
    return make_production_mesh(multi_pod=name == "multi")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--simulate-host-loss", type=int, default=0,
                    help="simulate N dead hosts and print the elastic plan")
    ap.add_argument("--torch-device", default=None,
                    help="where training runs: 'cuda' (the default: the "
                         "card, an error without one) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    started = init_from_env(args.torch_device)
    try:
        _run(args, cfg)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, cfg):
    mesh = mesh_for(args.mesh)

    if args.simulate_host_loss:
        healthy = list(range(128 - args.simulate_host_loss))
        plan = plan_remesh(128, healthy, 4, 16)
        print(f"[elastic] lost {args.simulate_host_loss} hosts -> "
              f"mesh {plan.mesh_shape} ({plan.note}); restore latest "
              f"checkpoint into the new mesh and continue.")

    data = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.global_batch)
    t0 = time.time()
    _, losses = train_loop(cfg, data, steps=args.steps, ckpt_dir=args.ckpt,
                           mesh=mesh, microbatches=args.microbatches,
                           device=args.torch_device)
    dt = time.time() - t0
    print(f"[train] {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
