"""Multi-rank harness for the port's CPU tests.

:func:`start_worlds` spawns gloo worlds of CPU processes (``torch.
multiprocessing``'s "spawn"), each rank running one of this module's
scenario functions ``fn(rank, world, **kwargs)``, and returns every rank's
result.  Ranks rendezvous through a ``file://`` store in the test's
temporary directory (never a fixed port: several pytest workers run at
once), run one thread each, and are joined with a timeout, so a dead or
hung rank fails the test with its traceback instead of hanging the suite.

This module imports torch and ``repro_torch`` only: the ranks never import
JAX or the JAX package.  The tests hold what the ranks return against
single-process runs and against the JAX package.
"""
from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a world may take, spawn and import of torch included
TIMEOUT_S = 120


def _rank_main(fn_name, rank, world, store, out, kwargs):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            result = globals()[fn_name](rank, world, **kwargs)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


class Worlds:
    """Gloo worlds started by :func:`start_worlds`; :meth:`join` waits for
    them (the test's own work can run meanwhile)."""

    def __init__(self, procs, dirs, timeout):
        self.procs, self.dirs = procs, dirs
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self._results = None

    def join(self):
        """``{name: [result of rank r]}``; raises with every failed rank's
        traceback, or when a rank outlives the timeout (then killed)."""
        if self._results is not None:
            return self._results
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        errors = [f"a rank exited with code {p.exitcode}" for p in self.procs
                  if p not in hung and p.exitcode != 0]
        for name, (d, world) in self.dirs.items():
            for r in range(world):
                err = os.path.join(d, f"rank{r}.err")
                if os.path.exists(err):
                    errors.append(f"world {name} rank {r}:\n"
                                  + open(err).read())
        if hung or errors:
            raise RuntimeError(f"{len(hung)} rank(s) hung past "
                               f"{self.timeout} s\n" + "\n".join(errors))
        self._results = {
            name: [torch.load(os.path.join(d, f"rank{r}.pt"),
                              weights_only=False) for r in range(world)]
            for name, (d, world) in self.dirs.items()}
        return self._results


def start_worlds(tmp_path, worlds, timeout=TIMEOUT_S) -> Worlds:
    """Start ``worlds`` (``{name: (fn_name, world_size, kwargs)}``) at
    once, each in its own gloo world."""
    ctx = mp.get_context("spawn")
    procs, dirs = [], {}
    for name, (fn_name, world, kwargs) in worlds.items():
        d = os.path.join(str(tmp_path), f"world_{name}")
        os.makedirs(d, exist_ok=True)
        dirs[name] = (d, world)
        for r in range(world):
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(fn_name, r, world,
                                  os.path.join(d, "store"), d, kwargs))
            p.start()
            procs.append(p)
    return Worlds(procs, dirs, timeout)


def run_worlds(tmp_path, worlds, timeout=TIMEOUT_S):
    """:func:`start_worlds`, then :meth:`Worlds.join`."""
    return start_worlds(tmp_path, worlds, timeout).join()


# ---------------------------------------------------------------------------
# shared inputs (made the same way in the ranks and in the tests)
# ---------------------------------------------------------------------------

#: the small CNN of the engine tests, and its batch: 5 rows, which no
#: world of 2 or 3 ranks divides
CNN_KW = dict(in_hw=(8, 8), channels=(4, 4), fc=(16,))
CNN_BATCH = 5
PRECISIONS = ("f32", "bf16", "fxp16")
METHODS = ("saliency", "deconvnet", "guided")


def cnn_setup():
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(**CNN_KW)
    params = cnn.init(torch.Generator().manual_seed(0), cfg)
    x = np.random.RandomState(1).randn(CNN_BATCH, 8, 8, 3).astype(np.float32)
    return cfg, params, torch.from_numpy(x)


def engine_outputs(params, cfg, x, precision, method, device=None,
                   backward="auto"):
    """What the engine tests compare: explain (top-2), forward then
    replay, a replay of another engine's residuals (``other``), predict,
    one composite (integrated gradients over 2 steps), and, for the
    seed-batched pair, the forward's residuals."""
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    eng = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                           method=method, precision=precision,
                           backward=backward, targets=TopK(2),
                           device=device))
    logits, rel = eng.explain(x)
    out = dict(logits=logits, rel=rel, predict=eng.predict(x),
               ig=eng.ig(x, steps=2)[1], n_shards=eng.n_shards,
               mesh=repr(eng.mesh))
    if eng.supports_replay:
        f_logits, res = eng.forward(x)
        seeds = eng._seeds(f_logits, None, 2)[0]
        out.update(forward=f_logits, residuals=res, seeds=seeds,
                   replay=eng.replay(res, seeds))
    return out


def engine_scenario(rank, world):
    """Every CNN engine of the tests on a ``mesh:edge-small:<world>``
    device: the sharded engine's outputs, and its replay of a
    single-process engine's residuals made in this rank."""
    cfg, params, x = cnn_setup()
    out = {}
    for precision in PRECISIONS:
        for method in METHODS:
            got = engine_outputs(params, cfg, x, precision, method,
                                 device=f"mesh:edge-small:{world}")
            if precision != "fxp16" and method == "guided":
                got["vjp"] = engine_outputs(
                    params, cfg, x, precision, method,
                    device=f"mesh:edge-small:{world}", backward="vjp")
            from repro_torch.engine import CNNModel, EngineSpec, build
            single = engine_outputs(params, cfg, x, precision, method)
            sharded = build(EngineSpec(
                CNNModel(params, cfg, device="cpu"), method=method,
                precision=precision, device=f"mesh:edge-small:{world}"))
            got["replay_single"] = sharded.replay(single["residuals"],
                                                  single["seeds"])
            got["occlusion"] = sharded.perturb(x, method="occlusion",
                                               window=4, stride=4)[1]
            out[(precision, method)] = got
    # the rows of each launch of the sharded pair, and whether its operands
    # are contiguous (the CUDA kernels take no strides), by spies on the
    # model
    from repro_torch import tree as trees
    from repro_torch.engine import CNNModel, EngineSpec, TopK, build
    from repro_torch.models import cnn
    eng = build(EngineSpec(CNNModel(params, cfg, device="cpu"),
                           targets=TopK(2), device=f"mesh:edge-small:{world}"))
    fwd, bwd, rows, dense = cnn.forward_with_residuals, cnn.backward_seeds, \
        [], []

    def contiguous(*trs):
        return all(t.is_contiguous() for t in trees.leaves(trs)
                   if isinstance(t, torch.Tensor))

    def spy_fwd(params, x, *args, **kwargs):
        rows.append(int(x.shape[0]))
        dense.append(contiguous(x))
        return fwd(params, x, *args, **kwargs)

    def spy_bwd(params, residuals, seeds, *args, **kwargs):
        rows.append(int(seeds.shape[1]))
        dense.append(contiguous(residuals, seeds))
        return bwd(params, residuals, seeds, *args, **kwargs)

    cnn.forward_with_residuals, cnn.backward_seeds = spy_fwd, spy_bwd
    try:
        eng.explain(x)
        eng.forward(x)
    finally:
        cnn.forward_with_residuals, cnn.backward_seeds = fwd, bwd
    out["rows_seen"], out["contiguous"] = rows, dense
    return out


# ---------------------------------------------------------------------------
# training (tests/test_torch_dp_train.py, tests/test_torch_train_loop.py)
# ---------------------------------------------------------------------------

#: the data-parallel step's archs (dense, mamba) and the MoE whose
#: gradient is held to its per-slice sum; 3 steps of a global batch of 5
#: rows (3 + 2 over two ranks) x 8 tokens
TRAIN_ARCHS = ("llama3.2-1b", "falcon-mamba-7b")
MOE_ARCH = "moonshot-v1-16b-a3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 5, 8, 3


def token_batches(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.data import TokenStream
    data = TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    return [{k: torch.as_tensor(v) for k, v in data.batch_at(s).items()}
            for s in range(steps)]


def train_run(cfg, mesh=None):
    """``TRAIN_STEPS`` steps of ``launch.train.build``'s step from the
    seed-0 state: ``(final state, [metrics per step])``."""
    from repro_torch.launch import train
    init_fn, step_fn = train.build(cfg, total_steps=10, mesh=mesh)
    state = init_fn(torch.Generator().manual_seed(0), "cpu")
    metrics = []
    for batch in token_batches(cfg):
        state, m = step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def step_grads(cfg, batch, mesh=None):
    """The gradient one train step clips (after the mesh's all-reduce),
    caught at ``clip_by_global_norm``."""
    from repro_torch.launch import steps, train
    init_fn, step_fn = train.build(cfg, total_steps=10, mesh=mesh)
    state = init_fn(torch.Generator().manual_seed(0), "cpu")
    caught, real = [], steps.clip_by_global_norm

    def spy(grads, clip, **kw):
        from repro_torch import tree as trees
        caught.append(trees.tree_map(torch.clone, grads))
        return real(grads, clip, **kw)

    steps.clip_by_global_norm = spy
    try:
        step_fn(state, batch)
    finally:
        steps.clip_by_global_norm = real
    return caught[0]


def train_scenario(rank, world):
    """The data-parallel step on ``make_host_mesh(world, 1)``: each
    arch's states and metrics, and the MoE's first-step gradient."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, 1)
    out = {arch: train_run(configs.get_smoke(arch), mesh)
           for arch in TRAIN_ARCHS}
    moe = configs.get_smoke(MOE_ARCH)
    out["moe_grads"] = step_grads(moe, token_batches(moe)[0], mesh)
    out["mesh"] = repr(mesh)
    return out


def train_loop_scenario(rank, world, ckpt):
    """``train_loop`` on ``--mesh host``'s mesh: 4 straight steps, then 2
    with a checkpoint and 2 resumed from it; and the CLI."""
    from repro_torch import configs
    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    cfg = configs.get_smoke("llama3.2-1b")
    data = TokenStream(vocab=cfg.vocab, seq_len=8, global_batch=4)
    mesh = train.mesh_for("host")
    kw = dict(mesh=mesh, verbose=False, device="cpu")
    straight, losses = train.train_loop(cfg, data, steps=4, ckpt_dir=None,
                                        **kw)
    train.train_loop(cfg, data, steps=2, ckpt_dir=ckpt, ckpt_every=2, **kw)
    resumed, _ = train.train_loop(cfg, data, steps=4, ckpt_dir=ckpt, **kw)
    files = sorted(os.listdir(os.path.join(ckpt, "step_00000004")))
    train.main(["--steps", "2", "--torch-device", "cpu", "--seq", "8",
                "--mesh", "host"])
    return dict(straight=straight, resumed=resumed, losses=losses,
                mesh=repr(mesh), files=files)


# ---------------------------------------------------------------------------
# the distribution layer and the compressed all-reduce
# ---------------------------------------------------------------------------


def placement_groups(ptree):
    """``{leaf path: placements}`` of ``param_sharding_tree``'s tree (its
    leaves are tuples, one placement per mesh dimension)."""
    from repro_torch import tree as trees
    out = {}
    for path, pl in trees.walk(ptree):
        out.setdefault(path[:-1], []).append(pl)
    return {k: tuple(v) for k, v in out.items()}


def dtensor_scenario(rank, world):
    """A SMOKE llama3.2-1b tree split over a ``(1, world)`` host mesh by
    ``param_sharding_tree``'s placements: each leaf's local shard shape,
    and whether ``full_tensor()`` gives the leaf back bitwise."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch import tree as trees
    from repro_torch.dist import params as dist_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    mesh = make_host_mesh(1, world)
    cfg = configs.get_smoke("llama3.2-1b")
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    pls = placement_groups(dist_params.param_sharding_tree(params, mesh))
    out = {}
    for path, leaf in trees.walk(params):
        dt = distribute_tensor(leaf, mesh.device_mesh, pls[path])
        out[path] = (tuple(dt.to_local().shape),
                     bool(torch.equal(dt.full_tensor(), leaf)),
                     tuple(repr(p) for p in pls[path]))
    return dict(leaves=out, mesh=repr(mesh))


def compression_inputs(rank, dtype, shape):
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(shape, generator=g).mul_(1 + rank).to(dtype)
    err = torch.randn(shape, generator=g).mul_(1e-2)
    return x, err


#: the compressed all-reduce's cases: (dtype, shape)
COMPRESSION_CASES = ((torch.float32, (64, 257)), (torch.bfloat16, (64, 257)),
                     (torch.float32, (300,)), (torch.float32, (3, 5, 33)))


def compression_scenario(rank, world):
    """``compressed_all_reduce`` over the world for each case, with a spy
    on ``dist.all_gather`` recording what the wire carries."""
    from repro_torch.runtime import compressed_all_reduce
    real, wire = dist.all_gather, []

    def spy(tensors, tensor, group=None, async_op=False):
        wire.append((tensor.dtype, tuple(tensor.shape)))
        return real(tensors, tensor, group=group, async_op=async_op)

    dist.all_gather = spy
    try:
        out = {}
        for dtype, shape in COMPRESSION_CASES:
            x, err = compression_inputs(rank, dtype, shape)
            out[(dtype, shape)] = compressed_all_reduce(x, err=err)
    finally:
        dist.all_gather = real
    return dict(out=out, wire=wire)


# ---------------------------------------------------------------------------
# the model axis (tests/test_torch_tp.py, tests/test_torch_tp_train.py)
# ---------------------------------------------------------------------------

#: one SMOKE config of each family of the zoo: dense (tied), GQA with 2 KV
#: heads, MoE, mamba, hybrid, encoder-decoder, vlm; "hymba-1.5b:split" is
#: hymba with 5 query heads and 1 KV head (80 columns: 2.5 heads a rank at
#: 2 ways, as hymba-1.5b's 25 heads at 2 and 4) and the chunked sdpa
TP_ARCHS = ("llama3.2-1b", "qwen2-1.5b", "moonshot-v1-16b-a3b",
            "falcon-mamba-7b", "hymba-1.5b", "seamless-m4t-medium",
            "llava-next-mistral-7b", "hymba-1.5b:split")
TP_BATCH, TP_SEQ, TP_NEW, TP_SRC = 2, 8, 3, 6


def tp_config(name):
    """The SMOKE config of ``name`` (``arch`` or ``arch:split``)."""
    from repro_torch import configs
    arch, _, variant = name.partition(":")
    cfg = configs.get_smoke(arch)
    if variant == "split":
        cfg = cfg.with_(n_heads=5, n_kv=1, attn_chunk_threshold=4,
                        attn_chunk=4)
    return cfg


def tp_params_np(cfg, seed=0):
    """Parameters of ``cfg`` as NumPy arrays, drawn by the port's ``init``
    from ``seed`` (the JAX package's tree: ``params_from_jax`` carries
    them into the port, ``jnp.asarray`` into the JAX package)."""
    from repro_torch import tree as trees
    from repro_torch.models import transformer as tf
    return trees.tree_map(lambda t: t.numpy(), tf.init(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu"))


def tp_batch(cfg, rows=TP_BATCH, seed=1):
    """A NumPy batch: tokens, plus the vlm's patches or the
    encoder-decoder's frames."""
    rs = np.random.RandomState(seed)
    b = {"tokens": rs.randint(0, cfg.vocab, (rows, TP_SEQ)).astype(np.int32)}
    if cfg.frontend == "patches":
        b["patches"] = rs.randn(rows, cfg.n_patches,
                                cfg.d_model).astype(np.float32)
    if cfg.enc_layers:
        b["frames"] = rs.randn(rows, TP_SRC, cfg.d_model).astype(np.float32)
    return b


def whole_cache(cache, mesh):
    """A rank's cache with its "model" blocks gathered (the fused KV and
    conv columns last, the state's channels second to last)."""
    from repro_torch import tree as trees
    from repro_torch.dist import sharding as shd
    with shd.use_mesh(mesh):
        return trees.map_with_path(
            lambda p, t: shd.gather_from_model(
                t, -2 if trees.leaf_name(p) == "h" else -1), cache)


def lm_outputs(cfg, params, batch_np, mesh=None):
    """What the model-axis tests compare, on ``mesh`` (params: the full
    tree, sharded here): the attribute step's last logits and ixg scores
    and contrastive scores (saliency), the prefill and
    ``TP_NEW`` decode steps' tokens and the final cache, whole."""
    from repro_torch.dist import params as dist_params
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    local = dist_params.shard_params(params, mesh)
    out = {}
    for mode in ("ixg", "contrastive"):
        out[mode] = steps.make_attribute_step(cfg, mode=mode, mesh=mesh)(
            local, batch)
    rows = batch["tokens"].shape[0]
    prompt = TP_SEQ + (cfg.n_patches if cfg.frontend == "patches" else 0)
    cache = tf.init_cache(cfg, rows, prompt + TP_NEW,
                          TP_SRC if cfg.enc_layers else 0, device="cpu",
                          mesh=mesh)
    nxt, cache = steps.make_prefill_step(cfg, mesh=mesh)(local, batch, cache)
    toks = [nxt]
    decode = steps.make_decode_step(cfg, mesh=mesh)
    for i in range(TP_NEW - 1):
        nxt, cache = decode(local, cache, nxt, prompt + i)
        toks.append(nxt)
    out["tokens"] = torch.cat(toks, dim=1)
    out["cache"] = whole_cache(cache, mesh) if mesh is not None else cache
    return out


def routed_experts(params, cfg, mesh=None):
    """The routed experts of the MoE segment's first layer (no shared
    expert) on a NumPy input, on ``mesh``."""
    from repro_torch.dist import params as dist_params
    from repro_torch.dist import sharding as shd
    from repro_torch.models import moe
    cfg = cfg.with_(n_shared_experts=0)
    si = [k for k, _, _ in cfg.layer_plan()].index("moe")
    seg = dist_params.shard_params(params, mesh)["segments"][si]["ffn"]
    p = {k: v[0] for k, v in seg.items() if k != "shared"}
    x = torch.from_numpy(np.random.RandomState(2).randn(
        TP_BATCH, TP_SEQ, cfg.d_model).astype(np.float32))
    with shd.use_mesh(mesh):
        return moe.moe_ffn(p, x, cfg)


def tp_scenario(rank, world, params_np, model):
    """Every arch of ``params_np`` (``{name: the JAX package's params as
    NumPy}``) on ``make_host_mesh(world // model, model)``: its
    :func:`lm_outputs`, whether ``gather_params(shard_params(p))`` is
    ``p`` bit for bit, and the MoE's routed experts; llama3.2-1b's and
    falcon-mamba-7b's outputs on a ``(1, 1)`` mesh (a model axis of 1 with
    a process group) ("ones"); the size of the group over the data and
    model axes and this rank's place in it."""
    from repro_torch import tree as trees
    from repro_torch.dist import params as dist_params
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    mesh = make_host_mesh(world // model, model)
    group = mesh._product_group(("data", "model"))
    out = {"mesh": repr(mesh), "model": shd.model_group(mesh)[1:],
           "product_group": (dist.get_world_size(group),
                             dist.get_rank(group)), "ones": {}}
    for name in ("llama3.2-1b", "falcon-mamba-7b"):
        cfg = tp_config(name)
        out["ones"][name] = lm_outputs(
            cfg, tf.params_from_jax(params_np[name]), tp_batch(cfg),
            make_host_mesh(1, 1))
    for name, pnp in params_np.items():
        cfg = tp_config(name)
        params = tf.params_from_jax(pnp)
        back = dist_params.gather_params(
            dist_params.shard_params(params, mesh), mesh)
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                   zip(trees.leaves(back), trees.leaves(params)))
        out[name] = dict(lm_outputs(cfg, params, tp_batch(cfg), mesh),
                         roundtrip=same)
        if cfg.n_experts:
            out[name]["routed"] = routed_experts(params, cfg, mesh)
    return out


def tp_train_run(cfg, state, batches, mesh=None, **kw):
    """The train step of ``launch.train.build`` on ``mesh`` from ``state``
    (full; sharded here) over NumPy ``batches``: ``([the state after each
    step, gathered whole], [metrics], [each step's clipped gradient,
    gathered])``."""
    from repro_torch.dist import params as dist_params
    from repro_torch.launch import steps, train
    _, step_fn = train.build(cfg, mesh=mesh, **kw)
    state = steps.shard_state(state, mesh)
    states, metrics, grads, real = [], [], [], steps.clip_by_global_norm

    def spy(g, clip, **kw):
        grads.append(dist_params.gather_params(g, mesh))
        return real(g, clip, **kw)

    steps.clip_by_global_norm = spy
    try:
        for b in batches:
            state, m = step_fn(state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(steps.gather_state(state, mesh))
    finally:
        steps.clip_by_global_norm = real
    return states, metrics, grads


def tp_train_scenario(rank, world, states_np, batches_np, model, ckpt):
    """The train step of each arch of ``states_np`` (the JAX package's
    ``TrainState`` as NumPy) on ``make_host_mesh(world // model, model)``
    over ``batches_np[name]`` (:func:`tp_train_run`); the first arch's
    initial state sharded and gathered onto rank 0 alone ("onto_rank0");
    with ``ckpt``: the first arch's run on a ``(1, 1)`` mesh ("ones"), its
    ``train_loop`` writing a checkpoint under ``ckpt/mesh``, and its state
    restored from the single-process checkpoint under ``ckpt/single``."""
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world // model, model)
    out = {"mesh": repr(mesh)}
    for name, snp in states_np.items():
        out[name] = tp_train_run(tp_config(name), steps.state_from_jax(snp),
                                 batches_np[name], mesh, total_steps=10)
    first = next(iter(states_np))
    out["onto_rank0"] = steps.gather_state(steps.shard_state(
        steps.state_from_jax(states_np[first]), mesh), mesh, dst=0)
    if ckpt:
        out["ones"] = tp_train_run(
            tp_config(first), steps.state_from_jax(states_np[first]),
            batches_np[first], make_host_mesh(1, 1), total_steps=10)
        cfg = tp_config(first)
        data = TokenStream(vocab=cfg.vocab, seq_len=8, global_batch=4)
        kw = dict(mesh=mesh, verbose=False, device="cpu")
        state, _ = train.train_loop(cfg, data, steps=2,
                                    ckpt_dir=os.path.join(ckpt, "mesh"),
                                    **kw)
        out["written"] = steps.gather_state(state, mesh)
        state, _ = train.train_loop(cfg, data, steps=2,
                                    ckpt_dir=os.path.join(ckpt, "single"),
                                    **kw)
        out["restored"] = steps.gather_state(state, mesh)
    return out
