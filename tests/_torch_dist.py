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

    def exitcodes(self):
        """``{name: [exit code of rank r]}`` once every rank has ended, for
        worlds whose ranks are meant to fail; a rank alive at the timeout
        is killed (its code is then negative)."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        codes, procs = {}, iter(self.procs)
        for name, (_, world) in self.dirs.items():
            codes[name] = [next(procs).exitcode for _ in range(world)]
        return codes


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


# ---------------------------------------------------------------------------
# multi-rank serving (tests/test_torch_serve_mesh.py)
# ---------------------------------------------------------------------------

#: seats a launch per rank; a world of n fills ``SERVE_MAX_BATCH * n``
SERVE_MAX_BATCH = 4
SERVE_POOL = 24
SERVE_OPTS = {"integrated_gradients": {"steps": 4}, "smoothgrad": {"n": 4},
              "occlusion": {"window": 4, "stride": 4},
              "lime": {"n_samples": 16}, "rise": {"n_samples": 16}}
#: the "steps" server's options: another integrated gradients on the same
#: adapter (the followers build it apart from the main server's)
SERVE_STEPS_OPTS = dict(SERVE_OPTS, integrated_gradients={"steps": 8})
#: a payload value the faulty follower fails on after the launch's
#: collectives (an error surfacing at the end of the device work)
FAULT_MARK = 1234.5


def serve_pool():
    return np.random.RandomState(7).randn(SERVE_POOL, 8, 8,
                                          3).astype(np.float32)


def serve_phases(pkg, x, precision, key=int):
    """The request stream of the multi-rank server tests, as ``(name,
    server, requests)`` bursts (each submitted whole, then drained):
    ``server`` is "main", "steps" (integrated gradients at 8 steps, not
    4) or, from f32 and bf16, "reroute" (capacity 16, explains rerouted
    to fxp16 above half of it).  ``pkg`` is
    ``repro.serve`` or ``repro_torch.serve``; ``key`` makes a request's
    seed (the JAX package's server takes PRNG keys)."""
    R = pkg.Request

    def ex(uid, i, method, **kw):
        return R(uid=uid, kind="explain", x=x[i], method=method, **kw)

    marked = x[20].copy()
    marked[0, 0, 0] = FAULT_MARK
    # groups of 3 or 4 rows pad to 4: at least 2 rows a rank in worlds of
    # 2 and 3; the groups of 2 give one row a rank, those of 1 one row
    phases = [
        ("predict", "main", [R(uid=f"p{i}", kind="predict", x=x[i])
                             for i in range(12)]),
        ("hits", "main",
         [ex(f"p{i}", i, "saliency") for i in range(4)]
         + [ex(f"p{i}", i, "deconvnet") for i in (4, 5, 6)]
         + [ex(f"p{i}", i, "guided", topk=3) for i in (7, 8, 9)]
         + [ex(f"p{i}", i, "saliency", target=7) for i in (10, 11)]),
        # the same rows, cold: bitwise the hits of the same batch
        ("colds", "main",
         [ex(f"c{i}", i, "saliency") for i in range(4)]
         + [ex(f"c{i}", i, "guided", topk=3) for i in (7, 8, 9)]),
        ("followups", "main",
         [ex(f"c{i}", i, "deconvnet") for i in range(4)]
         + [ex("p0", 0, "guided", topk=3)]),
        ("composites", "main",
         [ex(f"ig{i}", 12 + i, "integrated_gradients") for i in range(3)]
         + [ex(f"sg{i}", 15 + i, "smoothgrad", key=key(100 + i))
            for i in range(3)]
         + [ex("ixg0", 18, "input_x_gradient"),
            ex("ixg1", 19, "input_x_gradient", target=3)]),
        ("singleton", "main", [ex("sg0", 15, "smoothgrad", key=key(100))]),
        ("ig_steps", "steps", [ex(f"is{i}", 12 + i, "integrated_gradients")
                               for i in range(3)]),
        ("perturb", "main",
         [ex(f"oc{i}", 12 + i, "occlusion") for i in range(3)]
         + [ex(f"lime{i}", 12 + i, "lime", key=key(200 + i)) for i in range(3)]
         + [ex(f"rise{i}", 12 + i, "rise", key=key(300 + i)) for i in range(2)]),
        # refused at submit (never announced), then a launch that fails on
        # every rank (class 99 of 10) beside a batch that is served
        ("poison", "main",
         [R(uid="bad_shape", kind="predict", x=x[0][:4]),
          R(uid="bad_nan", kind="predict",
            x=np.full_like(x[0], np.nan)),
          ex("bad_target", 19, "input_x_gradient", target=99),
          ex("e0", 19, "saliency")]),
        ("fault", "main", [R(uid="f0", kind="predict", x=marked)]
         + [R(uid=f"f{i}", kind="predict", x=x[20 + i]) for i in (1, 2)]),
        ("after_fault", "main", [R(uid=f"f{i}", kind="predict",
                                   x=x[20 + i]) for i in (3, 1, 2)]),
    ]
    if precision != "fxp16":
        # the faulty follower cannot build the fxp16 sibling the first
        # time: the first rerouted batch fails, the next is served
        phases += [(f"reroute{r}", "reroute",
                    [ex(f"d{r}_{i}", i, "saliency") for i in range(16)])
                   for r in range(2)]
    return phases


def serve_servers(pkg, adapter, max_batch):
    """The three servers of :func:`serve_phases` on one adapter."""
    kw = dict(max_batch=max_batch, max_delay_s=60.0, cache_capacity=256,
              method_opts=SERVE_OPTS)
    return {"main": pkg.ExplanationServer(
                adapter, admission=pkg.AdmissionConfig(capacity=1024), **kw),
            "steps": pkg.ExplanationServer(
                adapter, **dict(kw, method_opts=SERVE_STEPS_OPTS)),
            "reroute": pkg.ExplanationServer(adapter, admission=pkg.
                AdmissionConfig(capacity=16, degrade=pkg.DegradePolicy(
                    pressure_threshold=0.5, reroute_precision="fxp16")),
                **kw)}


def response_record(r):
    """What the tests compare of a response."""
    return dict(uid=r.uid, kind=r.kind, method=r.method, ok=r.ok,
                error_type=r.error_type, error=r.error, targets=r.targets,
                cache_hit=r.cache_hit, batch_size=r.batch_size,
                meta=dict(r.meta), logits=r.logits, relevance=r.relevance)


def serve_run(pkg, servers, phases, stats=None):
    """Run ``phases`` through ``servers``: ``{phase: [record]}``; a
    refusal at submit is a record with ``raised`` set.  ``stats``: a
    stream's stats dict, whose counts each phase adds are kept in
    ``out["stream"][phase]``."""
    out = {"stream": {}}
    for name, which, reqs in phases:
        before = None if stats is None else _counts(stats)
        srv, recs = servers[which], []
        for req in reqs:
            try:
                srv.submit(req)
            except Exception as e:                      # noqa: BLE001
                recs.append(dict(uid=req.uid, raised=type(e).__name__))
        recs += [response_record(r) for r in srv.drain()]
        out[name] = recs
        if stats is not None:
            after = _counts(stats)
            out["stream"][name] = {k: after[k] - before.get(k, 0)
                                   for k in after}
    return out


def _counts(stats):
    """A stream's integer counts, flat (calls by op as ``calls/<op>``)."""
    flat = {f"calls/{k}": v for k, v in stats["calls"].items()}
    flat.update({k: v for k, v in stats.items() if isinstance(v, int)})
    return flat


#: requests of the timed replay the leader drives through the stream
SERVE_REPLAY_N = 40


def serve_replay(pkg, adapter):
    """The replay harness (``serve.replay``: a ``TimedAdapter`` on a
    virtual clock) through ``adapter`` over :data:`SERVE_REPLAY_N`
    requests of its default mix: offered, completed, errors, and every
    response's uid and method."""
    from repro_torch.serve.replay import (TimedAdapter, VirtualClock,
                                          replay, synthesize)
    clock = VirtualClock()
    srv = pkg.ExplanationServer(TimedAdapter(adapter, clock), clock=clock,
                                max_batch=SERVE_MAX_BATCH, max_delay_s=0.002,
                                method_opts=SERVE_OPTS)
    rep = replay(srv, synthesize(SERVE_REPLAY_N, seed=0, x_pool=16),
                 example_shape=(8, 8, 3), x_pool=16)
    return dict(offered=rep.offered, completed=rep.completed,
                errors=rep.errors, hit_rate=rep.cache_hit_rate)


class FaultyAdapter:
    """A follower's adapter that fails three times: building its first
    explainer (integrated gradients', before the launch: the follower
    cannot prepare it), building its first sibling (a build launch), and
    a predict whose batch holds :data:`FAULT_MARK` (after the launch's
    collectives)."""

    def __init__(self, inner):
        self.inner = inner
        self.sibling_fault = True
        self.explainer_fault = True

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def predict(self, xb):
        out = self.inner.predict(xb)
        if bool((xb == FAULT_MARK).any()):
            raise RuntimeError("injected: predict failed on a follower")
        return out

    def with_precision(self, precision):
        if self.sibling_fault:
            self.sibling_fault = False
            raise RuntimeError("injected: no sibling on a follower")
        return self.inner.with_precision(precision)

    def engine_for(self, rules):
        # a follower asks its adapter for an engine only to build an
        # explainer (the inner adapter's replays use its own)
        if self.explainer_fault:
            self.explainer_fault = False
            raise RuntimeError("injected: no explainer on a follower")
        return self.inner.engine_for(rules)


def serve_scenario(rank, world, params_np, precisions):
    """Every rank of a world serving :func:`serve_phases` on a
    ``mesh:edge-small:<world>`` CNN adapter: rank 0 leads the servers,
    the others follow (the last through :class:`FaultyAdapter`).  Rank 0
    returns each precision's records and stream stats, the others their
    follower stats."""
    import repro_torch.serve as tserve
    from repro_torch.engine import CNNModel, EngineSpec, build
    from repro_torch.serve import follower
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(**CNN_KW)
    params = cnn.params_from_jax(params_np)
    x = serve_pool()
    out = {}
    for precision in precisions:
        adapter = tserve.CNNAdapter.from_engine(build(EngineSpec(
            CNNModel(params, cfg, device="cpu"), precision=precision,
            device=f"mesh:edge-small:{world}")))
        if rank == 0:
            with follower.lead(adapter) as adp:
                servers = serve_servers(tserve, adp, SERVE_MAX_BATCH)
                out[precision] = serve_run(
                    tserve, servers, serve_phases(tserve, x, precision),
                    stats=adp.stream.stats)
                out[precision]["replay"] = serve_replay(tserve, adp)
                out[precision]["stats"] = dict(adp.stream.stats)
        else:
            if rank == world - 1:
                adapter = FaultyAdapter(adapter)
            out[precision] = follower.follow(adapter)
    return out


#: worlds whose serving stream is lost by design: ``{name: (ranks, the
#: rank that fails inside its model function)}``
SERVE_LOST = {"follower": (3, 2), "leader": (2, 0)}
#: FAULT_GRACE_S in those worlds, and the seconds a world may take to stop
SERVE_LOST_GRACE_S, SERVE_LOST_TIMEOUT_S = 2.0, 90


def serve_lost_scenario(rank, world, params_np, faulty):
    """A world that serves one predict batch and then loses its stream:
    rank ``faulty`` raises inside its model function (its first conv, on
    its rows of a batch whose every row holds :data:`FAULT_MARK`) before
    the engine's gather, so the other ranks wait in that collective.
    Every rank is meant to end its process with the follower's
    ``LOST_EXIT_CODE``; returning is a failure."""
    import repro_torch.serve as tserve
    from repro_torch.engine import CNNModel, EngineSpec, build
    from repro_torch.models import cnn
    from repro_torch.serve import follower
    follower.FAULT_GRACE_S = SERVE_LOST_GRACE_S
    if rank == faulty:
        real = cnn._KERNELS["f32"]["conv"]

        def conv(x, *args, **kw):
            if bool((x == FAULT_MARK).any()):
                raise RuntimeError("injected: a conv failed on one rank")
            return real(x, *args, **kw)
        cnn._KERNELS["f32"] = dict(cnn._KERNELS["f32"], conv=conv)
    adapter = tserve.CNNAdapter.from_engine(build(EngineSpec(
        CNNModel(cnn.params_from_jax(params_np), cnn.CNNConfig(**CNN_KW),
                 device="cpu"), device=f"mesh:edge-small:{world}")))
    if rank > 0:
        return follower.follow(adapter)
    x = serve_pool()
    marked = x[:4].copy()
    marked[:, 0, 0, 0] = FAULT_MARK
    with follower.lead(adapter) as adp:
        srv = tserve.ExplanationServer(adp, max_batch=SERVE_MAX_BATCH,
                                       max_delay_s=60.0)
        for rows, tag in ((x[:4], "ok"), (marked, "lost")):
            for i, row in enumerate(rows):
                srv.submit(tserve.Request(uid=f"{tag}{i}", kind="predict",
                                          x=row))
            out = srv.drain()
        return [response_record(r) for r in out]


def serve_lost_worlds(tmp_path, params_np):
    """Start the :data:`SERVE_LOST` worlds."""
    return start_worlds(tmp_path, {
        name: ("serve_lost_scenario", ranks,
               dict(params_np=params_np, faulty=faulty))
        for name, (ranks, faulty) in SERVE_LOST.items()},
        timeout=SERVE_LOST_TIMEOUT_S)


#: tests/test_torch_serve.py's tolerances: (logits, relevance) relative to
#: the reference's max |value|
SERVE_TOL = {"f32": (1e-5, 1e-4), "bf16": (2.0 ** -6, 2.0 ** -6),
             "fxp16": (0.0, 0.0)}
#: methods whose draws the JAX package makes from its own keys
SERVE_STOCHASTIC = ("smoothgrad", "lime", "rise")
#: the requests the faulty follower fails: a predict batch after its
#: collectives, the first composite batch (no explainer) and the first
#: rerouted batch (no fxp16 sibling)
SERVE_INJECTED = ({"f0", "f1", "f2", "ig0", "ig1", "ig2"}
                  | {f"d0_{i}" for i in range(8, 16)})
SERVE_WORLDS = (2, 3)


def serve_worlds(tmp_path, params_np):
    """Start the serving worlds of 2 and 3 ranks, every precision."""
    return start_worlds(tmp_path, {
        str(n): ("serve_scenario", n, dict(params_np=params_np,
                                           precisions=PRECISIONS))
        for n in SERVE_WORLDS})


def _host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy().astype(np.float64)
    return np.asarray(t, np.float32).astype(np.float64)


def serve_close(got, want, tol, what):
    """``got`` within ``tol`` of ``want``'s max |value| (tensors or
    arrays)."""
    got, want = _host(got), _host(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def serve_pairs(got, want, skip=()):
    """``(phase, got record, want record)`` of two runs of
    :func:`serve_phases`, phase by phase, in order: every request of
    ``want`` (a reference run may leave the stochastic methods out), but
    the uids in ``skip``."""
    phases = [k for k in want if k != "stream"]
    assert [k for k in got
            if k not in ("stream", "stats", "replay")] == phases
    for phase in phases:
        uids = {w["uid"] for w in want[phase]}
        mine = [r for r in got[phase]
                if r.get("method") not in SERVE_STOCHASTIC
                or r["uid"] in uids]
        assert [r["uid"] for r in mine] == [
            r["uid"] for r in want[phase]], phase
        for a, b in zip(mine, want[phase]):
            if a["uid"] not in skip:
                yield phase, a, b


def serve_same_outcome(a, b, what) -> bool:
    """Two records of one request agree but for their values; True when
    they carry values (an ok response)."""
    assert a.get("raised") == b.get("raised"), what
    if "raised" in a:
        return False
    for k in ("kind", "method", "ok", "error_type", "targets", "cache_hit",
              "batch_size", "meta"):
        assert a[k] == b[k], (what, k)
    return a["ok"]


def followers_requests(pkg, x):
    """4 predicts, their 4 saliency hits and 4 cold guided explains."""
    R = pkg.Request
    return ([R(uid=f"p{i}", kind="predict", x=x[i]) for i in range(4)]
            + [R(uid=f"p{i}", kind="explain", x=x[i], method="saliency")
               for i in range(4)]
            + [R(uid=f"c{i}", kind="explain", x=x[4 + i], method="guided")
               for i in range(4)])


def serve_followers_scenario(rank, world, params_np, x):
    """``tests/test_torch_serve.py``'s world: rank 0 serves
    :func:`followers_requests` through ``follower.lead`` (after a server
    without the stream is refused), the others follow; every header is
    longer than the first broadcast takes, so each goes out in two."""
    import repro_torch.serve as tserve
    from repro_torch.engine import CNNModel, EngineSpec, build
    from repro_torch.models import cnn
    from repro_torch.serve import follower
    follower.HEADER_BYTES = 64
    adapter = tserve.CNNAdapter.from_engine(build(EngineSpec(
        CNNModel(cnn.params_from_jax(params_np), cnn.CNNConfig(**CNN_KW),
                 device="cpu"), device=f"mesh:edge-small:{world}")))
    if rank > 0:
        return follower.follow(adapter)
    try:
        tserve.ExplanationServer(adapter)
        refused = None
    except ValueError as e:
        refused = type(e).__name__
    with follower.lead(adapter) as adp:
        srv = tserve.ExplanationServer(adp, max_batch=4, max_delay_s=0.0)
        for r in followers_requests(tserve, x):
            srv.submit(r)
        out = [response_record(r) for r in srv.drain()]
    return dict(refused=refused, responses=out)
