"""The explanation server on a mesh of ranks against the JAX package's
server on one device (CPU).

The worlds of ``tests/test_torch_serve_mesh.py`` (gloo, 2 and 3 ranks,
``tests/_torch_dist.py``'s ``serve_scenario``) serve their request stream
in f32, bf16 and fxp16; ``repro.serve.ExplanationServer`` serves the same
stream on the same parameters with ``n`` times the seats a launch (the
world's: the same batches).  Every response of the world is within
``SERVE_TOL`` of the reference's: f32 logits 1e-5 and relevance 1e-4 of
max, bf16 2^-6, fxp16 bitwise; targets, cache hits, batch sizes, meta and
error types are equal.  Left out: SmoothGrad, LIME and RISE (torch
generators draw other noise and masks than the JAX package's keys), the
class-99 request (it fails the port's seed scatter and is a zero seed in
JAX), and the requests the faulty follower fails by design.  The JAX
package runs in its own processes, one a precision, so that its programs
compile at once.
"""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import jax
import numpy as np
import pytest

import repro.serve as jserve
from repro.models import cnn as jcnn

from _torch_dist import (CNN_KW, PRECISIONS, SERVE_INJECTED,
                         SERVE_MAX_BATCH, SERVE_STOCHASTIC, SERVE_TOL,
                         SERVE_WORLDS, serve_close, serve_pairs,
                         serve_phases, serve_pool, serve_run,
                         serve_same_outcome, serve_servers, serve_worlds)

JCFG = jcnn.CNNConfig(**CNN_KW)
REFERENCE_TIMEOUT_S = 240


def reference_runs(precision):
    """The JAX package's servers on the stream at ``precision`` (its
    stochastic methods left out), for each world's seats; arrays as
    NumPy."""
    jparams = jcnn.init(jax.random.PRNGKey(0), JCFG)
    x = serve_pool()
    out = {}
    for n in SERVE_WORLDS:
        recs = serve_run(
            jserve, serve_servers(jserve, jserve.CNNAdapter(
                jparams, JCFG, precision=precision), SERVE_MAX_BATCH * n),
            [(name, which, [r for r in reqs if r.kind == "predict"
                            or r.method not in SERVE_STOCHASTIC])
             for name, which, reqs in serve_phases(jserve, x, precision)])
        for phase, rs in recs.items():
            for r in rs if phase != "stream" else ():
                for k in ("logits", "relevance"):
                    if r.get(k) is not None:
                        r[k] = np.asarray(r[k], np.float32)
        out[n] = recs
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params_np = jax.tree.map(np.asarray, jcnn.init(jax.random.PRNGKey(0),
                                                   JCFG))
    worlds = serve_worlds(tmp_path_factory.mktemp("serve_mesh_ref"),
                          params_np)
    with ProcessPoolExecutor(len(PRECISIONS),
                             mp_context=mp.get_context("spawn")) as pool:
        refs = {p: pool.submit(reference_runs, p) for p in PRECISIONS}
        ref = {p: fut.result(timeout=REFERENCE_TIMEOUT_S)
               for p, fut in refs.items()}
    return worlds.join(), ref


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("world", SERVE_WORLDS)
def test_responses_within_tol_of_the_reference_server(runs, world,
                                                      precision):
    worlds, ref = runs
    got = worlds[str(world)][0][precision]
    ltol, rtol = SERVE_TOL[precision]
    n = 0
    for phase, a, b in serve_pairs(got, ref[precision][world],
                                   skip=SERVE_INJECTED | {"bad_target"}):
        what = (world, precision, phase, a["uid"])
        if not serve_same_outcome(a, b, what):
            continue
        serve_close(a["logits"], b["logits"], ltol, what)
        if b["relevance"] is not None:
            serve_close(a["relevance"], b["relevance"], rtol, what)
        n += 1
    assert n >= 40
