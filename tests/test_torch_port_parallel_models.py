"""Every model family grid-sharded over two rank processes against the
JAX package's `spatialize(model, make_mesh(n_data=1, n_space=2))`, on the
CPU.

The JAX side runs here, on two of the 8 virtual CPU devices that
tests/conftest.py gives (its CPU route, Pallas off; compiled once per
model at XLA's lowest optimization level, `run_compiled`), with the
port's seeded weights (`jax_params_from_port`). The port's side runs in
two rank processes (tests/parallel_ranks.py: a gloo world on the CPU,
one torch thread each, each waited on with its own timeout), which build
the same models from the same seed, shard them (`spatialize`), and read
the inputs this test writes as .npz. GraphLAM, HiLAM and HiLAMParallel
(2 levels) and GraphEFM on a 30x28 grid, HiEFM on a 24x12 global grid (an
icosahedral mesh at 2 refinements in 2 levels, whose polar g2m receivers
take edges from both ranks' grid blocks), hidden 64, one processor layer,
batch 2, the port on its mixed route (`_FLAT_MIN_VIRT` 100: the sets of at
least 100 virtual rows flat, the others batched). Held:

* the one-step prediction within 1e-4 of JAX's (and the latent models'
  KL, from a given noise and target);
* the gradients of the training loss (a 2-step unroll; GraphEFM and
  HiEFM: the mean square of the prediction plus the mean KL, which takes
  the replicated output's cotangent through both) within 5e-4 x max abs
  per parameter, the losses within 1e-5 relative;
* a bf16 GraphLAM, sharded: its bf16 error against the fp32 prediction
  within 0.9-1.1x of the unsharded bf16 model's (the bf16 tests' limit on
  the error's size; the unsharded bf16 path is held against JAX there);
* the host-side merges over the data groups (`psum_across_hosts`,
  `mean_across_data`, `broadcast_object`) on each rank of a 2 x 1 mesh
  of the same world.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.datastore.dummy_global import (
    DummyGlobalDatastore as JDummyGlobalDatastore,
)
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.global_mesh import (
    create_global_graph as j_create_global_graph,
)
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu.parallel.grid_sharded import spatialize as j_spatialize
from neural_lam_tpu.parallel.mesh import make_mesh as j_make_mesh

from .latent_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_params_from_port,
    one_torch_thread,
    run_compiled,
)
from .parallel_ranks import CASES, D_Z, GLOBAL, GRID, H, LAYERS, build

ROOT = Path(__file__).resolve().parent.parent
B, T = 2, 2
RANK_TIMEOUT_S = 120


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script_args, world, timeout=RANK_TIMEOUT_S):
    """Start `world` rank processes of tests/parallel_ranks.py, wait for
    each with its own timeout, and fail with their output if any fails."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "parallel_ranks.py"), str(r),
         str(world), str(port), *script_args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f"a rank timed out:\n{out[-3000:]}")
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"a rank failed:\n{out[-3000:]}"


def _jax_side(case, tmp_path, x, tm):
    """(prediction, loss, KL or None, gradients by the port's parameter
    names) of JAX's spatialized model for `case` (`tm`: the port's)."""
    name, graph, _ = CASES[case]
    if graph == "global":
        kind = "dummydata_global"
        jds = JDummyGlobalDatastore(n_lon=GLOBAL[0], n_lat=GLOBAL[1],
                                    n_timesteps=10)
        jb = j_create_global_graph("", jds.get_xy("state"), refinements=2,
                                   n_levels=2, hierarchical=True)
    else:
        kind = "dummydata"
        jds = JDummyDatastore(grid_shape=GRID, n_timesteps=10)
        jb = j_create_graph(str(tmp_path / f"jg_{case}"),
                            jds.get_xy("state", stacked=False),
                            n_max_levels=2 if graph == "hier" else None,
                            hierarchical=graph == "hier")
    jm = J_MODELS[name](
        JModelArgs(hidden_dim=H, processor_layers=LAYERS, latent_dim=D_Z),
        JNeuralLAMConfig(datastore=JDatastoreSelection(kind, "")),
        jds, j_graph_from_bundle(jb))
    params = jax_params_from_port(jm, tm)
    sp = j_spatialize(jm, j_make_mesh(n_data=1, n_space=2))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    latent = getattr(jm, "is_latent", False)

    def f(p):
        if latent:
            ctx = {**sp.precompute_rollout_ctx(p), "latent_eps": j["eps"],
                   "latent_target": j["target"][:, 0]}
            pred, _ = sp.predict_step(p, j["init"][:, 1], j["init"][:, 0],
                                      j["forcing"][:, 0], ctx=ctx)
            kl = ctx["_latent_kl"]
            return jnp.mean(pred ** 2) + jnp.mean(kl), (pred, kl)
        pred, _ = sp.predict_step(p, j["init"][:, 1], j["init"][:, 0],
                                  j["forcing"][:, 0])
        loss = sp.training_loss(p, (j["init"], j["target"], j["forcing"],
                                    j["times"]))
        return loss, (pred, None)

    (loss, (pred, kl)), grads = run_compiled(
        jax.value_and_grad(f, has_aux=True), params)
    named = {}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        named[key] = np.asarray(g)
    return (np.asarray(pred), float(loss),
            None if kl is None else np.asarray(kl), named)


def _inputs(rng, model):
    """One batch of inputs of `model`'s grid (and noise for its latent
    nodes, which the non-latent models ignore)."""
    n, d = model.num_grid_nodes, model.num_state_vars
    d_f = model.grid_dim - 2 * d - model.grid_static_dim
    return dict(
        init=rng.standard_normal((B, 2, n, d)).astype(np.float32),
        target=rng.standard_normal((B, T, n, d)).astype(np.float32),
        forcing=rng.standard_normal((B, T, n, d_f)).astype(np.float32),
        times=np.arange(B * T, dtype=np.int64).reshape(B, T),
        eps=rng.standard_normal(
            (B, getattr(model, "latent_num_nodes", 1), D_Z)).astype(
                np.float32))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' results, JAX's results by case)."""
    out = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(3)
    models = {case: build(case, out / f"tg_{case}")[0] for case in CASES
              if CASES[case][2] is None}
    # the 30x28 cases share one batch (GraphEFM's noise shape); the
    # global case has its own
    xs = {"lam": _inputs(rng, models["graph_efm"]),
          "global": _inputs(rng, models["hi_efm"])}
    np.savez(out / "inputs.npz", **xs["lam"],
             **{f"global/{k}": v for k, v in xs["global"].items()})
    run_ranks([str(out)], world=2)
    ranks = dict(np.load(out / "ranks.npz"))
    jax_res = {case: _jax_side(
        case, out, xs["global" if CASES[case][1] == "global" else "lam"], tm)
        for case, tm in models.items()}
    return ranks, jax_res


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2] is None])
def test_sharded_model_matches_jax_spatialize(case, results):
    ranks, jax_res = results
    pred, loss, kl, grads = jax_res[case]
    np.testing.assert_allclose(ranks[f"{case}/pred"], pred, atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(ranks[f"{case}/loss"]), loss,
                               rtol=1e-5)
    if kl is not None:
        np.testing.assert_allclose(ranks[f"{case}/kl"], kl, atol=1e-4,
                                   rtol=0)
    port = {k.split("/grad/")[1]: v for k, v in ranks.items()
            if k.startswith(f"{case}/grad/")}
    assert set(port) == set(grads), set(port) ^ set(grads)
    for k, g in grads.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        gap = float(np.abs(port[k] - g).max())
        assert gap <= 5e-4 * scale, (k, gap, scale)


def test_host_merges_over_data_groups(results):
    """psum_across_hosts, mean_across_data and broadcast_object over the
    data groups of a 2 x 1 mesh, on each rank."""
    ranks, _ = results
    for r in range(2):
        np.testing.assert_array_equal(ranks[f"host/psum{r}"],
                                      np.full((2, 3), 3.0))
        assert float(ranks[f"host/mean{r}"]) == 0.5
        assert int(ranks[f"host/bcast{r}"]) == 10


def test_sharded_bf16_error_size(results):
    ranks, _ = results
    fp32 = ranks["graph_lam_bf16/pred_fp32"]
    err_sharded = np.abs(ranks["graph_lam_bf16/pred_sharded"] - fp32).mean()
    err_plain = np.abs(ranks["graph_lam_bf16/pred_plain"] - fp32).mean()
    assert err_plain > 0
    assert 0.9 <= err_sharded / err_plain <= 1.1, (err_sharded, err_plain)
