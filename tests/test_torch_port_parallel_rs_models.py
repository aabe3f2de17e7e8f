"""The mesh_rs scheme over two rank processes against the JAX package's
`spatialize_rs(model, make_mesh(n_data=1, n_space=2))`, and the
scheme's collectives against the `shard_map` ones, on the CPU.

The JAX side runs here, on two of the 8 virtual CPU devices that
tests/conftest.py gives (its CPU route, Pallas off; compiled once a case
at XLA's lowest optimization level, `run_compiled`), with the port's
seeded weights. The port's side runs in two rank processes
(tests/parallel_rs_ranks.py: a gloo world on the CPU, one torch thread
each, each waited on with its own timeout) on the inputs this test
writes as .npz, on its mixed route (`_FLAT_MIN_VIRT` 100). Held:

* `collectives.reduce_scatter`, `all_gather` and `ppermute` (both
  shifts): each rank's output and the gradient of a given cotangent
  equal JAX's tiled `psum_scatter`, tiled `all_gather` and `ppermute`
  under `shard_map`, and `jax.vjp` of them, within 1e-6 (the all-gather's
  backward is a reduce-scatter, not `gather_blocks`' own block); a bf16
  reduce-scatter sums in fp32 and rounds once;
* GraphLAM, HiLAM and HiLAMParallel (2 levels) on a 30x28 grid, hidden
  64, one processor layer, batch 2, under mesh_rs: the one-step
  prediction within 1e-4 of JAX's, the training loss of a 2-step unroll
  within 1e-5 relative, its gradients within 5e-4 x max abs per
  parameter (`check_case`);
* a bf16 GraphLAM under mesh_rs: its bf16 error against the fp32
  prediction within 0.9-1.1x of the unsharded bf16 model's.

tests/test_torch_port_parallel_rs_halo.py holds the same families under
mesh_halo, tests/test_torch_port_parallel_rs_latent.py the latent ones
under both; their helpers are this file's.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

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
from neural_lam_tpu.parallel.grid_sharded import (
    spatialize_rs as j_spatialize_rs,
)
from neural_lam_tpu.parallel.mesh import make_mesh as j_make_mesh

from .latent_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    jax_params_from_port,
    one_torch_thread,
    run_compiled,
)
from .parallel_ranks import GLOBAL, GRID, H, LAYERS, D_Z, build_model
from .parallel_rs_ranks import COLLECTIVES, RS_CASES
from .test_torch_port_parallel_models import (
    RANK_TIMEOUT_S,
    ROOT,
    _inputs,
    free_port,
)

CASES = ["graph_lam:rs", "hi_lam:rs", "hi_lam_parallel:rs"]


def run_rank_processes(out, cases, world=2, timeout=RANK_TIMEOUT_S):
    """Start `world` rank processes of tests/parallel_rs_ranks.py on
    `cases`, wait for each with its own timeout, and fail with their
    output if any fails."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "parallel_rs_ranks.py"),
         str(r), str(world), str(port), str(out), ",".join(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = p.communicate()
            pytest.fail(f"a rank timed out:\n{o[-3000:]}")
        outs.append(o)
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"a rank failed:\n{o[-3000:]}"


def write_inputs(out, cases, rng):
    """The cases' inputs (.npz the ranks read): one batch of the 30x28
    grid, one of the global grid, noise for the most latent rows of the
    cases, and the collectives' per-rank arrays and cotangents. Returns
    {"lam": ..., "global": ...}."""
    models = {}
    for case in cases:
        name, graph, dtype, _ = RS_CASES[case]
        if dtype is None:
            models[case] = build_model(name, graph, None,
                                       out / f"tg_{case.replace(':', '_')}")[0]
    lam = [m for c, m in models.items() if RS_CASES[c][1] != "global"]
    glob = [m for c, m in models.items() if RS_CASES[c][1] == "global"]
    xs = {}
    for where, ms in (("lam", lam), ("global", glob)):
        if ms:
            most = max(ms, key=lambda m: getattr(m, "latent_num_nodes", 1))
            xs[where] = _inputs(rng, most)
    flat = {**{k: v for k, v in xs.get("lam", {}).items()},
            **{f"global/{k}": v for k, v in xs.get("global", {}).items()}}
    shapes = {"x2": (2, 6, 10), "x3": (2, 2, 6, 5), "a2": (2, 3, 10),
              "a3": (2, 2, 3, 5), "p2": (2, 4, 5)}
    for key, shape in shapes.items():
        flat[f"coll/{key}"] = rng.standard_normal(shape).astype(np.float32)
    for name, kind, key, arg in COLLECTIVES:
        shape = list(shapes[key])
        if kind != "ppermute":
            shape[1 + arg] = shape[1 + arg] // 2 if kind == \
                "reduce_scatter" else shape[1 + arg] * 2
        flat[f"coll/ct_{name}"] = rng.standard_normal(shape).astype(
            np.float32)
    np.savez(out / "inputs.npz", **flat)
    return models, xs, flat


def _jax_collective(kind, arg, glob, ct, dim):
    mesh = j_make_mesh(n_data=1, n_space=2)
    spec = P(*([None] * dim + ["space"]))
    if kind == "reduce_scatter":
        def body(v):
            return jax.lax.psum_scatter(v, "space", scatter_dimension=dim,
                                        tiled=True)
    elif kind == "all_gather":
        def body(v):
            return jax.lax.all_gather(v, "space", axis=dim, tiled=True)
    else:
        perm = [(s, s + arg) for s in range(2) if 0 <= s + arg < 2]

        def body(v):
            return jax.lax.ppermute(v, "space", perm=perm)
    f = shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec,
                  check_vma=False)
    y, vjp = jax.vjp(f, jnp.asarray(glob))
    (g,) = vjp(jnp.asarray(ct))
    return np.asarray(y), np.asarray(g)


def check_collectives(out, flat):
    ranks = [dict(np.load(out / f"coll{r}.npz")) for r in range(2)]
    for name, kind, key, arg in COLLECTIVES:
        per, ct = flat[f"coll/{key}"], flat[f"coll/ct_{name}"]
        if name == "rs_bf16":
            x16 = torch.from_numpy(per).to(torch.bfloat16).float()
            want = x16.sum(0).to(torch.bfloat16).float().numpy()
            for r in range(2):
                np.testing.assert_array_equal(
                    ranks[r][name], want[3 * r:3 * r + 3], err_msg=name)
            continue
        dim = arg if kind != "ppermute" else 0
        y, g = _jax_collective(kind, arg, np.concatenate(list(per), dim),
                               np.concatenate(list(ct), dim), dim)
        ys, gs = np.split(y, 2, axis=dim), np.split(g, 2, axis=dim)
        for r in range(2):
            np.testing.assert_allclose(ranks[r][name], ys[r], atol=1e-6,
                                       rtol=0, err_msg=f"{name} rank {r}")
            np.testing.assert_allclose(ranks[r][f"{name}/grad"], gs[r],
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} grad rank {r}")


def jax_case(case, tmp_path, x, tm):
    """(prediction, loss, KL or None, gradients by the port's parameter
    names) of JAX's `spatialize_rs` model for `case` (`tm`: the port's)."""
    name, graph, _, scheme = RS_CASES[case]
    if graph == "global":
        kind = "dummydata_global"
        jds = JDummyGlobalDatastore(n_lon=GLOBAL[0], n_lat=GLOBAL[1],
                                    n_timesteps=10)
        jb = j_create_global_graph("", jds.get_xy("state"), refinements=2,
                                   n_levels=2, hierarchical=True)
    else:
        kind = "dummydata"
        jds = JDummyDatastore(grid_shape=GRID, n_timesteps=10)
        jb = j_create_graph(str(tmp_path / f"jg_{case.replace(':', '_')}"),
                            jds.get_xy("state", stacked=False),
                            n_max_levels=2 if graph == "hier" else None,
                            hierarchical=graph == "hier")
    jm = J_MODELS[name](
        JModelArgs(hidden_dim=H, processor_layers=LAYERS, latent_dim=D_Z),
        JNeuralLAMConfig(datastore=JDatastoreSelection(kind, "")),
        jds, j_graph_from_bundle(jb))
    params = jax_params_from_port(jm, tm)
    sp = j_spatialize_rs(jm, j_make_mesh(n_data=1, n_space=2),
                         halo=scheme == "mesh_halo")
    j = {k: jnp.asarray(v) for k, v in x.items()}
    latent = getattr(jm, "is_latent", False)
    if latent:
        nm = jm.latent_num_nodes
        eps = jnp.pad(j["eps"][:, :nm],
                      ((0, 0), (0, sp._latent_rows - nm), (0, 0)))

    def f(p):
        if latent:
            ctx = {**sp.precompute_rollout_ctx(p), "latent_eps": eps,
                   "latent_target": j["target"][:, 0]}
            pred, _ = sp.predict_step(p, j["init"][:, 1], j["init"][:, 0],
                                      j["forcing"][:, 0], ctx=ctx)
            kl = ctx["_latent_kl"][:, :nm]
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


def rank_and_jax_results(out, cases, with_collectives=False):
    """(the ranks' results, JAX's results by case, the inputs) of `cases`
    (the ranks run the collectives too, with `with_collectives`)."""
    rng = np.random.default_rng(5)
    models, xs, flat = write_inputs(out, cases, rng)
    run_rank_processes(out, (["collectives"] if with_collectives else [])
                       + list(cases))
    ranks = dict(np.load(out / "ranks.npz"))
    jax_res = {case: jax_case(
        case, out, xs["global" if RS_CASES[case][1] == "global" else "lam"],
        tm) for case, tm in models.items()}
    return ranks, jax_res, flat


def check_case(case, ranks, jax_res):
    """The port's prediction, loss, KL and gradients of `case` against
    JAX's (the limits of the module doc)."""
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


def check_bf16(case, ranks):
    """The sharded bf16 model's error against fp32 is the unsharded bf16
    model's size."""
    fp32 = ranks[f"{case}/pred_fp32"]
    err_sharded = np.abs(ranks[f"{case}/pred_sharded"] - fp32).mean()
    err_plain = np.abs(ranks[f"{case}/pred_plain"] - fp32).mean()
    assert err_plain > 0
    assert 0.9 <= err_sharded / err_plain <= 1.1, (err_sharded, err_plain)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("rs_ranks")
    return out, rank_and_jax_results(out, CASES + ["graph_lam_bf16:rs"],
                                     with_collectives=True)


def test_collectives_match_shard_map(results):
    out, (_, _, flat) = results
    check_collectives(out, flat)


@pytest.mark.parametrize("case", CASES)
def test_rs_model_matches_jax_spatialize_rs(case, results):
    check_case(case, *results[1][:2])


def test_rs_bf16_error_size(results):
    check_bf16("graph_lam_bf16:rs", results[1][0])
