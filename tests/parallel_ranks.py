"""A rank process of the port's parallel tests (no JAX here).

    python tests/parallel_ranks.py RANK WORLD PORT OUT_DIR

Joins a gloo world of WORLD ranks on the CPU at 127.0.0.1:PORT, builds
each model of `CASES` from its seed on every rank, runs it grid-sharded
over the WORLD space ranks (`parallel.grid_sharded.spatialize`) on the
inputs in OUT_DIR/inputs.npz (the global case's under "global/"), and
rank 0 writes OUT_DIR/ranks.npz: each
case's one-step prediction, its training loss and its parameter
gradients (summed over the ranks by `collectives.reduce_gradients`), for
the bf16 case the unsharded bf16 and fp32 predictions beside the sharded
bf16 one, and every rank's results of the host-side merges over the data
groups of a WORLD x 1 mesh. Run by tests/test_torch_port_parallel_models.py.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from neural_lam_tpu_torch.config import (  # noqa: E402
    DatastoreSelection,
    NeuralLAMConfig,
)
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore  # noqa: E402
from neural_lam_tpu_torch.datastore.dummy_global import (  # noqa: E402
    DummyGlobalDatastore,
)
from neural_lam_tpu_torch.graph.build import create_graph  # noqa: E402
from neural_lam_tpu_torch.graph.global_mesh import (  # noqa: E402
    create_global_graph,
)
from neural_lam_tpu_torch.graph.storage import graph_from_bundle  # noqa
from neural_lam_tpu_torch.models import MODELS  # noqa: E402
from neural_lam_tpu_torch.models.ar_model import ModelArgs  # noqa: E402
from neural_lam_tpu_torch.ops import message_passing  # noqa: E402
from neural_lam_tpu_torch.parallel import distributed  # noqa: E402
from neural_lam_tpu_torch.parallel.collectives import (  # noqa: E402
    reduce_gradients,
)
from neural_lam_tpu_torch.parallel.grid_sharded import spatialize  # noqa
from neural_lam_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

GRID = (30, 28)
# the global case: n_lon x n_lat, an icosahedral mesh at 2 refinements in
# 2 levels (its polar grid points have the largest g2m in-degrees, split
# between the two ranks' grid blocks)
GLOBAL = (24, 12)
H, LAYERS, D_Z = 64, 1, 8
# case -> (model, graph: "flat" multiscale, "hier" 2 levels or "global",
# compute dtype)
CASES = {"graph_lam": ("graph_lam", "flat", None),
         "hi_lam": ("hi_lam", "hier", None),
         "hi_lam_parallel": ("hi_lam_parallel", "hier", None),
         "graph_efm": ("graph_efm", "flat", None),
         "hi_efm": ("hi_efm", "global", None),
         "graph_lam_bf16": ("graph_lam", "flat", "bfloat16")}
# some sets of these small graphs on the flat route, the rest batched
FLAT_MIN_VIRT = 100


def build(case, graph_dir):
    """(port model, datastore) of `case`, weights from seed 0."""
    return build_model(*CASES[case], graph_dir)


def build_model(name, graph, dtype, graph_dir):
    """(port model `name` on graph kind `graph`, datastore), weights from
    seed 0."""
    if graph == "global":
        kind = "dummydata_global"
        ds = DummyGlobalDatastore(n_lon=GLOBAL[0], n_lat=GLOBAL[1],
                                  n_timesteps=10)
        bundle = create_global_graph("", ds.get_xy("state"), refinements=2,
                                     n_levels=2, hierarchical=True)
    else:
        kind = "dummydata"
        ds = DummyDatastore(grid_shape=GRID, n_timesteps=10)
        bundle = create_graph(str(graph_dir),
                              ds.get_xy("state", stacked=False),
                              n_max_levels=2 if graph == "hier" else None,
                              hierarchical=graph == "hier")
    args = ModelArgs(hidden_dim=H, processor_layers=LAYERS, latent_dim=D_Z,
                     compute_dtype=dtype)
    model = MODELS[name](
        args, NeuralLAMConfig(datastore=DatastoreSelection(kind, "")),
        ds, graph_from_bundle(bundle, device="cpu"), device="cpu",
        generator=torch.Generator().manual_seed(0))
    return model, ds


def step_and_loss(model, x, latent):
    """(one-step prediction, loss, KL or None): a latent model's step
    with the given noise and target, its loss mean(pred^2) + mean(KL);
    another model's step and its training loss over the batch."""
    init, target, forcing = x["init"], x["target"], x["forcing"]
    if latent:
        ctx = {**model.precompute_rollout_ctx(), "latent_eps": x["eps"],
               "latent_target": target[:, 0]}
        pred, _ = model.predict_step(init[:, 1], init[:, 0], forcing[:, 0],
                                     ctx)
        kl = ctx["_latent_kl"]
        return pred, (pred ** 2).mean() + kl.mean(), kl
    with torch.no_grad():
        pred, _ = model.predict_step(init[:, 1], init[:, 0], forcing[:, 0])
    loss = model.training_loss((init, target, forcing, x["times"]))
    return pred, loss, None


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    message_passing._FLAT_MIN_VIRT = FLAT_MIN_VIRT
    distributed.init_multihost(f"127.0.0.1:{port}", world, rank,
                               backend="gloo", device="cpu", timeout_s=100)
    mesh = make_mesh(n_space=world)
    inputs = np.load(out / "inputs.npz")
    xs = {"lam": {}, "global": {}}
    for k in inputs.files:
        where, _, name = k.rpartition("/")
        xs[where or "lam"][name] = torch.from_numpy(inputs[k])
    res = {}
    for case, (_, graph, dtype) in CASES.items():
        model, _ = build(case, out / f"graph_{case}_{rank}")
        sp = spatialize(model, mesh)
        x = xs["global" if graph == "global" else "lam"]
        if dtype is not None:  # the bf16 case: its forecasts only
            step = (x["init"][:, 1], x["init"][:, 0], x["forcing"][:, 0])
            fp32, _ = build("graph_lam", out / f"graph_fp32_{rank}")
            with torch.no_grad():
                for what, m in (("sharded", sp), ("plain", model),
                                ("fp32", fp32)):
                    res[f"{case}/pred_{what}"] = m.predict_step(
                        *step)[0].float().numpy()
            continue
        pred, loss, kl = step_and_loss(sp, x, getattr(model, "is_latent",
                                                      False))
        loss.backward()
        reduce_gradients(model.parameters(), mesh.world_group, mesh.n_data)
        res[f"{case}/pred"] = pred.detach().numpy()
        res[f"{case}/loss"] = np.asarray(float(loss))
        if kl is not None:
            res[f"{case}/kl"] = kl.detach().numpy()
        for k, p in model.named_parameters():
            if p.grad is not None:
                res[f"{case}/grad/{k}"] = p.grad.numpy()
    # the host-side merges over the data groups of a 2 x 1 mesh
    dmesh = make_mesh(n_data=world)
    res[f"host/psum{rank}"] = distributed.psum_across_hosts(
        {"a": np.full((2, 3), rank + 1.0)}, dmesh)["a"]
    res[f"host/mean{rank}"] = np.asarray(
        distributed.mean_across_data(float(rank), dmesh))
    res[f"host/bcast{rank}"] = np.asarray(
        distributed.broadcast_object(10 + rank))
    distributed.barrier()
    if rank:
        np.savez(out / "host1.npz", **{k: v for k, v in res.items()
                                       if k.startswith("host/")})
    distributed.barrier()
    if rank == 0:
        res.update(np.load(out / "host1.npz"))
        np.savez(out / "ranks.npz", **res)
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main()
