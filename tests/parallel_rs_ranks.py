"""A rank process of the port's mesh-node-sharded tests (no JAX here).

    python tests/parallel_rs_ranks.py RANK WORLD PORT OUT_DIR CASES

Joins a gloo world of WORLD ranks on the CPU at 127.0.0.1:PORT and runs
each case of the comma-separated CASES, with OUT_DIR/inputs.npz as its
inputs (the global case's under "global/"):

* "collectives": `collectives.reduce_scatter`, `all_gather` and
  `ppermute` on this rank's slice of the "coll/..." arrays, their outputs
  and the gradients of given cotangents, written by every rank to
  OUT_DIR/coll{RANK}.npz;
* "<family>:<scheme>" (`RS_CASES`): the model built from its seed on
  every rank, sharded over the WORLD space ranks by
  `spatialize_scheme(model, mesh, "mesh_rs" | "mesh_halo")`: its one-step
  prediction, its loss (a latent model's: the mean square of the
  prediction plus the mean KL, from the given noise and target; another
  model's training loss over a 2-step unroll), the KL, and the parameter
  gradients summed over the ranks (`collectives.reduce_gradients`),
  written by rank 0 to OUT_DIR/ranks.npz; for a "*_bf16" case the
  sharded bf16, unsharded bf16 and unsharded fp32 predictions instead.

Run by tests/test_torch_port_parallel_rs_models.py and
tests/test_torch_port_parallel_rs_halo.py.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from neural_lam_tpu_torch.ops import message_passing  # noqa: E402
from neural_lam_tpu_torch.parallel import collectives, distributed  # noqa
from neural_lam_tpu_torch.parallel.grid_sharded import (  # noqa: E402
    spatialize_scheme,
)
from neural_lam_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from parallel_ranks import FLAT_MIN_VIRT, build_model  # noqa: E402

# case -> (model, graph: "flat" multiscale, "hier" 2 levels or "global"
# (the 24x12 grid's icosahedral mesh), compute dtype, scheme)
RS_CASES = {
    f"{m}{suffix}:{sc}": (m, g, dtype, f"mesh_{sc}")
    for sc in ("rs", "halo")
    for m, suffix, g, dtype in (
        ("graph_lam", "", "flat", None),
        ("hi_lam", "", "hier", None),
        ("hi_lam_parallel", "", "hier", None),
        ("graph_efm", "", "flat", None),
        ("hi_efm", "", "hier", None),
        ("hi_efm", "_global", "global", None),
        ("graph_lam", "_bf16", "flat", "bfloat16"))
}
# the collective cases: (name, kind, per-rank input key, dim or shift)
COLLECTIVES = (("rs_flat", "reduce_scatter", "x2", 0),
               ("rs_batched", "reduce_scatter", "x3", 1),
               ("rs_bf16", "reduce_scatter", "x2", 0),
               ("ag_flat", "all_gather", "a2", 0),
               ("ag_batched", "all_gather", "a3", 1),
               ("pp_up", "ppermute", "p2", 1),
               ("pp_down", "ppermute", "p2", -1))


def run_collectives(x, rank, group):
    """{name: output, name/grad: the gradient of sum(output * ct)} of
    each of `COLLECTIVES` on this rank's slices."""
    fns = {"reduce_scatter": collectives.reduce_scatter,
           "all_gather": collectives.all_gather,
           "ppermute": collectives.ppermute}
    out = {}
    for name, kind, key, arg in COLLECTIVES:
        inp = x[f"coll/{key}"][rank].clone()
        if name == "rs_bf16":
            inp = inp.to(torch.bfloat16)
        inp.requires_grad_(True)
        y = fns[kind](inp, group, arg)
        ct = x[f"coll/ct_{name}"][rank].to(y.dtype)
        (y * ct).sum().backward()
        out[name] = y.detach().float().numpy()
        out[f"{name}/grad"] = inp.grad.float().numpy()
    return out


def step_and_loss(model, x, latent):
    """(one-step prediction, loss, KL or None), as the module doc says."""
    init, target, forcing = x["init"], x["target"], x["forcing"]
    if latent:
        # the batch's noise has the most latent rows of its cases
        eps = x["eps"][:, :model.latent_num_nodes]
        ctx = {**model.precompute_rollout_ctx(), "latent_eps": eps,
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
    cases = sys.argv[5].split(",")
    torch.set_num_threads(1)
    message_passing._FLAT_MIN_VIRT = FLAT_MIN_VIRT
    distributed.init_multihost(f"127.0.0.1:{port}", world, rank,
                               backend="gloo", device="cpu", timeout_s=100)
    mesh = make_mesh(n_space=world)
    inputs = np.load(out / "inputs.npz")
    xs = {"lam": {}, "global": {}}
    for k in inputs.files:
        where = "global" if k.startswith("global/") else "lam"
        xs[where][k.removeprefix("global/")] = torch.from_numpy(inputs[k])
    res = {}
    for case in cases:
        if case == "collectives":
            np.savez(out / f"coll{rank}.npz", **run_collectives(
                xs["lam"], rank, mesh.space_group))
            continue
        name, graph, dtype, scheme = RS_CASES[case]
        gdir = out / f"graph_{case.replace(':', '_')}_{rank}"
        model, _ = build_model(name, graph, dtype, gdir)
        sp = spatialize_scheme(model, mesh, scheme)
        x = xs["global" if graph == "global" else "lam"]
        if dtype is not None:  # the bf16 case: its forecasts only
            step = (x["init"][:, 1], x["init"][:, 0], x["forcing"][:, 0])
            fp32, _ = build_model(name, graph, None,
                                  gdir.with_name(gdir.name + "_fp32"))
            with torch.no_grad():
                for what, m in (("sharded", sp), ("plain", model),
                                ("fp32", fp32)):
                    res[f"{case}/pred_{what}"] = m.predict_step(
                        *step)[0].float().numpy()
            continue
        pred, loss, kl = step_and_loss(sp, x, getattr(model, "is_latent",
                                                      False))
        loss.backward()
        collectives.reduce_gradients(model.parameters(), mesh.world_group,
                                     mesh.n_data)
        res[f"{case}/pred"] = pred.detach().numpy()
        res[f"{case}/loss"] = np.asarray(float(loss))
        if kl is not None:
            res[f"{case}/kl"] = kl.detach().numpy()
        for k, p in model.named_parameters():
            if p.grad is not None:
                res[f"{case}/grad/{k}"] = p.grad.numpy()
    distributed.barrier()
    if rank == 0:
        np.savez(out / "ranks.npz", **res)
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main()
