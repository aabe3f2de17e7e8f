"""The port's bf16 forecast path (compute_dtype="bfloat16") against the
JAX package's, models and CLIs, on the CPU.

The reference is the JAX package with its Pallas kernels in interpret mode
and the accelerator's casts emulated: `jmp._einsum_f32acc` and
`jmp.node_transform_from_flat` patched to round both operands to bf16 and
take the fp32 product, which is what they compute off the CPU. Unpatched,
on the CPU they skip that rounding (their CPU dot thunk has no bf16 x bf16
-> fp32), and with Pallas off the batched route skips its pre-gather cast:
on GraphLAM 16x16 at batch 2, either difference alone moves the output by
1.2e-3 to 2.4e-3, as much as the whole bf16 effect (1.1e-3), so those
routes could not tell a right port from a wrong one. Nothing in the JAX
package changes: both functions are looked up by module-global name at
their call sites, and the tests patch the module attribute.

Models (GraphLAM 16x16, hidden 64, 2 processor layers, weights from
`convert.params_from_jax`), on the flat route (`_FLAT_MIN_VIRT` = 1 on
both sides, batch 2: K1-K4) and the batched route (batch 1: P2, P3); the
HiLAM cases are in test_torch_port_bf16_hilam.py. For one predict step
and a 3-step rollout:

* Every interaction-net round of the JAX bf16 predict step, recorded with
  its inputs, against the port's round on the same inputs: fewer than 1%
  of the outputs not bit-equal, each within 4 bf16 ulps of the output's
  largest magnitude (a value that rounds the other way in one of the
  round's stored-in-bf16 steps moves the rest of its row by an ulp or
  two). This pins every rounding site of the round.
* The whole output: the port's bf16 error against the JAX fp32 output
  has the size of JAX's own (mean abs within 0.9-1.1x, max abs within
  0.5-1.5x), and the port's bf16-vs-fp32 gap is at least half of JAX's
  (a "bf16" path that stayed fp32 fails here). The port-vs-JAX gap of
  the bf16 outputs themselves is not held to a fraction of the bf16
  effect: bf16 storage makes the network chaotic at this scale. Where
  the two sides' fp32 arithmetic differs in its last bit (torch's and
  XLA's silu, sum orders), a value on a bf16 rounding boundary rounds
  the other way, and the flip spreads through the following stored-in-
  bf16 layers: on the batched route 60% of the outputs end up differing
  by one or more ulps, and the max gap is 0.7-1.1x the bf16 effect.
  Measured here: port/JAX error ratios 0.96-1.01 (mean), 0.85-1.13
  (max); a route that skips the cast sites doubles the mean.

CLIs: `predict.main --precision bf16` (and `bf16-mixed`) on the MDP
fixture from a converted JAX checkpoint equals the port model's bf16
rollout bit for bit and differs from `--precision 32`;
`train.main --eval test --precision bf16` writes its maps; bf16 training
raises before any step, naming the training slice.
"""

import contextlib
import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import convert_jax_checkpoint
import neural_lam_tpu.models.base_graph_model as jbg
import neural_lam_tpu.models.base_hi_graph_model as jbh
import neural_lam_tpu.models.graph_lam as jgl
import neural_lam_tpu.models.hi_lam as jhl
from neural_lam_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
    load_config_and_datastore as j_load_config_and_datastore,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.datastore.mdp import MDPDatastore as JMDPDatastore
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu_torch import predict, train
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.datastore.mdp import MDPDatastore
from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops.message_passing import init_interaction_net

from .mdp_fixture import make_mdp_dataset

BF = torch.bfloat16
T, LAYERS = 3, 2
# case -> (model, grid side, batch, _FLAT_MIN_VIRT on both sides or None)
CASES = {
    "graph_lam-flat": ("graph_lam", 16, 2, 1),
    "graph_lam-batched": ("graph_lam", 16, 1, None),
}
MEAN_RATIO = (0.9, 1.1)  # port's bf16 error / JAX's, mean abs
MAX_RATIO = (0.5, 1.5)  # the same, max abs
ROUND_ULPS = 4  # each round output, in ulps of its largest magnitude


def accelerator_einsum(spec, x, w, compute_dtype=None):
    """jmp._einsum_f32acc as the accelerator computes it: both operands
    rounded to the compute dtype, the product in fp32."""
    if compute_dtype is not None:
        x, w = x.astype(compute_dtype), w.astype(compute_dtype)
    return jnp.einsum(spec, x.astype(jnp.float32), w.astype(jnp.float32),
                      preferred_element_type=jnp.float32)


def accelerator_transform_from_flat(x_f, w, batch_size, compute_dtype=None):
    """jmp.node_transform_from_flat as the accelerator computes it."""
    wk = jnp.kron(jnp.eye(batch_size, dtype=jnp.float32),
                  w.astype(jnp.float32))
    if compute_dtype is not None:
        x_f, wk = x_f.astype(compute_dtype), wk.astype(compute_dtype)
    return jnp.dot(x_f.astype(jnp.float32), wk.astype(jnp.float32),
                   preferred_element_type=jnp.float32)


@contextlib.contextmanager
def jax_reference(mode, min_virt):
    """The JAX package with Pallas in `mode` and the accelerator's casts;
    both packages' flat-route threshold at `min_virt` (None: as is)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmp, "_PALLAS_MODE", mode)
        mp.setattr(jmp, "_einsum_f32acc", accelerator_einsum)
        mp.setattr(jmp, "node_transform_from_flat",
                   accelerator_transform_from_flat)
        if min_virt is not None:
            mp.setattr(jmp, "_FLAT_MIN_VIRT", min_virt)
            mp.setattr(tmp, "_FLAT_MIN_VIRT", min_virt)
        yield mp


def build_models(tmp_path_factory, kind, nx):
    """(JAX models {None, "bfloat16"}, JAX params, port models {None,
    "bfloat16"}) on an nx x nx DummyDatastore, hidden 64."""
    jds = JDummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    hier = kind.startswith("hi_")
    jg = j_graph_from_bundle(j_create_graph(
        str(tmp_path_factory.mktemp("jg")), jds.get_xy("state", stacked=False),
        n_max_levels=None, hierarchical=hier))
    tg = graph_from_bundle(create_graph(
        str(tmp_path_factory.mktemp("tg")), tds.get_xy("state", stacked=False),
        n_max_levels=None, hierarchical=hier), device="cpu")
    jcfg = JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", ""))
    tcfg = NeuralLAMConfig(datastore=DatastoreSelection("dummydata", ""))
    dtypes = (None, "bfloat16")
    jm = {cd: J_MODELS[kind](JModelArgs(hidden_dim=64, processor_layers=LAYERS,
                                        compute_dtype=cd), jcfg, jds, jg)
          for cd in dtypes}
    params = jm[None].init_params(jax.random.PRNGKey(0))
    state = params_from_jax(jax.tree.map(np.asarray, params))
    tm = {}
    for cd in dtypes:
        tm[cd] = MODELS[kind](ModelArgs(hidden_dim=64, processor_layers=LAYERS,
                                        compute_dtype=cd), tcfg, tds, tg,
                              device="cpu")
        tm[cd].load_state_dict(state)
    return jm, params, tm


def _t(a):
    """A JAX array (or None) as a torch tensor of the same dtype."""
    if a is None:
        return None
    t = torch.as_tensor(np.array(a.astype(jnp.float32)))
    return t.to(BF) if a.dtype == jnp.bfloat16 else t


def run_case(jm, params, tm, B, min_virt):
    """Everything the tests of a case read: the predict steps and 3-step
    rollouts of JAX fp32 (Pallas off), JAX bf16 (the reference) and the
    port in both dtypes, and the JAX bf16 step's interaction-net rounds
    with their inputs."""
    rng = np.random.default_rng(B)
    ref = tm[None]
    n, d = ref.num_grid_nodes, ref.num_state_vars
    init = rng.standard_normal((B, 2, n, d)).astype(np.float32)
    forcing = rng.standard_normal(
        (B, T, n, ref.num_forcing_vars * 3)).astype(np.float32)
    true = rng.standard_normal((B, T, n, d)).astype(np.float32)
    out = {}

    def jax_run(cd):
        step, _ = jm[cd].predict_step(params, jnp.asarray(init[:, 1]),
                                      jnp.asarray(init[:, 0]),
                                      jnp.asarray(forcing[:, 0]))
        roll, _ = jm[cd].unroll_prediction(params, jnp.asarray(init),
                                           jnp.asarray(forcing),
                                           jnp.asarray(true))
        return (np.asarray(step, np.float32), np.asarray(roll, np.float32))

    with jax_reference("off", None):
        out["jax", None] = jax_run(None)
    rounds = []
    with jax_reference("interpret", min_virt) as mp:
        real = jmp.apply_interaction_net

        def record(p, edges, send_rep, rec_rep, edge_rep=None, **kw):
            res = real(p, edges, send_rep, rec_rep, edge_rep, **kw)
            rounds.append((p, edges, send_rep, rec_rep, edge_rep, kw, res))
            return res

        for mod in (jmp, jgl, jhl, jbh, jbg):
            mp.setattr(mod, "apply_interaction_net", record)
        jm["bfloat16"].predict_step(params, jnp.asarray(init[:, 1]),
                                    jnp.asarray(init[:, 0]),
                                    jnp.asarray(forcing[:, 0]))
        for mod in (jmp, jgl, jhl, jbh, jbg):
            mp.setattr(mod, "apply_interaction_net", real)
        out["jax", "bfloat16"] = jax_run("bfloat16")
        for cd in (None, "bfloat16"):
            with torch.no_grad():
                step, _ = tm[cd].predict_step(
                    torch.as_tensor(init[:, 1]), torch.as_tensor(init[:, 0]),
                    torch.as_tensor(forcing[:, 0]))
                roll, _ = tm[cd].unroll_prediction(
                    torch.as_tensor(init), torch.as_tensor(forcing),
                    torch.as_tensor(true))
            out["port", cd] = (step.numpy(), roll.numpy())
        out["rounds"] = port_rounds(rounds, jm["bfloat16"].graph,
                                    tm["bfloat16"].graph)
    return out


def port_rounds(rounds, jgraph, tgraph):
    """[(what, JAX outputs, port outputs)] of each recorded JAX round, the
    port's round run on the same inputs and weights."""
    sets = {}
    for name in ("g2m", "m2g", "m2m", "up", "down"):
        j, t = getattr(jgraph, name), getattr(tgraph, name)
        if isinstance(j, (list, tuple)):
            sets.update({id(a): (f"{name}[{i}]", b)
                         for i, (a, b) in enumerate(zip(j, t))})
        elif j is not None:
            sets[id(j)] = (name, t)
    got = []
    for p, edges, send, rec, edge_rep, kw, res in rounds:
        what, t_edges = sets[id(edges)]
        inet = init_interaction_net(64)
        inet.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p)))
        with torch.no_grad():
            o = tmp.apply_interaction_net(
                inet, t_edges, _t(send), _t(rec), _t(edge_rep),
                ew=_t(kw.get("ew")), update_edges=kw.get("update_edges",
                                                         True),
                aggr=kw.get("aggr", "sum"), compute_dtype=BF)
        res, o = (res if isinstance(res, tuple) else (res,),
                  o if isinstance(o, tuple) else (o,))
        got.append((what, res, o))
    return got


def check_rounds(out):
    """Every recorded round: outputs bf16 on both sides, fewer than 1%
    not bit-equal, each within ROUND_ULPS ulps of the output's largest
    magnitude (see the module doc)."""
    assert out["rounds"], "no interaction-net round was recorded"
    for what, res, o in out["rounds"]:
        for name, j, t in zip(("rec_out", "edge_out"), res, o):
            assert j.dtype == jnp.bfloat16 and t.dtype == BF, (what, name)
            j = np.asarray(j.astype(jnp.float32))
            t = t.float().numpy()
            assert j.shape == t.shape, (what, name, j.shape, t.shape)
            scale = 2.0 ** (np.floor(np.log2(np.abs(j).max())) - 7)
            share = float(np.mean(j != t))
            worst = float(np.abs(j - t).max() / scale)
            assert share < 0.01 and worst <= ROUND_ULPS, (
                f"{what} {name}: {share:.4%} of {j.size} not bit-equal, "
                f"worst {worst:.1f} ulps of its largest magnitude")


def check_output(out, i, what):
    """Output i (0: the predict step, 1: the rollout) of a case: the size
    of the port's bf16 error against JAX's, and the guard (module doc)."""
    j32, j16 = out["jax", None][i], out["jax", "bfloat16"][i]
    t32, t16 = out["port", None][i], out["port", "bfloat16"][i]
    assert t16.shape == j16.shape and np.isfinite(t16).all()
    err_j, err_t = np.abs(j16 - j32), np.abs(t16 - j32)
    mean_ratio = err_t.mean() / err_j.mean()
    max_ratio = err_t.max() / err_j.max()
    own = np.abs(t16 - t32).max()
    msg = (f"{what}: bf16 error vs the JAX fp32 output, port / JAX: mean "
           f"{err_t.mean():.3e} / {err_j.mean():.3e} = {mean_ratio:.3f}, "
           f"max {err_t.max():.3e} / {err_j.max():.3e} = {max_ratio:.3f}; "
           f"bf16-vs-fp32 gap, port {own:.3e}, JAX {err_j.max():.3e}; "
           f"port vs JAX bf16, max {np.abs(t16 - j16).max():.3e}")
    assert MEAN_RATIO[0] <= mean_ratio <= MEAN_RATIO[1], msg
    assert MAX_RATIO[0] <= max_ratio <= MAX_RATIO[1], msg
    assert own >= 0.5 * err_j.max(), msg


@pytest.fixture(scope="module")
def graph_lam(tmp_path_factory):
    return build_models(tmp_path_factory, "graph_lam", 16)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, graph_lam):
    kind, nx, B, min_virt = CASES[request.param]
    jm, params, tm = graph_lam
    out = run_case(jm, params, tm, B, min_virt)
    return request.param, out


def test_bf16_rounds_match_jax_on_its_inputs(case):
    """Each interaction-net round of the JAX bf16 predict step, on its
    own inputs, against the port's (module doc)."""
    check_rounds(case[1])


def test_bf16_predict_step_matches_jax(case):
    """One bf16 predict step: the port's bf16 error has JAX's size, and
    it is bf16 (module doc)."""
    check_output(case[1], 0, f"{case[0]} predict step")


def test_bf16_rollout_matches_jax(case):
    """A 3-step bf16 rollout with boundary overwrite, as the step."""
    check_output(case[1], 1, f"{case[0]} 3-step rollout")


def test_bf16_routes(graph_lam):
    """The routes the cases exercise: at batch 2 with the threshold at 1,
    every set flat (K1-K4); at batch 1, every set batched."""
    tm = graph_lam[2]["bfloat16"]
    g = tm.graph
    sets = (g.g2m, g.m2g, g.m2m[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmp, "_FLAT_MIN_VIRT", 1)
        assert all(tmp.flat_eligible(es, 2, 64) for es in sets)
        assert tm._flat_grid_eligible(2)
    assert not any(tmp.flat_eligible(es, 1, 64) for es in sets)


# --- the CLIs ------------------------------------------------------------


H, STEPS = 16, 2


@pytest.fixture
def mdp_checkpoint(tmp_path, monkeypatch):
    """(neural-lam config, converted JAX checkpoint) on the MDP fixture,
    its boundary frame narrowed to 2 on both packages (the 12x10 fixture
    lies wholly in the default frame)."""
    for cls in (MDPDatastore, JMDPDatastore):
        monkeypatch.setattr(cls.__init__, "__defaults__", (2,))
    root = tmp_path / "ds"
    root.mkdir()
    ds_cfg = make_mdp_dataset(root)
    cfg = root / "config.yaml"
    cfg.write_text(yaml.safe_dump({"datastore": {
        "kind": "mdp", "config_path": ds_cfg.name}}))
    config, jds = j_load_config_and_datastore(cfg)
    jmodel = J_MODELS["graph_lam"](
        JModelArgs(graph="g1level", hidden_dim=H, processor_layers=1),
        config, jds)
    j_save_checkpoint(tmp_path / "jax", "best",
                      jmodel.init_params(jax.random.PRNGKey(3)),
                      meta={"step": 1})
    return cfg, convert_jax_checkpoint.convert(tmp_path / "jax" / "best",
                                               tmp_path / "port")


def test_predict_cli_bf16_equals_the_models_bf16_rollout(mdp_checkpoint,
                                                         tmp_path):
    """`predict.main --precision bf16` and `bf16-mixed` forecast the bf16
    rollout of the port's model bit for bit (un-standardized the same
    way), and differ from `--precision 32`."""
    cfg, ckpt = mdp_checkpoint
    common = ["--config_path", str(cfg), "--graph", "g1level",
              "--hidden_dim", str(H), "--processor_layers", "1",
              "--ar_steps", str(STEPS), "--split", "train", "--sample_idx",
              "-1", "--load", str(ckpt), "--device", "cpu"]
    fc = {}
    for prec in ("32", "bf16", "bf16-mixed"):
        predict.main(common + ["--precision", prec,
                               "--out", str(tmp_path / f"{prec}.zarr")])
        fc[prec] = ZarrGroup(tmp_path / f"{prec}.zarr")["state"].read_full()
    args = predict.parse_args(common + ["--precision", "bf16", "--out",
                                        "x.zarr"])
    model, datastore, _ = predict.prepare(args)
    assert model.compute_dtype == BF
    pred, _ = predict.rollout(model, datastore, args)
    stats = datastore.get_standardization_dataarray(category="state")
    want = (pred * np.asarray(stats["state_std"], np.float32)
            + np.asarray(stats["state_mean"], np.float32))
    np.testing.assert_array_equal(fc["bf16"], want)
    np.testing.assert_array_equal(fc["bf16-mixed"], fc["bf16"])
    assert np.isfinite(fc["bf16"]).all()
    gap = np.abs(fc["bf16"] - fc["32"]).max()
    assert gap > 0, "the bf16 forecast equals the fp32 one"


def test_train_cli_evaluates_in_bf16_and_refuses_to_train(mdp_checkpoint,
                                                          tmp_path):
    """`train.main --eval test --precision bf16` scores the checkpoint on
    the bf16 path and writes its maps; `--precision bf16` without --eval
    (which once refused) trains on the bf16 path, and its checkpoint
    scores again in bf16."""
    cfg, ckpt = mdp_checkpoint
    common = ["--config_path", str(cfg), "--device", "cpu", "--graph",
              "g1level", "--hidden_dim", str(H), "--processor_layers", "1",
              "--batch_size", "2", "--ar_steps_eval", "2",
              "--val_steps_to_log", "1", "2", "--save_dir",
              str(tmp_path / "models")]
    res = {}
    for prec in ("32", "bf16"):
        res[prec] = train.main(common + [
            "--eval", "test", "--load", str(ckpt), "--precision", prec,
            "--run_name", f"eval{prec}", "--n_example_pred", "0"])
        run = tmp_path / "models" / f"eval{prec}"
        for f in ("test_rmse.csv", "test_mae.csv", "mean_spatial_loss.npy",
                  "spatial_loss_t1.npy", "spatial_loss_t2.npy"):
            assert (run / f).exists(), (prec, f)
    a, b = (np.loadtxt(tmp_path / "models" / f"eval{p}" / "test_rmse.csv",
                       delimiter=",") for p in ("32", "bf16"))
    assert np.isfinite(b).all() and not np.array_equal(a, b)
    np.testing.assert_allclose(b, a, rtol=5e-2)
    train.main(common + ["--precision", "bf16", "--epochs", "1",
                         "--max_steps", "2", "--load", str(ckpt),
                         "--run_name", "train_bf16"])
    run = tmp_path / "models" / "train_bf16"
    assert (run / "last").exists() and (run / "metrics.jsonl").exists()
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    assert any(np.isfinite(r.get("train_loss", np.nan)) for r in logged)
    res["trained"] = train.main(common + [
        "--eval", "test", "--load", str(run / "last"), "--precision", "bf16",
        "--run_name", "eval_trained", "--n_example_pred", "0"])
    c = np.loadtxt(tmp_path / "models" / "eval_trained" / "test_rmse.csv",
                   delimiter=",")
    assert np.isfinite(c).all() and not np.array_equal(b, c)
