"""The port's bf16 HiLAMParallel forecast against the JAX package's, on
the CPU: the cases of test_torch_port_bf16_models.py (its module doc
gives the reference, the limits and why), in a file of their own so that
the test workers share the interpret-mode runs.

A 30x30 DummyDatastore gives a two-level hierarchy (81 and 9 mesh nodes,
4 chunks), hidden 64, 2 processor layers, at batch 2 with
`_FLAT_MIN_VIRT` at 100 on both sides: the mixed route (K1-K4 for the
grid side, K3 on the m2m[0] and down[0] chunks and in the read-out, P1
with messages on the m2m[1] and up[0] chunks, P3 for the mesh-init
round), which runs both kinds of chunk (the batched route at batch 1
runs P1 with messages on all four, as the fp32 tests hold it).

The JAX runs are compiled with XLA's excess precision off (`strict`,
test_torch_port_bf16_train_models.py: every bf16 rounding the program
specifies is made, as in an eager run), and the rounds' inputs and
outputs are recorded by callbacks as the compiled step runs; the eager
runs of that module's `run_case` take four times as long here. Besides
the predict step, the rollout and the interaction-net rounds of the
module doc, one processor layer on the inputs the JAX bf16 step gives
its processor: each level's receiver sums, each chunk's new edge state
and each level's new state against the JAX layer's, in its dtype (P1's
fp32 messages leave a batched chunk's edge state and its level's sums in
fp32 from the first layer on; a flat chunk's stay bf16), within 4 bf16
ulps of the output's largest magnitude, and, where bf16, fewer than 1%
not bit-equal (the rounds' limits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import neural_lam_tpu.models.hi_lam_parallel as jhlp
from neural_lam_tpu_torch.ops import message_passing as tmp

import neural_lam_tpu.models.base_graph_model as jbg
import neural_lam_tpu.models.base_hi_graph_model as jbh
from neural_lam_tpu.ops import message_passing as jmp

from .test_torch_port_hilam_parallel import one_torch_thread  # noqa: F401
from .test_torch_port_bf16_models import (
    BF,
    ROUND_ULPS,
    T,
    _t,
    build_models,
    check_output,
    check_rounds,
    jax_reference,
    port_rounds,
)
from .test_torch_port_bf16_train_models import strict

# case -> (batch, _FLAT_MIN_VIRT on both sides, rounds recorded: the
# mesh-init and read-out rounds at 2 levels)
CASES = {"hi_lam_parallel-mixed": (2, 100, 2)}


@pytest.fixture(scope="module")
def hlp(tmp_path_factory):
    return build_models(tmp_path_factory, "hi_lam_parallel", 30)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def run_case(jm, params, tm, B, min_virt):
    """test_torch_port_bf16_models.run_case's outputs from compiled JAX
    runs (module doc), and the inputs the JAX bf16 step gives its
    processor (`"processor_inputs"`)."""
    rng = np.random.default_rng(B)
    ref = tm[None]
    n, d = ref.num_grid_nodes, ref.num_state_vars
    init = rng.standard_normal((B, 2, n, d)).astype(np.float32)
    forcing = rng.standard_normal(
        (B, T, n, ref.num_forcing_vars * 3)).astype(np.float32)
    true = rng.standard_normal((B, T, n, d)).astype(np.float32)
    args = (params,) + tuple(jnp.asarray(a) for a in (init, forcing, true))
    out = {}

    def jax_run(cd):
        def run(params, init, forcing, true):
            step, _ = jm[cd].predict_step(params, init[:, 1], init[:, 0],
                                          forcing[:, 0])
            roll, _ = jm[cd].unroll_prediction(params, init, forcing, true)
            return step, roll

        return tuple(np.asarray(x, np.float32)
                     for x in strict(run, *args)(*args))

    with jax_reference("off", None):
        out["jax", None] = jax_run(None)
    meta, vals, proc = [], {}, []
    real = jmp.apply_interaction_net
    real_step = jhlp.HiLAMParallel.hi_processor_step

    def record(p, edges, send_rep, rec_rep, edge_rep=None, **kw):
        res = real(p, edges, send_rep, rec_rep, edge_rep, **kw)
        i = len(meta)
        meta.append((edges, {k: kw[k] for k in ("update_edges", "aggr")
                             if k in kw}))
        jax.debug.callback(lambda *a, i=i: vals.__setitem__(i, a), p,
                           send_rep, rec_rep, edge_rep, kw.get("ew"), res)
        return res

    def record_step(self, p, *a):
        jax.debug.callback(lambda x: proc.append(x), a)
        return real_step(self, p, *a)

    with jax_reference("interpret", min_virt) as mp:
        for mod in (jmp, jbh, jbg):
            mp.setattr(mod, "apply_interaction_net", record)
        mp.setattr(jhlp.HiLAMParallel, "hi_processor_step", record_step)
        step = strict(jm["bfloat16"].predict_step, params, *(
            jnp.asarray(a) for a in (init[:, 1], init[:, 0], forcing[:, 0])))
        jax.block_until_ready(step(params, *(
            jnp.asarray(a) for a in (init[:, 1], init[:, 0], forcing[:, 0]))))
        jax.effects_barrier()
        for mod in (jmp, jbh, jbg):
            mp.setattr(mod, "apply_interaction_net", real)
        mp.setattr(jhlp.HiLAMParallel, "hi_processor_step", real_step)
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
        rounds = []
        for i, (edges, kw) in enumerate(meta):
            p, send, rec, edge_rep, ew, res = _jnp(vals[i])
            rounds.append((p, edges, send, rec, edge_rep, dict(kw, ew=ew),
                           res))
        out["rounds"] = port_rounds(rounds, jm["bfloat16"].graph,
                                    tm["bfloat16"].graph)
    assert len(proc) == 1
    out["processor_inputs"] = _jnp(proc[0])
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, hlp):
    B, min_virt, _ = CASES[request.param]
    jm, params, tm = hlp
    return request.param, run_case(jm, params, tm, B, min_virt)


def test_bf16_rounds_match_jax_on_its_inputs(case):
    """Each interaction-net round of the JAX bf16 predict step, on its
    own inputs, against the port's."""
    assert len(case[1]["rounds"]) == CASES[case[0]][2]
    check_rounds(case[1])


def test_bf16_predict_step_matches_jax(case):
    """One bf16 predict step: the port's bf16 error has JAX's size, and
    it is bf16."""
    check_output(case[1], 0, f"{case[0]} predict step")


def test_bf16_rollout_matches_jax(case):
    """A 3-step bf16 rollout with boundary overwrite, as the step."""
    check_output(case[1], 1, f"{case[0]} 3-step rollout")


def _close(j, t, what):
    """A layer output against JAX's: same dtype and shape, within
    ROUND_ULPS bf16 ulps of JAX's largest magnitude; a bf16 one with
    fewer than 1% not bit-equal."""
    assert (t.dtype == BF) == (j.dtype == jnp.bfloat16), (what, t.dtype,
                                                         j.dtype)
    j = np.asarray(j.astype(jnp.float32))
    t16, t = t.dtype == BF, t.float().numpy()
    assert j.shape == t.shape, (what, j.shape, t.shape)
    scale = 2.0 ** (np.floor(np.log2(np.abs(j).max())) - 7)
    worst = float(np.abs(j - t).max() / scale)
    share = float(np.mean(j != t))
    msg = (f"{what}: {share:.4%} of {j.size} not bit-equal, worst "
           f"{worst:.2f} ulps of its largest magnitude")
    assert worst <= ROUND_ULPS and (share < 0.01 or not t16), msg


def test_bf16_processor_layer_matches_jax_on_its_inputs(hlp, case):
    """One bf16 processor layer on the mixed route (K3 and P1-with-
    messages chunks side by side), on the inputs JAX's bf16 predict step
    gives its processor (module doc)."""
    jm, params, tm = hlp
    jmodel, tmodel = jm["bfloat16"], tm["bfloat16"]
    B, min_virt, _ = CASES[case[0]]
    inputs = case[1]["processor_inputs"]
    aggs = []
    real_concat = jhlp.apply_mlp_concat

    def record_concat(p, parts, **kw):
        jax.debug.callback(lambda a: aggs.append(a), parts[1], ordered=True)
        return real_concat(p, parts, **kw)

    def layer(p, a):
        return jmodel.hi_processor_step({"processor": p["processor"][:1]},
                                        *a)

    with jax_reference("interpret", min_virt) as mp:
        mp.setattr(jhlp, "apply_mlp_concat", record_concat)
        j_levels, *j_edges = strict(layer, params, inputs)(params, inputs)
        jax.effects_barrier()
        j_edges = [e for part in j_edges for e in part]
        flat = [tmp.flat_eligible(es, B, 64)
                for es in tmodel._chunk_edge_sets()]
        assert flat == [True, False, False, True]
        levels, same, up, down = inputs
        lv = [_t(x) for x in levels]
        edges = [_t(e) for e in list(same) + list(up) + list(down)]
        with torch.no_grad():
            t_aggs, _ = tmodel.aggregate_chunks(tmodel.processor[0], lv,
                                                edges)
            t_levels, t_edges = tmodel.processor_layer(tmodel.processor[0],
                                                       lv, edges)
    # level 0 sums two flat chunks (bf16, gather-free folds), level 1 two
    # P1 chunks (fp32); the batched chunks' edge states turn fp32
    assert [a.dtype for a in t_aggs] == [BF, torch.float32]
    assert [e.dtype for e in t_edges] == [BF, torch.float32, torch.float32,
                                          BF]
    for what, js, ts in (("receiver sums", aggs, t_aggs),
                         ("edge state", j_edges, t_edges),
                         ("level state", j_levels, t_levels)):
        assert len(js) == len(ts), what
        for i, (j, t) in enumerate(zip(js, ts)):
            _close(jnp.asarray(j), t, f"{what} {i}")
