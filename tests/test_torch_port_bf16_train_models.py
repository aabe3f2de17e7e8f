"""The port's bf16 training path (compute_dtype="bfloat16") against the
JAX package's, GraphLAM on the CPU.

The reference is the JAX package with its Pallas kernels in interpret
mode and the accelerator's casts emulated, as in
test_torch_port_bf16_models.py (`jax_reference`), with its batched-route
VJPs' cotangents widened to fp32 (`batched_reference`, see
test_torch_port_bf16_train.py: this JAX version refuses them unwidened),
compiled with XLA's `xla_allow_excess_precision` off (`strict`): by
default XLA's CPU compiler may skip a bf16 rounding inside a fusion, so
the reference's bf16 error came out smaller than its program's (the
port's gradient error was 1.04-1.13x JAX's on six seeded batches on the
flat route, 0.97-1.05x against the strict reference).
GraphLAM 16x16, hidden 64, 2 processor layers, weights from
`convert.params_from_jax`, on the flat route (`_FLAT_MIN_VIRT` = 1 on
both sides, batch 2: K1-K4 and B1-B6) and the batched route (batch 1: P2,
P3 and their recompute); HiLAM's cases are in
test_torch_port_bf16_train_hilam.py. Gradients of `training_loss`
(ar_steps 1) on four seeded batches, and a 5-step AdamW trajectory:

* Each interaction-net round of the JAX bf16 gradient (the first batch),
  its inputs and the
  cotangents of its outputs recorded in JAX's own backward pass, against
  the port's round's VJP on the same values: every gradient (of the
  round's bf16 inputs and its fp32 parameters) within 4 bf16 ulps of its
  largest magnitude, and of the bf16 ones fewer than 1% not bit-equal,
  the forward rounds' limits. This pins the rounding sites of each
  round's backward. The exception: the sender-table gradient, which sums
  the round's per-slot bf16 gradients onto the table (the flat route's
  scatter-free fold, in fp32; the batched route's gather backward, slot
  after slot in bf16): each of the 16x16 graph's 9 mesh nodes is the
  sender of ~8 m2m slots and ~110 m2g slots, so the share of slot
  gradients that round the other way (under 1%) reaches several % of the
  table's elements, and on the batched route every later partial sum of
  the sender; it is held to the magnitude limit alone.
* The whole `training_loss` gradient, by size (bf16 makes it chaotic, as
  the forward: one last-bit difference flips a rounding, and the flip
  spreads): each parameter's gradient over its fp32 max abs, all of them
  and all four batches together; the port's bf16 error against the JAX
  fp32 gradient has the size of JAX's own (mean abs within 0.9-1.1x, max
  abs within 0.5-1.5x), and the port's bf16-vs-fp32 gap is at least half
  of JAX's. One batch alone is too noisy for these limits: on eight
  seeded batches of the batched route the mean ratio of a single batch
  ran 0.94-1.16 (their mean 1.03), the max ratio 0.90-1.53.
* 5 AdamW steps of the port's Trainer (flat route) against
  optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.01) on the same
  batches: the port's bf16 parameters deviate from JAX's fp32 trajectory
  by the size of JAX's bf16 deviation (each parameter over its fp32
  update's max abs; mean within 0.9-1.1x, max within 0.5-1.5x), and from
  the port's own fp32 trajectory by at least half of that.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import neural_lam_tpu.models.base_graph_model as jbg
import neural_lam_tpu.models.base_hi_graph_model as jbh
import neural_lam_tpu.models.graph_lam as jgl
import neural_lam_tpu.models.hi_lam as jhl
from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.train import Trainer, TrainFlags
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops.message_passing import init_interaction_net

from .test_torch_port_bf16_models import _t, build_models, jax_reference
from .test_torch_port_bf16_train import batched_reference

BF = torch.bfloat16
MEAN_RATIO = (0.9, 1.1)
MAX_RATIO = (0.5, 1.5)
ROUND_ULPS = 4
# case -> (model, grid side, batch, _FLAT_MIN_VIRT on both sides or None)
CASES = {
    "graph_lam-flat": ("graph_lam", 16, 2, 1),
    "graph_lam-batched": ("graph_lam", 16, 1, None),
}


def make_batch(tm, B, seed):
    """(init, target, forcing, times) of one ar_steps=1 batch, seeded."""
    rng = np.random.default_rng(seed)
    n, d = tm.num_grid_nodes, tm.num_state_vars
    return (rng.standard_normal((B, 2, n, d)).astype(np.float32),
            rng.standard_normal((B, 1, n, d)).astype(np.float32),
            rng.standard_normal((B, 1, n, tm.num_forcing_vars * 3))
            .astype(np.float32),
            np.zeros((B, 1), np.float32))


def strict(fn, *args):
    """fn compiled for args with XLA's excess precision off: every bf16
    rounding the JAX program specifies is made (module doc)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _tap(x, key):
    """x, whose cotangent is appended to _TAPPED as (key, value)."""
    return x


def _tap_fwd(x, key):
    return x, None


def _tap_bwd(key, _, g):
    jax.debug.callback(lambda v: _TAPPED.append((key, np.array(v))), g,
                       ordered=True)
    return (g,)


_tap.defvjp(_tap_fwd, _tap_bwd)
_TAPPED = []


def recorded_rounds(jm, params, batches, mp):
    """(JAX bf16 gradients of `batches`, [(p, edges, inputs, kw,
    cotangents)] of each interaction-net round of the first): the
    gradient compiled once (`strict`) with every round's inputs recorded
    as the forward runs and its outputs' cotangents as the backward
    reaches them (`_tap`)."""
    real = jmp.apply_interaction_net
    seen, ins = [], []

    def record(p, edges, send_rep, rec_rep, edge_rep=None, **kw):
        i = len(seen)
        # the round's static arguments; `consts` (kernel constants derived
        # from p inside the trace) is left to the round to derive again
        seen.append((edges, {k: v for k, v in kw.items()
                             if k not in ("ew", "consts")}))
        jax.debug.callback(
            lambda p, s, r, e, ew: ins.append(
                (jax.tree.map(np.array, p), np.array(s), np.array(r),
                 None if e is None else np.array(e),
                 None if ew is None else np.array(ew))),
            p, send_rep, rec_rep, edge_rep, kw.get("ew"), ordered=True)
        res = real(p, edges, send_rep, rec_rep, edge_rep, **kw)
        outs = res if isinstance(res, tuple) else (res,)
        outs = tuple(_tap(o, 2 * i + j) for j, o in enumerate(outs))
        return outs if isinstance(res, tuple) else outs[0]

    for mod in (jmp, jgl, jhl, jbh, jbg):
        mp.setattr(mod, "apply_interaction_net", record)
    _TAPPED.clear()
    jbs = [tuple(jnp.asarray(b) for b in batch) for batch in batches]
    grad = strict(jax.grad(jm.training_loss), params, jbs[0])
    grads = [jax.block_until_ready(grad(params, jbs[0]))]
    for mod in (jmp, jgl, jhl, jbh, jbg):
        mp.setattr(mod, "apply_interaction_net", real)
    cts = dict(_TAPPED)
    rounds = [(ins[i][0], edges, ins[i][1:], kw,
               [cts.get(2 * i + j) for j in range(2)])
              for i, (edges, kw) in enumerate(seen)]
    # the other batches through the same executable (its callbacks record
    # again; nothing reads them)
    grads += [grad(params, jb) for jb in jbs[1:]]
    return grads, rounds


def round_vjps(rounds, jgraph, tgraph):
    """[(what, name, JAX gradient, port gradient)] of each recorded round:
    jax.vjp of the JAX round and torch autograd through the port's, on the
    recorded inputs, with the recorded cotangents."""
    sets = {}
    for name in ("g2m", "m2g", "m2m", "up", "down"):
        j, t = getattr(jgraph, name), getattr(tgraph, name)
        if isinstance(j, (list, tuple)):
            sets.update({id(a): (f"{name}[{i}]", b)
                         for i, (a, b) in enumerate(zip(j, t))})
        elif j is not None:
            sets[id(j)] = (name, t)
    out = []
    compiled = {}  # (edge set, inputs, kwargs) -> the strict VJP
    for p, edges, (send, rec, edge_rep, ew), kw, cts in rounds:
        what, t_edges = sets[id(edges)]
        kw = dict(kw)
        kw.pop("ew", None)
        names = ["send", "rec"] + (["edge"] if edge_rep is not None else [])
        names += ["ew"] if ew is not None else []
        vals = [x for x in (send, rec, edge_rep, ew) if x is not None]
        j_in = [jnp.asarray(v) for v in vals]
        n_out = 2 if kw.get("update_edges", True) else 1
        shapes = jax.eval_shape(
            lambda p, *a: _jround(p, edges, names, kw, *a), p, *j_in)
        j_ct = tuple(jnp.asarray(c) if c is not None else
                     jnp.zeros(o.shape, o.dtype)
                     for c, o in zip(cts[:n_out], shapes if n_out == 2
                                     else (shapes,)))

        def vjp_of(p, ct, *a, edges=edges, names=names, kw=kw):
            _, vjp = jax.vjp(lambda p, *a: _jround(p, edges, names, kw, *a),
                             p, *a)
            return vjp(ct)

        ct = j_ct if n_out == 2 else j_ct[0]
        key = (id(edges), tuple(names), repr(sorted(kw.items())))
        if key not in compiled:
            compiled[key] = strict(vjp_of, p, ct, *j_in)
        g_p, *g_in = compiled[key](p, ct, *j_in)
        inet = init_interaction_net(64)
        inet.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p)))
        t_in = [_t(jnp.asarray(v)).requires_grad_() for v in vals]
        targs = dict(zip(names, t_in))
        o = tmp.apply_interaction_net(
            inet, t_edges, targs["send"], targs["rec"], targs.get("edge"),
            ew=targs.get("ew"), update_edges=kw.get("update_edges", True),
            aggr=kw.get("aggr", "sum"), compute_dtype=BF)
        o = o if isinstance(o, tuple) else (o,)
        torch.autograd.backward(list(o), [_t(c) for c in j_ct])
        want_p = params_from_jax(jax.tree.map(np.asarray, g_p))
        for name, g, t in zip(names, g_in, t_in):
            out.append((what, name, g, t.grad, name == "send"))
        for k, prm in inet.named_parameters():
            out.append((what, k, want_p[k], prm.grad, False))
    return out


def _jround(p, edges, names, kw, *args):
    a = dict(zip(names, args))
    return jmp.apply_interaction_net(p, edges, a["send"], a["rec"],
                                     a.get("edge"), ew=a.get("ew"), **kw)


def check_round_grads(got):
    """Every recorded round's gradients: within ROUND_ULPS bf16 ulps of the
    tensor's largest magnitude, the bf16 ones fewer than 1% not
    bit-equal, but the sender table's (module doc)."""
    assert got, "no interaction-net round was recorded"
    for what, name, want, g, summed in got:
        w = np.asarray(jnp.asarray(want).astype(jnp.float32))
        if g is None:  # unused by the round (b0 inside a static ew)
            assert not w.any(), (what, name)
            continue
        t = g.float().numpy()
        assert w.shape == t.shape, (what, name, w.shape, t.shape)
        scale = 2.0 ** (np.floor(np.log2(max(np.abs(w).max(), 1e-30))) - 7)
        worst = float(np.abs(w - t).max() / scale)
        msg = f"{what} d_{name}: worst {worst:.2f} ulps of its largest value"
        if g.dtype == BF:
            assert jnp.asarray(want).dtype == jnp.bfloat16, (what, name)
            share = float(np.mean(w != t))
            msg += f", {share:.4%} of {w.size} not bit-equal"
            assert summed or share < 0.01, msg
        assert worst <= ROUND_ULPS, msg


def normalized(grads, scale):
    """Each parameter's gradient over its scale, all concatenated."""
    return np.concatenate([np.asarray(grads[k]).ravel() / scale[k]
                           for k in sorted(scale)])


def check_size(t16, j16, j32, t32, what):
    """The port's bf16 error against JAX's fp32 values has the size of
    JAX's bf16 error (mean abs within MEAN_RATIO, max abs within
    MAX_RATIO), and the port's bf16-vs-fp32 gap is at least half of
    JAX's."""
    err_j, err_t = np.abs(j16 - j32), np.abs(t16 - j32)
    mean_ratio = err_t.mean() / err_j.mean()
    max_ratio = err_t.max() / err_j.max()
    own = np.abs(t16 - t32).max()
    msg = (f"{what}: bf16 error vs JAX fp32, port / JAX: mean "
           f"{err_t.mean():.3e} / {err_j.mean():.3e} = {mean_ratio:.3f}, "
           f"max {err_t.max():.3e} / {err_j.max():.3e} = {max_ratio:.3f}; "
           f"port bf16-vs-fp32 {own:.3e}")
    assert MEAN_RATIO[0] <= mean_ratio <= MEAN_RATIO[1], msg
    assert MAX_RATIO[0] <= max_ratio <= MAX_RATIO[1], msg
    assert own >= 0.5 * err_j.max(), msg


def port_grads(tm, batch):
    tm.zero_grad(set_to_none=True)
    tm.training_loss(tuple(torch.as_tensor(b) for b in batch)).backward()
    return {k: p.grad.detach().numpy().copy()
            for k, p in tm.named_parameters()}


N_BATCHES = 4


def run_case(jm, params, tm, B, min_virt):
    """Everything the gradient tests of a case read: for each of
    N_BATCHES seeded batches the JAX fp32 (Pallas off) and bf16
    (reference) gradients and the port's in both dtypes; the rounds' VJPs
    of the first."""
    batches = [make_batch(tm[None], B, seed=1 + i) for i in range(N_BATCHES)]
    jbs = [tuple(jnp.asarray(b) for b in batch) for batch in batches]
    out = {k: [] for k in (("jax", None), ("jax", "bfloat16"),
                           ("port", None), ("port", "bfloat16"))}

    def grads_of(g):
        return {n: v.numpy() for n, v in params_from_jax(
            jax.tree.map(np.asarray, g)).items()}

    with jax_reference("off", None):
        g32 = strict(jax.grad(jm[None].training_loss), params, jbs[0])
        out["jax", None] = [grads_of(g32(params, jb)) for jb in jbs]
    with jax_reference("interpret", min_virt) as mp, batched_reference(mp):
        g16, rounds = recorded_rounds(jm["bfloat16"], params, batches, mp)
        out["rounds"] = round_vjps(rounds, jm["bfloat16"].graph,
                                   tm["bfloat16"].graph)
        out["jax", "bfloat16"] = [grads_of(g) for g in g16]
        for batch in batches:
            for cd in (None, "bfloat16"):
                out["port", cd].append(port_grads(tm[cd], batch))
    return out


@pytest.fixture(scope="module")
def graph_lam(tmp_path_factory):
    return build_models(tmp_path_factory, "graph_lam", 16)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, graph_lam):
    kind, nx, B, min_virt = CASES[request.param]
    jm, params, tm = graph_lam
    return request.param, run_case(jm, params, tm, B, min_virt)


def test_bf16_training_rounds_match_jax(case):
    """Each interaction-net round's VJP on JAX's recorded inputs and
    cotangents (module doc)."""
    check_round_grads(case[1]["rounds"])


def test_bf16_training_gradient_matches_jax(case):
    """The whole training_loss gradient of a bf16 GraphLAM: its bf16
    error has JAX's size, and it is bf16 (module doc)."""
    what, out = case
    vecs = {k: [] for k in (("port", "bfloat16"), ("jax", "bfloat16"),
                            ("jax", None), ("port", None))}
    for i, j32 in enumerate(out["jax", None]):
        scale = {k: float(np.abs(v).max()) or 1.0 for k, v in j32.items()}
        assert set(out["port", "bfloat16"][i]) == set(scale)
        for k in vecs:
            vecs[k].append(normalized(out[k][i], scale))
    check_size(*(np.concatenate(v) for v in vecs.values()),
               f"{what} training_loss gradient, {N_BATCHES} batches")


def test_bf16_adamw_trajectory_matches_optax(graph_lam):
    """5 AdamW steps on the flat route, bf16 against fp32, the port's
    Trainer against optax (module doc)."""
    jm, params, tm = graph_lam
    batches = [make_batch(tm[None], 2, seed=10 + i) for i in range(5)]
    optimizer = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.01)
    final = {}
    for cd, mode in ((None, "off"), ("bfloat16", "interpret")):
        model = jm[cd]

        def step(p, s, batch, model=model):
            grads = jax.grad(model.training_loss)(p, batch)
            updates, s = optimizer.update(grads, s, p)
            return optax.apply_updates(p, updates), s

        with jax_reference(mode, 1) as mp, batched_reference(mp):
            p, s = params, optimizer.init(params)
            jb = [tuple(jnp.asarray(x) for x in b) for b in batches]
            step = strict(step, p, s, jb[0])
            for b in jb:
                p, s = step(p, s, b)
        final["jax", cd] = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, p)).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmp, "_FLAT_MIN_VIRT", 1)
        for cd in (None, "bfloat16"):
            model = tm[cd]
            state = {k: v.clone() for k, v in model.state_dict().items()}
            trainer = Trainer(model, TrainFlags(seed=0))
            for b in batches:
                trainer.train_step(tuple(torch.as_tensor(x) for x in b))
            final["port", cd] = {k: v.detach().numpy().copy()
                                 for k, v in model.state_dict().items()}
            model.load_state_dict(state)
    p0 = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    scale = {k: float(np.abs(final["jax", None][k] - p0[k]).max()) or 1.0
             for k in p0}
    check_size(*(normalized(final[k], scale) for k in (
        ("port", "bfloat16"), ("jax", "bfloat16"), ("jax", None),
        ("port", None))), "5-step AdamW trajectory, flat route")
