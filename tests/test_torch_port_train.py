"""The port's training slice against the JAX package, on the CPU.

Kernel level: each differentiable kernel wrapper of the port (an
autograd.Function whose CPU backward is its `*_bwd_plain`) against
`jax.grad` through the JAX package's kernel in interpret mode (its Pallas
backward kernel), with the sender gather of the JAX side done by
`gather_send_flat` (its scatter-free transposed-layout backward) and a
zero `delta` added to the gathered rows, so that one gradient gives both
the per-slot cotangent (B2, B3, B5) and the folded table gradient (B4,
B6). Tolerance for every kernel-level gradient: max abs diff <= 1e-4 +
1e-4 * max abs of the JAX gradient -- fp32 sums over up to ~2k slots run
in another order on each side, and the JAX kernels fold LayerNorm
centring into the weights.

Model level: `training_loss` gradients of the port's GraphLAM against
`jax.grad` of the JAX model's (CPU route), and a 20-step AdamW loss
trajectory against optax, on the port's flat route (its `_FLAT_MIN_VIRT`
lowered to 1: at 16x16 every set would take the batched route) and, for
the gradients, on the batched route too. Plus the host modules of the
slice: metrics, LR schedules, the dataset, checkpoints and the training
CLI for GraphLAM and HiLAM.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from neural_lam_tpu import metrics as jmetrics
from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
)
from neural_lam_tpu.dataset import (
    WeatherDataLoader as JWeatherDataLoader,
    WeatherDataset as JWeatherDataset,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu.ops import pallas_edge_flat as pef
from neural_lam_tpu.ops import pallas_embed as pe
from neural_lam_tpu.ops import pallas_grid_update as pgu
from neural_lam_tpu.ops.message_passing import EdgeSet as JEdgeSet
from neural_lam_tpu_torch import metrics
from neural_lam_tpu_torch.checkpoint import load_checkpoint
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.dataset import WeatherDataLoader, WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.entry import build_model, make_trainer, train_steps
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.models.graph_lam import GraphLAM
from neural_lam_tpu_torch.ops import edge_flat, embed, grid_update
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops.message_passing import EdgeSet
from neural_lam_tpu_torch.train import lr_at

H = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _local_graph(n_send, n_rec, deg, rng, spread=3):
    """Receiver r takes `deg` senders near r * n_send / n_rec."""
    centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
    off = rng.integers(-spread, spread + 1, (n_rec, deg))
    senders = np.clip(centre + off, 0, n_send - 1).reshape(-1)
    receivers = np.repeat(np.arange(n_rec), deg)
    feats = rng.standard_normal((n_rec * deg, 3)).astype(np.float32)
    return senders, receivers, feats


def _edge_sets(senders, receivers, feats, n_send, n_rec, **kw):
    j = JEdgeSet.from_local(senders, receivers, feats, n_send, n_rec,
                            dense=True, **kw)
    t = EdgeSet.from_local(senders, receivers, feats, n_send, n_rec,
                           device="cpu", **kw)
    return j, t


def _assert_grad_close(got, want, name):
    """max |got - want| <= 1e-4 + 1e-4 * max |want| (see module doc)."""
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-4 + 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max abs diff {err:.3e} > {tol:.3e}"


def _leaves(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _capturing_fold(edges, captured):
    """The edge set's fold, keeping the per-slot cotangent it receives."""
    def fold(d_slots):
        captured.append(d_slots)
        return edges.fold_senders(d_slots)

    return fold


@pytest.fixture(scope="module")
def edge_case():
    """A local graph in both packages' dense layouts (K=8, padding slots
    and padding virtual rows included) and random inputs, B=2."""
    rng = np.random.default_rng(11)
    n_send, n_rec, B = 150, 120, 2
    j, t = _edge_sets(*_local_graph(n_send, n_rec, 9, rng), n_send, n_rec)
    K, n_virt = t.dense_k, t.num_virt
    M, W = n_virt * K, B * H
    x = dict(
        table=_rand(rng, n_send, W), ew=_rand(rng, M, H),
        rec=_rand(rng, n_virt, W), edge=_rand(rng, M, W),
        w_e=_rand(rng, H, H, scale=0.2), b0=_rand(rng, H, scale=0.2),
        w2=_rand(rng, H, H, scale=0.2), b2=_rand(rng, H, scale=0.2),
        ls=1 + _rand(rng, H, scale=0.1), lb=_rand(rng, H, scale=0.1),
        ct_v=_rand(rng, n_virt, W, scale=1.0),
        ct_e=_rand(rng, M, W, scale=1.0),
    )
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    return j, t, x, mask_p


def test_sender_fold_layout_matches_jax(edge_case):
    """The port's transposed layout (sender fold) is the JAX package's
    `EdgeSet.transposed`, slot for slot: real slots only, same cap."""
    j, t, _, _ = edge_case
    jt, tt = j.transposed, t.transposed
    assert (tt.dense_k, tt.num_virt, tt.virt_identity, tt.num_rec) == (
        jt.dense_k, jt.num_virt, jt.virt_identity, jt.num_rec)
    for name in ("senders", "receivers", "mask", "virt_to_rec"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    if jt.rec_slots is not None:
        np.testing.assert_array_equal(tt.rec_slots.numpy(),
                                      np.asarray(jt.rec_slots))


def test_sender_fold_sums_real_slots_only(edge_case):
    """fold_senders == index_add of the real slots' rows onto their
    senders; values at padding slots have no effect; two runs agree bit
    for bit."""
    _, t, _, _ = edge_case
    rng = np.random.default_rng(3)
    d = torch.as_tensor(_rand(rng, t.senders.shape[0], 2 * H))
    real = t.mask[:, 0] > 0
    want = torch.zeros(t.num_send, d.shape[1]).index_add_(
        0, t.senders[real].long(), d[real])
    got = t.fold_senders(d)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    d_pad = d.clone()
    d_pad[~real] = 1e6
    assert torch.equal(t.fold_senders(d_pad), got)
    assert torch.equal(t.fold_senders(d), got)


def test_embed_bwd_matches_jax():
    """B1: gradients of embed_grid_flat (every input and parameter)
    against jax.grad through the interpret-mode Pallas embedder."""
    rng = np.random.default_rng(4)
    B, N, d_in, d_pad = 2, 256, 23, 64
    x = _rand(rng, N, B, d_in, scale=1.0)
    par = [_rand(rng, d_in, H), _rand(rng, H), _rand(rng, H, H), _rand(rng, H),
           1 + _rand(rng, H, scale=0.1), _rand(rng, H, scale=0.1)]
    ct = _rand(rng, N, B * H, scale=1.0)
    x_pad = np.pad(x, ((0, 0), (0, 0), (0, d_pad - d_in))).reshape(N, -1)

    def loss_j(x_pad, w0, b0, w1, b1, ls, lb):
        params = {"layers": [{"w": w0, "b": b0}, {"w": w1, "b": b1}],
                  "ln": {"scale": ls, "bias": lb}}
        out = pe.embed_grid_flat(x_pad, params, B, d_pad, interpret=True)
        return (out * ct).sum()

    g_j = jax.grad(loss_j, argnums=tuple(range(7)))(
        jnp.asarray(x_pad), *map(jnp.asarray, par))
    leaves = _leaves(x.reshape(N, -1), *par)
    out = embed.embed_grid_flat(*leaves, B)
    (out * torch.as_tensor(ct)).sum().backward()
    d_x_j = np.asarray(g_j[0]).reshape(N, B, d_pad)[..., :d_in]
    _assert_grad_close(leaves[0].grad, d_x_j.reshape(N, -1), "d_x")
    for name, leaf, want in zip(("w0", "b0", "w1", "b1", "ls", "lb"),
                                leaves[1:], g_j[1:]):
        _assert_grad_close(leaf.grad, want, name)


def test_edge_tail_sum_bwd_matches_jax(edge_case):
    """B2 (and the fold of its table gradient): per-slot d_x0, d_table,
    d_ew, d_rec_rows and the tail parameters against jax.grad of
    gather_send_flat + the interpret-mode JAX tail kernel."""
    j, t, x, mask_p = edge_case
    K = t.dense_k
    names = ("table", "ew", "rec", "w2", "b2", "ls", "lb")

    def loss_j(delta, table, ew, rec, w2, b2, ls, lb):
        g = jmp.gather_send_flat(table, j) + delta
        _, virt = pef.edge_tail_sum_flat(g, ew, rec, w2, b2, ls, lb, mask_p,
                                         K, interpret=True)
        return (virt * x["ct_v"]).sum()

    g_j = jax.grad(loss_j, argnums=tuple(range(8)))(
        jnp.zeros_like(x["edge"]), *(jnp.asarray(x[n]) for n in names))
    leaves = _leaves(*(x[n] for n in names))
    slots = []
    virt = edge_flat.edge_tail_sum_flat(
        leaves[0], t.senders, leaves[1], leaves[2], t.mask.view(-1, K),
        *leaves[3:], fold=_capturing_fold(t, slots))
    (virt * torch.as_tensor(x["ct_v"])).sum().backward()
    _assert_grad_close(slots[0], g_j[0], "d_x0 per slot")
    for name, leaf, want in zip(names, leaves, g_j[1:]):
        _assert_grad_close(leaf.grad, want, name)


@pytest.mark.parametrize("edge_grad", [True, False],
                         ids=["d_edge_out", "no_d_edge_out"])
def test_edge_layer_bwd_matches_jax(edge_case, edge_grad):
    """B3/B4: per-slot d_x0 (B3), d_table through the fold (B4), d_edge,
    d_rec_rows and the layer parameters. Without a cotangent on edge_out
    (the last processor layer) the Function gets None for it."""
    j, t, x, mask_p = edge_case
    K = t.dense_k
    names = ("edge", "table", "rec", "w_e", "b0", "w2", "b2", "ls", "lb")

    def loss_j(delta, edge, table, rec, w_e, b0, w2, b2, ls, lb):
        g = jmp.gather_send_flat(table, j) + delta
        eo, virt = pef.edge_layer_flat(edge, g, rec, mask_p, w_e, b0, w2,
                                       b2, ls, lb, K, interpret=True)
        loss = (virt * x["ct_v"]).sum()
        return loss + (eo * x["ct_e"]).sum() if edge_grad else loss

    g_j = jax.grad(loss_j, argnums=tuple(range(10)))(
        jnp.zeros_like(x["edge"]), *(jnp.asarray(x[n]) for n in names))
    leaves = _leaves(*(x[n] for n in names))
    slots = []
    eo, virt = edge_flat.edge_layer_flat(
        leaves[0], leaves[1], t.senders, leaves[2], t.mask.view(-1, K),
        *leaves[3:], fold=_capturing_fold(t, slots))
    loss = (virt * torch.as_tensor(x["ct_v"])).sum()
    if edge_grad:
        loss = loss + (eo * torch.as_tensor(x["ct_e"])).sum()
    loss.backward()
    _assert_grad_close(slots[0], g_j[0], "d_x0 per slot")
    for name, leaf, want in zip(names, leaves, g_j[1:]):
        _assert_grad_close(leaf.grad, want, name)


def _decoder_params(rng, d_out):
    def mk(*shape):
        return _rand(rng, *shape, scale=0.1)

    return {
        "w_i": mk(H, H), "w2": mk(H, H), "b2": mk(H),
        "e_ls": 1.0 + mk(H), "e_lb": mk(H),
        "enc_w0": mk(H, H), "enc_b0": mk(H), "enc_w1": mk(H, H),
        "enc_b1": mk(H), "enc_ls": 1.0 + mk(H), "enc_lb": mk(H),
        "a_w0": mk(2 * H, H), "a_b0": mk(H), "a_w1": mk(H, H),
        "a_b1": mk(H), "a_ls": 1.0 + mk(H), "a_lb": mk(H),
        "o_w0": mk(H, H), "o_b0": mk(H), "o_w1": mk(H, d_out),
        "o_b1": mk(d_out),
    }


def test_grid_update_bwd_matches_jax():
    """B5/B6: per-slot d_x0 (B5), d_table through the fold (B6), d_ew,
    d_grid_emb_f (real rows only: N_rec < num_virt) and all 21 decoder
    parameters."""
    rng = np.random.default_rng(5)
    B, K, d_out, n_rec, n_send = 2, 4, 9, 300, 60
    j, t = _edge_sets(*_local_graph(n_send, n_rec, K, rng, spread=2),
                      n_send, n_rec, dense_cap=K)
    assert t.virt_identity and t.num_virt > n_rec
    n_virt, M, W = t.num_virt, t.num_virt * K, B * H
    table, ew = _rand(rng, n_send, W), _rand(rng, M, H)
    ge = _rand(rng, n_rec, W)
    pp = _decoder_params(rng, d_out)
    ct = _rand(rng, n_virt, B * d_out, scale=1.0)
    mask_p = np.asarray(j.mask).reshape(n_virt, K)

    def loss_j(delta, table, ew, ge, pp):
        g = jmp.gather_send_flat(table, j) + delta
        out = pgu.grid_update_flat(g, ew, ge, mask_p, pp, K, interpret=True)
        return (out * ct).sum()

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(
        jnp.zeros((M, W), jnp.float32), jnp.asarray(table), jnp.asarray(ew),
        jnp.asarray(ge), {k: jnp.asarray(v) for k, v in pp.items()})
    leaves = _leaves(table, ew, ge)
    pp_t = {k: torch.tensor(v, requires_grad=True) for k, v in pp.items()}
    slots = []
    out = grid_update.grid_update_flat(
        leaves[0], t.senders, leaves[1], leaves[2], t.mask.view(-1, K), pp_t,
        fold=_capturing_fold(t, slots))
    (out * torch.as_tensor(ct)).sum().backward()
    _assert_grad_close(slots[0], g_j[0], "d_x0 per slot")
    for name, leaf, want in zip(("table", "ew", "ge"), leaves, g_j[1:4]):
        _assert_grad_close(leaf.grad, want, name)
    for k, v in pp_t.items():
        _assert_grad_close(v.grad, g_j[4][k], k)


@pytest.mark.parametrize("name", sorted(metrics.DEFINED_METRICS))
def test_metrics_match_jax(name):
    """Each metric, masked and unmasked, with and without the grid mean
    and the variable sum; rtol 1e-5 (fp32 sums in another order)."""
    rng = np.random.default_rng(6)
    B, T, N, d = 2, 3, 50, 4
    pred, target = _rand(rng, B, T, N, d, scale=1.0), _rand(rng, B, T, N, d)
    std = (0.5 + np.abs(_rand(rng, B, T, N, d))).astype(np.float32)
    mask = rng.random(N) > 0.3
    for m, avg, sv in [(None, True, True), (mask, True, True),
                       (mask, True, False), (None, False, True),
                       (mask, False, False)]:
        got = metrics.get_metric(name)(
            torch.as_tensor(pred), torch.as_tensor(target),
            torch.as_tensor(std), None if m is None else torch.as_tensor(m),
            average_grid=avg, sum_vars=sv)
        want = jmetrics.get_metric(name)(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(std),
            None if m is None else jnp.asarray(m), average_grid=avg,
            sum_vars=sv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("schedule", ["constant", "cosine",
                                      "warmup_cosine"])
def test_lr_schedules_match_optax(schedule):
    """lr_at against optax's schedules as the JAX trainer builds them
    (train.py:240-251), across warm-up, decay and past decay_steps.
    atol 1e-9 (1e-6 of the peak rate): optax evaluates in fp32, lr_at in
    fp64."""
    lr, warm, decay = 1e-3, 10, 50
    want = {
        "constant": lambda s: lr,
        "cosine": optax.cosine_decay_schedule(lr, decay),
        "warmup_cosine": optax.warmup_cosine_decay_schedule(0.0, lr, warm,
                                                            decay),
    }[schedule]
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 70):
        np.testing.assert_allclose(lr_at(step, lr, schedule, warm, decay),
                                   float(want(step)), rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def datastores():
    return (DummyDatastore(grid_shape=(12, 10), n_timesteps=30),
            JDummyDatastore(grid_shape=(12, 10), n_timesteps=30))


@pytest.mark.parametrize("split,ar_steps", [("train", 1), ("train", 3),
                                            ("val", 2)])
def test_dataset_items_match_jax(datastores, split, ar_steps):
    """WeatherDataset items equal the JAX dataset's, array for array, and
    a shuffled loader yields the same batches in the same order."""
    tds, jds = datastores
    t = WeatherDataset(tds, split=split, ar_steps=ar_steps)
    j = JWeatherDataset(jds, split=split, ar_steps=ar_steps)
    assert len(t) == len(j)
    for idx in range(len(t)):
        for a, b in zip(t[idx], j[idx]):
            np.testing.assert_array_equal(a, b)
    lt = WeatherDataLoader(t, batch_size=2, shuffle=True, seed=3)
    lj = JWeatherDataLoader(j, batch_size=2, shuffle=True, seed=3,
                            prefetch=0)
    lt.set_epoch(1)
    lj.set_epoch(1)
    n = 0
    for bt, bj in zip(lt, lj):
        n += 1
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)
    assert n == len(lt) == len(lj)


NX = 16


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(jax_model, jax_params, port_model, port datastore) for a 16x16
    DummyDatastore (30 time steps), hidden 64, 2 processor layers."""
    jds = JDummyDatastore(grid_shape=(NX, NX), n_timesteps=30)
    tds = DummyDatastore(grid_shape=(NX, NX), n_timesteps=30)
    jbundle = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                             jds.get_xy("state", stacked=False),
                             n_max_levels=None, hierarchical=False)
    tbundle = create_graph(str(tmp_path_factory.mktemp("tg")),
                           tds.get_xy("state", stacked=False),
                           n_max_levels=None, hierarchical=False)
    jmodel = J_MODELS["graph_lam"](
        JModelArgs(hidden_dim=64, processor_layers=2),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
        jds, j_graph_from_bundle(jbundle))
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = GraphLAM(
        ModelArgs(hidden_dim=64, processor_layers=2),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, graph_from_bundle(tbundle, device="cpu"), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, tds


def _batch(tds, ar_steps, first=0, size=2):
    ds = WeatherDataset(tds, split="train", ar_steps=ar_steps)
    return tuple(np.stack(p) for p in zip(*(ds[first + i]
                                            for i in range(size))))


@pytest.fixture
def flat_route(monkeypatch):
    """Every edge set of the 16x16 graph on the flat route."""
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", 1)


@pytest.mark.parametrize("ar_steps,rel", [(1, 5e-4), (3, 2e-3)])
def test_training_loss_grads_match_jax(models, ar_steps, rel, flat_route):
    """Gradient of training_loss for every parameter against jax.grad of
    the JAX model's training_loss (Pallas off: its XLA CPU route), on the
    port's flat route. Per parameter: max abs diff <= rel * max abs of the
    JAX gradient; rel is 5e-4 for one step and 2e-3 for three, since each
    unrolled step feeds the previous step's rounding back in."""
    assert tmp.flat_eligible(models[2].m2m, 2, H)
    _check_training_grads(models, ar_steps, rel)


def test_training_loss_grads_batched_route_match_jax(models):
    """The same one-step gradients on the batched route (P2/P3 with their
    backward through the plain versions), rel 5e-4."""
    assert not tmp.flat_eligible(models[2].m2m, 2, H)
    _check_training_grads(models, 1, 5e-4)


def _check_training_grads(models, ar_steps, rel):
    jmodel, params, tmodel, tds = models
    batch = _batch(tds, ar_steps)
    loss_j, g_j = jax.value_and_grad(jmodel.training_loss)(
        params, tuple(jnp.asarray(b) for b in batch))
    tmodel.zero_grad(set_to_none=True)
    loss_t = tmodel.training_loss(tuple(torch.as_tensor(b) for b in batch))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, g_j))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for k, w in want.items():
        err = float((got[k].grad - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-7, (k, err)


def test_adamw_trajectory_matches_optax(models, flat_route):
    """20 AdamW steps of the port's Trainer against optax.adamw(1e-3,
    b1=0.9, b2=0.95, weight_decay=0.01) from the same weights over the
    same batches; losses within rtol 2e-3, atol 1e-5 (fp32 drift grows
    with the step count, as in test_torch_parity's trajectory test)."""
    jmodel, params, fixture_model, tds = models
    tmodel = GraphLAM(
        ModelArgs(hidden_dim=64, processor_layers=2),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, fixture_model.graph, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    trainer, _ = make_trainer(tmodel, tds, batch_size=2, ar_steps=1)
    batches = [_batch(tds, 1, first=2 * i) for i in range(4)]
    n_steps = 20
    losses_t = [float(trainer.train_step(tuple(
        torch.as_tensor(b) for b in batches[i % 4]))) for i in range(n_steps)]

    optimizer = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.01)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(p, s, batch):
        loss, grads = jax.value_and_grad(jmodel.training_loss)(p, batch)
        updates, s = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    losses_j = []
    p = params
    for i in range(n_steps):
        p, opt_state, loss = step(p, opt_state, tuple(
            jnp.asarray(b) for b in batches[i % 4]))
        losses_j.append(float(loss))
    np.testing.assert_allclose(losses_t, losses_j, rtol=2e-3, atol=1e-5)


def test_checkpoint_round_trip(tmp_path):
    """save/load of model and AdamW state: a restored trainer continues
    exactly as the original does."""
    model, ds = build_model(nx=9, ny=9, processor_layers=1, n_timesteps=20,
                            device="cpu", seed=2)
    trainer, dm = make_trainer(model, ds, batch_size=2, ar_steps=1,
                               run_dir=tmp_path)
    batch = next(trainer.train_batches(dm, 0))
    trainer.train_step(batch)
    trainer.save("last", {"step": trainer.global_step, "best_val_loss": 1.5})
    assert (tmp_path / "last").is_dir()
    model_state, opt_state, meta = load_checkpoint(tmp_path / "last")
    assert meta == {"step": 1, "best_val_loss": 1.5}

    model2, _ = build_model(nx=9, ny=9, processor_layers=1, n_timesteps=20,
                            device="cpu", seed=7)
    model2.load_state_dict(model_state)
    trainer2, _ = make_trainer(model2, ds, batch_size=2, ar_steps=1)
    trainer2.optimizer.load_state_dict(opt_state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k
    assert trainer.train_step(batch) == trainer2.train_step(batch)
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k


def test_train_steps_runs_on_cpu_and_learns():
    """entry.train_steps: finite losses, one per step, decreasing on a
    fixed tiny problem (ar_steps 1 and 2)."""
    model, ds = build_model(nx=9, ny=9, processor_layers=1, n_timesteps=20,
                            device="cpu", seed=3)
    losses = train_steps(model, ds, batch_size=2, ar_steps=1, steps=6,
                         device="cpu")
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert len(train_steps(model, ds, 2, 2, steps=2, device="cpu")) == 2


def test_train_cli_one_epoch_on_cpu(tmp_path):
    """`python -m neural_lam_tpu_torch.train --device cpu` on a tiny dummy
    config: builds the graph, trains one epoch, validates, writes the
    metrics and the `last` and `min_val_loss` checkpoints."""
    (tmp_path / "dummy.yaml").write_text(
        "n_points_1d: 10\nn_timesteps: 40\nroot: dsroot\n")
    (tmp_path / "config.yaml").write_text(
        "datastore:\n  kind: dummydata\n  config_path: dummy.yaml\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "neural_lam_tpu_torch.train",
           "--config_path", "config.yaml", "--device", "cpu",
           "--hidden_dim", "64", "--processor_layers", "1", "--epochs", "1",
           "--batch_size", "2", "--ar_steps_eval", "2",
           "--val_steps_to_log", "1", "2", "--save_dir", "models",
           "--run_name", "r1"]
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    run = tmp_path / "models" / "r1"
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(recs[0]["train_loss"])
    assert "val_loss_unroll2" in recs[1] and np.isfinite(
        recs[1]["val_mean_loss"])
    assert (run / "last").is_dir() and (run / "min_val_loss").is_dir()
    assert (tmp_path / "dsroot" / "graph" / "multiscale" / "meta.json").exists()


def test_train_cli_hi_lam_one_epoch_on_cpu(tmp_path):
    """`--model hi_lam --graph hierarchical` on a 27x27 dummy config (the
    smallest grid with two mesh levels): builds the hierarchical graph,
    trains one epoch, validates and writes the metrics."""
    (tmp_path / "dummy.yaml").write_text(
        "n_points_1d: 27\nn_timesteps: 30\nroot: dsroot\n")
    (tmp_path / "config.yaml").write_text(
        "datastore:\n  kind: dummydata\n  config_path: dummy.yaml\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "neural_lam_tpu_torch.train",
           "--config_path", "config.yaml", "--device", "cpu",
           "--model", "hi_lam", "--graph", "hierarchical",
           "--hidden_dim", "64", "--processor_layers", "1", "--epochs", "1",
           "--batch_size", "2", "--ar_steps_eval", "2",
           "--val_steps_to_log", "1", "2", "--save_dir", "models",
           "--run_name", "h1"]
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    run = tmp_path / "models" / "h1"
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(recs[0]["train_loss"])
    assert "val_loss_unroll2" in recs[1] and np.isfinite(
        recs[1]["val_mean_loss"])
    assert (run / "last").is_dir()
    meta = json.loads((tmp_path / "dsroot" / "graph" / "hierarchical"
                       / "meta.json").read_text())
    assert meta == {"n_levels": 2, "hierarchical": True}
