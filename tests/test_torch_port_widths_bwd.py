"""The port's backward at hidden widths 32 and 128 against the JAX package,
on the CPU.

The backward CUDA sources (B1-B6 and `xtd_sum`) are built once per hidden
width (`_build.WIDTHS`: 32, 64, 128), like the forward ones; on a CPU
tensor every wrapper runs its plain version, which takes any width, and
chip_smoke.py (phase 20) holds each kernel against that plain version on
the card. Here, on the same inputs drawn with numpy:

* B1 (`embed_grid_flat_bwd`) at h = 32 and 128, d_in 23, 56 and 160 (past
  the 128 columns the kernel stages at once), batch 4, against `jax.grad`
  through `pallas_embed.embed_grid_flat` in interpret mode (its Pallas
  backward);
* B2 and B3/B4 through the autograd Functions of `edge_tail_sum_flat` and
  `edge_layer_flat` (chain and `xtd_sum`, plain), K = 1, 3 and 8, against
  `jax.vjp` through `pallas_edge_flat.edge_tail_sum_flat` and
  `edge_layer_flat` (interpret); B4's and B6's windowed JAX backwards
  (`edge_layer_flat_win_bwd`, `grid_update_flat_win_bwd`) against the
  port's table gradient, where their layout guards take the shapes;
* B5/B6 through `grid_update_flat`'s autograd Function at output maps
  wider than the width (d_out 34 at h = 32, 160 at 128, 80 at 64)
  against `jax.grad` through `pallas_grid_update.grid_update_flat`;
* `xtd_sum_plain` with D wider than X (the decoder's o_w1 pair past
  d_out = h) against float64, and `column_chunks`, which cuts such a D
  into h-wide pairs for the kernel;
* GraphLAM and a 2-level HiLAM (one processor layer) `training_loss`
  gradients at h = 32 and 128 on the port's flat route against
  `jax.grad` of the JAX model's training_loss on its CPU route (Pallas
  off).

Tolerances as the files at h = 64 state them: max abs diff <= 1e-4 +
1e-4 * max abs of the JAX gradient per tensor for a kernel (fp32 sums
over the rows in another order on each side), 5e-4 * max abs for a
model's parameter gradient. About 100-150 s serial.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
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
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.ops import edge_flat, embed, grid_update, weight_grad
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops.message_passing import EdgeSet
from .latent_helpers import run_compiled

WIDTHS = (32, 128)
SLOTS = (1, 3, 8)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rand(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _edge_sets(deg, seed, n_send=90, n_rec=80, spread=3):
    """(JAX EdgeSet, port EdgeSet, rng) of a local graph of in-degree
    `deg`: receiver r takes senders near r * n_send / n_rec."""
    rng = np.random.default_rng(seed)
    centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
    s = np.clip(centre + rng.integers(-spread, spread + 1, (n_rec, deg)), 0,
                n_send - 1).reshape(-1)
    r = np.repeat(np.arange(n_rec), deg)
    f = rng.standard_normal((n_rec * deg, 3)).astype(np.float32)
    j = JEdgeSet.from_local(s, r, f, n_send, n_rec, dense=True)
    t = EdgeSet.from_local(s, r, f, n_send, n_rec, device="cpu")
    assert t.dense_k == j.dense_k == deg
    return j, t, rng


def _tail(rng, h):
    """w2, b2, ln scale, ln bias of an edge MLP at width h."""
    return [_rand(rng, h, h, scale=0.2), _rand(rng, h, scale=0.2),
            1 + _rand(rng, h, scale=0.1), _rand(rng, h, scale=0.1)]


def _close(got, want, name):
    """max |got - want| <= 1e-4 + 1e-4 * max |want|."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-4 + 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max abs diff {err:.3e} > {tol:.3e}"


def _slot_capture(edges, captured):
    def fold(d_slots):
        captured.append(d_slots)
        return edges.fold_senders(d_slots)

    return fold


# ------------------------------------------------------------------- B1


@pytest.mark.parametrize("d_in", [23, 56, 160])
@pytest.mark.parametrize("h", WIDTHS)
def test_embed_bwd_width_matches_jax(h, d_in):
    """B1 plain, with and without dx, against jax.grad through the
    interpret-mode Pallas embedder on its lane-padded packing, batch 4."""
    rng = np.random.default_rng(h + d_in)
    N, B = 40, 4
    x = _rand(rng, N, B, d_in, scale=1.0)
    par = [_rand(rng, d_in, h), _rand(rng, h), _rand(rng, h, h, scale=0.2),
           _rand(rng, h), 1 + _rand(rng, h, scale=0.1),
           _rand(rng, h, scale=0.1)]
    ct = _rand(rng, N, B * h, scale=1.0)
    d_pad = -(-d_in // (128 // B)) * (128 // B)
    x_pad = np.pad(x, ((0, 0), (0, 0), (0, d_pad - d_in))).reshape(N, -1)

    def loss(x_pad, w0, b0, w1, b1, ls, lb):
        params = {"layers": [{"w": w0, "b": b0}, {"w": w1, "b": b1}],
                  "ln": {"scale": ls, "bias": lb}}
        out = pe.embed_grid_flat(x_pad, params, B, d_pad, interpret=True)
        return (out * ct).sum()

    g = jax.grad(loss, argnums=tuple(range(7)))(
        jnp.asarray(x_pad), *map(jnp.asarray, par))
    want_dx = np.asarray(g[0]).reshape(N, B, d_pad)[..., :d_in]
    args = [_t(x.reshape(N, -1))] + [_t(p) for p in par]
    got = embed.embed_grid_flat_bwd(*args, B, _t(ct), True)
    _close(got[0], want_dx.reshape(N, -1), "d_x")
    names = ("d_w0", "d_b0", "d_w1", "d_b1", "d_ln_scale", "d_ln_bias")
    for name, a, w in zip(names, got[1:], g[1:]):
        _close(a, w, name)
    no_dx = embed.embed_grid_flat_bwd(*args, B, _t(ct), False)
    assert no_dx[0] is None
    for name, a, w in zip(names, no_dx[1:], got[1:]):
        torch.testing.assert_close(a, w, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------- B2, B3


@pytest.mark.parametrize("K", SLOTS)
@pytest.mark.parametrize("h", WIDTHS)
def test_edge_tail_bwd_width_matches_jax(h, K):
    """B2 (chain + xtd_sum, plain) through edge_tail_sum_flat's autograd
    Function against jax.vjp through pallas_edge_flat.edge_tail_sum_flat
    (interpret), batch 4: the per-slot sender cotangent, the table's
    gradient through the fold, ew, rec_rows and the tail parameters."""
    j, t, rng = _edge_sets(K, 50 + K + h)
    B, n_virt = 4, t.num_virt
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    x = dict(table=_rand(rng, t.num_send, B * h),
             ew=_rand(rng, n_virt * K, h), rec=_rand(rng, n_virt, B * h))
    x.update(zip(("w2", "b2", "ls", "lb"), _tail(rng, h)))
    ct = _rand(rng, n_virt, B * h, scale=1.0)
    names = ("table", "ew", "rec", "w2", "b2", "ls", "lb")

    def f(delta, table, ew, rec, w2, b2, ls, lb):
        g = jmp.gather_send_flat(table, j) + delta
        return pef.edge_tail_sum_flat(g, ew, rec, w2, b2, ls, lb, mask_p, K,
                                      interpret=True)[1]

    _, vjp = jax.vjp(f, jnp.zeros((n_virt * K, B * h)),
                     *(jnp.asarray(x[n]) for n in names))
    g_j = vjp(jnp.asarray(ct))
    leaves = [torch.tensor(x[n], requires_grad=True) for n in names]
    slots = []
    virt = edge_flat.edge_tail_sum_flat(
        leaves[0], t.senders, leaves[1], leaves[2], t.mask.view(n_virt, K),
        *leaves[3:], fold=_slot_capture(t, slots))
    (virt * _t(ct)).sum().backward()
    _close(slots[0], g_j[0], "d_x0 per slot")
    for name, leaf, want in zip(names, leaves, g_j[1:]):
        _close(leaf.grad, want, name)


@pytest.mark.parametrize("K", SLOTS)
@pytest.mark.parametrize("h", WIDTHS)
def test_edge_layer_bwd_width_matches_jax(h, K):
    """B3/B4 (chain + xtd_sum, plain) through edge_layer_flat's autograd
    Function against jax.vjp through pallas_edge_flat.edge_layer_flat
    (interpret), batch 4, cotangents on both outputs."""
    j, t, rng = _edge_sets(K, 60 + K + h)
    B, n_virt = 4, t.num_virt
    M = n_virt * K
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    x = dict(edge=_rand(rng, M, B * h), table=_rand(rng, t.num_send, B * h),
             rec=_rand(rng, n_virt, B * h), w_e=_rand(rng, h, h, scale=0.2),
             b0=_rand(rng, h, scale=0.2))
    x.update(zip(("w2", "b2", "ls", "lb"), _tail(rng, h)))
    ct_e, ct_v = _rand(rng, M, B * h, scale=1.0), _rand(rng, n_virt, B * h,
                                                         scale=1.0)
    names = ("edge", "table", "rec", "w_e", "b0", "w2", "b2", "ls", "lb")

    def f(delta, edge, table, rec, *par):
        g = jmp.gather_send_flat(table, j) + delta
        return pef.edge_layer_flat(edge, g, rec, mask_p, *par, K,
                                   interpret=True)

    _, vjp = jax.vjp(f, jnp.zeros((M, B * h)),
                     *(jnp.asarray(x[n]) for n in names))
    g_j = vjp((jnp.asarray(ct_e), jnp.asarray(ct_v)))
    leaves = [torch.tensor(x[n], requires_grad=True) for n in names]
    slots = []
    eo, virt = edge_flat.edge_layer_flat(
        leaves[0], leaves[1], t.senders, leaves[2], t.mask.view(n_virt, K),
        *leaves[3:], fold=_slot_capture(t, slots))
    ((virt * _t(ct_v)).sum() + (eo * _t(ct_e)).sum()).backward()
    _close(slots[0], g_j[0], "d_x0 per slot")
    for name, leaf, want in zip(names, leaves, g_j[1:]):
        _close(leaf.grad, want, name)


# ---------------------------------------------------------------- B5/B6


def _decoder_params(rng, h, d_out):
    def mk(*shape):
        return _rand(rng, *shape, scale=0.1)

    pp = {k: mk(2 * h if k == "a_w0" else h, h) for k in grid_update._MATS}
    pp.update({k: mk(h) for k in grid_update._VECS})
    pp.update({k: 1.0 + mk(h) for k in ("enc_ls", "e_ls", "a_ls")})
    return dict(pp, o_w1=mk(h, d_out), o_b1=mk(d_out))


@pytest.mark.parametrize("h, d_out", [(32, 34), (128, 160), (64, 80)])
def test_grid_update_bwd_width_matches_jax(h, d_out):
    """B5/B6 (chain + xtd_sum, plain, the o_w1 pair wider than h) through
    grid_update_flat's autograd Function against jax.grad through
    pallas_grid_update.grid_update_flat (interpret), batch 4, K = 4,
    n_ge < n_virt: the per-slot d_x0, d_table through the fold, d_ew,
    d_grid_emb_f and all 21 parameters."""
    K, B, n_rec = 4, 4, 120
    j, t, rng = _edge_sets(K, 70 + h, n_send=40, n_rec=n_rec, spread=2)
    assert t.virt_identity and t.num_virt > n_rec
    n_virt, M, W = t.num_virt, t.num_virt * K, B * h
    table, ew = _rand(rng, t.num_send, W), _rand(rng, M, h)
    ge = _rand(rng, n_rec, W)
    pp = _decoder_params(rng, h, d_out)
    ct = _rand(rng, n_virt, B * d_out, scale=1.0)
    mask_p = np.asarray(j.mask).reshape(n_virt, K)

    def loss_j(delta, table, ew, ge, pp):
        g = jmp.gather_send_flat(table, j) + delta
        out = pgu.grid_update_flat(g, ew, ge, mask_p, pp, K, interpret=True)
        return (out * ct).sum()

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(
        jnp.zeros((M, W), jnp.float32), jnp.asarray(table), jnp.asarray(ew),
        jnp.asarray(ge), {k: jnp.asarray(v) for k, v in pp.items()})
    leaves = [torch.tensor(a, requires_grad=True) for a in (table, ew, ge)]
    pp_t = {k: torch.tensor(v, requires_grad=True) for k, v in pp.items()}
    slots = []
    out = grid_update.grid_update_flat(
        leaves[0], t.senders, leaves[1], leaves[2], t.mask.view(-1, K), pp_t,
        fold=_slot_capture(t, slots))
    (out * _t(ct)).sum().backward()
    _close(slots[0], g_j[0], "d_x0 per slot")
    for name, leaf, want in zip(("table", "ew", "ge"), leaves, g_j[1:4]):
        _close(leaf.grad, want, name)
    for k, v in pp_t.items():
        _close(v.grad, g_j[4][k], k)


@pytest.mark.parametrize("which", ["B4", "B6"])
@pytest.mark.parametrize("h", WIDTHS)
def test_window_bwd_width_matches_jax(which, h):
    """The table gradient of the port's B3/B4 (K = 8) and B5/B6 (K = 4),
    folded from its per-slot d_x0, against the JAX package's windowed
    backwards (`edge_layer_flat_win_bwd`, `grid_update_flat_win_bwd`,
    interpret), which fold per-tile window cotangents, at batch 4 (h = 32)
    and 2 (h = 128)."""
    B = 4 if h == 32 else 2
    if which == "B4":
        j, t, rng = _edge_sets(8, 80 + h, n_send=256, n_rec=256)
    else:
        j, t, rng = _edge_sets(4, 90 + h, n_send=60, n_rec=300, spread=2)
    K, nv = t.dense_k, t.num_virt
    n_send, W = t.num_send, B * h
    mask = np.asarray(j.mask)
    mask_j = jnp.asarray(mask.reshape(nv, K))
    arrays, static = pgu.prep_window_gather(
        np.asarray(j.senders), mask, nv, K, n_send,
        target_rows=128 if which == "B4" else 64)
    assert "fold_slots" in arrays
    win = (arrays, static["wrows"], static["tile_v"])
    table = _rand(rng, n_send, W)
    tl = torch.tensor(table, requires_grad=True)
    if which == "B4":
        par = [_rand(rng, h, h, scale=0.2), _rand(rng, h, scale=0.2)] + _tail(
            rng, h)
        edge_rep, rec = _rand(rng, nv * K, W), _rand(rng, nv, W)
        cts = (_rand(rng, nv * K, W, scale=1.0) * np.repeat(
            mask.reshape(-1, 1), W, 1), _rand(rng, nv, W, scale=1.0))
        d_win = pef.edge_layer_flat_win_bwd(
            jnp.asarray(edge_rep), jnp.asarray(table), jnp.asarray(rec),
            mask_j, *map(jnp.asarray, par), K, *win,
            tuple(map(jnp.asarray, cts)), interpret=True)
        out = edge_flat.edge_layer_flat(
            _t(edge_rep), tl, t.senders, _t(rec), t.mask.view(nv, K),
            *map(_t, par), fold=t.fold_senders)
        torch.autograd.backward(list(out), [_t(c) for c in cts])
    else:
        ew, ge = _rand(rng, nv * K, h), _rand(rng, 300, W)
        pp = _decoder_params(rng, h, 9)
        ct = _rand(rng, nv, B * 9, scale=1.0)
        d_win = pgu.grid_update_flat_win_bwd(
            jnp.asarray(table), jnp.asarray(ew), jnp.asarray(ge), mask_j,
            {k: jnp.asarray(v) for k, v in pp.items()}, K, *win,
            jnp.asarray(ct), interpret=True)
        out = grid_update.grid_update_flat(
            tl, t.senders, _t(ew), _t(ge), t.mask.view(nv, K),
            {k: _t(v) for k, v in pp.items()}, fold=t.fold_senders)
        out.backward(_t(ct))
    assert d_win is not None, "the JAX windowed backward declined the shapes"
    _close(tl.grad, d_win[1] if which == "B4" else d_win[0], "d_table")


# --------------------------------------------------------------- xtd_sum


@pytest.mark.parametrize("h", [32, 64, 128])
def test_xtd_sum_plain_wider_d_matches_float64(h):
    """xtd_sum_plain with D wider than X (d = 2h + 5, the decoder's o_w1
    pair at d_out > h) and narrower, within 1e-5 * (1 + max abs) of
    float64; `column_chunks` cuts the wide D into h-wide contiguous
    chunks whose sums, joined, are the same matrix."""
    rng = np.random.default_rng(h)
    pairs = [(_rand(rng, 97, h, scale=1.0), _rand(rng, 97, d, scale=1.0))
             for d in (2 * h + 5, 17)]
    tp = [(_t(x), _t(d)) for x, d in pairs]
    got = weight_grad.xtd_sum_plain(tp)
    for g, (x, d) in zip(got, pairs):
        want = x.astype(np.float64).T @ d.astype(np.float64)
        assert g.shape == want.shape
        assert float(np.abs(g.numpy() - want).max()) <= 1e-5 * (
            1 + np.abs(want).max())
    chunks, counts = weight_grad.column_chunks(tp)
    assert counts == [3, 1]
    assert [d.shape[1] for _, d in chunks] == [h, h, 5, 17]
    assert all(d.is_contiguous() for _, d in chunks)
    assert chunks[3][1] is tp[1][1]  # no wider than h: as it is
    parts = weight_grad.xtd_sum_plain(chunks)
    torch.testing.assert_close(torch.cat(parts[:3], 1), got[0], rtol=0,
                               atol=0)
    torch.testing.assert_close(weight_grad.xtd_sum(tp)[0], got[0], rtol=0,
                               atol=0)


# ------------------------------------------------------- models against JAX


def _model_pair(kind, h, tmp_path_factory):
    """(jax_model, jax_params, port_model): GraphLAM on a 16x16 and HiLAM
    on a 30x30 (2-level) DummyDatastore, hidden h, 1 processor layer."""
    assert jmp._pallas_mode() == "off"
    nx = 16 if kind == "graph_lam" else 30
    jds = JDummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    hier = kind == "hi_lam"
    jbundle = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                             jds.get_xy("state", stacked=False),
                             n_max_levels=None, hierarchical=hier)
    tbundle = create_graph(str(tmp_path_factory.mktemp("tg")),
                           tds.get_xy("state", stacked=False),
                           n_max_levels=None, hierarchical=hier)
    jmodel = J_MODELS[kind](
        JModelArgs(hidden_dim=h, processor_layers=1),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
        jds, j_graph_from_bundle(jbundle))
    params = jmodel.init_params(jax.random.PRNGKey(h))
    tmodel = MODELS[kind](
        ModelArgs(hidden_dim=h, processor_layers=1),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, graph_from_bundle(tbundle, device="cpu"), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("kind", ["graph_lam", "hi_lam"])
def test_training_loss_grads_width_match_jax(kind, h, tmp_path_factory,
                                            monkeypatch):
    """Gradient of training_loss (one step) for every parameter on the
    port's flat route (`_FLAT_MIN_VIRT` at 1: K1-K4's autograd Functions,
    whose backwards are B1-B6 and xtd_sum, on every set the flat route
    takes) against jax.grad of the JAX model's training_loss (Pallas off:
    its XLA CPU route, compiled at XLA's lowest optimization level), batch
    4 at h = 32 and 1 at 128: max abs diff <= 5e-4 * max abs of the JAX
    gradient per parameter."""
    jmodel, params, tmodel = _model_pair(kind, h, tmp_path_factory)
    B = 4 if h == 32 else 1  # B*h = 128: the flat route at both widths
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", 1)
    assert tmodel._flat_grid_eligible(B)
    rng = np.random.default_rng(h)
    n, d = tmodel.num_grid_nodes, tmodel.num_state_vars
    batch = (rng.standard_normal((B, 2, n, d)).astype(np.float32),
             rng.standard_normal((B, 1, n, d)).astype(np.float32),
             rng.standard_normal(
                 (B, 1, n, tmodel.num_forcing_vars * 3)).astype(np.float32),
             np.zeros((B, 1), np.int64))
    loss_j, g_j = run_compiled(jax.value_and_grad(jmodel.training_loss),
                               params, tuple(jnp.asarray(b) for b in batch))
    loss_t = tmodel.training_loss(tuple(_t(b) for b in batch))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, g_j))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for k, w in want.items():
        err = float((got[k].grad - w).abs().max())
        assert err <= 5e-4 * float(w.abs().max()) + 1e-7, (k, err)
