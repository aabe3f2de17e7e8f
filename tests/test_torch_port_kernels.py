"""The port's kernels (plain versions, CPU) against the JAX package's Pallas
kernels run in interpret mode, on the same inputs drawn with numpy.

Tolerance for every comparison: atol = rtol = 1e-4 in fp32. The two sides
sum in different orders (per-slot LayerNorm statistics and masked slot
sums, per-batch-group matmuls against the JAX side's kron-widened ones),
and the JAX kernels fold the LayerNorm mean-centering into W2 (and W1 /
enc_w1 / a_w1) before the product, so they round differently from a
direct LayerNorm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu.ops import pallas_edge_flat as pef
from neural_lam_tpu.ops import pallas_embed as pe
from neural_lam_tpu.ops import pallas_grid_update as pgu
from neural_lam_tpu.ops.message_passing import EdgeSet as JEdgeSet
from neural_lam_tpu_torch.ops import _build, edge_flat, embed, grid_update
from neural_lam_tpu_torch.ops.message_passing import EdgeSet

TOL = dict(atol=1e-4, rtol=1e-4)
H = 64


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rand(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _local_graph(n_send, n_rec, deg, rng, spread=3):
    """Receiver r takes `deg` senders near r * n_send / n_rec: sender
    locality like the mesh graphs, so window layouts exist."""
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


def test_edge_set_layout_matches_jax():
    """The dense K-slot layout is the JAX package's, slot for slot,
    including padding and the virtual-row fold."""
    rng = np.random.default_rng(0)
    n_send, n_rec = 120, 100
    senders = rng.integers(0, n_send, 900)
    receivers = rng.integers(0, n_rec, 900)
    feats = rng.standard_normal((900, 3)).astype(np.float32)
    j, t = _edge_sets(senders, receivers, feats, n_send, n_rec)
    assert (t.dense_k, t.num_virt, t.virt_identity) == (
        j.dense_k, j.num_virt, j.virt_identity)
    for name in ("senders", "receivers", "features", "gather_table", "mask",
                 "virt_to_rec", "rec_slots", "rec_mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)


def _tail_inputs(rng, n_virt, K, n_send, B):
    W = B * H
    return dict(
        table=_rand(rng, n_send, W), ew=_rand(rng, n_virt * K, H),
        rec_rows=_rand(rng, n_virt, W), w2=_rand(rng, H, H, scale=0.2),
        b2=_rand(rng, H, scale=0.2),
        ls=(1 + _rand(rng, H, scale=0.1)), lb=_rand(rng, H, scale=0.1),
        w_e=_rand(rng, H, H, scale=0.2), b0=_rand(rng, H, scale=0.2),
        edge=_rand(rng, n_virt * K, W),
    )


def _tail_matches_jax(seed, deg, B, n_send=120, n_rec=100):
    """K2 plain == pallas_edge_flat.edge_tail_sum_flat (interpret) on a
    local graph of in-degree `deg` at batch B; returns the port's
    EdgeSet."""
    rng = np.random.default_rng(seed)
    j, t = _edge_sets(*_local_graph(n_send, n_rec, deg, rng), n_send, n_rec)
    K, n_virt = t.dense_k, t.num_virt
    x = _tail_inputs(rng, n_virt, K, n_send, B)
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    gathered = x["table"][np.asarray(j.senders)]
    _, virt_j = pef.edge_tail_sum_flat(
        gathered, x["ew"], x["rec_rows"], x["w2"], x["b2"], x["ls"],
        x["lb"], mask_p, K, interpret=True)
    virt_t = edge_flat.edge_tail_sum_flat(
        _t(x["table"]), t.senders, _t(x["ew"]), _t(x["rec_rows"]),
        t.mask.view(n_virt, K), _t(x["w2"]), _t(x["b2"]), _t(x["ls"]),
        _t(x["lb"]))
    np.testing.assert_allclose(virt_t.numpy(), np.asarray(virt_j), **TOL)
    return t


def test_edge_tail_sum_flat_matches_jax():
    """K2 plain == pallas_edge_flat.edge_tail_sum_flat (interpret)."""
    _tail_matches_jax(1, 9, 2)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", range(1, 9))
def test_edge_tail_sum_flat_sizes_match_jax(K, B):
    """The same at every slot count K2's kernel is built for (in-degree K:
    K slots a virtual row, one virtual row a receiver) and at batch 1 and
    4."""
    assert _tail_matches_jax(30 + K, K, B).dense_k == K


@pytest.mark.parametrize("variant", ["gathered", "window"])
def test_edge_layer_flat_matches_jax(variant):
    """K3 plain == edge_layer_flat (pre-gathered) and edge_layer_flat_win
    (in-kernel window gather from prep_window_gather's layout)."""
    rng = np.random.default_rng(2)
    B, n = 2, 400
    j, t = _edge_sets(*_local_graph(n, n, 8, rng), n, n)
    K, n_virt = t.dense_k, t.num_virt
    x = _tail_inputs(rng, n_virt, K, n, B)
    mask_np = np.asarray(j.mask)
    mask_p = mask_np.reshape(n_virt, K)
    args = (x["w_e"], x["b0"], x["w2"], x["b2"], x["ls"], x["lb"])
    if variant == "gathered":
        gathered = x["table"][np.asarray(j.senders)]
        edge_j, virt_j = pef.edge_layer_flat(
            x["edge"], gathered, x["rec_rows"], mask_p, *args, K,
            interpret=True)
    else:
        win = pgu.prep_window_gather(np.asarray(j.senders), mask_np, n_virt,
                                     K, n, target_rows=128)
        assert win is not None, "no window layout at this shape"
        arrays, static = win
        edge_j, virt_j = pef.edge_layer_flat_win(
            jnp.asarray(x["edge"]), jnp.asarray(x["table"]),
            x["rec_rows"], mask_p, *args, K, arrays, static["wrows"],
            static["tile_v"], interpret=True)
    edge_t, virt_t = edge_flat.edge_layer_flat(
        _t(x["edge"]), _t(x["table"]), t.senders, _t(x["rec_rows"]),
        t.mask.view(n_virt, K), *map(_t, args))
    np.testing.assert_allclose(virt_t.numpy(), np.asarray(virt_j), **TOL)
    # every slot, padding included: both sides write e + msg there
    np.testing.assert_allclose(edge_t.numpy(), np.asarray(edge_j), **TOL)


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


@pytest.mark.parametrize("variant", ["gathered", "window"])
def test_grid_update_flat_matches_jax(variant):
    """K4 plain == grid_update_flat and grid_update_flat_win, with ragged
    grid rows (N_rec < num_virt: the padding rows are sliced off)."""
    rng = np.random.default_rng(3)
    B, K, d_out, n_rec, n_send = 2, 4, 9, 300, 60
    j, t = _edge_sets(*_local_graph(n_send, n_rec, K, rng, spread=2),
                      n_send, n_rec, dense_cap=K)
    assert t.virt_identity and t.num_virt > n_rec
    n_virt = t.num_virt
    table = _rand(rng, n_send, B * H)
    ew = _rand(rng, n_virt * K, H)
    ge = _rand(rng, n_rec, B * H)
    mask_np = np.asarray(j.mask)
    mask_p = mask_np.reshape(n_virt, K)
    pp = _decoder_params(rng, d_out)
    pp_j = {k: jnp.asarray(v) for k, v in pp.items()}
    if variant == "gathered":
        out_j = pgu.grid_update_flat(table[np.asarray(j.senders)], ew, ge,
                                     mask_p, pp_j, K, interpret=True)
    else:
        win = pgu.prep_window_gather(np.asarray(j.senders), mask_np, n_virt,
                                     K, n_send, target_rows=64)
        assert win is not None, "no window layout at this shape"
        arrays, static = win
        out_j = pgu.grid_update_flat_win(
            jnp.asarray(table), ew, ge, mask_p, pp_j, K, arrays,
            static["wrows"], static["tile_v"], interpret=True)
    out_t = grid_update.grid_update_flat(
        _t(table), t.senders, _t(ew), _t(ge), t.mask.view(n_virt, K),
        {k: _t(v) for k, v in pp.items()})
    assert out_t.shape == (n_virt, B * d_out)
    np.testing.assert_allclose(out_t.numpy()[:n_rec],
                               np.asarray(out_j)[:n_rec], **TOL)


@pytest.mark.parametrize("K", range(1, 9))
def test_grid_update_flat_sizes_match_jax(K):
    """K4 plain == grid_update_flat (interpret) at every slot count K4's
    kernel is built for (in-degree K, one virtual row a receiver), batch
    4: the CPU half of the K4 sweep on the card."""
    rng = np.random.default_rng(40 + K)
    B, d_out, n_rec, n_send = 4, 17, 200, 60
    j, t = _edge_sets(*_local_graph(n_send, n_rec, K, rng, spread=2),
                      n_send, n_rec)
    assert t.dense_k == K and t.virt_identity
    n_virt = t.num_virt
    table = _rand(rng, n_send, B * H)
    ew = _rand(rng, n_virt * K, H)
    ge = _rand(rng, n_rec, B * H)
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    pp = _decoder_params(rng, d_out)
    out_j = pgu.grid_update_flat(
        table[np.asarray(j.senders)], ew, ge, mask_p,
        {k: jnp.asarray(v) for k, v in pp.items()}, K, interpret=True)
    out_t = grid_update.grid_update_flat(
        _t(table), t.senders, _t(ew), _t(ge), t.mask.view(n_virt, K),
        {k: _t(v) for k, v in pp.items()})
    np.testing.assert_allclose(out_t.numpy()[:n_rec],
                               np.asarray(out_j)[:n_rec], **TOL)


def _embed_case(rng, N, B, d_in):
    x = _rand(rng, N, B, d_in, scale=1.0)
    params = {
        "layers": [{"w": _rand(rng, d_in, H), "b": _rand(rng, H)},
                   {"w": _rand(rng, H, H), "b": _rand(rng, H)}],
        "ln": {"scale": 1 + _rand(rng, H, scale=0.1),
               "bias": _rand(rng, H, scale=0.1)},
    }
    lyr = params["layers"]
    port_args = (_t(x.reshape(N, -1)), _t(lyr[0]["w"]), _t(lyr[0]["b"]),
                 _t(lyr[1]["w"]), _t(lyr[1]["b"]), _t(params["ln"]["scale"]),
                 _t(params["ln"]["bias"]), B)
    return x, params, port_args


def _embed_matches_jax(seed, N, B, d_in):
    """K1 plain (unpadded features) == embed_grid_flat (interpret) on the
    JAX package's lane-padded packing of the same features (each batch
    group padded to a multiple of 128/B, as its models pack it)."""
    rng = np.random.default_rng(seed)
    m = 128 // B
    d_pad = -(-d_in // m) * m
    x, params, port_args = _embed_case(rng, N, B, d_in)
    x_pad = np.pad(x, ((0, 0), (0, 0), (0, d_pad - d_in))).reshape(N, -1)
    out_j = pe.embed_grid_flat(jnp.asarray(x_pad),
                               jax.tree.map(jnp.asarray, params), B, d_pad,
                               interpret=True)
    out_t = embed.embed_grid_flat(*port_args)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_embed_grid_flat_matches_jax():
    """K1 plain (unpadded features) == embed_grid_flat (interpret) on the
    JAX package's lane-padded packing of the same features."""
    _embed_matches_jax(4, 256, 2, 23)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("d_in", [23, 56, 100, 160])
def test_embed_grid_flat_sizes_match_jax(d_in, B):
    """The same at the widths K1's kernel stages differently (rows not a
    multiple of 16 bytes; one, two and more than two 64-column blocks) on
    250 nodes (no Pallas tile divides them, so the JAX side takes its XLA
    reference path)."""
    _embed_matches_jax(40 + d_in + B, 250, B, d_in)


def test_k1_k2_take_plain_version_on_cpu(monkeypatch):
    """On CPU tensors K1 and K2 are their plain versions: nothing is built
    and no launch is counted."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    rng = np.random.default_rng(5)
    _, _, k1 = _embed_case(rng, 50, 4, 23)
    n_send, n_rec, K, B = 60, 40, 3, 4
    _, t = _edge_sets(*_local_graph(n_send, n_rec, K, rng), n_send, n_rec)
    x = _tail_inputs(rng, t.num_virt, t.dense_k, n_send, B)
    k2 = (_t(x["table"]), t.senders, _t(x["ew"]), _t(x["rec_rows"]),
          t.mask.view(t.num_virt, t.dense_k), _t(x["w2"]), _t(x["b2"]),
          _t(x["ls"]), _t(x["lb"]))
    before = (embed.embed_grid_flat.launches,
              edge_flat.edge_tail_sum_flat.launches)
    torch.testing.assert_close(embed.embed_grid_flat(*k1),
                               embed.embed_grid_flat_plain(*k1), rtol=0,
                               atol=0)
    torch.testing.assert_close(edge_flat.edge_tail_sum_flat(*k2),
                               edge_flat.edge_tail_sum_flat_plain(*k2),
                               rtol=0, atol=0)
    assert (embed.embed_grid_flat.launches,
            edge_flat.edge_tail_sum_flat.launches) == before


# Gradients of the two flat edge kernels (K2's backward B2, K3's B3/B4) at
# several slot counts: (n_send, n_rec, in-degree) -> K = 8 with two virtual
# rows per receiver and padding slots, K = 3 (a K that does not divide the
# 16-row tiles of K3's tensor-core kernel) and K = 1 (a down set).
GRAD_SETS = {"k8": (150, 120, 9), "k3": (90, 120, 3), "k1": (40, 300, 1)}


@pytest.fixture(scope="module", params=sorted(GRAD_SETS))
def grad_case(request):
    """(JAX EdgeSet, port EdgeSet, inputs, cotangents) for B = 2."""
    rng = np.random.default_rng(20 + len(request.param))
    n_send, n_rec, deg = GRAD_SETS[request.param]
    j, t = _edge_sets(*_local_graph(n_send, n_rec, deg, rng), n_send, n_rec)
    assert t.dense_k == int(request.param[1:])
    B, K, n_virt = 2, t.dense_k, t.num_virt
    x = _tail_inputs(rng, n_virt, K, n_send, B)
    x.update(ct_v=_rand(rng, n_virt, B * H, scale=1.0),
             ct_e=_rand(rng, n_virt * K, B * H, scale=1.0))
    return j, t, x


def _assert_grad_close(got, want, name):
    """max |got - want| <= 1e-4 + 1e-4 * max |want|: fp32 sums over up to
    ~2k slots (the table's rows, the weights) run in another order on each
    side."""
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-4 + 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max abs diff {err:.3e} > {tol:.3e}"


def _slot_capture(edges, captured):
    def fold(d_slots):
        captured.append(d_slots)
        return edges.fold_senders(d_slots)

    return fold


def test_edge_tail_sum_flat_grads_match_jax(grad_case):
    """K2's autograd Function backward (B2: chain + xtd_sum, plain on the
    CPU) against jax.vjp through pallas_edge_flat.edge_tail_sum_flat
    (interpret), the JAX side's sender gather by `gather_send_flat` (whose
    backward, like the port's fold, sums real slots only): the per-slot
    sender cotangent, the table's gradient through the fold, and ew,
    rec_rows and the tail parameters."""
    j, t, x = grad_case
    K, n_virt = t.dense_k, t.num_virt
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    names = ("table", "ew", "rec_rows", "w2", "b2", "ls", "lb")

    def f(delta, table, ew, rec, w2, b2, ls, lb):
        g = jmp.gather_send_flat(table, j) + delta
        _, virt = pef.edge_tail_sum_flat(g, ew, rec, w2, b2, ls, lb, mask_p,
                                         K, interpret=True)
        return virt

    _, vjp = jax.vjp(f, jnp.zeros((n_virt * K, x["table"].shape[1])),
                     *(jnp.asarray(x[n]) for n in names))
    g_j = vjp(jnp.asarray(x["ct_v"]))
    leaves = [torch.tensor(x[n], requires_grad=True) for n in names]
    slots = []
    virt = edge_flat.edge_tail_sum_flat(
        leaves[0], t.senders, leaves[1], leaves[2], t.mask.view(n_virt, K),
        *leaves[3:], fold=_slot_capture(t, slots))
    (virt * _t(x["ct_v"])).sum().backward()
    _assert_grad_close(slots[0], g_j[0], "d_x0 per slot")
    for name, leaf, want in zip(names, leaves, g_j[1:]):
        _assert_grad_close(leaf.grad, want, name)


def test_edge_layer_flat_grads_match_jax(grad_case):
    """K3's autograd Function backward (B3/B4: chain + xtd_sum, plain on
    the CPU) against jax.vjp through pallas_edge_flat.edge_layer_flat
    (interpret, gather as above), with cotangents on both outputs (padding
    slots' edge_out too): the per-slot sender
    cotangent, the table's gradient through the fold, edge_rep, rec_rows
    and the layer parameters."""
    j, t, x = grad_case
    K, n_virt = t.dense_k, t.num_virt
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    names = ("edge", "table", "rec_rows", "w_e", "b0", "w2", "b2", "ls",
             "lb")

    def f(delta, edge, table, rec, *par):
        g = jmp.gather_send_flat(table, j) + delta
        return pef.edge_layer_flat(edge, g, rec, mask_p, *par, K,
                                   interpret=True)

    _, vjp = jax.vjp(f, jnp.zeros_like(jnp.asarray(x["edge"])),
                     *(jnp.asarray(x[n]) for n in names))
    g_j = vjp((jnp.asarray(x["ct_e"]), jnp.asarray(x["ct_v"])))
    leaves = [torch.tensor(x[n], requires_grad=True) for n in names]
    slots = []
    eo, virt = edge_flat.edge_layer_flat(
        leaves[0], leaves[1], t.senders, leaves[2], t.mask.view(n_virt, K),
        *leaves[3:], fold=_slot_capture(t, slots))
    ((virt * _t(x["ct_v"])).sum() + (eo * _t(x["ct_e"])).sum()).backward()
    _assert_grad_close(slots[0], g_j[0], "d_x0 per slot")
    for name, leaf, want in zip(names, leaves, g_j[1:]):
        _assert_grad_close(leaf.grad, want, name)
