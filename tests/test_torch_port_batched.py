"""The port's batched edge route against the JAX package's, on the CPU.

Kernel level: the plain versions behind `edge.edge_tail` (P1),
`edge.edge_tail_sum` (P2) and `edge.edge_layer` (P3) against
`pallas_edge.edge_tail`, `edge_tail_sum` and `edge_layer` run in interpret
mode, on the same inputs drawn with numpy (h = 64, a few hundred virtual
rows, padding slots and padding rows included, K = 8 and K = 1 sets).
Values: atol = rtol = 1e-4 in fp32 (per-slot LayerNorm statistics and
masked slot sums run in another order on each side). Gradients of every
input, the port's autograd.Function backward against `jax.vjp` through
the JAX function (its reference-recompute VJP): max abs diff <= 1e-4 +
1e-4 * max abs of the JAX gradient, since the sender-table gradient sums
up to ~2k slot cotangents per row in another order.

At every slot count the kernels are built for (K = 1..8, local graphs
of in-degree K, batch 1 and 4), the values of P1 and P2 (with and without
messages) and P3 (both in_gather variants) against JAX, within TOL; and
the batched plain P2/P3 against the flat plain K2/K3 after the layout
permutation, torch only (see that test for its tolerance).

Route level: `flat_eligible` and `expand_edge_rep` against the JAX
package's dispatch, and `apply_interaction_net`'s batched rounds against
the JAX package's.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu.ops import pallas_edge as jpe
from neural_lam_tpu.ops.message_passing import EdgeSet as JEdgeSet
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.ops import _build, edge
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops.message_passing import EdgeSet

H = 64
TOL = dict(atol=1e-4, rtol=1e-4)


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


# (n_send, n_rec, in-degree): K=8 with two virtual rows per receiver and
# padding slots; K=1 (a down set: one parent per child)
SETS = {"k8": (150, 120, 9), "k1": (40, 300, 1)}


@pytest.fixture(scope="module", params=sorted(SETS))
def case(request):
    """(JAX EdgeSet, port EdgeSet, inputs) for B = 2."""
    rng = np.random.default_rng(len(request.param))
    n_send, n_rec, deg = SETS[request.param]
    s, r, f = _local_graph(n_send, n_rec, deg, rng)
    j = JEdgeSet.from_local(s, r, f, n_send, n_rec, dense=True)
    t = EdgeSet.from_local(s, r, f, n_send, n_rec, device="cpu")
    B, K, n_virt = 2, t.dense_k, t.num_virt
    M = n_virt * K
    assert float(t.mask.sum()) < M, "the set should hold padding slots"
    x = dict(
        x0=_rand(rng, B, M, H, scale=1.0), send_t=_rand(rng, B, n_send, H),
        ew=_rand(rng, M, H), rec=_rand(rng, B, n_virt, H),
        edge=_rand(rng, B, M, H),
        w_e=_rand(rng, H, H, scale=0.2), b0=_rand(rng, H, scale=0.2),
        w2=_rand(rng, H, H, scale=0.2), b2=_rand(rng, H, scale=0.2),
        ls=1 + _rand(rng, H, scale=0.1), lb=_rand(rng, H, scale=0.1),
        mask=np.asarray(j.mask), ct_m=_rand(rng, B, M, H, scale=1.0),
        ct_v=_rand(rng, B, n_virt, H, scale=1.0),
    )
    return j, t, x


def _leaves(x, names):
    return [torch.tensor(x[n], requires_grad=True) for n in names]


def _assert_grad_close(got, want, name):
    """max |got - want| <= 1e-4 + 1e-4 * max |want| (see module doc)."""
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-4 + 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max abs diff {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("with_messages", [True, False])
def test_edge_tail_matches_jax(case, with_messages):
    """P1 plain == pallas_edge.edge_tail (interpret): msg at every slot,
    virt, and the gradients of x0, the tail parameters and the mask."""
    j, t, x = case
    K = t.dense_k
    names = ("x0", "w2", "b2", "ls", "lb", "mask")

    def f(*a):
        msg, virt = jpe.edge_tail(*a, K, True, with_messages)
        return (msg, virt) if with_messages else virt

    out_j, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in names))
    leaves = _leaves(x, names)
    msg_t, virt_t = edge.edge_tail(*leaves, K, with_messages=with_messages)
    virt_j = out_j[1] if with_messages else out_j
    np.testing.assert_allclose(virt_t.detach().numpy(), np.asarray(virt_j),
                               **TOL)
    loss = (virt_t * torch.as_tensor(x["ct_v"])).sum()
    if with_messages:
        np.testing.assert_allclose(msg_t.detach().numpy(),
                                   np.asarray(out_j[0]), **TOL)
        loss = loss + (msg_t * torch.as_tensor(x["ct_m"])).sum()
        g_j = vjp((jnp.asarray(x["ct_m"]), jnp.asarray(x["ct_v"])))
    else:
        assert msg_t is None
        g_j = vjp(jnp.asarray(x["ct_v"]))
    loss.backward()
    for name, leaf, want in zip(names, leaves, g_j):
        _assert_grad_close(leaf.grad, want, name)


def test_edge_tail_sum_matches_jax(case):
    """P2 plain (sender rows gathered by index from the table) ==
    pallas_edge.edge_tail_sum (interpret) on send_t[:, senders]; gradients
    of the table (through the gather), ew, rec_rows, parameters and mask."""
    j, t, x = case
    K = t.dense_k
    senders = np.asarray(j.senders)
    names = ("send_t", "ew", "rec", "w2", "b2", "ls", "lb", "mask")

    def f(send_t, *rest):
        _, virt = jpe.edge_tail_sum(jnp.take(send_t, senders, axis=1), *rest,
                                    K, True, False)
        return virt

    virt_j, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in names))
    leaves = _leaves(x, names)
    msg_t, virt_t = edge.edge_tail_sum(leaves[0], t.senders, *leaves[1:], K,
                                       with_messages=False)
    assert msg_t is None
    np.testing.assert_allclose(virt_t.detach().numpy(), np.asarray(virt_j),
                               **TOL)
    (virt_t * torch.as_tensor(x["ct_v"])).sum().backward()
    for name, leaf, want in zip(names, leaves,
                                vjp(jnp.asarray(x["ct_v"]))):
        _assert_grad_close(leaf.grad, want, name)


@pytest.mark.parametrize("in_gather", [False, True])
def test_edge_layer_matches_jax(case, in_gather):
    """P3 plain == pallas_edge.edge_layer (interpret), both in_gather
    variants: edge_out at every slot (padding included: e + msg on both
    sides), virt, and the gradients of every input."""
    j, t, x = case
    K = t.dense_k
    senders = np.asarray(j.senders)
    names = ("edge", "send_t", "rec", "mask", "w_e", "b0", "w2", "b2",
             "ls", "lb")

    def f(e, send_t, rec, mask, *par):
        gs = senders if in_gather else jnp.take(send_t, senders, axis=1)
        return jpe.edge_layer(e, gs, send_t, rec, mask, *par, K, in_gather,
                              True)

    (eo_j, virt_j), vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in names))
    leaves = _leaves(x, names)
    eo_t, virt_t = edge.edge_layer(leaves[0], leaves[1], t.senders,
                                   *leaves[2:], K)
    np.testing.assert_allclose(virt_t.detach().numpy(), np.asarray(virt_j),
                               **TOL)
    np.testing.assert_allclose(eo_t.detach().numpy(), np.asarray(eo_j),
                               **TOL)
    ((virt_t * torch.as_tensor(x["ct_v"])).sum()
     + (eo_t * torch.as_tensor(x["ct_m"])).sum()).backward()
    g_j = vjp((jnp.asarray(x["ct_m"]), jnp.asarray(x["ct_v"])))
    for name, leaf, want in zip(names, leaves, g_j):
        _assert_grad_close(leaf.grad, want, name)


def test_edge_layer_without_edge_cotangent(case):
    """The last processor layer's edge state is never read: its gradient
    arrives as None, and the other gradients equal those of a zero
    edge cotangent."""
    _, t, x = case
    K = t.dense_k
    names = ("edge", "send_t", "rec", "w_e", "b0", "w2", "b2", "ls", "lb")
    grads = []
    for with_edge in (False, True):
        leaves = _leaves(x, names)
        eo, virt = edge.edge_layer(leaves[0], leaves[1], t.senders,
                                   leaves[2], t.mask, *leaves[3:], K)
        loss = (virt * torch.as_tensor(x["ct_v"])).sum()
        if with_edge:
            loss = loss + (eo * 0).sum()
        loss.backward()
        grads.append([leaf.grad for leaf in leaves])
    for name, a, b in zip(names, *grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=name)


def _calls():
    """(wrapper, args) for each batched wrapper at a tiny shape."""
    rng = np.random.default_rng(0)
    B, n_virt, K, n_send = 2, 4, 2, 5
    M = n_virt * K

    def r(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    senders = torch.as_tensor(rng.integers(0, n_send, M), dtype=torch.int32)
    mask = torch.ones(M, 1)
    tail = (r(H, H), r(H), r(H), r(H))
    return [
        (edge.edge_tail, (r(B, M, H), *tail, mask, K)),
        (edge.edge_tail_sum, (r(B, n_send, H), senders, r(M, H),
                              r(B, n_virt, H), *tail, mask, K)),
        (edge.edge_layer, (r(B, M, H), r(B, n_send, H), senders,
                           r(B, n_virt, H), mask, r(H, H), r(H), *tail, K)),
    ]


@pytest.mark.parametrize("index", range(3))
def test_batched_wrapper_takes_plain_version_on_cpu(index, monkeypatch):
    """A CPU tensor runs the plain version (identical result), builds and
    launches nothing; a tensor on another non-CUDA device raises."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    wrapper, args = _calls()[index]
    plain = getattr(edge, wrapper.__name__ + "_plain")
    before = wrapper.launches
    for g, w in zip(wrapper(*args), plain(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert wrapper.launches == before
    meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(*meta_args)
    assert wrapper.launches == before


def test_flat_eligible_matches_jax(monkeypatch):
    """The port's dispatch is the JAX package's (with its Pallas kernels
    on) over a grid of batch sizes, widths and virtual-row counts."""
    monkeypatch.setattr(jmp, "_PALLAS_MODE", "interpret")
    monkeypatch.delenv("NLT_NO_FLAT", raising=False)
    n = 0
    for num_virt in (64, 448, 511, 512, 768, 6656):
        es = types.SimpleNamespace(dense_k=8, num_virt=num_virt)
        for B in (1, 2, 3, 4, 8):
            for h in (16, 32, 64, 96, 128):
                got = tmp.flat_eligible(es, B, h)
                assert got == jmp.flat_eligible(es, B, h), (num_virt, B, h)
                n += got
    assert 0 < n < 6 * 5 * 5
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", 1)
    assert tmp.flat_eligible(types.SimpleNamespace(num_virt=64), 2, 64)


@pytest.mark.parametrize("B", [1, 2])
def test_expand_edge_rep_layout_matches_jax(B, monkeypatch):
    """expand_edge_rep: flat (M, B*h) on the flat route, batched (B, M, h)
    otherwise, with the JAX package's values in both."""
    monkeypatch.setattr(jmp, "_PALLAS_MODE", "interpret")
    rng = np.random.default_rng(7)
    s, r, f = _local_graph(100, 80, 6, rng)
    j = JEdgeSet.from_local(s, r, f, 100, 80, dense=True)
    t = EdgeSet.from_local(s, r, f, 100, 80, device="cpu")
    emb = _rand(rng, t.num_virt * t.dense_k, H)
    for min_virt in (512, 1):
        monkeypatch.setattr(jmp, "_FLAT_MIN_VIRT", min_virt)
        monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", min_virt)
        want = np.asarray(jmp.expand_edge_rep(j, jnp.asarray(emb), B))
        got = tmp.expand_edge_rep(t, torch.as_tensor(emb), B)
        assert tuple(got.shape) == want.shape, (min_virt, B)
        np.testing.assert_array_equal(got.numpy(), want)


def _inet_pair(seed):
    from neural_lam_tpu.ops.message_passing import (
        init_interaction_net as j_init)

    jp = j_init(jax.random.PRNGKey(seed), H)
    tp = tmp.init_interaction_net(H)
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jp, tp


@pytest.mark.parametrize("kind", ["layer", "static_ew", "read_only",
                                  "layer_mean"])
def test_apply_interaction_net_batched_matches_jax(case, kind, monkeypatch):
    """One batched round of apply_interaction_net (B = 2 below the flat
    threshold): P3 with update_edges, P2 on a static ew, P1 on a read-only
    edge state, and mean aggregation; against the JAX round with its
    Pallas kernels in interpret mode. atol 1e-4 (the round chains two
    MLPs and a fold)."""
    monkeypatch.setattr(jmp, "_PALLAS_MODE", "interpret")
    j, t, x = case
    rng = np.random.default_rng(9)
    B = 2
    jp, tp = _inet_pair(3)
    send = _rand(rng, B, t.num_send, H, scale=1.0)
    rec = _rand(rng, B, t.num_rec, H, scale=1.0)
    aggr = "mean" if kind == "layer_mean" else "sum"
    update = kind in ("layer", "layer_mean")
    kw_j, kw_t = {}, {}
    if kind == "static_ew":
        kw_j["ew"], kw_t["ew"] = jnp.asarray(x["ew"]), torch.as_tensor(
            x["ew"])
    else:
        kw_j["edge_rep"] = jnp.asarray(x["edge"])
        kw_t["edge_rep"] = torch.as_tensor(x["edge"])
    out_j = jmp.apply_interaction_net(jp, j, jnp.asarray(send),
                                      jnp.asarray(rec), update_edges=update,
                                      aggr=aggr, **kw_j)
    with torch.no_grad():
        out_t = tmp.apply_interaction_net(
            tp, t, torch.as_tensor(send), torch.as_tensor(rec),
            update_edges=update, aggr=aggr, **kw_t)
    for a, b in zip(out_t if update else (out_t,),
                    out_j if update else (out_j,)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_apply_interaction_net_rejects_the_other_layout(case, monkeypatch):
    """A set on the batched route never takes a flat edge state (nor the
    other way round): the round raises instead of reshaping."""
    _, t, x = case
    _, tp = _inet_pair(4)
    B = 2
    send = torch.zeros(B, t.num_send, H)
    rec = torch.zeros(B, t.num_rec, H)
    flat_state = torch.as_tensor(x["edge"]).transpose(0, 1).reshape(
        -1, B * H)
    with pytest.raises(ValueError, match="batched route"):
        tmp.apply_interaction_net(tp, t, send, rec, flat_state)
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT", 1)
    with pytest.raises(ValueError, match="flat route"):
        tmp.apply_interaction_net(tp, t, send, rec,
                                  torch.as_tensor(x["edge"]))


def _sized_sets(K, seed):
    """(JAX EdgeSet, port EdgeSet, rng) of a local graph of in-degree K:
    K slots a virtual row, 100 receivers padded to 128 virtual rows (28
    padding rows), 120 senders."""
    rng = np.random.default_rng(seed)
    n_send, n_rec = 120, 100
    s, r, f = _local_graph(n_send, n_rec, K, rng)
    j = JEdgeSet.from_local(s, r, f, n_send, n_rec, dense=True)
    t = EdgeSet.from_local(s, r, f, n_send, n_rec, device="cpu")
    assert t.dense_k == j.dense_k == K
    # the Pallas kernel runs (not its reference fallback) at this size
    assert jpe._pick_tile_v_batched(t.num_virt, K) >= 64
    return j, t, rng


def _sized_inputs(rng, t, B):
    n_virt, K = t.num_virt, t.dense_k
    M = n_virt * K
    return dict(
        send_t=_rand(rng, B, t.num_send, H), ew=_rand(rng, M, H),
        rec=_rand(rng, B, n_virt, H), edge=_rand(rng, B, M, H),
        w_e=_rand(rng, H, H, scale=0.2), b0=_rand(rng, H, scale=0.2),
        w2=_rand(rng, H, H, scale=0.2), b2=_rand(rng, H, scale=0.2),
        ls=1 + _rand(rng, H, scale=0.1), lb=_rand(rng, H, scale=0.1),
    )


@pytest.mark.parametrize("with_messages", [True, False])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", range(1, 9))
def test_edge_tail_sum_sizes_match_jax(K, B, with_messages):
    """P2 plain == pallas_edge.edge_tail_sum (interpret) at every slot
    count P2's kernel is built for, at batch 1 and 4, with and without
    messages (msg at every slot, padding included); TOL as above."""
    j, t, rng = _sized_sets(K, 40 + K)
    x = _sized_inputs(rng, t, B)
    tail = [x[n] for n in ("w2", "b2", "ls", "lb")]
    gathered = x["send_t"][:, np.asarray(j.senders)]
    msg_j, virt_j = jpe.edge_tail_sum(gathered, x["ew"], x["rec"], *tail,
                                      np.asarray(j.mask), K, True,
                                      with_messages)
    msg_t, virt_t = edge.edge_tail_sum(
        torch.as_tensor(x["send_t"]), t.senders, torch.as_tensor(x["ew"]),
        torch.as_tensor(x["rec"]), *map(torch.as_tensor, tail), t.mask, K,
        with_messages=with_messages)
    np.testing.assert_allclose(virt_t.numpy(), np.asarray(virt_j), **TOL)
    if with_messages:
        np.testing.assert_allclose(msg_t.numpy(), np.asarray(msg_j), **TOL)
    else:
        assert msg_t is None and msg_j is None


@pytest.mark.parametrize("with_messages", [True, False])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", range(1, 9))
def test_edge_tail_sizes_match_jax(K, B, with_messages):
    """P1 plain == pallas_edge.edge_tail (interpret) at every slot count
    P1's kernel is built for, at batch 1 and 4, with and without messages
    (msg at every slot, padding included); TOL as above."""
    j, t, rng = _sized_sets(K, 70 + K)
    x = _sized_inputs(rng, t, B)
    x0 = _rand(rng, B, t.num_virt * K, H, scale=1.0)
    tail = [x[n] for n in ("w2", "b2", "ls", "lb")]
    msg_j, virt_j = jpe.edge_tail(x0, *tail, np.asarray(j.mask), K, True,
                                  with_messages)
    msg_t, virt_t = edge.edge_tail(torch.as_tensor(x0),
                                   *map(torch.as_tensor, tail), t.mask, K,
                                   with_messages=with_messages)
    np.testing.assert_allclose(virt_t.numpy(), np.asarray(virt_j), **TOL)
    if with_messages:
        np.testing.assert_allclose(msg_t.numpy(), np.asarray(msg_j), **TOL)
    else:
        assert msg_t is None and msg_j is None


@pytest.mark.parametrize("in_gather", [False, True])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", range(1, 9))
def test_edge_layer_sizes_match_jax(K, B, in_gather):
    """P3 plain == pallas_edge.edge_layer (interpret), both in_gather
    variants, at every slot count P3's kernel is built for and at batch 1
    and 4: edge_out at every slot (padding included) and virt; TOL as
    above."""
    j, t, rng = _sized_sets(K, 50 + K)
    x = _sized_inputs(rng, t, B)
    par = [x[n] for n in ("w_e", "b0", "w2", "b2", "ls", "lb")]
    senders = np.asarray(j.senders)
    gs = senders if in_gather else x["send_t"][:, senders]
    eo_j, virt_j = jpe.edge_layer(x["edge"], gs, x["send_t"], x["rec"],
                                  np.asarray(j.mask), *par, K, in_gather,
                                  True)
    eo_t, virt_t = edge.edge_layer(
        torch.as_tensor(x["edge"]), torch.as_tensor(x["send_t"]), t.senders,
        torch.as_tensor(x["rec"]), t.mask, *map(torch.as_tensor, par), K)
    np.testing.assert_allclose(virt_t.numpy(), np.asarray(virt_j), **TOL)
    np.testing.assert_allclose(eo_t.numpy(), np.asarray(eo_j), **TOL)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", range(1, 9))
def test_batched_matches_flat_layout(K, B):
    """The batched plain P2 and P3 equal the flat plain K2 and K3 after
    the (B, rows, h) <-> (rows, B*h) permutation, the mapping between the
    two layouts of the CUDA kernel template both share; at B = 1 the flat
    functions take the batched tensors as views. Tolerance: fp32
    rounding, atol = rtol = 1e-5 (the same arithmetic; the CPU's BLAS
    blocks the (B*M, h) and (M*B, h) products differently, and P3 adds b0
    after the sender and receiver terms where K3 adds it first; virt sums
    up to 8 unit-scale messages, values up to ~30, whose rounding reaches
    a few 1e-6)."""
    from neural_lam_tpu_torch.ops import edge_flat

    _, t, rng = _sized_sets(K, 60 + K)
    x = {k: torch.as_tensor(v) for k, v in _sized_inputs(rng, t, B).items()}
    n_virt = t.num_virt
    mask_p = t.mask.view(n_virt, K)
    tail = [x[n] for n in ("w2", "b2", "ls", "lb")]

    def flat(a):  # (B, rows, h) -> (rows, B*h)
        return a[0] if B == 1 else a.permute(1, 0, 2).reshape(a.shape[1], -1)

    if B == 1:
        assert flat(x["send_t"]).data_ptr() == x["send_t"].data_ptr()
    tol = dict(atol=1e-5, rtol=1e-5)
    _, virt_p2 = edge.edge_tail_sum_plain(x["send_t"], t.senders, x["ew"],
                                          x["rec"], *tail, t.mask, K,
                                          with_messages=False)
    virt_k2 = edge_flat.edge_tail_sum_flat_plain(
        flat(x["send_t"]), t.senders, x["ew"], flat(x["rec"]), mask_p, *tail)
    torch.testing.assert_close(flat(virt_p2), virt_k2, **tol)
    eo_p3, virt_p3 = edge.edge_layer_plain(
        x["edge"], x["send_t"], t.senders, x["rec"], t.mask, x["w_e"],
        x["b0"], *tail, K)
    eo_k3, virt_k3 = edge_flat.edge_layer_flat_plain(
        flat(x["edge"]), flat(x["send_t"]), t.senders, flat(x["rec"]),
        mask_p, x["w_e"], x["b0"], *tail)
    torch.testing.assert_close(flat(eo_p3), eo_k3, **tol)
    torch.testing.assert_close(flat(virt_p3), virt_k3, **tol)
