"""The bf16 training path of the port, kernel by kernel, against the JAX
package on the CPU.

Each backward on JAX's own inputs: `jax.vjp` of the JAX custom-VJP
function (its Pallas kernels in interpret mode) on bf16 inputs and a bf16
cotangent, against the port's autograd through its wrapper on the same
values (on the CPU the wrapper runs its plain version, which the bf16
instances on the card are held to by `chip_smoke.py`):

* B1 (the grid embedder) at d_in 56 and 128, with and without dx;
* B2 (g2m's tail) and B3/B4 (the processor edge layer) at K = 1, 3 and 8,
  the per-slot sender cotangent (JAX's d_gathered) and its fold onto the
  table (the scatter-free gather backward) included;
* B5/B6 (the fused decoder) at K = 1 and 4;
* P1-P3's recompute (the batched route's VJPs, which recompute through
  the JAX package's reference math), at K = 1, 3 and 8 (P2 and P3 at
  batch 1 and 2: K = 1 and 8 at batch 1, K = 3 and 8 at batch 2).

Limits: a bf16 gradient within one bf16 ulp of JAX's, fewer than 1% of
its elements not bit-equal (`assert_bf16_close`: the fp32 math of the two
sides rounds in another order, so a value next to a rounding boundary may
round the other way); where the gradient sums other bf16 gradients (the
sender fold of the per-slot d_x0, the batched route's bf16 scatter-add
and slot sums), within one ulp of each of its terms, since each term may
itself have rounded the other way (`summed_ulps`); P2's, which come out
of a chain of bf16 operations (its reference's x0 and silu, op by op,
where the two sides' exp differ in their last fp32 bit now and then),
within one ulp of the tensor's largest magnitude, as the forward tests
hold chained outputs (`assert_bf16_close(chained=True)`); an fp32 weight or
vector gradient within 1e-4 + 1e-4 x its largest magnitude, the fp32
tests' limit. B3's dW_e is where a port that summed the weight gradient
from the stored bf16 d_x0, not from its fp32 value, would fail.

JAX's batched-route VJPs (`pallas_edge.edge_tail_sum`, `edge_layer`) take
the bf16 cotangent of their bf16 output straight into `jax.vjp` of their
fp32-output reference, which this JAX version refuses (a dtype mismatch,
on any backend). The reference here is that VJP with the cotangents
widened to fp32 (exact), patched in as a new custom VJP over the JAX
module's own forward (`batched_reference`); nothing in the JAX package
changes. Its math, and the port's, is the reference's on the bf16
residuals: P2's x0 and silu in bf16 op by op, every bf16 gradient summed
over slots or batch elements one term after the other in bf16 (as XLA's
CPU reduces a bf16 array).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu.ops import pallas_edge as jpe
from neural_lam_tpu.ops import pallas_edge_flat as pef
from neural_lam_tpu.ops import pallas_embed as pe
from neural_lam_tpu.ops import pallas_grid_update as pgu
from neural_lam_tpu_torch.ops import edge, edge_flat, embed, grid_update

from .test_torch_port_bf16 import (
    BF, H, N_REC, N_SEND, _bf16, _f32, _j, _local_graph, _tail_params, _ulp,
    assert_bf16_close,
)

F32 = jnp.float32


def assert_grad_close(got, want, what):
    """An fp32 gradient: max abs diff <= 1e-4 + 1e-4 * max abs of JAX's."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-4 + 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs diff {err:.3e} > {tol:.3e}"


def summed_ulps(terms, index, n, dim):
    """One bf16 ulp of each term (JAX's values), summed as the terms are
    summed into a gradient: rows `index` of `terms` along `dim` added onto
    n rows. The limit of a gradient that sums bf16 gradients."""
    u = torch.as_tensor(_ulp(np.asarray(terms.astype(F32))))
    shape = list(u.shape)
    shape[dim] = n
    return torch.zeros(shape).index_add_(dim, torch.as_tensor(index), u)


def check(got, want, what, summed=None, chained=False):
    """A port gradient against JAX's: bf16 by `assert_bf16_close` (or, for
    a sum of bf16 terms, within `summed`, their ulps summed, where that is
    larger), fp32 by `assert_grad_close`, each in the other side's dtype."""
    if got.dtype == BF and chained:
        assert_bf16_close(got, want, what, chained=True)
    elif got.dtype == BF and summed is not None:
        g = got.float().numpy()
        w = np.asarray(want.astype(F32))
        assert g.shape == w.shape, (what, g.shape, w.shape)
        tol = np.maximum(np.maximum(_ulp(np.maximum(np.abs(g), np.abs(w))),
                                    2.0**-20 * np.abs(w).max()),
                         summed.numpy())
        worst = float((np.abs(g - w) / tol).max())
        share = float(np.mean(g != w))
        assert worst <= 1.0 and share < 0.01, (
            f"{what}: {share:.4%} of {g.size} elements not bit-equal, worst "
            f"gap {worst:.2f} x its limit")
    elif got.dtype == BF:
        assert_bf16_close(got, want, what)
    else:
        assert want.dtype == F32, (what, want.dtype)
        assert_grad_close(got, want, what)


def leaves(*tensors):
    return [t.detach().clone().requires_grad_() for t in tensors]


def folded_ulps(edges, d_slots_j):
    """`summed_ulps` of the sender fold: JAX's per-slot d_gathered onto
    the sender table, real slots only."""
    real = edges.mask[:, 0].numpy() > 0
    return summed_ulps(d_slots_j[real], edges.senders.numpy()[real],
                       edges.num_send, 0)


def capturing_fold(edges, captured):
    """The edge set's fold, keeping the per-slot cotangent it receives."""
    def fold(d_slots):
        captured.append(d_slots)
        return edges.fold_senders(d_slots)

    return fold


# --- the batched route's reference VJPs, with widened cotangents ----------


def _widened(g, shape):
    return jnp.zeros(shape, F32) if g is None else g.astype(F32)


def _tail_sum_bwd(K, interpret, with_messages, res, grads):
    gathered, ew, rec_rows, w2, b2, ls, lb, mask = res
    g_msg = _widened(grads[0] if with_messages else None, gathered.shape)
    _, vjp = jax.vjp(lambda *a: jpe._sum_reference(*a, K), gathered, ew,
                     rec_rows, w2, b2, ls, lb, mask)
    return vjp((g_msg, grads[1].astype(F32)))


def _tail_bwd(K, interpret, with_messages, res, grads):
    x0 = res[0]
    g_msg = _widened(grads[0] if with_messages else None, x0.shape)
    _, vjp = jax.vjp(lambda *a: jpe._tail_reference(*a, K), *res)
    return vjp((g_msg, grads[1].astype(F32)))


def _layer_bwd(K, in_gather, interpret, res, grads):
    g_edge, g_virt = grads
    edge_rep = res[0]
    n_virt = edge_rep.shape[-2] // K
    g_edge = _widened(g_edge, edge_rep.shape)
    g_virt = _widened(g_virt, edge_rep.shape[:-2] + (n_virt, H))
    return jpe._edge_layer_bwd(K, in_gather, interpret, res, (g_edge, g_virt))


def _custom(fun, nondiff, fwd, bwd):
    f = jax.custom_vjp(fun, nondiff_argnums=nondiff)
    f.defvjp(fwd, bwd)
    return f


@contextlib.contextmanager
def batched_reference(mp=None):
    """The JAX module's batched-route VJPs with their cotangents widened
    to fp32 (module doc), patched in for the block."""
    with contextlib.ExitStack() as stack:
        if mp is None:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
        mp.setattr(jpe, "edge_tail_sum", _custom(
            jpe.edge_tail_sum.fun, (8, 9, 10), jpe._edge_tail_sum_fwd,
            _tail_sum_bwd))
        mp.setattr(jpe, "edge_tail", _custom(
            jpe.edge_tail.fun, (6, 7, 8), jpe._edge_tail_fwd, _tail_bwd))
        mp.setattr(jpe, "_edge_layer_vjp", _custom(
            jpe._edge_layer_vjp.fun, (11, 12, 13), jpe._edge_layer_fwd,
            _layer_bwd))
        yield mp


# --- B1 ------------------------------------------------------------------


@pytest.mark.parametrize("need_dx", [True, False], ids=["dx", "no_dx"])
@pytest.mark.parametrize("d_in", [56, 128])
def test_b1_bf16_matches_jax(d_in, need_dx):
    """B1: bf16 x and d_out; d_x bf16 (when asked), the weight and vector
    gradients fp32, batch 2 on 256 nodes."""
    rng = np.random.default_rng(d_in + need_dx)
    N, B = N_REC, 2
    x = _bf16(rng, N, B, d_in, scale=1.0)
    par = [_f32(rng, d_in, H, scale=0.2), _f32(rng, H), _f32(rng, H, H),
           _f32(rng, H), 1 + _f32(rng, H, scale=0.1), _f32(rng, H, scale=0.1)]
    ct = _bf16(rng, N, B * H, scale=1.0)
    m = 128 // B
    d_pad = -(-d_in // m) * m
    x_pad = torch.nn.functional.pad(x, (0, d_pad - d_in)).reshape(N, -1)

    def fn(x_pad, w0, b0, w1, b1, ls, lb):
        params = {"layers": [{"w": w0, "b": b0}, {"w": w1, "b": b1}],
                  "ln": {"scale": ls, "bias": lb}}
        return pe.embed_grid_flat(x_pad, params, B, d_pad, interpret=True,
                                  out_dtype=jnp.bfloat16)

    out_j, vjp = jax.vjp(fn, _j(x_pad), *map(_j, par))
    g_j = vjp(_j(ct))
    xt = x.reshape(N, -1).requires_grad_(need_dx)
    pt = leaves(*par)
    out = embed.embed_grid_flat(xt, *pt, B)
    assert out.dtype == BF
    out.backward(ct)
    if need_dx:
        d_x_j = g_j[0].reshape(N, B, d_pad)[..., :d_in].reshape(N, -1)
        check(xt.grad, d_x_j, f"B1 d_in {d_in} d_x")
    else:
        assert xt.grad is None
    for name, leaf, want in zip(("w0", "b0", "w1", "b1", "ls", "lb"), pt,
                                g_j[1:]):
        check(leaf.grad, want, f"B1 d_in {d_in} {name}")


# --- B2, B3/B4 -----------------------------------------------------------


def _flat_case(K, seed, B=2):
    rng = np.random.default_rng(seed)
    j, t = _local_graph(K, rng)
    n_virt = t.num_virt
    M = n_virt * K
    x = dict(table=_bf16(rng, N_SEND, B * H), ew=_bf16(rng, M, H),
             rec=_bf16(rng, n_virt, B * H), edge=_bf16(rng, M, B * H),
             ct_v=_bf16(rng, n_virt, B * H, scale=1.0),
             ct_e=_bf16(rng, M, B * H, scale=1.0))
    mask = t.mask.view(n_virt, K)
    # the cotangents of padding slots and padding virtual rows are zero in
    # the model (gather_send_flat's contract)
    x["ct_e"] = x["ct_e"] * t.mask.to(BF)
    return rng, j, t, x, mask, _tail_params(rng)


@pytest.mark.parametrize("K", [1, 3, 8])
def test_b2_bf16_matches_jax(K):
    """B2 and the fold of its table gradient: the per-slot d_x0 (JAX's
    d_gathered), d_table, d_ew and d_rec_rows bf16; d_w2, d_b2 and the
    LayerNorm's fp32."""
    rng, j, t, x, mask, p = _flat_case(K, 60 + K)
    names = ("w2", "b2", "ls", "lb")
    mask_j = _j(mask)

    def fn(delta, table, ew, rec, w2, b2, ls, lb):
        g = jmp.gather_send_flat(table, j) + delta
        _, virt = pef.edge_tail_sum_flat(g, ew, rec, w2, b2, ls, lb, mask_j,
                                         K, interpret=True)
        return virt

    zero = jnp.zeros((t.num_virt * K, x["table"].shape[1]), jnp.bfloat16)
    _, vjp = jax.vjp(fn, zero, _j(x["table"]), _j(x["ew"]), _j(x["rec"]),
                     *(_j(p[k]) for k in names))
    g_j = vjp(_j(x["ct_v"]))
    tl = leaves(x["table"], x["ew"], x["rec"], *(p[k] for k in names))
    slots = []
    virt = edge_flat.edge_tail_sum_flat(
        tl[0], t.senders, tl[1], tl[2], mask, *tl[3:],
        fold=capturing_fold(t, slots))
    virt.backward(x["ct_v"])
    check(slots[0], g_j[0], f"B2 K={K} d_x0 per slot")
    check(tl[0].grad, g_j[1], f"B2 K={K} table", folded_ulps(t, g_j[0]))
    for name, leaf, want in zip(("ew", "rec") + names, tl[1:], g_j[2:]):
        check(leaf.grad, want, f"B2 K={K} {name}")


@pytest.mark.parametrize("K", [1, 3, 8])
def test_b3_bf16_matches_jax(K):
    """B3/B4 with both cotangents: the per-slot d_x0, d_table (B4's fold),
    d_edge and d_rec_rows bf16; d_w_e (summed from the fp32 d_x0), d_b0,
    d_w2, d_b2 and the LayerNorm's fp32."""
    rng, j, t, x, mask, p = _flat_case(K, 70 + K)
    names = ("w_e", "b0", "w2", "b2", "ls", "lb")
    mask_j = _j(mask)

    def fn(delta, edge_rep, table, rec, w_e, b0, w2, b2, ls, lb):
        g = jmp.gather_send_flat(table, j) + delta
        return pef.edge_layer_flat(edge_rep, g, rec, mask_j, w_e, b0, w2, b2,
                                   ls, lb, K, interpret=True)

    zero = jnp.zeros(x["edge"].shape, jnp.bfloat16)
    _, vjp = jax.vjp(fn, zero, _j(x["edge"]), _j(x["table"]), _j(x["rec"]),
                     *(_j(p[k]) for k in names))
    g_j = vjp((_j(x["ct_e"]), _j(x["ct_v"])))
    tl = leaves(x["edge"], x["table"], x["rec"], *(p[k] for k in names))
    slots = []
    eo, virt = edge_flat.edge_layer_flat(
        tl[0], tl[1], t.senders, tl[2], mask, *tl[3:],
        fold=capturing_fold(t, slots))
    torch.autograd.backward([eo, virt], [x["ct_e"], x["ct_v"]])
    check(slots[0], g_j[0], f"B3 K={K} d_x0 per slot")
    check(tl[1].grad, g_j[2], f"B3 K={K} table", folded_ulps(t, g_j[0]))
    for name, leaf, want in zip(("edge", "rec") + names, tl[:1] + tl[2:],
                                g_j[1:2] + g_j[3:]):
        check(leaf.grad, want, f"B3 K={K} {name}")


def test_b3_dwe_takes_the_fp32_d_x0():
    """B3's dW_e pair: the bf16 edge state with the chain's fp32 d_x0.
    Taken from the d_x0 stored in bf16 instead, dW_e misses JAX's by more
    than the fp32 limit: the check above would see it."""
    K = 8
    rng, _, t, x, mask, p = _flat_case(K, 78)
    args = (x["edge"], x["table"], t.senders, x["rec"], mask,
            *(p[k] for k in ("w_e", "b0", "w2", "b2", "ls", "lb")),
            x["ct_e"], x["ct_v"])
    _, d_x0, _, _, pairs = edge_flat.edge_layer_bwd_chain(*args)
    (xe, d_e), = pairs[1:]
    assert xe.dtype == BF and d_e.dtype == torch.float32
    assert d_x0.dtype == BF
    torch.testing.assert_close(d_e.reshape(d_x0.shape).to(BF), d_x0,
                               rtol=0, atol=0)
    good = xe.float().t() @ d_e
    bad = xe.float().t() @ d_x0.float().reshape(d_e.shape)
    tol = 1e-4 + 1e-4 * float(good.abs().max())
    assert float((good - bad).abs().max()) > tol


# --- B5/B6 ---------------------------------------------------------------


def _decoder_params(rng, d_out):
    return {k: _f32(rng, *s, scale=0.1) + (1.0 if k.endswith("_ls") else 0.0)
            for k, s in (("w_i", (H, H)), ("w2", (H, H)), ("b2", (H,)),
                         ("e_ls", (H,)), ("e_lb", (H,)), ("enc_w0", (H, H)),
                         ("enc_b0", (H,)), ("enc_w1", (H, H)),
                         ("enc_b1", (H,)), ("enc_ls", (H,)), ("enc_lb", (H,)),
                         ("a_w0", (2 * H, H)), ("a_b0", (H,)),
                         ("a_w1", (H, H)), ("a_b1", (H,)), ("a_ls", (H,)),
                         ("a_lb", (H,)), ("o_w0", (H, H)), ("o_b0", (H,)),
                         ("o_w1", (H, d_out)), ("o_b1", (d_out,)))}


@pytest.mark.parametrize("K", [1, 4])
def test_b5_bf16_matches_jax(K):
    """B5/B6: the per-slot d_x0, d_table (B6's fold), d_ew and
    d_grid_emb_f bf16 (real rows only); all 21 decoder parameters' fp32
    (enc_w0's pair on the bf16 grid embeddings), batch 2, 17 outputs."""
    rng = np.random.default_rng(80 + K)
    n_rec = 300
    j, t = _local_graph(K, rng, n_rec=n_rec, spread=2)
    assert t.virt_identity and t.num_virt > n_rec
    B, n_virt, d_out = 2, t.num_virt, 17
    M = n_virt * K
    table, ew = _bf16(rng, N_SEND, B * H), _bf16(rng, M, H)
    ge = _bf16(rng, n_rec, B * H)
    pp = _decoder_params(rng, d_out)
    ct = _bf16(rng, n_virt, B * d_out, scale=1.0)
    mask = t.mask.view(n_virt, K)
    mask_j = _j(mask)

    def fn(delta, table, ew, ge, pp):
        g = jmp.gather_send_flat(table, j) + delta
        return pgu.grid_update_flat(g, ew, ge, mask_j, pp, K, interpret=True)

    _, vjp = jax.vjp(fn, jnp.zeros((M, B * H), jnp.bfloat16), _j(table),
                     _j(ew), _j(ge), {k: _j(v) for k, v in pp.items()})
    g_j = vjp(_j(ct))
    tl = leaves(table, ew, ge)
    pt = {k: v.clone().requires_grad_() for k, v in pp.items()}
    slots = []
    out = grid_update.grid_update_flat(tl[0], t.senders, tl[1], tl[2], mask,
                                       pt, fold=capturing_fold(t, slots))
    out.backward(ct)
    check(slots[0], g_j[0], f"B5 K={K} d_x0 per slot")
    check(tl[0].grad, g_j[1], f"B5 K={K} table", folded_ulps(t, g_j[0]))
    for name, leaf, want in zip(("ew", "ge"), tl[1:], g_j[2:4]):
        check(leaf.grad, want, f"B5 K={K} {name}")
    for k, v in pt.items():
        check(v.grad, g_j[4][k], f"B5 K={K} {k}")


# --- P1-P3: the batched route's recompute -------------------------------


def batched_ulps(d_slots_j, senders, K):
    """`summed_ulps` of the batched route's sums of JAX's per-slot
    d_gathered (B, M, h) in bf16: onto the sender table (the gather's
    scatter-add), over each row's K slots (d_rec_rows) and over the batch
    (a shared ew's d_ew)."""
    M = d_slots_j.shape[1]
    return dict(
        send_t=summed_ulps(d_slots_j, senders, N_SEND, 1),
        rec=summed_ulps(d_slots_j, np.arange(M) // K, M // K, 1),
        ew=summed_ulps(d_slots_j, np.zeros(d_slots_j.shape[0], np.int64), 1,
                       0)[0])


def _batched_case(K, B, seed):
    rng = np.random.default_rng(seed)
    j, t = _local_graph(K, rng)
    n_virt, M = t.num_virt, t.num_virt * K
    x = dict(send=_bf16(rng, B, N_SEND, H), ew=_bf16(rng, M, H),
             rec=_bf16(rng, B, n_virt, H), edge=_bf16(rng, B, M, H),
             x_e=_f32(rng, B, M, H), ct_v=_bf16(rng, B, n_virt, H, scale=1.0),
             ct_e=_bf16(rng, B, M, H, scale=1.0))
    return j, t, x, _tail_params(rng)


# (K, batch) pairs of the P2 and P3 cases: every K of the module doc at
# one batch size or both
KB = [(1, 1), (8, 1), (3, 2), (8, 2)]


@pytest.mark.parametrize("K,B", KB)
def test_p2_bf16_recompute_matches_jax(K, B):
    """P2's VJP, recomputed on its bf16 residuals: d_send_t (through the
    bf16 gather's scatter-add), d_ew, d_rec_rows bf16; the tail's
    parameters fp32."""
    j, t, x, p = _batched_case(K, B, 90 + K + B)
    names = ("w2", "b2", "ls", "lb")
    senders = np.asarray(j.senders)

    def fn(delta, send, ew, rec, w2, b2, ls, lb):
        g = jnp.take(send, senders, axis=1) + delta
        return jpe.edge_tail_sum(g, ew, rec, w2, b2, ls, lb,
                                 np.asarray(j.mask), K, True, False)[1]

    with batched_reference():
        _, vjp = jax.vjp(fn, jnp.zeros(x["edge"].shape, jnp.bfloat16),
                         _j(x["send"]), _j(x["ew"]), _j(x["rec"]),
                         *(_j(p[k]) for k in names))
        _, *g_j = vjp(_j(x["ct_v"]))
    tl = leaves(x["send"], x["ew"], x["rec"], *(p[k] for k in names))
    _, virt = edge.edge_tail_sum(tl[0], t.senders, tl[1], tl[2], *tl[3:],
                                 t.mask, K, with_messages=False)
    virt.backward(x["ct_v"])
    for name, leaf, want in zip(("send_t", "ew", "rec") + names, tl, g_j):
        check(leaf.grad, want, f"P2 K={K} B={B} {name}", chained=True)


@pytest.mark.parametrize("K,B", KB)
def test_p3_bf16_recompute_matches_jax(K, B):
    """P3's VJP (the pre-gathered variant the model takes), recomputed on
    its bf16 residuals: d_edge_rep, d_send_t and d_rec_rows bf16; the
    layer's parameters fp32."""
    j, t, x, p = _batched_case(K, B, 100 + K + B)
    names = ("w_e", "b0", "w2", "b2", "ls", "lb")
    senders = np.asarray(j.senders)

    def fn(delta, edge_rep, send, rec, *par):
        gs = jnp.take(send, senders, axis=1) + delta
        return jpe.edge_layer(edge_rep, gs, send, rec, np.asarray(j.mask),
                              *par, K, False, True)

    with batched_reference():
        _, vjp = jax.vjp(fn, jnp.zeros(x["edge"].shape, jnp.bfloat16),
                         _j(x["edge"]), _j(x["send"]), _j(x["rec"]),
                         *(_j(p[k]) for k in names))
        d_slots, *g_j = vjp((_j(x["ct_e"]), _j(x["ct_v"])))
    summed = batched_ulps(d_slots, senders, K)
    # d_edge = ct_e + t, t = d_x0 @ w_e^T rounded: one ulp of t (|t| at
    # most |d_edge - ct_e| and half an ulp of d_edge) and one of the sum
    d_e = np.asarray(g_j[0].astype(F32))
    term = np.abs(d_e - x["ct_e"].float().numpy()) + _ulp(d_e) / 2
    summed["edge"] = torch.as_tensor(_ulp(term) + _ulp(d_e))
    tl = leaves(x["edge"], x["send"], x["rec"], *(p[k] for k in names))
    eo, virt = edge.edge_layer(tl[0], tl[1], t.senders, tl[2], t.mask,
                               *tl[3:], K)
    assert eo.dtype == BF and virt.dtype == BF
    torch.autograd.backward([eo, virt], [x["ct_e"], x["ct_v"]])
    for name, leaf, want in zip(("edge", "send_t", "rec") + names, tl, g_j):
        check(leaf.grad, want, f"P3 K={K} B={B} {name}", summed.get(name))


@pytest.mark.parametrize("K", [1, 3, 8])
def test_p1_bf16_recompute_matches_jax(K):
    """P1 in the bf16 path (HiLAM's read-out): x0 = x_e (fp32) + the bf16
    gathered sender rows + the bf16 rec_rows repeated, fp32 by promotion,
    and P1's fp32 tail; d_send_t and d_rec_rows bf16 (the repeat's
    gradient summed in bf16), d_x_e and the tail's parameters fp32."""
    B = 2
    j, t, x, p = _batched_case(K, B, 110 + K)
    names = ("w2", "b2", "ls", "lb")
    senders = np.asarray(j.senders)
    ct_v = x["ct_v"].float()

    def fn(delta, x_e, send, rec, *par):
        x0 = (x_e + (jnp.take(send, senders, axis=1) + delta)
              + jnp.repeat(rec, K, axis=-2))
        return jpe.edge_tail(x0, *par, np.asarray(j.mask), K, True, False)[1]

    with batched_reference():
        _, vjp = jax.vjp(fn, jnp.zeros(x["edge"].shape, jnp.bfloat16),
                         _j(x["x_e"]), _j(x["send"]), _j(x["rec"]),
                         *(_j(p[k]) for k in names))
        d_slots, *g_j = vjp(_j(ct_v))
    summed = batched_ulps(d_slots, senders, K)
    tl = leaves(x["x_e"], x["send"], x["rec"], *(p[k] for k in names))
    x0 = edge.sum_x0(tl[0], tl[1], t.senders, tl[2], K)
    assert x0.dtype == torch.float32
    _, virt = edge.edge_tail(x0, *tl[3:], t.mask, K, with_messages=False)
    virt.backward(ct_v)
    for name, leaf, want in zip(("x_e", "send_t", "rec") + names, tl, g_j):
        check(leaf.grad, want, f"P1 K={K} {name}", summed.get(name))


# --- B4's and B6's window layout: the deliberate deviation ---------------


def _window_case(which):
    """(port d_table, JAX's windowed d_table, JAX's un-windowed d_table,
    JAX's per-slot d_gathered, the port's edge set) for B4 (the processor
    layer, K=8) or B6 (the decoder, K=4) on local graphs whose window
    layout (`prep_window_gather`) has fold arrays."""
    if which == "B4":
        rng = np.random.default_rng(2)
        B, n = 2, 400
        j, t = _local_graph(8, rng, n_send=n, n_rec=n)
        K, nv = t.dense_k, t.num_virt
        p = _tail_params(rng)
        par = tuple(p[k] for k in ("w_e", "b0", "w2", "b2", "ls", "lb"))
        edge_rep, table = _bf16(rng, nv * K, B * H), _bf16(rng, n, B * H)
        rec = _bf16(rng, nv, B * H)
        cts = (_bf16(rng, nv * K, B * H, scale=1.0) * t.mask.to(BF),
               _bf16(rng, nv, B * H, scale=1.0))
        target, n_send = 128, n
    else:
        rng = np.random.default_rng(3)
        B, K, n_send, n_rec = 2, 4, 60, 300
        j, t = _local_graph(K, rng, n_send=n_send, n_rec=n_rec, spread=2)
        nv = t.num_virt
        table, ew = _bf16(rng, n_send, B * H), _bf16(rng, nv * K, H)
        ge = _bf16(rng, n_rec, B * H)
        pp = _decoder_params(rng, 9)
        cts = (_bf16(rng, nv, B * 9, scale=1.0),)
        target = 64
    mask = np.asarray(j.mask)
    mask_j = jnp.asarray(mask.reshape(nv, K))
    arrays, static = pgu.prep_window_gather(np.asarray(j.senders), mask, nv,
                                            K, n_send, target_rows=target)
    assert "fold_slots" in arrays
    win = (arrays, static["wrows"], static["tile_v"])
    tl = table.clone().requires_grad_()
    if which == "B4":
        pj = [_j(x) for x in par]
        d_win = pef.edge_layer_flat_win_bwd(
            _j(edge_rep), _j(table), _j(rec), mask_j, *pj, K, *win,
            tuple(map(_j, cts)), interpret=True)[1]

        def fn(delta, table):
            g = jmp.gather_send_flat(table, j) + delta
            return pef.edge_layer_flat(_j(edge_rep), g, _j(rec), mask_j, *pj,
                                       K, interpret=True)

        out = edge_flat.edge_layer_flat(edge_rep, tl, t.senders, rec,
                                        t.mask.view(nv, K), *par,
                                        fold=t.fold_senders)
    else:
        ppj = {k: _j(v) for k, v in pp.items()}
        d_win = pgu.grid_update_flat_win_bwd(
            _j(table), _j(ew), _j(ge), mask_j, ppj, K, *win, _j(cts[0]),
            interpret=True)[0]

        def fn(delta, table):
            g = jmp.gather_send_flat(table, j) + delta
            return pgu.grid_update_flat(g, _j(ew), _j(ge), mask_j, ppj, K,
                                        interpret=True)

        out = grid_update.grid_update_flat(tl, t.senders, ew, ge,
                                           t.mask.view(nv, K), pp,
                                           fold=t.fold_senders)
    _, vjp = jax.vjp(fn, jnp.zeros((nv * K, B * H), jnp.bfloat16),
                     _j(table))
    d_slots, d_gathered_route = vjp(tuple(map(_j, cts)) if which == "B4"
                                    else _j(cts[0]))
    torch.autograd.backward(list(out) if which == "B4" else [out], list(cts))
    return tl.grad, d_win, d_gathered_route, d_slots, t


@pytest.mark.parametrize("which", ["B4", "B6"])
def test_window_rounding_is_jax_own_route_gap(which):
    """Where JAX's windowed backward (B4's, B6's) rounds each tile's
    window partial sum to bf16 before folding, the port, which has no
    window layout, rounds each slot's d_x0 (the un-windowed route's
    d_gathered) and folds in fp32. The port's table gradient equals JAX's
    un-windowed route's (under 1% not bit-equal, within one bf16 ulp of
    each summed slot gradient), and differs from the windowed route's as
    JAX's two routes differ from each other: the same share of elements
    (10.6% at B4's layout, 35.4% at B6's here), each within 1.5 bf16 ulps
    of the summed slot gradients (a sum that cancels is off by up to ~250
    ulps of its own)."""
    got, d_win, d_route, d_slots, t = _window_case(which)
    fold = folded_ulps(t, d_slots)
    check(got, d_route, f"{which} d_table vs the un-windowed route", fold)
    g = got.float().numpy()
    w = np.asarray(d_win.astype(F32))
    r = np.asarray(d_route.astype(F32))
    share, share_jax = np.mean(g != w), np.mean(r != w)
    assert abs(share - share_jax) < 0.01, (which, share, share_jax)
    tol = np.maximum(_ulp(np.maximum(np.abs(g), np.abs(w))), fold.numpy())
    assert (np.abs(g - w) / tol).max() <= 1.5, which
