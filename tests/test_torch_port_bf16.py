"""The bf16 forecast path of the port, ops and kernels, against the JAX
package on the CPU.

Kernels: the plain versions of K1, K2, K3, K4, P2 and P3 on bf16 inputs
(the port's bf16 instances compute what their plain versions compute: fp32
math on the bf16 inputs, outputs rounded to nearest even) against the JAX
Pallas kernels run in interpret mode on the same bf16 values, at 16x16-
graph sizes (K2-K4, P2 and P3 at K = 1, 3 and 8 on local graphs of that
in-degree). Both sides store their outputs in bf16. Limit: every element
within one bf16 ulp of the JAX value, and fewer than 1% of the elements
not bit-equal: the fp32 math of the two sides rounds in another order
(LayerNorm statistics, slot sums, the JAX kernels' folded LayerNorm
centring), so an output whose fp32 value lies that close to a bf16
rounding boundary may round the other way. Where a slot sum cancels to
near zero, one ulp of the result is smaller than the fp32 error of the
sum, and the element is held to that error (2^-20 of the tensor's largest
magnitude) instead.

Ops: the rounding rules of the JAX package's bf16 call sites (`mlp.mm`,
`apply_mlp`, the node transforms, the folds), and the wrappers: a bf16
tensor takes the plain version on the CPU, a gradient through a bf16
forward runs there (the backward kernels' bf16 instances are held against
JAX in tests/test_torch_port_bf16_train*.py), `_build.pointers` holds
bf16 as strictly as float32, and P1 stays fp32 in a HiLAM bf16 step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu.ops import mlp as jmlp
from neural_lam_tpu.ops import pallas_edge as jpe
from neural_lam_tpu.ops import pallas_edge_flat as pef
from neural_lam_tpu.ops import pallas_embed as pe
from neural_lam_tpu.ops import pallas_grid_update as pgu
from neural_lam_tpu.ops.message_passing import EdgeSet as JEdgeSet
from neural_lam_tpu_torch import entry
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.ops import _build, edge, edge_flat, embed
from neural_lam_tpu_torch.ops import grid_update, weight_grad
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops import mlp as tmlp
from neural_lam_tpu_torch.ops.message_passing import EdgeSet

H = 64
BF = torch.bfloat16
# 16x16 grid nodes receiving from 81 mesh nodes
N_REC, N_SEND = 256, 81


def _bf16(rng, *shape, scale=0.3):
    """A bf16 tensor drawn from the numpy generator (rounded to nearest
    even from fp32)."""
    return torch.as_tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(BF)


def _f32(rng, *shape, scale=0.3):
    return torch.as_tensor((rng.standard_normal(shape) * scale)
                           .astype(np.float32))


def _j(t):
    """The same values for the JAX side, in the tensor's dtype."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == BF else a


def _ulp(x):
    """One bf16 ulp of |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


def assert_bf16_close(got, want, what, chained=False):
    """got (torch) and want (JAX) both bf16; every element within one bf16
    ulp, fewer than 1% not bit-equal (see the module doc). An element
    where a sum cancels to near zero is held to the fp32 error of that
    sum instead, 2^-20 of the tensor's largest magnitude, where that is
    larger than its ulp.

    chained: the output of several stored-in-bf16 steps (an MLP): where an
    intermediate rounds the other way, the rest of its row moves by an ulp
    or two of the row's scale, so each element is held to one ulp of the
    tensor's largest magnitude (the share limit stays)."""
    assert got.dtype == BF, (what, got.dtype)
    assert want.dtype == jnp.bfloat16, (what, want.dtype)
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape, (what, g.shape, w.shape)
    tol = np.maximum(_ulp(np.maximum(np.abs(g), np.abs(w))),
                     2.0**-20 * np.abs(w).max())
    if chained:
        tol = np.maximum(tol, _ulp(np.abs(w).max()))
    worst = float((np.abs(g - w) / tol).max())
    share = float(np.mean(g != w))
    msg = (f"{what}: {share:.4%} of {g.size} elements not bit-equal, "
           f"worst gap {worst:.2f} x its limit")
    assert worst <= 1.0 and share < 0.01, msg


def _local_graph(K, rng, n_send=N_SEND, n_rec=N_REC, spread=3):
    """Receiver r takes K senders near r * n_send / n_rec."""
    centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
    senders = np.clip(centre + rng.integers(-spread, spread + 1, (n_rec, K)),
                      0, n_send - 1).reshape(-1)
    receivers = np.repeat(np.arange(n_rec), K)
    feats = rng.standard_normal((n_rec * K, 3)).astype(np.float32)
    j = JEdgeSet.from_local(senders, receivers, feats, n_send, n_rec,
                            dense=True)
    t = EdgeSet.from_local(senders, receivers, feats, n_send, n_rec,
                           device="cpu")
    assert t.dense_k == K
    return j, t


def _tail_params(rng):
    return dict(w_e=_f32(rng, H, H, scale=0.2), b0=_f32(rng, H, scale=0.2),
                w2=_f32(rng, H, H, scale=0.2), b2=_f32(rng, H, scale=0.2),
                ls=1 + _f32(rng, H, scale=0.1), lb=_f32(rng, H, scale=0.1))


@pytest.mark.parametrize("d_in", [23, 56])
def test_k1_bf16_matches_jax(d_in):
    """K1: a bf16 x_f (the grid inputs rounded) in, bf16 out (the JAX
    kernel's out_dtype), batch 2, on 256 nodes (the Pallas tiles divide
    them: the kernel runs in interpret mode)."""
    rng = np.random.default_rng(d_in)
    N, B = N_REC, 2
    x = _bf16(rng, N, B, d_in, scale=1.0)
    p = dict(w0=_f32(rng, d_in, H), b0=_f32(rng, H), w1=_f32(rng, H, H),
             b1=_f32(rng, H), ls=1 + _f32(rng, H, scale=0.1),
             lb=_f32(rng, H, scale=0.1))
    m = 128 // B
    d_pad = -(-d_in // m) * m
    x_pad = torch.nn.functional.pad(x, (0, d_pad - d_in)).reshape(N, -1)
    params = {"layers": [{"w": _j(p["w0"]), "b": _j(p["b0"])},
                         {"w": _j(p["w1"]), "b": _j(p["b1"])}],
              "ln": {"scale": _j(p["ls"]), "bias": _j(p["lb"])}}
    out_j = pe.embed_grid_flat(_j(x_pad), params, B, d_pad, interpret=True,
                               out_dtype=jnp.bfloat16)
    with torch.no_grad():
        out_t = embed.embed_grid_flat(x.reshape(N, -1), p["w0"], p["b0"],
                                      p["w1"], p["b1"], p["ls"], p["lb"], B)
    assert_bf16_close(out_t, out_j, f"K1 d_in {d_in}")


@pytest.mark.parametrize("K", [1, 3, 8])
def test_k2_bf16_matches_jax(K):
    """K2 (g2m's tail + slot sum): bf16 table, ew and rec_rows, bf16
    virt, batch 2."""
    rng = np.random.default_rng(10 + K)
    j, t = _local_graph(K, rng)
    B, n_virt = 2, t.num_virt
    table = _bf16(rng, N_SEND, B * H)
    ew = _bf16(rng, n_virt * K, H)
    rec = _bf16(rng, n_virt, B * H)
    p = _tail_params(rng)
    mask_p = t.mask.view(n_virt, K)
    _, virt_j = pef.edge_tail_sum_flat(
        _j(table)[np.asarray(j.senders)], _j(ew), _j(rec), _j(p["w2"]),
        _j(p["b2"]), _j(p["ls"]), _j(p["lb"]), _j(mask_p), K, True, False)
    with torch.no_grad():
        virt_t = edge_flat.edge_tail_sum_flat(
            table, t.senders, ew, rec, mask_p, p["w2"], p["b2"], p["ls"],
            p["lb"])
    assert_bf16_close(virt_t, virt_j, f"K2 K={K}")


@pytest.mark.parametrize("K", [1, 3, 8])
def test_k3_bf16_matches_jax(K):
    """K3 (processor edge layer): bf16 edge state, table and rec_rows,
    bf16 edge_out and virt, batch 2."""
    rng = np.random.default_rng(20 + K)
    j, t = _local_graph(K, rng)
    B, n_virt = 2, t.num_virt
    edge_rep = _bf16(rng, n_virt * K, B * H)
    table = _bf16(rng, N_SEND, B * H)
    rec = _bf16(rng, n_virt, B * H)
    p = _tail_params(rng)
    mask_p = t.mask.view(n_virt, K)
    eo_j, virt_j = pef.edge_layer_flat(
        _j(edge_rep), _j(table)[np.asarray(j.senders)], _j(rec),
        _j(mask_p), *(_j(p[k]) for k in ("w_e", "b0", "w2", "b2", "ls",
                                         "lb")), K, True)
    with torch.no_grad():
        eo_t, virt_t = edge_flat.edge_layer_flat(
            edge_rep, table, t.senders, rec, mask_p,
            *(p[k] for k in ("w_e", "b0", "w2", "b2", "ls", "lb")))
    assert_bf16_close(eo_t, eo_j, f"K3 K={K} edge_out")
    assert_bf16_close(virt_t, virt_j, f"K3 K={K} virt")


@pytest.mark.parametrize("K", [1, 3, 8])
def test_k4_bf16_matches_jax(K):
    """K4 (the fused decoder): bf16 gathered rows, ew and grid
    embeddings, bf16 output (17 state features), batch 2."""
    rng = np.random.default_rng(30 + K)
    j, t = _local_graph(K, rng, spread=2)
    assert t.virt_identity
    B, n_virt, d_out = 2, t.num_virt, 17
    table = _bf16(rng, N_SEND, B * H)
    ew = _bf16(rng, n_virt * K, H)
    ge = _bf16(rng, N_REC, B * H)
    pp = {k: _f32(rng, *s, scale=0.1) + (1.0 if k.endswith("_ls") else 0.0)
          for k, s in (("w_i", (H, H)), ("w2", (H, H)), ("b2", (H,)),
                       ("e_ls", (H,)), ("e_lb", (H,)), ("enc_w0", (H, H)),
                       ("enc_b0", (H,)), ("enc_w1", (H, H)),
                       ("enc_b1", (H,)), ("enc_ls", (H,)), ("enc_lb", (H,)),
                       ("a_w0", (2 * H, H)), ("a_b0", (H,)),
                       ("a_w1", (H, H)), ("a_b1", (H,)), ("a_ls", (H,)),
                       ("a_lb", (H,)), ("o_w0", (H, H)), ("o_b0", (H,)),
                       ("o_w1", (H, d_out)), ("o_b1", (d_out,)))}
    mask_p = t.mask.view(n_virt, K)
    out_j = pgu.grid_update_flat(
        _j(table)[np.asarray(j.senders)], _j(ew), _j(ge), _j(mask_p),
        {k: _j(v) for k, v in pp.items()}, K, interpret=True)
    with torch.no_grad():
        out_t = grid_update.grid_update_flat(table, t.senders, ew, ge,
                                             mask_p, pp)
    assert_bf16_close(out_t[:N_REC], out_j[:N_REC], f"K4 K={K}")


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_p2_bf16_matches_jax(K, B):
    """P2 (batched tail + slot sum): bf16 node table, ew and rec_rows;
    bf16 messages and virt."""
    rng = np.random.default_rng(40 + K + B)
    j, t = _local_graph(K, rng)
    n_virt, M = t.num_virt, t.num_virt * K
    send_t = _bf16(rng, B, N_SEND, H)
    ew = _bf16(rng, M, H)
    rec = _bf16(rng, B, n_virt, H)
    p = _tail_params(rng)
    tail = ("w2", "b2", "ls", "lb")
    msg_j, virt_j = jpe.edge_tail_sum(
        jnp.take(_j(send_t), np.asarray(j.senders), axis=1), _j(ew), _j(rec),
        *(_j(p[k]) for k in tail), np.asarray(j.mask), K, True, True)
    with torch.no_grad():
        msg_t, virt_t = edge.edge_tail_sum(
            send_t, t.senders, ew, rec, *(p[k] for k in tail), t.mask, K,
            with_messages=True)
    assert_bf16_close(msg_t, msg_j, f"P2 K={K} B={B} messages")
    assert_bf16_close(virt_t, virt_j, f"P2 K={K} B={B} virt")


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_p3_bf16_matches_jax(K, B):
    """P3 (batched processor edge layer, the pre-gathered variant): bf16
    edge state, node table and rec_rows; bf16 edge_out and virt."""
    rng = np.random.default_rng(50 + K + B)
    j, t = _local_graph(K, rng)
    n_virt, M = t.num_virt, t.num_virt * K
    edge_rep = _bf16(rng, B, M, H)
    send_t = _bf16(rng, B, N_SEND, H)
    rec = _bf16(rng, B, n_virt, H)
    p = _tail_params(rng)
    par = ("w_e", "b0", "w2", "b2", "ls", "lb")
    gs = jnp.take(_j(send_t), np.asarray(j.senders), axis=1)
    eo_j, virt_j = jpe.edge_layer(_j(edge_rep), gs, _j(send_t), _j(rec),
                                  np.asarray(j.mask), *(_j(p[k]) for k in par),
                                  K, False, True)
    with torch.no_grad():
        eo_t, virt_t = edge.edge_layer(edge_rep, send_t, t.senders, rec,
                                       t.mask, *(p[k] for k in par), K)
    assert_bf16_close(eo_t, eo_j, f"P3 K={K} B={B} edge_out")
    assert_bf16_close(virt_t, virt_j, f"P3 K={K} B={B} virt")


# --- the rounding rules of the JAX package's bf16 call sites ---------------


def test_mm_rounds_both_operands_and_keeps_fp32():
    """Rule 1: `mlp.mm` with a compute dtype is the JAX package's
    `jnp.dot(x.astype(bf16), w.astype(bf16), preferred_element_type=
    float32)`: an fp32 result, not rounded to bf16 (a bf16 GEMM's would
    be)."""
    rng = np.random.default_rng(1)
    x, w = _f32(rng, 40, 56, scale=1.0), _f32(rng, 56, H)
    got = tmlp.mm(x, w, BF)
    want = jnp.dot(_j(x).astype(jnp.bfloat16), _j(w).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert not torch.equal(got, got.to(BF).float())
    assert not torch.equal(got, x @ w)


def test_rounded_weights_are_made_once_per_parameter_version():
    """`mlp.rounded`, which `mm` takes its weight from: a parameter's
    rounding, and its slices', equal a fresh rounding; one copy serves
    every slice until the parameter changes in place; a weight that needs
    a gradient is rounded afresh, and the gradient reaches it."""
    rng = np.random.default_rng(2)
    p = torch.nn.Parameter(_f32(rng, 3 * H, H))
    with torch.no_grad():
        views = (p, p[:H], p[H:2 * H], p[2 * H:], p[5:9, 3:40])
        for v in views:
            assert torch.equal(tmlp.rounded(v, BF), v.to(BF).float())
        whole = tmlp.rounded(p, BF)
        assert tmlp.rounded(p[H:2 * H], BF).data_ptr() == (
            whole.data_ptr() + H * H * whole.element_size())
        p.mul_(1.5)
        for v in views:
            assert torch.equal(tmlp.rounded(v, BF), v.to(BF).float())
    x = _f32(rng, 7, H)
    tmlp.mm(x, p[H:2 * H], BF).sum().backward()
    assert p.grad is not None and p.grad[H:2 * H].abs().sum() > 0
    assert not p.grad[:H].any()


def test_apply_mlp_bf16_matches_jax():
    """apply_mlp and apply_mlp_concat with compute_dtype bf16: each layer's
    output stored in bf16, LayerNorm in fp32 statistics, bf16 out."""
    rng = np.random.default_rng(2)
    jp = jmlp.init_mlp(jax.random.PRNGKey(3), [56, H, H])
    tm = tmlp.init_mlp([56, H, H])
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    x = _f32(rng, 300, 56, scale=1.0)
    with torch.no_grad():
        got = tmlp.apply_mlp(tm, x, BF)
        got_c = tmlp.apply_mlp_concat(tm, [x[:, :20], x[:, 20:]], BF)
    assert_bf16_close(got, jmlp.apply_mlp(jp, _j(x),
                                          compute_dtype=jnp.bfloat16),
                      "apply_mlp", chained=True)
    assert_bf16_close(got_c, jmlp.apply_mlp_concat(
        jp, [_j(x[:, :20]), _j(x[:, 20:])], compute_dtype=jnp.bfloat16),
        "apply_mlp_concat", chained=True)


def test_node_transforms_round_as_on_the_accelerator():
    """Rule 2: the port rounds the operands of its flat node transforms,
    which the JAX package does off the CPU only (its CPU dot thunk): the
    port equals the accelerator's rule, emulated, and differs from the
    JAX CPU route."""
    rng = np.random.default_rng(4)
    x, w = _f32(rng, 2, 50, H, scale=1.0), _f32(rng, H, H)
    x_f = _f32(rng, 50, 2 * H, scale=1.0)
    bfj = jnp.bfloat16

    def rounded(a):
        return _j(a).astype(bfj).astype(jnp.float32)

    want = jnp.einsum("bnh,hk->nbk", rounded(x), rounded(w)).reshape(50, -1)
    got = tmp.node_transform_flat(x, w, BF)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    cpu_route = jmp.node_transform_flat(_j(x), _j(w), bfj)
    assert np.abs(got.numpy() - np.asarray(cpu_route)).max() > 1e-3
    want_f = (rounded(x_f).reshape(50, 2, H) @ rounded(w)).reshape(50, -1)
    got_f = tmp.node_transform_from_flat(x_f, w, 2, BF)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("rows", [3, 20])
def test_fold_in_bf16_matches_segment_sum(rows):
    """Rule 6: where the JAX package folds virtual rows by `segment_sum`
    (its batched route; its flat route past 16 rows a receiver) on a bf16
    virt, the port's gather fold with in_virt_dtype sums in bf16, row after
    row, bit for bit; the fp32 fold (the JAX flat route's `_rec_fold`) is
    bf16 virt times the fp32 mask."""
    rng = np.random.default_rng(rows)
    n_rec = 40
    receivers = np.repeat(np.arange(n_rec), rows * 8)
    senders = rng.integers(0, 30, receivers.size)
    es = EdgeSet.from_local(senders, receivers,
                            np.zeros((receivers.size, 1), np.float32), 30,
                            n_rec, device="cpu", build_transpose=False)
    assert es.rec_slots.shape[1] == rows and not es.virt_identity
    virt = _bf16(rng, 2, es.num_virt, H, scale=3.0)
    # the padding virtual rows have no real slot: their sums are zero
    virt[:, int(es.rec_mask.sum()):] = 0
    want = jax.vmap(lambda v: jax.ops.segment_sum(
        v, jnp.asarray(es.virt_to_rec.numpy()), num_segments=n_rec,
        indices_are_sorted=True))(_j(virt))
    got = tmp._fold_virt(es, virt, in_virt_dtype=True)
    assert got.dtype == BF
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    f32 = tmp._fold_virt(es, virt)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(
        f32.numpy(), (virt.float()[:, es.rec_slots]
                      * es.rec_mask[None, :, :, None]).sum(2).numpy(),
        rtol=1e-6, atol=1e-5)


# --- the wrappers ------------------------------------------------------------


def test_bf16_takes_the_plain_version_on_cpu(monkeypatch):
    """On a CPU tensor a bf16 input takes the plain version: nothing is
    built, no launch is counted, and the output is bf16."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    rng = np.random.default_rng(6)
    _, t = _local_graph(3, rng)
    p = _tail_params(rng)
    before = (edge_flat.edge_tail_sum_flat.launches,
              edge_flat.edge_tail_sum_flat.launches_bf16)
    with torch.no_grad():
        virt = edge_flat.edge_tail_sum_flat(
            _bf16(rng, N_SEND, 2 * H), t.senders, _bf16(rng, t.num_virt * 3, H),
            _bf16(rng, t.num_virt, 2 * H), t.mask.view(t.num_virt, 3),
            p["w2"], p["b2"], p["ls"], p["lb"])
    assert virt.dtype == BF
    assert (edge_flat.edge_tail_sum_flat.launches,
            edge_flat.edge_tail_sum_flat.launches_bf16) == before


@pytest.mark.parametrize("which", ["K1", "K2", "K3", "K4", "P1", "P2", "P3"])
def test_gradient_through_bf16_forward_raises(which):
    """A gradient through a bf16 forward (the bf16 training path, which
    once raised here) runs on the CPU: every input and parameter that
    needs one gets a finite gradient of its own dtype, through the plain
    versions, and no bf16 launch is counted (forward or backward)."""
    rng = np.random.default_rng(7)
    _, t = _local_graph(3, rng)
    n_virt, K = t.num_virt, 3
    p = {k: v.requires_grad_() for k, v in _tail_params(rng).items()}
    mask_p = t.mask.view(n_virt, K)
    tail = (p["w2"], p["b2"], p["ls"], p["lb"])

    def bf(*shape):
        return _bf16(rng, *shape).requires_grad_()

    w0 = _f32(rng, 7, H).requires_grad_()
    pp = {k: _f32(rng, *s, scale=0.1).requires_grad_()
          for k, s in _decoder_shapes(5)}
    calls = {
        "K1": lambda: ([x := bf(10, 2 * 7), w0], embed.embed_grid_flat(
            x, w0, p["b0"], p["w2"], p["b2"], p["ls"], p["lb"], 2)),
        "K2": lambda: ([tb := bf(N_SEND, 2 * H), e := bf(n_virt * K, H),
                        r := bf(n_virt, 2 * H)],
                       edge_flat.edge_tail_sum_flat(
                           tb, t.senders, e, r, mask_p, *tail,
                           fold=t.fold_senders)),
        "K3": lambda: ([e := bf(n_virt * K, 2 * H), tb := bf(N_SEND, 2 * H),
                        r := bf(n_virt, 2 * H)],
                       edge_flat.edge_layer_flat(
                           e, tb, t.senders, r, mask_p, p["w_e"], p["b0"],
                           *tail, fold=t.fold_senders)),
        "K4": lambda: ([tb := bf(N_SEND, 2 * H), e := bf(n_virt * K, H),
                        g := bf(N_REC, 2 * H)],
                       grid_update.grid_update_flat(
                           tb, t.senders, e, g, mask_p, pp,
                           fold=t.fold_senders)),
        "P1": lambda: ([x := _f32(rng, 1, n_virt * K, H).requires_grad_()],
                       edge.edge_tail(x, *tail, t.mask, K)),
        "P2": lambda: ([s := bf(1, N_SEND, H), e := bf(n_virt * K, H),
                        r := bf(1, n_virt, H)],
                       edge.edge_tail_sum(s, t.senders, e, r, *tail, t.mask,
                                          K)),
        "P3": lambda: ([e := bf(1, n_virt * K, H), s := bf(1, N_SEND, H),
                        r := bf(1, n_virt, H)],
                       edge.edge_layer(e, s, t.senders, r, t.mask, p["w_e"],
                                       p["b0"], *tail, K)),
    }
    wrappers = (embed.embed_grid_flat, embed.embed_grid_flat_bwd,
                edge_flat.edge_tail_sum_flat, edge_flat.edge_tail_sum_flat_bwd,
                edge_flat.edge_layer_flat, edge_flat.edge_layer_flat_bwd,
                grid_update.grid_update_flat,
                grid_update.grid_update_flat_bwd, edge.edge_tail_sum,
                edge.edge_layer, weight_grad.xtd_sum, weight_grad.xtd_reduce)
    before = [w.launches_bf16 for w in wrappers]
    inputs, out = calls[which]()
    outs = [o for o in (out if isinstance(out, tuple) else (out,))
            if o is not None]
    sum(o.float().square().sum() for o in outs).backward()
    weight = pp["enc_w0"] if which == "K4" else p["w2"]
    for i, x in enumerate(inputs + [weight]):
        assert x.grad is not None, (which, i)
        assert x.grad.dtype == x.dtype, (which, i, x.grad.dtype)
        assert bool(torch.isfinite(x.grad.float()).all()), (which, i)
    assert [w.launches_bf16 for w in wrappers] == before


def _decoder_shapes(d_out):
    """(name, shape) of the fused decoder's parameters, d_out outputs."""
    return [(k, (2 * H, H) if k == "a_w0" else (H, d_out) if k == "o_w1"
             else (d_out,) if k == "o_b1" else (H, H) if k.endswith(
                 ("w0", "w1", "w_i", "w2")) else (H,))
            for k in grid_update._KEYS]


def test_pointers_hold_bf16_as_strictly_as_float32():
    """`_build.pointers` refuses a bf16 tensor where float32 is expected
    and the reverse; `_build.io_dtype` names the instance of a float32 or
    bf16 tensor and refuses any other dtype with TypeError."""
    dev = torch.device("cpu")
    x32, x16 = torch.zeros(4), torch.zeros(4, dtype=BF)
    assert _build.pointers(dev, ("x", x16, BF))[0] == x16.data_ptr()
    with pytest.raises(TypeError, match="bfloat16, expected torch.float32"):
        _build.pointers(dev, ("x", x16, torch.float32))
    with pytest.raises(TypeError, match="float32, expected torch.bfloat16"):
        _build.pointers(dev, ("x", x32, BF))
    assert _build.io_dtype("x", x16) == BF
    assert _build.io_dtype("x", x32) == torch.float32
    with pytest.raises(TypeError, match="float16"):
        _build.io_dtype("x", torch.zeros(4, dtype=torch.float16))


def test_p1_stays_fp32_in_a_hilam_bf16_step(monkeypatch):
    """Rule 5: in a HiLAM bf16 predict step (30x30, 2 levels, batch 1: the
    batched route), the x0 that reaches P1 (`edge.edge_tail`) is fp32,
    promoted by its fp32 first term, while P2 and P3 get bf16 inputs."""
    model, _ = entry.build_model(nx=30, ny=30, processor_layers=1,
                                 device="cpu", model="hi_lam",
                                 compute_dtype="bfloat16")
    seen = {"edge_tail": [], "edge_tail_sum": [], "edge_layer": []}
    for name in seen:
        real = getattr(edge, name)

        def spy(first, *a, _real=real, _name=name, **kw):
            seen[_name].append(first.dtype)
            return _real(first, *a, **kw)

        monkeypatch.setattr(edge, name, spy)
    init, forcing, _ = entry.make_inputs(model, 1, 1)
    with torch.no_grad():
        out, _ = model.predict_step(init[:, 1], init[:, 0], forcing[:, 0])
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert seen["edge_tail"] and set(seen["edge_tail"]) == {torch.float32}
    assert set(seen["edge_tail_sum"]) == {BF}
    assert set(seen["edge_layer"]) == {BF}
