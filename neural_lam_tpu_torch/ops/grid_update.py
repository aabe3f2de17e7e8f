"""The whole m2g decoder stage in one pass (K4) and its backward (B5/B6).

Counterpart of neural_lam_tpu/ops/pallas_grid_update.py. Per grid node of
a `virt_identity` m2g edge set (one K-slot virtual row per grid node):

    grid_rep = ge + EncMLP(ge)                      (encoding_grid_mlp)
    rec      = grid_rep @ W_i                       (edge-MLP rec term)
    x        = silu(table[senders] + ew + rec)      (edge MLP layer 0)
    msg      = LayerNorm(x @ W2 + b2)
    agg      = masked K-slot sum
    rec_out  = grid_rep + AggrMLP(grid_rep, agg)
    out      = OutMLP(rec_out)                      (no LN)

One function covers the JAX package's pre-gathered kernel and its windowed
twin (`grid_update_flat` / `grid_update_flat_win`): the sender rows are
read by index from the (N_send, W) table. `grid_update_flat` is a
`torch.autograd.Function` on both devices, whose forward calls the
operator `nlt::grid_update_flat` (`ops/library.py`): forward and backward
run their
plain versions on a CPU tensor and the CUDA kernels (`csrc/grid_update.cu`,
`csrc/grid_update_bwd.cu` and `csrc/weight_grad.cu`) on a CUDA tensor.
The forward saves only its inputs; the backward recomputes it and yields
the sender cotangent per slot, which the caller's `fold` sums onto the
table. The backward runs in two passes: a chain pass, which writes the
activation/gradient pairs of the weight gradients to a scratch, and
`weight_grad.xtd_sum` over those pairs.
`grid_update_flat.launches` and `grid_update_flat_bwd.launches` (the chain
kernel) count kernel launches.

bf16 (the bf16 path): a bf16 table takes the bf16 instances, which read
table, ew and grid_emb_f (and, backward, d_out) in bf16, compute in fp32
on the fp32 parameters and store their outputs in bf16, each rounded once
(round to nearest even), as the JAX kernels do on bf16 inputs: the
output forward; the per-slot d_x0, d_ew and d_grid_emb_f backward. The
weight and vector gradients stay fp32: the chain's scratch is fp32, the
enc_w0 pair takes the bf16 grid_emb_f as it is, and the o_w1 pair a
widened copy of d_out (its D must be fp32; the JAX kernel widens d_out
as it reads it). `grid_update_flat.launches_bf16` and
`grid_update_flat_bwd.launches_bf16` count the bf16 instances' launches.

Widths: the forward and backward kernels take h = w2's width at every
width they are built for (`_build.WIDTHS`: 32, 64, 128), from that
width's library, and any output width d_out; any other h raises on a
CUDA tensor. The plain versions take any width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, library, weight_grad
from .mlp import grads_through, layer_norm

_P, _I, _IP = _build.P, _build.I, _build.IP
_SIGNATURES = {"nlt_grid_update": [_P] * 7 + [_I] * 6 + [_P],
               "nlt_grid_update_bf16": [_P] * 7 + [_I] * 6 + [_P]}
_BWD_SIGNATURES = {
    f"nlt_grid_update_bwd{sfx}{grid}": sig
    for sfx in ("", "_bf16")
    for grid, sig in (("", [_P] * 14 + [_I] * 7 + [_P]),
                      ("_grid", [_I] * 6 + [_IP]))
}

# order of the parameter blob csrc/grid_update.cu reads
_MATS = ("enc_w0", "enc_w1", "w_i", "w2", "a_w0", "a_w1", "o_w0")
_VECS = ("enc_b0", "enc_b1", "enc_ls", "enc_lb", "b2", "e_ls", "e_lb",
         "a_b0", "a_b1", "a_ls", "a_lb", "o_b0")
# every parameter, in blob order (the autograd.Function's argument order)
_KEYS = _MATS + _VECS + ("o_w1", "o_b1")


def _lib(h):
    return _build.library("grid_update", _SIGNATURES, h)


def _bwd_lib(h):
    return _build.library("grid_update_bwd", _BWD_SIGNATURES, h)


def pack_grid_update_params(model) -> dict:
    """The parameters the fused decoder reads, from a model holding the
    m2g_gnn, encoding_grid_mlp and output_map modules (names as the JAX
    package's `pack_grid_update_params`)."""
    m2g = model.m2g_gnn
    e0 = m2g.edge_mlp.layers[0].w
    h = e0.shape[0] // 3
    enc = model.encoding_grid_mlp
    aggr = m2g.aggr_mlp
    out = model.output_map
    return {
        "w_i": e0[2 * h:],
        "w2": m2g.edge_mlp.layers[1].w,
        "b2": m2g.edge_mlp.layers[1].b,
        "e_ls": m2g.edge_mlp.ln.scale,
        "e_lb": m2g.edge_mlp.ln.bias,
        "enc_w0": enc.layers[0].w,
        "enc_b0": enc.layers[0].b,
        "enc_w1": enc.layers[1].w,
        "enc_b1": enc.layers[1].b,
        "enc_ls": enc.ln.scale,
        "enc_lb": enc.ln.bias,
        "a_w0": aggr.layers[0].w,
        "a_b0": aggr.layers[0].b,
        "a_w1": aggr.layers[1].w,
        "a_b1": aggr.layers[1].b,
        "a_ls": aggr.ln.scale,
        "a_lb": aggr.ln.bias,
        "o_w0": out.layers[0].w,
        "o_b0": out.layers[0].b,
        "o_w1": out.layers[1].w,
        "o_b1": out.layers[1].b,
    }


def grid_update_applicable(model, m2g_edges) -> bool:
    """Structural eligibility for the fused decoder: a virt_identity m2g
    set and 2-layer MLPs with the reference LayerNorm layout."""
    def two_layer(mlp, ln):
        return len(mlp.layers) == 2 and (mlp.ln is not None) == ln

    return (
        m2g_edges.virt_identity
        and two_layer(model.m2g_gnn.edge_mlp, True)
        and two_layer(model.m2g_gnn.aggr_mlp, True)
        and two_layer(model.encoding_grid_mlp, True)
        and two_layer(model.output_map, False)
    )


def _decoder_from_gathered(g, ew, grid_emb_f, mask_p, pp, keep=None):
    """K4's math on pre-gathered sender rows g (M, W). `keep`, a dict,
    receives the intermediates by name."""
    n_virt, K = mask_p.shape
    h = ew.shape[-1]
    B = g.shape[-1] // h
    ge = grid_emb_f.view(grid_emb_f.shape[0], B, h)
    if ge.shape[0] < n_virt:
        ge = F.pad(ge, (0, 0, 0, 0, 0, n_virt - ge.shape[0]))
    t1p = ge @ pp["enc_w0"] + pp["enc_b0"]
    t1 = F.silu(t1p)
    t2 = t1 @ pp["enc_w1"] + pp["enc_b1"]
    gr = ge + layer_norm(t2, pp["enc_ls"], pp["enc_lb"])
    rec = gr @ pp["w_i"]
    x1 = F.silu(g.view(n_virt, K, B, h) + ew.view(n_virt, K, 1, h)
                + rec[:, None])
    y2 = x1 @ pp["w2"] + pp["b2"]
    msg = layer_norm(y2, pp["e_ls"], pp["e_lb"])
    agg = (msg * mask_p[:, :, None, None]).sum(dim=1)
    u0p = gr @ pp["a_w0"][:h] + agg @ pp["a_w0"][h:] + pp["a_b0"]
    u1 = F.silu(u0p)
    u2 = u1 @ pp["a_w1"] + pp["a_b1"]
    ro = gr + layer_norm(u2, pp["a_ls"], pp["a_lb"])
    y0p = ro @ pp["o_w0"] + pp["o_b0"]
    y = F.silu(y0p)
    out = y @ pp["o_w1"] + pp["o_b1"]
    if keep is not None:
        keep.update(t1p=t1p, t1=t1, t2=t2, gr=gr, rec=rec, x1=x1, y2=y2,
                    agg=agg, u0p=u0p, u1=u1, u2=u2, ro=ro, y0p=y0p, y=y)
    return out.reshape(n_virt, -1)


def grid_update_flat_plain(table, senders, ew, grid_emb_f, mask_p, pp):
    """Plain PyTorch version of `grid_update_flat`'s forward (fp32 math,
    the output in the table's dtype)."""
    return _decoder_from_gathered(table.index_select(0, senders).float(),
                                  ew.float(), grid_emb_f.float(), mask_p,
                                  pp).to(table.dtype)


def _check(table, senders, ew, grid_emb_f, mask_p, pp,
           what="grid_update_flat"):
    """K4's and B5/B6's shapes (any d_out >= 1); returns their instance's
    dtype and h, a built width."""
    n_virt, K = mask_p.shape
    W = table.shape[1]
    d_out = pp["o_w1"].shape[1]
    h = _build.require_width(pp["w2"].shape[-1], what)
    _build.expect(W % h == 0 and ew.shape == (n_virt * K, h), "ew",
                  ew.shape)
    _build.expect(grid_emb_f.dim() == 2 and grid_emb_f.shape[1] == W
                  and grid_emb_f.shape[0] <= n_virt, "grid_emb_f",
                  grid_emb_f.shape)
    _build.expect(senders.shape == (n_virt * K,), "senders", senders.shape)
    _build.expect(d_out >= 1, "d_out", d_out)
    for name in _MATS:
        rows = 2 * h if name == "a_w0" else h
        _build.expect(pp[name].shape == (rows, h), name, pp[name].shape)
    _build.expect(pp["o_w1"].shape[0] == h, "o_w1", pp["o_w1"].shape)
    return _build.io_dtype("table", table), h


def _blob(pp):
    """The parameter blob, in the layout both CUDA kernels read."""
    return torch.cat([pp[n].reshape(-1) for n in _KEYS])


def _grid_cuda(table, senders, ew, grid_emb_f, mask_p, params):
    dev = _build.require_cuda(table)
    pp = dict(zip(_KEYS, params))
    dt, h = _check(table, senders, ew, grid_emb_f, mask_p, pp)
    n_virt, K = mask_p.shape
    B = table.shape[1] // h
    d_out = pp["o_w1"].shape[1]
    blob = _blob(pp)
    out = torch.empty((n_virt, B * d_out), device=dev, dtype=dt)
    f32, i32 = torch.float32, torch.int32
    ptrs = _build.pointers(dev, ("table", table, dt),
                           ("senders", senders, i32), ("ew", ew, dt),
                           ("grid_emb_f", grid_emb_f, dt),
                           ("mask_p", mask_p, f32), ("params", blob, f32),
                           ("out", out, dt))
    lib = _lib(h)
    fn = (lib.nlt_grid_update_bf16 if dt == torch.bfloat16
          else lib.nlt_grid_update)
    rc = fn(*ptrs, n_virt, grid_emb_f.shape[0], K, B, d_out, dev.index,
            _build.stream_of(dev))
    _build.check(lib, rc, "grid_update_flat")
    _build.count_launch(grid_update_flat, dt)
    return out


def _grid_plain(table, senders, ew, grid_emb_f, mask_p, params):
    return grid_update_flat_plain(table, senders, ew, grid_emb_f, mask_p,
                                  dict(zip(_KEYS, params)))


def _grid_fake(table, senders, ew, grid_emb_f, mask_p, params):
    pp = dict(zip(_KEYS, params))
    if library.on_card(table):
        _check(table, senders, ew, grid_emb_f, mask_p, pp)
    B = table.shape[1] // ew.shape[1]
    return table.new_empty((mask_p.shape[0], B * pp["o_w1"].shape[1]))


# K4's operator (ops/library.py); `params` in `_KEYS` order
_grid_op = library.define(
    "grid_update_flat",
    "(Tensor table, Tensor senders, Tensor ew, Tensor grid_emb_f, "
    "Tensor mask_p, Tensor[] params) -> Tensor",
    cpu=_grid_plain, cuda=_grid_cuda, fake=_grid_fake)


def _grid_fwd(table, senders, ew, grid_emb_f, mask_p, pp):
    return _grid_op(table, senders, ew, grid_emb_f, mask_p,
                    [pp[k] for k in _KEYS])


def grid_update_flat_bwd_plain(table, senders, ew, grid_emb_f, mask_p, pp,
                               d_out):
    """Plain PyTorch version of `grid_update_flat_bwd`: autograd through
    the plain forward on the gathered rows (fp32 math, the activation
    gradients in their inputs' dtype)."""
    keys = list(pp)

    def fwd(g, ew, grid_emb_f, *params):
        return _decoder_from_gathered(g.float(), ew.float(),
                                      grid_emb_f.float(), mask_p,
                                      dict(zip(keys, params))).to(g.dtype)

    grads = grads_through(
        fwd, [table.index_select(0, senders), ew, grid_emb_f]
        + [pp[k] for k in keys], (d_out,))
    return grads[0], grads[1], grads[2], dict(zip(keys, grads[3:]))


# Scratch rows of the chain pass (csrc/grid_update_bwd.cu): the node
# tensors, each (n_virt*B, h) with row v*B + b, in this order; and the
# slot tensors X1 = silu(x0) and DX2, each (n_virt*K*B, h) with row
# (v*K + k)*B + b. "d" marks a gradient: dt1p is d t1p.
_NODE = ("t1", "gr", "agg", "u1", "ro", "y",
         "dt1p", "dt2", "drec", "du0p", "du2", "dy0p")
_SLOT = ("x1", "dx2")
# the nine weight gradients, X^T @ D for these (X, D) scratch pairs
# (a_w0's two halves apart; ge is grid_emb_f, dout is d_out)
_PAIRS = (("enc_w0", "ge", "dt1p"), ("enc_w1", "t1", "dt2"),
          ("w_i", "gr", "drec"), ("w2", "x1", "dx2"),
          ("a_wr", "gr", "du0p"), ("a_wa", "agg", "du0p"),
          ("a_w1", "u1", "du2"), ("o_w0", "ro", "dy0p"),
          ("o_w1", "y", "dout"))


def _weight_pairs(node, slot, grid_emb_f, d_out, B):
    """The (X, D) pairs of `_PAIRS`, as views of the chain's scratch
    (node (12, n_virt*B, h), slot (2, n_virt*K*B, h)) and the inputs;
    ge's pair over grid_emb_f's real rows only (a bf16 grid_emb_f as it
    is), dout's on d_out widened to fp32."""
    rows = dict(zip(_NODE + _SLOT, [*node, *slot]),
                ge=grid_emb_f.view(-1, grid_emb_f.shape[1] // B),
                dout=d_out.float().reshape(-1, d_out.shape[1] // B))
    return [(rows[x], rows[d][:rows[x].shape[0]]) for _, x, d in _PAIRS]


def grid_update_bwd_chain_plain(table, senders, ew, grid_emb_f, mask_p, pp,
                                d_out):
    """Plain PyTorch version of the chain pass: (d_x0, d_ew, d_grid_emb_f,
    {name: gradient} for the 13 vector parameters, the weight-gradient
    pairs of `_PAIRS`), by autograd through the plain forward (fp32 math)
    with its intermediates kept; d_x0, d_ew and d_grid_emb_f in their
    inputs' dtypes, each rounded once."""
    n_virt, K = mask_p.shape
    h = ew.shape[-1]
    B = table.shape[1] // h
    vec_keys = _VECS + ("o_b1",)
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in (
            table.index_select(0, senders), ew, grid_emb_f)]
        vecs = {k: pp[k].detach().requires_grad_() for k in vec_keys}
        act = {}
        out = _decoder_from_gathered(
            *leaves, mask_p, dict({k: pp[k].detach() for k in pp}, **vecs),
            act)
        # scratch gradient -> the intermediate it is taken with respect to
        grad_of = {"dt1p": "t1p", "dt2": "t2", "drec": "rec", "du0p": "u0p",
                   "du2": "u2", "dy0p": "y0p", "dx2": "y2"}
        grads = torch.autograd.grad(
            out, leaves + [act[k] for k in grad_of.values()]
            + [vecs[k] for k in vec_keys], d_out.float().reshape(out.shape))
    rows = dict(act, **dict(zip(grad_of, grads[3:])))
    node = [rows[k].detach().reshape(-1, h) for k in _NODE]
    slot = [rows[k].detach().reshape(-1, h) for k in _SLOT]
    return (grads[0].to(table.dtype), grads[1].to(ew.dtype),
            grads[2].to(grid_emb_f.dtype),
            dict(zip(vec_keys, grads[3 + len(grad_of):])),
            _weight_pairs(node, slot, grid_emb_f, d_out, B))


def grid_update_bwd_chain(table, senders, ew, grid_emb_f, mask_p, pp, d_out):
    """B5/B6's chain pass: `grid_update_bwd_chain_plain` on a CPU tensor,
    the kernel of csrc/grid_update_bwd.cu on a CUDA tensor (its instance of
    the table's dtype; d_out in that dtype too). Its launches count on
    `grid_update_flat_bwd.launches` (`launches_bf16`): the chain kernel is
    the decoder backward's own kernel."""
    if table.device.type == "cpu":
        return grid_update_bwd_chain_plain(table, senders, ew, grid_emb_f,
                                           mask_p, pp, d_out)
    dev = _build.require_cuda(table)
    dt, h = _check(table, senders, ew, grid_emb_f, mask_p, pp,
                   "grid_update_flat_bwd")
    n_virt, K = mask_p.shape
    W = table.shape[1]
    B = W // h
    d_o = pp["o_w1"].shape[1]
    _build.expect(d_out.shape == (n_virt, B * d_o), "d_out", d_out.shape)
    params = _blob(pp)
    aw0 = pp["a_w0"]
    mats_t = [pp["enc_w0"], pp["enc_w1"], pp["w_i"], pp["w2"], aw0[:h],
              aw0[h:], pp["a_w1"], pp["o_w0"]]
    tparams = torch.cat([m.t().reshape(-1) for m in mats_t]
                        + [pp["o_w1"].t().reshape(-1)])
    d_out = d_out.contiguous()
    f32, i32 = torch.float32, torch.int32
    d_x0 = torch.empty((n_virt * K, W), device=dev, dtype=dt)
    d_ew = torch.empty_like(ew)
    d_ge = torch.empty_like(grid_emb_f)
    node = torch.empty((len(_NODE), n_virt * B, h), device=dev, dtype=f32)
    slot = torch.empty((len(_SLOT), n_virt * K * B, h), device=dev,
                       dtype=f32)
    ptrs = _build.pointers(dev, ("table", table, dt),
                           ("senders", senders, i32), ("ew", ew, dt),
                           ("grid_emb_f", grid_emb_f, dt),
                           ("mask_p", mask_p, f32), ("params", params, f32),
                           ("tparams", tparams, f32), ("d_out", d_out, dt),
                           ("d_x0", d_x0, dt), ("d_ew", d_ew, dt),
                           ("d_ge", d_ge, dt), ("node", node, f32),
                           ("slot", slot, f32))
    n_vec = len(_VECS) * h
    g = _build.run_bwd(_bwd_lib(h),
                       "nlt_grid_update_bwd" + _build.suffix(dt), ptrs,
                       [n_virt, grid_emb_f.shape[0], K, B, d_o],
                       n_vec + d_o, dev, "grid_update_flat_bwd")
    _build.count_launch(grid_update_flat_bwd, dt)
    vecs = {k: g[i * h:(i + 1) * h] for i, k in enumerate(_VECS)}
    vecs["o_b1"] = g[n_vec:]
    return d_x0, d_ew, d_ge, vecs, _weight_pairs(node, slot, grid_emb_f,
                                                 d_out, B)


def _assemble(vecs, mats):
    """{name: gradient} in `_KEYS` order from the chain's vector gradients
    and the weight-gradient pass's matrices (in `_PAIRS` order)."""
    m = dict(zip((name for name, _, _ in _PAIRS), mats))
    m["a_w0"] = torch.cat([m.pop("a_wr"), m.pop("a_wa")])
    return {k: m[k] if k in m else vecs[k] for k in _KEYS}


def grid_update_flat_bwd(table, senders, ew, grid_emb_f, mask_p, pp, d_out):
    """Backward of `grid_update_flat` from d_out (N_virt, B*d_out):
    (d_x0 (M, W) per slot, d_ew (M, h), d_grid_emb_f (N_rows, W), {name:
    gradient} for every parameter, in `_KEYS` order); the first three in
    the inputs' dtype, the parameter gradients fp32.

    Replaces pallas_grid_update.py::_grid_update_bwd_kernel (via
    _grid_update_bwd) and ::_grid_update_win_bwd_kernel (via
    grid_update_flat_win_bwd), in two passes: the chain
    (`grid_update_bwd_chain`, csrc/grid_update_bwd.cu) writes the
    activation/gradient pairs of the nine weight gradients, and
    `weight_grad.xtd_sum` (csrc/weight_grad.cu) sums them. Both run their
    plain versions on a CPU tensor and their kernels on a CUDA tensor.
    """
    d_x0, d_ew, d_ge, vecs, pairs = grid_update_bwd_chain(
        table, senders, ew, grid_emb_f, mask_p, pp, d_out)
    return d_x0, d_ew, d_ge, _assemble(vecs, weight_grad.xtd_sum(pairs))


class _GridUpdateFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, senders, ew, grid_emb_f, mask_p, fold, *params):
        ctx.save_for_backward(table, senders, ew, grid_emb_f, mask_p,
                              *params)
        ctx.fold = fold
        return _grid_fwd(table, senders, ew, grid_emb_f, mask_p,
                         dict(zip(_KEYS, params)))

    @staticmethod
    def backward(ctx, d_out):
        table, senders, ew, ge, mask_p, *params = ctx.saved_tensors
        d_x0, d_ew, d_ge, d_pp = grid_update_flat_bwd(
            table, senders, ew, ge, mask_p, dict(zip(_KEYS, params)), d_out)
        d_table = None
        if ctx.needs_input_grad[0]:
            if ctx.fold is None:
                raise ValueError("the table gradient needs the edge set's "
                                 "sender fold: pass fold=EdgeSet.fold_senders")
            d_table = ctx.fold(d_x0)  # in d_x0's dtype
        return (d_table, None, d_ew, d_ge, None, None,
                *(d_pp[k] for k in _KEYS))


def grid_update_flat(table, senders, ew, grid_emb_f, mask_p, pp, *,
                     fold=None):
    """Fused m2g decoder stage, differentiable.

    table: (N_send, W) mesh-side sender transforms; senders (M,) int32;
    ew: (M, h) static edge term emb @ W_e + b0; grid_emb_f: (N_rows, W)
    flat grid embeddings with N_rows <= N_virt (virtual-row padding reads
    as zero rows; the caller slices those outputs off); mask_p (N_virt, K);
    pp: `pack_grid_update_params(model)`; fold: maps the per-slot sender
    cotangent onto the table (`EdgeSet.fold_senders`), needed only for the
    table's gradient.
    Returns (N_virt, B*d_out).

    Replaces pallas_grid_update.py::_grid_update_kernel (grid_update_flat)
    and ::_grid_update_win_kernel (grid_update_flat_win). Bound by fp32
    operations on the card; see csrc/grid_update.cu. bf16 table, ew and
    grid_emb_f give a bf16 output, and their gradients run B5/B6's bf16
    instance.
    """
    return _GridUpdateFlat.apply(table, senders, ew, grid_emb_f, mask_p,
                                 fold, *(pp[k] for k in _KEYS))


grid_update_flat.launches = 0
grid_update_flat.launches_bf16 = 0
grid_update_flat_bwd.launches = 0
grid_update_flat_bwd.launches_bf16 = 0
