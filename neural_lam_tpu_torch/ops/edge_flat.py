"""Flat-layout edge-MLP tail (K2) and processor edge layer (K3), with
their backward kernels (B2, and B3/B4).

Counterpart of neural_lam_tpu/ops/pallas_edge_flat.py. Both functions read
the sender term by index from the node table (`table[senders]`), so one
function covers the JAX package's pre-gathered kernels and its windowed
twins (`edge_layer_flat` and `edge_layer_flat_win`).

Layout: node and edge activations are flat (rows, W) with W = B*h; mask_p
is the (N_virt, K) dense-slot validity of the EdgeSet.

`edge_tail_sum_flat` and `edge_layer_flat` are `torch.autograd.Function`s
on both devices; their forwards call the operators
`nlt::edge_tail_sum_flat` and `nlt::edge_layer_flat` (`ops/library.py`).
Forward and backward each run their plain PyTorch
version (`*_plain`, same module) on a CPU tensor and their CUDA kernels
(`csrc/edge_flat.cu`, `csrc/edge_flat_bwd.cu`, `csrc/weight_grad.cu`) on a
CUDA tensor; there is no fallback from one to the other. The forward saves
only its inputs and the backward recomputes it. The backward yields the
sender cotangent per edge slot, d_x0 (M, W); the `fold` the caller passes
(`EdgeSet.fold_senders`) sums it onto the node table in a fixed order.

Both backwards (B2, B3/B4) run in two passes: a chain pass
(`edge_tail_bwd_chain`, `edge_layer_bwd_chain`) computes the cotangents
and the vector gradients and writes X1 = silu(x0) and DY (the LayerNorm
input's gradient) to a scratch; then `weight_grad.xtd_sum` sums dW2 =
X1^T DY (and, for B3/B4, dW_e = edge^T d_x0) over every slot and batch
element, in two launches. `<wrapper>.launches` counts kernel launches
(B2's chain on `edge_tail_sum_flat_bwd.launches`, B3/B4's on
`edge_layer_flat_bwd.launches`, the weight-gradient pass on
`weight_grad.xtd_sum.launches` and `weight_grad.xtd_reduce.launches`).

bf16 (the bf16 path): a bf16 table takes the bf16 instances, which read
table, ew / edge_rep and rec_rows (and, backward, d_virt and d_edge_out)
in bf16, compute in fp32 on the fp32 parameters and store their outputs
in bf16, each rounded once (round to nearest even), as the JAX kernels do
on bf16 inputs: edge_out and virt forward; the per-slot d_x0, d_ew,
d_edge and d_rec_rows backward. The weight and vector gradients stay fp32:
X1 and DY are fp32 scratch, and B3/B4's dW_e pair takes the bf16 edge
state with the chain's unrounded fp32 d_x0 (a second, fp32 copy), as the
JAX kernel sums dW_e from its fp32 d_x0 while it stores the d_gathered
that the sender fold sums in bf16. `<wrapper>.launches_bf16` counts the
bf16 instances' launches.

Widths: the forward and backward kernels take h = w2's width at every
width they are built for (`_build.WIDTHS`: 32, 64, 128), from that
width's library; any other h raises on a CUDA tensor. The plain versions
take any width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, library, weight_grad
from .mlp import grads_through, layer_norm

_P, _I, _IP = _build.P, _build.I, _build.IP
_SIGNATURES = {
    "nlt_edge_tail_sum": [_P] * 7 + [_I] * 4 + [_P],
    "nlt_edge_layer": [_P] * 8 + [_I] * 4 + [_P],
    "nlt_edge_tail_sum_bf16": [_P] * 7 + [_I] * 4 + [_P],
    "nlt_edge_layer_bf16": [_P] * 8 + [_I] * 4 + [_P],
}
_BWD_SIGNATURES = {
    f"nlt_edge_{name}_bwd{sfx}{grid}": sig
    for sfx in ("", "_bf16")
    for name, grid, sig in (
        ("tail_sum", "", [_P] * 13 + [_I] * 5 + [_P]),
        ("layer", "", [_P] * 15 + [_I] * 5 + [_P]),
        ("tail_sum", "_grid", [_I] * 4 + [_IP]),
        ("layer", "_grid", [_I] * 4 + [_IP]))
}


def _lib(h):
    return _build.library("edge_flat", _SIGNATURES, h)


def _bwd_lib(h):
    return _build.library("edge_flat_bwd", _BWD_SIGNATURES, h)


def _masked_slot_sum(msg, mask_p):
    """(N_virt, K, B, h) messages -> (N_virt, B*h) masked K-slot sums."""
    n_virt = msg.shape[0]
    return (msg * mask_p[:, :, None, None]).sum(dim=1).reshape(n_virt, -1)


def _tail_from_gathered(g, ew, rec_rows, mask_p, w2, b2, ln_scale, ln_bias,
                        keep=None):
    """K2's math on pre-gathered sender rows g (M, W). `keep`, a dict,
    receives the intermediates x1 = silu(x0) and y (the LayerNorm's input),
    each (N_virt, K, B, h)."""
    n_virt, K = mask_p.shape
    h = ew.shape[-1]
    B = g.shape[-1] // h
    x0 = (g.view(n_virt, K, B, h) + ew.view(n_virt, K, 1, h)
          + rec_rows.view(n_virt, 1, B, h))
    x1 = F.silu(x0)
    y = x1 @ w2 + b2
    if keep is not None:
        keep.update(x1=x1, y=y)
    return _masked_slot_sum(layer_norm(y, ln_scale, ln_bias), mask_p)


def edge_tail_sum_flat_plain(table, senders, ew, rec_rows, mask_p, w2, b2,
                             ln_scale, ln_bias):
    """Plain PyTorch version of `edge_tail_sum_flat`'s forward (fp32
    math, virt in the table's dtype)."""
    return _tail_from_gathered(table.index_select(0, senders).float(),
                               ew.float(), rec_rows.float(), mask_p, w2, b2,
                               ln_scale, ln_bias).to(table.dtype)


def _tail_cuda(table, senders, ew, rec_rows, mask_p, w2, b2, ln_scale,
               ln_bias):
    dev = _build.require_cuda(table)
    n_virt, K = mask_p.shape
    W = table.shape[1]
    dt, h = _check_tail(table, senders, ew, rec_rows, mask_p, w2)
    params = torch.cat([w2.reshape(-1), b2, ln_scale, ln_bias])
    virt = torch.empty((n_virt, W), device=dev, dtype=dt)
    f32, i32 = torch.float32, torch.int32
    ptrs = _build.pointers(dev, ("table", table, dt),
                           ("senders", senders, i32), ("ew", ew, dt),
                           ("rec_rows", rec_rows, dt),
                           ("mask_p", mask_p, f32), ("params", params, f32),
                           ("virt", virt, dt))
    lib = _lib(h)
    fn = (lib.nlt_edge_tail_sum_bf16 if dt == torch.bfloat16
          else lib.nlt_edge_tail_sum)
    rc = fn(*ptrs, n_virt, K, W // h, dev.index, _build.stream_of(dev))
    _build.check(lib, rc, "edge_tail_sum_flat")
    _build.count_launch(edge_tail_sum_flat, dt)
    return virt


def _tail_fake(table, senders, ew, rec_rows, mask_p, w2, b2, ln_scale,
               ln_bias):
    if library.on_card(table):
        _check_tail(table, senders, ew, rec_rows, mask_p, w2)
    return table.new_empty((mask_p.shape[0], table.shape[1]))


# K2's operator (ops/library.py)
_tail_fwd = library.define(
    "edge_tail_sum_flat",
    "(Tensor table, Tensor senders, Tensor ew, Tensor rec_rows, "
    "Tensor mask_p, Tensor w2, Tensor b2, Tensor ln_scale, Tensor ln_bias)"
    " -> Tensor",
    cpu=edge_tail_sum_flat_plain, cuda=_tail_cuda, fake=_tail_fake)


def _check_tail(table, senders, ew, rec_rows, mask_p, w2,
                what="edge_tail_sum_flat"):
    """K2's and B2's shapes; returns their instance's dtype and h, a built
    width."""
    n_virt, K = mask_p.shape
    W = table.shape[1]
    h = _build.require_width(w2.shape[-1], what)
    _build.expect(ew.shape == (n_virt * K, h), "ew", ew.shape)
    _build.expect(W % h == 0 and rec_rows.shape == (n_virt, W),
                  "rec_rows", rec_rows.shape)
    _build.expect(senders.shape == (n_virt * K,), "senders", senders.shape)
    _build.expect(w2.shape == (h, h), "w2", w2.shape)
    return _build.io_dtype("table", table), h


def edge_tail_sum_flat_bwd_plain(table, senders, ew, rec_rows, mask_p, w2,
                                 b2, ln_scale, ln_bias, d_virt):
    """Plain PyTorch version of `edge_tail_sum_flat_bwd` (autograd
    through the plain forward on the gathered rows: fp32 math, the
    activation gradients in their inputs' dtype)."""
    g = table.index_select(0, senders)

    def fwd(g, ew, rec_rows, w2, b2, ln_scale, ln_bias):
        return _tail_from_gathered(g.float(), ew.float(), rec_rows.float(),
                                   mask_p, w2, b2, ln_scale,
                                   ln_bias).to(g.dtype)

    return grads_through(fwd, (g, ew, rec_rows, w2, b2, ln_scale, ln_bias),
                          (d_virt,))


def _tail_pairs(x1, dy):
    """`xtd_sum`'s (X, D) pair for d_w2: (X1, DY) from the chain, each
    (M*B, h) with row (v*K + k)*B + b."""
    return [(x1, dy)]


def _fp32_leaves(*tensors):
    """Detached fp32 copies (widened from bf16) that require a gradient:
    the plain chains differentiate the fp32 math on them."""
    return [t.detach().float().requires_grad_() for t in tensors]


def edge_tail_bwd_chain_plain(table, senders, ew, rec_rows, mask_p, w2, b2,
                              ln_scale, ln_bias, d_virt):
    """Plain PyTorch version of `edge_tail_bwd_chain`, by autograd through
    the plain forward (fp32 math) with its intermediates kept; d_x0, d_ew
    and d_rec_rows in their inputs' dtypes, each rounded once."""
    with torch.enable_grad():
        leaves = _fp32_leaves(table.index_select(0, senders), ew, rec_rows,
                              b2, ln_scale, ln_bias)
        g, vew, rec, vb2, vls, vlb = leaves
        keep = {}
        virt = _tail_from_gathered(g, vew, rec, mask_p, w2.detach(), vb2,
                                   vls, vlb, keep)
        grads = torch.autograd.grad(virt, leaves + [keep["y"]],
                                    d_virt.float())
    d_x0, d_ew, d_rec, *d_vec, d_y = grads
    h = w2.shape[0]
    return (d_x0.to(table.dtype), d_ew.to(ew.dtype),
            d_rec.to(rec_rows.dtype), tuple(d_vec),
            _tail_pairs(keep["x1"].detach().reshape(-1, h),
                        d_y.reshape(-1, h)))


def edge_tail_bwd_chain(table, senders, ew, rec_rows, mask_p, w2, b2,
                        ln_scale, ln_bias, d_virt):
    """B2's chain pass: (d_x0 (M, W) per slot, d_ew (M, h), d_rec_rows,
    (d_b2, d_ln_scale, d_ln_bias), the (X, D) pair of d_w2 for
    `weight_grad.xtd_sum`). `edge_tail_bwd_chain_plain` on a CPU tensor,
    the chain kernel of csrc/edge_flat_bwd.cu on a CUDA tensor (its
    instance of the table's dtype; d_virt in that dtype too); its launches
    count on `edge_tail_sum_flat_bwd.launches` (`launches_bf16`)."""
    if table.device.type == "cpu":
        return edge_tail_bwd_chain_plain(table, senders, ew, rec_rows,
                                         mask_p, w2, b2, ln_scale, ln_bias,
                                         d_virt)
    dev = _build.require_cuda(table)
    n_virt, K = mask_p.shape
    W = table.shape[1]
    dt, h = _check_tail(table, senders, ew, rec_rows, mask_p, w2,
                        "edge_tail_sum_flat_bwd")
    _build.expect(d_virt.shape == (n_virt, W), "d_virt", d_virt.shape)
    params = torch.cat([w2.reshape(-1), b2, ln_scale, ln_bias])
    d_virt = d_virt.contiguous()
    M = n_virt * K
    f32, i32 = torch.float32, torch.int32
    d_x0 = torch.empty((M, W), device=dev, dtype=dt)
    d_ew = torch.empty((M, h), device=dev, dtype=dt)
    d_rec = torch.empty((n_virt, W), device=dev, dtype=dt)
    x1 = torch.empty((M * (W // h), h), device=dev, dtype=f32)
    dy = torch.empty_like(x1)
    ptrs = _build.pointers(dev, ("table", table, dt),
                           ("senders", senders, i32), ("ew", ew, dt),
                           ("rec_rows", rec_rows, dt),
                           ("mask_p", mask_p, f32), ("params", params, f32),
                           ("d_virt", d_virt, dt), ("d_x0", d_x0, dt),
                           ("d_ew", d_ew, dt), ("d_rec", d_rec, dt),
                           ("x1", x1, f32), ("dy", dy, f32))
    g = _build.run_bwd(_bwd_lib(h),
                       "nlt_edge_tail_sum_bwd" + _build.suffix(dt), ptrs,
                       [n_virt, K, W // h], 3 * h, dev,
                       "edge_tail_sum_flat_bwd")
    _build.count_launch(edge_tail_sum_flat_bwd, dt)
    d_b2, d_ls, d_lb = g.view(3, h)
    return d_x0, d_ew, d_rec, (d_b2, d_ls, d_lb), _tail_pairs(x1, dy)


def edge_tail_sum_flat_bwd(table, senders, ew, rec_rows, mask_p, w2, b2,
                           ln_scale, ln_bias, d_virt):
    """Backward of `edge_tail_sum_flat` from d_virt (N_virt, W): (d_x0
    (M, W) per slot, d_ew (M, h), d_rec_rows (N_virt, W), d_w2, d_b2,
    d_ln_scale, d_ln_bias); the first three in the inputs' dtype, the
    parameter gradients fp32.

    Replaces pallas_edge_flat.py::_tail_bwd_kernel (via
    _edge_tail_sum_flat_bwd), in two passes: the chain
    (`edge_tail_bwd_chain`, csrc/edge_flat_bwd.cu) and `weight_grad.xtd_sum`
    (csrc/weight_grad.cu) over the pair it gives. Both run their plain
    versions on a CPU tensor and their kernels on a CUDA tensor. Bound by
    fp32 operations on the card.
    """
    d_x0, d_ew, d_rec, (d_b2, d_ls, d_lb), pairs = edge_tail_bwd_chain(
        table, senders, ew, rec_rows, mask_p, w2, b2, ln_scale, ln_bias,
        d_virt)
    (d_w2,) = weight_grad.xtd_sum(pairs)
    return d_x0, d_ew, d_rec, d_w2, d_b2, d_ls, d_lb


def _fold(fold, d_x0, needed):
    """The table gradient: `fold` of the per-slot cotangent d_x0 (in
    d_x0's dtype: `EdgeSet.fold_senders` sums a bf16 d_x0 in fp32 and
    rounds once, as the JAX package's scatter-free gather backward
    does)."""
    if not needed:
        return None
    if fold is None:
        raise ValueError("the table gradient needs the edge set's sender "
                         "fold: pass fold=EdgeSet.fold_senders")
    return fold(d_x0)


class _EdgeTailSumFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, senders, ew, rec_rows, mask_p, w2, b2, ln_scale,
                ln_bias, fold):
        ctx.save_for_backward(table, senders, ew, rec_rows, mask_p, w2, b2,
                              ln_scale, ln_bias)
        ctx.fold = fold
        return _tail_fwd(table, senders, ew, rec_rows, mask_p, w2, b2,
                         ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, d_virt):
        need = ctx.needs_input_grad
        d_x0, d_ew, d_rec, *d_par = edge_tail_sum_flat_bwd(
            *ctx.saved_tensors, d_virt)
        return (_fold(ctx.fold, d_x0, need[0]), None, d_ew, d_rec, None,
                *d_par, None)


def edge_tail_sum_flat(table, senders, ew, rec_rows, mask_p, w2, b2,
                       ln_scale, ln_bias, *, fold=None):
    """Fused edge-MLP tail with a static edge term (g2m encoder).

    table: (N_send, W) sender transforms x_j @ W_j, one row per node.
    senders: (M,) int32 sender id per edge slot, M = N_virt*K.
    ew: (M, h) static edge term emb @ W_e + b0, shared across batch.
    rec_rows: (N_virt, W) receiver transforms per virtual row.
    fold: maps the per-slot sender cotangent (M, W) onto the table
    (`EdgeSet.fold_senders`); needed only for the table's gradient.
    Returns virt (N_virt, W): sum_k mask * LN(silu(x0) @ w2 + b2) with
    x0 = table[senders] + ew + rec_rows.

    Replaces pallas_edge_flat.py::_tail_sum_flat_kernel (via
    edge_tail_sum_flat). Its W2 product runs on tensor cores in 3xTF32
    (K3's tiles with one product), so it is bound by bytes on the card;
    see csrc/edge_flat.cu and csrc/edge_tc.cuh. bf16 table, ew and
    rec_rows give a bf16 virt, and their gradients run B2's bf16
    instance.
    """
    return _EdgeTailSumFlat.apply(table, senders, ew, rec_rows, mask_p, w2,
                                  b2, ln_scale, ln_bias, fold)


edge_tail_sum_flat.launches = 0
edge_tail_sum_flat.launches_bf16 = 0
edge_tail_sum_flat_bwd.launches = 0
edge_tail_sum_flat_bwd.launches_bf16 = 0


def _layer_from_gathered(edge_rep, g, rec_rows, mask_p, w_e, b0, w2, b2,
                         ln_scale, ln_bias, keep=None):
    """K3's math on pre-gathered sender rows g (M, W). `keep`, a dict,
    receives the intermediates x1 = silu(x0) and y (the LayerNorm's input),
    each (N_virt, K, B, h)."""
    n_virt, K = mask_p.shape
    M, W = edge_rep.shape
    h = w2.shape[0]
    B = W // h
    e = edge_rep.view(n_virt, K, B, h)
    x0 = (e @ w_e + b0 + g.view(n_virt, K, B, h)
          + rec_rows.view(n_virt, 1, B, h))
    x1 = F.silu(x0)
    y = x1 @ w2 + b2
    msg = layer_norm(y, ln_scale, ln_bias)
    if keep is not None:
        keep.update(x1=x1, y=y)
    return (e + msg).reshape(M, W), _masked_slot_sum(msg, mask_p)


def edge_layer_flat_plain(edge_rep, table, senders, rec_rows, mask_p, w_e,
                          b0, w2, b2, ln_scale, ln_bias):
    """Plain PyTorch version of `edge_layer_flat`'s forward (fp32 math,
    the outputs in edge_rep's dtype)."""
    outs = _layer_from_gathered(
        edge_rep.float(), table.index_select(0, senders).float(),
        rec_rows.float(), mask_p, w_e, b0, w2, b2, ln_scale, ln_bias)
    return tuple(t.to(edge_rep.dtype) for t in outs)


def _check_layer(edge_rep, table, senders, rec_rows, mask_p, w_e, w2,
                 what="edge_layer_flat"):
    """K3's and B3/B4's shapes; returns their instance's dtype and h, a
    built width."""
    n_virt, K = mask_p.shape
    M, W = edge_rep.shape
    h = _build.require_width(w2.shape[-1], what)
    _build.expect(M == n_virt * K and W % h == 0, "edge_rep",
                  edge_rep.shape)
    _build.expect(table.dim() == 2 and table.shape[1] == W, "table",
                  table.shape)
    _build.expect(rec_rows.shape == (n_virt, W), "rec_rows", rec_rows.shape)
    _build.expect(senders.shape == (M,), "senders", senders.shape)
    _build.expect(w_e.shape == (h, h) and w2.shape == (h, h),
                  "w_e/w2", (w_e.shape, w2.shape))
    return _build.io_dtype("edge_rep", edge_rep), h


def _layer_cuda(edge_rep, table, senders, rec_rows, mask_p, w_e, b0, w2,
                b2, ln_scale, ln_bias):
    dev = _build.require_cuda(edge_rep)
    n_virt, K = mask_p.shape
    W = edge_rep.shape[1]
    dt, h = _check_layer(edge_rep, table, senders, rec_rows, mask_p, w_e,
                         w2)
    params = torch.cat([w2.reshape(-1), b2, ln_scale, ln_bias,
                        w_e.reshape(-1), b0])
    edge_out = torch.empty_like(edge_rep)
    virt = torch.empty((n_virt, W), device=dev, dtype=dt)
    f32, i32 = torch.float32, torch.int32
    ptrs = _build.pointers(dev, ("edge_rep", edge_rep, dt),
                           ("table", table, dt), ("senders", senders, i32),
                           ("rec_rows", rec_rows, dt),
                           ("mask_p", mask_p, f32), ("params", params, f32),
                           ("edge_out", edge_out, dt), ("virt", virt, dt))
    lib = _lib(h)
    fn = (lib.nlt_edge_layer_bf16 if dt == torch.bfloat16
          else lib.nlt_edge_layer)
    rc = fn(*ptrs, n_virt, K, W // h, dev.index, _build.stream_of(dev))
    _build.check(lib, rc, "edge_layer_flat")
    _build.count_launch(edge_layer_flat, dt)
    return edge_out, virt


def _layer_fake(edge_rep, table, senders, rec_rows, mask_p, w_e, b0, w2, b2,
                ln_scale, ln_bias):
    if library.on_card(edge_rep):
        _check_layer(edge_rep, table, senders, rec_rows, mask_p, w_e, w2)
    return (torch.empty_like(edge_rep),
            edge_rep.new_empty((mask_p.shape[0], edge_rep.shape[1])))


# K3's operator (ops/library.py)
_layer_fwd = library.define(
    "edge_layer_flat",
    "(Tensor edge_rep, Tensor table, Tensor senders, Tensor rec_rows, "
    "Tensor mask_p, Tensor w_e, Tensor b0, Tensor w2, Tensor b2, "
    "Tensor ln_scale, Tensor ln_bias) -> (Tensor, Tensor)",
    cpu=edge_layer_flat_plain, cuda=_layer_cuda, fake=_layer_fake)


def edge_layer_flat_bwd_plain(edge_rep, table, senders, rec_rows, mask_p,
                              w_e, b0, w2, b2, ln_scale, ln_bias, d_edge_out,
                              d_virt):
    """Plain PyTorch version of `edge_layer_flat_bwd` (autograd through
    the plain forward on the gathered rows: fp32 math, the activation
    gradients in their inputs' dtype)."""
    g = table.index_select(0, senders)

    def fwd(edge_rep, g, rec_rows, w_e, b0, w2, b2, ln_scale, ln_bias):
        outs = _layer_from_gathered(edge_rep.float(), g.float(),
                                    rec_rows.float(), mask_p, w_e, b0, w2,
                                    b2, ln_scale, ln_bias)
        return tuple(t.to(edge_rep.dtype) for t in outs)

    return grads_through(
        fwd, (edge_rep, g, rec_rows, w_e, b0, w2, b2, ln_scale, ln_bias),
        (d_edge_out, d_virt))


def _layer_pairs(edge_rep, d_x0, x1, dy):
    """`xtd_sum`'s (X, D) pairs for (d_w2, d_w_e): (X1, DY) from the chain,
    and edge_rep and d_x0 (M, W) viewed (M*B, h), whose row (v*K + k)*B + b
    is X1's and DY's: no copy."""
    h = x1.shape[-1]
    return [(x1, dy), (edge_rep.reshape(-1, h), d_x0.reshape(-1, h))]


def edge_layer_bwd_chain_plain(edge_rep, table, senders, rec_rows, mask_p,
                               w_e, b0, w2, b2, ln_scale, ln_bias,
                               d_edge_out, d_virt):
    """Plain PyTorch version of `edge_layer_bwd_chain`, by autograd through
    the plain forward (fp32 math) with its intermediates kept; d_edge_rep,
    d_x0 and d_rec_rows in their inputs' dtypes, each rounded once, and
    the dW_e pair on the unrounded d_x0."""
    with torch.enable_grad():
        leaves = _fp32_leaves(edge_rep, table.index_select(0, senders),
                              rec_rows, b0, b2, ln_scale, ln_bias)
        e, g, rec, vb0, vb2, vls, vlb = leaves
        keep = {}
        outs = _layer_from_gathered(e, g, rec, mask_p, w_e.detach(), vb0,
                                    w2.detach(), vb2, vls, vlb, keep)
        pairs = [(o, d.float()) for o, d in zip(outs, (d_edge_out, d_virt))
                 if d is not None]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    leaves + [keep["y"]],
                                    [d for _, d in pairs])
    d_e, d_x0, d_rec, *d_vec, d_y = grads
    h = w2.shape[0]
    return (d_e.to(edge_rep.dtype), d_x0.to(table.dtype),
            d_rec.to(rec_rows.dtype), tuple(d_vec),
            _layer_pairs(edge_rep, d_x0, keep["x1"].detach().reshape(-1, h),
                         d_y.reshape(-1, h)))


def edge_layer_bwd_chain(edge_rep, table, senders, rec_rows, mask_p, w_e, b0,
                         w2, b2, ln_scale, ln_bias, d_edge_out, d_virt):
    """B3/B4's chain pass: (d_edge_rep, d_x0 (M, W) per slot, d_rec_rows,
    (d_b0, d_b2, d_ln_scale, d_ln_bias), the (X, D) pairs of (d_w2, d_w_e)
    for `weight_grad.xtd_sum`). `edge_layer_bwd_chain_plain` on a CPU
    tensor, the chain kernel of csrc/edge_flat_bwd.cu on a CUDA tensor (its
    instance of edge_rep's dtype; the cotangents in that dtype too); its
    launches count on `edge_layer_flat_bwd.launches` (`launches_bf16`)."""
    if edge_rep.device.type == "cpu":
        return edge_layer_bwd_chain_plain(edge_rep, table, senders, rec_rows,
                                          mask_p, w_e, b0, w2, b2, ln_scale,
                                          ln_bias, d_edge_out, d_virt)
    dev = _build.require_cuda(edge_rep)
    n_virt, K = mask_p.shape
    M, W = edge_rep.shape
    dt, h = _check_layer(edge_rep, table, senders, rec_rows, mask_p, w_e, w2,
                         "edge_layer_flat_bwd")
    _build.expect(d_virt.shape == (n_virt, W), "d_virt", d_virt.shape)
    # K3's blob; at width 128 W_e^T after it, which the kernel reads from
    # device memory (csrc/edge_flat_bwd.cu)
    params = torch.cat([w2.reshape(-1), b2, ln_scale, ln_bias,
                        w_e.reshape(-1), b0]
                       + ([w_e.t().reshape(-1)] if h > 64 else []))
    d_virt = d_virt.contiguous()
    f32, i32 = torch.float32, torch.int32
    d_x0 = torch.empty_like(edge_rep)
    # the bf16 instance writes d_x0 once more, unrounded, for dW_e
    d_x0_f = (torch.empty((M, W), device=dev, dtype=f32)
              if dt == torch.bfloat16 else None)
    d_e = torch.empty_like(edge_rep)
    d_rec = torch.empty((n_virt, W), device=dev, dtype=dt)
    x1 = torch.empty((M * (W // h), h), device=dev, dtype=f32)
    dy = torch.empty_like(x1)
    ptrs = _build.pointers(dev, ("edge_rep", edge_rep, dt),
                           ("table", table, dt), ("senders", senders, i32),
                           ("rec_rows", rec_rows, dt),
                           ("mask_p", mask_p, f32), ("params", params, f32),
                           ("d_virt", d_virt, dt))
    if d_edge_out is None:
        ptrs.append(None)
    else:
        d_edge_out = d_edge_out.contiguous()
        ptrs += _build.pointers(dev, ("d_edge_out", d_edge_out, dt))
    ptrs += _build.pointers(dev, ("d_x0", d_x0, dt))
    ptrs.append(None if d_x0_f is None else
                _build.pointers(dev, ("d_x0_f", d_x0_f, f32))[0])
    ptrs += _build.pointers(dev, ("d_e", d_e, dt), ("d_rec", d_rec, dt),
                            ("x1", x1, f32), ("dy", dy, f32))
    g = _build.run_bwd(_bwd_lib(h), "nlt_edge_layer_bwd" + _build.suffix(dt),
                       ptrs, [n_virt, K, W // h], 4 * h, dev,
                       "edge_layer_flat_bwd")
    _build.count_launch(edge_layer_flat_bwd, dt)
    d_b2, d_ls, d_lb, d_b0 = g.view(4, h)
    return (d_e, d_x0, d_rec, (d_b0, d_b2, d_ls, d_lb),
            _layer_pairs(edge_rep, d_x0 if d_x0_f is None else d_x0_f, x1,
                         dy))


def edge_layer_flat_bwd(edge_rep, table, senders, rec_rows, mask_p, w_e, b0,
                        w2, b2, ln_scale, ln_bias, d_edge_out, d_virt):
    """Backward of `edge_layer_flat` from d_edge_out (M, W) or None (the
    last layer's edge state is unused) and d_virt (N_virt, W): (d_edge_rep,
    d_x0 (M, W) per slot, d_rec_rows, d_w_e, d_b0, d_w2, d_b2, d_ln_scale,
    d_ln_bias); the first three in the inputs' dtype, the parameter
    gradients fp32.

    Replaces pallas_edge_flat.py::_layer_bwd_kernel (via
    _edge_layer_flat_bwd) and ::_layer_bwd_win_kernel (via
    edge_layer_flat_win_bwd), in two passes: the chain
    (`edge_layer_bwd_chain`, csrc/edge_flat_bwd.cu) and
    `weight_grad.xtd_sum` (csrc/weight_grad.cu) over the pairs it gives.
    Both run their plain versions on a CPU tensor and their kernels on a
    CUDA tensor. Bound by fp32 operations on the card.
    """
    d_e, d_x0, d_rec, (d_b0, d_b2, d_ls, d_lb), pairs = edge_layer_bwd_chain(
        edge_rep, table, senders, rec_rows, mask_p, w_e, b0, w2, b2,
        ln_scale, ln_bias, d_edge_out, d_virt)
    d_w2, d_w_e = weight_grad.xtd_sum(pairs)
    return d_e, d_x0, d_rec, d_w_e, d_b0, d_w2, d_b2, d_ls, d_lb


class _EdgeLayerFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_rep, table, senders, rec_rows, mask_p, w_e, b0, w2,
                b2, ln_scale, ln_bias, fold):
        ctx.save_for_backward(edge_rep, table, senders, rec_rows, mask_p,
                              w_e, b0, w2, b2, ln_scale, ln_bias)
        ctx.fold = fold
        # the last processor layer's edge state is never read: its
        # gradient arrives as None instead of a zero (M, W) tensor
        ctx.set_materialize_grads(False)
        return _layer_fwd(edge_rep, table, senders, rec_rows, mask_p, w_e,
                          b0, w2, b2, ln_scale, ln_bias)

    @staticmethod
    def backward(ctx, d_edge_out, d_virt):
        need = ctx.needs_input_grad
        saved = ctx.saved_tensors
        if d_virt is None:
            d_virt = torch.zeros((saved[4].shape[0], saved[0].shape[1]),
                                 device=saved[0].device,
                                 dtype=saved[0].dtype)
        d_e, d_x0, d_rec, *d_par = edge_layer_flat_bwd(*saved, d_edge_out,
                                                       d_virt)
        return (d_e, _fold(ctx.fold, d_x0, need[1]), None, d_rec, None,
                *d_par, None)


def edge_layer_flat(edge_rep, table, senders, rec_rows, mask_p, w_e, b0, w2,
                    b2, ln_scale, ln_bias, *, fold=None):
    """Fused residual edge layer with evolving edge state (m2m processor).

    edge_rep: (M, W) edge state; table/senders/rec_rows/mask_p/fold as in
    `edge_tail_sum_flat`. Returns (edge_out = edge_rep + msg, virt) with
    msg = LN(silu(edge_rep @ w_e + b0 + table[senders] + rec_rows) @ w2
    + b2). edge_out at padding slots is computed the same way.

    Replaces pallas_edge_flat.py::_layer_flat_kernel (edge_layer_flat) and
    ::_layer_flat_win_kernel (edge_layer_flat_win). Its W_e and W2
    products run on tensor cores in 3xTF32, so it is bound by bytes on the
    card; see csrc/edge_flat.cu and csrc/edge_tc.cuh. bf16 edge_rep,
    table and rec_rows give bf16 outputs, and their gradients run B3/B4's
    bf16 instance.
    """
    return _EdgeLayerFlat.apply(edge_rep, table, senders, rec_rows, mask_p,
                                w_e, b0, w2, b2, ln_scale, ln_bias, fold)


edge_layer_flat.launches = 0
edge_layer_flat.launches_bf16 = 0
edge_layer_flat_bwd.launches = 0
edge_layer_flat_bwd.launches_bf16 = 0
