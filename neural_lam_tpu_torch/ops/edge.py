"""Batched-layout edge-MLP tail (P1, P2) and processor edge layer (P3).

Counterpart of neural_lam_tpu/ops/pallas_edge.py: the kernels the JAX
package runs for dense edge sets off the flat route (`flat_eligible`
false), where activations keep the (B, rows, h) layout.

Layout: x0, edge state and messages are (B, M, h) with M = N_virt*K slots;
rec_rows and virt are (B, N_virt, h); send_t is the (B, N_send, h) sender
node table, read by index (`senders`, (M,) int32) inside the kernel, so
`edge_tail_sum` and `edge_layer` take the table where the JAX functions
take `send_t[:, senders]` (and `edge_layer` covers both of its `in_gather`
variants). mask is the EdgeSet's (M, 1) slot validity.

Each function is a `torch.autograd.Function` on both devices. Its forward
calls its operator (`nlt::edge_tail`, `nlt::edge_tail_sum`,
`nlt::edge_layer`; `ops/library.py`), which runs the plain PyTorch version
(`*_plain`, same module) on a CPU tensor and the CUDA kernel
(`csrc/edge.cu`) on a CUDA tensor; there is no fallback
from one to the other. P1, P2 and P3 are the batched-layout instances of
K2's and K3's tensor-core kernel (`csrc/edge_tc.cuh`); P1 is its
materialised-x0 mode. The backward recomputes with autograd through the
JAX package's reference math (`_tail_ref`, `_tail_sum_ref`, `_layer_ref`:
its `_tail_reference`, `_sum_reference` and `_layer_reference`), as the
JAX package's VJPs do: it has no backward kernel for these three.
`<wrapper>.launches` counts kernel launches, and of P1's,
`edge_tail.launches_with_messages` those that write the messages
(HiLAMParallel's processor chunks).

bf16 (the bf16 path): P2 and P3 have bf16 instances, taken for a bf16
send_t / edge_rep, which read the node table, ew or the edge state and
rec_rows in bf16, compute in fp32 on the fp32 parameters and store their
outputs in bf16 (round to nearest even), as the JAX kernels do on bf16
inputs; `<wrapper>.launches_bf16` counts them. Their backward recomputes
on the bf16 residuals as the JAX references do: P2's x0 and silu in bf16,
op by op (`_silu_ref`), the products on the operands widened to fp32, and
every sum of a bf16 gradient over slots or batch elements in bf16, one
term after the other (`_sum_seq`), as XLA reduces a bf16 array; P3's x0
is fp32 (its edge term is). P1 has no bf16 instance: in the bf16 path its
x0 is promoted to fp32 by its fp32 first term
(`message_passing.edge_messages_and_virt`), so it runs its fp32 instance,
and a bf16 x0 on the card raises TypeError.

Widths: each kernel takes h = w2's width at every width it is built for
(`_build.WIDTHS`: 32, 64, 128), from that width's library; any other h
raises on a CUDA tensor. The plain versions take any width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, library
from .mlp import layer_norm
from .segment import gather_rows_batched

MAX_K = 8  # slots per virtual row the kernels are instantiated for

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "nlt_batched_edge_tail": [_P] * 5 + [_I] * 4 + [_P],
    "nlt_batched_edge_tail_sum": [_P] * 8 + [_I] * 5 + [_P],
    "nlt_batched_edge_layer": [_P] * 8 + [_I] * 5 + [_P],
    "nlt_batched_edge_tail_sum_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "nlt_batched_edge_layer_bf16": [_P] * 8 + [_I] * 5 + [_P],
}


def _lib(h):
    return _build.library("edge", _SIGNATURES, h)


def _sum_seq(x, dim):
    """x summed over `dim`: in fp32 by `sum`; a bf16 x slice after slice in
    bf16, each partial sum rounded, as XLA reduces a bf16 array (the
    backward of the JAX package's broadcasts and `jnp.repeat` in bf16)."""
    if x.dtype != torch.bfloat16:
        return x.sum(dim)
    out = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        out = out + x.select(dim, i)
    return out


class _RepeatRows(torch.autograd.Function):
    """rec_rows (B, N_virt, h) repeated over each row's K slots -> (B, M,
    h), `jnp.repeat(rec_rows, K, axis=-2)`; its backward sums the K slots'
    gradients with `_sum_seq`."""

    @staticmethod
    def forward(ctx, rec_rows, K):
        ctx.K = K
        B, n, h = rec_rows.shape
        return rec_rows[:, :, None, :].expand(B, n, K, h).reshape(B, n * K, h)

    @staticmethod
    def backward(ctx, d):
        B, M, h = d.shape
        return _sum_seq(d.reshape(B, M // ctx.K, ctx.K, h), 2), None


class _ExpandBatch(torch.autograd.Function):
    """ew (M, h) broadcast over B batch elements -> (B, M, h); its backward
    sums the batch elements' gradients with `_sum_seq`."""

    @staticmethod
    def forward(ctx, ew, B):
        return ew[None].expand(B, *ew.shape)

    @staticmethod
    def backward(ctx, d):
        return _sum_seq(d, 0), None


class _SiluBf16(torch.autograd.Function):
    """jax.nn.silu on a bf16 tensor as XLA computes it, every operation
    rounded to bf16: s = 1 / (1 + exp(-x)), x * s; and its VJP, d * s + (x
    * d) * (s * (1 - s)), with the same roundings."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s, s * (1 - s))
        return x * s

    @staticmethod
    def backward(ctx, d):
        x, s, ds = ctx.saved_tensors
        return d * s + (x * d) * ds


def _silu_ref(x):
    """silu as the JAX reference computes it: fp32 `F.silu`; bf16 op by op
    (`_SiluBf16`)."""
    if x.dtype == torch.bfloat16:
        return _SiluBf16.apply(x)
    return F.silu(x)


def _tail_ref(x0, w2, b2, ln_scale, ln_bias, mask, K):
    """(msg, virt), both fp32, of the tail on x0 (B, M, h): the JAX
    package's `_tail_reference`, silu in x0's dtype, the product on x0
    widened (its `jnp.dot` promotes)."""
    msg = layer_norm(_silu_ref(x0).float() @ w2 + b2, ln_scale, ln_bias)
    B, M, h = msg.shape
    return msg, (msg * mask).view(B, M // K, K, h).sum(dim=2)


def _tail_sum_ref(send_t, senders, ew, rec_rows, w2, b2, ln_scale, ln_bias,
                  mask, K):
    """The JAX package's `_sum_reference` on its gathered rows: x0 =
    send_t[:, senders] + ew + rec_rows repeated, in the inputs' dtype."""
    g = gather_rows_batched(send_t, senders)
    x0 = g + _ExpandBatch.apply(ew, g.shape[0]) + _RepeatRows.apply(rec_rows,
                                                                    K)
    return _tail_ref(x0, w2, b2, ln_scale, ln_bias, mask, K)


def _layer_ref(edge_rep, send_t, senders, rec_rows, mask, w_e, b0, w2, b2,
               ln_scale, ln_bias, K):
    """The JAX package's `_layer_reference` on its gathered rows: x0 =
    edge_rep @ w_e (fp32) + send_t[:, senders] + rec_rows repeated + b0,
    the bf16 terms widened by the fp32 sum; (edge_rep + msg, virt), fp32."""
    x0 = (edge_rep.float() @ w_e + gather_rows_batched(send_t, senders)
          + _RepeatRows.apply(rec_rows, K) + b0)
    msg, virt = _tail_ref(x0, w2, b2, ln_scale, ln_bias, mask, K)
    return edge_rep + msg, virt


def sum_x0(x_e, send_t, senders, rec_rows, K):
    """x_e (B or 1, M, h) + send_t[:, senders] + rec_rows repeated over
    the K slots of each virtual row (`_RepeatRows`): x0 of the batched
    tail."""
    return (x_e + gather_rows_batched(send_t, senders)
            + _RepeatRows.apply(rec_rows, K))


def _widened(*tensors):
    return tuple(t.float() for t in tensors)


def edge_tail_plain(x0, w2, b2, ln_scale, ln_bias, mask, K,
                    with_messages=True):
    """Plain PyTorch version of `edge_tail`'s forward (`_tail_ref` on x0
    widened: fp32 math, the outputs in x0's dtype)."""
    msg, virt = _tail_ref(x0.float(), w2, b2, ln_scale, ln_bias, mask, K)
    return (msg.to(x0.dtype) if with_messages else None), virt.to(x0.dtype)


def edge_tail_sum_plain(send_t, senders, ew, rec_rows, w2, b2, ln_scale,
                        ln_bias, mask, K, with_messages=True):
    """Plain PyTorch version of `edge_tail_sum`'s forward (`_tail_sum_ref`
    on its inputs widened: fp32 math, the outputs in send_t's dtype)."""
    send, ew32, rec = _widened(send_t, ew, rec_rows)
    msg, virt = _tail_sum_ref(send, senders, ew32, rec, w2, b2, ln_scale,
                              ln_bias, mask, K)
    return ((msg.to(send_t.dtype) if with_messages else None),
            virt.to(send_t.dtype))


def edge_layer_plain(edge_rep, send_t, senders, rec_rows, mask, w_e, b0, w2,
                     b2, ln_scale, ln_bias, K):
    """Plain PyTorch version of `edge_layer`'s forward (`_layer_ref` on its
    inputs widened: fp32 math, the outputs in edge_rep's dtype)."""
    outs = _layer_ref(*_widened(edge_rep, send_t), senders,
                      rec_rows.float(), mask, w_e, b0, w2, b2, ln_scale,
                      ln_bias, K)
    return tuple(t.to(edge_rep.dtype) for t in outs)


def _plain_grads(fn, inputs, needs, output_grads):
    """Gradients of fn(*inputs) for the inputs flagged in `needs` (None for
    the others), by autograd through fn on detached leaves; output
    cotangents that are None are skipped, the others widened to their
    output's dtype (a reference's fp32 outputs take a bf16 kernel output's
    cotangent)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() if n else t
                  for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
        pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, output_grads)
                 if o is not None and g is not None]
        wrt = [t for t, n in zip(leaves, needs) if n]
        if not pairs or not wrt:
            return [None] * len(inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return [next(got) if n else None for n in needs]


def _check_common(mask, params_hh, K, M, what):
    """The checks every P kernel shares; returns h (the width of its
    (h, h) weights, a built width)."""
    _build.expect(1 <= K <= MAX_K and M % K == 0, "K", (K, M))
    _build.expect(mask.numel() == M, "mask", mask.shape)
    h = _build.require_width(params_hh[0][1].shape[-1], what)
    for name, w in params_hh:
        _build.expect(w.shape == (h, h), name, w.shape)
    return h


def _tail_params(w2, b2, ln_scale, ln_bias, *layer):
    return torch.cat([w2.reshape(-1), b2, ln_scale, ln_bias]
                     + [t.reshape(-1) for t in layer])


def _outputs(dev, B, M, K, h, with_messages, dtype=torch.float32):
    msg = (torch.empty((B, M, h), device=dev, dtype=dtype)
           if with_messages else None)
    virt = torch.empty((B, M // K, h), device=dev, dtype=dtype)
    return msg, virt


def _msg_or_empty(msg, like):
    """An operator's messages output: `msg`, or an empty tensor where the
    call asked for none."""
    return like.new_empty(0) if msg is None else msg


def _check_tail(x0, w2, mask, K):
    """P1's shapes (fp32 only: it has no bf16 instance); returns h."""
    B, M, h = x0.shape
    _build.expect(h == w2.shape[-1], "x0", x0.shape)
    return _check_common(mask, [("w2", w2)], K, M, "edge_tail")


def _tail_cuda(x0, w2, b2, ln_scale, ln_bias, mask, K, with_messages):
    dev = _build.require_cuda(x0)
    h = _check_tail(x0, w2, mask, K)
    B, M, _ = x0.shape
    x0, mask = x0.contiguous(), mask.contiguous()
    params = _tail_params(w2, b2, ln_scale, ln_bias)
    msg, virt = _outputs(dev, B, M, K, h, with_messages)
    f32 = torch.float32
    ptrs = _build.pointers(dev, ("x0", x0, f32), ("mask", mask, f32),
                           ("params", params, f32))
    ptrs.append(None if msg is None else
                _build.pointers(dev, ("msg", msg, f32))[0])
    ptrs += _build.pointers(dev, ("virt", virt, f32))
    lib = _lib(h)
    rc = lib.nlt_batched_edge_tail(*ptrs, M // K, K, B, dev.index,
                                   _build.stream_of(dev))
    _build.check(lib, rc, "edge_tail")
    edge_tail.launches += 1
    if msg is not None:
        edge_tail.launches_with_messages += 1
    return _msg_or_empty(msg, virt), virt


def _tail_plain(x0, w2, b2, ln_scale, ln_bias, mask, K, with_messages):
    msg, virt = edge_tail_plain(x0, w2, b2, ln_scale, ln_bias, mask, K,
                                with_messages)
    return _msg_or_empty(msg, virt), virt


def _tail_fake(x0, w2, b2, ln_scale, ln_bias, mask, K, with_messages):
    if library.on_card(x0):
        _check_tail(x0, w2, mask, K)
    B, M, _ = x0.shape
    h = w2.shape[1]
    msg = x0.new_empty((B, M, h) if with_messages else (0,))
    return msg, x0.new_empty((B, M // K, h))


# P1's operator (ops/library.py)
_tail_op = library.define(
    "edge_tail",
    "(Tensor x0, Tensor w2, Tensor b2, Tensor ln_scale, Tensor ln_bias, "
    "Tensor mask, int K, bool with_messages) -> (Tensor, Tensor)",
    cpu=_tail_plain, cuda=_tail_cuda, fake=_tail_fake)


def _tail_fwd(x0, w2, b2, ln_scale, ln_bias, mask, K, with_messages):
    msg, virt = _tail_op(x0, w2, b2, ln_scale, ln_bias, mask, K,
                         with_messages)
    return (msg if with_messages else None), virt


def _check_tail_sum(send_t, senders, ew, rec_rows, w2, mask, K):
    """P2's shapes; returns its instance's dtype and h."""
    B, n_send, hs = send_t.shape
    M = senders.shape[0]
    h = _check_common(mask, [("w2", w2)], K, M, "edge_tail_sum")
    _build.expect(hs == h, "send_t", send_t.shape)
    _build.expect(ew.shape == (M, h), "ew", ew.shape)
    _build.expect(rec_rows.shape == (B, M // K, h), "rec_rows",
                  rec_rows.shape)
    return _build.io_dtype("send_t", send_t), h


def _tail_sum_cuda(send_t, senders, ew, rec_rows, w2, b2, ln_scale, ln_bias,
                   mask, K, with_messages):
    dev = _build.require_cuda(send_t)
    dt, h = _check_tail_sum(send_t, senders, ew, rec_rows, w2, mask, K)
    B, n_send, _ = send_t.shape
    M = senders.shape[0]
    send_t, ew = send_t.contiguous(), ew.contiguous()
    rec_rows, mask = rec_rows.contiguous(), mask.contiguous()
    params = _tail_params(w2, b2, ln_scale, ln_bias)
    msg, virt = _outputs(dev, B, M, K, h, with_messages, dt)
    f32, i32 = torch.float32, torch.int32
    ptrs = _build.pointers(dev, ("send_t", send_t, dt),
                           ("senders", senders, i32), ("ew", ew, dt),
                           ("rec_rows", rec_rows, dt), ("mask", mask, f32),
                           ("params", params, f32))
    ptrs.append(None if msg is None else
                _build.pointers(dev, ("msg", msg, dt))[0])
    ptrs += _build.pointers(dev, ("virt", virt, dt))
    lib = _lib(h)
    fn = (lib.nlt_batched_edge_tail_sum_bf16 if dt == torch.bfloat16
          else lib.nlt_batched_edge_tail_sum)
    rc = fn(*ptrs, M // K, K, B, n_send, dev.index, _build.stream_of(dev))
    _build.check(lib, rc, "edge_tail_sum")
    _build.count_launch(edge_tail_sum, dt)
    return _msg_or_empty(msg, virt), virt


def _tail_sum_plain(send_t, senders, ew, rec_rows, w2, b2, ln_scale, ln_bias,
                    mask, K, with_messages):
    msg, virt = edge_tail_sum_plain(send_t, senders, ew, rec_rows, w2, b2,
                                    ln_scale, ln_bias, mask, K,
                                    with_messages)
    return _msg_or_empty(msg, virt), virt


def _tail_sum_fake(send_t, senders, ew, rec_rows, w2, b2, ln_scale, ln_bias,
                   mask, K, with_messages):
    if library.on_card(send_t):
        _check_tail_sum(send_t, senders, ew, rec_rows, w2, mask, K)
    B = send_t.shape[0]
    M = senders.shape[0]
    h = w2.shape[1]
    msg = send_t.new_empty((B, M, h) if with_messages else (0,))
    return msg, send_t.new_empty((B, M // K, h))


# P2's operator (ops/library.py)
_tail_sum_op = library.define(
    "edge_tail_sum",
    "(Tensor send_t, Tensor senders, Tensor ew, Tensor rec_rows, Tensor w2, "
    "Tensor b2, Tensor ln_scale, Tensor ln_bias, Tensor mask, int K, "
    "bool with_messages) -> (Tensor, Tensor)",
    cpu=_tail_sum_plain, cuda=_tail_sum_cuda, fake=_tail_sum_fake)


def _tail_sum_fwd(send_t, senders, ew, rec_rows, w2, b2, ln_scale, ln_bias,
                  mask, K, with_messages):
    msg, virt = _tail_sum_op(send_t, senders, ew, rec_rows, w2, b2,
                             ln_scale, ln_bias, mask, K, with_messages)
    return (msg if with_messages else None), virt


def _check_layer(edge_rep, send_t, senders, rec_rows, mask, w_e, w2, K):
    """P3's shapes; returns its instance's dtype and h."""
    B, M, he = edge_rep.shape
    h = _check_common(mask, [("w_e", w_e), ("w2", w2)], K, M, "edge_layer")
    _build.expect(he == h, "edge_rep", edge_rep.shape)
    _build.expect(send_t.dim() == 3 and send_t.shape[0] == B
                  and send_t.shape[2] == h, "send_t", send_t.shape)
    _build.expect(senders.shape == (M,), "senders", senders.shape)
    _build.expect(rec_rows.shape == (B, M // K, h), "rec_rows",
                  rec_rows.shape)
    return _build.io_dtype("edge_rep", edge_rep), h


def _layer_cuda(edge_rep, send_t, senders, rec_rows, mask, w_e, b0, w2, b2,
                ln_scale, ln_bias, K):
    dev = _build.require_cuda(edge_rep)
    dt, h = _check_layer(edge_rep, send_t, senders, rec_rows, mask, w_e, w2,
                         K)
    B, M, _ = edge_rep.shape
    edge_rep, send_t = edge_rep.contiguous(), send_t.contiguous()
    rec_rows, mask = rec_rows.contiguous(), mask.contiguous()
    params = _tail_params(w2, b2, ln_scale, ln_bias, w_e, b0)
    edge_out, virt = _outputs(dev, B, M, K, h, True, dt)
    f32, i32 = torch.float32, torch.int32
    ptrs = _build.pointers(dev, ("edge_rep", edge_rep, dt),
                           ("send_t", send_t, dt), ("senders", senders, i32),
                           ("rec_rows", rec_rows, dt), ("mask", mask, f32),
                           ("params", params, f32),
                           ("edge_out", edge_out, dt), ("virt", virt, dt))
    lib = _lib(h)
    fn = (lib.nlt_batched_edge_layer_bf16 if dt == torch.bfloat16
          else lib.nlt_batched_edge_layer)
    rc = fn(*ptrs, M // K, K, B, send_t.shape[1], dev.index,
            _build.stream_of(dev))
    _build.check(lib, rc, "edge_layer")
    _build.count_launch(edge_layer, dt)
    return edge_out, virt


def _layer_fake(edge_rep, send_t, senders, rec_rows, mask, w_e, b0, w2, b2,
                ln_scale, ln_bias, K):
    if library.on_card(edge_rep):
        _check_layer(edge_rep, send_t, senders, rec_rows, mask, w_e, w2, K)
    B, M, h = edge_rep.shape
    return (edge_rep.new_empty((B, M, h)),
            edge_rep.new_empty((B, M // K, h)))


# P3's operator (ops/library.py)
_layer_fwd = library.define(
    "edge_layer",
    "(Tensor edge_rep, Tensor send_t, Tensor senders, Tensor rec_rows, "
    "Tensor mask, Tensor w_e, Tensor b0, Tensor w2, Tensor b2, "
    "Tensor ln_scale, Tensor ln_bias, int K) -> (Tensor, Tensor)",
    cpu=edge_layer_plain, cuda=_layer_cuda, fake=_layer_fake)


class _EdgeTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, w2, b2, ln_scale, ln_bias, mask, K, with_messages):
        ctx.save_for_backward(x0, w2, b2, ln_scale, ln_bias, mask)
        ctx.K, ctx.with_messages = K, with_messages
        ctx.set_materialize_grads(False)
        msg, virt = _tail_fwd(x0, w2, b2, ln_scale, ln_bias, mask, K,
                              with_messages)
        return (msg, virt) if with_messages else virt

    @staticmethod
    def backward(ctx, *grads):
        if not ctx.with_messages:
            grads = (None,) + grads
        K = ctx.K
        d = _plain_grads(
            lambda *a: _tail_ref(*a, K), ctx.saved_tensors,
            ctx.needs_input_grad[:6], grads)
        return (*d, None, None)


def edge_tail(x0, w2, b2, ln_scale, ln_bias, mask, K: int,
              with_messages: bool = True):
    """Fused edge-MLP tail on a materialised x0 (B, M, h); mask (M, 1).

    Returns (msg (B, M, h) or None, virt (B, M/K, h)) with msg =
    LN(silu(x0) @ w2 + b2) at every slot (padding included) and virt the
    masked sum of each virtual row's K slots. with_messages=False skips
    writing msg (update_edges=False rounds need only virt).

    Replaces pallas_edge.py::_tail_kernel (via _edge_tail_fwd_impl).
    Bound by bytes on the card (x0 in, virt and msg out), its W2 product
    on tensor cores in 3xTF32; see csrc/edge_tc.cuh. fp32 only: a bf16
    x0 raises TypeError on the card. Its backward recomputes through
    `_tail_ref`.
    """
    out = _EdgeTail.apply(x0, w2, b2, ln_scale, ln_bias, mask, K,
                          with_messages)
    return out if with_messages else (None, out)


class _EdgeTailSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send_t, senders, ew, rec_rows, w2, b2, ln_scale,
                ln_bias, mask, K, with_messages):
        ctx.save_for_backward(send_t, senders, ew, rec_rows, w2, b2,
                              ln_scale, ln_bias, mask)
        ctx.K, ctx.with_messages = K, with_messages
        ctx.set_materialize_grads(False)
        msg, virt = _tail_sum_fwd(send_t, senders, ew, rec_rows, w2, b2,
                                  ln_scale, ln_bias, mask, K, with_messages)
        return (msg, virt) if with_messages else virt

    @staticmethod
    def backward(ctx, *grads):
        if not ctx.with_messages:
            grads = (None,) + grads
        K = ctx.K
        d = _plain_grads(
            lambda *a: _tail_sum_ref(*a, K), ctx.saved_tensors,
            ctx.needs_input_grad[:9], grads)
        return (*d, None, None)


def edge_tail_sum(send_t, senders, ew, rec_rows, w2, b2, ln_scale, ln_bias,
                  mask, K: int, with_messages: bool = True):
    """Fused edge-MLP tail with a static edge term (update_edges=False
    encoders and decoders off the flat route).

    send_t: (B, N_send, h) sender transforms x_j @ W_j; senders: (M,)
    int32; ew: (M, h) static edge term emb @ W_e + b0, shared across the
    batch; rec_rows: (B, M/K, h) receiver transforms per virtual row.
    Returns (msg or None, virt) as `edge_tail` does, with x0 =
    send_t[:, senders] + ew + rec_rows repeated over each row's K slots.

    Replaces pallas_edge.py::_tail_sum_kernel (via _edge_tail_sum_impl).
    Bound by bytes on the card (the gathered sender rows, ew, rec_rows,
    virt and msg), its W2 product on tensor cores in 3xTF32; see
    csrc/edge_tc.cuh. bf16 send_t, ew and rec_rows give bf16 outputs;
    the backward recomputes through `_tail_sum_ref` on them.
    """
    out = _EdgeTailSum.apply(send_t, senders, ew, rec_rows, w2, b2,
                             ln_scale, ln_bias, mask, K, with_messages)
    return out if with_messages else (None, out)


class _EdgeLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_rep, send_t, senders, rec_rows, mask, w_e, b0, w2,
                b2, ln_scale, ln_bias, K):
        ctx.save_for_backward(edge_rep, send_t, senders, rec_rows, mask,
                              w_e, b0, w2, b2, ln_scale, ln_bias)
        ctx.K = K
        # the last processor layer's edge state is never read: its
        # gradient arrives as None
        ctx.set_materialize_grads(False)
        return _layer_fwd(edge_rep, send_t, senders, rec_rows, mask, w_e,
                          b0, w2, b2, ln_scale, ln_bias, K)

    @staticmethod
    def backward(ctx, d_edge_out, d_virt):
        K = ctx.K
        d = _plain_grads(
            lambda *a: _layer_ref(*a, K), ctx.saved_tensors,
            ctx.needs_input_grad[:11], (d_edge_out, d_virt))
        return (*d, None)


def edge_layer(edge_rep, send_t, senders, rec_rows, mask, w_e, b0, w2, b2,
               ln_scale, ln_bias, K: int):
    """Fused residual edge layer with evolving edge state (processor rounds
    off the flat route).

    edge_rep: (B, M, h) edge state; send_t/senders/rec_rows/mask as in
    `edge_tail_sum`. Returns (edge_out = edge_rep + msg, virt) with msg =
    LN(silu(edge_rep @ w_e + b0 + send_t[:, senders] + rec_rows) @ w2 +
    b2); edge_out at padding slots is computed the same way.

    Replaces pallas_edge.py::_layer_kernel (via _edge_layer_impl), both
    in_gather variants. Bound by bytes on the card (the edge rows in and
    out, the gathered sender rows, rec_rows, virt), its W_e and W2
    products on tensor cores in 3xTF32; see csrc/edge_tc.cuh. bf16
    edge_rep, send_t and rec_rows give bf16 outputs; the backward
    recomputes through `_layer_ref` on them.
    """
    return _EdgeLayer.apply(edge_rep, send_t, senders, rec_rows, mask, w_e,
                            b0, w2, b2, ln_scale, ln_bias, K)


edge_tail.launches = 0
edge_tail.launches_with_messages = 0
edge_tail_sum.launches = 0
edge_layer.launches = 0
edge_tail_sum.launches_bf16 = 0
edge_layer.launches_bf16 = 0
