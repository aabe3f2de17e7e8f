"""Grid-feature embedder (K1) and its backward (B1): MLP + LayerNorm.

Counterpart of neural_lam_tpu/ops/pallas_embed.py. The caller packs the
concatenated per-node features into the flat layout once, x_f (N, B*d_in),
and one pass computes per (node, batch element) row

    out = LayerNorm(silu(x @ w0 + b0) @ w1 + b1)          -> (N, B*h)

Unlike the TPU kernel, d_in is not zero-padded to a lane multiple.

`embed_grid_flat` is a `torch.autograd.Function` on both devices. Its
forward calls the operator `nlt::embed_grid_flat` (`ops/library.py`),
which runs the plain version on a CPU tensor and the CUDA kernel
(`csrc/embed.cu`) on a CUDA tensor; its backward, likewise, runs
`embed_grid_flat_bwd_plain` or the backward kernel (`csrc/embed_bwd.cu`).
The forward saves only its inputs: the backward recomputes it, as the JAX
residuals do. `embed_grid_flat.launches` and `embed_grid_flat_bwd.launches`
count kernel launches.

A bf16 x_f (the bf16 path) takes the bf16 instances: the forward reads x
in bf16, runs every product and the LayerNorm in fp32 on the fp32
parameters and stores the output in bf16 (round to nearest even), as the
JAX kernel with `out_dtype=bfloat16` does; the backward reads x and d_out
in bf16 and stores dx in bf16, its weight and vector gradients fp32, as
the JAX backward kernel does. `embed_grid_flat.launches_bf16` and
`embed_grid_flat_bwd.launches_bf16` count their launches.

Widths: both kernels take h = w1's width at every width they are built
for (`_build.WIDTHS`: 32, 64, 128), from that width's library, and any
d_in; any other h raises on a CUDA tensor. The plain versions take any
width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, library
from .mlp import grads_through, layer_norm

_P, _I, _LL, _IP = _build.P, _build.I, _build.LL, _build.IP
_SIGNATURES = {"nlt_embed": [_P] * 3 + [_LL, _I, _I, _P],
               "nlt_embed_bf16": [_P] * 3 + [_LL, _I, _I, _P]}
_BWD_SIGNATURES = {"nlt_embed_bwd": [_P] * 5 + [_LL, _I, _I, _I, _P],
                   "nlt_embed_bwd_grid": [_LL, _I, _I, _IP],
                   "nlt_embed_bwd_bf16": [_P] * 5 + [_LL, _I, _I, _I, _P],
                   "nlt_embed_bwd_bf16_grid": [_LL, _I, _I, _IP]}


def _lib(h):
    return _build.library("embed", _SIGNATURES, h)


def _bwd_lib(h):
    return _build.library("embed_bwd", _BWD_SIGNATURES, h)


def embed_grid_flat_plain(x_f, w0, b0, w1, b1, ln_scale, ln_bias,
                          batch_size: int):
    """Plain PyTorch version of `embed_grid_flat`'s forward (fp32 math,
    the output in x_f's dtype)."""
    N = x_f.shape[0]
    x = x_f.float().view(N, batch_size, -1)
    y = F.silu(x @ w0 + b0) @ w1 + b1
    return layer_norm(y, ln_scale, ln_bias).reshape(N, -1).to(x_f.dtype)


def _check_embed(x_f, w0, w1, batch_size, what="embed_grid_flat"):
    """The kernels' shapes: x_f (N, B*d_in), w0 (d_in, h), w1 (h, h), h a
    built width; their dtype (float32 or bfloat16) and h."""
    d_in = w0.shape[0]
    h = _build.require_width(w1.shape[-1], what)
    _build.expect(x_f.shape[1] == batch_size * d_in, "x_f",
                  (x_f.shape, d_in))
    _build.expect(w0.shape == (d_in, h) and w1.shape == (h, h),
                  "w0/w1", (w0.shape, w1.shape))
    return _build.io_dtype("x_f", x_f), h


def _embed_cuda(x_f, w0, b0, w1, b1, ln_scale, ln_bias, batch_size):
    dev = _build.require_cuda(x_f)
    dt, h = _check_embed(x_f, w0, w1, batch_size)
    N = x_f.shape[0]
    d_in = w0.shape[0]
    params = torch.cat([w0.reshape(-1), w1.reshape(-1), b0, b1, ln_scale,
                        ln_bias])
    out = torch.empty((N, batch_size * h), device=dev, dtype=dt)
    f32 = torch.float32
    ptrs = _build.pointers(dev, ("x_f", x_f, dt), ("params", params, f32),
                           ("out", out, dt))
    lib = _lib(h)
    fn = lib.nlt_embed_bf16 if dt == torch.bfloat16 else lib.nlt_embed
    rc = fn(*ptrs, N * batch_size, d_in, dev.index, _build.stream_of(dev))
    _build.check(lib, rc, "embed_grid_flat")
    _build.count_launch(embed_grid_flat, dt)
    return out


def _embed_fake(x_f, w0, b0, w1, b1, ln_scale, ln_bias, batch_size):
    if library.on_card(x_f):
        _check_embed(x_f, w0, w1, batch_size)
    return x_f.new_empty((x_f.shape[0], batch_size * w1.shape[1]))


# K1's operator (ops/library.py): the plain version on the CPU, the
# kernel on the card
_embed_fwd = library.define(
    "embed_grid_flat",
    "(Tensor x_f, Tensor w0, Tensor b0, Tensor w1, Tensor b1, "
    "Tensor ln_scale, Tensor ln_bias, int batch_size) -> Tensor",
    cpu=embed_grid_flat_plain, cuda=_embed_cuda, fake=_embed_fake)


def embed_grid_flat_bwd_plain(x_f, w0, b0, w1, b1, ln_scale, ln_bias,
                              batch_size: int, d_out, need_dx: bool = True):
    """Plain PyTorch version of `embed_grid_flat_bwd`: autograd through
    the plain forward (fp32 math; d_x in x_f's dtype, rounded once).
    Returns (d_x | None, d_w0, d_b0, d_w1, d_b1, d_ln_scale, d_ln_bias)."""
    grads = grads_through(
        lambda *t: embed_grid_flat_plain(*t, batch_size),
        (x_f, w0, b0, w1, b1, ln_scale, ln_bias), (d_out,))
    return (grads[0] if need_dx else None,) + tuple(grads[1:])


def embed_grid_flat_bwd(x_f, w0, b0, w1, b1, ln_scale, ln_bias,
                        batch_size: int, d_out, need_dx: bool = True):
    """Backward of `embed_grid_flat` from d_out (N, B*h): (d_x | None,
    d_w0, d_b0, d_w1, d_b1, d_ln_scale, d_ln_bias). d_x is computed only
    when `need_dx` (the first predict step's input needs none). Any d_in,
    at each built width h.

    Replaces pallas_embed.py::_embed_bwd_kernel (via _embed_bwd). Its
    products, the weight gradients' included, run on tensor cores in
    3xTF32 in one pass; see csrc/embed_bwd.cu. A bf16 x_f takes the bf16
    instance: d_out bf16 in, d_x bf16 out, the parameter gradients fp32.
    """
    if x_f.device.type == "cpu":
        return embed_grid_flat_bwd_plain(x_f, w0, b0, w1, b1, ln_scale,
                                         ln_bias, batch_size, d_out, need_dx)
    dev = _build.require_cuda(x_f)
    dt, h = _check_embed(x_f, w0, w1, batch_size, "embed_grid_flat_bwd")
    N = x_f.shape[0]
    d_in = w0.shape[0]
    _build.expect(d_out.shape == (N, batch_size * h), "d_out", d_out.shape)
    params = torch.cat([w0.reshape(-1), w1.reshape(-1), b0, b1, ln_scale,
                        ln_bias])
    d_out = d_out.contiguous()
    d_x = torch.empty_like(x_f) if need_dx else None
    f32 = torch.float32
    ptrs = _build.pointers(dev, ("x_f", x_f, dt), ("d_out", d_out, dt),
                           ("params", params, f32))
    ptrs.append(None if d_x is None else d_x.data_ptr())
    g = _build.run_bwd(_bwd_lib(h), "nlt_embed_bwd" + _build.suffix(dt),
                       ptrs, [N * batch_size, d_in], params.numel(), dev,
                       "embed_grid_flat_bwd")
    _build.count_launch(embed_grid_flat_bwd, dt)
    n0, n1 = d_in * h, h * h
    v = g[n0 + n1:].view(4, h)
    return (d_x, g[:n0].view(d_in, h), v[0], g[n0:n0 + n1].view(h, h),
            v[1], v[2], v[3])


class _EmbedGridFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_f, w0, b0, w1, b1, ln_scale, ln_bias, batch_size):
        ctx.save_for_backward(x_f, w0, b0, w1, b1, ln_scale, ln_bias)
        ctx.batch_size = batch_size
        return _embed_fwd(x_f, w0, b0, w1, b1, ln_scale, ln_bias, batch_size)

    @staticmethod
    def backward(ctx, d_out):
        grads = embed_grid_flat_bwd(*ctx.saved_tensors, ctx.batch_size,
                                    d_out, need_dx=ctx.needs_input_grad[0])
        return (*grads, None)


def embed_grid_flat(x_f, w0, b0, w1, b1, ln_scale, ln_bias,
                    batch_size: int):
    """Fused flat grid embedder, differentiable (see module docstring).

    x_f: (N, B*d_in) flat-packed features; w0 (d_in, h), w1 (h, h).
    Returns (N, B*h).

    Replaces pallas_embed.py::_embed_fwd_kernel (via embed_grid_flat).
    Both products run on tensor cores in 3xTF32, so it is bound by bytes
    on the card; see csrc/embed.cu. A bf16 x_f gives a bf16 output, and
    its gradient runs the backward's bf16 instance.
    """
    return _EmbedGridFlat.apply(x_f, w0, b0, w1, b1, ln_scale, ln_bias,
                                batch_size)


embed_grid_flat.launches = 0
embed_grid_flat.launches_bf16 = 0
embed_grid_flat_bwd.launches = 0
embed_grid_flat_bwd.launches_bf16 = 0
