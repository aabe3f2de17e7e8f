"""MLP kit with the reference's math, as torch modules.

Counterpart of neural_lam_tpu/ops/mlp.py. Every sub-network is one MLP
recipe (ref: neural_lam/utils.py:191-214): Linear layers with SiLU between
them and, optionally, a LayerNorm (eps 1e-5, fp32 statistics) on the
output. Parameters keep the JAX package's layout and names, so a JAX
parameter pytree maps one to one onto the state dict (`convert.py`):

    layers.{i}.w (d_in, d_out), layers.{i}.b (d_out,), ln.scale, ln.bias

Weights are stored (in, out), transposed relative to torch.nn.Linear, so
the forward pass is `x @ w`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # torch.nn.LayerNorm default


class Linear(nn.Module):
    """x @ w + b with w stored (in, out)."""

    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        # torch.nn.Linear's default init: U(-1/sqrt(d_in), 1/sqrt(d_in))
        bound = 1.0 / (d_in**0.5)
        self.w = nn.Parameter(
            (torch.rand(d_in, d_out, generator=generator) * 2 - 1) * bound
        )
        self.b = nn.Parameter(
            (torch.rand(d_out, generator=generator) * 2 - 1) * bound
        )


class LayerNormParams(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))


class MLP(nn.Module):
    """Linear layers with SiLU between them, optional output LayerNorm.

    Holds parameters only; the forward math lives in the functions below
    (and in the fused kernels), mirroring the JAX package's functional
    split between parameter pytrees and ops."""

    def __init__(self, blueprint: list[int], layer_norm: bool,
                 generator: torch.Generator):
        super().__init__()
        assert len(blueprint) >= 2, "Invalid MLP blueprint"
        self.layers = nn.ModuleList(
            Linear(d1, d2, generator)
            for d1, d2 in zip(blueprint[:-1], blueprint[1:])
        )
        self.ln = LayerNormParams(blueprint[-1]) if layer_norm else None


def init_mlp(blueprint: list[int], layer_norm: bool = True,
             generator: torch.Generator | None = None) -> MLP:
    """MLP from a layer-size blueprint (ref: neural_lam/utils.py:191-214).
    Parameters are drawn on the CPU from `generator`; move the module to a
    device afterwards."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return MLP(blueprint, layer_norm, generator)


def layer_norm(x, scale, bias, eps: float = LN_EPS):
    """LayerNorm over the last axis with fp32 statistics."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def mm(x, w, compute_dtype=None):
    """x @ w. With a compute_dtype (bf16), both operands are rounded to it
    and the product is taken in fp32, as the JAX package's
    `jnp.dot(x.astype(cd), w.astype(cd), preferred_element_type=float32)`
    computes it: bf16 x bf16 products are exact in fp32, so an fp32 matmul
    (TF32 off) on the rounded operands gives the same product with an fp32
    sum, where a bf16 GEMM would round its result to bf16. The weight's
    rounding is made once per parameter (`rounded`)."""
    if compute_dtype is None:
        return x @ w
    return x.to(compute_dtype).float() @ rounded(w, compute_dtype)


def rounded(w, dtype):
    """w rounded to `dtype` and back to fp32. For a parameter, or a view of
    one (the slices of a first layer's weight), the rounding of the whole
    parameter is kept on it and reused until the parameter changes (its
    version counter, storage or the dtype differ), so a rollout rounds each
    weight once, not at every product. A weight that needs a gradient is
    rounded afresh, so that the gradient flows, and so is a weight under
    tracing (`torch.export`: its fake tensors have no storage to key on),
    where the rounding becomes part of the program."""
    base = w if w._base is None else w._base
    if (w.requires_grad and torch.is_grad_enabled()) or not (
            isinstance(base, nn.Parameter) and base.is_contiguous()) or (
            torch.compiler.is_compiling()):
        return w.to(dtype).float()
    key = (dtype, base._version, base.data_ptr(), base.device)
    hit = getattr(base, "_nlt_rounded", None)
    if hit is None or hit[0] != key:
        hit = (key, base.detach().to(dtype).float())
        base._nlt_rounded = hit
    if w is base:
        return hit[1]
    return hit[1].as_strided(w.shape, w.stride(),
                             w.storage_offset() - base.storage_offset())


def store(x, compute_dtype=None):
    """x stored in the compute dtype, when there is one."""
    return x if compute_dtype is None else x.to(compute_dtype)


def finish_mlp(mlp: MLP, x, compute_dtype=None):
    """Layers 1..n (+ optional LayerNorm) given the first layer's output x;
    with a compute_dtype, the output is stored in it before the LayerNorm
    (which keeps the input's dtype)."""
    for lyr in list(mlp.layers)[1:]:
        x = mm(F.silu(x), lyr.w, compute_dtype) + lyr.b
    x = store(x, compute_dtype)
    if mlp.ln is not None:
        x = layer_norm(x, mlp.ln.scale, mlp.ln.bias)
    return x


def apply_mlp(mlp: MLP, x, compute_dtype=None):
    """Linear (+ SiLU between layers), optional output LayerNorm. With a
    compute_dtype, every product rounds its operands to it (`mm`) and every
    layer's output is stored in it, as the JAX package's `apply_mlp`."""
    return finish_mlp(mlp, mm(x, mlp.layers[0].w, compute_dtype)
                      + mlp.layers[0].b, compute_dtype)


def apply_mlp_concat(mlp: MLP, parts: list, compute_dtype=None):
    """apply_mlp(mlp, concat(parts, -1)) without materializing the concat:
    the first Linear decomposes into per-part matmuls summed."""
    w0 = mlp.layers[0].w
    off = 0
    x = mlp.layers[0].b
    for part in parts:
        d = part.shape[-1]
        x = x + mm(part, w0[off:off + d], compute_dtype)
        off += d
    assert off == w0.shape[0], (off, w0.shape)
    return finish_mlp(mlp, x, compute_dtype)


def grads_through(fn, inputs, output_grads):
    """torch.autograd.grad of fn(*inputs) with the given output cotangents
    (None entries skipped) with respect to every input: the plain
    backward of a fused kernel, through its plain forward on detached
    leaves."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, output_grads) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs],
                                   leaves, [g for _, g in pairs],
                                   allow_unused=True)
