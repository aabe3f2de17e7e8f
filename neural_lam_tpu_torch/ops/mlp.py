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


def finish_mlp(mlp: MLP, x):
    """Layers 1..n (+ optional LayerNorm) given the first layer's output x."""
    for lyr in list(mlp.layers)[1:]:
        x = F.silu(x) @ lyr.w + lyr.b
    if mlp.ln is not None:
        x = layer_norm(x, mlp.ln.scale, mlp.ln.bias)
    return x


def apply_mlp(mlp: MLP, x):
    """Linear (+ SiLU between layers), optional output LayerNorm."""
    return finish_mlp(mlp, x @ mlp.layers[0].w + mlp.layers[0].b)


def apply_mlp_concat(mlp: MLP, parts: list):
    """apply_mlp(mlp, concat(parts, -1)) without materializing the concat:
    the first Linear decomposes into per-part matmuls summed."""
    w0 = mlp.layers[0].w
    off = 0
    x = mlp.layers[0].b
    for part in parts:
        d = part.shape[-1]
        x = x + part @ w0[off:off + d]
        off += d
    assert off == w0.shape[0], (off, w0.shape)
    return finish_mlp(mlp, x)


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
