"""The grid embedder's backward (B1) of the port against the JAX package,
on the CPU.

On a CPU tensor `embed.embed_grid_flat_bwd` runs
`embed_grid_flat_bwd_plain` (autograd through the plain forward); on a
CUDA tensor it runs the kernel of `csrc/embed_bwd.cu`, which chip_smoke.py
holds against the same plain version on the card. These tests hold the
port's B1, both through autograd of `embed.embed_grid_flat` and called
directly, against `jax.grad` through the JAX package's interpret-mode
`pallas_embed.embed_grid_flat` (its Pallas backward kernel), at d_in 23
(rows that are not a multiple of 16 bytes), 56 (the bench's) and 100
(above 64 input columns), batch 1 and 4, with and without dx: max abs
diff <= 1e-4 + 1e-4 * max abs of the JAX gradient, per tensor (fp32 sums
over the rows in another order on each side; the JAX kernel folds the
LayerNorm centring into W1). Without dx, d_x is None and the other six
outputs are the same as with it. On CPU tensors nothing is built or
launched.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_lam_tpu.ops import pallas_embed as pe
from neural_lam_tpu_torch.ops import _build, embed

H = 64
N = 80  # grid nodes
NAMES = ("d_w0", "d_b0", "d_w1", "d_b1", "d_ln_scale", "d_ln_bias")


def _rand(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _case(d_in, B):
    """x (N, B, d_in), the six parameters and the cotangent (N, B*64)."""
    rng = np.random.default_rng(100 * d_in + B)
    x = _rand(rng, N, B, d_in, scale=1.0)
    par = [_rand(rng, d_in, H), _rand(rng, H), _rand(rng, H, H),
           _rand(rng, H), 1 + _rand(rng, H, scale=0.1),
           _rand(rng, H, scale=0.1)]
    return x, par, _rand(rng, N, B * H, scale=1.0)


def _jax_grads(x, par, ct):
    """jax.grad of sum(out * ct) through the interpret-mode Pallas
    embedder, x zero-padded to a lane multiple: (d_x, *d_params)."""
    n, B, d_in = x.shape
    d_pad = -(-d_in // 64) * 64
    x_pad = np.pad(x, ((0, 0), (0, 0), (0, d_pad - d_in))).reshape(n, -1)

    def loss(x_pad, w0, b0, w1, b1, ls, lb):
        params = {"layers": [{"w": w0, "b": b0}, {"w": w1, "b": b1}],
                  "ln": {"scale": ls, "bias": lb}}
        out = pe.embed_grid_flat(x_pad, params, B, d_pad, interpret=True)
        return (out * ct).sum()

    g = jax.grad(loss, argnums=tuple(range(7)))(
        jnp.asarray(x_pad), *map(jnp.asarray, par))
    d_x = np.asarray(g[0]).reshape(n, B, d_pad)[..., :d_in].reshape(n, -1)
    return (d_x,) + tuple(np.asarray(a) for a in g[1:])


def _assert_close(got, want, name):
    got = got.detach().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    tol = 1e-4 + 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max abs diff {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("need_dx", [True, False], ids=["dx", "no_dx"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("d_in", [23, 56, 100])
def test_embed_bwd_matches_jax(d_in, B, need_dx):
    """B1 through autograd of embed_grid_flat (x a leaf only when its
    gradient is asked for, as in the training step, where x_f is data)
    and called directly, against jax.grad of the Pallas embedder."""
    x, par, ct = _case(d_in, B)
    want = _jax_grads(x, par, ct)
    x_f = torch.tensor(x.reshape(N, -1), requires_grad=need_dx)
    leaves = [torch.tensor(p, requires_grad=True) for p in par]
    out = embed.embed_grid_flat(x_f, *leaves, B)
    (out * torch.as_tensor(ct)).sum().backward()
    if need_dx:
        _assert_close(x_f.grad, want[0], "d_x (autograd)")
    else:
        assert x_f.grad is None
    for name, leaf, w in zip(NAMES, leaves, want[1:]):
        _assert_close(leaf.grad, w, f"{name} (autograd)")

    args = [torch.as_tensor(x.reshape(N, -1))] + [torch.as_tensor(p)
                                                   for p in par]
    got = embed.embed_grid_flat_bwd(*args, B, torch.as_tensor(ct), need_dx)
    assert len(got) == 7
    if need_dx:
        _assert_close(got[0], want[0], "d_x")
    else:
        assert got[0] is None
        with_dx = embed.embed_grid_flat_bwd(*args, B, torch.as_tensor(ct),
                                            True)
        for name, g, w in zip(NAMES, got[1:], with_dx[1:]):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    for name, g, w in zip(NAMES, got[1:], want[1:]):
        _assert_close(g, w, name)


def test_embed_bwd_takes_plain_version_on_cpu(monkeypatch):
    """On CPU tensors B1 is its plain version: nothing is built and no
    launch is counted, with or without dx."""
    def no_build(*a, **kw):
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    x, par, ct = _case(23, 4)
    args = [torch.as_tensor(x.reshape(N, -1))] + [torch.as_tensor(p)
                                                   for p in par]
    before = embed.embed_grid_flat_bwd.launches
    for need_dx in (True, False):
        got = embed.embed_grid_flat_bwd(*args, 4, torch.as_tensor(ct),
                                        need_dx)
        want = embed.embed_grid_flat_bwd_plain(*args, 4, torch.as_tensor(ct),
                                               need_dx)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert embed.embed_grid_flat_bwd.launches == before
