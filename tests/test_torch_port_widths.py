"""The port at hidden widths 32 and 128 against the JAX package, on the CPU.

The CUDA sources are built once per hidden width (`_build.WIDTHS`: 32, 64,
128); their plain versions take any width. Here, on the same inputs drawn
with numpy:

* the plain versions of K1-K4 (flat, batch 4) and P1-P3 (batched, batch 1
  and 2) at h = 32 and 128, at K = 1, 3 and 8, against the JAX Pallas
  kernels in interpret mode (K4 also with an output map wider than its
  width: d_out 80 at h = 64, 34 at h = 32);
* GraphLAM and a 2-level HiLAM, a predict step and a 3-step rollout at
  h = 32 and 128 on both of the port's routes, against the JAX package's
  CPU route (Pallas off);
* a JAX checkpoint at h = 128, converted, through the port's predict CLI
  against the JAX predict CLI;
* the host logic, which needs no CUDA: a library a source and width,
  forward and backward (its name and nvcc flags), the raise at an unbuilt
  width (48) in the build, in each forward kernel's shape check and in
  each backward wrapper, and the train CLI's raise at 48 before its first
  step (and no raise at 32 and 128).

Tolerances as at h = 64: atol = rtol = 1e-4 for a kernel (sums in
another order on each side; the JAX kernels fold the LayerNorm's mean
into the weights), 1e-4 on a predict step and 5e-4 on a rollout (~10-20
chained fp32 MLPs on O(1) activations), 5e-4 x state_std on the CLI's
forecast (as test_torch_port_predict.py). About 80 s serial.
"""

import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import convert_jax_checkpoint
from neural_lam_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from neural_lam_tpu.config import (
    DatastoreSelection as JDatastoreSelection,
    NeuralLAMConfig as JNeuralLAMConfig,
    load_config_and_datastore as j_load_config_and_datastore,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.datastore.zarr_reader import ZarrGroup as JZarrGroup
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.models import MODELS as J_MODELS
from neural_lam_tpu.models.ar_model import ModelArgs as JModelArgs
from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu.ops import pallas_edge as jpe
from neural_lam_tpu.ops import pallas_edge_flat as pef
from neural_lam_tpu.ops import pallas_embed as pe
from neural_lam_tpu.ops import pallas_grid_update as pgu
from neural_lam_tpu.ops.message_passing import EdgeSet as JEdgeSet
from neural_lam_tpu.predict import main as j_predict_main
from neural_lam_tpu_torch import predict, train
from neural_lam_tpu_torch.config import (
    DatastoreSelection,
    NeuralLAMConfig,
    load_config_and_datastore,
)
from neural_lam_tpu_torch.convert import params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.models import MODELS
from neural_lam_tpu_torch.models.ar_model import ModelArgs
from neural_lam_tpu_torch.ops import (
    _build,
    edge,
    edge_flat,
    embed,
    grid_update,
    weight_grad,
)
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.ops.message_passing import EdgeSet

TOL = dict(atol=1e-4, rtol=1e-4)
WIDTHS = (32, 128)
SLOTS = (1, 3, 8)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rand(rng, *shape, scale=0.3):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _edge_sets(deg, seed, n_send=120, n_rec=100):
    """(JAX EdgeSet, port EdgeSet, rng) of a local graph of in-degree
    `deg`: receiver r takes senders near r * n_send / n_rec."""
    rng = np.random.default_rng(seed)
    centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
    s = np.clip(centre + rng.integers(-3, 4, (n_rec, deg)), 0,
                n_send - 1).reshape(-1)
    r = np.repeat(np.arange(n_rec), deg)
    f = rng.standard_normal((n_rec * deg, 3)).astype(np.float32)
    j = JEdgeSet.from_local(s, r, f, n_send, n_rec, dense=True)
    t = EdgeSet.from_local(s, r, f, n_send, n_rec, device="cpu")
    assert t.dense_k == j.dense_k == deg
    return j, t, rng


def _tail(rng, h):
    """w2, b2, ln scale, ln bias of an edge MLP at width h."""
    return [_rand(rng, h, h, scale=0.2), _rand(rng, h, scale=0.2),
            1 + _rand(rng, h, scale=0.1), _rand(rng, h, scale=0.1)]


# ---------------------------------------------------------------- host logic


def test_a_library_per_source_and_width():
    """Each source, forward and backward, has a library at 32, 64 and 128:
    the width is in its name, its nvcc flags and its hash. Nothing is
    built (no nvcc here)."""
    assert _build.WIDTHS == (32, 64, 128)
    assert set(_build.FORWARD) == {"embed", "edge_flat", "grid_update",
                                   "edge"}
    assert set(_build.BACKWARD) == set(_build.SOURCES) - set(_build.FORWARD)
    for name in _build.SOURCES:
        paths = {w: _build.lib_path(name, w) for w in _build.WIDTHS}
        for w, p in paths.items():
            assert p.name.startswith(f"libnlt_{name}_h{w}-"), p.name
            assert f"-DNLT_H={w}" in _build.nvcc_flags(w)
            assert _build.lib_key(name, w) == (
                name if w == 64 else f"{name}@{w}")
        assert len({p.name for p in paths.values()}) == len(_build.WIDTHS)
    assert _build.lib_path("edge") == _build.lib_path("edge", 64)


@pytest.mark.parametrize("width", [48, 16, 256])
def test_unbuilt_width_raises(width):
    """A width with no library raises, naming the built widths, for a
    forward and a backward source alike."""
    with pytest.raises(ValueError, match="32, 64, 128"):
        _build.require_width(width, "k")
    with pytest.raises(ValueError, match="32, 64, 128"):
        _build.lib_path("edge_flat", width)
    with pytest.raises(ValueError, match="32, 64, 128"):
        _build.lib_path("edge_flat_bwd", width)
    assert _build.require_width(128, "k") == 128


@pytest.mark.parametrize("width", [32, 128])
def test_backward_raises_off_64(width):
    """The backward sources have libraries at 32 and 128 as at 64 (no
    width-64-only rule is left: `require_bwd_width` is gone), and width 48
    raises in each, naming the built widths."""
    assert not hasattr(_build, "require_bwd_width")
    for name in _build.BACKWARD:
        assert _build.lib_path(name, width).name.startswith(
            f"libnlt_{name}_h{width}-")
        with pytest.raises(ValueError, match="32, 64, 128"):
            _build.lib_path(name, 48)


@pytest.mark.parametrize("width", _build.WIDTHS)
@pytest.mark.parametrize("name", _build.BACKWARD)
def test_backward_library_per_width(name, width):
    """Each backward library of each width: its name holds the source and
    the width, its flags `-DNLT_H=<width>`, its key `<source>@<width>`
    (the source alone at 64), and its hash differs from the other widths'
    (nothing is built)."""
    path = _build.lib_path(name, width)
    assert path.name.startswith(f"libnlt_{name}_h{width}-")
    assert path.parent == _build.BUILD_DIR
    assert f"-DNLT_H={width}" in _build.nvcc_flags(width)
    assert _build.lib_key(name, width) == (
        name if width == 64 else f"{name}@{width}")
    assert _build._split_key(_build.lib_key(name, width)) == (name, width)
    others = {_build.lib_path(name, w).name for w in _build.WIDTHS
              if w != width}
    assert path.name not in others


def _shape_checks(h):
    """Each forward module's kernel shape check on CPU tensors at width h
    (what the wrappers run on a CUDA tensor before they load a library)."""
    rng = np.random.default_rng(0)
    j, t, _ = _edge_sets(2, 1, n_send=20, n_rec=20)
    B, M, nv = 4, t.num_virt * t.dense_k, t.num_virt
    mask_p = t.mask.view(nv, t.dense_k)

    def r(*shape):
        return _t(_rand(rng, *shape))

    pp = {k: r(2 * h if k == "a_w0" else h, h) for k in grid_update._MATS}
    pp.update({k: r(h) for k in grid_update._VECS}, o_w1=r(h, 90),
              o_b1=r(90))
    return [
        lambda: embed._check_embed(r(20, B * 5), r(5, h), r(h, h), B),
        lambda: edge_flat._check_tail(r(20, B * h), t.senders, r(M, h),
                                      r(nv, B * h), mask_p, r(h, h)),
        lambda: edge_flat._check_layer(r(M, B * h), r(20, B * h), t.senders,
                                       r(nv, B * h), mask_p, r(h, h),
                                       r(h, h)),
        lambda: grid_update._check(r(20, B * h), t.senders, r(M, h),
                                   r(20, B * h), mask_p, pp),
        lambda: edge._check_tail(r(1, M, h), r(h, h), t.mask, t.dense_k),
        lambda: edge._check_tail_sum(r(1, 20, h), t.senders, r(M, h),
                                     r(1, nv, h), r(h, h), t.mask,
                                     t.dense_k),
        lambda: edge._check_layer(r(1, M, h), r(1, 20, h), t.senders,
                                  r(1, nv, h), t.mask, r(h, h), r(h, h),
                                  t.dense_k),
    ]


@pytest.mark.parametrize("index", range(7))
def test_kernel_shape_checks_take_built_widths(index):
    """K1-K4 and P1-P3: h = 32 and 128 pass (K4 with a 90-column output
    map: no cap), h = 48 raises naming the built widths."""
    for h in (32, 128):
        got = _shape_checks(h)[index]()
        got_h = got[1] if isinstance(got, tuple) else got
        assert got_h == h
    with pytest.raises(ValueError, match="32, 64, 128"):
        _shape_checks(48)[index]()


def test_train_cli_raises_at_128_on_cuda(monkeypatch):
    """`train.py` on CUDA at --hidden_dim 48 (no library) raises before
    its first step, naming the built widths; at 128 and 32, and with
    --eval or with MLPs the kernels do not take (--hidden_layers 2), it
    goes on (stopped here at the next step)."""
    monkeypatch.setattr(train, "resolve_device",
                        lambda d: torch.device("cuda"))

    class Past(Exception):
        pass

    def past(**kw):
        raise Past

    monkeypatch.setattr(train, "make_mesh", past)
    argv = ["--config_path", "unused.yaml", "--hidden_dim", "48"]
    with pytest.raises(ValueError, match="32, 64, 128"):
        train.main(argv)
    for extra in (["--eval", "val"], ["--hidden_layers", "2"]):
        with pytest.raises(Past):
            train.main(argv + extra)
    for h in ("128", "32", "64"):
        with pytest.raises(Past):
            train.main(["--config_path", "unused.yaml", "--hidden_dim", h])


def _bwd_calls(h):
    """Each backward wrapper (B1, B2, B3/B4, B5/B6, xtd_sum) on meta
    tensors at width h: its device check passes (patched), so its shape
    and width checks run before it loads a library."""
    B, K, nv = 4, 2, 8
    M = nv * K

    def r(*shape):
        return torch.empty(*shape, device="meta")

    senders = torch.zeros(M, dtype=torch.int32, device="meta")
    mask_p = r(nv, K)
    tail = (r(h, h), r(h), r(h), r(h))
    pp = {k: r(2 * h if k == "a_w0" else h, h) for k in grid_update._MATS}
    pp.update({k: r(h) for k in grid_update._VECS}, o_w1=r(h, 90),
              o_b1=r(90))
    return [
        lambda: embed.embed_grid_flat_bwd(
            r(20, B * 5), r(5, h), r(h), r(h, h), r(h), r(h), r(h), B,
            r(20, B * h), False),
        lambda: edge_flat.edge_tail_bwd_chain(
            r(20, B * h), senders, r(M, h), r(nv, B * h), mask_p, *tail,
            r(nv, B * h)),
        lambda: edge_flat.edge_layer_bwd_chain(
            r(M, B * h), r(20, B * h), senders, r(nv, B * h), mask_p,
            r(h, h), r(h), *tail, None, r(nv, B * h)),
        lambda: grid_update.grid_update_bwd_chain(
            r(20, B * h), senders, r(M, h), r(20, B * h), mask_p, pp,
            r(nv, B * 90)),
        lambda: weight_grad.xtd_sum([(r(64, h), r(64, 90))]),
    ]


@pytest.mark.parametrize("index", range(5))
def test_backward_wrappers_raise_at_48(index, monkeypatch):
    """Each backward wrapper on a tensor of the card at width 48 raises
    naming the built widths before it loads a library or launches (the
    card's device check stood in for by a patch, on meta tensors)."""
    def no_build(*a, **kw):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "require_cuda", lambda t: t.device)
    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="32, 64, 128"):
        _bwd_calls(48)[index]()


# ---------------------------------------------------- kernels against JAX


@pytest.mark.parametrize("d_in", [23, 56])
@pytest.mark.parametrize("h", WIDTHS)
def test_embed_width_matches_jax(h, d_in):
    """K1 plain (unpadded features) == pallas_embed.embed_grid_flat
    (interpret) on its lane-padded packing, batch 4."""
    rng = np.random.default_rng(h + d_in)
    N, B = 256, 4
    d_pad = -(-d_in // (128 // B)) * (128 // B)
    x = _rand(rng, N, B, d_in, scale=1.0)
    params = {
        "layers": [{"w": _rand(rng, d_in, h), "b": _rand(rng, h)},
                   {"w": _rand(rng, h, h, scale=0.2), "b": _rand(rng, h)}],
        "ln": {"scale": 1 + _rand(rng, h, scale=0.1),
               "bias": _rand(rng, h, scale=0.1)},
    }
    x_pad = np.pad(x, ((0, 0), (0, 0), (0, d_pad - d_in))).reshape(N, -1)
    out_j = pe.embed_grid_flat(jnp.asarray(x_pad),
                               jax.tree.map(jnp.asarray, params), B, d_pad,
                               interpret=True)
    lyr = params["layers"]
    out_t = embed.embed_grid_flat(
        _t(x.reshape(N, -1)), _t(lyr[0]["w"]), _t(lyr[0]["b"]),
        _t(lyr[1]["w"]), _t(lyr[1]["b"]), _t(params["ln"]["scale"]),
        _t(params["ln"]["bias"]), B)
    assert out_t.shape == (N, B * h)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("K", SLOTS)
@pytest.mark.parametrize("h", WIDTHS)
def test_edge_tail_sum_flat_width_matches_jax(h, K):
    """K2 plain == pallas_edge_flat.edge_tail_sum_flat (interpret), B=4."""
    j, t, rng = _edge_sets(K, 10 + K + h)
    B, n_virt = 4, t.num_virt
    table = _rand(rng, t.num_send, B * h)
    ew, rec = _rand(rng, n_virt * K, h), _rand(rng, n_virt, B * h)
    tail = _tail(rng, h)
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    _, virt_j = pef.edge_tail_sum_flat(table[np.asarray(j.senders)], ew, rec,
                                       *tail, mask_p, K, interpret=True)
    virt_t = edge_flat.edge_tail_sum_flat(
        _t(table), t.senders, _t(ew), _t(rec), t.mask.view(n_virt, K),
        *map(_t, tail))
    np.testing.assert_allclose(virt_t.numpy(), np.asarray(virt_j), **TOL)


@pytest.mark.parametrize("K", SLOTS)
@pytest.mark.parametrize("h", WIDTHS)
def test_edge_layer_flat_width_matches_jax(h, K):
    """K3 plain == pallas_edge_flat.edge_layer_flat (interpret), B=4:
    edge_out at every slot (padding included) and virt."""
    j, t, rng = _edge_sets(K, 20 + K + h)
    B, n_virt = 4, t.num_virt
    table = _rand(rng, t.num_send, B * h)
    e, rec = _rand(rng, n_virt * K, B * h), _rand(rng, n_virt, B * h)
    par = [_rand(rng, h, h, scale=0.2), _rand(rng, h, scale=0.2)] + _tail(
        rng, h)
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    edge_j, virt_j = pef.edge_layer_flat(e, table[np.asarray(j.senders)],
                                         rec, mask_p, *par, K,
                                         interpret=True)
    edge_t, virt_t = edge_flat.edge_layer_flat(
        _t(e), _t(table), t.senders, _t(rec), t.mask.view(n_virt, K),
        *map(_t, par))
    np.testing.assert_allclose(virt_t.numpy(), np.asarray(virt_j), **TOL)
    np.testing.assert_allclose(edge_t.numpy(), np.asarray(edge_j), **TOL)


def _decoder_params(rng, h, d_out):
    def mk(*shape):
        return _rand(rng, *shape, scale=0.1)

    pp = {k: mk(2 * h if k == "a_w0" else h, h) for k in grid_update._MATS}
    pp.update({k: mk(h) for k in grid_update._VECS})
    pp.update({k: 1.0 + mk(h) for k in ("enc_ls", "e_ls", "a_ls")})
    return dict(pp, o_w1=mk(h, d_out), o_b1=mk(d_out))


@pytest.mark.parametrize("h, K, d_out", [
    (32, 1, 17), (32, 3, 17), (32, 8, 17), (128, 1, 17), (128, 3, 17),
    (128, 8, 17), (64, 4, 80), (32, 4, 34)])
def test_grid_update_width_matches_jax(h, K, d_out):
    """K4 plain == pallas_grid_update.grid_update_flat (interpret), B=4,
    at h = 32 and 128 and with output maps wider than the width (d_out 80
    at 64, 34 at 32: the CUDA kernel's chunked output map)."""
    j, t, rng = _edge_sets(K, 30 + K + h, n_send=60, n_rec=200)
    assert t.virt_identity
    B, n_virt = 4, t.num_virt
    table = _rand(rng, t.num_send, B * h)
    ew, ge = _rand(rng, n_virt * K, h), _rand(rng, 200, B * h)
    mask_p = np.asarray(j.mask).reshape(n_virt, K)
    pp = _decoder_params(rng, h, d_out)
    out_j = pgu.grid_update_flat(
        table[np.asarray(j.senders)], ew, ge, mask_p,
        {k: jnp.asarray(v) for k, v in pp.items()}, K, interpret=True)
    out_t = grid_update.grid_update_flat(
        _t(table), t.senders, _t(ew), _t(ge), t.mask.view(n_virt, K),
        {k: _t(v) for k, v in pp.items()})
    assert out_t.shape == (n_virt, B * d_out)
    np.testing.assert_allclose(out_t.numpy()[:200],
                               np.asarray(out_j)[:200], **TOL)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("K", SLOTS)
@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("kernel", ["edge_tail", "edge_tail_sum",
                                    "edge_layer"])
def test_batched_width_matches_jax(kernel, h, K, B):
    """P1 (with messages), P2 (with messages) and P3 plain ==
    pallas_edge.edge_tail, edge_tail_sum and edge_layer (interpret): the
    messages or edge_out at every slot, padding included, and virt."""
    j, t, rng = _edge_sets(K, 40 + K + h + B)
    n_virt = t.num_virt
    M = n_virt * K
    mask = np.asarray(j.mask)
    tail = _tail(rng, h)
    send_t, rec = _rand(rng, B, t.num_send, h), _rand(rng, B, n_virt, h)
    if kernel == "edge_tail":
        x0 = _rand(rng, B, M, h, scale=1.0)
        got = edge.edge_tail(_t(x0), *map(_t, tail), t.mask, K)
        want = jpe.edge_tail(x0, *tail, mask, K, True, True)
    elif kernel == "edge_tail_sum":
        ew = _rand(rng, M, h)
        got = edge.edge_tail_sum(_t(send_t), t.senders, _t(ew), _t(rec),
                                 *map(_t, tail), t.mask, K)
        want = jpe.edge_tail_sum(send_t[:, np.asarray(j.senders)], ew, rec,
                                 *tail, mask, K, True, True)
    else:
        e = _rand(rng, B, M, h)
        par = [_rand(rng, h, h, scale=0.2), _rand(rng, h, scale=0.2)] + tail
        got = edge.edge_layer(_t(e), _t(send_t), t.senders, _t(rec), t.mask,
                              *map(_t, par), K)
        want = jpe.edge_layer(e, np.asarray(j.senders), send_t, rec, mask,
                              *par, K, True, True)
    for g, w in zip(got, want):
        assert g.shape[-1] == h
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


# ------------------------------------------------------- models against JAX


def _model_pair(kind, h, tmp_path_factory):
    """(jax_model, jax_params, port_model): GraphLAM on a 16x16 and HiLAM
    on a 30x30 (2-level) DummyDatastore, hidden h, 2 processor layers."""
    assert jmp._pallas_mode() == "off"
    nx = 16 if kind == "graph_lam" else 30
    jds = JDummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    hier = kind == "hi_lam"
    jbundle = j_create_graph(str(tmp_path_factory.mktemp("jg")),
                             jds.get_xy("state", stacked=False),
                             n_max_levels=None, hierarchical=hier)
    tbundle = create_graph(str(tmp_path_factory.mktemp("tg")),
                           tds.get_xy("state", stacked=False),
                           n_max_levels=None, hierarchical=hier)
    jmodel = J_MODELS[kind](
        JModelArgs(hidden_dim=h, processor_layers=2),
        JNeuralLAMConfig(datastore=JDatastoreSelection("dummydata", "")),
        jds, j_graph_from_bundle(jbundle))
    params = jmodel.init_params(jax.random.PRNGKey(h))
    tmodel = MODELS[kind](
        ModelArgs(hidden_dim=h, processor_layers=2),
        NeuralLAMConfig(datastore=DatastoreSelection("dummydata", "")),
        tds, graph_from_bundle(tbundle, device="cpu"), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module", params=[(k, h) for k in ("graph_lam",
                                                        "hi_lam")
                                        for h in WIDTHS],
                ids=lambda p: f"{p[0]}-h{p[1]}")
def models(request, tmp_path_factory):
    return _model_pair(*request.param, tmp_path_factory)


@pytest.mark.parametrize("route", ["flat", "batched"])
def test_model_width_matches_jax(models, route, monkeypatch):
    """One predict step (atol 1e-4) and a 3-step rollout (5e-4) at batch
    4 against the JAX CPU route. The port's `_FLAT_MIN_VIRT` at 1,
    "flat": K1-K4 and K2/K3 on every set (B*h >= 128 at both widths); past
    every set's rows, "batched": P1-P3 on every set."""
    jmodel, params, tmodel = models
    B, T = 4, 3
    monkeypatch.setattr(tmp, "_FLAT_MIN_VIRT",
                        1 if route == "flat" else 10**9)
    assert tmodel._flat_grid_eligible(B) == (route == "flat")
    rng = np.random.default_rng(1)
    n, d = tmodel.num_grid_nodes, tmodel.num_state_vars
    init = rng.standard_normal((B, 2, n, d)).astype(np.float32)
    forcing = rng.standard_normal(
        (B, T, n, tmodel.num_forcing_vars * 3)).astype(np.float32)
    true = rng.standard_normal((B, T, n, d)).astype(np.float32)
    out_j, _ = jmodel.predict_step(params, jnp.asarray(init[:, 1]),
                                   jnp.asarray(init[:, 0]),
                                   jnp.asarray(forcing[:, 0]))
    pred_j, _ = jmodel.unroll_prediction(params, jnp.asarray(init),
                                         jnp.asarray(forcing),
                                         jnp.asarray(true))
    with torch.no_grad():
        out_t, _ = tmodel.predict_step(_t(init[:, 1]), _t(init[:, 0]),
                                       _t(forcing[:, 0]))
        pred_t, _ = tmodel.unroll_prediction(_t(init), _t(forcing),
                                             _t(true))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4,
                               rtol=0)
    assert pred_t.shape == (B, T, n, d)
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j),
                               atol=5e-4, rtol=0)


# ------------------------------------------------------- the predict CLI


def test_converted_jax_checkpoint_at_128_forecasts_as_jax(tmp_path):
    """A JAX GraphLAM checkpoint at hidden 128 -> convert_jax_checkpoint.py
    -> the port's predict CLI, against the JAX predict CLI on the same
    checkpoint and sample (a 10x10 dummydata datastore, 1 processor
    layer): (port - JAX) / state_std within 5e-4 over 3 steps."""
    (tmp_path / "dummy.yaml").write_text(yaml.safe_dump(
        dict(n_points_1d=10, n_timesteps=40, root="dsroot")))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({"datastore": {
        "kind": "dummydata", "config_path": "dummy.yaml"}}))
    config, jds = j_load_config_and_datastore(cfg)
    jmodel = J_MODELS["graph_lam"](
        JModelArgs(graph="g1level", hidden_dim=128, processor_layers=1),
        config, jds)
    params = jmodel.init_params(jax.random.PRNGKey(5))
    j_save_checkpoint(tmp_path / "jax", "best", params, meta={"step": 3})
    ckpt = convert_jax_checkpoint.convert(tmp_path / "jax" / "best",
                                          tmp_path / "port")
    common = ["--config_path", str(cfg), "--model", "graph_lam", "--graph",
              "g1level", "--hidden_dim", "128", "--processor_layers", "1",
              "--ar_steps", "3", "--split", "test", "--sample_idx", "-1"]
    j_predict_main(common + ["--load", str(tmp_path / "jax" / "best"),
                             "--out", str(tmp_path / "jax.zarr")])
    got = predict.main(common + ["--load", str(ckpt), "--device", "cpu",
                                 "--out", str(tmp_path / "port.zarr")])
    assert json.loads(json.dumps(got["out"])).endswith("port.zarr")
    _, tds = load_config_and_datastore(cfg)
    std = tds.get_standardization_dataarray("state")["state_std"]
    pred = ZarrGroup(tmp_path / "port.zarr")["state"].read_full()
    want = JZarrGroup(tmp_path / "jax.zarr")["state"].read_full()
    assert pred.shape == want.shape == (3, tds.num_grid_points,
                                        tds.get_num_data_vars("state"))
    assert np.isfinite(pred).all()
    gap = np.abs(pred - want) / std
    assert gap.max() <= 5e-4, gap.max()
