"""The host-side parts of the mesh-node-sharded schemes (mesh_rs,
mesh_halo) against the JAX package on the CPU, in one process.

* The halo plan builders (`parallel/halo.py`: `_build_gather_halo`,
  `_build_push_halo`, `_remap_to_extended`) give JAX's plans, send lists,
  remaps, push positions and add positions, array for array, for every
  edge set of a flat multiscale and a two-level hierarchical graph on a
  30x28 grid, at 2, 3 and 4 shards: the gather plans of m2m, up, down and
  m2g as `build_rs_shard` asks for them, and g2m's push plan.
* `build_rs_shard`: rank s's part (built alone, padded to the common
  sizes) equals index s of JAX's stacked `RSShard`, for mesh_rs and
  mesh_halo, set for set with the transposed layouts and the frontier
  splits; its statics, send lists, add positions and plans are JAX's at
  index s. The split sets keep JAX's structure (its
  `test_split_sets_structure`): interior senders inside the owned block,
  frontier senders inside the imported table, and interior plus frontier
  edges together the set's.
"""

import numpy as np
import pytest

from neural_lam_tpu.parallel.grid_sharded import (
    build_rs_shard as j_build_rs_shard,
)
from neural_lam_tpu.parallel.spatial import (
    _build_gather_halo as j_build_gather_halo,
    _build_push_halo as j_build_push_halo,
    _remap_to_extended as j_remap_to_extended,
)
from neural_lam_tpu_torch.parallel import halo
from neural_lam_tpu_torch.parallel.grid_sharded import (
    _real_edges,
    build_rs_shard,
)

from .test_torch_port_parallel import _assert_set, graphs  # noqa: F401


def _gather_inputs(tg, S):
    """(name, senders, destination shards, owner block) of each gather
    plan `build_rs_shard` makes for graph `tg` over S shards."""
    mblocks = [-(-n // S) for n in tg.level_sizes]
    block = -(-tg.num_grid_nodes // S)
    out = []
    for kind, sets, send_lv, rec_lv in (
            ("m2m", tg.m2m, lambda lv: lv, lambda lv: lv),
            ("up", tg.up, lambda lv: lv, lambda lv: lv + 1),
            ("down", tg.down, lambda lv: lv + 1, lambda lv: lv)):
        for lv, es in enumerate(sets):
            send, recv, _ = _real_edges(es)
            out.append((f"{kind}[{lv}]", send,
                        np.minimum(recv // mblocks[rec_lv(lv)], S - 1),
                        mblocks[send_lv(lv)]))
    send, recv, _ = _real_edges(tg.m2g)
    out.append(("m2g", send, np.minimum(recv // block, S - 1), mblocks[0]))
    return out


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("kind", ["flat", "hier"])
def test_halo_plans_match_jax(kind, S, graphs):  # noqa: F811
    tg, _, _ = graphs[kind]
    for name, send, dst, blk in _gather_inputs(tg, S):
        t_plan, t_idx, t_remap = halo._build_gather_halo(send, dst, blk, S)
        j_plan, j_idx, j_remap = j_build_gather_halo(send, dst, blk, S)
        assert t_plan == j_plan, name
        np.testing.assert_array_equal(t_idx, j_idx, err_msg=name)
        assert t_remap == j_remap, name
        for s in range(S):
            sel = dst == s
            np.testing.assert_array_equal(
                halo._remap_to_extended(send[sel], s, blk, t_remap, S),
                j_remap_to_extended(send[sel], s, blk, j_remap, S),
                err_msg=f"{name} remap {s}")
    send, recv, _ = _real_edges(tg.g2m)
    mblock = -(-tg.level_sizes[0] // S)
    src = np.minimum(send // -(-tg.num_grid_nodes // S), S - 1)
    t = halo._build_push_halo(recv, src, mblock, S)
    j = j_build_push_halo(recv, src, mblock, S)
    assert t[0] == j[0] and t[1] == j[1] and t[3] == j[3]
    np.testing.assert_array_equal(t[2], j[2])
    assert t[0], "g2m pushes no row at this size"


def _pairs(tp, jp):
    pairs = [("g2m", tp.g2m, jp.g2m), ("m2g", tp.m2g, jp.m2g)]
    for kind in ("m2m", "up", "down"):
        pairs += [(f"{kind}[{i}]", t, j) for i, (t, j) in enumerate(
            zip(getattr(tp, kind), getattr(jp, kind)))]
    return pairs


def _real_senders(es, s=None):
    mask = es.mask[:, 0] if s is None else np.asarray(es.mask[s, :, 0])
    snd = es.senders if s is None else np.asarray(es.senders[s])
    snd = np.asarray(snd)[np.asarray(mask) > 0]
    return snd


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("scheme", ["mesh_rs", "mesh_halo"])
@pytest.mark.parametrize("kind", ["flat", "hier"])
def test_rs_shard_matches_jax(kind, scheme, S, graphs):  # noqa: F811
    tg, jg, stat = graphs[kind]
    is_halo = scheme == "mesh_halo"
    jp = j_build_rs_shard(jg, S, stat, halo=is_halo)
    n_split = 0
    for s in range(S):
        tp = build_rs_shard(tg, S, stat, s, device="cpu", halo=is_halo)
        assert (tp.block, tp.num_grid, tp.num_mesh, tp.mblock) == (
            jp.block, jp.num_grid, jp.num_mesh, jp.mblock)
        pairs = _pairs(tp, jp)
        assert len(pairs) == 2 + len(jg.m2m) + len(jg.up) + len(jg.down)
        for what, t, j in pairs:
            where = f"{scheme} shard {s} {what}"
            assert (t.frontier is None) == (j.frontier is None), where
            sets = [("", t, j)]
            if t.frontier is not None:
                sets.append((".frontier", t.frontier, j.frontier))
                n_split += 1
            for sub, ts, js in sets:
                _assert_set(ts, js, where + sub, index=s)
                _assert_set(ts.transposed, js.transposed,
                            where + sub + ".transposed",
                            fields=("senders", "mask", "virt_to_rec"),
                            index=s)
            if t.frontier is not None:
                # JAX's split structure: interior senders in the owned
                # block, frontier senders in the imported table, and
                # together every edge of the rank's receivers
                assert _real_senders(t).max(initial=-1) < t.num_send
                assert _real_senders(t.frontier).max(
                    initial=-1) < t.frontier.num_send
        np.testing.assert_array_equal(
            tp.grid_static.numpy(),
            np.asarray(jp.grid_static)[s * jp.block:(s + 1) * jp.block])
        if is_halo:
            want = [np.asarray(jp.mesh_static0_c)[s]] + [
                np.asarray(m)[s] for m in jp.mesh_static_own]
            for name in ("mm", "up", "down"):
                assert getattr(tp, f"{name}_plans") == getattr(
                    jp, f"{name}_plans")
                for t_idx, j_idx in zip(getattr(tp, f"{name}_send_idx"),
                                        getattr(jp, f"{name}_send_idx")):
                    np.testing.assert_array_equal(t_idx.numpy(),
                                                  np.asarray(j_idx)[s])
            assert (tp.mg_plan, tp.g2m_plan) == (jp.mg_plan, jp.g2m_plan)
            np.testing.assert_array_equal(tp.mg_send_idx.numpy(),
                                          np.asarray(jp.mg_send_idx)[s])
            np.testing.assert_array_equal(tp.g2m_add_pos.numpy(),
                                          np.asarray(jp.g2m_add_pos)[s])
        else:
            want = [np.asarray(m) for m in jp.mesh_static]
        assert len(tp.mesh_static) == len(want)
        for lv, (t_m, j_m) in enumerate(zip(tp.mesh_static, want)):
            np.testing.assert_array_equal(t_m.numpy(), j_m,
                                          err_msg=f"mesh_static[{lv}]")
    assert n_split >= S, "no split set"
    # conservation: a split set's interior and frontier edges over the
    # ranks are the whole set's
    for lv, es in enumerate(jg.m2m if is_halo else jg.m2m[:1]):
        j = jp.m2m[lv]
        if j.frontier is None:
            continue
        total = sum(_real_senders(j, s).size + _real_senders(j.frontier,
                                                             s).size
                    for s in range(S))
        assert total == int(np.asarray(es.mask[:, 0]).sum())
