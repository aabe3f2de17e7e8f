"""Global (spherical) mesh-graph construction: icosahedral mesh over a
lat-lon grid.

Counterpart of neural_lam_tpu/graph/global_mesh.py, numpy and scipy only,
with the same vertex numbering (parity with the JAX package depends on
it). The reference builds rectangular lattice meshes for limited-area
domains only (ref: neural_lam/create_graph.py:111-147). This module
produces `GraphBundle`s in the on-disk format of `graph.build` (global
node numbering: mesh levels first with cumulative offsets, finest level
0; grid nodes after all mesh nodes), so every model family and the dense
EdgeSet layout work unchanged on the sphere.

Construction (GraphCast-style, Lam et al. 2023):

* mesh levels: an icosahedron refined r times (Loop midpoint subdivision,
  vertices projected to the unit sphere). Refinement APPENDS vertices, so
  level r's vertex set contains level r-1's with identical indices: the
  multiscale (flat) merge is a plain union of the per-level edge lists
  over the finest level's vertices (ref: create_graph.py:371-405).
* hierarchical: levels kept separate (finest = level 0); up/down edges
  connect each child vertex to its nearest parent-level vertex both ways
  (ref: create_graph.py:277-350 uses the same 1-NN parent rule).
* g2m: grid points within chord radius 0.67 x (mean finest mesh edge
  length) of each bottom-mesh vertex (ref radius rule,
  create_graph.py:424-486); m2g: 4 nearest bottom-mesh vertices per grid
  point (ref: create_graph.py:500-529).
* positions are 3D unit vectors; edge features are
  [chord_len, dx, dy, dz]; mesh static features are the unit xyz
  coordinates.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.spatial

from .storage import GraphBundle, save_graph

G2M_RADIUS_SCALE = 0.67  # x mean finest-mesh edge length (ref rule)
M2G_K = 4


def latlon_to_xyz(latlon_deg: np.ndarray) -> np.ndarray:
    """(N, 2) [lon, lat] degrees -> (N, 3) unit sphere positions."""
    lon = np.deg2rad(latlon_deg[:, 0])
    lat = np.deg2rad(latlon_deg[:, 1])
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
        axis=-1,
    )


def _icosahedron():
    """Regular icosahedron: (12, 3) unit vertices, (20, 3) faces."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    return verts, faces


def _subdivide(verts: np.ndarray, faces: np.ndarray):
    """One Loop subdivision step on the sphere. New midpoint vertices are
    APPENDED, so existing vertex indices are preserved (prefix property
    the multiscale merge relies on)."""
    verts = list(verts)
    midpoint = {}

    def mid(a, b):
        key = (a, b) if a < b else (b, a)
        if key not in midpoint:
            m = verts[a] + verts[b]
            m = m / np.linalg.norm(m)
            midpoint[key] = len(verts)
            verts.append(m)
        return midpoint[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(new_faces, dtype=np.int64)


def _edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Directed (2, M) edge list, both directions per triangle edge."""
    u = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    v = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    und = np.unique(np.sort(np.stack([u, v], axis=1), axis=1), axis=0)
    return np.concatenate(
        [und.T, und.T[::-1]], axis=1
    ).astype(np.int64)  # (2, 2*|und|)


def build_icosahedral_levels(refinements: int):
    """Vertices and per-refinement edge lists.

    Returns (verts_per_level, edges_per_level), both ordered FINEST FIRST
    (level 0 = `refinements` subdivisions), matching graph.storage's
    bottom-level convention. verts_per_level[l] is a prefix view of the
    finest vertex array."""
    verts, faces = _icosahedron()
    levels = [(verts, faces)]
    for _ in range(refinements):
        verts, faces = _subdivide(verts, faces)
        levels.append((verts, faces))
    levels = levels[::-1]  # finest first
    finest_verts = levels[0][0]
    verts_per_level = [finest_verts[: lv[0].shape[0]] for lv in levels]
    edges_per_level = [_edges_from_faces(lv[1]) for lv in levels]
    return verts_per_level, edges_per_level


def _edge_features_3d(edge_index, pos_send, pos_rec):
    vdiff = pos_send[edge_index[0]] - pos_rec[edge_index[1]]
    length = np.sqrt((vdiff**2).sum(-1, keepdims=True))
    return np.concatenate([length, vdiff], axis=-1).astype(np.float32)


def locality_order(verts: np.ndarray) -> np.ndarray:
    """Meridian-major spatial sort permutation for unit-sphere vertices:
    primary key = longitude bin (bin width ~ one vertex spacing, so each
    bin is a thin meridian column), secondary key = latitude ascending.

    Subdivision order (the raw `_subdivide` output) interleaves vertices
    of every region, so consecutive vertex indices are spatially
    uncorrelated and row gathers jump across the whole table. This
    ordering makes consecutive indices spatially adjacent AND aligned
    with the lon-major raster global lat-lon datastores use (grid_index
    = ilon*n_lat + ilat, datastore/dummy_global.py). Graph topology is
    unaffected: callers remap edge indices through the permutation."""
    lon = np.mod(np.arctan2(verts[:, 1], verts[:, 0]), 2.0 * np.pi)
    lat = np.arcsin(np.clip(verts[:, 2], -1.0, 1.0))
    n = verts.shape[0]
    n_bins = max(int(np.sqrt(np.pi * n)), 1)
    lon_bin = np.minimum((lon / (2.0 * np.pi) * n_bins).astype(np.int64),
                         n_bins - 1)
    return np.lexsort((lat, lon_bin))


def create_global_graph(graph_dir_path: str, latlon_deg: np.ndarray,
                        refinements: int = 3,
                        n_levels: int | None = None,
                        hierarchical: bool = False,
                        reorder: bool = True) -> GraphBundle:
    """Build and save a global icosahedral mesh graph over a lat-lon grid.

    latlon_deg: (N_grid, 2) [lon, lat] in degrees (grid_index order).
    refinements: icosahedron subdivision count for the finest level.
    n_levels: number of mesh levels (finest up); default all
    (refinements + 1). hierarchical=True keeps levels separate with
    up/down edge sets; otherwise a single merged multiscale m2m set.
    reorder=True (default) renumbers each level's vertices into the
    spatial `locality_order` (graph isomorphic; see that function's
    docstring).
    """
    latlon_deg = np.asarray(latlon_deg, dtype=np.float64).reshape(-1, 2)
    grid_pos = latlon_to_xyz(latlon_deg)
    n_grid = grid_pos.shape[0]

    verts_per_level, edges_per_level = build_icosahedral_levels(refinements)
    if n_levels is not None:
        assert 1 <= n_levels <= len(verts_per_level)
        verts_per_level = verts_per_level[:n_levels]
        edges_per_level = edges_per_level[:n_levels]

    if reorder:
        # Per-level renumbering. All of a level's edge endpoints index
        # the FINEST vertex array (prefix property), but only positions
        # < level_size occur at level l, so remapping through that
        # level's own inverse permutation is exact. The flat branch's
        # cross-level union requires one shared numbering, so every
        # level is remapped through the FINEST level's permutation
        # there; the hierarchical branch keeps per-level numberings.
        perms = [locality_order(v) for v in verts_per_level]
        invs = []
        for p in perms:
            inv = np.empty_like(p)
            inv[p] = np.arange(p.shape[0])
            invs.append(inv)
        verts_per_level = [v[p] for v, p in zip(verts_per_level, perms)]
        if hierarchical:
            edges_per_level = [
                inv[e] for e, inv in zip(edges_per_level, invs)
            ]
        else:
            edges_per_level = [invs[0][e] for e in edges_per_level]

    bottom_verts = verts_per_level[0]
    bottom_edges = edges_per_level[0]

    # mean finest edge chord length sets the g2m radius
    dm = float(np.linalg.norm(
        bottom_verts[bottom_edges[0]] - bottom_verts[bottom_edges[1]],
        axis=1,
    ).mean())

    if hierarchical:
        level_sizes = [v.shape[0] for v in verts_per_level]
        first_index = np.concatenate(([0], np.cumsum(level_sizes[:-1])))
        m2m_edge_index = [
            e + first_index[lev] for lev, e in enumerate(edges_per_level)
        ]
        m2m_features = [
            _edge_features_3d(e, v, v)
            for e, v in zip(edges_per_level, verts_per_level)
        ]
        up_idx, up_feat, down_idx, down_feat = [], [], [], []
        for lev in range(len(level_sizes) - 1):
            child, parent = verts_per_level[lev], verts_per_level[lev + 1]
            tree = scipy.spatial.cKDTree(parent)
            # k=2 with a geometric tie-break: every midpoint vertex is
            # exactly equidistant to the two parents it bisects, and
            # cKDTree's 1-NN tie-break follows array order — which would
            # make the hierarchy depend on the vertex numbering (and on
            # `reorder`). Among near-tied parents pick the one with the
            # lexicographically larger (z, y, x) position instead, so
            # the graph topology is numbering-invariant.
            dd, nn = tree.query(child, k=2)
            tied = (dd[:, 1] - dd[:, 0]) <= 1e-9 * (dd[:, 0] + 1e-30)
            p0, p1 = parent[nn[:, 0]], parent[nn[:, 1]]
            key0 = [p0[:, 0], p0[:, 1], p0[:, 2]]
            key1 = [p1[:, 0], p1[:, 1], p1[:, 2]]
            pick1 = np.zeros(child.shape[0], dtype=bool)
            undecided = np.ones(child.shape[0], dtype=bool)
            for a, b in ((key0[2], key1[2]), (key0[1], key1[1]),
                         (key0[0], key1[0])):
                gt = undecided & (b > a + 1e-12)
                lt = undecided & (b < a - 1e-12)
                pick1 |= gt
                undecided &= ~(gt | lt)
            parent_of = np.where(tied & pick1, nn[:, 1], nn[:, 0])
            child_ids = np.arange(child.shape[0], dtype=np.int64)
            up = np.stack([
                child_ids + first_index[lev],
                parent_of.astype(np.int64) + first_index[lev + 1],
            ])
            down = up[::-1].copy()
            up_idx.append(up)
            up_feat.append(_edge_features_3d(
                np.stack([child_ids, parent_of.astype(np.int64)]),
                child, parent,
            ))
            down_idx.append(down)
            down_feat.append(_edge_features_3d(
                np.stack([parent_of.astype(np.int64), child_ids]),
                parent, child,
            ))
        mesh_levels = verts_per_level
        num_mesh_total = int(sum(level_sizes))
    else:
        # multiscale merge: union of all levels' edges over the finest
        # vertex set (prefix property makes index mapping the identity)
        all_edges = np.concatenate(edges_per_level, axis=1)
        und = np.unique(np.sort(all_edges.T, axis=1), axis=0)
        merged = np.concatenate([und.T, und.T[::-1]], axis=1)
        m2m_edge_index = [merged]
        m2m_features = [
            _edge_features_3d(merged, bottom_verts, bottom_verts)
        ]
        up_idx = up_feat = down_idx = down_feat = []
        mesh_levels = [bottom_verts]
        num_mesh_total = bottom_verts.shape[0]

    # g2m: grid points within radius of each bottom-mesh vertex; global
    # grid indices come AFTER all mesh nodes (graph.storage convention)
    grid_tree = scipy.spatial.cKDTree(grid_pos)
    neigh = grid_tree.query_ball_point(bottom_verts,
                                       r=G2M_RADIUS_SCALE * dm)
    g2m_send, g2m_rec = [], []
    for mesh_i, grid_ids in enumerate(neigh):
        for gi in grid_ids:
            g2m_send.append(gi)
            g2m_rec.append(mesh_i)
    g2m_send = np.asarray(g2m_send, dtype=np.int64)
    g2m_rec = np.asarray(g2m_rec, dtype=np.int64)
    g2m_edge_index = np.stack([g2m_send + num_mesh_total, g2m_rec])
    g2m_features = _edge_features_3d(
        np.stack([g2m_send, g2m_rec]), grid_pos, bottom_verts
    )

    # m2g: 4 nearest bottom-mesh vertices per grid point
    mesh_tree = scipy.spatial.cKDTree(bottom_verts)
    _, nearest = mesh_tree.query(grid_pos, k=M2G_K)
    m2g_send = nearest.reshape(-1).astype(np.int64)
    m2g_rec = np.repeat(np.arange(n_grid, dtype=np.int64), M2G_K)
    m2g_edge_index = np.stack([m2g_send, m2g_rec + num_mesh_total])
    m2g_features = _edge_features_3d(
        np.stack([m2g_send, m2g_rec]), bottom_verts, grid_pos
    )

    bundle = GraphBundle(
        hierarchical=hierarchical,
        m2m_edge_index=m2m_edge_index,
        m2m_features=m2m_features,
        mesh_static_features=[
            v.astype(np.float32) for v in mesh_levels
        ],
        mesh_up_edge_index=up_idx,
        mesh_up_features=up_feat,
        mesh_down_edge_index=down_idx,
        mesh_down_features=down_feat,
        g2m_edge_index=g2m_edge_index,
        g2m_features=g2m_features,
        m2g_edge_index=m2g_edge_index,
        m2g_features=m2g_features,
        g2m_mesh_pos=bottom_verts,
    )
    if graph_dir_path:
        os.makedirs(graph_dir_path, exist_ok=True)
        save_graph(graph_dir_path, bundle)
    return bundle
