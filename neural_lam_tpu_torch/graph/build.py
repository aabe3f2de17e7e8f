"""Offline mesh-graph construction from grid coordinates.

Re-implements the reference's graph generation algorithm
(ref: neural_lam/create_graph.py:111-535) with pure numpy/scipy index
arithmetic — no networkx. The reference builds rectangular lattice meshes,
so node orderings and edge sets are fully determined by index math:

* per-level mesh: an n×n lattice with 4-neighbour + both diagonal edges,
  node (i, j) at (lx[i], ly[j]), node index i*n + j (the reference's
  sorted-tuple ordering, ref: create_graph.py:111-147).
* multiscale (flat): coarse level-l node (i, j) is identified with bottom
  node (3^l i + (3^l-1)/2, 3^l j + ...); coarse positions override bottom
  positions at shared nodes (networkx `compose` attribute precedence,
  ref: create_graph.py:371-405).
* hierarchical: levels stay separate with global indices offset by
  cumulative level sizes; up/down edges via 1-NN parent per child
  (ref: create_graph.py:277-350).
* g2m: grid nodes within radius 0.67·dm of each bottom-mesh node
  (ref: create_graph.py:424-486); m2g: 4 nearest bottom-mesh nodes per grid
  node (ref: create_graph.py:500-529).
* edge feature = [len, vdiff_x, vdiff_y] with vdiff = pos_u - pos_v
  (ref: create_graph.py:81-102); mesh static feature = pos / max|grid xy|
  (ref: create_graph.py:410-415).

Grid-node ordering: grid_index g = ix*Ny + iy with position xy[ix, iy] —
the datastores' stack("x", "y") convention (x-major). See the note in
`create_graph` about the reference's own (transposed) builder ordering.

`create_graph_from_datastore` and the CLI (`cli`, `python -m
neural_lam_tpu_torch.graph.build`) build a datastore's graph: this
module's lattice, or with `--mesh global_icosahedral` the spherical mesh
of `global_mesh.py`.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.spatial

from .storage import GraphBundle, save_graph

# radius (in units of bottom-mesh spacing) for grid->mesh association
# (ref: create_graph.py:424)
DM_SCALE = 0.67


def _lattice_positions(xy: np.ndarray, n: int):
    """Positions of an n×n mesh lattice over the grid's bounding box,
    nodes kept off the border (ref: create_graph.py:111-121)."""
    xm, xM = xy[:, 0, 0].min(), xy[:, 0, 0].max()
    ym, yM = xy[0, :, 1].min(), xy[0, :, 1].max()
    dx = (xM - xm) / n
    dy = (yM - ym) / n
    lx = np.linspace(xm + dx / 2, xM - dx / 2, n)
    ly = np.linspace(ym + dy / 2, yM - dy / 2, n)
    pos = np.stack(np.meshgrid(lx, ly, indexing="ij"), axis=-1)  # (n, n, 2)
    return pos.reshape(n * n, 2)


def _lattice_edges(n: int):
    """Directed edge list (2, M) of the 4-neighbour + diagonal lattice,
    both directions per undirected edge (ref: create_graph.py:122-147)."""
    idx = np.arange(n * n, dtype=np.int64).reshape(n, n)
    pairs = [
        (idx[:-1, :].ravel(), idx[1:, :].ravel()),      # +x
        (idx[:, :-1].ravel(), idx[:, 1:].ravel()),      # +y
        (idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()),   # diagonal
        (idx[1:, :-1].ravel(), idx[:-1, 1:].ravel()),   # anti-diagonal
    ]
    u = np.concatenate([p[0] for p in pairs])
    v = np.concatenate([p[1] for p in pairs])
    return np.stack([np.concatenate([u, v]), np.concatenate([v, u])])


def _edge_features(edge_index: np.ndarray, pos_send: np.ndarray,
                   pos_rec: np.ndarray):
    """[len, vdiff_x, vdiff_y] per edge, vdiff = pos_u - pos_v (u=sender)."""
    vdiff = pos_send[edge_index[0]] - pos_rec[edge_index[1]]
    length = np.sqrt((vdiff**2).sum(-1, keepdims=True))
    return np.concatenate([length, vdiff], axis=-1).astype(np.float32)


def create_graph(graph_dir_path: str, xy: np.ndarray,
                 n_max_levels: int | None, hierarchical: bool) -> GraphBundle:
    """Create all graph components from (Nx, Ny, 2) grid coordinates and save
    them under `graph_dir_path` (ref: create_graph.py:157-535)."""
    xy = np.asarray(xy, dtype=np.float64)
    assert xy.ndim == 3 and xy.shape[2] == 2, "xy must be (Nx, Ny, 2)"
    Nx, Ny = xy.shape[:2]
    pos_max = np.abs(xy).max()

    # --- mesh levels (ref: create_graph.py:241-262) ---
    refine = 3  # children per side per level
    nlev = int(np.log(max(Nx, Ny)) / np.log(refine))
    nleaf = refine**nlev
    mesh_levels = nlev - 1
    if n_max_levels:
        mesh_levels = min(mesh_levels, n_max_levels)
    assert mesh_levels >= 1, "Grid too small to build a mesh graph"
    if hierarchical and mesh_levels < 2:
        raise ValueError(
            "Hierarchical graphs need >= 2 mesh levels; grid of size "
            f"{Nx}x{Ny} only supports {mesh_levels} (need >= 27 points/side)"
        )

    level_n = [nleaf // (refine**lev) for lev in range(1, mesh_levels + 1)]
    level_pos = [_lattice_positions(xy, n) for n in level_n]
    level_edges = [_lattice_edges(n) for n in level_n]

    if hierarchical:
        bundle = _build_hierarchical(level_n, level_pos, level_edges)
    else:
        bundle = _build_flat(level_n, level_pos, level_edges, refine)

    # --- grid2mesh / mesh2grid over the bottom mesh (ref: :419-529) ---
    bottom_pos = bundle.g2m_mesh_pos  # bottom-level positions (flat: merged)
    n0 = level_n[0]
    # mesh spacing: distance between bottom nodes (1,0) and (0,0)
    dm = np.linalg.norm(bottom_pos[1 * n0 + 0] - bottom_pos[0])

    # Grid node positions in grid_index order. We use the datastore's
    # stacking convention grid_index = ix*Ny + iy (x-major, stack("x","y")).
    # NOTE: the reference's builder orders grid nodes y-major
    # (ref: create_graph.py:437-465 — networkx tuple sort gives i*Nx + j with
    # i the y index) which *disagrees* with its own datastores' x-major
    # grid_index; its graphs are effectively built on the transposed grid.
    # We deliberately use the consistent convention instead.
    grid_pos = xy.reshape(Nx * Ny, 2)

    kdt_g = scipy.spatial.KDTree(grid_pos)
    g2m_src, g2m_dst = [], []
    for m, p in enumerate(bottom_pos):
        for g in kdt_g.query_ball_point(p, dm * DM_SCALE):
            g2m_src.append(g)
            g2m_dst.append(m)
    g2m_edge_index = np.stack(
        [np.asarray(g2m_src, dtype=np.int64), np.asarray(g2m_dst, dtype=np.int64)]
    )
    g2m_features = _edge_features(g2m_edge_index, grid_pos, bottom_pos)

    kdt_m = scipy.spatial.KDTree(bottom_pos)
    _, nearest4 = kdt_m.query(grid_pos, 4)  # (N_grid, 4)
    m2g_src = nearest4.ravel()
    m2g_dst = np.repeat(np.arange(Nx * Ny, dtype=np.int64), 4)
    m2g_edge_index = np.stack([m2g_src.astype(np.int64), m2g_dst])
    m2g_features = _edge_features(m2g_edge_index, bottom_pos, grid_pos)

    # Global offsets matching the reference's saved file contract: grid node
    # indices come after all mesh nodes; g2m receivers / m2g senders are in
    # the global mesh index space (bottom level occupies [0, n_bottom)).
    num_mesh_total = sum(p.shape[0] for p in bundle.mesh_static_features)
    g2m_edge_index[0] += num_mesh_total
    m2g_edge_index[1] += num_mesh_total

    bundle = GraphBundle(
        hierarchical=bundle.hierarchical,
        m2m_edge_index=bundle.m2m_edge_index,
        m2m_features=bundle.m2m_features,
        mesh_static_features=[
            (p / pos_max).astype(np.float32) for p in bundle.mesh_static_features
        ],
        mesh_up_edge_index=bundle.mesh_up_edge_index,
        mesh_up_features=bundle.mesh_up_features,
        mesh_down_edge_index=bundle.mesh_down_edge_index,
        mesh_down_features=bundle.mesh_down_features,
        g2m_edge_index=g2m_edge_index,
        g2m_features=g2m_features,
        m2g_edge_index=m2g_edge_index,
        m2g_features=m2g_features,
        g2m_mesh_pos=bottom_pos,
    )
    save_graph(graph_dir_path, bundle)
    return bundle


def _build_flat(level_n, level_pos, level_edges, refine):
    """Merge all levels into one bottom-level graph (ref: :371-405)."""
    n0 = level_n[0]
    # bottom-level index of coarse level-l node (i, j):
    #   (s*i + o) * n0 + (s*j + o) with s = 3^l, o = (3^l - 1) / 2
    merged_pos = level_pos[0].copy()
    all_edges = [level_edges[0]]
    all_feats = [
        _edge_features(level_edges[0], level_pos[0], level_pos[0])
    ]
    for lev in range(1, len(level_n)):
        s = refine**lev
        o = (s - 1) // 2
        n_l = level_n[lev]
        ii, jj = np.divmod(np.arange(n_l * n_l), n_l)
        bottom_ids = (s * ii + o) * n0 + (s * jj + o)  # (n_l²,)
        # coarse positions override shared nodes (compose precedence)
        merged_pos[bottom_ids] = level_pos[lev]
        e = bottom_ids[level_edges[lev]]
        all_edges.append(e)
        all_feats.append(
            _edge_features(level_edges[lev], level_pos[lev], level_pos[lev])
        )
    m2m_edge_index = np.concatenate(all_edges, axis=1)
    m2m_features = np.concatenate(all_feats, axis=0)
    return GraphBundle(
        hierarchical=False,
        m2m_edge_index=[m2m_edge_index],
        m2m_features=[m2m_features],
        mesh_static_features=[merged_pos],
        mesh_up_edge_index=[],
        mesh_up_features=[],
        mesh_down_edge_index=[],
        mesh_down_features=[],
        g2m_edge_index=None,
        g2m_features=None,
        m2g_edge_index=None,
        m2g_features=None,
        g2m_mesh_pos=merged_pos,
    )


def _build_hierarchical(level_n, level_pos, level_edges):
    """Keep levels separate; add 1-NN up/down edges (ref: :264-369)."""
    sizes = [n * n for n in level_n]
    first_index = np.concatenate(([0], np.cumsum(sizes[:-1]))).astype(np.int64)

    m2m_edge_index = [
        e + first_index[lev] for lev, e in enumerate(level_edges)
    ]
    m2m_features = [
        _edge_features(e, p, p) for e, p in zip(level_edges, level_pos)
    ]

    up_edge_index, up_features = [], []
    down_edge_index, down_features = [], []
    for lev in range(1, len(level_n)):
        child_pos = level_pos[lev - 1]
        parent_pos = level_pos[lev]
        kdt = scipy.spatial.KDTree(parent_pos)
        _, parent_of = kdt.query(child_pos, 1)  # (n_child,)
        children = np.arange(sizes[lev - 1], dtype=np.int64)
        down = np.stack(
            [parent_of.astype(np.int64) + first_index[lev],
             children + first_index[lev - 1]]
        )  # parent -> child
        up = np.stack([down[1], down[0]])  # child -> parent (inverted)
        down_feat = _edge_features(
            np.stack([parent_of, children]), parent_pos, child_pos
        )
        up_feat = _edge_features(
            np.stack([children, parent_of]), child_pos, parent_pos
        )
        down_edge_index.append(down)
        down_features.append(down_feat)
        up_edge_index.append(up)
        up_features.append(up_feat)

    return GraphBundle(
        hierarchical=True,
        m2m_edge_index=m2m_edge_index,
        m2m_features=m2m_features,
        mesh_static_features=[p.copy() for p in level_pos],
        mesh_up_edge_index=up_edge_index,
        mesh_up_features=up_features,
        mesh_down_edge_index=down_edge_index,
        mesh_down_features=down_features,
        g2m_edge_index=None,
        g2m_features=None,
        m2g_edge_index=None,
        m2g_features=None,
        g2m_mesh_pos=level_pos[0],
    )


def create_graph_from_datastore(datastore, output_root_path: str,
                                n_max_levels: int | None = None,
                                hierarchical: bool = False,
                                mesh: str = "lattice",
                                refinements: int = 3) -> GraphBundle:
    """Build and save the graph for a regular-grid datastore
    (ref: create_graph.py:538-558). mesh="global_icosahedral" builds a
    spherical mesh instead: the datastore must be global, with get_xy in
    [lon, lat] degrees (`global_mesh.create_global_graph`)."""
    from ..datastore.base import BaseRegularGridDatastore

    if not isinstance(datastore, BaseRegularGridDatastore):
        raise NotImplementedError(
            "Only graph creation for BaseRegularGridDatastore is supported"
        )
    if mesh == "global_icosahedral":
        from .global_mesh import create_global_graph

        if not getattr(datastore, "is_global", False):
            raise ValueError("the global_icosahedral mesh needs a global "
                             "datastore (get_xy in [lon, lat] degrees)")
        return create_global_graph(
            graph_dir_path=output_root_path,
            latlon_deg=datastore.get_xy(category="state", stacked=True),
            refinements=refinements, n_levels=n_max_levels,
            hierarchical=hierarchical,
        )
    if mesh != "lattice":
        raise ValueError(f"unknown mesh {mesh!r}: lattice or "
                         "global_icosahedral")
    return create_graph(
        graph_dir_path=output_root_path,
        xy=datastore.get_xy(category="state", stacked=False),
        n_max_levels=n_max_levels, hierarchical=hierarchical,
    )


def cli(input_args=None):
    """Graph CLI, as `python -m neural_lam_tpu.graph.build` (ref:
    create_graph.py:561-606): builds the graph of the datastore a
    neural-lam config selects into <datastore root>/graph/<name>/.

        python -m neural_lam_tpu_torch.graph.build --config_path cfg.yaml \\
            --name hierarchical --hierarchical [--levels 3] \\
            [--mesh global_icosahedral --refinements 5] [--plot]

    `--plot` saves a 3D figure of the graph as graph.png beside it
    (`plot_graph.make_graph_figure`; needs matplotlib).
    """
    from argparse import ArgumentParser

    from ..config import load_config_and_datastore

    parser = ArgumentParser(description="Graph generation arguments")
    parser.add_argument("--config_path", type=str, required=True,
                        help="Path to neural-lam configuration file")
    parser.add_argument("--name", type=str, default="multiscale",
                        help="Name to save graph as (default: multiscale)")
    parser.add_argument("--levels", type=int,
                        help="Limit multi-scale mesh to given number of "
                             "levels, from bottom up (default: no limit)")
    parser.add_argument("--hierarchical", action="store_true",
                        help="Generate hierarchical mesh graph")
    parser.add_argument("--mesh", type=str, default="lattice",
                        choices=["lattice", "global_icosahedral"],
                        help="Mesh family: LAM lattice (reference) or a "
                             "global icosahedral sphere mesh")
    parser.add_argument("--refinements", type=int, default=3,
                        help="Icosahedron subdivision count for the finest "
                             "level (global_icosahedral only)")
    parser.add_argument("--plot", action="store_true",
                        help="Save a 3D figure of the generated graph next "
                             "to it (ref create_graph.py renders each level "
                             "interactively)")
    args = parser.parse_args(input_args)

    _, datastore = load_config_and_datastore(args.config_path)
    out_dir = os.path.join(datastore.root_path, "graph", args.name)
    bundle = create_graph_from_datastore(
        datastore=datastore, output_root_path=out_dir,
        n_max_levels=args.levels, hierarchical=args.hierarchical,
        mesh=args.mesh, refinements=args.refinements,
    )
    if args.plot:
        from ..plot_graph import load_plot_graph, make_graph_figure

        fig = make_graph_figure(load_plot_graph(out_dir),
                                datastore.get_xy("state"))
        fig_path = os.path.join(out_dir, "graph.png")
        fig.savefig(fig_path, dpi=150, bbox_inches="tight")
        print(f"Saved graph figure to {fig_path}")
    return bundle


if __name__ == "__main__":
    cli()
