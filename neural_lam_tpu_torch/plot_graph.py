"""3D graph visualization CLI (ref: neural_lam/plot_graph.py:19-210).

Counterpart of neural_lam_tpu/plot_graph.py. Renders the g2m/m2m/m2g
(and up/down) edge sets with the mesh levels stacked at different z
heights: `graph_scene` extracts the point clouds and edge segments (numpy
alone), `make_graph_figure` draws them on matplotlib's 3D axes, and
`--html` writes the interactive page of `graph/html_viz.py` (numpy alone
too, so it works where matplotlib is missing; the PNG then raises,
naming it).

Usage: python -m neural_lam_tpu_torch.plot_graph --config_path <cfg>
       [--graph name] [--save out.png] [--html out.html] [--mesh_only]
       [--show_axis]
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

MESH_HEIGHT = 0.1
MESH_LEVEL_DIST = 0.2
GRID_HEIGHT = 0


def _np(x):
    """A graph array (a tensor on any device, or an array) as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _edge_segments(pos_send, pos_rec, senders, receivers):
    a = pos_send[_np(senders)]
    b = pos_rec[_np(receivers)]
    return np.stack([a, b], axis=1)  # (M, 2, 3)


def graph_scene(graph, grid_xy, mesh_only=False):
    """The 3D scene (point clouds + edge-segment sets) of a LoadedGraph
    (`graph/storage.py`, its tensors on any device) and the grid
    positions, in numpy. Shared by the matplotlib renderer below and the
    interactive HTML page (`graph/html_viz.py`)."""
    scale = float(np.ptp(grid_xy[:, 0]))
    grid_pos = np.concatenate(
        [grid_xy, np.full((grid_xy.shape[0], 1), GRID_HEIGHT)], axis=1
    )

    # mesh level positions (static features are normalized positions;
    # rescale with the grid extent for display)
    pos_max = np.abs(grid_xy).max()
    level_pos = []
    for lev, feat in enumerate(graph.mesh_static_features):
        p = _np(feat) * pos_max
        z = (MESH_HEIGHT + lev * MESH_LEVEL_DIST) * scale
        level_pos.append(
            np.concatenate([p, np.full((p.shape[0], 1), z)], axis=1)
        )

    edge_sets, point_sets = [], []
    for lev, es in enumerate(graph.m2m):
        edge_sets.append(dict(
            name=f"m2m L{lev}", color="blue", width=0.3,
            segs=_edge_segments(level_pos[lev], level_pos[lev],
                                es.senders, es.receivers),
        ))
    for lev, es in enumerate(graph.up):
        edge_sets.append(dict(
            name=f"up L{lev}", color="green", width=0.3,
            segs=_edge_segments(level_pos[lev], level_pos[lev + 1],
                                es.senders, es.receivers),
        ))
    for lev, es in enumerate(graph.down):
        edge_sets.append(dict(
            name=f"down L{lev}", color="purple", width=0.3,
            segs=_edge_segments(level_pos[lev + 1], level_pos[lev],
                                es.senders, es.receivers),
        ))
    if not mesh_only:
        edge_sets.append(dict(
            name="g2m", color="orange", width=0.15,
            segs=_edge_segments(grid_pos, level_pos[0],
                                graph.g2m.senders, graph.g2m.receivers),
        ))
        edge_sets.append(dict(
            name="m2g", color="red", width=0.15,
            segs=_edge_segments(level_pos[0], grid_pos,
                                graph.m2g.senders, graph.m2g.receivers),
        ))
        point_sets.append(dict(name="grid", color="black", size=1,
                               pos=grid_pos))
    for lev, p in enumerate(level_pos):
        point_sets.append(dict(name=f"mesh L{lev}", color=None, size=4,
                               pos=p))
    return point_sets, edge_sets


def make_graph_figure(graph, grid_xy, mesh_only=False,
                      show_axis=False):
    """The 3D matplotlib figure of a LoadedGraph and the grid positions.
    Raises ImportError naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("make_graph_figure draws with matplotlib, which "
                          "is not installed; graph_scene and the --html "
                          "page need numpy alone") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    point_sets, edge_sets = graph_scene(graph, grid_xy, mesh_only)

    fig = plt.figure(figsize=(12, 10))
    ax = fig.add_subplot(projection="3d")
    for es in edge_sets:
        label = es["name"] if not es["name"].endswith(
            tuple(f"L{i}" for i in range(1, 32))
        ) else None
        ax.add_collection(Line3DCollection(
            es["segs"], colors=es["color"], linewidths=es["width"],
            label=label,
        ))
    all_pts = []
    for ps in point_sets:
        p = ps["pos"]
        kw = {"c": ps["color"], "alpha": 0.3} if ps["color"] else {}
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=ps["size"],
                   label=ps["name"], **kw)
        all_pts.append(p)

    all_pts = np.concatenate(all_pts)
    ax.auto_scale_xyz(all_pts[:, 0], all_pts[:, 1], all_pts[:, 2])
    ax.legend(loc="upper left", fontsize=8)
    if not show_axis:
        ax.set_axis_off()  # ref: plot_graph.py:193
    return fig


def load_plot_graph(graph_dir_path: str):
    """The graph under `graph_dir_path` on the CPU (the dense layout, as
    the JAX package's `load_graph` gives it)."""
    from .graph.storage import graph_from_bundle, load_graph_bundle

    return graph_from_bundle(load_graph_bundle(graph_dir_path),
                             device="cpu")


def main(input_args=None):
    import os

    from .config import load_config_and_datastore

    parser = ArgumentParser(description="Plot graph")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--graph", type=str, default="multiscale",
                        help="Graph to plot (default: multiscale)")
    parser.add_argument("--save", type=str, default="graph.png",
                        help="Output image path (default: graph.png)")
    parser.add_argument("--html", type=str, default=None,
                        help="Also save an interactive 3D page here "
                        "(standalone html, rotate/zoom/toggle sets; the "
                        "reference's plotly html equivalent)")
    parser.add_argument("--mesh_only", action="store_true",
                        help="Plot only the mesh (no g2m/m2g edges)")
    parser.add_argument("--show_axis", action="store_true",
                        help="Show the 3D axes (ref: plot_graph.py:40)")
    args = parser.parse_args(input_args)

    _, datastore = load_config_and_datastore(config_path=args.config_path)
    graph = load_plot_graph(
        os.path.join(datastore.root_path, "graph", args.graph))
    grid_xy = datastore.get_xy("state")
    fig = make_graph_figure(graph, grid_xy, mesh_only=args.mesh_only,
                            show_axis=args.show_axis)
    fig.savefig(args.save, dpi=200, bbox_inches="tight")
    print(f"Saved graph figure to {args.save}")
    if args.html:
        from .graph.html_viz import save_interactive_html

        point_sets, edge_sets = graph_scene(
            graph, grid_xy, mesh_only=args.mesh_only
        )
        save_interactive_html(point_sets, edge_sets, args.html,
                              title=f"graph: {args.graph}")
        print(f"Saved interactive graph page to {args.html}")


if __name__ == "__main__":
    main()
