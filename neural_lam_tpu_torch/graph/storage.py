"""Graph storage (.npz) and loading into torch EdgeSets on a device.

Counterpart of neural_lam_tpu/graph/storage.py: the same `graph.npz` +
`meta.json` file contract (global edge numbering, ref:
neural_lam/create_graph.py:164-228) and the same normalization on load
(all edge features divided by the longest m2m edge length,
ref: neural_lam/utils.py:104-113). Loading builds the dense K-slot
virtual-row layout (`EdgeSet.from_local`) with torch tensors on `device`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.message_passing import EdgeSet


@dataclasses.dataclass
class GraphBundle:
    """Raw (numpy, global-index) graph components as built/saved on disk."""

    hierarchical: bool
    m2m_edge_index: list  # per level (2, M)
    m2m_features: list  # per level (M, 3)
    mesh_static_features: list  # per level (N, 2)
    mesh_up_edge_index: list  # len n_levels-1
    mesh_up_features: list
    mesh_down_edge_index: list
    mesh_down_features: list
    g2m_edge_index: np.ndarray | None
    g2m_features: np.ndarray | None
    m2g_edge_index: np.ndarray | None
    m2g_features: np.ndarray | None
    g2m_mesh_pos: np.ndarray | None = None  # bottom-mesh positions (builder temp)

    @property
    def n_levels(self) -> int:
        return len(self.m2m_edge_index)

    @property
    def level_sizes(self) -> list[int]:
        return [p.shape[0] for p in self.mesh_static_features]


def save_graph(graph_dir_path: str, bundle: GraphBundle) -> None:
    """Write `graph.npz` + `meta.json` under graph_dir_path."""
    os.makedirs(graph_dir_path, exist_ok=True)
    arrays = {}
    for lev in range(bundle.n_levels):
        arrays[f"m2m_edge_index_{lev}"] = bundle.m2m_edge_index[lev]
        arrays[f"m2m_features_{lev}"] = bundle.m2m_features[lev]
        arrays[f"mesh_features_{lev}"] = bundle.mesh_static_features[lev]
    for lev in range(len(bundle.mesh_up_edge_index)):
        arrays[f"mesh_up_edge_index_{lev}"] = bundle.mesh_up_edge_index[lev]
        arrays[f"mesh_up_features_{lev}"] = bundle.mesh_up_features[lev]
        arrays[f"mesh_down_edge_index_{lev}"] = bundle.mesh_down_edge_index[lev]
        arrays[f"mesh_down_features_{lev}"] = bundle.mesh_down_features[lev]
    arrays["g2m_edge_index"] = bundle.g2m_edge_index
    arrays["g2m_features"] = bundle.g2m_features
    arrays["m2g_edge_index"] = bundle.m2g_edge_index
    arrays["m2g_features"] = bundle.m2g_features
    np.savez_compressed(os.path.join(graph_dir_path, "graph.npz"), **arrays)
    with open(os.path.join(graph_dir_path, "meta.json"), "w") as f:
        json.dump(
            {"n_levels": bundle.n_levels,
             "hierarchical": bool(bundle.hierarchical)}, f,
        )


def load_graph_bundle(graph_dir_path: str) -> GraphBundle:
    """Read the raw numpy bundle back from disk."""
    with open(os.path.join(graph_dir_path, "meta.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(graph_dir_path, "graph.npz"))
    n_levels = meta["n_levels"]
    hierarchical = meta["hierarchical"]
    n_ud = n_levels - 1 if hierarchical else 0
    return GraphBundle(
        hierarchical=hierarchical,
        m2m_edge_index=[z[f"m2m_edge_index_{l}"] for l in range(n_levels)],
        m2m_features=[z[f"m2m_features_{l}"] for l in range(n_levels)],
        mesh_static_features=[z[f"mesh_features_{l}"] for l in range(n_levels)],
        mesh_up_edge_index=[z[f"mesh_up_edge_index_{l}"] for l in range(n_ud)],
        mesh_up_features=[z[f"mesh_up_features_{l}"] for l in range(n_ud)],
        mesh_down_edge_index=[z[f"mesh_down_edge_index_{l}"] for l in range(n_ud)],
        mesh_down_features=[z[f"mesh_down_features_{l}"] for l in range(n_ud)],
        g2m_edge_index=z["g2m_edge_index"],
        g2m_features=z["g2m_features"],
        m2g_edge_index=z["m2g_edge_index"],
        m2g_features=z["m2g_features"],
    )


@dataclasses.dataclass(frozen=True)
class LoadedGraph:
    """Device-resident graph: local-index dense EdgeSets + normalized static
    features. m2m/up/down are per-level tuples (flat graphs: one m2m entry,
    empty up/down); up[l] sends from level l to its parents at level l+1,
    down[l] from level l+1 to level l."""

    g2m: EdgeSet
    m2g: EdgeSet
    m2m: tuple
    up: tuple
    down: tuple
    mesh_static_features: tuple  # per-level (N_l, 2) tensors
    hierarchical: bool
    num_grid_nodes: int
    level_sizes: tuple


def graph_from_bundle(bundle: GraphBundle, device="cuda") -> LoadedGraph:
    """Convert a raw bundle to local-index dense EdgeSets on `device`, with
    the reference's normalization (ref: neural_lam/utils.py:36-188)."""
    device = resolve_device(device)
    level_sizes = bundle.level_sizes
    first_index = np.concatenate(([0], np.cumsum(level_sizes[:-1]))).astype(np.int64)
    num_mesh_total = int(sum(level_sizes))

    # Every grid node receives exactly 4 m2g edges, so the receiver max
    # reliably gives the grid size (ref: create_graph.py:506-519).
    num_grid = int(bundle.m2g_edge_index[1].max()) - num_mesh_total + 1

    longest_edge = max(
        float(f[:, 0].max()) for f in bundle.m2m_features
    )  # ref: utils.py:104-107

    def norm(f):
        return (np.asarray(f, np.float32) / longest_edge).astype(np.float32)

    g2m = EdgeSet.from_local(
        senders=bundle.g2m_edge_index[0] - num_mesh_total,
        receivers=bundle.g2m_edge_index[1],  # bottom level starts at 0
        features=norm(bundle.g2m_features),
        num_send=num_grid, num_rec=level_sizes[0], device=device,
    )
    m2g = EdgeSet.from_local(
        senders=bundle.m2g_edge_index[0],
        receivers=bundle.m2g_edge_index[1] - num_mesh_total,
        features=norm(bundle.m2g_features),
        num_send=level_sizes[0], num_rec=num_grid, device=device,
    )
    m2m = tuple(
        EdgeSet.from_local(
            senders=e[0] - first_index[lev],
            receivers=e[1] - first_index[lev],
            features=norm(f),
            num_send=level_sizes[lev], num_rec=level_sizes[lev],
            device=device,
        )
        for lev, (e, f) in enumerate(zip(bundle.m2m_edge_index, bundle.m2m_features))
    )
    up = tuple(
        EdgeSet.from_local(
            senders=e[0] - first_index[lev],        # child level lev
            receivers=e[1] - first_index[lev + 1],  # parent level lev+1
            features=norm(f),
            num_send=level_sizes[lev], num_rec=level_sizes[lev + 1],
            device=device,
        )
        for lev, (e, f) in enumerate(
            zip(bundle.mesh_up_edge_index, bundle.mesh_up_features))
    )
    down = tuple(
        EdgeSet.from_local(
            senders=e[0] - first_index[lev + 1],  # parent level lev+1
            receivers=e[1] - first_index[lev],    # child level lev
            features=norm(f),
            num_send=level_sizes[lev + 1], num_rec=level_sizes[lev],
            device=device,
        )
        for lev, (e, f) in enumerate(
            zip(bundle.mesh_down_edge_index, bundle.mesh_down_features))
    )
    return LoadedGraph(
        g2m=g2m,
        m2g=m2g,
        m2m=m2m,
        up=up,
        down=down,
        mesh_static_features=tuple(
            torch.as_tensor(np.asarray(p, np.float32), device=device)
            for p in bundle.mesh_static_features
        ),
        hierarchical=bool(bundle.hierarchical),
        num_grid_nodes=num_grid,
        level_sizes=tuple(int(s) for s in level_sizes),
    )


def load_or_build_graph(datastore, name: str, device="cuda") -> LoadedGraph:
    """The graph under <datastore root>/graph/<name> on `device`, built
    there first when absent, as the JAX package's models do: hierarchical
    when the name holds "hier", one level when it holds "1level",
    multiscale otherwise. The build goes to a directory unique to the
    process and is renamed into place, so processes that share the root
    (a trainer and a forecaster, or two of either) never read a
    half-written graph: the first rename wins, the others discard theirs."""
    from .build import create_graph

    graph_dir = Path(datastore.root_path) / "graph" / name
    if not (graph_dir / "meta.json").exists():
        print(f"graph '{name}' not found under {graph_dir.parent}; "
              "building it", flush=True)
        tmp = graph_dir.parent / f".{name}.tmp{os.getpid()}"
        create_graph(str(tmp), datastore.get_xy("state", stacked=False),
                     n_max_levels=1 if "1level" in name.lower() else None,
                     hierarchical="hier" in name.lower())
        try:
            os.rename(tmp, graph_dir)
        except OSError:  # another process renamed its build first
            shutil.rmtree(tmp, ignore_errors=True)
    return graph_from_bundle(load_graph_bundle(str(graph_dir)), device)
