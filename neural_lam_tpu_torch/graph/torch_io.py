"""Interop with the reference's torch `.pt` graph directories.

Counterpart of neural_lam_tpu/graph/torch_io.py, on the port's GraphBundle.

The reference saves graphs as torch pickles (ref: neural_lam/create_graph.py
:82-102,414-416) and loads them in neural_lam/utils.py:36-188:

    m2m_edge_index.pt   list of (2, M_l) int64, one per level
    m2m_features.pt     list of (M_l, 3) float32 (RAW, normalized at load)
    mesh_features.pt    list of (N_l, 2) float32
    g2m_edge_index.pt / g2m_features.pt     (2, M) / (M, 3)
    m2g_edge_index.pt / m2g_features.pt
    mesh_up_edge_index.pt / mesh_up_features.pt      (hierarchical only)
    mesh_down_edge_index.pt / mesh_down_features.pt

Index convention (both frameworks): one global node numbering with all mesh
levels first (cumulative level offsets) and grid nodes after all mesh nodes.

Grid-ordering caveat: the reference's builder numbers grid nodes Y-MAJOR
(networkx sorted (y, x) tuples give g_ref = iy*Nx + ix,
ref: create_graph.py:437-465) which disagrees with its own datastores'
x-major `grid_index = ix*Ny + iy` stacking. This framework uses the
datastore-consistent x-major order everywhere, so conversion permutes the
grid endpoints of g2m senders / m2g receivers: g = (g_ref % Nx)*Ny +
g_ref // Nx. Edge features are positions/lengths and are order-free.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .storage import GraphBundle


def _load_pt(graph_dir: str, name: str):
    return torch.load(
        os.path.join(graph_dir, name), map_location="cpu", weights_only=True
    )


def _np_list(obj) -> list:
    """torch tensor-or-list-of-tensors -> list of numpy arrays."""
    if isinstance(obj, (list, tuple)):
        return [np.asarray(t) for t in obj]
    return [np.asarray(obj)]


def graph_from_torch_dir(graph_dir: str, grid_shape) -> GraphBundle:
    """Convert a reference `.pt` graph directory into a GraphBundle.

    grid_shape: (Nx, Ny) of the datastore grid — needed to translate the
    reference's y-major grid numbering to the datastore-consistent x-major
    `grid_index` (see module docstring). Pass the result to
    `graph_from_bundle` (normalization happens there, matching the
    reference's load-time divide-by-longest-edge, ref: utils.py:104-113).
    """
    nx, ny = int(grid_shape[0]), int(grid_shape[1])
    m2m_edge_index = _np_list(_load_pt(graph_dir, "m2m_edge_index.pt"))
    m2m_features = _np_list(_load_pt(graph_dir, "m2m_features.pt"))
    mesh_static_features = _np_list(_load_pt(graph_dir, "mesh_features.pt"))
    g2m_edge_index = np.asarray(_load_pt(graph_dir, "g2m_edge_index.pt"))
    g2m_features = np.asarray(_load_pt(graph_dir, "g2m_features.pt"))
    m2g_edge_index = np.asarray(_load_pt(graph_dir, "m2g_edge_index.pt"))
    m2g_features = np.asarray(_load_pt(graph_dir, "m2g_features.pt"))
    hierarchical = len(m2m_edge_index) > 1

    num_mesh = sum(p.shape[0] for p in mesh_static_features)

    def to_x_major(global_grid_idx):
        g_ref = global_grid_idx - num_mesh
        assert g_ref.min() >= 0 and g_ref.max() < nx * ny, (
            "grid endpoints out of range — wrong grid_shape or graph dir"
        )
        return num_mesh + (g_ref % nx) * ny + g_ref // nx

    g2m_edge_index = g2m_edge_index.copy()
    m2g_edge_index = m2g_edge_index.copy()
    g2m_edge_index[0] = to_x_major(g2m_edge_index[0])
    m2g_edge_index[1] = to_x_major(m2g_edge_index[1])

    if hierarchical:
        up_ei = _np_list(_load_pt(graph_dir, "mesh_up_edge_index.pt"))
        up_f = _np_list(_load_pt(graph_dir, "mesh_up_features.pt"))
        down_ei = _np_list(_load_pt(graph_dir, "mesh_down_edge_index.pt"))
        down_f = _np_list(_load_pt(graph_dir, "mesh_down_features.pt"))
    else:
        up_ei, up_f, down_ei, down_f = [], [], [], []

    return GraphBundle(
        hierarchical=hierarchical,
        m2m_edge_index=m2m_edge_index,
        m2m_features=m2m_features,
        mesh_static_features=mesh_static_features,
        mesh_up_edge_index=up_ei,
        mesh_up_features=up_f,
        mesh_down_edge_index=down_ei,
        mesh_down_features=down_f,
        g2m_edge_index=g2m_edge_index,
        g2m_features=g2m_features,
        m2g_edge_index=m2g_edge_index,
        m2g_features=m2g_features,
    )


def torch_dir_from_bundle(bundle: GraphBundle, graph_dir: str,
                          grid_shape) -> None:
    """Write a GraphBundle as a reference-format `.pt` graph directory
    (inverse of `graph_from_torch_dir`, incl. the grid reorder back to the
    reference's y-major numbering) — lets reference tooling consume graphs
    built here, and gives the conversion a round-trip test."""
    nx, ny = int(grid_shape[0]), int(grid_shape[1])
    os.makedirs(graph_dir, exist_ok=True)
    num_mesh = sum(p.shape[0] for p in bundle.mesh_static_features)

    def to_y_major(global_grid_idx):
        g = global_grid_idx - num_mesh
        return num_mesh + (g % ny) * nx + g // ny

    g2m_ei = bundle.g2m_edge_index.copy()
    m2g_ei = bundle.m2g_edge_index.copy()
    g2m_ei[0] = to_y_major(g2m_ei[0])
    m2g_ei[1] = to_y_major(m2g_ei[1])

    def save(name, obj):
        torch.save(obj, os.path.join(graph_dir, name))

    tt = torch.tensor
    save("m2m_edge_index.pt", [tt(e) for e in bundle.m2m_edge_index])
    save("m2m_features.pt", [tt(f) for f in bundle.m2m_features])
    save("mesh_features.pt", [tt(p) for p in bundle.mesh_static_features])
    save("g2m_edge_index.pt", tt(g2m_ei))
    save("g2m_features.pt", tt(bundle.g2m_features))
    save("m2g_edge_index.pt", tt(m2g_ei))
    save("m2g_features.pt", tt(bundle.m2g_features))
    if bundle.hierarchical:
        save("mesh_up_edge_index.pt",
             [tt(e) for e in bundle.mesh_up_edge_index])
        save("mesh_up_features.pt", [tt(f) for f in bundle.mesh_up_features])
        save("mesh_down_edge_index.pt",
             [tt(e) for e in bundle.mesh_down_edge_index])
        save("mesh_down_features.pt",
             [tt(f) for f in bundle.mesh_down_features])
