"""Segment layout helpers.

Counterpart of neural_lam_tpu/ops/segment.py: the padded gather table
that `EdgeSet.from_local` stores beside the dense layout (host-side numpy),
and the batched row gather of the batched edge route.
"""

from __future__ import annotations

import numpy as np


def build_gather_table(receivers: np.ndarray, num_receivers: int):
    """Precompute the padded (num_receivers, max_deg) edge-id table.

    Entry [r, k] is the id of the k-th edge whose receiver is r, or
    ``num_edges`` (a sentinel one-past-the-end row) for padding.

    Returns (table int32 (N, max_deg), max_deg).
    """
    receivers = np.asarray(receivers)
    m = receivers.shape[0]
    counts = np.bincount(receivers, minlength=num_receivers) if m else np.zeros(
        num_receivers, dtype=np.int64
    )
    max_deg = int(counts.max()) if m else 1
    table = np.full((num_receivers, max(max_deg, 1)), m, dtype=np.int32)
    if m:
        # works for unsorted receivers too: stable-sort edge ids by
        # receiver, then place each id at its within-segment position.
        order = np.argsort(receivers, kind="stable").astype(np.int32)
        sorted_recv = receivers[order]
        starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
        within = np.arange(m) - starts[sorted_recv]
        table[sorted_recv, within] = order
    return table, max_deg


def gather_rows_batched(src, idx):
    """src[:, idx] for a (B, N, h) source: the rows `idx` (int32 or int64)
    of every batch element, (B, len(idx), h)."""
    return src.index_select(-2, idx)
