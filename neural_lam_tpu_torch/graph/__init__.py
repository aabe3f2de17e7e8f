"""Graph construction (numpy/scipy) and loading into torch EdgeSets."""

from .build import create_graph  # noqa: F401
from .storage import (  # noqa: F401
    GraphBundle,
    graph_from_bundle,
    load_graph_bundle,
    load_or_build_graph,
)
