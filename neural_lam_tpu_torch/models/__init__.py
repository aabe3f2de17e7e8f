"""Forecast models (counterpart of neural_lam_tpu/models)."""

from .base_hi_graph_model import BaseHiGraphModel
from .graph_efm import GraphEFM, HiEFM  # noqa: F401
from .graph_lam import GraphLAM  # noqa: F401
from .hi_lam import HiLAM  # noqa: F401
from .hi_lam_parallel import HiLAMParallel  # noqa: F401

MODELS = {"graph_lam": GraphLAM, "hi_lam": HiLAM,
          "hi_lam_parallel": HiLAMParallel, "graph_efm": GraphEFM,
          "hi_efm": HiEFM}


def is_hierarchical(model: str) -> bool:
    """Whether MODELS[model] runs on a hierarchical mesh graph."""
    return issubclass(MODELS[model], BaseHiGraphModel)
