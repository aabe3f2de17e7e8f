"""Forecast models (counterpart of neural_lam_tpu/models)."""

from .graph_lam import GraphLAM  # noqa: F401
from .hi_lam import HiLAM  # noqa: F401

MODELS = {"graph_lam": GraphLAM, "hi_lam": HiLAM}
