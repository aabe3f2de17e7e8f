"""Datastores (counterpart of neural_lam_tpu/datastore)."""

from .base import BaseDatastore, BaseRegularGridDatastore  # noqa: F401
from .dummy import DummyDatastore  # noqa: F401
