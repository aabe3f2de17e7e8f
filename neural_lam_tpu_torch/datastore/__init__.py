"""Datastores and their registry (counterpart of
neural_lam_tpu/datastore/__init__.py; ref: neural_lam/datastore/
__init__.py:6-26)."""

from .base import BaseDatastore, BaseRegularGridDatastore  # noqa: F401
from .dummy import DummyDatastore
from .dummy_global import DummyGlobalDatastore
from .mdp import MDPDatastore
from .npyfilesmeps import NpyFilesDatastoreMEPS

DATASTORES = {
    cls.SHORT_NAME: cls
    for cls in [MDPDatastore, NpyFilesDatastoreMEPS, DummyDatastore,
                DummyGlobalDatastore]
}


def register_datastore(cls):
    """Register an additional datastore class by its SHORT_NAME."""
    DATASTORES[cls.SHORT_NAME] = cls
    return cls


def init_datastore(datastore_kind: str, config_path) -> BaseDatastore:
    """Instantiate a datastore by registry short-name
    (ref: datastore/__init__.py:16-26)."""
    if datastore_kind not in DATASTORES:
        raise NotImplementedError(
            f"Datastore kind {datastore_kind} is not implemented")
    return DATASTORES[datastore_kind](config_path=config_path)
