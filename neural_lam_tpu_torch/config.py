"""YAML config system, schema-compatible with the reference's config files.

PyTorch port: the classes the forecast and training paths read, and
`load_config_and_datastore` for the datastores the port has; PyYAML is
imported only when a YAML file is read, so the package imports without
it.

ref: neural_lam/config.py — a neural-lam config YAML selects a datastore
(kind + per-datastore config path, resolved relative to the config file) and
training options, with polymorphic sections chosen by a `__config_class__`
tag. Re-implemented on plain pyyaml + dataclasses (no dataclass_wizard in
this environment); the on-disk YAML format is identical, so reference config
files load unchanged.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Union


class InvalidConfigError(Exception):
    pass


@dataclasses.dataclass
class DatastoreSelection:
    """Datastore choice: `kind` (registry short name) + `config_path`
    relative to the neural-lam config file (ref: config.py:28-43)."""

    kind: str
    config_path: str


@dataclasses.dataclass
class ManualStateFeatureWeighting:
    """Manually specified per-state-feature loss weights (ref: config.py:47-58)."""

    weights: Dict[str, float]


@dataclasses.dataclass
class UniformFeatureWeighting:
    """All state features weighted equally (ref: config.py:61-68)."""


# Tag value (class name) -> class, for `__config_class__` tagged unions
# (ref: config.py:107-132 — tag_key="__config_class__", auto class-name tags).
_TAGGED_CLASSES = {
    "ManualStateFeatureWeighting": ManualStateFeatureWeighting,
    "UniformFeatureWeighting": UniformFeatureWeighting,
}
TAG_KEY = "__config_class__"


def _parse_tagged_union(value: dict, default_cls):
    if value is None:
        return default_cls()
    value = dict(value)
    tag = value.pop(TAG_KEY, None)
    cls = _TAGGED_CLASSES.get(tag, default_cls) if tag else default_cls
    if tag is not None and tag not in _TAGGED_CLASSES:
        raise InvalidConfigError(f"Unknown {TAG_KEY}: {tag}")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(value) - fields
    if unknown:
        raise InvalidConfigError(f"Unknown keys for {cls.__name__}: {unknown}")
    return cls(**value)


@dataclasses.dataclass
class TrainingConfig:
    """Training options (ref: config.py:72-87)."""

    state_feature_weighting: Union[
        ManualStateFeatureWeighting, UniformFeatureWeighting
    ] = dataclasses.field(default_factory=UniformFeatureWeighting)


@dataclasses.dataclass
class NeuralLAMConfig:
    """Top-level config: datastore selection + training (ref: config.py:91-132)."""

    datastore: DatastoreSelection
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "NeuralLAMConfig":
        try:
            ds = DatastoreSelection(**d["datastore"])
        except (KeyError, TypeError) as ex:
            raise InvalidConfigError(f"Invalid datastore section: {ex}") from ex
        training_d = d.get("training") or {}
        weighting = _parse_tagged_union(
            training_d.get("state_feature_weighting"), UniformFeatureWeighting
        )
        return cls(datastore=ds,
                   training=TrainingConfig(state_feature_weighting=weighting))

    @classmethod
    def from_yaml_file(cls, path) -> "NeuralLAMConfig":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
        if not isinstance(d, dict):
            raise InvalidConfigError(f"Config file {path} is not a mapping")
        return cls.from_dict(d)


def load_config_and_datastore(config_path):
    """Load the neural-lam config and construct the datastore it selects
    (ref: config.py:139-171): mdp, npyfilesmeps, dummydata or
    dummydata_global; the
    datastore's config path resolves against the config file's directory."""
    from .datastore import init_datastore

    config = NeuralLAMConfig.from_yaml_file(config_path)
    ds_path = Path(config_path).parent / config.datastore.config_path
    datastore = init_datastore(datastore_kind=config.datastore.kind,
                               config_path=ds_path)
    return config, datastore
