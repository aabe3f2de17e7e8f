"""Per-state-feature loss weighting from config (ref: neural_lam/loss_weighting.py)."""

from __future__ import annotations

from .config import ManualStateFeatureWeighting, NeuralLAMConfig, UniformFeatureWeighting


def get_manual_state_feature_weights(weighting_config: ManualStateFeatureWeighting,
                                     datastore) -> list[float]:
    """Weights in datastore state-feature order; validates exact coverage
    (ref: loss_weighting.py:10-49)."""
    state_feature_names = datastore.get_vars_names(category="state")
    feature_weight_names = weighting_config.weights.keys()

    if set(feature_weight_names) != set(state_feature_names):
        additional = set(feature_weight_names) - set(state_feature_names)
        missing = set(state_feature_names) - set(feature_weight_names)
        raise ValueError(
            "State feature weights must be provided for each state feature "
            f"in the datastore ({state_feature_names}). {missing} are missing "
            f"and weights are defined for the features {additional} which are "
            "not in the datastore."
        )
    return [weighting_config.weights[f] for f in state_feature_names]


def get_uniform_state_feature_weights(datastore) -> list[float]:
    """1/n_features for each state feature (ref: loss_weighting.py:52-71)."""
    n = len(datastore.get_vars_names(category="state"))
    return [1.0 / n] * n


def get_state_feature_weighting(config: NeuralLAMConfig, datastore) -> list[float]:
    """Dispatch on the config's weighting class (ref: loss_weighting.py:74-106)."""
    weighting_config = config.training.state_feature_weighting
    if isinstance(weighting_config, ManualStateFeatureWeighting):
        return get_manual_state_feature_weights(weighting_config, datastore)
    if isinstance(weighting_config, UniformFeatureWeighting):
        return get_uniform_state_feature_weights(datastore)
    raise NotImplementedError(
        f"Unsupported state feature weighting configuration: {weighting_config}"
    )
