from .export_keras import save_keras_weights
from .import_keras import infer_window_size, load_keras_weights
from .reviser import (
    Reviser,
    ReviserConfig,
    init_reviser_params,
    params_from_numpy,
    reviser_apply,
)

__all__ = [
    "Reviser",
    "ReviserConfig",
    "init_reviser_params",
    "params_from_numpy",
    "reviser_apply",
    "load_keras_weights",
    "infer_window_size",
    "save_keras_weights",
]
