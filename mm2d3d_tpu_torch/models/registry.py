"""Model plugin registry (port of `mm2d3d_tpu/models/registry.py`).

Built-in models register by name (`net2d`, `net3d`, `minkunet34c`);
`load_model("name" | "pkg.module", **cfg)` resolves a registry entry or
imports a module that exports ``Model`` (and optionally ``signature`` and
``dependencies``), and passes only the config keys the model's constructor
declares.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_model(name: str, signature: Optional[Tuple] = None,
                   dependencies: Optional[list] = None) -> Callable:
    def deco(cls):
        _REGISTRY[name] = {"cls": cls, "signature": signature,
                           "dependencies": dependencies or []}
        return cls

    return deco


def available_models() -> list:
    return sorted(_REGISTRY)


def get_entry(name: str) -> Dict[str, Any]:
    if name in _REGISTRY:
        return _REGISTRY[name]
    mod = importlib.import_module(name)
    return {"cls": mod.Model, "signature": getattr(mod, "signature", None),
            "dependencies": getattr(mod, "dependencies", [])}


def load_model(name: str, **config):
    """Instantiate a registered or plugin model with the config keys its
    constructor declares."""
    cls = get_entry(name)["cls"]
    fields = set(inspect.signature(cls).parameters)
    return cls(**{k: v for k, v in config.items() if k in fields})


def _register_builtins():
    from .minkunet import MinkUNet34CSeg
    from .net2d import Net2DSeg
    from .sparse_unet import Net3DSeg

    register_model(
        "net2d",
        signature=(
            {"img": np.zeros([1, 225, 400, 3], np.float32),
             "depth": np.zeros([1, 225, 400, 1], np.float32),
             "img_indices": np.zeros([1, 8192, 2], np.int32)},
            {"seg_logit": np.zeros([1, 8192, 6], np.float32),
             "seg_logit_2d": np.zeros([1, 225, 400, 6], np.float32)},
        ),
        dependencies=["torch"],
    )(Net2DSeg)
    register_model(
        "net3d",
        signature=(
            {"feats": np.zeros([8192, 3], np.float32)},
            {"seg_logit": np.zeros([8192, 6], np.float32),
             "confidence": np.zeros([8192, 1], np.float32)},
        ),
        dependencies=["torch"],
    )(Net3DSeg)
    register_model(
        "minkunet34c",
        signature=(
            {"feats": np.zeros([10240, 3], np.float32)},
            {"seg_logit": np.zeros([10240, 6], np.float32),
             "confidence": np.zeros([10240, 1], np.float32)},
        ),
        dependencies=["torch"],
    )(MinkUNet34CSeg)


_register_builtins()
