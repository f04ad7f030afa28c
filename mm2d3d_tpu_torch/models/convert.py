"""Weight bridge: the JAX package's flax trees -> this package's state_dicts.

`from_flax` takes the params and batch-stats trees of Net2DSeg and Net3DSeg
as nested dicts of numpy arrays (e.g. `jax.tree_util.tree_map(np.asarray,
state.params2d)`) and returns one `state_dict` per branch.  The port's module
names mirror the flax tree, so every leaf maps by its path:

    Conv kernel HWIO                  -> weight OIHW
    ConvTranspose kernel (kh,kw,I,O)  -> weight (I, O, kh, kw), spatial flip undone
                                         (inverse of torch_import._tconv)
    Dense kernel (in, out)            -> weight (out, in)
    sparse kernel (27|8, Ci, Co)      -> weight, unchanged
    bias                              -> bias
    BatchNorm scale / mean / var      -> weight / running_mean / running_var
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _kernel(a: np.ndarray, module: str) -> np.ndarray:
    if a.ndim == 4:
        if module == "tconv":
            return np.transpose(a[::-1, ::-1], (2, 3, 0, 1))
        return np.transpose(a, (3, 2, 0, 1))
    if a.ndim == 3:
        return a
    if a.ndim == 2:
        return a.T
    raise ValueError(f"unexpected kernel rank {a.ndim} at {module}")


_PARAM_LEAF = {"bias": "bias", "scale": "weight", "kernel": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _state_dict(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for tree, names in ((params, _PARAM_LEAF), (stats, _STAT_LEAF)):
        for path, a in _leaves(tree):
            leaf, module = path[-1], path[:-1]
            if leaf not in names:
                raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
            if leaf == "kernel":
                a = _kernel(a, module[-1])
            key = ".".join(module + (names[leaf],))
            if key in sd:
                raise KeyError(f"two flax leaves map to {key}")
            sd[key] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return sd


def from_flax(params2d: Mapping, stats2d: Mapping, params3d: Mapping,
              stats3d: Mapping):
    """-> (state_dict for models.net2d.Net2DSeg,
           state_dict for models.sparse_unet.Net3DSeg)."""
    return _state_dict(params2d, stats2d), _state_dict(params3d, stats3d)
