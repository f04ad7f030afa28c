"""Weight bridge between the JAX package's flax trees and this package's
state_dicts, both ways.

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

`to_flax` is the inverse: state_dicts (or any name -> tensor maps with the
same keys, such as the parameters' gradients) back to flax-shaped trees of
fp32 numpy arrays, so the two packages compare leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple, Union

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


def _unkernel(a: np.ndarray, module: str) -> np.ndarray:
    """Inverse of `_kernel`."""
    if a.ndim == 4:
        if module == "tconv":
            return np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]
        return np.transpose(a, (2, 3, 1, 0))
    if a.ndim == 2:
        return a.T
    return a


_FLAX_STAT = {v: k for k, v in _STAT_LEAF.items()}


def _trees(sd: Mapping[str, Union[torch.Tensor, np.ndarray]]):
    params: Dict = {}
    stats: Dict = {}
    for key, t in sd.items():
        *module, leaf = key.split(".")
        a = np.asarray(t.detach().cpu().float() if isinstance(t, torch.Tensor) else t,
                       dtype=np.float32)
        if leaf in _FLAX_STAT:
            tree, name = stats, _FLAX_STAT[leaf]
        elif leaf == "bias":
            tree, name = params, "bias"
        elif leaf == "weight":
            # 1-D weights are batch-norm scales, the rest are kernels
            tree, name = params, ("scale" if a.ndim == 1 else "kernel")
            if a.ndim > 1:
                a = _unkernel(a, module[-1])
        else:
            raise KeyError(f"unmapped state_dict entry {key}")
        node = tree
        for m in module:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return params, stats


def to_flax(sd2: Mapping, sd3: Mapping):
    """Inverse of `from_flax`: (state_dict of Net2DSeg, state_dict of
    Net3DSeg) -> (params2d, stats2d, params3d, stats3d) as nested dicts of
    fp32 numpy arrays.  A map of parameters only (e.g. their gradients)
    gives empty stats trees."""
    return (*_trees(sd2), *_trees(sd3))
