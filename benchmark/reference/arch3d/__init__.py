"""The 3D networks the benchmark knows, one module each, found by the name
the program loads the network by: `models.net3d.name` of the configuration
(`net3d` where it names none).

A registered name is the module's file name (`net3d` -> `net3d.py`); a
dotted plugin path has each `.` written `__` (`pkg.models.unet` ->
`pkg__models__unet.py`).  Every module is plain PyTorch in float32,
imports nothing of the program, and gives:

- `template(config) -> {name: shape}`: every weight and running statistic
  of the 3D branch, under the names of the program's `state_dict`;
- `forward(W, feats, vox, config, train, q) -> {"seg_logit",
  "seg_logit_point"}`: the branch from the (P, C) point features to both
  heads' (P, nc) logits over the reference's voxelisation
  (`voxels.Voxels`), BatchNorms with the batch's statistics in training,
  `q` the operand precision of every product (`quant`);
- `convs(vox, config) -> [(pairs, rows in, rows out, Cin, Cout, taps)]`:
  every sparse convolution of one forward (`core.work.SpConv`), counted
  from the same voxelisation;
- `dense_flops(vox, points, config) -> int`: the FLOPs of its other
  products (gate, heads, 1x1 shortcuts) for `points` valid points;
- `SPCONV_MODULES`: the dotted names of the program's module classes whose
  calls are sparse convolutions (the `spconv` layer of a trace);
- optionally `fan_in(name, shape) -> int or None`: the fan-in of a leaf
  whose layout is not (out, in, ...) (`core.weights.init_std`).

Adding a 3D network to the benchmark is adding its module here, its
configuration file, its limits file and the entries that name them.
"""

from __future__ import annotations

import importlib
import pkgutil
import re
from types import ModuleType
from typing import Dict, List

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*(\.[A-Za-z_][A-Za-z0-9_]*)*$")


def known() -> List[str]:
    """The names of every module here."""
    return sorted(m.name.replace("__", ".") for m in pkgutil.iter_modules(__path__))


def lookup(config: Dict) -> ModuleType:
    """The module of the configuration's 3D network; a ValueError that lists
    the known names where there is none."""
    name = config["models"]["net3d"].get("name", "net3d")
    if isinstance(name, str) and _NAME.match(name):
        path = f"{__name__}.{name.replace('.', '__')}"
        try:
            return importlib.import_module(path)
        except ModuleNotFoundError as e:
            if e.name != path:
                raise
    raise ValueError(f"the benchmark has no reference for the 3D network {name!r} "
                     f"(models.net3d.name); known: {', '.join(known())}")
