"""The one traffic generator: a mix file's parameters and a configuration's
scan geometry -> a pool of seeded batches.

A mix (`benchmark/workloads/<traffic>.json`) is data: its `kind` ("train":
closed loop of source/target pairs; "eval": closed loop of batches), its
`batch_size`, the size of the pool the loop cycles, and optional `data`
overrides of the configuration's scan geometry.  Every stream of random
numbers is derived from `--seed` through `numpy.random.SeedSequence`, which
takes seeds of any size, so one seed always gives the same pool, weights and
dropout, and different seeds give pools of the same sizes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .synthetic import make_batch

# stream tags of `derive`
BATCHES, WEIGHTS, DROPOUT, SAMPLE = 1, 2, 3, 4


def derive(seed: int, tag: int, index: int = 0) -> int:
    """A 63-bit seed for one named stream of the run's `seed`."""
    if seed < 0:
        raise ValueError(f"--seed must be >= 0, got {seed}")
    words = np.random.SeedSequence([seed, tag, index]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def scan_geometry(config: Dict, mix: Dict) -> Dict:
    """The configuration's `data` with the mix's overrides."""
    return {**config["data"], **mix.get("data", {})}


def make_pool(config: Dict, mix: Dict, seed: int) -> List:
    """[batch, ...] for an eval mix, [(source, target), ...] for a train mix;
    each batch a dict of numpy arrays (`synthetic.make_batch`)."""
    geo = scan_geometry(config, mix)

    def batch(i: int):
        rng = np.random.RandomState(derive(seed, BATCHES, i) & 0xFFFFFFFF)
        return make_batch(rng, batch_size=mix["batch_size"], height=geo["height"],
                          width=geo["width"], n_points=geo["n_points"],
                          num_classes=config["num_classes"],
                          full_scale=geo["full_scale"],
                          valid_fraction=geo["valid_fraction"],
                          variant=geo["variant"])

    if mix["kind"] == "train":
        return [(batch(2 * i), batch(2 * i + 1)) for i in range(mix["pool_pairs"])]
    if mix["kind"] == "eval":
        return [batch(i) for i in range(mix["pool_batches"])]
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")
