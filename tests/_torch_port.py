"""Shared helpers of the tests that hold mm2d3d_tpu_torch against mm2d3d_tpu.

Both frameworks run on the CPU in one process; data crosses between them as
numpy arrays made from a seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def jax_batch(batch):
    """A JAX PointBatch of numpy arrays -> device arrays."""
    return jax.tree_util.tree_map(jnp.asarray, batch)


def to_numpy_tree(tree):
    """Flax params / batch stats -> nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def randomize_stats(stats, seed: int):
    """Random running statistics (mean ~0.1 N(0,1), var in [0.5, 1.5)), so
    eval-mode comparisons exercise them."""
    r = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("mean", "bn_mean"):
            return (r.randn(*x.shape) * 0.1).astype(np.float32)
        return (r.rand(*x.shape) + 0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, to_numpy_tree(stats))


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def assert_equal(port, ref, name=""):
    np.testing.assert_array_equal(t2n(port) if isinstance(port, torch.Tensor)
                                  else np.asarray(port), np.asarray(ref),
                                  err_msg=name)


def near_tie(logits: np.ndarray, gap: float = 1e-3) -> np.ndarray:
    """Points whose top-2 logit (or probability) gap is below `gap`: their
    argmax may legitimately differ between two summation orders."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < gap


@pytest.fixture(scope="module")
def two_threads():
    """Two intra-op threads for a module's tests: the test workers share the
    machine's cores, and torch's default of one thread per core in each of
    them oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
