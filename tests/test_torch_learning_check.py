"""The port's flagship learning check (`tools/check_flagship_learning.py`)
on the CPU at a small size, and its fault injection against the JAX
package's.

- `--record` then a check passes, and `--mutate` fails it, at m=8, 3
  planes, full_scale 256, fp32, batch 2 of 24x32 images, 5 steps (the
  module's constants shrunk):
  the tool's own gates and file, exercised end to end.
- Mutation parity: with both packages' `_DEBUG_DROP_COMPACT_TIERS_BWD` set,
  the 3-tier submanifold conv's input and weight gradients equal
  `jax.vjp`'s within 1e-5 of their largest, at a level with mid and heavy
  tiers that hold hits (points packed densely enough that many voxels
  have more neighbours than tier 1 takes), and differ from the unmutated
  ones; both flags are restored.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_spconv import _assert_grads_match

from mm2d3d_tpu.ops import hierarchy as HJ
from mm2d3d_tpu.ops import spconv as SJ
from mm2d3d_tpu.ops.voxelize import voxelize as voxelize_jax
from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops import spconv as S
from mm2d3d_tpu_torch.ops.voxelize import voxelize
from mm2d3d_tpu_torch.tools import check_flagship_learning as check

STEPS = 5


@pytest.fixture
def small(monkeypatch):
    """The tool's trajectory at a small size, on one CPU thread (the CPU's
    multithreaded backward of the point-to-pixel gather is not bit-stable,
    and `--record` holds a repeat run bit for bit)."""
    monkeypatch.setattr(check, "BATCH", 2)
    monkeypatch.setattr(check, "SCAN", dict(height=24, width=32, n_points=256,
                                            num_classes=6, full_scale=256))
    monkeypatch.setattr(check, "TASK", dict(compute_dtype=torch.float32,
                                            full_scale=256, num_planes=3, m=8))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_record_check_and_mutate(small, tmp_path, capsys):
    path = str(tmp_path / "band.json")
    args = ["--device", "cpu", "--steps", str(STEPS), "--checks", path]
    assert check.main(args + ["--record"]) == 0
    with open(path) as f:
        band = json.load(f)
    assert len(band["losses"]) == STEPS and band["first_loss"] == band["losses"][0]
    assert band["repeat_bit_identical"] and band["repeat_max_step_dev"] == 0
    assert band["env"]["card"] == "none: cpu" and band["env"]["torch"] == torch.__version__
    # the gate sits at most at half what the fault moves
    assert 0 < band["tol_step"] <= min(check.TOL_STEP, band["mutate_max_step_dev"] / 2)
    assert not S._DEBUG_DROP_COMPACT_TIERS_BWD
    capsys.readouterr()

    assert check.main(args) == 0
    assert "flagship learning check: OK" in capsys.readouterr().out
    assert check.main(args + ["--mutate"]) == 1
    out = capsys.readouterr().out
    assert "MUTATED" in out and "OUT OF BAND" in out and "CHECK FAILED" in out
    assert not S._DEBUG_DROP_COMPACT_TIERS_BWD


def test_check_without_a_recording_fails(tmp_path, capsys):
    assert check.main(["--device", "cpu", "--checks", str(tmp_path / "none.json")]) == 1
    assert "--record first" in capsys.readouterr().out


def test_entry_raises_without_a_gpu_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check.main(["--checks", str(tmp_path / "none.json")])


@pytest.fixture
def both_flags():
    """Both packages' fault flags set in the block, restored after it."""
    before = (S._DEBUG_DROP_COMPACT_TIERS_BWD, SJ._DEBUG_DROP_COMPACT_TIERS_BWD)
    S._DEBUG_DROP_COMPACT_TIERS_BWD = SJ._DEBUG_DROP_COMPACT_TIERS_BWD = True
    yield
    S._DEBUG_DROP_COMPACT_TIERS_BWD, SJ._DEBUG_DROP_COMPACT_TIERS_BWD = before


SLOT_CAPS = ((3, 6, 26, 2048, 2048),)


@pytest.fixture(scope="module")
def level():
    """Level 0 of one dense point set, in both packages: 3 tiers, each
    holding hits, none dropped."""
    import jax

    r = np.random.RandomState(12)
    n, fs, cap = 1500, 16, 2048
    coords = r.randint(0, 12, size=(n, 3)).astype(np.int32)
    batch = np.zeros(n, np.int32)
    valid = np.ones(n, bool)

    @jax.jit
    def build_jax(c, b, m):
        g = voxelize_jax(c, b, m, fs, capacity=cap)
        return HJ.build_hierarchy(g, 1, capacities=(cap,), slot_caps=SLOT_CAPS,
                                  num_batches=1)

    lj = build_jax(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(valid)).levels[0]
    gt = voxelize(torch.from_numpy(coords), torch.from_numpy(batch),
                  torch.from_numpy(valid), fs, capacity=cap)
    lt = H.build_hierarchy(gt, 1, (cap,), SLOT_CAPS, num_batches=1).levels[0]
    k = 27
    assert int(lt.slot_overflow) == int(lj.slot_overflow) == 0
    assert int((lt.slot_tapm < k).sum()) > 100 and int((lt.slot_tap2 < k).sum()) > 100
    return lt, lj


def _case(level):
    lt, lj = level
    r = np.random.RandomState(30)
    cin, cout = 12, 20
    feats = r.randn(lt.capacity, cin).astype(np.float32)
    w = (r.randn(27, cin, cout) * 0.1).astype(np.float32)
    cot = r.randn(lt.capacity, cout).astype(np.float32)
    return (lambda x, k: S.subm_conv3(x, lt, k, torch.float32),
            lambda x, k: SJ.subm_conv3(x, lj, k, jnp.float32), feats, w, cot)


def _grads(fn_t, x, w, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = fn_t(xt, wt)
    out.backward(torch.from_numpy(cot))
    return out.detach(), xt.grad, wt.grad


def test_mutation_matches_jax(level, both_flags):
    fn_t, fn_j, x, w, cot = _case(level)
    _assert_grads_match(fn_t, fn_j, x, w, cot)


def test_mutation_drops_the_compact_tiers_from_the_backward_only(level):
    fn_t, _, x, w, cot = _case(level)
    out, dx, dw = _grads(fn_t, x, w, cot)
    before = S._DEBUG_DROP_COMPACT_TIERS_BWD
    S._DEBUG_DROP_COMPACT_TIERS_BWD = True
    try:
        out_m, dx_m, dw_m = _grads(fn_t, x, w, cot)
    finally:
        S._DEBUG_DROP_COMPACT_TIERS_BWD = before
    assert torch.equal(out, out_m)
    assert not torch.allclose(dx, dx_m) and not torch.allclose(dw, dw_m)
