"""K6's launch plan (`ops.kernels.tapsum.tapsum_plan`) over the flagship's
28 dense contractions: the 14 submanifold convs of the forward (input conv,
7 encoder and 6 decoder blocks, m = 16, 7 planes) and their 14 input
gradients (Ci and Co swapped), at the voxel capacities of
`default_capacities(65536, 7)` (V = 65,536 ... 2,048), bf16.

The plan must cover each tap exactly once, give the card's 132 SMs a block
each wherever the voxels and output channels allow, leave level 0 unsplit,
and size the scratch the kernel writes.  A CPU emulation of the split-K sums
(each tap group's fp32 partial, then the partials added in order) must equal
the plain version within 1e-5 * max|plain| (fp32 sums in another order).
No JAX here: the plan is the port's own.
"""

import numpy as np
import pytest
import torch

from mm2d3d_tpu_torch.ops.kernels import tapsum as T
from mm2d3d_tpu_torch.train.batch import default_capacities

M, LEVELS = 16, 7


def _forward_shapes():
    """(name, level, Ci, Co) of the 14 dense convs of the forward."""
    out = [("input_conv", 0, 3, M)]
    out += [(f"enc_l{l}", l, M * (l + 1), M * (l + 1)) for l in range(LEVELS)]
    out += [(f"dec_l{l}_concat", l, 2 * M * (l + 1), M * (l + 1))
            for l in range(LEVELS - 1)]
    return out


CAPS = default_capacities(65536, LEVELS)
SHAPES = {}
for _name, _l, _ci, _co in _forward_shapes():
    SHAPES[f"{_name}_fwd"] = (27, CAPS[_l], _ci, _co)
    SHAPES[f"{_name}_adjoint"] = (27, CAPS[_l], _co, _ci)


def _blocks(plan, v, co):
    return -(-v // plan.bm) * -(-co // plan.bn) * plan.splits


def test_the_flagship_has_28_dense_shapes():
    assert len(SHAPES) == 28
    assert sorted({v for _, v, _, _ in SHAPES.values()}) == [
        2048, 4096, 8192, 16384, 24576, 40960, 65536]


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plan_covers_each_tap_once_and_sizes_the_scratch(case):
    k, v, ci, co = SHAPES[case]
    plan = T.tapsum_plan(k, v, ci, co)
    groups = T.tap_groups(k, plan.splits)
    taps = [t for t0, t1 in groups for t in range(t0, t1)]
    assert taps == list(range(k))
    assert all(t1 > t0 for t0, t1 in groups)
    need = plan.splits * v * co if plan.splits > 1 else 0
    assert int(np.prod(T.scratch_shape(plan, v, co))) == need
    if T.tensor_cores(torch.bfloat16, ci):
        assert plan.bm in (64, 128) and plan.bn % 16 == 0 and 16 <= plan.bn <= 128
        assert plan.bn >= co or -(-co // plan.bn) > 1
    else:
        assert plan.splits == 1


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plan_fills_the_card(case):
    k, v, ci, co = SHAPES[case]
    plan = T.tapsum_plan(k, v, ci, co)
    unsplit = _blocks(plan._replace(splits=1), v, co)
    if v == CAPS[0]:
        assert plan.splits == 1
    if unsplit * k >= T.SMS:  # the voxels and channels allow it
        assert _blocks(plan, v, co) >= T.SMS
    if unsplit >= T.SMS:
        assert plan.splits == 1  # no scratch where the tiles fill the card
    if plan.bm == 128:
        assert unsplit >= T.SMS  # the long tile only where it fills the card


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_split_k_emulation_matches_plain_version(case):
    """The kernel's arithmetic order at the plan's split, at 256 voxels:
    each group's partial over its taps, then the partials summed s = 0, 1,
    ... into the output."""
    k, v, ci, co = SHAPES[case]
    plan = T.tapsum_plan(k, v, ci, co)
    r = np.random.RandomState(v + ci + co)
    g = torch.from_numpy(r.randn(k, 256, ci).astype(np.float32))
    w = torch.from_numpy((0.1 * r.randn(k, ci, co)).astype(np.float32))
    part = torch.empty(T.scratch_shape(plan, 256, co) if plan.splits > 1
                       else (1, 256, co))
    for s, (t0, t1) in enumerate(T.tap_groups(k, plan.splits)):
        part[s] = torch.einsum("kvi,kio->vo", g[t0:t1], w[t0:t1])
    out = part[0].clone()
    for s in range(1, plan.splits):
        out += part[s]
    ref = T.tapsum_ref(g, w)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_plans_at_known_shapes():
    """fp32, and bf16 rows that are no whole 16-byte chunks (the input
    conv's Ci = 3), take the CUDA-core kernel unsplit; bf16 otherwise takes
    tensor cores, split where the tiles are few."""
    assert T.tapsum_plan(27, 2048, 112, 112, torch.float32) == (1, 32, 32)
    assert T.tapsum_plan(27, 65536, 3, 16) == (1, 32, 16)
    assert T.tapsum_plan(27, 65536, 16, 16) == (1, 128, 16)
    assert T.tapsum_plan(27, 65536, 16, 3) == (1, 128, 16)
    assert T.tapsum_plan(27, 24576, 48, 48) == (1, 128, 48)
    assert T.tapsum_plan(27, 16384, 64, 64) == (1, 64, 64)
    assert T.tapsum_plan(27, 2048, 112, 112) == (5, 64, 112)
    assert T.tapsum_plan(27, 4096, 192, 96) == (3, 64, 96)
    assert T.tapsum_plan(27, 500, 96, 192) == (9, 64, 96)
    assert T.tapsum_plan(27, 777, 16, 40) == (11, 64, 48)
    assert T.tapsum_plan(27, 0, 16, 16) == (1, 64, 16)


def test_wrapper_passes_the_plan_and_allocates_its_scratch(monkeypatch):
    """The CUDA route's bookkeeping, with the library replaced by a
    recorder: the plan's ints reach the kernel and the scratch is
    (splits, V, Co) fp32."""
    k, v, ci, co = 27, 2048, 112, 112
    plan = T.tapsum_plan(k, v, ci, co)
    assert plan.splits > 1
    calls, shapes = [], []
    empty = torch.empty

    def spy_empty(shape, *a, **kw):
        shapes.append(tuple(shape))
        return empty(shape, *a, **kw)

    class Lib:
        def tapsum(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(T, "on_cuda", lambda *t: True)
    monkeypatch.setattr(T, "stream", lambda: 0)
    monkeypatch.setattr(T.KERNEL, "lib", lambda: Lib())
    monkeypatch.setattr(torch, "empty", spy_empty)
    g = empty((k, v, ci), dtype=torch.bfloat16)
    w = empty((k, ci, co), dtype=torch.bfloat16)
    before = T.KERNEL.launches
    out = T.tapsum(g, w)
    assert T.KERNEL.launches == before + 1
    assert out.shape == (v, co) and out.dtype == torch.float32
    assert shapes == [(v, co), (plan.splits, v, co)]
    (args,) = calls
    assert args[4:12] == (k, v, ci, co, 1, *plan)
    assert args[3] is not None
