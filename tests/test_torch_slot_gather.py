"""The sparse convolutions' slot-row gather (`ops/kernels/slot_gather.py`).

Its plain version against a row-by-row gather (ids at the pad, past it and
negative give zeros; any id table shape, empty ones too), its chunk width
by shape, its refusals; then every sparse-convolution form of
`ops/spconv.py`, forward, input and weight gradients, bit-equal to the
same form over the padded map (`torch.cat([x, 0])[ids.long()]`, the gather
it replaces), with its launches as `tools/kernel_cases.py` counts them
per convolution and per network.  CPU only, no JAX; the kernel itself is
held to the plain version in `tests/test_torch_kernels_cuda.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.models.minkunet import MinkUNet34CSeg
from mm2d3d_tpu_torch.models.sparse_unet import Net3DSeg
from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops import spconv as S
from mm2d3d_tpu_torch.ops.kernels.slot_gather import slot_gather, vector_bytes
from mm2d3d_tpu_torch.ops.voxelize import voxelize
from mm2d3d_tpu_torch.tools import kernel_cases as KC
from mm2d3d_tpu_torch.train.batch import build_topology, flatten_points
from mm2d3d_tpu_torch.train.step import _init_


def _rowwise(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[id] row by row, zeros for an id outside the rows."""
    flat = ids.reshape(-1).tolist()
    out = torch.zeros((len(flat), x.shape[1]), dtype=x.dtype)
    for n, i in enumerate(flat):
        if 0 <= i < x.shape[0]:
            out[n] = x[i]
    return out.reshape(*ids.shape, x.shape[1])


def _ids(rng, v, shape):
    """Ids in [0, V), a third of them the pad V, some past it or negative."""
    ids = rng.randint(0, v, size=shape)
    r = rng.rand(*shape)
    ids[r < 0.33] = v
    ids[(r >= 0.33) & (r < 0.36)] = v + 1 + rng.randint(0, 1000)
    ids[(r >= 0.36) & (r < 0.38)] = -1
    return torch.from_numpy(ids.astype(np.int32))


@pytest.mark.parametrize("shape", [(3, 40), (57,), (20, 8), (0,), (3, 0)],
                         ids=["slots", "rows", "children", "empty", "empty_tiers"])
@pytest.mark.parametrize("c", [3, 16, 32, 96, 384])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_version_is_the_padded_gather(dtype, c, shape):
    rng = np.random.RandomState(c)
    v = 37
    x = torch.from_numpy(rng.randn(v, c).astype(np.float32)).to(dtype)
    ids = _ids(rng, v, shape)
    out = slot_gather(x, ids)
    assert out.dtype == dtype and out.shape == (*shape, c)
    assert torch.equal(out, _rowwise(x, ids))
    # the gather it replaces, where every id lies in [0, V]
    inside = torch.clamp(ids, 0, v)
    padded = torch.cat([x, x.new_zeros((1, c))])
    assert torch.equal(slot_gather(x, inside), padded[inside.long()])


def test_a_channel_slice_is_read_through_its_stride():
    rng = np.random.RandomState(1)
    wide = torch.from_numpy(rng.randn(50, 96).astype(np.float32)).to(torch.bfloat16)
    part = wide[:, 32:64]
    assert part.stride() == (96, 1)
    ids = _ids(rng, 50, (4, 30))
    assert torch.equal(slot_gather(part, ids), slot_gather(part.contiguous(), ids))


@pytest.mark.parametrize("row,stride,addrs,want", [
    (6, 6, (0, 256), 2),  # the 5^3 stem's input, Ci 3 bf16
    (12, 12, (0, 256), 4),  # Ci 3 fp32
    (32, 32, (0, 256), 16),  # Ci 16 bf16
    (768, 768, (0, 256), 16),  # Ci 384 bf16
    (64, 192, (64, 256), 16),  # a 32-channel slice of 96 bf16 at channel 32
    (64, 192, (6, 256), 2),  # ... at channel 3
    (1536, 1536, (8, 256), 8),  # an fp32 row at an 8-byte offset
    (1, 1, (0, 256), 1),
])
def test_chunk_is_the_widest_that_divides_row_stride_and_addresses(row, stride,
                                                                   addrs, want):
    assert vector_bytes(row, stride, *addrs) == want


def test_refuses_what_it_cannot_take():
    x = torch.zeros(10, 8)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        slot_gather(x, ids.long())
    with pytest.raises(ValueError):
        slot_gather(x, torch.zeros(4, 2, dtype=torch.int32).t())
    with pytest.raises(ValueError):
        slot_gather(torch.zeros(2, 5, 8), ids)
    with pytest.raises(ValueError):
        slot_gather(torch.zeros(8, 10).t(), ids)
    with pytest.raises(RuntimeError):
        slot_gather(x.requires_grad_(True), ids)


# ---- the sparse-convolution forms, before and after ----------------------

FS, N = 64, 1500
SLOT_CAPS = ((3, 6, 26, 512, 128), (8, 26, 256), None)  # 3-tier, 2-tier, dense
CAPS = (2048, 1024, 512)


def _points(seed=0):
    r = np.random.RandomState(seed)
    coords = torch.from_numpy(r.randint(0, FS, size=(2 * N, 3)).astype(np.int32))
    batch = torch.from_numpy(np.repeat(np.arange(2, dtype=np.int32), N))
    valid = torch.from_numpy(r.rand(2 * N) < 0.95)
    return coords, batch, valid


@pytest.fixture(scope="module")
def hiers():
    coords, batch, valid = _points()
    grid = voxelize(coords, batch, valid, FS, capacity=CAPS[0])
    plain = H.build_hierarchy(grid, 3, CAPS, SLOT_CAPS, num_batches=2)
    child = H.build_hierarchy(grid, 3, CAPS, SLOT_CAPS, num_batches=2,
                              child_slot_caps="default")
    assert [KC.tiers(l) for l in plain.levels[:2]] == [3, 2]
    assert plain.levels[2].slot_src is None and child.transitions[0].cslot_src is not None
    return plain, child


def _padded_gather(x, ids):
    """The gather the kernel replaces: the map with a zero row appended, at
    ids clamped to it (the dumped parents were clamped, the rest lay in
    [0, V] already)."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])[
        torch.clamp(ids, max=x.shape[0]).long()]


def _forms(plain, child):
    """(name, fn(x, w) -> out, rows in, weight shape, expected gathers)."""
    l0, l1, l2 = plain.levels
    one = dataclasses.replace(
        l0, slot_idx=None, slot_src2=None, slot_tap2=None, slot_idxm=None,
        slot_invm=None, slot_srcm=None, slot_tapm=None)
    tp, tc = plain.transitions[0], child.transitions[0]
    v0, v1 = l0.capacity, l1.capacity
    subm = lambda lev: lambda x, w: S.subm_conv3(x, lev, w, torch.float32)  # noqa: E731
    return {
        "subm_3tier": (subm(l0), v0, 27, KC.subm_gathers(l0)),
        "subm_2tier": (subm(l1), v1, 27, KC.subm_gathers(l1)),
        "subm_1tier": (subm(one), v0, 27, KC.subm_gathers(one)),
        "subm_dense": (subm(l2), l2.capacity, 27, KC.subm_gathers(l2)),
        "down": (lambda x, w: S.down_conv2(x, tp, w, torch.float32), v0, 8,
                 KC.down_gathers(tp)),
        "down_child_slots": (lambda x, w: S.down_conv2(x, tc, w, torch.float32), v0, 8,
                             KC.down_gathers(tc)),
        "up": (lambda x, w: S.up_conv2(x, tp, w, torch.float32), v1, 8,
               KC.up_gathers(tp)),
        "up_child_slots": (lambda x, w: S.up_conv2(x, tc, w, torch.float32), v1, 8,
                           KC.up_gathers(tc)),
    }


def _run_counted(monkeypatch, gather, fn):
    calls = []

    def counted(x, ids):
        calls.append(ids.shape)
        return gather(x, ids)

    monkeypatch.setattr(S, "slot_gather", counted)
    out = fn()
    return out, len(calls)


@pytest.mark.parametrize("form", ["subm_3tier", "subm_2tier", "subm_1tier",
                                  "subm_dense", "down", "down_child_slots", "up",
                                  "up_child_slots"])
def test_each_form_is_bit_equal_to_the_padded_gather(monkeypatch, hiers, form):
    fn, v, k, (n_fwd, n_bwd) = _forms(*hiers)[form]
    r = np.random.RandomState(5)
    ci, co = 12, 20
    x0 = torch.from_numpy(r.randn(v, ci).astype(np.float32))
    w0 = torch.from_numpy((r.randn(k, ci, co) * 0.1).astype(np.float32))

    def run(gather):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        out, fwd = _run_counted(monkeypatch, gather, lambda: fn(x, w))
        cot = torch.from_numpy(np.random.RandomState(6).randn(*out.shape)
                               .astype(np.float32))
        _, both = _run_counted(monkeypatch, gather, lambda: out.backward(cot))
        return (out.detach(), x.grad, w.grad), (fwd, both)

    new, counts = run(slot_gather)
    old, _ = run(_padded_gather)
    for a, b, name in zip(new, old, ("out", "d_x", "d_w")):
        assert torch.equal(a, b), name
    assert counts == (n_fwd, n_bwd)
    assert n_fwd > 0 and n_bwd > 0


def test_the_5x5x5_stem_is_bit_equal_to_the_padded_gather(monkeypatch):
    b = make_batch(np.random.RandomState(3), batch_size=2, height=32, width=48,
                   n_points=512, full_scale=128, variant="kitti")
    _, hier = build_topology(b, 128, 5, capacities=(640, 384, 256, 128, 128),
                             slot_profile="dense", stem_kernel=5)
    lev = hier.levels[0]
    r = np.random.RandomState(4)
    x0 = torch.from_numpy(r.randn(lev.capacity, 3).astype(np.float32))
    w0 = torch.from_numpy((r.randn(125, 3, 8) * 0.1).astype(np.float32))
    outs = []
    for gather in (slot_gather, _padded_gather):
        monkeypatch.setattr(S, "slot_gather", gather)
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        out = S.subm_conv5(x, lev, w, torch.float32)
        out.backward(torch.ones_like(out))
        outs.append((out.detach(), x.grad, w.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---- launches per network ------------------------------------------------

def _network_counts(monkeypatch, net, grid, hier, feats):
    calls = {"n": 0}

    def counted(x, ids):
        calls["n"] += 1
        return slot_gather(x, ids)

    monkeypatch.setattr(S, "slot_gather", counted)
    net.train(True)
    preds, _, _ = net(feats, grid, hier)
    fwd = calls["n"]
    preds["seg_logit"].sum().backward()
    return fwd, calls["n"] - fwd


@pytest.mark.parametrize("net", ["scn", "scn_residual", "minkunet34c"])
def test_network_launches_are_kernel_cases_counts(monkeypatch, net):
    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        b = make_batch(np.random.RandomState(2), batch_size=2, height=32, width=48,
                       n_points=512, full_scale=128, variant="kitti")
        if net == "minkunet34c":
            model = MinkUNet34CSeg(6, compute_dtype=torch.float32)
            grid, hier = build_topology(b, 128, 5, capacities=(640, 384, 256, 128, 128),
                                        slot_profile="dense", stem_kernel=5)
            want = KC.minkunet_gathers(hier)
        else:
            residual = net == "scn_residual"
            model = Net3DSeg(6, m=4, num_planes=4, compute_dtype=torch.float32,
                             residual_blocks=residual)
            grid, hier = build_topology(b, 128, 4, capacities=(640, 384, 256, 128))
            want = KC.scn_gathers(hier, residual)
        with torch.no_grad():
            _init_(model, torch.Generator().manual_seed(1))
        _, feats, _, _, _ = flatten_points(b)
        assert _network_counts(monkeypatch, model, grid, hier, feats) == want
    finally:
        torch.set_num_threads(threads)
