"""The port's topology profile (`mm2d3d_tpu_torch/tools/profile_topology.py`)
vs the JAX functions the JAX tool (`tools/profile_topology.py`) composes,
under `jax.jit` on the CPU: each of the four cumulative phases builds the
same integer tables, exactly, at batch 2 of 2,048 points over 7 levels.
K3's plain version with h1 = 0 gives the JAX `propagate_nbr` table; the
`full` phase equals `build_topology`; `main` refuses the CPU.
"""

import jax
import numpy as np
import pytest
import torch
from _torch_port import assert_equal, jax_batch

import chip_smoke
from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.ops import hierarchy as HJ
from mm2d3d_tpu.ops.voxelize import voxelize as voxelize_jax
from mm2d3d_tpu.train import batch as BJ
from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops.kernels.propagate import propagate_slots_ref
from mm2d3d_tpu_torch.tools import profile_topology as P
from mm2d3d_tpu_torch.train.batch import build_topology

B, N, L = 2, 2048, 7


def _same(port, ref, where):
    """Every table of a port dataclass equal to the JAX one's."""
    for name, t in vars(port).items():
        if not hasattr(ref, name):  # the port's own tables (nbr5: a 5^3 stem's only)
            assert t is None, f"{where}.{name}"
            continue
        r = getattr(ref, name)
        assert (t is None) == (r is None), f"{where}.{name}"
        if isinstance(t, torch.Tensor):
            assert_equal(t, r, f"{where}.{name}")
        elif t is not None:
            assert t == r, f"{where}.{name}"


def _jax_phases(ref):
    """The JAX tool's four functions (without its optimization barriers,
    which change no value), jitted, over the flattened JAX batch."""
    coords, _, _, mask, bidx = BJ.flatten_points(ref)
    caps = BJ.default_capacities(coords.shape[0], L, batch_size=B)
    slot_caps = BJ.default_slot_caps(L, caps)

    def vox(c, bi, m):
        return voxelize_jax(c, bi, m, 4096, capacity=caps[0],
                            presorted=ref.coords_sorted)

    def grids_only(c, bi, m):
        grids, transitions = [vox(c, bi, m)], []
        for l in range(1, L):
            gc, tr = HJ._coarsen_grid(grids[-1], capacity=caps[l])
            grids.append(gc)
            transitions.append(tr)
        return grids, transitions

    def with_nbr(c, bi, m):
        grids, transitions = grids_only(c, bi, m)
        nbrs = [None] * L
        nbrs[-1] = HJ.build_nbr(grids[-1], num_batches=B)
        for l in range(L - 2, -1, -1):
            nbrs[l] = HJ.propagate_nbr(grids[l], transitions[l], nbrs[l + 1])
        return grids, transitions, nbrs

    def full(c, bi, m):
        g = vox(c, bi, m)
        return g, HJ.build_hierarchy(g, L, capacities=caps, slot_caps=slot_caps,
                                     num_batches=B)

    fns = (vox, grids_only, with_nbr, full)
    return {name: (lambda f=f: jax.jit(f)(coords, bidx, mask))
            for name, f in zip(P.PHASES, fns)}


@pytest.fixture(scope="module")
def phases():
    ours = P.flagship_batch("cpu", batch_size=B, n_points=N)
    ref = jax_batch(make_batch_jax(np.random.RandomState(0), batch_size=B,
                                   height=225, width=400, n_points=N,
                                   num_classes=6, full_scale=4096))
    assert_equal(ours.coords, ref.coords, "coords")
    assert ours.coords_sorted == ref.coords_sorted
    with torch.no_grad():
        got = {name: fn() for name, fn in P.phases(ours).items()}
    want = {name: fn() for name, fn in _jax_phases(ref).items()}
    return ours, got, want


def test_voxelize_phase_matches_jax(phases):
    _, got, want = phases
    _same(got[P.PHASES[0]], want[P.PHASES[0]], "grid")


def test_coarsen_phase_matches_jax(phases):
    _, got, want = phases
    (grids, transitions), (ref_g, ref_t) = got[P.PHASES[1]], want[P.PHASES[1]]
    assert len(grids) == L and len(transitions) == L - 1
    for l, (g, r) in enumerate(zip(grids, ref_g)):
        _same(g, r, f"grid {l}")
    for l, (t, r) in enumerate(zip(transitions, ref_t)):
        _same(t, r, f"transition {l}")


def test_nbr_phase_matches_jax_propagate_nbr(phases):
    _, got, want = phases
    grids, _, nbrs = got[P.PHASES[2]]
    ref_grids, _, ref_nbrs = want[P.PHASES[2]]
    for l in range(L):
        _same(grids[l], ref_grids[l], f"grid {l}")
        assert_equal(nbrs[l], ref_nbrs[l], f"nbr {l}")


def test_k3_plain_with_h1_0_is_jax_propagate_nbr(phases):
    """K3's plain version alone, h1 = 0, on the coarsen phase's grids and
    the JAX tables of the level above: the JAX `propagate_nbr` table, no
    slots, every hit counted."""
    _, got, want = phases
    grids, transitions = got[P.PHASES[1]]
    ref_grids, ref_trans, ref_nbrs = want[P.PHASES[2]]
    for l in range(L - 1):
        nbr_c = torch.tensor(np.asarray(ref_nbrs[l + 1]))
        crows = H._propagate_candidates(grids[l], transitions[l], nbr_c)
        par = (grids[l].coords & 1).T.contiguous().to(torch.int32)
        valid = grids[l].valid.to(torch.int32)[None]
        nbr, src1, tap1, cnt = propagate_slots_ref(crows, par, valid, 0)
        assert_equal(nbr, jax.jit(HJ.propagate_nbr)(ref_grids[l], ref_trans[l],
                                                    ref_nbrs[l + 1]), f"nbr {l}")
        assert src1.shape[0] == tap1.shape[0] == 0
        v = nbr.shape[1]
        hits = (torch.cat([nbr[:13], nbr[14:]]) < v).sum(0)
        assert torch.equal(cnt, hits.to(cnt.dtype)), f"cnt {l}"


def test_full_phase_matches_jax_and_build_topology(phases):
    ours, got, want = phases
    (grid, hier), (ref_g, ref_h) = got[P.PHASES[3]], want[P.PHASES[3]]
    _same(grid, ref_g, "grid")
    for l, (lev, r) in enumerate(zip(hier.levels, ref_h.levels)):
        _same(lev, r, f"level {l}")
    for l, (t, r) in enumerate(zip(hier.transitions, ref_h.transitions)):
        _same(t, r, f"transition {l}")
    with torch.no_grad():
        n = chip_smoke.same_tables((grid, hier), build_topology(ours, 4096, L),
                                   "full phase vs build_topology")
    assert n > 3 * L


def test_phase_launches_are_counted(phases):
    """`launches` reads the counters around one call: the plain versions a
    CPU batch takes launch nothing."""
    ours, _, _ = phases
    fn = P.phases(ours)[P.PHASES[2]]
    with torch.no_grad():
        assert set(P.launches(fn, torch.device("cpu")).values()) == {0}


def test_main_refuses_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main([])
    assert capsys.readouterr().out == ""


def test_tool_sizes_are_the_jax_tools():
    assert P.ITERS == 10 and P.BATCH == 8 and P.NUM_LEVELS == 7
    assert P.SCAN == dict(height=225, width=400, n_points=8192, num_classes=6,
                          full_scale=4096)
    assert P.PHASES[0] == "voxelize only"
    assert P.PHASES[1] == "+ coarsen chain (6 levels)"
    assert P.PHASES[3] == "full (+ slot tables)"
