"""The trace reading on hand-made events: attribution of forward and
backward kernels, busy time, idle gaps."""

import pytest

from core.trace import WINDOW, DeviceOp, HostOp, summarize

MAIN, BWD = 1, 2


def _host(name, s, e, tid=MAIN, corr=0, seq=-1, fwd=0, ann=False):
    return HostOp(name, s, e, tid, corr, seq, fwd, ann)


def test_forward_and_backward_kernels_go_to_their_layer():
    host = [
        _host(WINDOW, 0, 1000, corr=1, ann=True),
        _host("bench/net2d", 10, 100, corr=2, ann=True),
        _host("aten::conv2d", 20, 30, corr=3, seq=7),
        _host("bench/net3d", 100, 200, corr=4, ann=True),
        _host("bench/spconv", 110, 150, corr=5, ann=True),
        _host("_SubmSlots3", 120, 140, corr=6, seq=8),
        _host("autograd::engine::evaluate_function: ConvolutionBackward0", 300, 400,
              tid=BWD, corr=7, seq=7, fwd=MAIN),
        _host("aten::convolution_backward", 310, 390, tid=BWD, corr=8),
        _host("autograd::engine::evaluate_function: _SubmSlots3Backward", 400, 500,
              tid=BWD, corr=9, seq=8, fwd=MAIN),
        _host("Optimizer.step#AdamW.step", 600, 700, corr=10, ann=True),
        _host("aten::_foreach_add_", 610, 620, corr=11),
    ]
    dev = [
        DeviceOp("conv_fwd", 25, 45, 3),  # 20 ns, net2d
        DeviceOp("k1", 125, 135, 6),  # 10 ns, net3d + spconv
        DeviceOp("conv_bwd", 320, 360, 8),  # 40 ns, net2d (backward)
        DeviceOp("k2", 410, 440, 9),  # 30 ns, net3d + spconv (backward)
        DeviceOp("adam", 615, 635, 11),  # 20 ns, optimizer
        DeviceOp("Memcpy HtoD", 800, 810, 0),  # 10 ns, unlinked copy
    ]
    s = summarize(host, dev)
    assert s["kernels"] == 5
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(130e-9)
    assert s["device_s"]["net2d"] == pytest.approx(60e-9)
    assert s["device_s"]["net3d"] == pytest.approx(40e-9)
    assert s["device_s"]["spconv"] == pytest.approx(40e-9)
    assert s["device_s"]["optimizer"] == pytest.approx(20e-9)
    assert s["attributed_share"] == pytest.approx(120 / 130)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0][1] == pytest.approx(190e-9)  # 810 -> the window's end
    assert len(s["breakdown"]["device_ops"]) == 6


def test_nothing_to_read_gives_nothing():
    assert summarize([], []) == {}
