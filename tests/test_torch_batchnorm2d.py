"""The 2D branch's train-form BatchNorm (`ops/kernels/batchnorm2d.py`) on the
CPU, where `BatchNorm2d` in train mode takes the plain versions: the
forward and the running statistics bit for bit as the eager decomposed form
(flax's E[x^2] - E[x]^2 clipped at 0, then the caller's ReLU or residual add
and ReLU) computes them, and the analytic backward against autograd of that
form; the kernels' launch plans and layout checks, which the card's route
takes from (M, C) and the strides.  No JAX: the parity with flax is
`tests/test_torch_train_parts.py`'s.
"""

import pytest
import torch

from mm2d3d_tpu_torch.models.net2d import Net2DSeg
from mm2d3d_tpu_torch.models.resnet2d import BatchNorm2d
from mm2d3d_tpu_torch.ops.kernels import batchnorm2d as B
from mm2d3d_tpu_torch.tools.kernel_cases import BN2D_FROZEN, BN2D_PER_FORWARD

SHAPE = (4, 17, 19)  # N, H, W: M = 1292 rows, a multiple of no tile
CONST_CH = 3  # the near-constant channel of the "clamp" layout


def _eager(bn, x, relu, identity, out_dtype):
    """The train form as it was written before the kernels, autograd-able."""
    x = x.float()
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(bn.momentum).add_((1 - bn.momentum) * mean)
        bn.running_var.mul_(bn.momentum).add_((1 - bn.momentum) * var)
    c = (1, -1, 1, 1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x - mean.view(c)) * mul.view(c) + bn.bias.view(c)
    if identity is not None:
        y = y + identity
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def _inputs(c, dtype, layout, residual, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n, h, w = SHAPE
    wide = 2 * c if layout == "stem_slice" else c
    x = (torch.randn((n, wide, h, w), generator=gen)
         * (0.5 + torch.rand((1, wide, 1, 1), generator=gen))
         + torch.randn((1, wide, 1, 1), generator=gen))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    if layout == "stem_slice":  # the second stem's half, read in place
        x = x[:, c:]
    ident = (torch.randn((n, c, h, w), generator=gen)
             .contiguous(memory_format=torch.channels_last) if residual else None)
    params = (1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen),
              0.1 * torch.randn(c, generator=gen), 1 + torch.rand(c, generator=gen))
    if layout == "clamp":
        _near_constant(x, params)
    return x, ident, params


def _near_constant(x, params):
    """Make channel CONST_CH one value with one element a bf16 step above
    it, the first value of a fixed list whose raw variance E[x^2] - E[x]^2
    comes out negative in fp32 (the sums' rounding beats the true
    variance; which value does depends on the reduction's order)."""
    for v in (1 + 0.05 * i for i in range(400)):
        x[:, CONST_CH] = v
        x[0, CONST_CH, 0, 0] = v * (1 + 2.0 ** -7)
        stats = B.stats_ref(x, params[0], params[2].clone(), params[3].clone(), 1e-5, 0.9)
        if stats[3, CONST_CH] == 0:
            return
    raise AssertionError("no near-constant channel with a negative raw variance")


def _run(form, x0, ident0, params, relu, out_dtype, dy):
    bn = BatchNorm2d(x0.shape[1]).train()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), params):
            t.copy_(v)
    x = x0.detach().requires_grad_(True)
    ident = None if ident0 is None else ident0.clone().requires_grad_(True)
    y = (_eager(bn, x, relu, ident, out_dtype) if form == "eager"
         else bn(x, relu, ident, out_dtype))
    y.backward(dy.to(y.dtype))
    return {"y": y.detach(), "running_mean": bn.running_mean, "running_var": bn.running_var,
            "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "didentity": None if ident is None else ident.grad}


@pytest.mark.parametrize("layout", ["nhwc", "stem_slice", "clamp"])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["none", "relu", "residual"])
def test_plain_route_matches_eager_autograd(epilogue, dtype, c, layout):
    """Forward, running statistics and the four gradients of the plain
    route against autograd of the eager form, over each epilogue, fp32 and
    bf16 inputs (a ReLU's bf16 input writes bf16, as `cb1` does), C = 64 to
    512, M = 1292 rows, a stem's half of a 128-channel-wide view read in
    place, and a near-constant channel whose raw variance comes out
    negative.  The forward is the same ops: bit for bit.  The gradients:
    within 1e-5 * max|autograd| in fp32 (the analytic form sums in another
    order), 2^-7 * max in bf16 (dx rounded once from values that differ
    before it); d(identity) is the masked gradient itself: bit for bit."""
    relu, residual = epilogue != "none", epilogue == "residual"
    out_dtype = dtype if epilogue == "relu" else torch.float32
    x, ident, params = _inputs(c, dtype, layout, residual)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    ref = _run("eager", x, ident, params, relu, out_dtype, dy)
    out = _run("module", x, ident, params, relu, out_dtype, dy)
    for k in ("y", "running_mean", "running_var", "didentity"):
        assert (out[k] is None) == (ref[k] is None), k
        if ref[k] is not None:
            assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]), k
    for k in ("dx", "dweight", "dbias"):
        r = ref[k].float()
        tol = (2.0 ** -7 if out[k].dtype == torch.bfloat16 else 1e-5) * float(r.abs().max())
        assert out[k].dtype == ref[k].dtype, k
        assert float((out[k].float() - r).abs().max()) <= tol, k


def test_eval_form_is_the_running_statistics_and_the_same_ops():
    """Eval mode keeps `F.batch_norm` on the running statistics, then the
    epilogue as eager ops, and returns fp32 whatever `out_dtype` says."""
    x, ident, params = _inputs(64, torch.bfloat16, "nhwc", True)
    bn = BatchNorm2d(64).eval()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), params):
            t.copy_(v)
    y = bn(x, True, ident, torch.bfloat16)
    ref = torch.relu(torch.nn.functional.batch_norm(
        x.float(), params[2], params[3], params[0], params[1], training=False) + ident)
    assert y.dtype == torch.float32 and torch.equal(y, ref)
    assert torch.equal(bn.running_mean, params[2])


def test_net2dseg_has_the_counted_train_form_batch_norms():
    """79 train-form BatchNorm2d a forward (36 per encoder with its stem, 7
    in the decoder), 43 with `frozen_batch_norm`: what
    `kernel_cases.expected_train_launches` counts."""
    for frozen, n in ((False, BN2D_PER_FORWARD), (True, BN2D_PER_FORWARD - BN2D_FROZEN)):
        net = Net2DSeg(6, frozen_batch_norm=frozen)
        assert sum(isinstance(m, BatchNorm2d) for m in net.modules()) == n


@pytest.mark.parametrize("m,c", [(16 * 240 * 400, 64), (16 * 304 * 480, 64),
                                 (16 * 120 * 200, 64), (16 * 15 * 25, 512),
                                 (16 * 60 * 100, 128), (1292, 192), (231, 64), (5, 8),
                                 (1, 2048)])
def test_sum_and_apply_plans_cover_every_row_once(m, c):
    """The sums' grid covers rows [0, M) once per 64-channel tile, with
    whole 32-row strides per block and no empty block, at most ~3 blocks
    per SM; the applies' blocks hold whole rows and fit an SM's threads."""
    p = B.sum_plan(m, c)
    assert p.tiles == -(-c // B.TILE)
    assert p.rows % B.SUM_ROW_LANES == 0
    assert (p.blocks - 1) * p.rows < m <= p.blocks * p.rows
    assert p.blocks * p.tiles <= B.SUM_BLOCKS + p.tiles
    a = B.apply_plan(m, c)
    threads = c // B.VEC * a.rows_per_iter
    assert c // B.VEC <= threads <= B.APPLY_THREADS
    assert 1 <= a.blocks <= B.SMS * B.APPLY_BLOCKS_PER_SM


def test_row_stride_reads_nhwc_and_channel_slices_only():
    x = torch.zeros((2, 128, 5, 6)).contiguous(memory_format=torch.channels_last)
    assert B.row_stride(x) == 128
    assert B.row_stride(x[:, 64:]) == 128  # a stem's half, in place
    assert B.row_stride(x[:, :, :1, :1]) == 5 * 6 * 128  # one pixel per image
    assert B.row_stride(torch.zeros((2, 64, 5, 6))) is None  # NCHW
    assert B.row_stride(x.transpose(2, 3)) is None


def test_wrappers_refuse_inputs_that_want_a_gradient():
    x = torch.zeros((2, 8, 3, 3), requires_grad=True)
    w, rm, rv = torch.ones(8), torch.zeros(8), torch.ones(8)
    with pytest.raises(RuntimeError, match="no backward"):
        B.bn_stats(x, w, rm, rv, 1e-5, 0.9)


@pytest.mark.parametrize("epilogue", ["none", "relu", "residual"])
def test_card_check_runs_on_the_cpu_route(epilogue):
    """`kernel_cases.bn_check`, which the card's tests and `chip_smoke.py`
    run, on the CPU route: BatchNormTrain and its four passes agree bit for
    bit, the masks agree, and every output is the plain version's own."""
    from mm2d3d_tpu_torch.tools.kernel_cases import bn_check, bn_inputs

    y_dtype = torch.bfloat16 if epilogue == "relu" else torch.float32
    case = ((2, 128, 5, 7), (64, 128), epilogue, torch.bfloat16, y_dtype)
    errs = bn_check(bn_inputs(case, torch.device("cpu"), seed=4), epilogue, y_dtype)
    assert set(errs) >= {"y", "dx", "dweight", "dbias", "running_mean", "running_var"}
    assert max(errs.values()) == 0.0
