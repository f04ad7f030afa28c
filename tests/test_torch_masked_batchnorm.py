"""The 3D branch's train-form masked BatchNorm (`models/sparse_unet.py::
MaskedBatchNorm`, train mode: `ops/kernels/batchnorm2d.py::BatchNormTrain`
with the level's row mask) on the CPU, where it takes the plain versions:
the forward and the running statistics bit for bit as the eager form
computed them before the kernels (the two-pass mean and variance of the
valid rows, then the caller's ReLU or residual add and ReLU), and the
analytic backward against autograd of that form, with a gradient at the
invalid rows too; the launch predictions' BatchNorm counts; the masked
kernels' layout and mask checks.  No JAX: the parity with flax is
`tests/test_torch_train_parts.py`'s.
"""

import pytest
import torch

from mm2d3d_tpu_torch.models.minkunet import MinkUNet34C
from mm2d3d_tpu_torch.models.sparse_unet import MaskedBatchNorm, UNetSCN3D
from mm2d3d_tpu_torch.ops.kernels import batchnorm2d as B
from mm2d3d_tpu_torch.tools import kernel_cases as K

V, C = 1000, 24  # rows of no tile's multiple; three 8-channel groups


def _mask(kind: str) -> torch.Tensor:
    """The level's row mask: an invalid tail (capacity past the voxels), a
    scattered one (no prefix), every row valid, or none."""
    if kind == "tail":
        return torch.arange(V) < 700
    if kind == "scattered":
        return torch.rand(V, generator=torch.Generator().manual_seed(5)) < 0.6
    return torch.full((V,), kind == "all")


def _eager(bn, x, valid, relu, identity, out_dtype):
    """The train form as it was written before the kernels: the old
    `MaskedBatchNorm.forward` (two-pass statistics of the valid rows, the
    running update, the affine in the input's dtype), then the caller's
    epilogue; autograd-able."""
    f32 = x.float()
    m = valid[:, None].float()
    n = torch.clamp(m.sum(), min=1.0)
    mean = (f32 * m).sum(0) / n
    var = ((f32 - mean).square() * m).sum(0) / n
    with torch.no_grad():
        bn.running_mean.mul_(bn.momentum).add_((1 - bn.momentum) * mean)
        bn.running_var.mul_(bn.momentum).add_((1 - bn.momentum) * var)
    y = (x.float() - mean) * torch.rsqrt(var + bn.eps)
    y = (y * bn.weight + bn.bias).to(x.dtype)
    if identity is not None:
        y = y + identity
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


def _run(form, mask_kind, eps, epilogue, out_dtype):
    gen = torch.Generator().manual_seed(3)
    x0 = (torch.randn((V, C), generator=gen) * (0.5 + torch.rand(C, generator=gen))
          + torch.randn(C, generator=gen))
    valid = _mask(mask_kind)
    x0[~valid] = 0.0  # a conv's output at an invalid row
    ident0 = torch.randn((V, C), generator=gen) if epilogue == "residual" else None
    dy = torch.randn((V, C), generator=gen)  # a gradient at the invalid rows too
    bn = MaskedBatchNorm(C, eps=eps).train()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(C, generator=gen))
        bn.bias.copy_(0.1 * torch.randn(C, generator=gen))
        bn.running_mean.copy_(0.1 * torch.randn(C, generator=gen))
        bn.running_var.copy_(1 + torch.rand(C, generator=gen))
    x = x0.clone().requires_grad_(True)
    ident = None if ident0 is None else ident0.clone().requires_grad_(True)
    relu = epilogue != "none"
    y = (_eager(bn, x, valid, relu, ident, out_dtype) if form == "eager"
         else bn(x, valid, relu, ident, out_dtype))
    y.backward(dy.to(y.dtype))
    return {"y": y.detach(), "running_mean": bn.running_mean,
            "running_var": bn.running_var, "dx": x.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "didentity": None if ident is None else ident.grad,
            "dy": dy, "valid": valid}


FORMS = [("none", torch.float32), ("relu", torch.float32), ("relu", torch.bfloat16),
         ("residual", torch.float32)]


@pytest.mark.parametrize("mask_kind", ["tail", "scattered", "all", "none"])
@pytest.mark.parametrize("eps", [1e-4, 1e-5])
@pytest.mark.parametrize("epilogue,out_dtype", FORMS)
def test_plain_route_matches_the_eager_form(mask_kind, eps, epilogue, out_dtype):
    """The module's train form against the eager form it replaced, at the
    SCN U-Net's eps and MinkUNet34C's, over an invalid tail, a scattered
    mask, every row valid and none (n clamped to 1), each epilogue, and a
    bf16 output where a convolution is the only reader.  The forward is the
    same ops: y and the running statistics bit for bit, d(identity) too
    (the masked gradient itself).  The gradients within 1e-5 * max|autograd|
    (the analytic form sums in another order; a bf16 y's gradient reaches
    both forms the same)."""
    ref = _run("eager", mask_kind, eps, epilogue, out_dtype)
    out = _run("module", mask_kind, eps, epilogue, out_dtype)
    for k in ("y", "running_mean", "running_var", "didentity"):
        assert (out[k] is None) == (ref[k] is None), k
        if ref[k] is not None:
            assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]), k
    for k in ("dx", "dweight", "dbias"):
        assert out[k].dtype == ref[k].dtype, k
        tol = 1e-5 * float(ref[k].abs().max())
        assert float((out[k] - ref[k]).abs().max()) <= tol, k


@pytest.mark.parametrize("mask_kind", ["tail", "scattered"])
def test_weight_and_bias_gradients_take_every_row(mask_kind):
    """y depends on the weight and the bias at the invalid rows too, so
    their gradients sum over every row: sums over the valid rows alone
    would miss autograd's by far more than the tolerance above, and dx at
    an invalid row is weight * rstd * g alone."""
    ref = _run("eager", mask_kind, 1e-5, "none", torch.float32)
    out = _run("module", mask_kind, 1e-5, "none", torch.float32)
    valid, dy = ref["valid"], ref["dy"]
    valid_only = dy[valid].sum(0)
    assert float((valid_only - ref["dbias"]).abs().max()) > 1e-2
    assert torch.allclose(out["dbias"], dy.sum(0), rtol=1e-6, atol=1e-5)
    stats = B.masked_stats_ref(torch.zeros(V, C), valid, torch.ones(C), torch.zeros(C),
                               torch.ones(C), 1e-5, 0.9)
    assert float(stats[4, 0]) == float(valid.sum())
    assert float((out["dx"][~valid] - ref["dx"][~valid]).abs().max()) <= (
        1e-5 * float(ref["dx"].abs().max()))


def test_eval_form_is_the_running_statistics_and_the_same_ops():
    """Eval mode normalises by the running statistics as before, then the
    epilogue as eager ops, in the input's dtype whatever `out_dtype` says;
    the running statistics stay."""
    gen = torch.Generator().manual_seed(8)
    x, ident = torch.randn((V, C), generator=gen), torch.randn((V, C), generator=gen)
    bn = MaskedBatchNorm(C).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(C, generator=gen))
        bn.running_var.copy_(1 + torch.rand(C, generator=gen))
    y = bn(x, _mask("tail"), True, ident, torch.bfloat16)
    ref = (x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
    ref = torch.relu((ref * bn.weight + bn.bias) + ident)
    assert y.dtype == torch.float32 and torch.equal(y, ref)


@pytest.mark.parametrize("epilogue", ["none", "relu", "residual"])
def test_card_check_runs_masked_on_the_cpu_route(epilogue):
    """`kernel_cases.bn_check` of a masked call form, which the card's
    tests and `chip_smoke.py` run, on the CPU route: BatchNormTrain and its
    four passes agree bit for bit, and every output is the plain version's
    own."""
    y_dtype = torch.bfloat16 if epilogue == "relu" else torch.float32
    case = ((300, 32), 0.6, epilogue, y_dtype, 1e-4)
    inputs = K.masked_bn_inputs(case, torch.device("cpu"), seed=4)
    assert inputs[-1].dtype == torch.bool and 0 < int(inputs[-1].sum()) < 300
    errs = K.bn_check(inputs, epilogue, y_dtype, eps=1e-4)
    assert set(errs) >= {"y", "dx", "dweight", "dbias", "running_mean", "running_var"}
    assert max(errs.values()) == 0.0


def test_networks_have_the_counted_masked_batch_norms():
    """26 train-form masked BatchNorms a forward in the 7-plane VGG SCN
    U-Net (7 enc, 6 down, 6 up, 6 dec, `out_bn`), 39 with residual blocks,
    62 in MinkUNet34C: what `kernel_cases.expected_train_launches` and the
    MinkUNet34C card test count, four launches each."""
    assert K.scn_batch_norms(7) == 26 and K.scn_batch_norms(7, True) == 39
    assert K.minkunet_batch_norms() == 62
    with torch.device("meta"):
        nets = {26: UNetSCN3D(3, 16, 1, 7, torch.bfloat16),
                62: MinkUNet34C(3, torch.bfloat16)}
    for n, net in nets.items():
        assert sum(isinstance(m, MaskedBatchNorm) for m in net.modules()) == n


def test_row_stride_and_refusals_of_voxel_rows():
    """(V, C) rows: their stride, a channel slice's, and the refusals the
    card's route makes before any launch (checked by the wrapper's helpers,
    which need no card)."""
    x = torch.zeros((10, 48))
    assert B.row_stride(x) == 48 and B.row_stride(x[:, 16:32]) == 48
    assert B.row_stride(x.t()) is None
    assert B._check(x) == (10, 48)
    with pytest.raises(ValueError, match="multiple of 8"):
        B._check(torch.zeros((10, 12)))
    with pytest.raises(ValueError, match="row mask"):
        B._valid(torch.ones(9, dtype=torch.bool), 10)
    with pytest.raises(ValueError, match="row mask"):
        B._valid(torch.ones(10, dtype=torch.uint8), 10)
    assert B.unpack_mask(torch.tensor([[5, 128]], dtype=torch.uint8), (1, 16)).tolist() == [
        [True, False, True] + [False] * 12 + [True]]
