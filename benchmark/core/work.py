"""The work of a step, counted from shapes and from the reference's own
voxelisation, and the least time the card could take for it.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W: 989 TFLOP/s
with bf16 operands, 3.35 TB/s of HBM (a frozen copy of `chip_smoke.py`'s
`bound` arithmetic).  Model FLOPs count the products of the published
layers: a dense convolution 2 Ci Co kh kw per output pixel (a transposed
2x2 stride-2 one 2 Ci Co per output pixel), a sparse convolution 2 Ci Co
per (output, input) pair its rulebook holds, a linear layer 2 Ci Co per
row; normalisations, activations, pooling and losses are not counted.  A
training step is counted as three forwards.  The 2D network's count is
here; a 3D network's list of sparse convolutions and its other products
come from its own module of `reference.arch3d`, found by the
configuration's `models.net3d.name`.

A sparse convolution's least time is summed over its passes (the forward;
in training also the input and the weight gradient), each the larger of its
bytes over the HBM rate and its FLOPs over the bf16 peak.  Bytes count
every input once at the compute type's width (2 bytes), the weights once,
and every output once at 4 bytes (the fp32 the products accumulate in), so
the count is the same whatever implements the convolution.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from reference import arch3d

PEAK_FLOPS = 989e12  # bf16 dense
HBM_BYTES_PER_S = 3.35e12
IN_BYTES, OUT_BYTES = 2, 4

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def bound_s(n_bytes: float, flops: float) -> float:
    """The least seconds: bytes over the HBM rate or FLOPs over the peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS)


def conv_flops(cin: int, cout: int, k: int, ho: int, wo: int) -> int:
    return 2 * cin * cout * k * k * ho * wo


def net2d_flops(height: int, width: int, num_classes: int) -> int:
    """Forward FLOPs of one image through the 2D network (padded to 16)."""
    hp, wp = height + (-height) % 16, width + (-width) % 16
    f = conv_flops(3, 64, 7, hp, wp) + conv_flops(1, 64, 7, hp, wp)
    enc = 0
    cin = 64
    for i, (blocks, width_c) in enumerate(STAGES):
        ho, wo = hp >> (i + 1), wp >> (i + 1)
        for b in range(blocks):
            stride = 2 if (b == 0 and i > 0) else 1
            enc += conv_flops(cin, width_c, 3, ho, wo) + conv_flops(width_c, width_c, 3, ho, wo)
            if stride != 1 or cin != width_c:
                enc += conv_flops(cin, width_c, 1, ho, wo)
            cin = width_c
    f += 2 * enc
    # decoder: (transposed 2x2 in, out, fusion in, output stride)
    for cin_t, cout, fuse_in, s in ((1024, 256, 768, 8), (256, 128, 384, 4),
                                    (128, 64, 192, 2)):
        ho, wo = hp // s, wp // s
        f += 2 * cin_t * cout * ho * wo + conv_flops(fuse_in, cout, 3, ho, wo)
    f += 2 * 64 * 64 * hp * wp  # up2
    f += conv_flops(192, 64, 3, hp, wp)  # dec_conv_stage1
    f += 2 * 2 * 64 * num_classes * height * width  # the two 1x1 heads
    return f


# one sparse convolution: (pairs, rows in, rows out, Cin, Cout, taps), as a
# 3D network's `convs` lists them
SpConv = Tuple[int, int, int, int, int, int]


def spconv_flops(convs: List[SpConv]) -> int:
    return sum(2 * pairs * ci * co for pairs, _, _, ci, co, _ in convs)


def spconv_least_s(convs: List[SpConv], train: bool) -> float:
    """The least seconds for every pass of these convolutions."""
    total = 0.0
    for pairs, v_in, v_out, ci, co, taps in convs:
        flops = 2 * pairs * ci * co
        w = taps * ci * co
        total += bound_s(v_in * ci * IN_BYTES + w * IN_BYTES + v_out * co * OUT_BYTES, flops)
        if train:
            # input gradient: reads the output gradient and the weights
            total += bound_s(v_out * co * IN_BYTES + w * IN_BYTES + v_in * ci * OUT_BYTES,
                             flops)
            # weight gradient: reads the input and the output gradient
            total += bound_s(v_in * ci * IN_BYTES + v_out * co * IN_BYTES + w * OUT_BYTES,
                             flops)
    return total


def batch_work(vox, points: int, config: Dict, geometry: Dict, batch_size: int,
               train: bool) -> Dict[str, float]:
    """{"flops": model FLOPs of one call (a train step counts both domains'
    batches here once; the caller multiplies), "spconv_least_s": the least
    seconds of its sparse convolutions} for one batch of `points` valid
    points, voxelised as `vox` (`reference.voxels.Voxels`)."""
    arch = arch3d.lookup(config)
    convs = arch.convs(vox, config)
    return {
        "flops": (batch_size * net2d_flops(geometry["height"], geometry["width"],
                                           config["num_classes"])
                  + spconv_flops(convs) + arch.dense_flops(vox, points, config)),
        "spconv_least_s": spconv_least_s(convs, train),
    }
