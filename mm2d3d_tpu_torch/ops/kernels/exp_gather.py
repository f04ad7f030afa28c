"""K7-K9: the row-movement probes of `tools/exp_dma_gather.py`.

Ports of the three TPU probe kernels of the JAX package's
`tools/exp_dma_gather.py`, which asked whether copies issued from inside a
kernel could beat the gather engine for slot-conv rows:

- K7 `group_gather` (`make_grp.kern`): row groups by id, G rows a group.
  CUDA kernel `csrc/exp_group_gather.cu`; plain version `group_gather_ref`.
- K8 `window_copy` (`make_win.kern`): contiguous windows of w rows, one
  bulk asynchronous copy each.  `csrc/exp_window_copy.cu`;
  `window_copy_ref`.
- K9 `window_gather` (`make_onehot.onehot_kernel`): rows by local id out
  of one window multicast to a thread-block cluster's shared memory
  (`window_gather_plan`).  `csrc/exp_window_gather.cu`;
  `window_gather_ref`.

No system path calls them: `tools/exp_dma_gather.py` (the port's) times
them against `torch.index_select`.  Each copies bytes, whatever the type.
An id or a window that falls outside the source gives rows of zeros, in
the kernels and in the plain versions alike.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import (
    Kernel, no_grad_inputs, on_cuda, ptr, register, require_contiguous, stream,
)
from .tapsum import SMS

MAX_BULK_BYTES = 227 * 1024 - 1024  # csrc/bulk.cuh: kMaxBulkBytes
GATHER_CLUSTERS = (2, 4)  # K9: the CTAs of a cluster that share one window
GATHER_PAIR_BYTES = 96 * 1024  # K9: clusters of 2 up to this window, of 4 above
GATHER_MIN_ROWS = 256  # K9: no CTA with fewer rows, where the rows allow


def _bind_group(lib):
    lib.group_gather.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.group_gather.restype = ctypes.c_int


def _bind_window_copy(lib):
    lib.window_copy.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p,
    ]
    lib.window_copy.restype = ctypes.c_int


def _bind_window_gather(lib):
    lib.window_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p,
    ]
    lib.window_gather.restype = ctypes.c_int


GROUP_KERNEL = register(Kernel(
    "exp_group_gather", ("exp_group_gather.cu", "common.cuh", "mma.cuh"),
    _bind_group, replaces="tools/exp_dma_gather.py:86",
))
WINDOW_COPY_KERNEL = register(Kernel(
    "exp_window_copy", ("exp_window_copy.cu", "common.cuh", "mma.cuh", "bulk.cuh"),
    _bind_window_copy, replaces="tools/exp_dma_gather.py:127",
))
WINDOW_GATHER_KERNEL = register(Kernel(
    "exp_window_gather", ("exp_window_gather.cu", "common.cuh", "mma.cuh", "bulk.cuh"),
    _bind_window_gather, replaces="tools/exp_dma_gather.py:151",
))


def _rows_or_zeros(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """src[ids] along dim 0, with zeros where an id is outside the rows."""
    ok = (ids >= 0) & (ids < src.shape[0])
    out = src.new_zeros((ids.numel(), *src.shape[1:]))
    out[ok] = src[ids[ok].long()]
    return out


def _row_bytes_ok(t: torch.Tensor, rows: int, what: str) -> int:
    """Bytes of `rows` rows of t; raises unless whole 16-byte chunks at a
    16-byte aligned address (the kernels move 16-byte chunks)."""
    n = rows * t.shape[1] * t.element_size()
    if n % 16 != 0:
        raise ValueError(f"{what}: {rows} row(s) of {t.shape[1]} x "
                         f"{t.element_size()} B are not whole 16-byte chunks")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: the data must be 16-byte aligned")
    return n


def _check_2d(x: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    no_grad_inputs(x)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected x (rows, C), got {tuple(x.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: ids must be int32, got {idx.dtype}")


# ---- K7: row groups by id ------------------------------------------------

def group_order(idx: torch.Tensor, tile: int) -> torch.Tensor:
    """The output order of the TPU probe's groups: (tile j, slot h, t) ->
    idx[h, j * tile + t], flattened."""
    h, n = idx.shape
    return idx.reshape(h, n // tile, tile).transpose(0, 1).reshape(-1)


def group_gather_ref(x: torch.Tensor, idx: torch.Tensor, group: int = 8,
                     tile: int = 512) -> torch.Tensor:
    """Plain version of `group_gather`."""
    c = x.shape[1]
    groups = x.reshape(x.shape[0] // group, group * c)
    return _rows_or_zeros(groups, group_order(idx, tile)).reshape(-1, c)


def _check_group(x, idx, group, tile):
    _check_2d(x, idx, "group_gather")
    if idx.dim() != 2 or tile <= 0 or idx.shape[1] % tile != 0:
        raise ValueError(f"group_gather: idx (H, n) with n a multiple of tile "
                         f"{tile}, got {tuple(idx.shape)}")
    if group <= 0 or x.shape[0] % group != 0:
        raise ValueError(f"group_gather: {x.shape[0]} rows are not whole groups "
                         f"of {group}")


def group_gather(x: torch.Tensor, idx: torch.Tensor, group: int = 8,
                 tile: int = 512) -> torch.Tensor:
    """x (N, C), idx (H, n) int32 group ids, n a multiple of `tile` ->
    out (n / tile * H * tile * group, C):

        out[((j * H + h) * tile + t) * group + r] = x[idx[h, j * tile + t] * group + r]

    for r < group, with zeros for an id outside [0, N / group).  On a CUDA
    tensor a group must be whole 16-byte chunks and x 16-byte aligned."""
    _check_group(x, idx, group, tile)
    if not on_cuda(x, idx):
        return group_gather_ref(x, idx, group, tile)

    require_contiguous(x=x, idx=idx)
    group_bytes = _row_bytes_ok(x, group, "group_gather")
    h, n = idx.shape
    out = torch.empty((n * h * group, x.shape[1]), dtype=x.dtype, device=x.device)
    lib = GROUP_KERNEL.lib()
    GROUP_KERNEL.launches += 1
    GROUP_KERNEL.check(lib.group_gather(
        ptr(x), ptr(idx), ptr(out), x.shape[0] // group, h, n, tile, group_bytes,
        stream(),
    ))
    return out


# ---- K8: contiguous windows ----------------------------------------------

def window_copy_ref(x: torch.Tensor, offs: torch.Tensor, w: int) -> torch.Tensor:
    """Plain version of `window_copy`."""
    n, v = offs.shape[0], x.shape[0]
    rows = offs.long()[:, None] + torch.arange(w, device=x.device)
    inside = (offs >= 0) & (offs.long() + w <= v)
    ids = torch.where(inside[:, None], rows, -1).reshape(-1)
    return _rows_or_zeros(x, ids).reshape(n, w, x.shape[1])


def window_chunk_rows(row_bytes: int, w: int, max_chunk_bytes: int = MAX_BULK_BYTES) -> int:
    """Rows per bulk copy: the whole window where it fits `max_chunk_bytes`
    (at most a block's shared memory), else as many rows as do."""
    rows = min(w, max(1, min(max_chunk_bytes, MAX_BULK_BYTES) // row_bytes))
    if rows * row_bytes > MAX_BULK_BYTES:
        raise ValueError(f"window_copy: one row of {row_bytes} B exceeds the "
                         f"{MAX_BULK_BYTES} B a copy may take")
    return rows


def window_copy(x: torch.Tensor, offs: torch.Tensor, w: int,
                max_chunk_bytes: int = MAX_BULK_BYTES) -> torch.Tensor:
    """x (V, C), offs (n,) int32 -> out (n, w, C), out[j] = x[offs[j] :
    offs[j] + w]; zeros for a window not inside x.  On a CUDA tensor each
    window is one bulk copy of at most `max_chunk_bytes` (a larger one is
    split), a row must be whole 16-byte chunks and x 16-byte aligned."""
    _check_2d(x, offs, "window_copy")
    if offs.dim() != 1 or w <= 0:
        raise ValueError(f"window_copy: offs (n,) and w > 0, got "
                         f"{tuple(offs.shape)}, w={w}")
    if not on_cuda(x, offs):
        return window_copy_ref(x, offs, w)

    require_contiguous(x=x, offs=offs)
    row_bytes = _row_bytes_ok(x, 1, "window_copy")
    chunk = window_chunk_rows(row_bytes, w, max_chunk_bytes)
    n = offs.shape[0]
    out = torch.empty((n, w, x.shape[1]), dtype=x.dtype, device=x.device)
    lib = WINDOW_COPY_KERNEL.lib()
    WINDOW_COPY_KERNEL.launches += 1
    WINDOW_COPY_KERNEL.check(lib.window_copy(
        ptr(x), ptr(offs), ptr(out), n, x.shape[0], w, row_bytes, chunk, stream(),
    ))
    return out


# ---- K9: rows of a resident window ---------------------------------------

def window_gather_ref(xw: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `window_gather`."""
    return _rows_or_zeros(xw, idx.reshape(-1)).reshape(*idx.shape, xw.shape[1])


def window_gather_plan(rows: int, w: int, row_bytes: int,
                       cluster: Optional[int] = None) -> dict:
    """K9's launch.  A `cluster` of CTAs shares the window by multicast:
    CTA r loads rows [r * part_rows, (r + 1) * part_rows) and lands them in
    every CTA of the cluster, so that each holds the whole window (`smem`
    bytes).  `ctas` (a whole number of clusters, at most one per SM, none
    with fewer than GATHER_MIN_ROWS rows where there are enough rows) each
    take `rows_per_cta` contiguous rows; the kernel cuts `ctas` to the
    clusters the card holds at once.  By default 2 CTAs a cluster up to
    GATHER_PAIR_BYTES of window, 4 above.  Raises where the window does not
    fit a CTA's shared memory."""
    window = w * row_bytes
    if w <= 0:
        raise ValueError("window_gather: an empty window")
    if window > MAX_BULK_BYTES:
        raise ValueError(f"window_gather: a window of {window} B does not fit a CTA's "
                         f"{MAX_BULK_BYTES} B of shared memory")
    if cluster is None:
        cluster = 2 if window <= GATHER_PAIR_BYTES else 4
    if cluster not in GATHER_CLUSTERS:
        raise ValueError(f"window_gather: cluster in {GATHER_CLUSTERS}, got {cluster}")
    ctas = -(-max(1, min(SMS, -(-rows // GATHER_MIN_ROWS))) // cluster) * cluster
    return {"cluster": cluster, "ctas": ctas, "part_rows": -(-w // cluster),
            "rows_per_cta": max(1, -(-rows // ctas)), "smem": window}


def window_gather(xw: torch.Tensor, idx: torch.Tensor,
                  cluster: Optional[int] = None) -> torch.Tensor:
    """xw (w, C), idx (...) int32 local row ids -> out (..., C), out[q] =
    xw[idx[q]]; zeros for an id outside [0, w).  On a CUDA tensor a
    cluster of 2 or 4 CTAs (`cluster`, by default `window_gather_plan`'s)
    shares the window by multicast: it must fit a CTA's shared memory (226
    KB), a row must be whole 16-byte chunks and xw 16-byte aligned."""
    _check_2d(xw, idx, "window_gather")
    if not on_cuda(xw, idx):
        return window_gather_ref(xw, idx)

    require_contiguous(xw=xw, idx=idx)
    row_bytes = _row_bytes_ok(xw, 1, "window_gather")
    rows = idx.numel()
    if rows >= 2**31:
        raise ValueError(f"window_gather: {rows} ids, more than an int32 counts")
    plan = window_gather_plan(rows, xw.shape[0], row_bytes, cluster)
    out = torch.empty((*idx.shape, xw.shape[1]), dtype=xw.dtype, device=xw.device)
    lib = WINDOW_GATHER_KERNEL.lib()
    WINDOW_GATHER_KERNEL.launches += 1
    WINDOW_GATHER_KERNEL.check(lib.window_gather(
        ptr(xw), ptr(idx), ptr(out), xw.shape[0], row_bytes, rows, plan["cluster"],
        plan["ctas"], plan["part_rows"], stream(),
    ))
    return out
