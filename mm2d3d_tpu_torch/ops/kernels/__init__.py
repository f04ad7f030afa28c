"""Hand-written Hopper kernels: build, load and launch bookkeeping.

Each kernel is CUDA C++ in ``mm2d3d_tpu_torch/csrc/<name>.cu`` with a plain C
interface.  It is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library under ``mm2d3d_tpu_torch/_build/`` at first use and bound with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and a stale library is never loaded.

Every kernel keeps a launch counter: its wrapper adds one where, and only
where, it launches the kernel.  `reset_counts` / `counts` let a caller show
that a run of the main path really went through the kernels.

Dispatch rule, shared by every wrapper: a CPU tensor takes the kernel's
plain PyTorch version (same module), a CUDA tensor launches the kernel or
raises.  There is no fallback from a failed build or launch.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-lineinfo", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is not None:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            if os.path.exists(cand):
                path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class Kernel:
    """One CUDA source file -> one shared library with a C interface.

    `bind` declares the ctypes signatures of the library's functions.
    `launches` counts kernel launches made through the Python wrapper.
    """

    def __init__(self, name: str, sources: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None], replaces: str):
        self.name = name
        self.sources = tuple(sources)  # file names under csrc/, first = .cu
        self.replaces = replaces  # file:line of the TPU kernel it ports
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.launches = 0

    @property
    def source(self) -> str:
        return os.path.join("mm2d3d_tpu_torch", "csrc", self.sources[0])

    def _digest(self) -> str:
        h = hashlib.sha256()
        for s in self.sources:
            with open(os.path.join(CSRC_DIR, s), "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    @property
    def build_log(self) -> str:
        """nvcc's output of the last build (with -Xptxas -v: registers,
        shared memory and spills per kernel)."""
        return os.path.join(BUILD_DIR, f"{self.name}.log")

    def library_path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.name}-{self._digest()}.so")

    def build(self) -> str:
        """Compile the library if no up-to-date build exists; returns its path."""
        out = self.library_path()
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, self.sources[0])]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(self.build_log, "w") as f:
            f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.sources[0]} (rc {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out)
        return out

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                self._bind(lib)
                self._lib = lib
            return self._lib

    def check(self, rc: int) -> None:
        """Raise if a launch returned a CUDA error (cudaGetLastError)."""
        if rc != 0:
            msg = self.lib().kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({rc})")


_REGISTRY: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    _REGISTRY[kernel.name] = kernel
    return kernel


def all_kernels() -> Dict[str, Kernel]:
    # importing the kernel modules registers them
    from . import (  # noqa: F401
        bandmm, bandmm_dw, batchnorm2d, exp_bandmm, exp_gather, head2d, maxpool,
        propagate, slot_gather, tapsum,
    )

    return dict(_REGISTRY)


def reset_counts() -> None:
    for k in all_kernels().values():
        k.launches = 0


def counts() -> Dict[str, int]:
    return {name: k.launches for name, k in all_kernels().items()}


def build_all() -> None:
    """Build every kernel's library, one nvcc per source, all at once."""
    kernels = list(all_kernels().values())
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        for fut in [pool.submit(k.lib) for k in kernels]:
            fut.result()


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True when the inputs live on a CUDA device (the kernel route), False
    when they are on the CPU (the plain route); raises on a mix."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def require_contiguous(**tensors: Optional[torch.Tensor]) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def no_grad_inputs(*tensors: Optional[torch.Tensor]) -> None:
    """A wrapper has no backward of its own (the autograd Functions of
    `ops.spconv`, `ops.kernels.maxpool` and `ops.kernels.head2d` call the
    wrappers with grad mode off): refuse inputs that want a gradient."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            "this kernel wrapper has no backward; call it under torch.no_grad() "
            "or through the autograd Functions that use it"
        )
