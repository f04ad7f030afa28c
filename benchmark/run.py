"""The benchmark of `mm2d3d_tpu_torch` on NVIDIA GPUs (see `core/main.py`).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Every cache a run writes lies in
`.bench_cache/` of the checkout, at a fixed path, and the kernel libraries
in the program's own `mm2d3d_tpu_torch/_build/`, so only the first run of a
checkout builds.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

if __name__ == "__main__":
    from core.main import main

    sys.exit(main(t_start=T_START))
