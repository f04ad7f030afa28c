"""One run of one cell: set-up, the measured window, the traced segment,
and the comparison with the reference.

Train cells: set-up builds the task, loads the seeded weights and puts the
pool of wire pairs on the card, then drives the task through its first
`warm_steps` steps with the window's own call (`MM2D3DTask.train_step`, on
pool pairs 0, 1, 2: rows that all differ).  Those steps warm every shape
and are the ones the reference follows.  The window goes on with the same
task, generator and pool, back to back, without a synchronise between
steps, as `Trainer.fit` runs them.  Eval cells: set-up warms the shapes with
two throwaway calls; each window call is one `MM2D3DTask.eval_step` into
the accumulated confusion matrices, timed by CUDA events and ended by a
synchronise.  The reference runs once the window has closed, the peak has
been read and the program's state is freed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from reference import arch3d, nets
from reference.quant import PRECISIONS
from reference.task import Reference
from reference.voxels import voxelize
from traffic import generator as G

from . import check, program, work
from .trace import WINDOW, events, layer_ranges, summarize, topology_spans
from .weights import make_weights


def templates(config: Dict) -> Dict:
    """{"2d", "3d"}: {name: shape} of each branch; the 3D network's from its
    module of `reference.arch3d`."""
    return {"2d": nets.template2d(config["num_classes"]),
            "3d": arch3d.lookup(config).template(config)}


def seeded_weights(config: Dict, seed: int, device) -> Dict:
    """Both branches' weights of the run with `seed`."""
    return make_weights(templates(config), G.derive(seed, G.WEIGHTS), device,
                        fan_in={"3d": getattr(arch3d.lookup(config), "fan_in", None)})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    """Per-call latency: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.e0, self.e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.e1.record()
            self.e1.synchronize()
            return self.e0.elapsed_time(self.e1)
        return (time.perf_counter() - self.t0) * 1e3


class Run:
    """The state of one run; `setup`, `window`, `traced`, `release`,
    `compare` in that order."""

    def __init__(self, spec: Dict, seed: int, device):
        self.spec, self.seed = spec, seed
        self.device = torch.device(device)
        self.config, self.mix = spec["config"], spec["mix"]
        self.kind = self.mix["kind"]
        self.pool_np = None
        self.rec: Dict = {"kind": self.kind, "batch_size": self.mix["batch_size"]}

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        dev = self.device
        self.net3d = arch3d.lookup(self.config)  # an unknown 3D network fails here
        phases = self.rec["setup_phases"] = {}
        t = time.perf_counter()

        def phase(name):
            nonlocal t
            _sync(dev)
            now = time.perf_counter()
            phases[name] = now - t
            t = now

        if dev.type == "cuda":
            program.build_kernels()
        phase("kernels")
        weights = seeded_weights(self.config, self.seed, dev)
        self.task = program.build_task(self.config, weights, dev)
        del weights
        phase("task")
        self.make_pool()
        phase("pool")
        self.over: List[torch.Tensor] = []
        self.pool_index: List[int] = []  # of each window call
        if self.kind == "train":
            self._setup_train()
        else:
            self._setup_eval()
        phase("warm")

    def make_pool(self) -> None:
        self.pool_np = G.make_pool(self.config, self.mix, self.seed)
        self.n = len(self.pool_np)

    def _setup_train(self) -> None:
        task, dev = self.task, self.device
        self.batches = [(program.point_batch(s, dev), program.point_batch(t, dev))
                        for s, t in self.pool_np]
        self.gen = torch.Generator(device=dev).manual_seed(G.derive(self.seed, G.DROPOUT))
        leaves = program.leaves(task)
        start = {k: p.detach().clone() for k, p in leaves.items()}
        losses, grad_norms = [], None
        self.warm = self.mix["warm_steps"]
        for s in range(self.warm):
            logs = task.train_step(*self.batches[s % self.n], self.gen)
            losses.append(logs["train/loss_total"])
            self.over.append(program.overflow(logs))
            if s == 0:
                grad_norms = program.first_grad_norms(task)
        keys = sorted(leaves)
        change = torch.stack([(leaves[k].detach() - start[k]).double().norm()
                              for k in keys]).tolist()
        self.prog = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
                     "change_norms": dict(zip(keys, change))}

    def _setup_eval(self) -> None:
        task, dev = self.task, self.device
        self.batches = [program.point_batch(b, dev) for b in self.pool_np]
        for i in range(self.mix["warm_calls"]):
            task.eval_step(self.batches[i % self.n])
        self.metrics = program.eval_metrics(task)
        rng = np.random.RandomState(G.derive(self.seed, G.SAMPLE) & 0xFFFFFFFF)
        rounds = rng.randint(0, self.mix["sample_rounds"], self.n)
        self.sampled = {j + self.n * int(r): j for j, r in enumerate(rounds)}
        self.captured: Dict[int, Dict[str, torch.Tensor]] = {}
        self.capture_as: Optional[int] = None
        self.calls: List = []  # (pool index, logs)
        self.latency_ms: List[float] = []
        self.timer = _Timer(dev)

        def grab(key, reshape):
            def hook(mod, args, out):
                if self.capture_as is not None:
                    self.captured.setdefault(self.capture_as, {})[key] = reshape(
                        out[0]["seg_logit"])
            return hook

        nc = self.config["num_classes"]
        self.grab_handles = [
            task.model2d.register_forward_hook(grab("2d", lambda t: t.reshape(-1, nc))),
            task.model3d.register_forward_hook(grab("3d", lambda t: t)),
        ]

    # -- window ---------------------------------------------------------

    def _call(self, i: int) -> None:
        if self.kind == "train":
            j = (self.warm + i) % self.n
            logs = self.task.train_step(*self.batches[j], self.gen)
        else:
            j = i % self.n
            self.capture_as = self.sampled.get(i)
            self.timer.start()
            self.metrics, logs = self.task.eval_step(self.batches[j], self.metrics)
            self.latency_ms.append(self.timer.stop_ms())
            self.capture_as = None
            self.calls.append((j, logs))
        self.pool_index.append(j)
        self.over.append(program.overflow(logs))

    def window(self, seconds: float, spans: bool = False) -> None:
        """Calls back to back until `seconds` have passed; the window ends
        when the card has finished the last one.  `spans` times each
        topology build (traced runs)."""
        dev = self.device
        self.spans: List[float] = []
        undo = topology_spans(self.task, self.spans) if spans else None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            self._call(i)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        self.rec["window_s"] = time.perf_counter() - t0
        self.rec["calls"] = i
        if undo is not None:
            undo()
        self.rec["topology_s"] = list(self.spans)
        self.rec["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)
        self.rec["latency_ms"] = list(getattr(self, "latency_ms", []))
        self.rec["window_pool_index"] = list(self.pool_index)

    def traced(self, calls: int) -> None:
        """`calls` more calls under the profiler, with the layer ranges."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        first = len(self.pool_index)
        with layer_ranges(program.layer_modules(self.task, self.net3d.SPCONV_MODULES)):
            spans: List[float] = []
            undo = topology_spans(self.task, spans)
            with profile(activities=acts) as prof:
                _sync(self.device)
                with torch.profiler.record_function(WINDOW):
                    for k in range(calls):
                        self._call(first + k)
                    _sync(self.device)
            undo()
        self.rec["trace_pool_index"] = self.pool_index[first:]
        self.rec["trace"] = summarize(*events(prof))

    def release(self) -> None:
        """Read back what the comparison needs and free the program."""
        over = torch.stack([o.float() for o in self.over]) if self.over else None
        self.rec["overflow_calls"] = int((over > 0).sum()) if over is not None else 0
        if self.kind == "train":
            self.prog["overflow"] = float(over.max()) if over is not None else 0.0
        else:
            for h in self.grab_handles:
                h.remove()
            losses = torch.stack([torch.stack([lg["loss_segmentation"].float(),
                                               lg["loss_segmentation_3d"].float()])
                                  for _, lg in self.calls]).tolist() if self.calls else []
            self.prog = {
                "calls": [(j, l2, l3) for (j, _), (l2, l3) in zip(self.calls, losses)],
                "cm": {k: getattr(self.metrics, k).cpu()
                       for k in ("cm_2d", "cm_3d", "cm_avg")},
                "logits": {j: (c["2d"].cpu(), c["3d"].cpu())
                           for j, c in self.captured.items()},
                "overflow": float(over.max()) if over is not None else 0.0,
            }
        for name in ("task", "batches", "gen", "metrics", "captured", "calls", "over"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- reference ------------------------------------------------------

    def reference(self, precision: str = "fp32") -> Reference:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        weights = seeded_weights(self.config, self.seed, self.device)
        return Reference(self.config, weights, self.device, PRECISIONS[precision])

    def reference_record(self, precision: str = "fp32", half: bool = False):
        """The reference's own record: train {"losses", "grad_norms",
        "change_norms"}; eval one `eval_batch` per pool batch."""
        ref = self.reference(precision)
        if self.kind == "train":
            gen = torch.Generator(device=self.device).manual_seed(
                G.derive(self.seed, G.DROPOUT))
            pairs = [self.pool_np[s % len(self.pool_np)] for s in range(self.mix["warm_steps"])]
            return ref.train_steps(pairs, gen, half=half)
        return [ref.eval_batch(b, half=half) for b in self.pool_np]

    def compare(self) -> Dict:
        """The program's numbers against the fp32 reference."""
        return numbers(self.kind, self.prog, self.reference_record())

    # -- work -----------------------------------------------------------

    def work_of_pool(self) -> List[Dict]:
        """`work.batch_work` of every pool batch, from the reference's own
        voxelisation; a train pair's entries summed over both domains."""
        geo = G.scan_geometry(self.config, self.mix)
        b3 = self.config["models"]["net3d"]["backbone_3d"]
        train = self.kind == "train"

        def one(batch):
            mask = torch.as_tensor(batch["point_mask"]).to(self.device)
            vox = voxelize(torch.as_tensor(batch["coords"]).to(self.device), mask,
                           b3["full_scale"], b3["num_planes"])
            return work.batch_work(vox, int(mask.sum()), self.config, geo,
                                   self.mix["batch_size"], train)

        out = []
        for item in self.pool_np:
            parts = [one(b) for b in (item if train else (item,))]
            out.append({k: sum(p[k] for p in parts) for k in parts[0]})
        return out


def _cpu(records: List[Dict]) -> List[Dict]:
    return [{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in r.items()}
            for r in records]


def numbers(kind: str, prog: Dict, ref) -> Dict:
    """`prog` (the program's record, or a reference's in its place) against
    the fp32 reference's record."""
    if kind == "train":
        return check.train_numbers(prog, ref)
    return check.eval_numbers(prog, _cpu(ref))


def as_program(kind: str, record) -> Dict:
    """A reference's record in the form of the program's (eval: one call
    per pool batch, every one of them sampled)."""
    if kind == "train":
        return record
    record = _cpu(record)
    return {"calls": [(j, r["loss_segmentation"], r["loss_segmentation_3d"])
                      for j, r in enumerate(record)],
            "cm": {k: sum(r[k] for r in record) for k in ("cm_2d", "cm_3d", "cm_avg")},
            "logits": {j: (r["logit_2d"], r["logit_3d"]) for j, r in enumerate(record)},
            "overflow": 0.0}
