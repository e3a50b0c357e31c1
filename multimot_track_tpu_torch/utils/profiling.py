"""Observability: per-stage timing and the torch profiler's hooks.

Port of ``multimot_track_tpu.utils.profiling``.  ``StageTimer`` keeps the
wall seconds of named stages; on a stage's exit it waits for the CUDA
device of the stage's result, so the device's time is counted in the stage
that queued it.  ``trace`` records a ``torch.profiler`` trace and writes it
as a Chrome trace (the JAX package's ``xla_trace``), and ``annotate``
names a region in that trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class StageTimer:
    """Accumulates wall-clock seconds per named stage; synchronises the
    result's CUDA device on exit."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        """``with timer.stage("solve") as h: h["result"] = f(x)``: the
        stage's result is ``h["result"]`` if set, else ``result``."""
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            out = holder.get("result", result)
            if self.sync and out is not None:
                for dev in _cuda_devices(out, set()):
                    torch.cuda.synchronize(dev)
            self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.times.items():
            if not v:
                continue
            s = sorted(v)
            out[k] = {
                "n": len(v),
                "mean_s": sum(v) / len(v),
                "median_s": s[len(s) // 2],
                "max_s": s[-1],
            }
        return out

    def report(self) -> str:
        lines = []
        for k, st in sorted(self.summary().items()):
            lines.append(
                f"{k:30s} n={st['n']:4d} mean={st['mean_s']*1e3:8.2f}ms "
                f"median={st['median_s']*1e3:8.2f}ms max={st['max_s']*1e3:8.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str, cuda: bool = None):
    """Record a ``torch.profiler`` trace of the block (CPU, and the CUDA
    device when there is one or ``cuda`` says so) and write it as
    ``<logdir>/trace.json`` in the Chrome trace format; yields the
    profiler, whose ``trace_path`` names the file once the block ends."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.trace_path = os.path.join(logdir, "trace.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)
