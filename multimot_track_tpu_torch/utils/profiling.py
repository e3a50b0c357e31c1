"""Observability: per-stage timing, the live system's spans and the torch
profiler's hooks.

Port of ``multimot_track_tpu.utils.profiling``.  ``StageTimer`` keeps the
wall seconds of named stages; on a stage's exit it waits for the CUDA
device of the stage's result, so the device's time is counted in the stage
that queued it.  ``trace`` records a ``torch.profiler`` trace and writes it
as a Chrome trace (the JAX package's ``xla_trace``), and ``annotate``
names a region in that trace.

The live system's spans (``_StageCtx``, ``span``) record host seconds
without a synchronise, so device work lands in the span that queued it only
where that span also waits for it.  A recorder is a ``{path: [seconds,
...]}`` dict (``MultiMotSystem.stage_times``).  A span opened on the
recorder (``_StageCtx``: the system's stages and its ``track_rgbd`` root)
is recorded under its own name; ``span(name)``, for code that has no
recorder at hand, opens one inside the innermost open span of the running
thread's context, recorded under that span's path plus its name
(``"dispatch_pair/ego"``).  The innermost open span is kept in a
``ContextVar``; outside every span, ``span`` is one lookup and records
nothing.  While a profiler runs on the thread, each span also opens the
profiler range ``"mmt:" + path``, which puts the spans on the device
trace's clock; with none running, no range is opened.

A span may also carry a counter recorder, a ``{path: [n, ...]}`` dict
(``MultiMotSystem.stage_counts``), which the spans opened inside it share:
``count(name, n)`` appends ``n`` under the innermost open span's path plus
its name (``"record/slots_active"``), once a call.  It reads no device and
launches nothing; outside every span, or in a span without a counter
recorder, it records nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch
from torch.autograd import _profiler_enabled

SPAN_PREFIX = "mmt:"            # prefix of the spans' profiler ranges
# (recorder, path, counter recorder or None) of the innermost open span in
# this thread's context
_OPEN: contextvars.ContextVar = contextvars.ContextVar("mmt_open_span", default=None)
_NO_SPAN = contextlib.nullcontext()


class _StageCtx:
    """One span: appends its elapsed wall seconds to ``acc[path]``;
    ``args`` goes to its profiler range; ``counts`` is the counter recorder
    of ``count`` inside it."""

    __slots__ = ("acc", "path", "args", "counts", "t0", "token", "range")

    def __init__(self, acc: Dict[str, List[float]], path: str, args: str = None,
                 counts: Dict[str, List[int]] = None):
        self.acc, self.path, self.args, self.counts = acc, path, args, counts

    def __enter__(self):
        self.token = _OPEN.set((self.acc, self.path, self.counts))
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(SPAN_PREFIX + self.path, self.args)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.acc.setdefault(self.path, []).append(dt)
        if self.range is not None:
            self.range.__exit__(*exc)
        _OPEN.reset(self.token)
        return False


def span(name: str):
    """``with span("ego"):`` a span inside the innermost open span of this
    thread's context, in its recorder; outside every span, a context that
    records nothing."""
    outer = _OPEN.get()
    if outer is None:
        return _NO_SPAN
    return _StageCtx(outer[0], outer[1] + "/" + name, counts=outer[2])


def count(name: str, n: int = 1):
    """Record ``n`` events of ``name`` in the innermost open span: appends
    ``n`` to its counter recorder under the span's path plus ``name``.
    Outside every span, or in one without a counter recorder, nothing."""
    outer = _OPEN.get()
    if outer is not None and outer[2] is not None:
        outer[2].setdefault(outer[1] + "/" + name, []).append(n)


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
