"""The program's own spans in a traced slice: per span, the CUDA runtime
calls its thread made inside it and the device work they queued.

The live system opens the profiler range ``mmt:<path>`` around each of its
spans while a profiler runs on the thread
(``multimot_track_tpu_torch.utils.profiling``); a path is a span's name
under its parent's (``dispatch_pair/ego``), and the root ``track_rgbd``
names its children as if it were not there.  Each CUDA runtime call is
given to the innermost ``mmt:`` range of its own thread that holds its
start, or to ``(no span)``, so the counts of all entries add up to the
slice's.  A device event belongs to the call with its correlation id.

Per entry, the counts of the calls given to it (``launches``, ``syncs``,
``copies``, ``sync_ms``: the time spent in syncs, ``device_ms``: the device
events of its calls) and the same with its children's (``*_all``); per
span also ``calls`` (ranges), ``host_ms`` and ``self_ms`` (host time
outside its children's ranges) and ``idle_ms``, the device's idle time
while the span was the innermost one of the thread that runs
``track_rgbd`` (``devtrace.idle_by_span``).

Launches are ``cudaLaunchKernel*``, ``cuLaunchKernel*`` and a graph launch
(one launch, whatever the graph holds); syncs ``cuda{Stream,Device,Event}
Synchronize`` (and the driver's) and every blocking copy; copies every
``cudaMemcpy*`` / ``cuMemcpy*``.  Nothing here is installed in a run: it
reads the events of a finished profile (``from_kineto``) or plain tuples
(``by_span``).
"""

from __future__ import annotations

from collections import defaultdict

from portbench import devtrace

PREFIX = "mmt:"
ROOT = "track_rgbd"
NO_SPAN = "(no span)"
COUNTS = ("launches", "syncs", "copies", "sync_ms", "device_ms")
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
_GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
          "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")
_COPIES = ("cudaMemcpy", "cuMemcpy")


def kinds(name: str):
    """(launch, sync, copy) of a CUDA runtime or driver call's name."""
    copy = name.startswith(_COPIES)
    launch = name.startswith(_LAUNCHES) or name in _GRAPH_LAUNCHES
    sync = name in _SYNCS or (copy and "Async" not in name)
    return launch, sync, copy


def _blank(span: bool) -> dict:
    out = {k: 0 for k in COUNTS}
    if span:
        out.update({k + "_all": 0 for k in COUNTS})
        out.update(calls=0, host_ms=0.0, self_ms=0.0)
    out["idle_ms"] = 0.0
    return out


def by_span(ranges, calls, device, idle_ns=None) -> dict:
    """``ranges``: (thread, start_ns, end_ns, path) of the spans' ranges;
    ``calls``: (thread, start_ns, end_ns, name, correlation id) of the CUDA
    runtime calls; ``device``: (start_ns, end_ns, correlation id) of the
    device events; ``idle_ns``: {path or '(no span)': ns}.  Returns
    {path or '(no span)': counts} as the module says."""
    dev_ns = defaultdict(int)
    for s, e, corr in device:
        dev_ns[corr] += e - s
    out = {NO_SPAN: _blank(False)}
    threads = defaultdict(list)
    for th, s, e, path in ranges:
        threads[th].append((s, e, path))
        out.setdefault(path, _blank(True))
    for rs in threads.values():
        rs.sort(key=lambda r: (r[0], -r[1]))
        # host and self time: a range opened inside another is its child
        stack, child_ns = [], [0] * len(rs)
        for i, (s, e, path) in enumerate(rs):
            while stack and rs[stack[-1]][1] <= s:
                stack.pop()
            if stack:
                child_ns[stack[-1]] += e - s
            stack.append(i)
        for (s, e, path), c in zip(rs, child_ns):
            d = out[path]
            d["calls"] += 1
            d["host_ms"] += (e - s) / 1e6
            d["self_ms"] += (e - s - c) / 1e6
    by_thread = defaultdict(list)
    for c in calls:
        by_thread[c[0]].append(c)
    for th, cs in by_thread.items():
        rs = threads.get(th, [])
        cs.sort(key=lambda c: c[1])
        stack, j = [], 0
        for _, s, e, name, corr in cs:
            while j < len(rs) and rs[j][0] <= s:
                while stack and stack[-1][1] <= rs[j][0]:
                    stack.pop()
                stack.append(rs[j])
                j += 1
            while stack and stack[-1][1] <= s:
                stack.pop()
            launch, sync, copy = kinds(name)
            add = dict(launches=int(launch), syncs=int(sync), copies=int(copy),
                       sync_ms=(e - s) / 1e6 if sync else 0.0,
                       device_ms=dev_ns.get(corr, 0) / 1e6)
            inner = out[stack[-1][2]] if stack else out[NO_SPAN]
            for k, v in add.items():
                inner[k] += v
            for path in {r[2] for r in stack}:
                for k, v in add.items():
                    out[path][k + "_all"] += v
    for path, ns in (idle_ns or {}).items():
        out.setdefault(path, _blank(path != NO_SPAN))["idle_ms"] += ns / 1e6
    return out


def totals(by: dict) -> dict:
    """The slice's counts: the sum over every entry, '(no span)' included."""
    return {k: sum(d[k] for d in by.values()) for k in COUNTS}


def named_share(by: dict, key: str = "launches") -> float:
    """The share of the slice's ``key`` that falls under a named span."""
    total = totals(by)[key]
    return 1.0 - by[NO_SPAN][key] / total if total else 1.0


def from_kineto(events) -> dict:
    """``by_span`` of a finished profile's ``kineto_results.events()``
    (CPU and CUDA activities; a thread is an event's
    ``device_resource_id``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ranges, calls, device = [], [], []
    h0 = h1 = None
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        annot = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                 else name.startswith((PREFIX, devtrace.SPAN)))
        if e.device_type() == cuda:
            if not annot and not name.startswith((PREFIX, devtrace.SPAN)):
                device.append((s, end, e.correlation_id()))
            continue
        h0 = s if h0 is None else min(h0, s)
        h1 = end if h1 is None else max(h1, end)
        if name.startswith(PREFIX):
            ranges.append((e.device_resource_id(), s, end, name[len(PREFIX):]))
        elif name.startswith("cu") and any(kinds(name)):
            calls.append((e.device_resource_id(), s, end, name, e.correlation_id()))
    idle = None
    if device:
        seg_s, seg_e = devtrace.merge([d[0] for d in device], [d[1] for d in device])
        live = {r[0] for r in ranges if r[3] == ROOT} or {r[0] for r in ranges}
        lo, hi = int(seg_s[0]), int(seg_e[-1])
        idle = devtrace.idle_by_span(seg_s, seg_e, lo if h0 is None else min(h0, lo),
                                     hi if h1 is None else max(h1, hi),
                                     [(s, e, p) for th, s, e, p in ranges if th in live])
    return by_span(ranges, calls, device, idle)


def per_frame(by: dict, frames: int) -> dict:
    """Every entry's counts and times over ``frames`` frames."""
    return {p: {k: v / frames for k, v in d.items()} for p, d in by.items()}


def layer_counts(by: dict, frames: int) -> dict:
    """The per-layer counts of a slice of ``frames`` frames: launches a
    frame under ``dispatch_pair``, ``local_map`` and ``window_refine`` and a
    call under ``joint_ba`` (children included), syncs a frame under the
    root; None where the span never ran."""
    def a_frame(path, key):
        return by[path][key + "_all"] / frames if path in by and frames else None

    jb = by.get("joint_ba")
    return {
        "dispatch_pair_launches": a_frame("dispatch_pair", "launches"),
        "local_map_launches": a_frame("local_map", "launches"),
        "window_refine_launches": a_frame("window_refine", "launches"),
        "joint_ba_launches_per_kf": jb["launches_all"] / jb["calls"] if jb else None,
        "host_syncs_per_frame": a_frame(ROOT, "syncs"),
    }
