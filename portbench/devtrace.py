"""The traced run's readings: a bounded slice of the window under
``torch.profiler`` (CPU and CUDA), the kernels' calls as the benchmark's
own wrappers see them, and spans around the program's layers.

Nothing here is installed in an untraced run.  The device's busy time is
the union of the device events' spans (the copy of
``tools/torch_profile_slice.device_busy_ms``), without the device side of
``record_function`` ranges, which are not work.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import bounds

SPAN = "pb:"                    # prefix of the benchmark's own spans
K1_KERNEL = "flow_ba_lm_kernel"
K2_KERNEL = "match_projected_kernel"


class Patches:
    """Module attributes replaced for the slice and put back after it."""

    def __init__(self):
        self._undo = []

    def set(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo.clear()


class KernelProbe:
    """Wraps K1's and K2's entry points (``flow_ba_cuda.solve_flow_ba_cuda``,
    ``match_cuda.match_projected_cuda``, which the program imports when it
    calls them) and keeps, per call, what its bound needs: the shapes and
    bytes at once, and references to the inputs whose counts (valid points,
    LM iterations, gated pairs) are read after the slice, so that the probe
    launches nothing on the device inside it."""

    def __init__(self, patches: Patches):
        from multimot_track_tpu_torch.ops import match_cuda
        from multimot_track_tpu_torch.solvers import flow_ba_cuda

        self.k1, self.k2 = [], []
        outs = {}
        f_outputs, k1, k2 = (flow_ba_cuda._outputs, flow_ba_cuda.solve_flow_ba_cuda,
                             match_cuda.match_projected_cuda)

        def outputs(*a):
            outs["last"] = f_outputs(*a)
            return outs["last"]

        def k1_probe(T_init, Twl, obs, flow_meas, depth, valid, *a, point_weight=None, **kw):
            res = k1(T_init, Twl, obs, flow_meas, depth, valid, *a,
                     point_weight=point_weight, **kw)
            M, N = obs.shape[0], obs.shape[1]
            if M > 0:
                o = outs["last"]
                self.k1.append(dict(
                    M=M, N=N, valid=valid, depth=depth, iters=o[6],
                    nbytes=bounds.tensor_bytes((T_init, Twl, obs, flow_meas, depth, valid,
                                                point_weight, *o))))
            return res

        def k2_probe(desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b, radius=15.0):
            best, second, idx = k2(desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b,
                                   radius=radius)
            if best.numel():
                args = (desc_a, uv_pred, valid_a, desc_b, uv_b, valid_b)
                self.k2.append(dict(args=args, radius=float(radius),
                                    nbytes=bounds.tensor_bytes((*args, best, second, idx))))
            return best, second, idx

        k1_probe.launches, k2_probe.launches = k1.launches, k2.launches
        patches.set(flow_ba_cuda, "_outputs", outputs)
        patches.set(flow_ba_cuda, "solve_flow_ba_cuda", k1_probe)
        patches.set(match_cuda, "match_projected_cuda", k2_probe)

    def k1_bounds_us(self):
        out = []
        for c in self.k1:
            n_valid = (c["valid"] & (c["depth"] > 0)).sum(1).double()
            point_iters = float((n_valid * c["iters"].double()).sum())
            out.append(bounds.k1_bound_us(c["M"], c["N"], point_iters, c["nbytes"])[0])
        return out

    def k2_bounds_us(self):
        out = []
        for c in self.k2:
            _, uv_a, va, _, uv_b, vb = c["args"]
            n = bounds.k2_gated_pairs(uv_a, va, uv_b, vb, c["radius"])
            out.append(bounds.k2_bound_us(n, c["nbytes"])[0])
        return out


def merge(starts, ends):
    """The union of intervals [start, end) as sorted, disjoint segments
    (start array, end array)."""
    starts, ends = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    run_end = np.maximum.accumulate(ends)
    # a new segment starts where a start lies past every end before it
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return starts[new], np.append(run_end[idx[1:] - 1], run_end[-1])


def idle_by_span(seg_start, seg_end, h0, h1, spans):
    """{span name: ns} of the device's idle time in [h0, h1] (the gaps
    between busy segments), each gap given to the innermost span around
    its middle; gaps in no span go to '(no span)'."""
    a = np.concatenate([[h0], seg_end])
    b = np.concatenate([seg_start, [h1]])
    keep = b > a
    a, b = a[keep], b[keep]
    mid = (a + b) // 2
    order = np.argsort(mid)
    a, b, mid = a[order], b[order], mid[order]
    label = np.full(len(mid), -1)
    names = []
    # outer spans first, so that an inner span overwrites its gaps
    for s, e, name in sorted(spans, key=lambda sp: sp[0] - sp[1]):
        lo, hi = np.searchsorted(mid, s, "left"), np.searchsorted(mid, e, "right")
        label[lo:hi] = len(names)
        names.append(name)
    out = {}
    for i, name in enumerate(names + ["(no span)"]):
        ns = int((b - a)[label == (i if i < len(names) else -1)].sum())
        if ns:
            out[name] = out.get(name, 0) + ns
    return out


class Slice:
    """One profiled slice: ``start()`` and ``stop()`` synchronise the card,
    so the slice's wall time holds all of its device work."""

    def __init__(self):
        self.prof = None
        self.wall_s = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self, top: int = 10) -> dict:
        """busy_s, the slice's wall, per-kernel device times of K1 / K2, and
        the breakdown: the device operations that took most time, and the
        device's idle time by the benchmark's span the host was in."""
        import torch

        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            annot = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                     else name.startswith(SPAN))
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not annot and not name.startswith(SPAN):
                    dev.append((s, s + d, name))
            else:
                host.append((s, s + d, name))
        self.prof = None
        if not dev:
            return {"busy_s": 0.0, "wall_s": self.wall_s, "n_device_events": 0,
                    "k1_us": [], "k2_us": [], "breakdown": None}
        seg_start, seg_end = merge([a for a, _, _ in dev], [b for _, b, _ in dev])
        busy_ns = int((seg_end - seg_start).sum())
        by_name = {}
        for a, b, n in dev:
            by_name[n] = by_name.get(n, 0) + (b - a)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        h0 = min([a for a, _, _ in host] + [int(seg_start[0])])
        h1 = max([b for _, b, _ in host] + [int(seg_end[-1])])
        spans = [(a, b, n[len(SPAN):]) for a, b, n in host if n.startswith(SPAN)]
        idle = idle_by_span(seg_start, seg_end, h0, h1, spans)
        idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {
            "busy_s": busy_ns / 1e9,
            "wall_s": self.wall_s,
            "n_device_events": len(dev),
            "k1_us": [(b - a) / 1e3 for a, b, n in dev if K1_KERNEL in n],
            "k2_us": [(b - a) / 1e3 for a, b, n in dev if K2_KERNEL in n],
            "breakdown": {
                "device_ops": [[n[:160], ns / 1e9] for n, ns in device_ops],
                "idle_gaps": [[n[:160], ns / 1e9] for n, ns in idle_gaps],
            },
        }

