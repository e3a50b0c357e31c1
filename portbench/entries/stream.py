"""Entry ``stream``: offline bulk processing of a recorded drive, as a user
of ``pipeline/batch.run_sequence_streaming`` runs it: the whole drive in
one call at the configuration's chunk, its host packing inside the call.

The set-up's warm-up runs one whole pass (K1 built, every chunk shape of
the drive, the padded last chunk included).  The window runs whole passes
over the same noisy frames back to back, each with its hypothesis sampler
seeded from ``--seed`` and the pass's index, and ends when the pass in
flight returns after its seconds.  The traced run profiles the passes
that begin in the window's last ``trace_tail_s`` seconds and reads the
host per-layer times only on the passes before them (once the profiler has
run, the process's launches stay slower).

Every pass is timed by the benchmark around the host packing of
``run_sequence_streaming`` (``batch.stream_chunks``) and its drain
(``state.result_to_numpy`` and ``batch._compose_batch_outputs``), patched
by name.  K1's inputs and poses are captured at the pair step's flow-BA
dispatch (``K1Capture``); the window's last pass is judged by the float64
re-solve of ``portbench/flowba64.py`` beside the scene's truth.
``reference.compare`` judges only the truth, so ``make`` extends it with
the float64 numbers of a run that carries captured problems
(``with_k1_gaps``); other runs' numbers are unchanged.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import devtrace, flowba64, harness
from portbench.entries.live import pipeline_config, to_frame_data

# the controls: K1's float inputs rounded to the mantissa of a lower precision
ROUNDINGS = {"k1-tf32-inputs": 10, "k1-bf16-inputs": 7}
N_OBJ_PROBLEMS = 256        # object problems of the judged pass re-solved in float64
MIN_POINTS = 10             # fewer valid points: an empty slot's problem, not re-solved


def round_mantissa(t, bits: int):
    """A float32 tensor rounded to ``bits`` explicit mantissa bits, to
    nearest with ties away from zero (as the card's TF32 conversion)."""
    import torch

    drop = 23 - bits
    i = t.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


class K1Capture:
    """Wraps the pair step's flow-BA dispatch, ``tracker.solve_flow_ba_auto``
    (patched by name; K1 on the card and the plain solver on the CPU are
    both behind it), and keeps references to each call's inputs and the
    poses it returned: no copy and no launch.  With ``bits``, each float
    input is rounded after the capture and before the solve (the control)."""

    def __init__(self, patches: devtrace.Patches, bits: int = None):
        from multimot_track_tpu_torch.pipeline import tracker

        self.calls = []
        solve = tracker.solve_flow_ba_auto

        def captured(T_init, Twl, obs, flow_meas, depth, valid, fx, fy, cx, cy, params,
                     backend="auto", point_weight=None):
            floats = (T_init, Twl, obs, flow_meas, depth, point_weight)
            if bits is not None:
                floats = [None if t is None else round_mantissa(t, bits) for t in floats]
            T0, W, o, fl, d, pw = floats
            res = solve(T0, W, o, fl, d, valid, fx, fy, cx, cy, params=params,
                        backend=backend, point_weight=pw)
            self.calls.append(dict(inputs=(T_init, Twl, obs, flow_meas, depth, valid,
                                           point_weight),
                                   cam=(fx, fy, cx, cy), params=params._asdict(), T=res.T))
            return res

        patches.set(tracker, "solve_flow_ba_auto", captured)

    def problems(self, solver_cfg, seed: int, n_obj: int = N_OBJ_PROBLEMS):
        """The captured problems on the host in float64, for
        ``flowba64.gap_numbers``: every camera problem, and ``n_obj`` object
        problems with at least MIN_POINTS valid points, drawn from ``seed``."""
        cam_key = (solver_cfg.cam_flow_prior_info, solver_cfg.cam_rp_thres,
                   solver_cfg.cam_lm_iters)
        kinds, counts = [], []
        for c in self.calls:
            p = c["params"]
            kinds.append("cam" if (p["prior_info"], p["rp_thres"], p["iters"]) == cam_key
                         else "obj")
            valid, depth = c["inputs"][5], c["inputs"][4]
            counts.append((valid & (depth > 0)).sum(1).cpu().numpy())
        pool = [(i, r) for i, k in enumerate(kinds) if k == "obj"
                for r in np.flatnonzero(counts[i] >= MIN_POINTS)]
        rng = np.random.default_rng(harness.derive_seed(seed, "k1-problems"))
        picked = sorted(rng.choice(len(pool), size=min(n_obj, len(pool)), replace=False)
                        .tolist()) if pool else []
        rows = {}
        for j in picked:
            rows.setdefault(pool[j][0], []).append(pool[j][1])
        groups = []
        for i, c in enumerate(self.calls):
            if kinds[i] == "obj" and i not in rows:
                continue
            M = c["T"].shape[0]
            idx = np.arange(M) if kinds[i] == "cam" else np.asarray(rows[i])

            def host(t, dtype=np.float64):
                if t is None:
                    return None
                if t.dim() == 1:                       # a point weight shared by all rows
                    t = t.expand(M, t.shape[0])
                return t[idx].detach().cpu().numpy().astype(dtype)

            T_init, Twl, obs, flow, depth, valid, pw = c["inputs"]
            groups.append(dict(kind=kinds[i], cam=c["cam"], params=c["params"],
                               T_init=host(T_init), Twl=host(Twl), obs=host(obs),
                               flow=host(flow), depth=host(depth), valid=host(valid, bool),
                               point_weight=host(pw), T_k1=host(c["T"])))
        return groups


def with_k1_gaps(compare):
    """``reference.compare`` plus, for runs that carry captured K1 problems
    (``k1``, on the last drive), the float64 gap numbers of the last one."""
    if getattr(compare, "adds_k1_gaps", False):
        return compare

    def judged(runs, truth):
        numbers = compare(runs, truth)
        k1 = [r["k1"] for r in runs if "k1" in r]
        if k1:
            numbers.update(flowba64.gap_numbers(k1[-1]))
        return numbers

    judged.adds_k1_gaps = True
    return judged


def _wrap(patches, obj, name, acc=None, key=None, span=None):
    """``obj.name`` timed into ``acc[key]`` and, with ``span``, inside the
    profiler range ``pb:<span>``."""
    import contextlib

    import torch

    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        ctx = (torch.profiler.record_function(devtrace.SPAN + span) if span
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with ctx:
                return fn(*a, **kw)
        finally:
            if acc is not None:
                acc[key] += time.perf_counter() - t0
    patches.set(obj, name, wrapped)


class Stream:
    def __init__(self, cell, frames, seed: int, trace: bool, device: str = "cuda"):
        import torch

        from multimot_track_tpu_torch import state
        from multimot_track_tpu_torch.pipeline import batch

        self.torch, self.batch, self.state = torch, batch, state
        self.cell, self.seed, self.trace, self.device = cell, seed, trace, device
        self.cfg = pipeline_config(cell.config)
        self.stream_kw = dict(cell.config["stream"])
        self.fds = to_frame_data(frames)
        self.tf32 = False            # the control: TF32 products and convolutions on
        self.k1_round = None         # the controls of ROUNDINGS
        self.capture = None

    def warm_up(self):
        """One whole pass: the cell's every shape, K1 built at first use
        (the pass ends with the one drain, which waits for the card)."""
        self._pass(harness.derive_seed(self.seed, "warm-up"), dict(pack_s=0.0, drain_s=0.0))

    def _pass(self, sampler_seed: int, acc: dict, profiled: bool = False):
        """One ``run_sequence_streaming`` call over the drive; returns the
        streaming call's (Tcw, records).  The call's K1 problems replace the last
        pass's in ``self.capture``."""
        b = self.batch
        patches = devtrace.Patches()
        self.capture = K1Capture(patches, ROUNDINGS.get(self.k1_round))
        _wrap(patches, b, "stream_chunks", acc, "pack_s", "pack" if profiled else None)
        _wrap(patches, self.state, "result_to_numpy", acc, "drain_s",
              "drain" if profiled else None)
        _wrap(patches, b, "_compose_batch_outputs", acc, "drain_s",
              "compose" if profiled else None)
        if profiled:
            _wrap(patches, b, "stream_chunk", span="chunk")
            _wrap(patches, b.ChunkUploader, "__call__", span="upload")
        if self.tf32:
            setup = b._setup

            def setup_tf32(*a, **kw):
                # after the program's own choice of exact float32
                out = setup(*a, **kw)
                self.torch.backends.cuda.matmul.allow_tf32 = True
                self.torch.backends.cudnn.allow_tf32 = True
                return out
            patches.set(b, "_setup", setup_tf32)
        try:
            Tcw, _, records = b.run_sequence_streaming(self.fds, self.cfg, seed=sampler_seed,
                                                       device=self.device, **self.stream_kw)
        finally:
            patches.restore()
        return Tcw, records

    def window(self, seconds: float, max_frames: int = None):
        """Whole passes until ``seconds`` have passed and, where it is
        given, ``max_frames`` pairs have been returned; returns the run
        record.  ``window(0, max_frames=len(frames) - 1)`` is one pass."""
        trace_at = seconds - float(self.cell.config["trace_tail_s"])
        probe_patches = devtrace.Patches()
        probe = None
        sl = devtrace.Slice() if self.trace else None
        passes, outputs = [], []
        pairs = 0
        t_start = last = time.perf_counter()
        while True:
            if self.trace and probe is None and last - t_start >= trace_at:
                probe = devtrace.KernelProbe(probe_patches)
                sl.start()
            acc = dict(pack_s=0.0, drain_s=0.0)
            out = self._pass(harness.derive_seed(self.seed, "pass", len(passes)), acc,
                             profiled=probe is not None)
            now = time.perf_counter()
            outputs.append(out)
            passes.append(dict(pairs=len(out[0]) - 1, host_s=now - last,
                               profiled=probe is not None, **acc))
            pairs += len(out[0]) - 1
            last = now
            if now - t_start >= seconds and (max_frames is None or pairs >= max_frames):
                break
        if probe is not None:
            sl.stop()
            probe_patches.restore()
        answers = [_answers(Tcw, records) for Tcw, records in outputs]
        answers[-1]["k1"] = self.capture.problems(self.cfg.solver, self.seed)
        self.capture = None
        rec = dict(kind="stream", wall_s=last - t_start, passes=passes, attempted=pairs,
                   answers=answers)
        if probe is not None:
            rec["profile"] = sl.summary()
            rec["k1_bounds_us"] = probe.k1_bounds_us()
            rec["profiled_pairs"] = sum(p["pairs"] for p in passes if p["profiled"])
        return rec


def _answers(Tcw, records) -> dict:
    """What the reference judges of one pass: the poses from the returned
    Tcw (no refinement, so refined and raw are one), and per object record
    (frame, label, track ID, P_lc), P_lc = Tcw[f] H_w Tcw[f-1]^-1 from the
    record's world-frame motion."""
    Tcw = np.asarray(Tcw, np.float64)
    Twc = np.linalg.inv(Tcw)
    recs = [(r["frame"], r["sem_label"], r["track_id"],
             Tcw[r["frame"]] @ np.asarray(r["H"], np.float64) @ Twc[r["frame"] - 1])
            for r in records]
    return dict(n=len(Tcw), Twc=Twc, Twc_raw=Twc, records=recs)


def make(cell, frames, seed, trace, device="cuda"):
    from portbench import reference

    reference.compare = with_k1_gaps(reference.compare)
    return Stream(cell, frames, seed, trace, device)
