#!/usr/bin/env python3
"""Time kernel K1 (csrc/flow_ba_lm.cu) at its path shapes under other
cluster plans than ``flow_ba_cuda.cluster_plan`` picks.

    python3 tools/k1_plan_sweep.py

For each of chip_smoke.py's five K1 shapes (same seeded inputs) and each
candidate (C CTAs per instance, P held points per thread), the profiler's
device time of the bare launch and its iterations; every plan's pose must
agree with the chosen plan's to 2e-4.  Then the fixed cost of one LM
iteration by cluster size (``chain_cost``).  A plan whose P * 256 points per CTA
fall short of ceil(N / C) streams the rest from device memory.  Needs one
CUDA device; prints one line per plan.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PLANS = {   # (M, N) -> candidate (C, P)
    (1, 2048): [(8, 1), (4, 2), (2, 4), (1, 8)],
    (18, 4096): [(8, 2), (4, 4), (2, 8)],
    (11, 2048): [(8, 1), (4, 2), (2, 4)],
    (198, 4096): [(4, 4), (2, 8), (8, 2), (1, 16), (1, 8)],
    (2, 2048): [(8, 1), (4, 2), (2, 4)],
}


def main() -> int:
    import torch

    import chip_smoke as cs
    from multimot_track_tpu_torch.config import SolverConfig
    from multimot_track_tpu_torch.solvers import flow_ba, flow_ba_cuda

    if not torch.cuda.is_available():
        print("k1_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.nvidia_smi()}", flush=True)
    sol = SolverConfig()
    rng = np.random.default_rng(0)             # the same draws as chip_smoke.py phase 3
    chosen = flow_ba_cuda.cluster_plan
    for name, M, N, weighted, is_cam in cs.k1_stages():
        prob = cs.make_flow_ba_problem(rng, M, N, np.array(
            [0.004, 0.004, 0.004, 0.1, 0.05, 0.5] if is_cam else [0.01, 0.01, 0.01, 0.2, 0.05, 0.4]))
        prob["point_weight"] = (1.0 / (1.0 + (prob["depth"] / sol.cam_depth_weight_z0) ** 2)
                                if weighted else None)
        params = flow_ba.FlowBAParams(
            reproj_info=sol.reproj_info,
            prior_info=sol.cam_flow_prior_info if is_cam else sol.obj_flow_prior_info,
            rp_thres=sol.cam_rp_thres if is_cam else sol.obj_rp_thres,
            iters=sol.cam_lm_iters if is_cam else sol.obj_lm_iters, tau=sol.lm_tau)
        args = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in prob.items()}
        ref = flow_ba_cuda.solve_flow_ba_cuda(**args, params=params).T
        print(f"[sweep] {name}: chosen plan {chosen(M, N)}", flush=True)
        for C, P in PLANS[(M, N)]:
            flow_ba_cuda.cluster_plan = lambda m, n, C=C, P=P: (C, P)
            try:
                bare = flow_ba_cuda._launcher(**args, params=params)
                it = bare().float()
                T = flow_ba_cuda.solve_flow_ba_cuda(**args, params=params).T
                torch.cuda.synchronize()
                _, us = cs.device_kernels(bare, reps=20)
            finally:
                flow_ba_cuda.cluster_plan = chosen
            dT = float((T - ref).abs().max())
            streamed = -(-N // C) > P * flow_ba_cuda.THREADS
            print(f"[sweep] {name}: C={C} P={P}{' (streams)' if streamed else ''}: "
                  f"{us / 1e3:.4f} ms device, iterations mean {float(it.mean()):.2f} max "
                  f"{int(it.max())}, max|dT| vs chosen {dT:.2e}", flush=True)
            if dT > cs.T_ATOL:
                raise SystemExit(f"plan C={C} P={P} disagrees on {name}")
    chain_cost(dev, cs)
    return 0


def chain_cost(dev, cs):
    """The fixed cost of one LM iteration at one point per thread, by cluster
    size: one instance of 256 C points on a cluster of C CTAs, the bare
    launch timed at an iteration cap of 1 and of 6 (rel_tol < 0, so only
    the cap or the lambda limit stops it); the difference over the extra
    iterations run is the chain of the iteration's two cluster reductions,
    its 6x6 solve and one point's two passes."""
    import torch

    from multimot_track_tpu_torch.solvers import flow_ba, flow_ba_cuda

    for C in (1, 2, 4, 8):
        rng = np.random.default_rng(5)
        prob = cs.make_flow_ba_problem(rng, 1, 256 * C, np.array([0.004, 0.004, 0.004, 0.1, 0.05, 0.5]))
        args = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in prob.items()}
        out = {}
        for cap in (1, 6):
            bare = flow_ba_cuda._launcher(**args, params=flow_ba.FlowBAParams(iters=cap, rel_tol=-1.0))
            it = int(bare()[0])
            torch.cuda.synchronize()
            out[cap] = (it, cs.device_kernels(bare, reps=50)[1])
        (i1, t1), (i6, t6) = out[1], out[6]
        print(f"[chain] C={C} ({256 * C} points, plan {flow_ba_cuda.cluster_plan(1, 256 * C)}): "
              f"{t1:.2f} us at {i1} iteration(s), {t6:.2f} us at {i6}: "
              f"{(t6 - t1) / max(i6 - i1, 1):.2f} us per iteration", flush=True)


if __name__ == "__main__":
    sys.exit(main())
