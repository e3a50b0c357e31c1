#!/usr/bin/env python3
"""Time kernel K2 (csrc/match_projected.cu) at its path shapes under other
plans than ``match_cuda.match_plan`` picks.

    python3 tools/k2_plan_sweep.py

For each of chip_smoke.py's K2 shapes (same seeded inputs) and each
cluster size C (CTAs per cluster), the profiler's device time per call;
every plan's outputs must equal the plain version's exactly.
Needs one CUDA device; prints one line per plan.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PLANS = (1, 2, 4, 8)


def main() -> int:
    import torch

    import chip_smoke as cs
    from multimot_track_tpu_torch.ops import match_cuda, matching

    if not torch.cuda.is_available():
        print("k2_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.nvidia_smi()}", flush=True)
    rng = np.random.default_rng(1)             # the same draws as chip_smoke.py phase 5
    chosen = match_cuda.match_plan
    lib = match_cuda._lib()
    print("[sweep] clusters the card holds at once, by cluster size: "
          + ", ".join(f"C={C}: {lib.match_projected_max_clusters(C)}" for C in (1, 2, 4, 8)),
          flush=True)
    for name, L, N, M, radius in cs.k2_shapes():
        args = [a.to(dev) for a in cs.make_match_problem(rng, L, N, M, radius)]
        plain = matching.match_projected_plain(*args, radius=radius)
        pick = chosen(L * N, M)
        for C in PLANS:
            match_cuda.match_plan = lambda rows, m, C=C: C
            try:
                run = lambda: match_cuda.match_projected_cuda(*args, radius=radius)
                same = all(torch.equal(x, y) for x, y in zip(run(), plain))
                _, us = cs.device_kernels(run)
            finally:
                match_cuda.match_plan = chosen
            ctas = -(-L * N // (match_cuda.THREADS // match_cuda.THREADS_PER_QUERY)) * C
            print(f"[sweep] {name}: C={C} ({ctas} CTAs){' [plan]' if C == pick else ''}"
                  f": {us / 1e3:.4f} ms device, equal to plain: {same}", flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
