#!/usr/bin/env python3
"""Same-call A/B of kernel K2 across source trees.

    python3 tools/k2_ab.py OLD_TREE . . OLD_TREE

Each tree argument is the root of a checkout (for the parent commit, one
unpacked with ``git archive`` into a directory ``.gitignore`` lists).  The
trees run one after another, each in its own process, which builds that
tree's csrc/match_projected.cu and runs this repository's
``chip_smoke.phase_match_kernel`` on that tree's ``match_projected_cuda``
(the same seeded inputs at the three path shapes, exact agreement with the
plain version required, no demand on the kernel count).  Per tree and shape
it prints the profiler's device ms per call and its split by device
kernel, the wrapper-included ms (CUDA events) and the plain version's ms,
then one table.  Needs one CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = "K2AB "


def child(tree: str) -> int:
    """Measure ``tree``'s K2 with this repository's phase 5."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from multimot_track_tpu_torch import kernels

    kernels.build("match_projected")
    figures = cs.phase_match_kernel(torch.device("cuda", 0), strict=False)
    print(TAG + json.dumps(figures), flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(argv[1])
    import torch

    if not torch.cuda.is_available() or not argv:
        print("usage (one CUDA device): k2_ab.py TREE [TREE ...]", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    runs = []
    for tree in argv:
        print(f"[ab] tree {tree}", flush=True)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                             capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"[ab] tree {tree} failed with exit code {out.returncode}", flush=True)
            return 1
        line = [ln for ln in out.stdout.splitlines() if ln.startswith(TAG)][-1]
        runs.append((tree, json.loads(line[len(TAG):])))
    print(f"[ab] {smi}; device ms per call (profiler) / kernels per call / wrapper ms "
          "(CUDA events), trees in call order:", flush=True)
    for k, fig in enumerate(runs[0][1]):
        cells = [f"{r[k]['ms']:.4f} / {r[k]['kernels_per_call']:.1f} / {r[k]['wrapper_ms']:.4f}"
                 for _, r in runs]
        print(f"[ab] {fig['stage']}: " + " | ".join(
            f"{tree}: {c}" for (tree, _), c in zip(runs, cells)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
