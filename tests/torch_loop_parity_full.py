"""The loop scene of ``chip_smoke.py`` phase 8 at DEFAULT_CONFIG through both
packages on the CPU: the JAX package with loop closing on and off, and the
port with loop closing on, drawing the JAX package's hypotheses
(``JaxKeySampler``).  Too slow for the test suite (about 4-7 min per run);
run it by hand:

    JAX_PLATFORMS=cpu python tests/torch_loop_parity_full.py

The three runs go in parallel processes of 3 threads each.  Prints each
run's loop events, global-BA stats, ATE, refined t-RPE and keyframes, then
the port's max |dT| against the JAX run.
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def one(package: str, loop: bool, out: str):
    import torch

    sys.path[:0] = [REPO, HERE]
    torch.set_num_threads(3)
    import chip_smoke
    from test_torch_ransac import FoldInKeys, JaxKeySampler

    kw = dict(seed=0, keyframe_gap=2, loop_consistency=1, enable_loop_closing=loop)
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from multimot_track_tpu.config import DEFAULT_CONFIG as C
        from multimot_track_tpu.pipeline.system import MultiMotSystem
        s = MultiMotSystem(C, **kw)
    else:
        from multimot_track_tpu_torch.config import DEFAULT_CONFIG as C
        from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
        s = MultiMotSystem(C, device="cpu", sampler=JaxKeySampler(
            FoldInKeys(0), C.padding.k_obj_max, C.solver.obj_ensemble_seeds), **kw)
    gba, inner = [], s.keyframes.global_ba

    def recording(*a, **k):
        o = inner(*a, **k)
        gba.append(None if o is None else o[1])
        return o

    s.keyframes.global_ba = recording
    for fd in chip_smoke.shuttle_frames():
        s.track_rgbd(fd)
    s.flush()
    summ = s.summary()
    np.save(out, np.stack(s.map.camera_poses))
    print(json.dumps(dict(
        run=f"{package}, loop closing {'on' if loop else 'off'}",
        loop_events=[[int(v) for v in e] for e in s.map.loop_events], global_ba=gba,
        ate_m=summ["ego_ate_rmse_m"], t_rpe_refined=summ["cam_t_rpe_refined_mean"],
        keyframes=[k.index for k in s.keyframes.frames])))


def main():
    import tempfile

    tmp = tempfile.mkdtemp()
    runs = [("jax", "on"), ("jax", "off"), ("torch", "on")]
    procs = [subprocess.Popen([sys.executable, __file__, p, m, os.path.join(tmp, f"{p}_{m}.npy")],
                              stdout=subprocess.PIPE, text=True) for p, m in runs]
    for (p, m), proc in zip(runs, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{p} {m} failed")
        print(out.strip().splitlines()[-1])
    a, b = (np.load(os.path.join(tmp, f"{p}_on.npy")) for p in ("jax", "torch"))
    print(f"port against the JAX package, loop closing on: max|dT| {np.abs(a - b).max():.3e}")


if __name__ == "__main__":
    if len(sys.argv) == 4:
        one(sys.argv[1], sys.argv[2] == "on", sys.argv[3])
    else:
        main()
