"""The circuit's object records, one by one, from either package.

``obj_t_rpe_rel_mean`` of a long row is ``np.nanmean`` of every record's
``t_rel = |t(H_est^-1 H_gt)| / |t_gt|``, so a few records with a small
ground-truth motion can carry it.  This lists each record of the circuit
(``make_circuit_frames`` at the KITTI camera, DEFAULT_CONFIG, the live
system as ``eval/long_seq.run_scene`` drives it) with what makes its
``t_rel``, and compares two such lists.

  python tools/torch_obj_records.py port [--frames 220] [--noise] [--cpu] --out PATH.json
      the port's MultiMotSystem (on the card unless --cpu)
  JAX_PLATFORMS=cpu python tools/torch_obj_records.py jax [--frames N] [--noise] --out PATH.json
      the JAX package's MultiMotSystem on the CPU (~10-13 s a frame at
      1242x375); on the CPU the list is rewritten every 5 frames, so a cut
      run leaves the records of the frames it finished
  python tools/torch_obj_records.py compare PORT.json JAX.json
      matches records by (frame, label); prints the records that carry each
      mean, those finite in one list only, and those whose t_rel differ by
      more than 5 %

``--noise`` runs the circuit-noisy row instead: the frames under
``degrade_frames(seed=11)``, as ``eval.long_seq --noise`` degrades them.
``port --jax-draws`` (CPU only) draws every hypothesis the JAX package's
``MultiMotSystem(seed=0)`` draws (tests/test_torch_ransac.JaxKeySampler
over its step keys), so a record that parts between the packages can be
told apart from the packages' own draws.

Each record: frame, track id, label, t_rel, t_rel_centred, |t_gt| (the
absolute error over t_rel), and whether t_rel is finite.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def records_of(sys_) -> list:
    out = []
    for r in sys_.map.obj_records:
        if not r.has_gt:
            continue
        t_rel, t_abs = float(r.t_rpe_rel), float(r.t_rpe)
        out.append(dict(frame=int(r.frame), track_id=int(r.track_id), label=int(r.sem_label),
                        t_rel=t_rel, t_rel_centred=float(r.t_rpe_centred), t_abs=t_abs,
                        t_gt=t_abs / t_rel if np.isfinite(t_rel) and t_rel > 0 else None,
                        finite=bool(np.isfinite(t_rel))))
    return out


def carriers(recs, k=10) -> list:
    """The ``k`` records of largest ``t_rel``, each with its share of the sum."""
    fin = [r for r in recs if r["finite"]]
    total = sum(r["t_rel"] for r in fin) or 1.0
    top = sorted(fin, key=lambda r: -r["t_rel"])[:k]
    return [dict(r, share=r["t_rel"] / total) for r in top]


def summary(recs) -> dict:
    fin = [r["t_rel"] for r in recs if r["finite"]]
    return dict(n=len(recs), n_nonfinite=len(recs) - len(fin),
                t_rel_mean=float(np.mean(fin)) if fin else None,
                t_rel_median=float(np.median(fin)) if fin else None)


def write(out, recs, meta):
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(meta, summary=summary(recs), carriers=carriers(recs),
                                   records=recs), indent=1))


def drive(package, n_frames, cpu, out, noise=False, jax_draws=False):
    if package == "jax":
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
        from multimot_track_tpu.config import DEFAULT_CONFIG
        from multimot_track_tpu.pipeline.system import MultiMotSystem
        make, meta = (lambda: MultiMotSystem(DEFAULT_CONFIG)), dict(package="jax", device="cpu")
    else:
        import torch

        from multimot_track_tpu_torch.config import DEFAULT_CONFIG
        from multimot_track_tpu_torch.eval.long_seq import card_info
        from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
        device = torch.device("cpu" if cpu else "cuda")
        kw = {}
        if jax_draws:
            import os

            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                       + " --xla_cpu_max_isa=AVX2").strip()
            import jax

            jax.config.update("jax_platforms", "cpu")
            sys.path.insert(0, str(REPO / "tests"))
            from test_torch_ransac import FoldInKeys, JaxKeySampler

            torch.set_num_threads(1)     # as the tests run
            kw["sampler"] = JaxKeySampler(FoldInKeys(0), DEFAULT_CONFIG.padding.k_obj_max,
                                          DEFAULT_CONFIG.solver.obj_ensemble_seeds)
        make = lambda: MultiMotSystem(DEFAULT_CONFIG, device=device, **kw)   # noqa: E731
        meta = dict(package="port, JAX draws" if jax_draws else "port", **card_info(device))
    if package == "jax":
        from multimot_track_tpu.io import synth
    else:
        from multimot_track_tpu_torch.io import synth
    # the circuit's length sets its trajectory: render the whole lap, run a prefix
    cam = dict(synth.KITTI_SYNTH_CAM)
    frames = synth.make_circuit_frames(n_frames=220, cam=dict(cam))
    if noise:
        frames = synth.degrade_frames(frames, seed=11, bf=cam["bf"])
    frames = frames[:n_frames]
    sys_ = make()
    meta = dict(meta, scene="circuit-noisy" if noise else "circuit", n_frames=n_frames)
    t0 = time.perf_counter()
    for i, fd in enumerate(frames):
        sys_.track_rgbd(fd)
        if (package == "jax" or cpu) and (i + 1) % 5 == 0:
            write(out, records_of(sys_), dict(meta, frames_done=i + 1,
                                              wall_s=time.perf_counter() - t0))
            print(f"frame {i}: {time.perf_counter() - t0:.1f} s", flush=True)
    s = sys_.summary()
    recs = records_of(sys_)
    write(out, recs, dict(meta, frames_done=len(frames), wall_s=time.perf_counter() - t0,
                          obj_t_rpe_rel_mean=s["obj_t_rpe_rel_mean"],
                          cam_t_rpe_rel_mean=s["cam_t_rpe_rel_mean"],
                          ego_ate_rmse_m=s["ego_ate_rmse_m"]))
    print(json.dumps(dict(summary=summary(recs), obj_t_rpe_rel_mean=s["obj_t_rpe_rel_mean"])))
    for r in carriers(recs):
        print(json.dumps(r))


def compare(a_path, b_path, rtol=0.05):
    a, b = (json.loads(pathlib.Path(p).read_text()) for p in (a_path, b_path))
    last = min(a["frames_done"], b["frames_done"])
    keyed = [{(r["frame"], r["label"]): r for r in d["records"] if r["frame"] < last}
             for d in (a, b)]
    common = sorted(set(keyed[0]) & set(keyed[1]))
    only = [sorted(set(keyed[i]) - set(keyed[1 - i])) for i in (0, 1)]
    fin_diff, rel_diff = [], []
    for k in common:
        ra, rb = keyed[0][k], keyed[1][k]
        if ra["finite"] != rb["finite"]:
            fin_diff.append((k, ra["t_rel"], rb["t_rel"], ra["t_gt"], rb["t_gt"]))
        elif ra["finite"] and abs(ra["t_rel"] - rb["t_rel"]) > rtol * max(abs(rb["t_rel"]), 1e-12):
            rel_diff.append((k, ra["t_rel"], rb["t_rel"], ra["t_gt"], rb["t_gt"]))
    for name, d, kd in ((a["package"], a, keyed[0]), (b["package"], b, keyed[1])):
        recs = list(kd.values())
        print(name, f"frames < {last}:", json.dumps(summary(recs)))
        for r in carriers(recs, 8):
            print("  carries", json.dumps(r))
    print(f"common records {len(common)}; only in {a['package']} {len(only[0])}, "
          f"only in {b['package']} {len(only[1])}")
    print(f"finite in one only: {len(fin_diff)}")
    for x in fin_diff:
        print("  ", x)
    print(f"t_rel differs by > {rtol:.0%}: {len(rel_diff)}")
    for x in sorted(rel_diff, key=lambda x: -abs(x[1] - x[2]))[:20]:
        print("  ", x)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("port", "jax", "compare"))
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--frames", type=int, default=220)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--noise", action="store_true")
    ap.add_argument("--jax-draws", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.what == "compare":
        compare(*args.paths)
    else:
        if args.jax_draws and not (args.what == "port" and args.cpu):
            ap.error("--jax-draws replays the JAX package's draws through the port on the CPU")
        drive(args.what, args.frames, args.cpu, args.out, args.noise, args.jax_draws)


if __name__ == "__main__":
    main()
