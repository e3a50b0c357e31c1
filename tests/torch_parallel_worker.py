"""One gloo rank of tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK WORLD INIT_FILE JOBS OUT

Brings up a gloo process group of WORLD ranks through the file rendezvous
INIT_FILE (``parallel.multihost.initialize(device="cpu")``), runs every
job in JOBS (a file the test wrote with ``torch.save``) on this rank's
share of the data, and writes {job: result} to OUT/rank<RANK>.pt.  Imports
the port and torch, nothing of JAX.  Hypothesis draws come recorded in the
job file, by sampler site, and are replayed here.
"""

import os
import pathlib
import sys
import traceback

import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from multimot_track_tpu_torch.parallel import (  # noqa: E402
    dist_ba, dist_window_ba, mesh as meshmod, multihost, pairwise,
)
from multimot_track_tpu_torch.pipeline import batch  # noqa: E402
from multimot_track_tpu_torch.pipeline.frames import tree_map  # noqa: E402
from multimot_track_tpu_torch.solvers.flow_ba import FlowBAParams  # noqa: E402
from multimot_track_tpu_torch.solvers.window_ba import WindowBAParams  # noqa: E402


class ReplaySampler:
    """Hands out recorded draws by site, in the order each site was asked."""

    def __init__(self, draws):
        self.draws = {s: list(v) for s, v in draws.items()}

    def __call__(self, p, iters, sites, k=3):
        idx = torch.stack([self.draws[s].pop(0) for s in sites.names()]).to(p.device)
        if tuple(idx.shape) != (len(sites), iters, k):
            raise ValueError(f"recorded draws {tuple(idx.shape)} for {(len(sites), iters, k)}")
        return idx


def _shard(x, rank, world, axis=0):
    n = x.shape[axis] // world
    return x.narrow(axis, rank * n, n)


def job_flow_ba(job, rank, world):
    mesh = meshmod.make_mesh(world, meshmod.POINT_AXIS, device_type="cpu")
    solve = dist_ba.make_distributed_flow_ba(mesh, FlowBAParams(iters=job["iters"]),
                                             *job["cam"])
    eye = torch.eye(4)
    sh = lambda k: _shard(job[k], rank, world)
    T = solve(eye, eye, sh("uv"), sh("flow"), sh("z"), sh("valid"))
    return dict(T=T.numpy(), all_reduce=mesh.counts["all_reduce"])


def job_window_ba(job, rank, world):
    mesh = meshmod.make_mesh(world, meshmod.POINT_AXIS, device_type="cpu")
    solve = dist_window_ba.make_distributed_window_ba(
        mesh, WindowBAParams(iters=job["iters"]), *job["cam"])
    n = job["uv"].shape[1]
    if n % world:                     # the refusal: this rank's share as shard_map cuts it
        lo, hi = rank * n // world, (rank + 1) * n // world
        uv, alive, z = job["uv"][:, lo:hi], job["alive"][:, lo:hi], job["z"][lo:hi]
        try:
            solve(job["init"], uv, alive, z)
        except ValueError as e:
            return dict(refused=str(e))
        return dict(refused=None)
    poses, rho = solve(job["init"], _shard(job["uv"], rank, world, 1),
                       _shard(job["alive"], rank, world, 1), _shard(job["z"], rank, world))
    rho_all = mesh.all_gather_rows(rho, [rho.shape[0]] * world)
    return dict(poses=poses.numpy(), rho=rho_all.numpy())


def job_multihost(job, rank, world):
    again = multihost.initialize()
    shapes = {"default": multihost.make_process_mesh(device_type="cpu").ranks.shape,
              "emulate_2": multihost.make_process_mesh(emulate_hosts=2,
                                                       device_type="cpu").ranks.shape}
    mesh = multihost.make_process_mesh(emulate_hosts=2, device_type="cpu")
    B_local = job["B_local"]
    local = {"x": (torch.arange(B_local, dtype=torch.float32)[:, None] + rank * B_local)
             * torch.ones((B_local, 3))}
    g = multihost.global_pair_batch(mesh, local)
    total = float(g.gather()["x"].sum())
    whole = {"a": torch.arange(world * 6, dtype=torch.float32).reshape(world * 2, 3),
             "b": torch.arange(world * 2, dtype=torch.int32)}
    sh = multihost.shard_pair_batch(mesh, whole)
    return dict(initialize_again=again, shapes=shapes, position=mesh.position(),
                total=total, counts=g.counts, rows=sh.rows,
                shard_a=sh.tree["a"].numpy(), shard_b=sh.tree["b"].numpy())


def job_pairwise(job, rank, world):
    mesh = meshmod.make_mesh(world, meshmod.PAIR_AXIS, device_type="cpu")
    rows = pairwise.shard_pairs(mesh, job["inputs"])
    T_rel = pairwise.solve_relative_batch(ReplaySampler(job["draws"]), rows.rows,
                                          *rows.tree, job["cfg"])
    T_all = rows.gather(T_rel)
    return dict(T_rel=T_all.numpy(), traj=pairwise.compose_trajectory(T_all).numpy())


def job_tracker(job, rank, world):
    mesh = multihost.make_process_mesh(emulate_hosts=job["hosts"], device_type="cpu")
    counts = job["counts"]
    lo = sum(counts[:mesh.position()])
    hi = lo + counts[mesh.position()]
    local = tree_map(lambda x: x[lo:hi], job["pairs"])
    rows = multihost.global_pair_batch(mesh, local)
    res = batch.track_pairs(*rows.tree, job["cfg"], ReplaySampler(job["draws"]), rows.rows)
    whole = rows.gather(res)
    return dict(Tcw_cur=whole.Tcw_cur.numpy(), rows=rows.rows,
                n_static_inliers=whole.n_static_inliers.numpy(),
                active=whole.objects.active.numpy())


JOBS = {"flow_ba": job_flow_ba, "window_ba": job_window_ba, "multihost": job_multihost,
        "pairwise": job_pairwise, "tracker": job_tracker}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, jobs_file, out_dir = sys.argv[3], sys.argv[4], pathlib.Path(sys.argv[5])
    torch.set_num_threads(1)
    did_init = multihost.initialize(f"file://{init_file}", world, rank, device="cpu",
                                    timeout_s=100)
    jobs = torch.load(jobs_file, weights_only=False)
    out = {"did_init": did_init, "backend": dist.get_backend()}
    for name, job in jobs:
        try:
            out[name] = JOBS[job["kind"]](job, rank, world)
        except Exception:              # reported to the test, which fails on it
            out[name] = {"error": traceback.format_exc()}
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".rank{rank}.{os.getpid()}.pt"
    torch.save(out, tmp)
    os.replace(tmp, out_dir / f"rank{rank}.pt")
    multihost.shutdown()


if __name__ == "__main__":
    main()
