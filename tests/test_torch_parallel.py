"""parallel/ on torch.distributed: the port's ranks against the JAX package's
mesh (CPU).

The port's ranks are OS processes (tests/torch_parallel_worker.py, which
imports only the port) joined by a gloo process group through a file
rendezvous; one group of 2 ranks and one of 4 run together, each rank on
one torch thread, while the JAX side runs here on the 8-device virtual CPU
mesh of tests/conftest.py.  The pair tracker's and the pairwise RANSAC's
hypothesis draws are the JAX package's keys' draws, recorded here by
sampler site and replayed in the workers.

Bounds (max |d|): point-sharded flow-BA vs the JAX distributed solver
1e-4, 2 ranks vs 4 ranks 1e-5, vs the single-process ``solve_flow_ba``
5e-4 (tests/test_parallel.py's bound); track-sharded window BA vs the JAX
one 1e-3 (poses) and 1e-4 (inverse depths); ``solve_relative_batch`` T_rel vs
JAX 1e-4 and ``compose_trajectory`` 1e-5; the pair-sharded tracker's
gathered Tcw_cur vs JAX ``batch.track_pairs`` on the hybrid mesh 1e-3
(T_TOL of tests/test_torch_tracker.py) and vs the port's single-process
``batch.track_pairs`` 1e-6.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as entrymod
from multimot_track_tpu import config as jconfig
from multimot_track_tpu.io.synth import make_multimover_frames
from multimot_track_tpu.ops import wire as jwire
from multimot_track_tpu.parallel import dist_ba as jdist_ba
from multimot_track_tpu.parallel import dist_window_ba as jdist_window_ba
from multimot_track_tpu.parallel import mesh as jmesh
from multimot_track_tpu.parallel import multihost as jmultihost
from multimot_track_tpu.parallel import pairwise as jpairwise
from multimot_track_tpu.pipeline import batch as jbatch
from multimot_track_tpu.pipeline import frames as jframes
from multimot_track_tpu.solvers.flow_ba import FlowBAParams as JFlowBAParams
from multimot_track_tpu.solvers.window_ba import WindowBAParams as JWindowBAParams
from multimot_track_tpu_torch import config as tconfig
from multimot_track_tpu_torch.parallel import dist_ba, mesh, multihost, pairwise
from multimot_track_tpu_torch.pipeline import batch as tbatch
from multimot_track_tpu_torch.pipeline.frames import tree_map
from multimot_track_tpu_torch.solvers.flow_ba import FlowBAParams, solve_flow_ba
from multimot_track_tpu_torch.solvers.window_ba import WindowBAParams, solve_window_ba
import test_parallel
import test_window_ba
from test_parallel import CAM, synth
from test_torch_ransac import JaxKeySampler
from test_torch_tracker import JCFG, TCFG, K, S, T_TOL
from test_window_ba import make_window
from torch_seeding import reseeded

torch.set_num_threads(1)

WORKER = pathlib.Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLDS = (2, 4)
RANK_TIMEOUT_S = 120         # per rank process; a hung collective fails its test
FLOW_ITERS, WINDOW_ITERS = 50, 20
CAM4 = (CAM.fx, CAM.fy, CAM.cx, CAM.cy)


def dryrun_camera():
    """The camera of ``dryrun_multichip``'s parts (2) and (3):
    ``__graft_entry__._small_cfg().camera``, the default one (the port
    cannot import the entry file; test_dryrun_camera_is_the_entry_files
    holds this copy to it)."""
    return tconfig.DEFAULT_CONFIG.camera


class PairwiseKeySampler(JaxKeySampler):
    """The JAX package's draws, with ``(pair, "pairwise")`` drawn by the
    pair's key unsplit, as parallel/pairwise hands it to RANSAC."""

    def key(self, site):
        if site[1] == "pairwise":
            return self.pair_keys[site[0]]
        return super().key(site)


class Recorder:
    """Wraps a sampler and keeps every draw by site, in call order."""

    def __init__(self, inner):
        self.inner, self.draws = inner, {}

    def __call__(self, p, iters, sites, k=3):
        idx = self.inner(p, iters, sites, k)
        for s, row in zip(sites.names(), idx):
            self.draws.setdefault(s, []).append(row.clone())
        return idx


# ---------------------------------------------------------------- inputs

def flow_ba_problem():
    uv, z, flow, T_true = synth()
    return dict(uv=uv, z=z, flow=flow, T_true=T_true, valid=np.ones(uv.shape[0], bool))


def window_problem():
    uvw, alive, zm, init, _, _ = make_window(N=512)
    return dict(uv=uvw, alive=alive, z=zm, init=init)


def solver_problems():
    """The flow-BA problem, the window and the pairwise batch, drawn as a
    fresh process draws them: from the JAX test modules' generators at their
    own seeds, which stay where they were."""
    with reseeded(test_parallel, 3), reseeded(test_window_ba, 21):
        return flow_ba_problem(), window_problem(), pairwise_problem()


def pairwise_problem():
    """test_parallel.test_pairwise_batch_and_compose's batch: B = 4, N = 256."""
    cfg_j = dataclasses.replace(jconfig.DEFAULT_CONFIG, solver=dataclasses.replace(
        jconfig.DEFAULT_CONFIG.solver, ransac_iters=64, cam_lm_iters=40))
    cfg_t = dataclasses.replace(tconfig.DEFAULT_CONFIG, solver=dataclasses.replace(
        tconfig.DEFAULT_CONFIG.solver, ransac_iters=64, cam_lm_iters=40))
    B, N = 4, 256
    probs = [synth(n=N, noise=0.0) for _ in range(B)]
    uv, z, flow = (np.stack([p[i] for p in probs]) for i in range(3))
    Ts = np.stack([p[3] for p in probs])
    X = uv_to_xyz(uv, z)
    cur_z = np.einsum("bij,bnj->bni", Ts[:, :3, :3], X)[..., 2] + Ts[:, None, 2, 3]
    inputs = (uv, flow, z, uv + flow, cur_z.astype(np.float32), np.ones((B, N), bool))
    return cfg_j, cfg_t, inputs, Ts


def uv_to_xyz(uv, z):
    x = (uv[..., 0] - CAM.cx) * z / CAM.fx
    y = (uv[..., 1] - CAM.cy) * z / CAM.fy
    return np.stack([x, y, z], -1)


def tracker_problem(n_frames=5):
    """The wire images of make_multimover_frames(5) for both packages, and
    the port's pair batch (frontend on the CPU)."""
    frames = make_multimover_frames(n_frames=n_frames)
    gray, depth, flow, sem = (np.stack(a) for a in zip(*[
        (np.clip(np.round(fd.gray), 0, 255).astype(np.uint8),
         np.clip(fd.depth_raw, 0, 65535).astype(np.uint16),
         jwire.pack_flow12(fd.flow), jwire.pack_sem4(fd.sem_mask)) for fd in frames]))
    gts = [jframes.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, K) for fd in frames]
    g, d, f, s, gt = tbatch.upload_frames(frames, TCFG, "cpu")
    obs = tbatch.frontend_batch(g, d, f, s, gt, TCFG)
    pairs = (tree_map(lambda x: x[:-1], obs), g[1:], d[1:], s[1:],
             tree_map(lambda x: x[1:], gt))
    return dict(wire=(gray, depth, flow, sem, gts), pairs=pairs)


def jax_tracker(wire, n_pairs):
    """JAX ``batch.track_pairs`` pair-sharded over the 8-device hybrid
    ("host", "pair") mesh, as ``dryrun_multichip`` runs it; the batch is
    padded to the 8 devices with copies of the last pair."""
    gray, depth, flow, sem, gts = wire
    gt_stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *gts)
    obs = jax.jit(jbatch.frontend_batch, static_argnames=("cfg",))(
        jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(flow), jnp.asarray(sem), gt_stack,
        cfg=JCFG)
    n_dev = len(jax.devices())
    pad = np.minimum(np.arange(n_dev), n_pairs - 1)
    keys = jax.random.split(jax.random.PRNGKey(0), n_pairs)
    tree = (keys, jax.tree_util.tree_map(lambda x: x[:-1], obs), gray[1:], depth[1:],
            sem[1:], jax.tree_util.tree_map(lambda x: x[1:], gt_stack))
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x)[pad], tree)
    hp = jmultihost.make_process_mesh(emulate_hosts=2)
    sharded = jmultihost.global_pair_batch(hp, tree)
    res = jax.jit(jbatch.track_pairs, static_argnames=("cfg",))(*sharded, cfg=JCFG)
    return np.asarray(res.Tcw_cur)[:n_pairs]


def _t(x):
    return torch.from_numpy(np.array(x))


def dryrun_problems(world):
    """dryrun_multichip's parts (2) and (3) at ``world`` ranks: N = 128 *
    world points, FlowBAParams(iters=5); F = 3, WindowBAParams(iters=3)."""
    cam = dryrun_camera()
    rng = np.random.default_rng(1)
    N = 128 * world
    uv1 = rng.uniform([100, 50], [cam.width - 100, cam.height - 50], (N, 2)).astype(np.float32)
    z1 = rng.uniform(5, 30, (N,)).astype(np.float32)
    f1 = rng.normal(0, 1, (N, 2)).astype(np.float32)
    Fw = 3
    uvw = rng.uniform([100, 50], [cam.width - 100, cam.height - 50],
                      (Fw, N, 2)).astype(np.float32)
    zw = rng.uniform(5, 30, (N,)).astype(np.float32)
    cam4 = (cam.fx, cam.fy, cam.cx, cam.cy)
    flow_job = dict(kind="flow_ba", iters=5, cam=cam4, uv=_t(uv1), flow=_t(f1), z=_t(z1),
                    valid=torch.ones(N, dtype=torch.bool))
    window_job = dict(kind="window_ba", iters=3, cam=cam4, uv=_t(uvw),
                      alive=torch.ones((Fw, N), dtype=torch.bool), z=_t(zw),
                      init=torch.eye(4).repeat(Fw, 1, 1))
    return flow_job, window_job


# ------------------------------------------------------------ the ranks

def launch(world, jobs, tmp):
    """Start ``world`` worker processes on ``jobs``; returns their Popens."""
    tmp.mkdir(parents=True, exist_ok=True)
    jobs_file = tmp / "jobs.pt"
    torch.save(jobs, jobs_file)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(tmp / "init"), str(jobs_file),
         str(tmp / "out")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env) for r in range(world)]


def collect(procs, tmp):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        f = tmp / "out" / f"rank{r}.pt"
        assert p.returncode == 0 and f.exists(), f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
        reports.append(torch.load(f, weights_only=False))
    return reports


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the recorded draws, both rank groups' reports and the JAX
    side's results."""
    base = tmp_path_factory.mktemp("torch_parallel")
    fba, window, (cfg_j, cfg_t, pw_inputs, pw_T) = solver_problems()
    trk = tracker_problem()
    n_pairs = trk["pairs"][1].shape[0]

    # the port, one process: the draws every worker replays
    pw_keys = jax.random.split(jax.random.PRNGKey(0), pw_inputs[0].shape[0])
    rec_pw = Recorder(PairwiseKeySampler(pw_keys, K, S))
    pw_single = pairwise.solve_relative_batch(rec_pw, range(len(pw_keys)),
                                              *map(_t, pw_inputs), cfg_t)
    rec_trk = Recorder(JaxKeySampler.for_sequence(0, n_pairs, K, S))
    trk_single = tbatch.track_pairs(*trk["pairs"], TCFG, rec_trk, list(range(n_pairs)))

    common = [
        ("flow_ba", dict(kind="flow_ba", iters=FLOW_ITERS, cam=CAM4, uv=_t(fba["uv"]),
                         flow=_t(fba["flow"]), z=_t(fba["z"]), valid=_t(fba["valid"]))),
        ("window_ba", dict(kind="window_ba", iters=WINDOW_ITERS, cam=CAM4,
                           **{k: _t(v) for k, v in window.items()})),
        ("window_uneven", dict(kind="window_ba", iters=1, cam=CAM4,   # 511 tracks
                               uv=_t(window["uv"][:, :-1]), alive=_t(window["alive"][:, :-1]),
                               z=_t(window["z"][:-1]), init=_t(window["init"]))),
        ("multihost", dict(kind="multihost", B_local=4)),
    ]
    jobs = {2: common + [("pairwise", dict(kind="pairwise", cfg=cfg_t, draws=rec_pw.draws,
                                           inputs=tuple(map(_t, pw_inputs))))],
            4: common + [("tracker", dict(kind="tracker", hosts=2, counts=(1,) * n_pairs,
                                          cfg=TCFG, draws=rec_trk.draws, pairs=trk["pairs"]))]}
    for w in WORLDS:
        fj, wj = dryrun_problems(w)
        jobs[w] += [("dryrun_flow_ba", fj), ("dryrun_window_ba", wj)]
    procs = {w: launch(w, jobs[w], base / f"w{w}") for w in WORLDS}
    try:
        # the JAX side, while the ranks run
        eye = jnp.eye(4)
        pm = jmesh.make_mesh(8, axis=jmesh.POINT_AXIS)
        jax_flow = np.asarray(jdist_ba.make_distributed_flow_ba(
            pm, JFlowBAParams(iters=FLOW_ITERS), *CAM4)(
            eye, eye, *(jnp.asarray(fba[k]) for k in ("uv", "flow", "z", "valid"))))
        jax_window = tuple(map(np.asarray, jdist_window_ba.make_distributed_window_ba(
            pm, JWindowBAParams(iters=WINDOW_ITERS), *CAM4)(
            *(jnp.asarray(window[k]) for k in ("init", "uv", "alive", "z")))))
        jax_pw = jpairwise.solve_relative_batch(pw_keys, *map(jnp.asarray, pw_inputs), cfg_j)
        jax_trk = jax_tracker(trk["wire"], n_pairs)
        reports = {w: collect(procs[w], base / f"w{w}") for w in WORLDS}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return dict(flow=fba, window=window, jobs=jobs, reports=reports, jax_flow=jax_flow,
                jax_window=jax_window, jax_pw=np.asarray(jax_pw),
                jax_traj=np.asarray(jpairwise.compose_trajectory(jax_pw)),
                pw_single=pw_single.numpy(), pw_T=pw_T, jax_trk=jax_trk,
                trk_single=trk_single.Tcw_cur.numpy())


def result(run, world, job, rank=None):
    """A job's result on every rank (or one), failing on a rank's error."""
    reps = run["reports"][world]
    outs = [reps[r][job] for r in (range(world) if rank is None else [rank])]
    for r, o in enumerate(outs):
        assert "error" not in o, f"rank {r}, {job}:\n{o['error']}"
    return outs if rank is None else outs[0]


# ----------------------------------------------------------------- tests

def test_initialize_single_process_noop(monkeypatch):
    """No coordinator, none in the environment: nothing to bring up."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize() is False


def test_one_rank_needs_no_group_and_more_ranks_do():
    m = mesh.make_mesh(1, mesh.POINT_AXIS, device_type="cpu")
    x = torch.arange(3.0)
    for y in (m.all_reduce(x), m.all_gather_rows(x, [3])):
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()   # a new tensor
    assert m.position() == 0 and not m.counts
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(2, mesh.POINT_AXIS, device_type="cpu")
    assert multihost.make_process_mesh(device_type="cpu").shape == {"host": 1, "pair": 1}


def test_cuda_ranks_raise_without_a_card():
    """NCCL / a CUDA mesh never give way to gloo or the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize("tcp://127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh(1, mesh.POINT_AXIS)
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize("tcp://127.0.0.1:1", 1, 0, device="cpu", backend="nccl")


def test_pair_batch_spec_and_placements():
    assert multihost.pair_batch_spec(1) == (("host", "pair"),)
    assert multihost.pair_batch_spec(3) == (("host", "pair"), None, None)
    m = mesh.make_mesh(1, device_type="cpu")
    assert mesh.pair_sharding(m).spec == (mesh.PAIR_AXIS,)
    assert mesh.replicated(m).spec == ()


def test_dryrun_camera_is_the_entry_files():
    assert dataclasses.asdict(dryrun_camera()) == \
        dataclasses.asdict(entrymod._small_cfg().camera)


def test_ranks_came_up_on_gloo(run):
    for w in WORLDS:
        for rep in run["reports"][w]:
            assert rep["did_init"] is True and rep["backend"] == "gloo"


@pytest.mark.parametrize("world", WORLDS)
def test_flow_ba_point_sharded(run, world):
    p = run["flow"]
    outs = result(run, world, "flow_ba")
    T = outs[0]["T"]
    for o in outs:                           # every rank holds the same pose
        np.testing.assert_array_equal(o["T"], T)
        assert o["all_reduce"] == 4 * FLOW_ITERS + 2
    np.testing.assert_allclose(T, run["jax_flow"], atol=1e-4)
    eye = torch.eye(4)[None]
    single = solve_flow_ba(eye, eye, _t(p["uv"])[None], _t(p["flow"])[None], _t(p["z"])[None],
                           _t(p["valid"])[None], *CAM4,
                           params=FlowBAParams(iters=FLOW_ITERS)).T[0].numpy()
    np.testing.assert_allclose(T, single, atol=5e-4)
    E = T @ np.linalg.inv(p["T_true"])
    assert np.linalg.norm(E[:3, 3]) < 0.05


def test_flow_ba_two_and_four_ranks_agree(run):
    T2 = result(run, 2, "flow_ba", 0)["T"]
    T4 = result(run, 4, "flow_ba", 0)["T"]
    np.testing.assert_allclose(T2, T4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_window_ba_track_sharded(run, world):
    outs = result(run, world, "window_ba")
    poses, rho = outs[0]["poses"], outs[0]["rho"]
    for o in outs:
        np.testing.assert_array_equal(o["poses"], poses)
    jp, jr = run["jax_window"]
    np.testing.assert_allclose(poses, jp, atol=1e-3)
    np.testing.assert_allclose(rho, jr, atol=1e-4)


def test_window_ba_refuses_uneven_tracks(run):
    for o in result(run, 2, "window_uneven"):
        assert o["refused"] and "unevenly" in o["refused"]


def test_pairwise_matches_jax(run):
    T_rel = run["pw_single"]
    np.testing.assert_allclose(T_rel, run["jax_pw"], atol=1e-4)
    for k in range(T_rel.shape[0]):
        E = T_rel[k] @ np.linalg.inv(run["pw_T"][k])
        assert np.linalg.norm(E[:3, 3]) < 5e-3, k
    traj = pairwise.compose_trajectory(_t(run["jax_pw"])).numpy()
    np.testing.assert_allclose(traj, run["jax_traj"], atol=1e-5)


def test_pairwise_pair_sharded(run):
    for o in result(run, 2, "pairwise"):
        np.testing.assert_allclose(o["T_rel"], run["pw_single"], atol=1e-6)
        np.testing.assert_allclose(o["traj"], run["jax_traj"], atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_meshes_and_batches(run, world):
    """tests/test_multihost.py and the two-process worker's batch checks."""
    B_local = 4
    B = B_local * world
    for r, o in enumerate(result(run, world, "multihost")):
        assert o["initialize_again"] is False
        assert o["shapes"] == {"default": (1, world), "emulate_2": (2, world // 2)}
        assert o["position"] == r                      # host-major: rows are rank order
        assert o["counts"] == (B_local,) * world
        assert abs(o["total"] - 3.0 * B * (B - 1) / 2.0) < 1e-3
        assert o["rows"] == [2 * r, 2 * r + 1]
        np.testing.assert_array_equal(o["shard_a"], np.arange(6 * r, 6 * r + 6,
                                                              dtype=np.float32).reshape(2, 3))
        np.testing.assert_array_equal(o["shard_b"], [2 * r, 2 * r + 1])


def test_dryrun_pair_sharded_tracker(run):
    """``dryrun_multichip``'s part (1): the full tracker pair-sharded over a
    (2, 2) mesh of 4 ranks, one pair each."""
    outs = result(run, 4, "tracker")
    assert [o["rows"] for o in outs] == [[0], [1], [2], [3]]
    T = outs[0]["Tcw_cur"]
    assert T.shape == (4, 4, 4) and np.isfinite(T).all()
    for o in outs:
        np.testing.assert_array_equal(o["Tcw_cur"], T)
    assert float(np.abs(T - run["trk_single"]).max()) <= 1e-6
    assert float(np.abs(T - run["jax_trk"]).max()) <= T_TOL
    traj = pairwise.compose_trajectory(_t(T))
    assert traj.shape == (5, 4, 4)


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_distributed_solvers(run, world):
    """``dryrun_multichip``'s parts (2) and (3) at ``world`` ranks, each
    against its single-process counterpart."""
    (_, fj), (_, wj) = run["jobs"][world][-2:]
    eye = torch.eye(4)
    T = result(run, world, "dryrun_flow_ba", 0)["T"]
    single = dist_ba.make_distributed_flow_ba(
        mesh.make_mesh(1, mesh.POINT_AXIS, device_type="cpu"), FlowBAParams(iters=5),
        *fj["cam"])(eye, eye, fj["uv"], fj["flow"], fj["z"], fj["valid"]).numpy()
    np.testing.assert_allclose(T, single, atol=1e-5)
    plain = solve_flow_ba(eye[None], eye[None], fj["uv"][None], fj["flow"][None], fj["z"][None],
                          fj["valid"][None], *fj["cam"],
                          params=FlowBAParams(iters=5, rel_tol=0.0)).T[0].numpy()
    np.testing.assert_allclose(T, plain, atol=5e-4)
    w = result(run, world, "dryrun_window_ba", 0)
    ref = solve_window_ba(wj["init"], wj["uv"], wj["alive"], wj["z"], *wj["cam"],
                          params=WindowBAParams(iters=3))
    assert w["poses"].shape == (3, 4, 4)
    np.testing.assert_allclose(w["poses"], ref.poses.numpy(), atol=2e-3)
    np.testing.assert_allclose(w["rho"], ref.inv_depth.numpy(), atol=2e-3)
