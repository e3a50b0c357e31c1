"""The stream cell on the CPU at test size: one pass through the entry's own
window, the arithmetic of its metrics, the float64 flow-BA against the
port's plain solver run in float64, the capture at K1's dispatch and the
lower-precision control it carries.

The test drive has 5 frames and the configuration's chunk is cut to 2, so
that a pass has two chunks and carries an observation between them."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import calibrate_stream, flowba64, harness, inputs, reference
from pbtest import REPO, small_root

SEED = 2 ** 33 + 11
N_FRAMES = 5
CHUNK = 2


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = small_root(tmp_path_factory.mktemp("stream"), n_frames=N_FRAMES)
    path = root / "portbench" / "configs" / "kitti03-rgbd-offline.json"
    cfg = json.loads(path.read_text())
    cfg["stream"]["chunk"] = CHUNK
    path.write_text(json.dumps(cfg))
    torch.set_num_threads(4)
    return harness.Cell("stream-junction", root=root)


@pytest.fixture(scope="module")
def one_pass(cell):
    clean, _ = inputs.clean_frames(cell)
    runner = cell.entry().make(cell, inputs.noisy_frames(cell, clean, SEED), SEED, False, "cpu")
    runner.warm_up()
    return runner.window(0.0, max_frames=N_FRAMES - 1)


def _reader(name):
    return harness.load_module(REPO / "portbench" / "metrics" / f"{name}.py", "metric")


def test_one_pass_returns_its_answers(one_pass):
    rec = one_pass
    assert rec["kind"] == "stream" and rec["attempted"] == N_FRAMES - 1
    assert len(rec["passes"]) == len(rec["answers"]) == 1
    ans = rec["answers"][0]
    assert ans["n"] == N_FRAMES and ans["Twc"].shape == (N_FRAMES, 4, 4)
    assert np.array_equal(ans["Twc"], ans["Twc_raw"]) and np.allclose(ans["Twc"][0], np.eye(4))
    assert ans["records"]
    for frame, label, tid, P in ans["records"]:
        assert 1 <= frame < N_FRAMES and label >= 1 and tid >= 1 and P.shape == (4, 4)
    # every camera problem of the pass (forward and backward, each chunk), and object problems
    groups = ans["k1"]
    cam = [g for g in groups if g["kind"] == "cam"]
    assert len(cam) == 2 * (N_FRAMES - 1) // CHUNK and all(len(g["T_k1"]) == CHUNK for g in cam)
    obj = [g for g in groups if g["kind"] == "obj"]
    assert obj and all(g["valid"].sum(1).min() >= 1 for g in obj)


def test_the_stream_metrics_of_one_pass(one_pass):
    rec = one_pass
    p = rec["passes"][0]
    assert _reader("stream_ms_per_pair").read(rec) == pytest.approx(1e3 * rec["wall_s"] / 4)
    assert rec["wall_s"] == pytest.approx(p["host_s"])
    assert 0 < p["pack_s"] < p["host_s"] and 0 < p["drain_s"] < p["host_s"]
    assert _reader("stream_pack_ms_per_pair").read(rec) == pytest.approx(1e3 * p["pack_s"] / 4)
    assert _reader("stream_drain_ms_per_pair").read(rec) == pytest.approx(1e3 * p["drain_s"] / 4)
    for name in ("stream_device_ms_per_pair", "k1_roofline.stream", "device_idle_share.stream"):
        assert _reader(name).read(rec) is None         # untraced: nothing to read


def test_host_readers_leave_out_the_profiled_pass_and_the_rate_does_not():
    passes = [dict(pairs=143, host_s=8.0, pack_s=1.0, drain_s=0.5, profiled=False),
              dict(pairs=143, host_s=9.0, pack_s=2.0, drain_s=0.7, profiled=False),
              dict(pairs=143, host_s=20.0, pack_s=9.0, drain_s=5.0, profiled=True)]
    rec = dict(kind="stream", wall_s=37.0, attempted=429, passes=passes,
               profile=dict(busy_s=3.0, wall_s=20.0, n_device_events=10), profiled_pairs=143)
    assert _reader("stream_ms_per_pair").read(rec) == pytest.approx(37e3 / 429)
    assert _reader("stream_pack_ms_per_pair").read(rec) == pytest.approx(3e3 / 286)
    assert _reader("stream_drain_ms_per_pair").read(rec) == pytest.approx(1.2e3 / 286)
    assert _reader("stream_device_ms_per_pair").read(rec) == pytest.approx(3e3 / 143)
    assert _reader("device_idle_share.stream").read(rec) == pytest.approx(85.0)
    live = dict(rec, kind="live")
    assert all(_reader(m).read(live) is None for m in (
        "stream_ms_per_pair", "stream_pack_ms_per_pair", "stream_drain_ms_per_pair",
        "stream_device_ms_per_pair", "k1_roofline.stream", "device_idle_share.stream"))


def _problems(M, N, seed):
    """Seeded flow-BA problems at the junction's camera: points 3-30 m away,
    a small true motion, flow noise with 15 % outliers, 90 % valid."""
    g = np.random.default_rng(seed)
    cam = (721.5377, 721.5377, 609.5593, 172.854)
    uv = np.stack([g.uniform(0, 1242, (M, N)), g.uniform(0, 375, (M, N))], -1)
    depth = g.uniform(3, 30, (M, N))
    xi = np.concatenate([g.normal(0, 0.01, (M, 3)), g.normal(0, 0.3, (M, 3))], -1)
    Twl = flowba64.exp_se3(np.concatenate([g.normal(0, 0.02, (M, 3)),
                                           g.normal(0, 1.0, (M, 3))], -1))
    Xw = flowba64.transform(Twl, flowba64.backproject(uv, depth, *cam))
    flow = (flowba64.project(flowba64.transform(flowba64.exp_se3(xi), Xw), *cam) - uv
            + g.normal(0, 0.3, (M, N, 2)))
    out = g.random((M, N)) < 0.15
    flow[out] += g.normal(0, 8.0, (int(out.sum()), 2))
    T_init = flowba64.exp_se3(xi + g.normal(0, 0.01, (M, 6)))
    return T_init, Twl, uv, flow, depth, g.random((M, N)) < 0.9, cam


@pytest.mark.parametrize("weighted,params", [
    (False, dict(reproj_info=0.1, prior_info=0.5, rp_thres=0.01, iters=100, tau=1e-5,
                 rel_tol=1e-6)),
    (True, dict(reproj_info=0.1, prior_info=0.3, rp_thres=0.04, iters=50, tau=1e-5,
                rel_tol=1e-6)),
])
def test_flowba64_agrees_with_the_plain_solver_run_in_float64(weighted, params):
    from multimot_track_tpu_torch.solvers import flow_ba

    T_init, Twl, uv, flow, depth, valid, cam = _problems(12, 512, 3 + weighted)
    pw = 1.0 / (1.0 + (depth / 15.0) ** 2) if weighted else None
    t = torch.from_numpy
    want = flow_ba.solve_flow_ba(t(T_init), t(Twl), t(uv), t(flow), t(depth), t(valid), *cam,
                                 params=flow_ba.FlowBAParams(**params),
                                 point_weight=None if pw is None else t(pw)).T.numpy()
    got, iters = flowba64.solve(T_init, Twl, uv, flow, depth, valid, *cam, params,
                                point_weight=pw)
    assert iters.mean() >= 3
    assert np.abs(got - want).max() <= 1e-9


def test_pose_gaps():
    T = flowba64.exp_se3(np.array([[0.01, -0.02, 0.03, 0.4, 0.1, -2.0]]))
    d = flowba64.exp_se3(np.array([[1e-6, 0.0, 0.0, 0.0, 3e-6, 0.0]]))
    t, r = flowba64.pose_gaps(d @ T, T)
    assert r[0] == pytest.approx(np.degrees(1e-6), rel=1e-6)
    assert t[0] == pytest.approx(np.linalg.norm((d @ T)[0, :3, 3] - T[0, :3, 3]), rel=1e-12)
    t, r = flowba64.pose_gaps(np.full((1, 4, 4), np.nan), T)
    assert np.isinf(t[0]) and np.isinf(r[0])


def test_round_mantissa_to_tf32_and_bf16():
    from portbench.entries import stream

    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12, 3.0, 0.0])
    assert stream.round_mantissa(x, 10).tolist() == [
        one, one + 2 ** -10, -(one + 2 ** -10), one, 3.0, 0.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 100
    for bits in (10, 7):
        r = stream.round_mantissa(y, bits)
        assert ((r - y).abs() <= y.abs() * 2.0 ** -(bits + 1)).all()
        assert torch.equal(stream.round_mantissa(r, bits), r)


def test_the_k1_gaps_are_added_only_to_runs_that_carry_captures(one_pass, cell):
    from portbench.entries import stream

    judged = stream.with_k1_gaps(lambda runs, truth: {"x": 1.0})
    assert judged([{"n": 1}], None) == {"x": 1.0}
    assert stream.with_k1_gaps(judged) is judged
    numbers = reference.compare(one_pass["answers"], cell.scene().truth())
    assert {"k1_f64_t_gap_m", "k1_f64_r_gap_deg"} <= set(numbers)
    assert 0 <= numbers["k1_f64_t_gap_m"] < 1e-3


def test_tf32_rounding_of_k1_inputs_raises_the_gap_threefold(cell):
    clean, _ = inputs.clean_frames(cell)
    entry = cell.entry()
    sound = calibrate_stream.reading(cell, entry, clean, SEED + 1, device="cpu")
    control = calibrate_stream.reading(cell, entry, clean, SEED + 1, control="k1-tf32-inputs",
                                       device="cpu")
    for name in ("k1_f64_t_gap_m", "k1_f64_r_gap_deg"):
        assert control[name] >= 3 * sound[name], (name, sound[name], control[name])
