"""The live pair step replayed from its tape of CUDA graphs
(``pipeline/step_graph``).

On the card (``gpu`` marker; ``--noconftest`` because tests/conftest.py
imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_step_graph.py

the tape's steps against the eager ``tracker.full_step`` from equal
generator states, at DEFAULT_CONFIG: 20 pairs of the junction, the avenue's
frames 30-45 (the crosser on label 4 born at 34, the oncoming car on 3 at
37), and six junction pairs with depth noise and flow outliers drawn from
the noise generator.  Integer and bool outputs equal, float outputs within
1e-5, every pair's outputs read after the last replay;
``dispatch_pair/replayed`` 0 on the first pair and 1 on every pair after
it; K1 5 launches a pair either way.  And the pipelined system, which reads
frame k - 1's result after frame k's replay, against the same system
stepping eagerly.

On the CPU: the tape's copies, the layout of its solve outputs, the seams
outside a recording, and ``reset``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multimot_track_tpu_torch.config import DEFAULT_CONFIG
from multimot_track_tpu_torch.io import synth
from multimot_track_tpu_torch.pipeline import frames as F
from multimot_track_tpu_torch.pipeline import step_graph, tracker
from multimot_track_tpu_torch.pipeline.system import MultiMotSystem
from multimot_track_tpu_torch.solvers import flow_ba, flow_ba_cuda
from multimot_track_tpu_torch.solvers.ransac import MultinomialSampler
from multimot_track_tpu_torch.utils import profiling

TOL = 1e-5
SEED = 7
REPLAYED = "dispatch_pair/replayed"
FX, FY, CX, CY = 460.0, 460.0, 320.0, 192.0


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def junction(card):
    return synth.make_junction_frames(21)


def wire(fd, cfg, dev):
    """One frame as the live system uploads it: wire tensors, GT table."""
    up = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
               for a in MultiMotSystem._compact_images(fd))
    gt = F.make_gt_table(fd.pose_gt, fd.obj_ids_gt, fd.obj_poses_gt, cfg.padding.k_obj_max)
    return up + (F.GTTable(*(torch.from_numpy(x).to(dev) for x in gt)),)


def drive(frames, cfg, dev, tape):
    """The live loop's pair steps over ``frames`` (the first, the frontend
    alone) inside a ``dispatch_pair`` span; returns every pair's outputs as
    numpy, read after the last step, the ``replayed`` counts and K1's
    launches a pair."""
    # the live system's settings: exact float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sampler = MultinomialSampler(torch.Generator(device=dev).manual_seed(SEED))
    noise = torch.Generator(device=dev).manual_seed(SEED + 1)
    drawn = noise if cfg.solver.depth_noise or cfg.solver.flow_outliers else None
    obs = tracker.first_step(*wire(frames[0], cfg, dev), cfg, drawn)
    ctx = F.tree_map(lambda x: x[0], tracker.initial_context(cfg.padding.k_obj_max, 1, dev))
    outs, k1, times, counts = [], [], {}, {}
    for i, fd in enumerate(frames[1:], 1):
        inputs = wire(fd, cfg, dev)
        n = flow_ba_cuda.solve_flow_ba_cuda.launches
        with profiling._StageCtx(times, "dispatch_pair", counts=counts):
            res, ctx, obs = tracker.full_step(sampler, i, obs, *inputs, ctx, cfg,
                                              generator=noise, tape=tape)
        k1.append(flow_ba_cuda.solve_flow_ba_cuda.launches - n)
        outs.append((res, ctx, obs))
    outs = [F.tree_map(lambda x: x.cpu().numpy(), o) for o in outs]
    return outs, counts[REPLAYED], k1


def fields(tree, path):
    """(path, leaf) of a nest of NamedTuples and tuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from fields(v, f"{path}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from fields(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(tree)


def assert_same(a, b, where):
    fa, fb = list(fields(a, where)), list(fields(b, where))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        if np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL, equal_nan=True, err_msg=path)
        else:
            np.testing.assert_array_equal(x, y, err_msg=path)


def scene(name, junction):
    if name == "junction":
        return junction, DEFAULT_CONFIG
    if name == "avenue":
        return synth.make_avenue_frames(240, times=range(29, 46)), DEFAULT_CONFIG
    noisy = dataclasses.replace(DEFAULT_CONFIG.solver, depth_noise=True, flow_outliers=True)
    return junction[:7], dataclasses.replace(DEFAULT_CONFIG, solver=noisy)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["junction", "avenue", "noise"])
def test_replayed_steps_equal_the_eager_step(card, junction, name):
    frames, cfg = scene(name, junction)
    n = len(frames) - 1
    eager, counts_eager, k1_eager = drive(frames, cfg, card, None)
    taped, counts, k1 = drive(frames, cfg, card, step_graph.StepTape())
    assert counts_eager == [0] * n
    assert counts == [0] + [1] * (n - 1)          # eager, then recorded and replayed
    assert k1 == k1_eager == [5] * n
    for f, (a, b) in enumerate(zip(taped, eager), 1):
        assert_same(a, b, f"pair {f}")


@pytest.mark.gpu
def test_the_pipelined_systems_results_survive_the_next_replay(card, junction):
    frames = junction[:12]

    def run(taped):
        s = MultiMotSystem(DEFAULT_CONFIG, seed=SEED, pipelined=True, device=card)
        if not taped:
            s._step_tape = None
        out = [s.track_rgbd(fd) for fd in frames] + [s.flush()]
        return s, [r for r in out if r is not None]

    s, results = run(True)
    _, eager = run(False)
    assert s.stage_counts[REPLAYED] == [0] + [1] * (len(frames) - 2)
    assert len(results) == len(eager) == len(frames) - 1
    for f, (a, b) in enumerate(zip(results, eager), 1):
        assert_same(a, b, f"frame {f}")


# ---------------------------------------------------------------- CPU

def problem(M=2, N=64):
    g = torch.Generator().manual_seed(0)
    eye = torch.eye(4).expand(M, 4, 4)
    obs = 100.0 + 200.0 * torch.rand((M, N, 2), generator=g)
    flow = torch.randn((M, N, 2), generator=g)
    depth = 4.0 + 10.0 * torch.rand((M, N), generator=g)
    return eye, eye, obs, flow, depth, torch.rand((M, N), generator=g) < 0.8


def test_copies_go_one_dtype_at_a_time_into_memory_of_their_own():
    src = [torch.arange(6.0).view(2, 3), torch.tensor([True, False]), torch.arange(4),
           torch.eye(4).expand(3, 4, 4), torch.ones(3, 2)[:, 0], torch.tensor([1, 0])]
    dst = [torch.zeros_like(s) for s in src]
    step_graph._copy(dst, src)
    fresh = step_graph._fresh(src)
    for d, f, s in zip(dst, fresh, src):
        assert d.dtype == f.dtype == s.dtype
        assert torch.equal(d, s) and torch.equal(f, s)
        assert f.data_ptr() != s.data_ptr()
    src[0].add_(1.0)
    assert fresh[0][0, 0] == 0.0


def test_the_solve_outputs_are_laid_out_as_both_solvers_return_them():
    M, N = 2, 64
    slots = flow_ba.empty_result(M, N, torch.device("cpu"))
    kernel = flow_ba_cuda._outputs(M, N, torch.device("cpu"))[:len(slots)]
    plain = flow_ba.solve_flow_ba(*problem(M, N), FX, FY, CX, CY,
                                  params=flow_ba.FlowBAParams(iters=2))
    for name, s, k, p in zip(flow_ba.FlowBAResult._fields, slots, kernel, plain):
        assert s.shape == k.shape == p.shape, name
        assert s.dtype == k.dtype == p.dtype, name


def test_the_seams_are_the_plain_calls_outside_a_recording():
    assert step_graph.span("x") is profiling.span("x")      # outside every span
    acc = {}
    with profiling._StageCtx(acc, "dispatch_pair"):
        with step_graph.span("ego"):
            pass
    assert set(acc) == {"dispatch_pair", "dispatch_pair/ego"}
    p = flow_ba.FlowBAParams(iters=3)
    a = step_graph.solve_flow_ba_auto(*problem(), FX, FY, CX, CY, params=p)
    b = flow_ba.solve_flow_ba_auto(*problem(), FX, FY, CX, CY, params=p)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_reset_drops_the_tape():
    s = MultiMotSystem(DEFAULT_CONFIG, enable_keyframes=False, device="cpu")
    tape = s._step_tape
    tape._key = ("a signature",)        # as after a pair step on the card
    s.reset()
    assert s._step_tape is not tape
    assert s._step_tape._key is None and s._step_tape._tape is None
