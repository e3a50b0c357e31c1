"""The port's ``MonoTracker`` against the JAX package's (CPU), on the
monocular fixture: the distinct-texture junction at the KITTI camera,
every 6th frame of 43 (8 frames, 2.7 m of ego motion apart; unsubsampled
frames never initialise, and at the 640 x 384 camera neither does this
scene).  Both draw the same hypotheses (``MonoKeySampler`` replays the JAX
package's keys).

* Backend off, 8 frames: both initialise at frame 1, no frame is LOST,
  every step's direction is the ground truth's (cosine > 0.9) at one scale,
  and the poses agree to 1e-3 (measured 2.9e-6).
* Backend on (``keyframe_gap=2``), the 15-frame shuttle (the 8 frames
  forward, then back to the start, so frames 10-14 revisit the images of
  frames 4-0): both initialise at frame 1, lose no frame, relocalize at
  frame 10, keep keyframes [2, 4, ..., 14], accept the same TrackLocalMap
  refinements and close the same loops, (10 -> the keyframe of frame 4,
  23 inliers, scale 0.3285) and (12 -> frame 2, 30 inliers, scale 0.983),
  scales within 1e-3; the poses each frame returned and the corrected
  trajectory agree to 1e-3 (measured 1.1e-5 and 1.1e-5).

The shuttle's tail is fragile by construction: its relocalization and
Sim3 RANSAC draw with ``p`` following a valid mask over points
triangulated across small baselines, so one point more or less redraws
every hypothesis.  It holds because the port's small SVDs (the
initializer's, the triangulation's, the PnP DLT's) run in float64: with
them in float32 the port was ten times less accurate than the JAX
package's float32 LAPACK, and the tail parted by up to 0.10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.config import DEFAULT_CONFIG as JDEFAULT
from multimot_track_tpu.config import CameraConfig as JCameraConfig
from multimot_track_tpu.pipeline.mono import MonoTracker as JMono
from multimot_track_tpu_torch.config import DEFAULT_CONFIG, CameraConfig
from multimot_track_tpu_torch.io import synth as tsynth
from multimot_track_tpu_torch.pipeline.mono import MonoTracker

torch.set_num_threads(1)

TIMES = range(0, 43, 6)
POSE_TOL = 1e-3
TCFG = dataclasses.replace(DEFAULT_CONFIG, camera=CameraConfig(**tsynth.KITTI_SYNTH_CAM))
JCFG = dataclasses.replace(JDEFAULT, camera=JCameraConfig(**tsynth.KITTI_SYNTH_CAM))


class MonoKeySampler:
    """A HypothesisSampler that draws what the JAX ``MonoTracker`` draws
    with ``PRNGKey(seed)``: frame f's key is ``fold_in(root, f)``; the
    initializer's F and H sets come from its two ``split`` halves, the
    fallback PnP from ``fold_in(key, 1)``, and the tracked PnP,
    relocalization and Sim3 from the key itself."""

    def __init__(self, seed: int = 0):
        self.root = jax.random.PRNGKey(seed)

    def key(self, site):
        k = jax.random.fold_in(self.root, site[0])
        if site[1] in ("mono_F", "mono_H"):
            return jax.random.split(k)[int(site[1] == "mono_H")]
        if site[1] == "pnp_fallback":
            return jax.random.fold_in(k, 1)
        assert site[1] in ("pnp", "reloc", "sim3"), site
        return k

    def __call__(self, p, iters, sites, k=3):
        pn = p.cpu().numpy()
        idx = [np.asarray(jax.random.choice(self.key(s), pn.shape[1], shape=(iters, k),
                                            replace=True, p=jnp.asarray(pn[m])))
               for m, s in enumerate(sites.names())]
        return torch.from_numpy(np.stack(idx)).to(torch.int64).to(p.device)


@pytest.fixture(scope="module")
def frames():
    return tsynth.make_junction_frames(43, cam=dict(tsynth.KITTI_SYNTH_CAM),
                                       texture="distinct", times=TIMES)


def drive(tracker, grays):
    """Track ``grays``; the run's record, read the same way for both
    packages (the JAX tracker keeps counters only)."""
    rec = dict(init=None, lost=[], reloc=[], lm=[], online=[])
    tlm = tracker._track_local_map

    def counting_tlm(*a, **kw):
        T = tlm(*a, **kw)
        if T is not None:
            rec["lm"].append(len(tracker.poses))
        return T

    tracker._track_local_map = counting_tlm
    for i, g in enumerate(grays):
        n_lost, n_reloc = tracker.n_lost_frames, tracker.n_relocalizations
        rec["online"].append(np.array(tracker.track(g)))
        if tracker.initialized and rec["init"] is None:
            rec["init"] = i
        if tracker.n_lost_frames > n_lost:
            rec["lost"].append(i)
        if tracker.n_relocalizations > n_reloc:
            rec["reloc"].append(i)
    rec["online"] = np.stack(rec["online"])   # each frame's pose as it was returned
    rec["poses"] = np.stack(tracker.poses)     # the trajectory after loop corrections
    rec["loops"] = list(tracker.loop_events)
    rec["kfs"] = [k.index for k in tracker.keyframes.frames] if tracker.keyframes else None
    return rec


def run_both(grays, **kw):
    j = drive(JMono(JCFG, n_kp=1024, **kw), grays)
    tr = MonoTracker(TCFG, n_kp=1024, device="cpu", sampler=MonoKeySampler(0), **kw)
    t = drive(tr, grays)
    # the port's own lists say what the counters say
    assert (tr.init_frame, tr.lost_frames, tr.relocalized_frames, tr.lm_accepted_frames) == \
        (t["init"], t["lost"], t["reloc"], t["lm"])
    return j, t


@pytest.fixture(scope="module")
def backend_off(frames):
    return run_both([f.gray for f in frames], enable_backend=False)


@pytest.fixture(scope="module")
def shuttle(frames):
    grays = [f.gray for f in frames]
    return run_both(grays + grays[-2::-1], enable_backend=True, keyframe_gap=2)


def steps(poses, frames):
    """Per step: cosine of the estimated and true camera displacement, and
    the estimated / true length."""
    c = [np.linalg.inv(T)[:3, 3] for T in poses]
    g = [f.pose_gt[:3, 3] for f in frames]
    out = []
    for i in range(1, len(frames)):
        de, dg = c[i] - c[i - 1], g[i] - g[i - 1]
        out.append((float(de @ dg / (np.linalg.norm(de) * np.linalg.norm(dg) + 1e-12)),
                    float(np.linalg.norm(de) / np.linalg.norm(dg))))
    return np.asarray(out)


def test_backend_off_matches_jax(backend_off, frames):
    j, t = backend_off
    for r in (j, t):
        assert r["init"] == 1 and r["lost"] == [] and r["reloc"] == [] and r["loops"] == []
    assert float(np.abs(t["poses"] - j["poses"]).max()) <= POSE_TOL
    st = steps(t["poses"], frames)
    assert (st[1:, 0] > 0.9).all(), st      # step 0 -> 1 is the bootstrap's (no pose yet)
    ratio = st[2:, 1] / st[1, 1]            # one scale: the map anchors it
    assert (np.abs(ratio - 1.0) < 0.2).all(), st


def test_shuttle_events_match_jax(shuttle):
    j, t = shuttle
    for k in ("init", "lost", "reloc", "kfs", "lm"):
        assert t[k] == j[k], (k, t[k], j[k])
    assert t["init"] == 1 and t["lost"] == [] and t["reloc"] == [10]
    assert t["kfs"] == [2, 4, 6, 8, 10, 12, 14]
    assert [l[:3] for l in t["loops"]] == [l[:3] for l in j["loops"]]
    assert [l[:2] for l in t["loops"]] == [(10, 4), (12, 2)]
    for a, b in zip(t["loops"], j["loops"]):
        assert abs(a[3] - b[3]) <= 1e-3, (a, b)


def test_shuttle_poses_match_jax(shuttle):
    """The poses each frame returned, and the trajectory after both loop
    corrections."""
    j, t = shuttle
    for k in ("online", "poses"):
        assert float(np.abs(t[k] - j[k]).max()) <= POSE_TOL, k


def test_shuttle_returns_to_its_start(shuttle):
    """The corrected trajectory comes back to where it began (up to scale):
    the last position is near the first against the largest excursion."""
    _, t = shuttle
    c = np.stack([np.linalg.inv(T)[:3, 3] for T in t["poses"]])
    assert np.linalg.norm(c[-1] - c[0]) < 0.1 * np.linalg.norm(c - c[0], axis=1).max()
