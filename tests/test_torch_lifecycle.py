"""The keyframe store's lifecycle: the PyTorch port against the JAX
package's own gates (CPU).

``tests/test_map_lifecycle.py`` (fusion merges duplicate landmarks,
found-ratio culling drops never-refound points, live-point mass stays
bounded under revisits), ``tests/test_kf_capacity.py`` (skeleton eviction
keeps the origin, the recent keyframes and a loop anchor past capacity;
eviction bumps the structural version and rebuilds the descriptor stack)
and ``tests/test_kf_dev_cache.py`` (the device cache follows reassignment
and lifecycle flips), each on that file's own fixtures: the same keyframes
go into a JAX store and a port store (``device="cpu"``), every gate of the
JAX test is asserted on the port, and the two stores must agree after
every step: fused and culled counts, live points, held indices, both
version counters and the lifecycle masks exactly, the retained points and
poses within 1e-5.

``test_map_lifecycle._scene`` draws from that module's ``RNG`` (seed 3):
the three scenes are drawn in its tests' order from a fresh generator at
that seed (``torch_seeding.reseeded``), so each test here sees the scene
its JAX counterpart sees, and the module's own generator is left alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_map_lifecycle as jml
from multimot_track_tpu.pipeline import keyframes as jkf
from multimot_track_tpu_torch.pipeline import keyframes as tkf
from test_kf_dev_cache import _kf as dev_cache_kf
from test_loop_closing import make_kf
from torch_seeding import reseeded

torch.set_num_threads(1)

X_TOL = 1e-5
LIFECYCLE = (jml.FX, jml.FY, jml.CX, jml.CY, jml.W, jml.H)


@pytest.fixture(scope="module")
def scenes():
    """test_map_lifecycle's three scenes, in its tests' order."""
    with reseeded(jml, 3):
        return [jml._scene() for _ in range(3)]


def to_port(kf):
    return tkf.Keyframe(**{f: np.copy(getattr(kf, f)) if isinstance(getattr(kf, f), np.ndarray)
                           else getattr(kf, f)
                           for f in ("index", "Tcw", "uv", "desc", "valid", "Xw",
                                     "seen", "found", "live", "bad")})


class Stores:
    """A JAX store and a port store fed the same keyframes."""

    def __init__(self, **kw):
        self.j = jkf.KeyframeStore(**kw)
        self.t = tkf.KeyframeStore(device="cpu", **kw)

    def add(self, kf):
        added = self.j.maybe_add(kf), self.t.maybe_add(to_port(kf))
        assert added[0] == added[1]
        self.same()
        return added[1]

    def fuse_and_cull(self):
        out = self.j.fuse_and_cull(*LIFECYCLE)
        assert self.t.fuse_and_cull(*LIFECYCLE) == out
        self.same()
        return out

    def same(self):
        j, t = self.j, self.t
        assert [k.index for k in t.frames] == [k.index for k in j.frames]
        assert (t._version, t._struct_version) == (j._version, j._struct_version)
        assert t.n_live_points() == j.n_live_points()
        for a, b in zip(t.frames, j.frames):
            for f in ("valid", "seen", "found", "live", "bad"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
            np.testing.assert_allclose(a.Xw, b.Xw, atol=X_TOL)
            np.testing.assert_allclose(a.Tcw, b.Tcw, atol=X_TOL)


# --- tests/test_map_lifecycle.py ----------------------------------------------

def test_fuse_merges_duplicates(scenes):
    Xw, desc = scenes[0]
    valid = np.ones(len(Xw), bool)
    s = Stores(min_gap=1)
    s.add(jml._mk_kf(0, jml._pose(0.0), Xw, desc, valid))
    s.add(jml._mk_kf(5, jml._pose(1.0), Xw, desc, valid))
    before = s.t.n_live_points()
    nf, nc = s.fuse_and_cull()
    store = s.t
    assert nf > 0.8 * len(Xw)
    assert store.n_live_points() == before - nf
    assert (store.frames[-1].valid & store.frames[-1].live).sum() == len(Xw)
    assert (store.frames[0].valid & store.frames[0].live).sum() == len(Xw) - nf
    assert store.frames[0].valid.sum() == len(Xw)
    assert store.frames[-1].found.max() >= 2


def test_cull_drops_never_refound_points(scenes):
    Xw, desc = scenes[1]
    valid = np.ones(len(Xw), bool)
    s = Stores(min_gap=1)
    desc0 = desc.copy()
    bogus = np.arange(32)
    desc0[bogus] = -desc0[bogus]
    s.add(jml._mk_kf(0, jml._pose(0.0), Xw, desc0, valid))
    culled_total = 0
    for i in range(1, 5):
        s.add(jml._mk_kf(5 * i, jml._pose(0.4 * i), Xw, desc, valid))
        culled_total += s.fuse_and_cull()[1]
    kf0 = s.t.frames[0]
    assert kf0.index == 0
    assert kf0.live[bogus].sum() <= 8, kf0.live[bogus].sum()
    assert culled_total >= 24, culled_total


def test_store_size_bounded_under_revisits(scenes):
    Xw, desc = scenes[2]
    valid = np.ones(len(Xw), bool)
    s = Stores(min_gap=1)
    live = []
    for i in range(8):
        tz = [0.0, 0.5, 1.0, 0.5][i % 4]
        s.add(jml._mk_kf(i * 5, jml._pose(tz + 0.01 * i), Xw, desc, valid))
        s.fuse_and_cull()
        live.append(s.t.n_live_points())
    assert live[-1] < 2.0 * len(Xw), live
    assert live[-1] < live[0] * len(s.t.frames) / 2


# --- tests/test_kf_capacity.py ------------------------------------------------

def _fill(s, n, step=3):
    kfs = [make_kf(i * step, seed=i) for i in range(n)]
    for kf in kfs:
        assert s.add(kf)
    return kfs


def _detect(store, kf):
    if isinstance(store, jkf.KeyframeStore):
        return store.detect_loop(jnp.asarray(kf.desc), jnp.asarray(kf.valid))
    return store.detect_loop(torch.from_numpy(kf.desc), torch.from_numpy(kf.valid))


def test_skeleton_keeps_origin_and_recent():
    s = Stores(capacity=12, min_gap=1)
    _fill(s, 40)
    idx = [kf.index for kf in s.t.frames]
    assert len(s.t.frames) == 12
    assert idx == sorted(idx)
    assert idx[0] == 0
    tail = max(2, s.t.capacity // 4)
    assert idx[-tail:] == [(40 - tail + k) * 3 for k in range(tail)]
    gaps = np.diff(idx)
    assert gaps.max() <= (idx[-1] - idx[0]) / 4 + 1, idx


def test_loop_anchor_survives_beyond_capacity():
    s = Stores(capacity=12, min_gap=1)
    kfs = _fill(s, 40)
    anchor = kfs[0]
    held = [k for k in s.t.frames if k.index == anchor.index]
    assert held
    cand = _detect(s.t, anchor)
    assert cand is not None and s.t.frames[cand] is held[0]
    assert cand == _detect(s.j, anchor)

    # control: the same fill under FIFO eviction loses the anchor
    fifo = Stores(capacity=12, min_gap=1)
    for st in (fifo.j, fifo.t):
        st._evict_skeleton = (lambda st: lambda: st.frames.pop(0))(st)
    for i in range(40):
        fifo.add(make_kf(i * 3, seed=i))
    assert fifo.t.frames[0].index == (40 - 12) * 3
    cand = _detect(fifo.t, anchor)
    assert cand is None or fifo.t.frames[cand].index != 0
    assert cand == _detect(fifo.j, anchor)


def test_eviction_bumps_versions_and_caches():
    s = Stores(capacity=8, min_gap=1)
    _fill(s, 8)
    store = s.t
    stack0 = store._stacked_descriptors()
    v0 = store._struct_version
    s.add(make_kf(99, seed=99))
    assert store._struct_version > v0
    stack1 = store._stacked_descriptors()
    assert stack1 is not stack0
    for a, b in zip(stack1, s.j._stacked_descriptors()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Xw, desc, valid = store.local_map(n_kf=3)
    assert Xw.shape[0] == 3 * store.frames[0].Xw.shape[0]
    assert store.frames[-1].index == 99
    for a, b in zip((Xw, desc, valid), s.j.local_map(n_kf=3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=X_TOL)


# --- tests/test_kf_dev_cache.py -----------------------------------------------

def test_struct_version_gates_stack_rebuild():
    s = Stores(min_gap=1)
    for i in range(3):
        s.add(dev_cache_kf(i))
    store = s.t
    stack1 = store._stacked_descriptors()
    assert stack1 is not None
    for st in (s.j, s.t):
        st.frames[0].live = st.frames[0].live & False
        st._version += 1
    s.same()
    assert store._stacked_descriptors() is stack1
    s.add(dev_cache_kf(3))
    stack3 = store._stacked_descriptors()
    assert stack3 is not stack1
    assert stack3[0].shape[0] == 4
    assert stack3[0].shape == s.j._stacked_descriptors()[0].shape


def test_dev_cache_tracks_reassignment():
    s = Stores(min_gap=1)
    kf = to_port(dev_cache_kf(0))
    d1 = s.t._dev(kf.Xw)
    assert s.t._dev(kf.Xw) is d1
    kf.Xw = kf.Xw + 1.0
    d2 = s.t._dev(kf.Xw)
    assert d2 is not d1
    np.testing.assert_allclose(d2.numpy(), d1.numpy() + 1.0)
    np.testing.assert_allclose(d2.numpy(), np.asarray(s.j._dev(kf.Xw)), atol=X_TOL)


def test_local_map_sees_lifecycle_flips():
    s = Stores(min_gap=1)
    for i in range(3):
        s.add(dev_cache_kf(i))
    n1 = int(s.t.local_map(n_kf=3)[2].sum())
    assert n1 == int(jnp.sum(s.j.local_map(n_kf=3)[2]))
    for st in (s.j, s.t):
        st.frames[-1].live = np.zeros_like(st.frames[-1].live)
        st._version += 1
    s.same()
    n2 = int(s.t.local_map(n_kf=3)[2].sum())
    assert n2 == n1 - int(s.t.frames[-1].valid.sum())
    assert n2 == int(jnp.sum(s.j.local_map(n_kf=3)[2]))
