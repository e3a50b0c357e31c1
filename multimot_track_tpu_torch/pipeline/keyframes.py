"""Keyframe store, TrackLocalMap, map-point fusion, relocalization and
loop closing.

Port of ``multimot_track_tpu.pipeline.keyframes``: a fixed-capacity host
list of keyframe arrays whose descriptors, world points and flags are
cached once on the device; the local-map pose refinement
(projection-guided matching through kernel K2, then stereo Gauss-Newton
with inlier re-classification, kernel K4 on the card); the
duplicate-landmark fuse scan of the newest keyframe against the previous L
in one K2 launch (the JAX ``vmap`` over L is K2's batch axis); keyframe
redundancy culling; place-recognition scores; relocalization by RANSAC
PnP; and the loop ladder: Sim3 RANSAC and a pose-graph correction
(``close_loop``), then the global bundle adjustment over the keyframe
graph (``global_ba``), plus two-view point creation
(``triangulate_between``).

Above ``bow_threshold`` keyframes, place recognition is two-stage
(``ops/bow``): a TF-IDF signature product over every keyframe, then exact
match counts on the ``bow_shortlist`` best.  The vocabulary is trained
once, from the store's first eight keyframes, from k-means seeds drawn by
``vocab_seed`` (default: ``bow.draw_seed_indices`` from a generator seeded
0, as the JAX package draws from a fixed key).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from multimot_track_tpu_torch.geometry import camera as cam_g
from multimot_track_tpu_torch.geometry import se3
from multimot_track_tpu_torch.ops import bow, matching
from multimot_track_tpu_torch.solvers import pnp, pose_graph, sim3
from multimot_track_tpu_torch.solvers.global_ba import GlobalBAParams, solve_global_ba
from multimot_track_tpu_torch.solvers.initializer import triangulate
from multimot_track_tpu_torch.solvers.ransac import (
    HypothesisSampler, _count_inliers, _gn_refine_stereo,
)
from multimot_track_tpu_torch.utils.profiling import count, span

# keyframes per batched descriptor-count pass: bounds the (chunk, N, N)
# distance intermediates without changing any count
COUNT_CHUNK = 8


def _in_view(y, uv_pred, width, height):
    return ((y[..., 2] > 0.5)
            & (uv_pred[..., 0] >= 0) & (uv_pred[..., 0] < width)
            & (uv_pred[..., 1] >= 0) & (uv_pred[..., 1] < height))


def local_map_refine(
    T_init: torch.Tensor,        # (4, 4) Tcw init (the flow-BA pose)
    Xw: torch.Tensor,            # (M, 3) local map points, world frame
    desc_map: torch.Tensor,      # (M, 256)
    valid_map: torch.Tensor,     # (M,)
    uv_cur: torch.Tensor,        # (N, 2) current-frame keypoints
    desc_cur: torch.Tensor,      # (N, 256)
    valid_cur: torch.Tensor,     # (N,)
    z_cur: torch.Tensor,         # (N,) measured depth of current keypoints
    fx, fy, cx, cy, width, height, bf,
    radius: float = 12.0,
    thresh: float = 3.0,
    gn_iters: int = 8,
    rounds: int = 2,
    depth_weight_z0: float = 15.0,
    backend: str = "auto",
):
    """Pose refinement against the local map (TrackLocalMap): project every
    map point with the init pose, match within ``radius`` px (K2), keep the
    best-distance map copy per current keypoint, then alternate weighted
    stereo Gauss-Newton with inlier re-classification
    (``local_map_gn_auto``: kernel K4 on the card).

    Returns (T_refined, n_inliers, n_matches) as tensors.  Inside the live
    system's ``local_map`` span the two parts are the spans ``match`` and
    ``gn``."""
    with span("match"):
        y = se3.transform(T_init, Xw)
        uv_pred = cam_g.project(y, fx, fy, cx, cy)
        res = matching.match_projected_auto(
            desc_map, uv_pred, valid_map & _in_view(y, uv_pred, width, height),
            desc_cur, uv_cur, valid_cur, radius=radius, backend=backend,
        )
        # uniqueness: several stacked copies of one landmark may match one
        # current keypoint; keep the best-distance copy (lowest index on
        # ties), the JAX package's .at[idx].min scatter written out
        M = res.idx.shape[0]
        key = (torch.where(res.valid, res.dist, torch.full_like(res.dist, 1e6)) * (M + 1.0)
               + torch.arange(M, dtype=torch.float32, device=Xw.device))
        best_key = torch.full((uv_cur.shape[0],), 1e12, dtype=torch.float32,
                              device=Xw.device).scatter_reduce(0, res.idx, key, "amin")
        matched = res.valid & (key <= best_key[res.idx])
        uv_obs = uv_cur[res.idx]
        disp_obs, w_disp = disparity_rows(z_cur[res.idx], matched, bf, depth_weight_z0)
        n_match = matched.sum()

    with span("gn"):
        T, n = local_map_gn_auto(T_init, Xw, uv_obs, disp_obs, w_disp, matched,
                                 fx, fy, cx, cy, bf, thresh=thresh, gn_iters=gn_iters,
                                 rounds=rounds)
    return T, n, n_match


def disparity_rows(z_obs, matched, bf, depth_weight_z0: float = 15.0):
    """The disparity row of each map point's stereo residual: the measured
    disparity ``bf / max(z, 0.25)`` and its weight, 0 without a depth
    (unmatched, or z <= 0.25 m) and falling as ``1 / (1 + (z / z0)^2)``
    with the depth's noise.  Returns (disp_obs, w_disp)."""
    has_depth = matched & (z_obs > 0.25)
    disp_obs = bf / torch.clamp(z_obs, min=0.25)
    w_disp = has_depth.to(torch.float32) / (1.0 + (z_obs / depth_weight_z0) ** 2)
    return disp_obs, w_disp


def local_map_gn(T_init, Xw, uv_obs, disp_obs, w_disp, matched, fx, fy, cx, cy, bf,
                 thresh: float = 3.0, gn_iters: int = 8, rounds: int = 2):
    """TrackLocalMap's stereo Gauss-Newton, plain: ``rounds`` rounds of
    ``gn_iters`` steps on IRLS Huber weights (delta = ``thresh``) taken at
    each round's start, then ``rounds`` rounds on the inlier set, recounted
    after each.  Returns (T, n_inliers) as tensors."""
    mf = matched.to(torch.float32)

    def huber_w(T):
        """IRLS Huber weights at delta = thresh over all matches."""
        yy = se3.transform(T, Xw)
        d = cam_g.project(yy, fx, fy, cx, cy) - uv_obs
        r = torch.sqrt((d * d).sum(-1))
        w = torch.clamp(thresh / torch.clamp(r, min=1e-6), max=1.0)
        return mf * w * (yy[..., 2] > 0)

    T = T_init
    for _ in range(rounds):
        T = _gn_refine_stereo(T, Xw, uv_obs, disp_obs, huber_w(T), w_disp, gn_iters,
                              fx, fy, cx, cy, bf)
    inl, n = _count_inliers(T, Xw, uv_obs, matched, thresh, fx, fy, cx, cy)
    for _ in range(rounds):
        T = _gn_refine_stereo(T, Xw, uv_obs, disp_obs, inl.to(torch.float32), w_disp,
                              gn_iters, fx, fy, cx, cy, bf)
        inl, n = _count_inliers(T, Xw, uv_obs, matched, thresh, fx, fy, cx, cy)
    return T, n


def local_map_gn_auto(T_init, Xw, uv_obs, disp_obs, w_disp, matched, fx, fy, cx, cy, bf,
                      thresh: float = 3.0, gn_iters: int = 8, rounds: int = 2):
    """Kernel K4 for CUDA tensors, ``local_map_gn`` for CPU tensors; counts
    ``k4`` in the open span (1 when K4 ran, 0 else).  A kernel that fails to
    build or launch raises: there is no fallback."""
    args = (T_init, Xw, uv_obs, disp_obs, w_disp, matched, fx, fy, cx, cy, bf)
    kw = dict(thresh=thresh, gn_iters=gn_iters, rounds=rounds)
    if Xw.is_cuda:
        from multimot_track_tpu_torch.solvers.local_map_gn_cuda import local_map_gn_cuda

        out = local_map_gn_cuda(*args, **kw)
        count("k4", 1)
        return out
    count("k4", 0)
    return local_map_gn(*args, **kw)


def _fuse_scan(Tcw_new, desc_new, uv_new, valid_new, Xw_new,    # the new keyframe
               Xw_prev, desc_prev, valid_prev,                  # stacked prev (L, N, ...)
               fx, fy, cx, cy, width, height,
               radius: float = 6.0, rel3d: float = 0.02, backend: str = "auto"):
    """Duplicate-landmark detection of L previous keyframes against the new
    one in one K2 launch: a previous point that projects into the new view,
    matches a new descriptor within ``radius`` px and whose stored 3-D
    position agrees to ``rel3d * z`` is the same landmark.

    Returns one (3, L, N) int32 tensor [dup, in_view, new_idx]."""
    y = se3.transform(Tcw_new, Xw_prev)
    uv_pred = cam_g.project(y, fx, fy, cx, cy)
    in_view = valid_prev & _in_view(y, uv_pred, width, height)
    res = matching.match_projected_auto(desc_prev, uv_pred, in_view, desc_new, uv_new,
                                        valid_new, radius=radius, backend=backend)
    d = Xw_new[res.idx] - Xw_prev
    d3 = torch.sqrt((d * d).sum(-1))
    dup = res.valid & (d3 < rel3d * torch.clamp(y[..., 2], min=0.5))
    return torch.stack([dup.to(torch.int32), in_view.to(torch.int32),
                        res.idx.to(torch.int32)])


def _batched_match_counts(desc_q, valid_q, desc_stack, valid_stack) -> torch.Tensor:
    """(K,) mutual-match counts of one query against a keyframe stack."""
    return torch.cat([
        matching.match_descriptors(desc_q[None], desc_stack[k:k + COUNT_CHUNK], valid_q[None],
                                   valid_stack[k:k + COUNT_CHUNK]).valid.sum(-1)
        for k in range(0, desc_stack.shape[0], COUNT_CHUNK)
    ])


def _adjacent_match_counts(desc_stack, valid_stack) -> torch.Tensor:
    """(K-1,) covisibility weights of consecutive keyframe pairs."""
    K = desc_stack.shape[0]
    if K < 2:
        return torch.zeros((0,), dtype=torch.int64, device=desc_stack.device)
    return torch.cat([
        matching.match_descriptors(desc_stack[k:min(k + COUNT_CHUNK, K - 1)],
                                   desc_stack[k + 1:min(k + 1 + COUNT_CHUNK, K)],
                                   valid_stack[k:min(k + COUNT_CHUNK, K - 1)],
                                   valid_stack[k + 1:min(k + 1 + COUNT_CHUNK, K)],
                                   threshold=50.0).valid.sum(-1)
        for k in range(0, K - 1, COUNT_CHUNK)
    ])


@dataclasses.dataclass
class Keyframe:
    index: int                 # frame index in the sequence
    Tcw: np.ndarray            # (4, 4)
    uv: np.ndarray             # (N, 2) keypoints
    desc: np.ndarray           # (N, 256) int8 sign-form descriptors
    valid: np.ndarray          # (N,) feature mask (descriptors exist)
    Xw: np.ndarray             # (N, 3) world points (from depth at capture)
    # map-point lifecycle: ``live`` is the map-point mask fusion and
    # culling clear; ``bad`` marks culled (geometry untrustworthy) points
    seen: np.ndarray = None    # (N,) int32 times projected into a new keyframe
    found: np.ndarray = None   # (N,) int32 times re-matched there
    live: np.ndarray = None    # (N,) bool
    bad: np.ndarray = None     # (N,) bool

    def __post_init__(self):
        if self.seen is None:
            self.seen = np.ones(self.valid.shape[0], np.int32)
        if self.found is None:
            self.found = np.ones(self.valid.shape[0], np.int32)
        if self.live is None:
            self.live = self.valid.copy()
        if self.bad is None:
            self.bad = np.zeros(self.valid.shape[0], bool)


def _cam_z(kf: Keyframe) -> np.ndarray:
    return ((kf.Tcw[:3, :3] @ kf.Xw.T).T + kf.Tcw[:3, 3])[:, 2]


class KeyframeStore:
    """Host list of keyframes with a device cache of their payloads.

    ``device`` holds the cached descriptors, points and flags and runs the
    store's solves (the card by default; without one the constructor
    raises, and ``device="cpu"`` runs on the CPU); ``match_backend``
    ("auto" | "cuda" | "torch") routes the projected matching of
    TrackLocalMap and the fuse scan; ``vocab_seed(p, n_words)`` returns the
    BoW vocabulary's k-means seed indices for draw probabilities p."""

    def __init__(self, capacity: int = 64, min_gap: int = 5, bow_threshold: int = 48,
                 bow_shortlist: int = 8, device="cuda", match_backend: str = "auto",
                 vocab_seed: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None):
        self.capacity = capacity
        self.min_gap = min_gap
        self.frames: List[Keyframe] = []
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("KeyframeStore runs on the card by default and found no "
                               "CUDA device; pass device='cpu' to run on the CPU")
        self.match_backend = match_backend
        self._version = 0            # bumped on any mutation; keys the local map
        self._struct_version = 0     # bumped when membership changes; keys the stack
        self._local_cache = None
        self._stack_cache = None
        self.bow_threshold = bow_threshold   # above it place recognition is two-stage
        self.bow_shortlist = bow_shortlist
        self.vocab_seed = vocab_seed or (lambda p, n: bow.draw_seed_indices(
            p, n, torch.Generator().manual_seed(0)))
        self._voc: Optional[bow.Vocabulary] = None   # trained at the first BoW query
        # id(kf) -> (kf, signature): the keyframe is kept with its entry, so
        # its id() cannot be recycled by a new keyframe while the entry lives
        self._sigs: dict = {}
        self.n_fuse_scans = 0        # fuse scans launched
        self.n_fused = 0             # map points fused away
        self.n_culled = 0            # map points culled
        # host array -> device tensor; the host array is kept with its copy
        # so that its id() cannot be recycled while the entry lives
        self._dev_arrays: dict = {}

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        e = self._dev_arrays.get(id(arr))
        if e is not None and e[0] is arr:
            return e[1]
        dev = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        self._dev_arrays[id(arr)] = (arr, dev)
        if len(self._dev_arrays) > 4 * max(len(self.frames), 8) + 16:
            keep = set()
            for kf in self.frames:
                keep.update((id(kf.desc), id(kf.Xw), id(kf.valid)))
            self._dev_arrays = {k: v for k, v in self._dev_arrays.items() if k in keep}
            self._dev_arrays[id(arr)] = (arr, dev)
        return dev

    def _t(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def maybe_add(self, kf: Keyframe) -> bool:
        if self.frames and kf.index - self.frames[-1].index < self.min_gap:
            return False
        self.frames.append(kf)
        if len(self.frames) > self.capacity:
            self._evict_skeleton()
        self._version += 1
        self._struct_version += 1
        return True

    def _evict_skeleton(self):
        """Capacity eviction that keeps loop anchors: drop the keyframe whose
        removal least widens the temporal coverage (the middle of the
        densest index triple); the first keyframe and the newest quarter are
        never evicted."""
        n = len(self.frames)
        lo, hi = 1, n - max(2, self.capacity // 4)
        if hi <= lo:
            self.frames.pop(0)
            return
        idx = [kf.index for kf in self.frames]
        self.frames.pop(min(range(lo, hi), key=lambda i: idx[i + 1] - idx[i - 1]))

    def correct_poses(self, new_Tcw: List[np.ndarray]):
        """Rewrite every keyframe pose after a trajectory correction,
        re-anchoring the stored world points with their keyframe."""
        assert len(new_Tcw) == len(self.frames)
        for kf, Tcw_new in zip(self.frames, new_Tcw):
            Xc = (kf.Tcw[:3, :3] @ kf.Xw.T).T + kf.Tcw[:3, 3]
            Twc_new = np.linalg.inv(Tcw_new)
            kf.Xw = ((Twc_new[:3, :3] @ Xc.T).T + Twc_new[:3, 3]).astype(np.float32)
            kf.Tcw = Tcw_new.astype(np.float32)
        self._version += 1

    # ------------------------------------------------------------------
    def local_map(self, n_kf: int = 3, max_depth: float = 35.0):
        """Concatenated (Xw, desc, valid) device tensors of the newest
        ``n_kf`` keyframes, live points within ``max_depth`` of their own
        keyframe's camera; cached until the store mutates."""
        sig = (self._version, n_kf, max_depth)
        if self._local_cache is not None and self._local_cache[0] == sig:
            return self._local_cache[1]
        kfs = self.frames[-n_kf:]
        Xw = torch.cat([self._dev(kf.Xw) for kf in kfs], 0)
        desc = torch.cat([self._dev(kf.desc) for kf in kfs], 0)
        zs = [_cam_z(kf) for kf in kfs]
        valid = self._t(np.concatenate([
            kf.valid & kf.live & (z > 0) & (z < max_depth) for kf, z in zip(kfs, zs)
        ]))
        self._local_cache = (sig, (Xw, desc, valid))
        return self._local_cache[1]

    def track_local_map(self, Tcw_init: np.ndarray, uv_cur, desc_cur, valid_cur, z_cur,
                        fx, fy, cx, cy, width, height, bf, n_kf: int = 3,
                        radius: float = 12.0, thresh: float = 3.0,
                        max_depth: float = 35.0) -> Tuple[np.ndarray, int, int]:
        """Refine ``Tcw_init`` against the local map.  Returns
        (T, n_inliers, n_matches); the caller applies its gates."""
        Xw, desc_m, valid_m = self.local_map(n_kf=n_kf, max_depth=max_depth)
        T, n_inl, n_match = local_map_refine(
            self._t(np.asarray(Tcw_init, np.float32)), Xw, desc_m, valid_m,
            uv_cur, desc_cur, valid_cur, z_cur, fx, fy, cx, cy, width, height, bf,
            radius=radius, thresh=thresh, backend=self.match_backend,
        )
        return T.cpu().numpy(), int(n_inl), int(n_match)

    # ------------------------------------------------------------------
    def _stacked_descriptors(self):
        """(K_pad, N, 256) device descriptor stack of the whole store, K
        padded to the next power of two with zero-valid rows; cached until
        membership changes.  None for a store of mixed keypoint counts."""
        sig = self._struct_version
        if self._stack_cache is not None and self._stack_cache[0] == sig:
            return self._stack_cache[1]
        K = len(self.frames)
        if K == 0 or len({kf.desc.shape[0] for kf in self.frames}) != 1:
            return None
        K_pad = 1 << (K - 1).bit_length()
        f0 = self.frames[0]
        pad_d = torch.zeros(f0.desc.shape, dtype=torch.int8, device=self.device)
        pad_v = torch.zeros(f0.valid.shape, dtype=torch.bool, device=self.device)
        desc = torch.stack([self._dev(kf.desc) for kf in self.frames] + [pad_d] * (K_pad - K))
        valid = torch.stack([self._dev(kf.valid) for kf in self.frames] + [pad_v] * (K_pad - K))
        self._stack_cache = (sig, (desc, valid))
        return self._stack_cache[1]

    def _pair_count(self, desc_a, valid_a, kf: Keyframe, threshold=matching.TH_LOW) -> int:
        return int(matching.match_descriptors(desc_a, self._dev(kf.desc), valid_a,
                                              self._dev(kf.valid),
                                              threshold=threshold).valid.sum())

    def _bow_signature(self, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self._voc is None:
            # trained once, from the store's early descriptors: retrieval
            # only ranks keyframes of this same scene
            train = torch.cat([self._dev(kf.desc) for kf in self.frames[:8]])
            tval = torch.cat([self._dev(kf.valid) for kf in self.frames[:8]])
            init_idx = self.vocab_seed(bow.seed_probabilities(tval), 256)
            self._voc = bow.train_vocabulary(init_idx.to(self.device), train, tval)
        return bow.signature(self._voc, desc, valid)

    def _kf_signature(self, kf: Keyframe) -> torch.Tensor:
        e = self._sigs.get(id(kf))
        if e is not None and e[0] is kf:
            return e[1]
        sig = self._bow_signature(self._dev(kf.desc), self._dev(kf.valid))
        if len(self._sigs) > 2 * len(self.frames) + 16:
            live = {id(f) for f in self.frames}
            self._sigs = {k: v for k, v in self._sigs.items() if k in live}
        self._sigs[id(kf)] = (kf, sig)
        return sig

    def _bow_scores(self, desc: torch.Tensor, valid: torch.Tensor, K: int) -> np.ndarray:
        """Two-stage retrieval: signature similarity over the first K
        keyframes, exact match counts on the ``bow_shortlist`` best only."""
        q = self._bow_signature(desc, valid)
        sigs = torch.stack([self._kf_signature(kf) for kf in self.frames[:K]])
        sim = bow.retrieve(q, sigs).cpu().numpy()
        scores = np.zeros(K, np.int32)
        for k in np.argsort(sim)[::-1][:self.bow_shortlist]:
            scores[k] = self._pair_count(desc, valid, self.frames[int(k)])
        return scores

    def similarity_scores(self, desc: torch.Tensor, valid: torch.Tensor,
                          exclude_last: int = 2) -> np.ndarray:
        """Mutual-match count against every stored keyframe but the newest
        ``exclude_last`` (place recognition): all in one batched pass, or,
        above ``bow_threshold`` keyframes, on the BoW shortlist only (zeros
        elsewhere)."""
        K = len(self.frames) - exclude_last
        if K <= 0:
            return np.zeros(max(K, 0), np.int32)
        if len(self.frames) > self.bow_threshold:
            return self._bow_scores(desc, valid, K)
        stacked = self._stacked_descriptors()
        if stacked is None:   # mixed keypoint counts: one keyframe at a time
            return np.asarray([self._pair_count(desc, valid, kf) for kf in self.frames[:K]],
                              np.int32)
        return _batched_match_counts(desc, valid, *stacked)[:K].cpu().numpy()

    def detect_loop(self, desc: torch.Tensor, valid: torch.Tensor,
                    min_matches: int = 40) -> Optional[int]:
        """Best loop candidate index into ``frames``."""
        if len(self.frames) <= 3:
            return None
        scores = self.similarity_scores(desc, valid)
        if scores.size == 0 or scores.max() < min_matches:
            return None
        return int(scores.argmax())

    # ------------------------------------------------------------------
    def covisibility(self, i: int, j: int, threshold: float = 50.0) -> int:
        """Shared-observation count between stored keyframes i and j."""
        a = self.frames[i]
        return self._pair_count(self._dev(a.desc), self._dev(a.valid), self.frames[j],
                                threshold=threshold)

    def _fuse_inputs(self, prevs):
        return (torch.stack([self._dev(kf.Xw) for kf in prevs]),
                torch.stack([self._dev(kf.desc) for kf in prevs]),
                self._t(np.stack([kf.valid & kf.live for kf in prevs])))

    def fuse_and_cull(self, fx, fy, cx, cy, width, height, n_prev: int = 4,
                      radius: float = 6.0, rel3d: float = 0.02, cull_min_seen: int = 3,
                      cull_ratio: float = 0.25) -> Tuple[int, int]:
        """Map-point lifecycle at keyframe cadence: the newest keyframe is
        scanned against the previous ``n_prev`` (one K2 launch); re-observed
        previous copies are fused into the newest, and points often seen but
        rarely re-found are culled.  Returns (n_fused, n_culled)."""
        if len(self.frames) < 2:
            return 0, 0
        new = self.frames[-1]
        prevs = self.frames[max(0, len(self.frames) - 1 - n_prev):-1]
        if len({kf.desc.shape[0] for kf in prevs} | {new.desc.shape[0]}) != 1:
            return 0, 0
        self.n_fuse_scans += 1
        packed = _fuse_scan(
            self._t(new.Tcw), self._dev(new.desc), self._t(new.uv), self._dev(new.valid),
            self._dev(new.Xw), *self._fuse_inputs(prevs),
            fx, fy, cx, cy, width, height, radius, rel3d, backend=self.match_backend,
        )
        return self.apply_fuse(packed.cpu().numpy(), prevs, new, cull_min_seen=cull_min_seen,
                               cull_ratio=cull_ratio)

    def dispatch_fuse(self, Tcw_new, desc_new, uv_new, valid_new, Xw_new,
                      fx, fy, cx, cy, width, height, n_prev: int = 4,
                      radius: float = 6.0, rel3d: float = 0.02):
        """Dispatch the fuse scan of a keyframe not yet added (device
        tensors) against the newest stored keyframes; returns (device
        result, prevs).  Feed the fetched result to :meth:`apply_fuse` once
        the keyframe is added."""
        prevs = self.frames[-n_prev:]
        if not prevs or len({kf.desc.shape[0] for kf in prevs}
                            | {int(desc_new.shape[0])}) != 1:
            return None, []
        self.n_fuse_scans += 1
        handle = _fuse_scan(Tcw_new, desc_new, uv_new, valid_new, Xw_new,
                            *self._fuse_inputs(prevs), fx, fy, cx, cy, width, height,
                            radius, rel3d, backend=self.match_backend)
        return handle, prevs

    def apply_fuse(self, packed, prevs, new, cull_min_seen: int = 3,
                   cull_ratio: float = 0.25):
        """Host bookkeeping of a fetched fuse scan (see fuse_and_cull)."""
        dup, in_view, idx = packed[0].astype(bool), packed[1].astype(bool), packed[2]
        n_fused = n_culled = 0
        for l, kf in enumerate(prevs):
            d, v, ix = dup[l], in_view[l], idx[l]
            kf.seen = kf.seen + v.astype(np.int32)
            kf.found = kf.found + d.astype(np.int32)
            # the newest copy survives and inherits the observation count
            np.add.at(new.found, ix[d], kf.found[d])
            kf.live = kf.live & ~d
            n_fused += int(d.sum())
            cull = kf.live & (kf.seen >= cull_min_seen) & (kf.found < cull_ratio * kf.seen)
            kf.live = kf.live & ~cull
            kf.bad = kf.bad | cull
            n_culled += int(cull.sum())
        if n_fused or n_culled:
            self._version += 1
        self.n_fused += n_fused
        self.n_culled += n_culled
        return n_fused, n_culled

    def n_live_points(self) -> int:
        """Total live map points across the store."""
        return int(sum((kf.valid & kf.live).sum() for kf in self.frames))

    def cull_redundant(self, overlap: float = 0.9, counts=None) -> int:
        """Drop keyframes ~fully covisible with both neighbours (the 90 %
        redundancy rule), never two adjacent ones in one sweep.  ``counts``:
        precomputed adjacent covisibilities (async cadence).  Returns the
        number culled."""
        K = len(self.frames)
        if K < 3:
            return 0
        if counts is not None:
            c = np.asarray(counts)[: K - 1]
        else:
            stacked = self._stacked_descriptors()
            if stacked is not None:
                c = _adjacent_match_counts(*stacked)[: K - 1].cpu().numpy()
            else:
                c = np.asarray([self.covisibility(k, k + 1) for k in range(K - 1)])
        drop = []
        k = 1
        while k < K - 1:
            n_own = max(int(self.frames[k].valid.sum()), 1)
            if c[k - 1] > overlap * n_own and c[k] > overlap * n_own:
                drop.append(k)
                k += 2   # keep the neighbour: its weights just changed
            else:
                k += 1
        for k in reversed(drop):
            self.frames.pop(k)
        if drop:
            self._version += 1
            self._struct_version += 1
        return len(drop)

    # ------------------------------------------------------------------
    def relocalize(self, sampler: HypothesisSampler, site: tuple, desc: torch.Tensor,
                   uv: torch.Tensor, valid: torch.Tensor, fx, fy, cx, cy,
                   min_inliers: int = 15, max_depth: float = 35.0) -> Optional[np.ndarray]:
        """Recover a camera pose from descriptors alone: the three best
        place-recognition candidates, each matched and solved by RANSAC PnP
        on points within ``max_depth`` of their keyframe's camera (retried
        without the depth gate when it thinned the set)."""
        if not self.frames:
            return None
        scores = self.similarity_scores(desc, valid, exclude_last=0)
        for k in np.argsort(scores)[::-1][:3]:
            kf = self.frames[int(k)]
            res = matching.match_descriptors(desc, self._dev(kf.desc), valid,
                                             self._dev(kf.valid))
            idx_h = res.idx.cpu().numpy()
            Xc_kf = (kf.Tcw[:3, :3] @ kf.Xw[idx_h].T).T + kf.Tcw[:3, 3]
            z = self._t(Xc_kf[:, 2])
            Xw = self._dev(kf.Xw)[res.idx]
            good = res.valid & self._t(~kf.bad[idx_h])
            ok = good & (z > 0) & (z < max_depth)
            sol = pnp.ransac_pnp(Xw, uv, ok, fx, fy, cx, cy, sampler=sampler, site=site)
            if int(sol.n_inliers) >= min_inliers:
                return sol.T.cpu().numpy()
            if int(ok.sum()) < int(good.sum()):
                # near set too thin for PnP: retry without the depth gate,
                # never with geometry-bad points
                sol = pnp.ransac_pnp(Xw, uv, good, fx, fy, cx, cy, sampler=sampler, site=site)
                if int(sol.n_inliers) >= min_inliers:
                    return sol.T.cpu().numpy()
        return None

    # ------------------------------------------------------------------
    def triangulate_between(self, i: int, j: int, fx, fy, cx, cy,
                            max_reproj_px: float = 2.0):
        """New world points from descriptor matches between keyframes i and
        j (DLT), gated on cheirality in both views and on the reprojection
        into i.  Returns (Xw (N, 3), valid (N,)) aligned with i's keypoints."""
        a, b = self.frames[i], self.frames[j]
        res = matching.match_descriptors(self._dev(a.desc), self._dev(b.desc),
                                         self._dev(a.valid), self._dev(b.valid))
        Kmat = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        uv_b = b.uv[res.idx.cpu().numpy()].astype(np.float32)
        X = triangulate(self._t(Kmat @ a.Tcw[:3]), self._t(Kmat @ b.Tcw[:3]),
                        self._t(a.uv), self._t(uv_b)).cpu().numpy()
        Xc1 = (a.Tcw[:3, :3] @ X.T).T + a.Tcw[:3, 3]
        Xc2 = (b.Tcw[:3, :3] @ X.T).T + b.Tcw[:3, 3]
        uv1_hat = cam_g.project(torch.from_numpy(Xc1), fx, fy, cx, cy).numpy()
        err = np.linalg.norm(uv1_hat - a.uv, axis=-1)
        ok = (res.valid.cpu().numpy() & (Xc1[:, 2] > 0) & (Xc2[:, 2] > 0)
              & np.isfinite(X).all(1) & (err < max_reproj_px))
        return X.astype(np.float32), ok

    # ------------------------------------------------------------------
    def close_loop(self, sampler: HypothesisSampler, site: tuple, cur: Keyframe,
                   cand_idx: int,
                   trajectory: np.ndarray,     # (M, 4, 4) Tcw of every frame so far
                   kf_to_traj: List[int],      # trajectory row of each stored keyframe
                   fx, fy, cx, cy, fix_scale: bool = True,
                   info: Optional[dict] = None,
                   max_corr_frac: float = 0.2) -> Tuple[np.ndarray, int]:
        """Sim3-verify the loop between ``cur`` and stored keyframe
        ``cand_idx`` (RANSAC over camera-frame points of the descriptor
        matches, hypotheses from ``sampler`` at ``site``) and correct the
        trajectory with a pose-graph solve: odometry edges plus the loop
        edge weighted by the inlier count, dense Gauss-Newton up to 256
        poses and CG above.

        ``fix_scale=False`` (monocular): the Sim3 scale is distributed
        geometrically over the loop segment's relative translations before
        the SE(3) solve.  ``info`` receives {"scale", "row_scale" (M,)}, and
        "rejected_implausible" when the drift gate refuses: a correction
        beyond max(1 m, ``max_corr_frac`` x the loop's path length).

        Returns (corrected trajectory, n_inliers); n_inliers 0 = rejected."""
        kf = self.frames[cand_idx]
        res = matching.match_descriptors(self._dev(cur.desc), self._dev(kf.desc),
                                         self._dev(cur.valid), self._dev(kf.valid))
        idx_h = res.idx.cpu().numpy()
        # camera-frame points on both sides
        Xc_cur = (cur.Tcw[:3, :3] @ cur.Xw.T).T + cur.Tcw[:3, 3]
        Xc_kf = ((kf.Tcw[:3, :3] @ kf.Xw.T).T + kf.Tcw[:3, 3])[idx_h]
        # both endpoints need trustworthy 3-D
        good = self._t(~kf.bad[idx_h] & ~cur.bad)
        s3 = sim3.ransac_sim3(self._t(Xc_cur.astype(np.float32)),
                              self._t(Xc_kf.astype(np.float32)), res.valid & good,
                              fx, fy, cx, cy, sampler=sampler, site=site,
                              fix_scale=fix_scale)
        n = int(s3.n_inliers)
        if n < 20:
            return trajectory, 0
        M = trajectory.shape[0]
        i_old_row = kf_to_traj[cand_idx]
        row_scale = np.ones(M, np.float64)
        s = float(s3.scale) if not fix_scale else 1.0
        if not fix_scale and np.isfinite(s) and 0.2 < s < 5.0:
            # distribute the drift: each step after the old keyframe's row
            # has its relative translation scaled by s^(1/n_steps), so the
            # cumulative correction at the loop frame is s
            gamma = s ** (1.0 / max(M - 1 - i_old_row, 1))
            rels = [trajectory[i] @ np.linalg.inv(trajectory[i - 1]) for i in range(1, M)]
            trajectory = trajectory.copy()
            c = 1.0
            for i in range(1, M):
                if i > i_old_row:
                    c *= gamma
                    rels[i - 1] = rels[i - 1].copy()
                    rels[i - 1][:3, 3] *= gamma
                row_scale[i] = c
                trajectory[i] = (rels[i - 1] @ trajectory[i - 1]).astype(np.float32)
        if info is not None:
            info["scale"] = s
            info["row_scale"] = row_scale
        # the loop edge: T_rel maps cur-camera to kf-camera points, so the
        # constraint on T_cur T_old^-1 is T_rel^-1
        T_rel = torch.eye(4, dtype=torch.float32, device=self.device)
        T_rel[:3, :3] = s3.R
        T_rel[:3, 3] = s3.t
        traj = self._t(trajectory.astype(np.float32))
        ij_odo, Z_odo = pose_graph.odometry_edges(traj)
        ij = torch.cat([ij_odo, torch.tensor([[M - 1, i_old_row]], dtype=torch.int32,
                                             device=self.device)])
        Z = torch.cat([Z_odo, torch.linalg.inv(T_rel)[None]])
        w = torch.cat([torch.ones(M - 1, device=self.device),
                       torch.tensor([float(n)], device=self.device)])
        # exact dense Gauss-Newton at keyframe scale, matrix-free CG beyond
        solve = pose_graph.optimize_pose_graph if M <= 256 else pose_graph.optimize_pose_graph_cg
        corrected = solve(traj, ij, Z, w).poses.cpu().numpy()
        # drift-plausibility gate: a genuine loop's correction is bounded by
        # the drift accumulated around it; one comparable to the path length
        # is a repetitive-texture false positive whose Sim3 verified
        pos = np.stack([np.linalg.inv(T)[:3, 3] for T in trajectory])
        path = float(np.sum(np.linalg.norm(np.diff(pos[i_old_row:], axis=0), axis=-1)))
        corr_mag = float(np.linalg.norm(np.linalg.inv(corrected[-1])[:3, 3] - pos[-1]))
        if corr_mag > max(1.0, max_corr_frac * path):
            if info is not None:
                info["rejected_implausible"] = corr_mag
            return trajectory, 0
        return corrected, n

    # ------------------------------------------------------------------
    def global_ba(self, fx, fy, cx, cy, bf, loop_pair: Optional[Tuple[int, int]] = None,
                  max_obs: int = 6, iters: int = 25, match_radius_px: float = 20.0,
                  rel3d: float = 0.05,
                  max_corr_m: float = 2.0) -> Optional[Tuple[List[np.ndarray], dict]]:
        """Global bundle adjustment over the keyframe graph, after the
        pose-graph correction and ``correct_poses``.

        Landmark identity comes from descriptor matches between consecutive
        keyframes (and the ``loop_pair``) that pass a reprojection and a
        3-D agreement gate, chained by union-find on the host; chains seen
        by at least two keyframes become landmarks, padded to a multiple of
        1024 with at most ``max_obs`` observations each.  Rejected (None,
        store untouched) with too few keyframes, matches or chains, on a
        non-finite or worse objective, a pose moved by more than
        ``max_corr_m``, or adjacent relative poses rewritten (median > 0.1 m
        or max > 0.5 m).  Otherwise writes the poses back, re-anchors every
        point with its keyframe, gives chain members their optimised
        landmark, and returns (new Tcw per keyframe, stats)."""
        K = len(self.frames)
        if K < 3:
            return None
        pairs = [(i, i + 1) for i in range(K - 1)]
        if loop_pair is not None and abs(loop_pair[0] - loop_pair[1]) > 1:
            pairs.append(tuple(loop_pair))

        # --- correspondence graph over (keyframe, point) nodes ---
        offsets = np.cumsum([0] + [kf.uv.shape[0] for kf in self.frames])
        parent = np.arange(offsets[-1])

        def find(a):
            root = a
            while parent[root] != root:
                root = parent[root]
            while parent[a] != root:
                parent[a], a = root, parent[a]
            return root

        n_edges = 0
        for i, j in pairs:
            a, b = self.frames[i], self.frames[j]
            res = matching.match_descriptors(self._dev(a.desc), self._dev(b.desc),
                                             self._t(a.valid & ~a.bad), self._t(b.valid & ~b.bad))
            idx = res.idx.cpu().numpy()
            ok = res.valid.cpu().numpy()
            # geometric gates: a's point reprojected near b's keypoint, and
            # the two stored world points close (loose: drift remains)
            Xb = (b.Tcw[:3, :3] @ a.Xw.T).T + b.Tcw[:3, 3]
            z = np.maximum(Xb[:, 2], 1e-3)
            u = fx * Xb[:, 0] / z + cx
            v = fy * Xb[:, 1] / z + cy
            duv = np.hypot(u - b.uv[idx][:, 0], v - b.uv[idx][:, 1])
            d3 = np.linalg.norm(a.Xw - b.Xw[idx], axis=-1)
            ok = (ok & (Xb[:, 2] > 0.5) & (duv < match_radius_px)
                  & (d3 < np.maximum(rel3d * z, 0.3)))
            for pt in np.nonzero(ok)[0]:
                ra, rb = find(offsets[i] + pt), find(offsets[j] + idx[pt])
                if ra != rb:
                    parent[rb] = ra
                    n_edges += 1
        if n_edges < 50:
            return None

        # --- chains -> padded observation tables ---
        groups: dict = {}
        for k, kf in enumerate(self.frames):
            for pt in np.nonzero(kf.valid & ~kf.bad)[0]:
                groups.setdefault(find(offsets[k] + pt), []).append((k, int(pt)))
        chains = [m for m in groups.values() if len({k for k, _ in m}) >= 2]
        if len(chains) < 50:
            return None
        L = len(chains)
        L_pad = ((L + 1023) // 1024) * 1024
        obs_kf = np.zeros((L_pad, max_obs), np.int32)
        obs_uv = np.zeros((L_pad, max_obs, 2), np.float32)
        obs_disp = np.full((L_pad, max_obs), bf / 20.0, np.float32)
        obs_w = np.zeros((L_pad, max_obs), np.float32)
        X0 = np.zeros((L_pad, 3), np.float32)
        X0[:, 2] = 20.0
        for l, members in enumerate(chains):
            members = members[:max_obs]
            acc = np.zeros(3)
            for o, (k, pt) in enumerate(members):
                kf = self.frames[k]
                obs_kf[l, o] = k
                obs_uv[l, o] = kf.uv[pt]
                zc = ((kf.Tcw[:3, :3] @ kf.Xw[pt]) + kf.Tcw[:3, 3])[2]
                obs_disp[l, o] = bf / max(zc, 0.5)
                obs_w[l, o] = 1.0
                acc += kf.Xw[pt]
            X0[l] = acc / len(members)

        poses0 = np.stack([kf.Tcw for kf in self.frames]).astype(np.float32)
        out = solve_global_ba(self._t(poses0), self._t(X0), self._t(obs_kf), self._t(obs_uv),
                              self._t(obs_disp), self._t(obs_w), fx, fy, cx, cy, bf,
                              params=GlobalBAParams(iters=iters))
        T_new, X_opt = out.poses.cpu().numpy(), out.X.cpu().numpy()
        chi2_init, chi2 = float(out.chi2_init), float(out.chi2)
        if not np.isfinite(T_new).all() or not np.isfinite(chi2) or chi2 > chi2_init:
            return None
        corr = max(float(np.linalg.norm((T_new[k] @ np.linalg.inv(poses0[k]))[:3, 3]))
                   for k in range(K))
        if corr > max_corr_m:
            return None
        # relative-pose preservation: adjacent odometry is the most reliable
        # constraint; a solution that rewrites it means the chains were wrong
        rel_changes = []
        for k in range(K - 1):
            rel_old = poses0[k + 1] @ np.linalg.inv(poses0[k])
            rel_new = T_new[k + 1] @ np.linalg.inv(T_new[k])
            rel_changes.append(float(np.linalg.norm((rel_new @ np.linalg.inv(rel_old))[:3, 3])))
        if rel_changes and (np.median(rel_changes) > 0.10 or max(rel_changes) > 0.5):
            return None

        # --- write back: poses move, unmatched points ride along, chain
        # members take the jointly optimised landmark ---
        for k, kf in enumerate(self.frames):
            Xc = (kf.Tcw[:3, :3] @ kf.Xw.T).T + kf.Tcw[:3, 3]
            Twc_new = np.linalg.inv(T_new[k])
            kf.Xw = ((Twc_new[:3, :3] @ Xc.T).T + Twc_new[:3, 3]).astype(np.float32)
            kf.Tcw = T_new[k].astype(np.float32)
        for l, members in enumerate(chains):
            for k, pt in members[:max_obs]:
                self.frames[k].Xw[pt] = X_opt[l]
        self._version += 1
        stats = {"n_landmarks": L, "n_edges": n_edges, "chi2_init": chi2_init, "chi2": chi2,
                 "max_corr_m": corr}
        return [kf.Tcw.copy() for kf in self.frames], stats
