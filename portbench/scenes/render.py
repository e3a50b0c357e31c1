"""Frozen numpy copy of the analytic renderer of
``multimot_track_tpu_torch/io/synth.py`` and of its noise models.

The benchmark makes its own inputs: this file imports nothing of the
program, so a change to the program's fixtures cannot change what is
measured or what it is judged against.  ``portbench/tests/test_pb_scenes.py`` holds
the copy to the program's renderer bit for bit at a few frames.

Two changes of form, none of arithmetic: a frame is rendered on its own
(``frame_record``; the program renders a list in one loop, and frame k only
ever needs time k's render and the poses at time k + 1), so the render can
be spread over processes; and frames are ``Frame`` records of this file
with the fields of the program's ``FrameData``.  ``ground_truth`` gives the
reference the exact poses in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

KITTI_SYNTH_CAM = dict(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.8540,
                       bf=387.5744, width=1242, height=375, fps=10.0)


@dataclasses.dataclass
class Frame:
    """One frame's host arrays, field for field the program's FrameData."""

    index: int
    timestamp: float
    gray: np.ndarray          # (H, W) float32 in [0, 255]
    depth_raw: np.ndarray     # (H, W) float32 disparity * 256
    flow: np.ndarray          # (H, W, 2) float32 flow to the next frame
    sem_mask: np.ndarray      # (H, W) int32 instance labels (0 = background)
    pose_gt: np.ndarray       # (4, 4) float32 camera-to-world, frame 0 = identity
    obj_ids_gt: np.ndarray    # (M,) int32
    obj_poses_gt: np.ndarray  # (M, 4, 4) float32 camera-frame object poses
    obj_bboxes_gt: np.ndarray  # (M, 4) float32


def texture(a, b, seed):
    """The program's default texture (``io/synth._texture``)."""
    s = float(seed)
    cell = np.sin(np.floor(a * 2.1) * 12.9898 + np.floor(b * 2.1) * 78.233 + s) * 43758.5453
    cell = cell - np.floor(cell)
    v = (
        0.35 * np.sin(a * 7.3 + s) * np.cos(b * 9.1 - s)
        + 0.25 * np.sin(a * 23.7 - b * 17.3 + 2 * s)
        + 0.4 * (cell - 0.5)
    )
    return np.clip(127.0 + 110.0 * v, 5, 250)


@dataclasses.dataclass
class Mover:
    """A textured body moving rigidly by translation (``io/synth.Mover``)."""

    centre: callable
    half_w: float
    half_h: float
    seed: int
    axes: np.ndarray = None
    t0: float = -1e9
    t1: float = 1e9
    label: int = None
    panels: list = None

    def alive(self, t: float) -> bool:
        return self.t0 <= t < self.t1

    def L_world(self, t: float) -> np.ndarray:
        T = np.eye(4, dtype=np.float64)
        T[:3, 3] = self.centre(t)
        return T


def path_poses(positions):
    """Twc per frame from a position sequence; heading along the tangent."""
    n = len(positions)
    poses = []
    for t in range(n):
        d = positions[min(t + 1, n - 1)] - positions[max(t - 1, 0)]
        yaw = float(np.arctan2(d[0], d[2]))
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        T[:3, 3] = positions[t]
        poses.append(T)
    return poses


def vee_panels(n_dir, half_w, half_h, angle_deg: float = 35.0):
    """Two half-width quads hinged on the vertical through the centre."""
    n = np.asarray(n_dir, np.float64).copy()
    n[1] = 0.0
    n /= max(np.linalg.norm(n), 1e-9)
    out = []
    for s in (+1.0, -1.0):
        a = np.deg2rad(angle_deg) * s
        c, si = np.cos(a), np.sin(a)
        Ry = np.array([[c, 0.0, si], [0.0, 1.0, 0.0], [-si, 0.0, c]])
        n_p = Ry @ n
        e1 = np.array([n_p[2], 0.0, -n_p[0]])
        e2 = np.array([0.0, 1.0, 0.0])
        out.append((np.stack([e1, e2, n_p]), s * (half_w / 2.0) * e1,
                    half_w / 2.0, half_h))
    return out


def render_view(cam, Twc, movers, t, box=False, tex=texture):
    """Analytic z-buffer render (``io/synth._render_frame``): gray, depth in
    metres, instance labels."""
    W, H = cam["width"], cam["height"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], -1)
    R, c0 = Twc[:3, :3], Twc[:3, 3]
    d_w = d_cam @ R.T
    o_w = c0

    GROUND_Y = 1.5

    def plane_hit(n, d0):
        denom = d_w @ np.asarray(n, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = (d0 - float(np.dot(n, o_w))) / denom
        return np.where((tt > 0.5) & np.isfinite(tt), tt, np.inf)

    t_g = plane_hit((0.0, 1.0, 0.0), GROUND_Y)
    if box:
        x0, x1, z0, z1 = box
        walls = [((0.0, 0.0, 1.0), z1, 29), ((0.0, 0.0, 1.0), z0, 31),
                 ((1.0, 0.0, 0.0), x1, 37), ((1.0, 0.0, 0.0), x0, 41)]
    else:
        walls = [((0.0, 0.0, 1.0), 40.0, 29)]
    t_bg = t_g
    sid = np.zeros(t_g.shape, np.int32)
    for w_i, (n, d0, _) in enumerate(walls, start=1):
        t_w = plane_hit(n, d0)
        closer = t_w < t_bg
        t_bg = np.where(closer, t_w, t_bg)
        sid = np.where(closer, w_i, sid)
    X_bg = o_w + t_bg[..., None] * d_w
    gray = tex(X_bg[..., 0], X_bg[..., 2], 11)
    for w_i, (n, d0, seed) in enumerate(walls, start=1):
        a_w = X_bg[..., 0] + X_bg[..., 2]
        gray = np.where(sid == w_i, tex(a_w, X_bg[..., 1] * 3.0, seed), gray)
    t_buf = t_bg.copy()
    label = np.zeros((H, W), np.int32)

    for k, mv in enumerate(movers, start=1):
        if not mv.alive(t):
            continue
        k = mv.label if mv.label is not None else k
        cen = mv.centre(t)
        if mv.panels is not None:
            panels = mv.panels
        elif mv.axes is None:
            panels = [(np.eye(3), np.zeros(3), mv.half_w, mv.half_h)]
        else:
            panels = [(np.asarray(mv.axes, np.float64), np.zeros(3), mv.half_w, mv.half_h)]
        for p_i, (axes_p, off_p, hw, hh) in enumerate(panels):
            e1, e2, n = np.asarray(axes_p, np.float64)
            cen_p = cen + np.asarray(off_p, np.float64)
            denom = d_w @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                tq = float(np.dot(n, cen_p - o_w)) / denom
            Xq = o_w + tq[..., None] * d_w
            a = (Xq - cen_p) @ e1
            b = (Xq - cen_p) @ e2
            hit = ((tq > 0.5) & np.isfinite(tq) & (tq < t_buf)
                   & (np.abs(a) < hw) & (np.abs(b) < hh))
            t_buf = np.where(hit, tq, t_buf)
            label = np.where(hit, k, label)
            gray = np.where(hit, tex(a * 9.0, b * 9.0, 100 + mv.seed + 7 * p_i), gray)
    return gray, t_buf, label


def frame_record(cam, Twc_at, movers, times, k, box=False, tex=texture) -> Frame:
    """Frame k of a drive rendered at ``times`` (``io/synth._build_frames``'
    body for one frame): exact depth, dense forward flow to ``times[k + 1]``,
    instance masks, ego pose and camera-frame object poses, the world
    anchored at ``times[0]``."""
    W, H = cam["width"], cam["height"]
    fx, fy, cx, cy, bf = cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["bf"]
    t = times[k]
    gray, depth_m, label = render_view(cam, Twc_at(t), movers, t, box=box, tex=tex)
    G0 = np.linalg.inv(Twc_at(times[0]))
    Twc = Twc_at(t)
    flow = np.zeros((H, W, 2), np.float32)
    if k + 1 < len(times):
        t1 = times[k + 1]
        us, vs = np.meshgrid(np.arange(W), np.arange(H))
        d_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], -1)
        X_cam = d_cam * depth_m[..., None]
        R, c0 = Twc[:3, :3], Twc[:3, 3]
        X_w = X_cam @ R.T + c0
        X_w1 = X_w.copy()
        for j, mv in enumerate(movers, start=1):
            if not mv.alive(t):
                continue
            j = mv.label if mv.label is not None else j
            step = mv.centre(t1) - mv.centre(t)
            X_w1 = np.where((label == j)[..., None], X_w + step, X_w1)
        Tcw1 = np.linalg.inv(Twc_at(t1))
        X_c1 = X_w1 @ Tcw1[:3, :3].T + Tcw1[:3, 3]
        u1 = fx * X_c1[..., 0] / X_c1[..., 2] + cx
        v1 = fy * X_c1[..., 1] / X_c1[..., 2] + cy
        flow = np.stack([u1 - us, v1 - vs], -1).astype(np.float32)

    ids, Ls, bbs = [], [], []
    for j, mv in enumerate(movers, start=1):
        if not mv.alive(t):
            continue
        j = mv.label if mv.label is not None else j
        m = label == j
        if m.sum() == 0:
            continue
        ids.append(j)
        Ls.append((np.linalg.inv(Twc) @ mv.L_world(t)).astype(np.float32))
        xs_k = np.where(m.any(0))[0]
        ys_k = np.where(m.any(1))[0]
        bbs.append([xs_k.min(), ys_k.min(), xs_k.max(), ys_k.max()])
    return Frame(
        index=k,
        gray=gray.astype(np.float32),
        depth_raw=(bf * 256.0 / np.maximum(depth_m, 0.5)).astype(np.float32),
        flow=flow,
        sem_mask=label,
        pose_gt=(G0 @ Twc).astype(np.float32),
        obj_ids_gt=np.asarray(ids, np.int32),
        obj_poses_gt=np.stack(Ls) if Ls else np.zeros((0, 4, 4), np.float32),
        obj_bboxes_gt=(np.asarray(bbs, np.float32) if bbs
                       else np.zeros((0, 4), np.float32)),
        timestamp=t * 0.1,
    )


def ground_truth(Twc_at, movers, times):
    """The reference's truth in float64: Twc of every frame anchored at
    ``times[0]``, and for every frame {label: camera-frame object pose}
    of each mover alive then."""
    G0 = np.linalg.inv(Twc_at(times[0]))
    Twc = np.stack([G0 @ Twc_at(t) for t in times])
    objs = []
    for t in times:
        Tcw = np.linalg.inv(Twc_at(t))
        objs.append({(mv.label if mv.label is not None else j): Tcw @ mv.L_world(t)
                     for j, mv in enumerate(movers, start=1) if mv.alive(t)})
    return Twc, objs


# ---------------------------------------------------------------------------
# The reference system's noise models (``io/synth.degrade_frames``)

def erode_labels(label: np.ndarray, r: int) -> np.ndarray:
    """Per-label erosion by a (2r+1)-square; eroded pixels become static."""
    if r <= 0:
        return label
    keep = np.ones_like(label, bool)
    H, W = label.shape
    pad = np.pad(label, r, mode="edge")
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            keep &= pad[r + dy:r + dy + H, r + dx:r + dx + W] == label
    out = label.copy()
    out[(label > 0) & ~keep] = 0
    return out


def degrade_frames(frames, seed=0, depth_noise_scale=0.15, flow_sigma=0.3,
                   flow_outlier_every=35, flow_outlier_sigma=4.0, mask_erode_px=2,
                   gray_sigma=2.0, bf=None):
    """Depth noise sigma = z^2 / (725 * 0.5) * scale (src/Frame.cc:1089),
    dense flow noise plus gross outliers at 1 / ``flow_outlier_every``
    (src/Frame.cc:276-301), masks eroded by ``mask_erode_px``, intensity
    noise; the truth stays exact.  ``seed`` is anything
    ``np.random.default_rng`` takes."""
    rng = np.random.default_rng(seed)
    out = []
    for fd in frames:
        depth_raw = fd.depth_raw
        if depth_noise_scale > 0:
            bf256 = 256.0 * (bf if bf is not None else KITTI_SYNTH_CAM["bf"])
            with np.errstate(divide="ignore"):
                z_m = np.where(depth_raw > 1e-6, bf256 / depth_raw, 0.0)
            sigma = z_m * z_m / (725.0 * 0.5) * depth_noise_scale
            z_noisy = np.maximum(z_m + rng.normal(0.0, 1.0, z_m.shape) * sigma, 0.5)
            depth_raw = np.where(depth_raw > 1e-6, bf256 / z_noisy, depth_raw).astype(np.float32)
        flow = fd.flow
        if flow_sigma > 0 or flow_outlier_every:
            flow = flow + rng.normal(0.0, flow_sigma, flow.shape).astype(np.float32)
            if flow_outlier_every:
                m = rng.random(flow.shape[:2]) < (1.0 / flow_outlier_every)
                flow = np.where(
                    m[..., None],
                    flow + rng.normal(0.0, flow_outlier_sigma, flow.shape).astype(np.float32),
                    flow,
                )
        gray = fd.gray
        if gray_sigma > 0:
            gray = np.clip(gray + rng.normal(0.0, gray_sigma, gray.shape), 0, 255).astype(
                np.float32)
        out.append(dataclasses.replace(
            fd, gray=gray, depth_raw=depth_raw, flow=flow.astype(np.float32),
            sem_mask=erode_labels(fd.sem_mask, mask_erode_px),
        ))
    return out


@dataclasses.dataclass
class Scene:
    """A drive: the camera, the ego path, the movers, the times rendered."""

    cam: dict
    Twc_at: callable
    movers: list
    times: list
    box: tuple = False

    def frame(self, k: int) -> Frame:
        return frame_record(self.cam, self.Twc_at, self.movers, self.times, k, box=self.box)

    def truth(self):
        return ground_truth(self.Twc_at, self.movers, self.times)
