"""Synthetic sequence construction (test/dev fixtures).

A numpy copy of the in-memory renderers of ``multimot_track_tpu.io.synth``
(that package imports jax at import time), of its stereo-tree writer
``write_stereo_tree``, which writes its PNGs through ``io/png.write_png``
instead of PIL, and of ``build`` (a forward and reversed replay of a
KITTI directory); and writers of its own,
``write_kitti_tree``, ``write_tum_tree`` and ``write_euroc_tree``, that
put rendered frames on disk in the layouts the sequence readers take.
``make_circuit_frames`` and ``make_avenue_frames`` take ``times=`` (as the
junction does): they render only those frames of the full scene, so
frames k..k+n of the 220-frame lap cost n renders.
tests/test_torch_geometry.py pins the rendered arrays, the stereo tree and
``build``'s output to the original bit for bit.

``make_multimover_frames`` renders a fully-synthetic multi-object scene
(kitti_sample has ONE ground-truth mover; the reference's label-switch
tables handle ~12, src/Tracking.cc:704-748): textured ground+wall
background, K planar movers with exact analytic depth / dense flow /
instance masks / GT ego and object poses — crossing paths, an occlusion,
and birth/death included.  This is the multi-object stress fixture."""

from __future__ import annotations

import dataclasses
import pathlib
import shutil

import numpy as np


def build(src, dst, include_objects: bool = False, order=None):
    """``order`` — explicit source-frame index sequence; default is one
    forward + one reversed pass.  Longer shuttle patterns (fwd-rev-fwd-…)
    make marathon fixtures with repeated revisits."""
    src = pathlib.Path(src)
    dst = pathlib.Path(dst)
    if dst.exists():
        shutil.rmtree(dst)
    (dst / "image").mkdir(parents=True)
    (dst / "depth").mkdir()
    (dst / "semantic").mkdir()

    n = len(list((src / "image").glob("*.png")))
    if order is None:
        order = list(range(n)) + list(range(n - 2, -1, -1))

    for out_i, in_i in enumerate(order):
        for sub, ext in (("image", "png"), ("depth", "png"), ("semantic", "txt")):
            s = src / sub / f"{in_i:06d}.{ext}"
            d = dst / sub / f"{out_i:06d}.{ext}"
            try:
                d.symlink_to(s)
            except OSError:
                shutil.copy(s, d)

    poses = {}
    for line in (src / "pose_gt.txt").read_text().splitlines():
        parts = line.split()
        if parts:
            poses[int(float(parts[0]))] = parts[1:]
    with open(dst / "pose_gt.txt", "w") as f:
        for out_i, in_i in enumerate(order):
            if in_i in poses:
                f.write(f"{out_i} " + " ".join(poses[in_i]) + "\n")

    with open(dst / "times.txt", "w") as f:
        for out_i in range(len(order)):
            f.write(f"{out_i * 0.1:.6e}\n")

    if include_objects and (src / "object_pose.txt").exists():
        rows = {}
        for line in (src / "object_pose.txt").read_text().splitlines():
            parts = line.split()
            if parts:
                rows.setdefault(int(float(parts[0])), []).append(parts[1:])
        with open(dst / "object_pose.txt", "w") as f:
            for out_i, in_i in enumerate(order):
                for r in rows.get(in_i, []):
                    f.write(f"{out_i} " + " ".join(r) + "\n")
    return len(order)


# ---------------------------------------------------------------------------
# Multi-object analytic scene renderer

SYNTH_CAM = dict(fx=460.0, fy=460.0, cx=320.0, cy=192.0, bf=138.0,
                 width=640, height=384, fps=10.0)


def synth_camera_config():
    from multimot_track_tpu_torch.config import CameraConfig

    return CameraConfig(**SYNTH_CAM)


def _texture(a, b, seed):
    """Deterministic viewpoint-consistent texture over surface coords
    (a, b): multi-frequency sinusoids + a per-cell pseudo-random level —
    enough gradient structure for FAST/ZNCC everywhere."""
    s = float(seed)
    cell = np.sin(np.floor(a * 2.1) * 12.9898 + np.floor(b * 2.1) * 78.233 + s) * 43758.5453
    cell = cell - np.floor(cell)
    v = (
        0.35 * np.sin(a * 7.3 + s) * np.cos(b * 9.1 - s)
        + 0.25 * np.sin(a * 23.7 - b * 17.3 + 2 * s)
        + 0.4 * (cell - 0.5)
    )
    return np.clip(127.0 + 110.0 * v, 5, 250)


def _texture_distinct(a, b, seed):
    """Locally DISTINCTIVE texture for descriptor-based matching: two
    scales of hashed random blocks — every neighbourhood is a unique
    pattern, unlike ``_texture`` whose dominant sinusoids repeat and
    alias BRIEF descriptors across the image (measured: 55/768 mutual
    matches frame-to-frame vs 400+ here).  Mono/ORB evaluation renders
    use this; the RGB-D fixtures keep ``_texture`` (their dense-flow +
    ZNCC path does not need descriptor uniqueness, and their test
    thresholds are calibrated on it)."""
    s = float(seed)
    v = np.zeros_like(np.asarray(a, np.float64))
    for k, scale in ((1.0, 1.3), (2.0, 3.3)):
        cell = np.sin(
            np.floor(a * scale) * 12.9898
            + np.floor(b * scale) * 78.233
            + s * 91.7 + k * 269.5
        ) * 43758.5453
        v += (cell - np.floor(cell)) - 0.5
    return np.clip(127.0 + 150.0 * v, 5, 250)


_TEXTURES = {"default": _texture, "distinct": _texture_distinct}


@dataclasses.dataclass
class Mover:
    """A textured planar quad moving rigidly by translation.

    ``centre(t)`` -> (3,) world position of the quad centre at frame t;
    the quad's local axes stay FIXED in world (pure translation is what
    the scene-flow classifier keys on, src/Tracking.cc:1463).  ``axes``
    is the optional (3, 3) row-stack (e1, e2, n): e1/e2 span the quad,
    n is its plane normal — None keeps the original world-aligned
    fronto-parallel quad (n = +z).  ``t0``/``t1`` bound the lifespan
    (birth/death); the quad only renders inside [t0, t1)."""

    centre: callable
    half_w: float
    half_h: float
    seed: int
    axes: np.ndarray = None
    t0: float = -1e9
    t1: float = 1e9
    # instance-mask label; None = the mover's 1-based position in the
    # list.  Long sequences recycle labels across non-overlapping
    # lifespans (the KITTI masks clamp to few labels the same way,
    # rgbd_tum.cc:335) — overlapping-lifespan movers need distinct labels.
    label: int = None
    # multi-panel body: list of (axes (3,3), offset (3,), half_w, half_h)
    # quads rendered under the same label/motion.  A single fronto-
    # parallel plane puts every member point at ONE depth — a degenerate
    # geometry where the 6-DoF motion solve trades rotation against
    # translation; real vehicles have depth structure.  None = the single
    # quad defined by axes/half_w/half_h above.
    panels: list = None

    def alive(self, t: float) -> bool:
        return self.t0 <= t < self.t1

    def L_world(self, t: float) -> np.ndarray:
        T = np.eye(4, dtype=np.float64)
        T[:3, 3] = self.centre(t)
        return T


# world-box scene bounds for long sequences (4 textured walls + ground);
# None = the original ground + single back-wall scene
BOX_HALF = 60.0


def _render_frame(cam, Twc, movers, t, box: bool = False, texture=None):
    """Analytic z-buffer render.  Returns (gray, depth_m, label, info)
    where info[y, x] = (surface id, local a, local b) for flow lookup.

    ``box=True`` encloses the scene in 4 textured walls at +-BOX_HALF so
    arbitrary ego headings (turns, full loops) always see textured
    background; the default keeps the original ground + back-wall scene."""
    texture = _texture if texture is None else texture
    W, H = cam["width"], cam["height"]
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    # ray in world coords
    d_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], -1)
    R, c0 = Twc[:3, :3], Twc[:3, 3]
    d_w = d_cam @ R.T
    o_w = c0

    GROUND_Y = 1.5

    def plane_hit(n, d0):
        """Intersect rays with plane n . X = d0; returns ray parameter."""
        denom = d_w @ np.asarray(n, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = (d0 - float(np.dot(n, o_w))) / denom
        return np.where((tt > 0.5) & np.isfinite(tt), tt, np.inf)

    # ground plane y = GROUND_Y (y grows downward)
    t_g = plane_hit((0.0, 1.0, 0.0), GROUND_Y)
    if box:
        x0, x1, z0, z1 = (
            (-BOX_HALF, BOX_HALF, -BOX_HALF, BOX_HALF)
            if box is True else box
        )
        walls = [
            ((0.0, 0.0, 1.0), z1, 29),    # z = z_max
            ((0.0, 0.0, 1.0), z0, 31),    # z = z_min
            ((1.0, 0.0, 0.0), x1, 37),    # x = x_max
            ((1.0, 0.0, 0.0), x0, 41),    # x = x_min
        ]
    else:
        walls = [((0.0, 0.0, 1.0), 40.0, 29)]
    t_bg = t_g
    sid = np.zeros(t_g.shape, np.int32)          # 0 = ground
    for w_i, (n, d0, _) in enumerate(walls, start=1):
        t_w = plane_hit(n, d0)
        closer = t_w < t_bg
        t_bg = np.where(closer, t_w, t_bg)
        sid = np.where(closer, w_i, sid)
    X_bg = o_w + t_bg[..., None] * d_w
    gray = texture(X_bg[..., 0], X_bg[..., 2], 11)  # ground texture
    for w_i, (n, d0, seed) in enumerate(walls, start=1):
        a_w = X_bg[..., 0] + X_bg[..., 2]            # along-wall coordinate
        gray = np.where(
            sid == w_i, texture(a_w, X_bg[..., 1] * 3.0, seed), gray
        )
    t_buf = t_bg.copy()
    label = np.zeros((H, W), np.int32)
    a_loc = X_bg[..., 0].copy()
    b_loc = X_bg[..., 2].copy()

    for k, mv in enumerate(movers, start=1):
        if not mv.alive(t):
            continue
        k = mv.label if mv.label is not None else k
        cen = mv.centre(t)
        if mv.panels is not None:
            panels = mv.panels
        elif mv.axes is None:
            panels = [(
                np.stack([np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                          np.array([0, 0, 1.0])]),
                np.zeros(3), mv.half_w, mv.half_h,
            )]
        else:
            panels = [(np.asarray(mv.axes, np.float64), np.zeros(3),
                       mv.half_w, mv.half_h)]
        for p_i, (axes_p, off_p, hw, hh) in enumerate(panels):
            e1, e2, n = np.asarray(axes_p, np.float64)
            cen_p = cen + np.asarray(off_p, np.float64)
            denom = d_w @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                tq = float(np.dot(n, cen_p - o_w)) / denom
            Xq = o_w + tq[..., None] * d_w
            a = (Xq - cen_p) @ e1
            b = (Xq - cen_p) @ e2
            hit = (
                (tq > 0.5) & np.isfinite(tq) & (tq < t_buf)
                & (np.abs(a) < hw) & (np.abs(b) < hh)
            )
            t_buf = np.where(hit, tq, t_buf)
            label = np.where(hit, k, label)
            a_loc = np.where(hit, a, a_loc)
            b_loc = np.where(hit, b, b_loc)
            gray = np.where(
                hit, texture(a * 9.0, b * 9.0, 100 + mv.seed + 7 * p_i), gray
            )

    # depth = z-coordinate in CAMERA frame: t_buf is the parameter along
    # d_w whose CAMERA-frame direction has z-component exactly 1 (rays are
    # built as (x/fx, y/fy, 1)), so depth == t_buf for any world rotation
    depth_m = t_buf
    return gray, depth_m, label, (a_loc, b_loc)


def make_multimover_frames(movers=None, n_frames: int = 8, cam=None,
                           ego_step: float = 0.3):
    """Render a multi-mover sequence; returns the FrameData list.

    frames are io.kitti.FrameData records (in-memory, no disk) with exact
    analytic depth, dense forward flow, instance masks, GT ego pose and
    GT camera-frame object poses."""
    if movers is None:
        movers = default_movers()

    def Twc_at(t):
        T = np.eye(4, dtype=np.float64)
        T[2, 3] = ego_step * t       # forward along +z
        return T

    return _build_frames(cam or dict(SYNTH_CAM), Twc_at, movers, n_frames,
                         box=False)


def _build_frames(cam, Twc_at, movers, n_frames, box: bool, texture=None, times=None):
    """Shared renderer loop: analytic frames with exact depth / dense
    forward flow / instance masks / GT ego + camera-frame object poses.

    The EMITTED ground-truth world is re-anchored at frame 0 (first
    camera = identity) — the reference convention every KITTI sequence
    follows, and the frame the live system estimates in.  Without this,
    world-frame motion comparisons (H vs H_gt) are conjugated by the
    first pose's rotation: a circuit starting with a 90-deg heading
    rotates every GT object translation by 90 deg relative to the
    estimate.  Rendering still uses the generator's raw world.

    ``times``: the generator times to render (default ``range(n_frames)``);
    frame k is time ``times[k]``, its flow runs to ``times[k + 1]`` and the
    world is anchored at ``times[0]``."""
    from multimot_track_tpu_torch.io.frame import FrameData

    W, H = cam["width"], cam["height"]
    fx, fy, cx, cy, bf = cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["bf"]
    times = list(range(n_frames)) if times is None else list(times)
    rendered = [
        _render_frame(cam, Twc_at(t), movers, t, box=box, texture=texture)
        for t in times
    ]
    G0 = np.linalg.inv(Twc_at(times[0]))   # gt-world -> frame-0-anchored world
    frames = []
    for k_frame, t in enumerate(times):
        gray, depth_m, label, (a_loc, b_loc) = rendered[k_frame]
        Twc = Twc_at(t)
        # dense forward flow to the next rendered time from the exact
        # surface correspondence
        flow = np.zeros((H, W, 2), np.float32)
        if k_frame + 1 < len(times):
            t1 = times[k_frame + 1]
            us, vs = np.meshgrid(np.arange(W), np.arange(H))
            d_cam = np.stack(
                [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], -1
            )
            X_cam = d_cam * depth_m[..., None]
            R, c0 = Twc[:3, :3], Twc[:3, 3]
            X_w = X_cam @ R.T + c0
            X_w1 = X_w.copy()
            for k, mv in enumerate(movers, start=1):
                if not mv.alive(t):
                    continue
                k = mv.label if mv.label is not None else k
                step = mv.centre(t1) - mv.centre(t)   # pure translation
                X_w1 = np.where((label == k)[..., None], X_w + step, X_w1)
            Twc1 = Twc_at(t1)
            Tcw1 = np.linalg.inv(Twc1)
            X_c1 = X_w1 @ Tcw1[:3, :3].T + Tcw1[:3, 3]
            u1 = fx * X_c1[..., 0] / X_c1[..., 2] + cx
            v1 = fy * X_c1[..., 1] / X_c1[..., 2] + cy
            flow = np.stack([u1 - us, v1 - vs], -1).astype(np.float32)

        ids, Ls, bbs = [], [], []
        for k, mv in enumerate(movers, start=1):
            if not mv.alive(t):
                continue
            k = mv.label if mv.label is not None else k
            m = label == k
            if m.sum() == 0:
                continue
            L_cam = np.linalg.inv(Twc) @ mv.L_world(t)   # camera-frame pose
            ids.append(k)
            Ls.append(L_cam.astype(np.float32))
            xs_k = np.where(m.any(0))[0]
            ys_k = np.where(m.any(1))[0]
            bbs.append([xs_k.min(), ys_k.min(), xs_k.max(), ys_k.max()])
        frames.append(
            FrameData(
                index=k_frame,
                gray=gray.astype(np.float32),
                depth_raw=(bf * 256.0 / np.maximum(depth_m, 0.5)).astype(np.float32),
                flow=flow,
                sem_mask=label,
                pose_gt=(G0 @ Twc).astype(np.float32),
                obj_ids_gt=np.asarray(ids, np.int32),
                obj_poses_gt=(
                    np.stack(Ls) if Ls else np.zeros((0, 4, 4), np.float32)
                ),
                obj_bboxes_gt=(
                    np.asarray(bbs, np.float32) if bbs else np.zeros((0, 4), np.float32)
                ),
                timestamp=t * 0.1,
            )
        )
    return frames


def default_movers():
    """Six movers: crossing pair, an occlusion, birth, death, slow lane."""
    return [
        # 1: crosses left -> right at z=9 (crosses mover 2's path)
        Mover(lambda t: np.array([-4.0 + 0.9 * t, 0.2, 9.0]), 1.1, 0.8, 1),
        # 2: crosses right -> left at z=13 (occluded by 1 mid-sequence)
        Mover(lambda t: np.array([4.0 - 0.9 * t, 0.1, 13.0]), 1.2, 0.9, 2),
        # 3: drives away in the right lane
        Mover(lambda t: np.array([2.5, 0.3, 6.0 + 0.8 * t]), 1.0, 0.7, 3),
        # 4: birth — enters the view from the left around frame 3
        Mover(lambda t: np.array([-11.0 + 1.4 * t, 0.0, 10.0]), 1.0, 0.8, 4),
        # 5: death — exits right around frame 4
        Mover(lambda t: np.array([3.0 + 1.1 * t, -0.2, 8.0]), 0.9, 0.7, 5),
        # 6: slow mover in the left lane toward the camera
        Mover(lambda t: np.array([-2.6, 0.4, 16.0 - 0.6 * t]), 1.1, 0.8, 6),
    ]


# ---------------------------------------------------------------------------
# Long multi-scene sequences (reference-scale evaluation: the reference
# RGB-D example tracks arbitrary-length KITTI sequences,
# Examples/RGB-D/rgbd_tum.cc:115-189, and BASELINE.md targets name the
# full KITTI tracking benchmark).  Both scenes render at EXACTLY the
# kitti03.yaml camera so every device program compiled for kitti_sample
# is reused verbatim.

KITTI_SYNTH_CAM = dict(fx=721.5377, fy=721.5377, cx=609.5593, cy=172.8540,
                       bf=387.5744, width=1242, height=375, fps=10.0)


def _path_poses(positions):
    """Twc per frame from a smooth position sequence; heading follows the
    path tangent (yaw about y only — a ground vehicle)."""
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


def _facing_axes(n_dir):
    """Quad axes (e1 horizontal, e2 = +y, n) for a plane facing ``n_dir``."""
    n = np.asarray(n_dir, np.float64).copy()
    n[1] = 0.0
    n /= max(np.linalg.norm(n), 1e-9)
    e1 = np.array([n[2], 0.0, -n[0]])
    e2 = np.array([0.0, 1.0, 0.0])
    return np.stack([e1, e2, n])


def vee_panels(n_dir, half_w, half_h, angle_deg: float = 35.0):
    """Two half-width quads hinged along the vertical line through the
    mover centre, each yawed +-angle_deg from the facing direction — a
    'vehicle corner' body.  The across-face depth variation
    (half_w * sin(angle)) conditions the 6-DoF motion solve: a single
    fronto-parallel plane puts every point at one depth, where rotation
    and translation trade off freely (measured ~20%% t-RPE on the flat
    lead-car quad vs <10%% with structure)."""
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


def make_circuit_frames(n_frames: int = 220, radius: float = 28.0,
                        cam=None, overlap: float = 0.12,
                        texture: str = "default", times=None):
    """Closed circular circuit with a genuine revisit (loop-closure proof
    at scale): the ego drives one full lap + ``overlap`` (default 12%), so the tail
    re-observes the head's scenery from the same poses.  Continuous
    turning (full 360 deg of yaw), a lead vehicle (as 4 lifespan segments
    so each fixed-orientation quad stays near face-on), oncoming traffic
    on the inner ring and radial crossers — 9 mover lifespans, <= 5
    concurrent.  ``times`` renders only those of the ``n_frames`` times
    (see ``_build_frames``: the ground truth is anchored at ``times[0]``,
    and the last rendered frame's flow is zero)."""
    cam = dict(KITTI_SYNTH_CAM) if cam is None else cam
    # ``overlap``: lap fraction re-driven past the start — sets how many
    # keyframes re-observe the head (the loop-consistency gate needs
    # several consecutive revisit detections)
    w = 2.0 * np.pi * (1.0 + overlap) / n_frames   # rad/frame
    th = lambda t: w * t

    def on_circle(r, theta):
        return np.array([r * np.sin(theta), 0.15, -r * np.cos(theta)])

    positions = [
        on_circle(radius, th(t)) - np.array([0.0, 0.15, 0.0])
        for t in range(n_frames)
    ]

    def tangent(theta):
        return np.array([np.cos(theta), 0.0, np.sin(theta)])

    movers = []
    # lead vehicle: 0.35 rad (~10 m) ahead at the ego's angular speed, in
    # 4 orientation segments (ONE physical vehicle -> one label; only the
    # fixed quad orientation refreshes between segments)
    seg = n_frames // 4
    for s in range(4):
        mid = th((s + 0.5) * seg + 0.35 / w)
        movers.append(Mover(
            centre=lambda t, r=radius - 0.5: on_circle(r, th(t) + 0.35),
            half_w=1.1, half_h=0.8, seed=10 + s,
            panels=vee_panels(-tangent(mid), 1.1, 0.8),
            t0=s * seg, t1=min((s + 1) * seg, n_frames), label=1,
        ))
    # oncoming traffic on the inner ring (opposite direction), staggered;
    # lifespans can overlap pairwise -> distinct labels
    for i, phi0 in enumerate((1.2, 2.6, 4.2)):
        w_m = -1.3 * w
        t_meet = phi0 / (w - w_m)      # ego meets it around this frame
        mid = th(t_meet) + 0.0
        movers.append(Mover(
            centre=lambda t, p=phi0, wm=w_m: on_circle(radius - 4.0, p + wm * t),
            half_w=1.0, half_h=0.75, seed=20 + i,
            panels=vee_panels(tangent(mid), 1.0, 0.75),
            t0=max(0, t_meet - 30), t1=min(n_frames, t_meet + 18),
            label=2 + i,
        ))
    # radial crossers at fixed stations, timed to the ego's arrival
    for i, frac in enumerate((0.3, 0.62, 0.85)):
        t_arr = frac * n_frames
        station = th(t_arr + 12)
        movers.append(Mover(
            centre=lambda t, s=station, ta=t_arr: (
                on_circle(radius + 6.0 - 0.45 * (t - (ta - 15)), s)
            ),
            half_w=0.9, half_h=0.8, seed=30 + i,
            axes=_facing_axes(-tangent(station)),
            t0=t_arr - 15, t1=t_arr + 25, label=5 + i,
        ))
    b = radius + 25.0
    poses = _path_poses(positions)
    return _build_frames(cam, lambda t: poses[t], movers,
                         n_frames, box=(-b, b, -b - 2.0, b + 2.0),
                         texture=_TEXTURES[texture], times=times)


def make_avenue_frames(n_frames: int = 240, cam=None,
                       texture: str = "default", times=None):
    """Long straight-ish avenue with S-curves: 180 m of travel, lead +
    oncoming + crossing traffic — 10 mover lifespans, <= 6 concurrent.
    Exercises sustained forward odometry with heading changes and
    repeated mover birth/death at KITTI resolution.  ``times``: as in
    ``make_circuit_frames``."""
    cam = dict(KITTI_SYNTH_CAM) if cam is None else cam
    v = 0.75
    amp, period = 2.5, 120.0
    positions = [
        np.array([amp * np.sin(2 * np.pi * t / period), 0.0, v * t])
        for t in range(n_frames)
    ]

    movers = [
        # lead vehicle in the right lane, same direction, slightly slower —
        # stays 8-20 m ahead for the whole run
        Mover(
            centre=lambda t: np.array([2.2, 0.25, 12.0 + 0.72 * t]),
            half_w=1.1, half_h=0.8, seed=50,
            panels=vee_panels((0.0, 0.0, -1.0), 1.1, 0.8), label=1,
        )
    ]
    # oncoming traffic in the left lane, staggered down the avenue
    for i in range(4):
        z0 = 55.0 + 62.0 * i
        t_meet = z0 / (v + 0.95)
        movers.append(Mover(
            centre=lambda t, z=z0: np.array([-2.8, 0.2, z - 0.95 * t]),
            half_w=1.0, half_h=0.75, seed=60 + i,
            panels=vee_panels((0.0, 0.0, 1.0), 1.0, 0.75),
            t0=max(0.0, t_meet - 32), t1=t_meet + 6, label=2 + i % 2,
        ))
    # crossers at stations along the road (left -> right), timed to ego
    for i in range(4):
        z_st = 45.0 + 48.0 * i
        t_arr = (z_st - 12.0) / v
        movers.append(Mover(
            centre=lambda t, z=z_st, ta=t_arr: np.array(
                [-9.0 + 0.55 * (t - (ta - 10)), 0.3, z]
            ),
            half_w=0.9, half_h=0.8, seed=70 + i,
            axes=_facing_axes((0.0, 0.0, -1.0)),
            t0=t_arr - 10, t1=t_arr + 28, label=4 + i % 2,
        ))
    poses = _path_poses(positions)
    return _build_frames(
        cam, lambda t: poses[t], movers, n_frames,
        box=(-40.0, 40.0, -20.0, v * n_frames + 60.0),
        texture=_TEXTURES[texture], times=times,
    )


def make_junction_frames(n_frames: int = 60, cam=None, n_concurrent: int = 8,
                         texture: str = "default", times=None):
    """Dense-traffic junction approach: ``n_concurrent`` movers with
    DISTINCT labels all alive simultaneously for (nearly) the whole scene
    — the k_obj_solve stress fixture.  The reference's association tables
    size for ~12 concurrent objects (src/Tracking.cc:704-748) and it
    solves every detected object each frame (src/Tracking.cc:1658-2253);
    this scene measures what a top-K solve batch costs in accuracy and ID
    stability when K < concurrent movers.

    Ego creeps forward at 0.45 m/s toward a junction with a lead vehicle,
    two oncoming cars and four crossers at staggered depth stations, all
    in view together.  ``times`` renders only those of the ``n_frames``
    times (``range(0, 43, 6)``: the monocular fixture, 2.7 m apart)."""
    cam = dict(KITTI_SYNTH_CAM) if cam is None else cam
    v = 0.45
    positions = [np.array([0.0, 0.0, v * t]) for t in range(n_frames)]

    # Lane layout constraints: every mover must stay inside the tracker's
    # 25 m working range (max_obj_depth, reference Tracking.cc:1523 drops
    # farther objects) AND >=6 must be visible in every frame.  The lead
    # (rel z ~11, u-band ~[360, 440]) occludes what is behind it in that
    # band, so traffic rides the left lanes / near field / right band,
    # and deep lanes drift forward so ego advance never pushes them
    # outside [8, 24] m relative depth.
    defs = [
        # (label, centre(t), facing, half_w, half_h)
        # lead, right of centre, rel z ~= 11 the whole scene
        (1, lambda t: np.array([2.0, 0.25, 11.0 + 0.40 * t]),
         (0.0, 0.0, -1.0), 1.05, 0.78),
        # oncoming, left lane: rel z 24 -> 9
        (2, lambda t: np.array([-2.8, 0.20, 24.0 + 0.20 * t]),
         (0.0, 0.0, 1.0), 1.05, 0.78),
        # drifting crossers (station advances with ego so rel z stays in
        # range): L->R at rel z 20 -> 11 ...
        (3, lambda t: np.array([-8.0 + 0.25 * t, 0.30, 20.0 + 0.30 * t]),
         (0.0, 0.0, -1.0), 1.0, 0.75),
        # ... and R->L at rel z 23 -> 11 (passes behind the lead briefly)
        (4, lambda t: np.array([8.0 - 0.22 * t, 0.30, 23.0 + 0.25 * t]),
         (0.0, 0.0, -1.0), 1.0, 0.75),
        # near crossers sweeping IN FRONT of the lead (rel z ~9-10):
        # small and fast, staggered early (5) / late (6)
        (5, lambda t: np.array([8.0 - 0.40 * t, 0.30, 10.5 + 0.43 * t]),
         (0.0, 0.0, -1.0), 0.8, 0.6),
        (6, lambda t: np.array([-14.0 + 0.40 * t, 0.35, 9.2 + 0.43 * t]),
         (0.0, 0.0, -1.0), 0.8, 0.6),
        # second oncoming, outer left lane: rel z 22 -> 13
        (7, lambda t: np.array([-5.5, 0.20, 22.0 + 0.30 * t]),
         (0.0, 0.0, 1.0), 1.05, 0.78),
        # right-band holder: rel z 18 -> 11, u ~ 486 -> 590 (right of the
        # lead band the whole time)
        (8, lambda t: np.array([6.5, 0.22, 18.0 + 0.33 * t]),
         (0.0, 0.0, 1.0), 1.05, 0.78),
    ]
    movers = [
        Mover(
            centre=c, half_w=hw, half_h=hh, seed=80 + lbl,
            panels=vee_panels(face, hw, hh), label=lbl,
        )
        for lbl, c, face, hw, hh in defs[:n_concurrent]
    ]
    poses = _path_poses(positions)
    return _build_frames(
        cam, lambda t: poses[t], movers, n_frames,
        box=(-40.0, 40.0, -20.0, v * n_frames + 95.0),
        texture=_TEXTURES[texture], times=times,
    )


def write_stereo_tree(dst, n_frames: int = 14, cam=None,
                      texture: str = "distinct"):
    """Render a synthetic STEREO sequence (KITTI image_2/image_3 layout)
    for the quad-stereo A/B: left + right views from a rigid baseline
    b = bf/fx, ground-truth poses, left-view instance masks.  No flow/
    depth files — the stereo loader computes block-matching disparity and
    the pipeline estimates flow on device, which is exactly the regime
    where the quad gate (descriptor-verified correspondences across all
    four views, src/ORBmatcher.cc:1704-1842) can improve on estimated
    flow."""
    import pathlib

    from multimot_track_tpu_torch.io.png import write_png

    cam = dict(SYNTH_CAM) if cam is None else cam
    b = cam["bf"] / cam["fx"]
    v = 0.55
    amp, period = 1.8, 40.0
    positions = [
        np.array([amp * np.sin(2 * np.pi * t / period), 0.0, v * t])
        for t in range(n_frames)
    ]
    movers = [
        Mover(
            centre=lambda t: np.array([1.8, 0.25, 9.0 + 0.42 * t]),
            half_w=1.0, half_h=0.75, seed=50,
            panels=vee_panels((0.0, 0.0, -1.0), 1.0, 0.75), label=1,
        ),
        Mover(
            centre=lambda t: np.array([-6.0 + 0.35 * t, 0.3, 16.0]),
            half_w=0.9, half_h=0.7, seed=51,
            axes=_facing_axes((0.0, 0.0, -1.0)), label=2,
        ),
    ]
    poses = _path_poses(positions)
    box = (-30.0, 30.0, -10.0, v * n_frames + 50.0)

    dst = pathlib.Path(dst)
    for sub in ("image_2", "image_3", "semantic"):
        (dst / sub).mkdir(parents=True, exist_ok=True)
    with open(dst / "pose_gt.txt", "w") as fpose, \
            open(dst / "times.txt", "w") as ftime:
        for t in range(n_frames):
            Twc = poses[t]
            Twc_r = Twc.copy()
            Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([b, 0.0, 0.0])
            tex = _TEXTURES[texture]
            left, _, label, _ = _render_frame(
                cam, Twc, movers, t, box=box, texture=tex)
            right, _, _, _ = _render_frame(
                cam, Twc_r, movers, t, box=box, texture=tex)
            write_png(dst / "image_2" / f"{t:06d}.png", left.astype(np.uint8))
            write_png(dst / "image_3" / f"{t:06d}.png", right.astype(np.uint8))
            np.savetxt(dst / "semantic" / f"{t:06d}.txt", label, fmt="%d")
            G0 = np.linalg.inv(poses[0])
            T = (G0 @ Twc).astype(np.float64)
            fpose.write(
                f"{t} " + " ".join(f"{x:.9f}" for x in T.reshape(-1)) + "\n"
            )
            ftime.write(f"{t * 0.1:.6e}\n")
    return dst


def _gray8(gray: np.ndarray) -> np.ndarray:
    return np.clip(np.round(gray), 0, 255).astype(np.uint8)


def write_kitti_tree(dst, frames, flow: bool = True):
    """Write rendered frames as a KITTI-format sequence directory (the
    layout ``io/kitti.KittiSequence`` reads): ``image/`` as 8-bit RGB PNG
    (the rounded gray in three equal channels), ``depth/`` as 16-bit PNG of
    the rounded raw disparity*256, ``flow/`` as .flo (unless
    ``flow=False``), ``semantic/`` as text masks, and ``pose_gt.txt`` /
    ``times.txt``.  Not in the JAX package."""
    import pathlib

    from multimot_track_tpu_torch.io.flowio import write_flo
    from multimot_track_tpu_torch.io.png import write_png

    dst = pathlib.Path(dst)
    for sub in ("image", "depth", "semantic") + (("flow",) if flow else ()):
        (dst / sub).mkdir(parents=True, exist_ok=True)
    with open(dst / "pose_gt.txt", "w") as fpose, open(dst / "times.txt", "w") as ftime:
        for i, fd in enumerate(frames):
            write_png(dst / "image" / f"{i:06d}.png", np.stack([_gray8(fd.gray)] * 3, -1))
            write_png(dst / "depth" / f"{i:06d}.png",
                      np.clip(np.round(fd.depth_raw), 0, 65535).astype(np.uint16))
            if flow:
                write_flo(dst / "flow" / f"{i:06d}.flo", fd.flow)
            np.savetxt(dst / "semantic" / f"{i:06d}.txt", fd.sem_mask, fmt="%d")
            T = np.asarray(fd.pose_gt, np.float64)
            fpose.write(f"{i} " + " ".join(f"{x:.9f}" for x in T.reshape(-1)) + "\n")
            ftime.write(f"{fd.timestamp:.6e}\n")
    return dst


def write_tum_tree(dst, frames, bf: float):
    """Write rendered frames in the TUM RGB-D layout (``io/tum``): ``rgb/``
    8-bit RGB PNG, ``depth/`` uint16 metric depth * 5000 (0 where unknown),
    ``rgb.txt`` / ``depth.txt`` on clocks 7 ms apart, so that the reader
    associates by nearest timestamp, and ``groundtruth.txt`` (quaternion
    camera-to-world rows, 4 ms early).  ``bf``: the frames' own baseline *
    fx, which turns their raw disparity into metric depth.  Not in the JAX
    package."""
    import pathlib

    from scipy.spatial.transform import Rotation

    from multimot_track_tpu_torch.io.png import write_png

    dst = pathlib.Path(dst)
    (dst / "rgb").mkdir(parents=True, exist_ok=True)
    (dst / "depth").mkdir(parents=True, exist_ok=True)
    rgb_rows, dep_rows, gt_rows = [], [], []
    for i, fd in enumerate(frames):
        t = 1305031102.0 + 0.1 * i
        write_png(dst / "rgb" / f"{t:.6f}.png", np.stack([_gray8(fd.gray)] * 3, -1))
        rgb_rows.append(f"{t:.6f} rgb/{t:.6f}.png")
        raw = np.asarray(fd.depth_raw, np.float64)
        z = np.where(raw > 0, bf / np.maximum(raw / 256.0, 1e-9), 0.0)
        td = t + 0.007
        write_png(dst / "depth" / f"{td:.6f}.png",
                  np.clip(np.round(z * 5000.0), 0, 65535).astype(np.uint16))
        dep_rows.append(f"{td:.6f} depth/{td:.6f}.png")
        T = np.asarray(fd.pose_gt, np.float64)
        q = Rotation.from_matrix(T[:3, :3]).as_quat()        # x y z w
        gt_rows.append(f"{t - 0.004:.6f} " + " ".join(f"{v:.9f}" for v in (*T[:3, 3], *q)))
    (dst / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_rows) + "\n")
    (dst / "depth.txt").write_text("# depth\n" + "\n".join(dep_rows) + "\n")
    (dst / "groundtruth.txt").write_text("# groundtruth\n" + "\n".join(gt_rows) + "\n")
    return dst


# a body <- camera extrinsic shaped like EuRoC's cam0 (axes permuted, a few
# centimetres of lever arm)
EUROC_T_BS = np.asarray([[0.0, -1.0, 0.0, -0.0216],
                         [1.0, 0.0, 0.0, -0.0647],
                         [0.0, 0.0, 1.0, 0.0098],
                         [0.0, 0.0, 0.0, 1.0]])


def write_euroc_tree(dst, frames, cam, distortion=(-2e-3, 5e-4, 1e-4, -1e-4),
                     T_BS=EUROC_T_BS):
    """Write rendered frames in the EuRoC ASL layout (``io/euroc``):
    ``mav0/cam0/data/<ns>.png`` 8-bit gray, ``data.csv``, a ``sensor.yaml``
    with ``cam``'s intrinsics, the radial-tangential ``distortion`` (the
    frames themselves are pinhole renders, so keep it small) and ``T_BS``,
    and ``state_groundtruth_estimate0/data.csv``: body poses T_WB = Twc
    T_BS^-1 as position + quaternion (w x y z) rows 1 ms after each frame,
    with zero velocities and biases.  Not in the JAX package."""
    import pathlib

    from scipy.spatial.transform import Rotation

    from multimot_track_tpu_torch.io.png import write_png

    dst = pathlib.Path(dst)
    cam_dir = dst / "mav0" / "cam0"
    (cam_dir / "data").mkdir(parents=True, exist_ok=True)
    gt_dir = dst / "mav0" / "state_groundtruth_estimate0"
    gt_dir.mkdir(parents=True, exist_ok=True)
    T_BS = np.asarray(T_BS, np.float64)
    rows, gt_rows = [], []
    for i, fd in enumerate(frames):
        ns = 1403636579763555584 + 50_000_000 * i
        write_png(cam_dir / "data" / f"{ns}.png", _gray8(fd.gray))
        rows.append(f"{ns},{ns}.png")
        T_WB = np.asarray(fd.pose_gt, np.float64) @ np.linalg.inv(T_BS)
        x, y, z, w = Rotation.from_matrix(T_WB[:3, :3]).as_quat()
        gt_rows.append(f"{ns + 1_000_000}," + ",".join(
            f"{v:.9f}" for v in (*T_WB[:3, 3], w, x, y, z, *([0.0] * 9))))
    (cam_dir / "data.csv").write_text("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    (gt_dir / "data.csv").write_text(
        "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], "
        "q_RS_y [], q_RS_z [], v_RS_R_x, v_RS_R_y, v_RS_R_z, b_w_RS_S_x, b_w_RS_S_y, "
        "b_w_RS_S_z, b_a_RS_S_x, b_a_RS_S_y, b_a_RS_S_z\n" + "\n".join(gt_rows) + "\n")
    data = ", ".join(f"{v:.6f}" for v in T_BS.reshape(-1))
    (cam_dir / "sensor.yaml").write_text(
        "sensor_type: camera\ncomment: synthetic render\n"
        f"T_BS:\n  cols: 4\n  rows: 4\n  data: [{data}]\n"
        f"rate_hz: 20\nresolution: [{cam['width']}, {cam['height']}]\n"
        "camera_model: pinhole\n"
        f"intrinsics: [{cam['fx']}, {cam['fy']}, {cam['cx']}, {cam['cy']}]\n"
        "distortion_model: radial-tangential\n"
        f"distortion_coefficients: [{', '.join(str(float(v)) for v in distortion)}]\n")
    return dst


# ---------------------------------------------------------------------------
# Input degradation (the reference's own noise models)

def _erode_labels(label: np.ndarray, r: int) -> np.ndarray:
    """Per-label binary erosion by a (2r+1)-square: a mover pixel survives
    only if its full neighbourhood shares its label; boundary pixels fall
    back to 0 (static).  Mimics a segmentation net's under-segmentation at
    object boundaries without pulling in scipy."""
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


def degrade_frames(
    frames,
    seed: int = 0,
    depth_noise_scale: float = 0.15,
    flow_sigma: float = 0.3,
    flow_outlier_every: int = 35,
    flow_outlier_sigma: float = 4.0,
    mask_erode_px: int = 2,
    gray_sigma: float = 2.0,
    bf: float = None,
):
    """Corrupt analytic frames with the REFERENCE's own noise models so
    at-scale accuracy is proven on degraded inputs, not just clean ones.

    - depth: z += N(0, z^2/(725*0.5) * depth_noise_scale) — exactly the
      reference's AddNoise model (src/Frame.cc:1089, UnprojectStereoSift;
      0.15 is the scale the reference ships enabled for its sampled
      features).
    - flow: dense N(0, flow_sigma) px everywhere (flow-net estimation
      error) + gross outliers at rate 1/flow_outlier_every with
      N(0, flow_outlier_sigma) px — the reference's commented outlier
      injector corrupts every 35th keypoint with gaussian(4.0)
      (src/Frame.cc:276-301).
    - mask: per-label erosion by mask_erode_px (segmentation boundary
      error; eroded pixels become static, stressing the motion-grouping
      gates with contaminated static sets).
    - gray: N(0, gray_sigma) intensity noise (sensor noise; stresses the
      ZNCC photometric verification gate).

    Ground truth stays EXACT — degraded inputs are measured against the
    same analytic GT, so these rows isolate robustness of the estimator.
    """
    rng = np.random.default_rng(seed)
    out = []
    for fd in frames:
        depth_raw = fd.depth_raw
        if depth_noise_scale > 0:
            # depth_raw = bf*256/z -> corrupt in METRIC space (sigma is a
            # function of z in meters), then re-encode.  ``bf`` must match
            # the generator camera; default is the KITTI synth camera.
            bf256 = 256.0 * (bf if bf is not None else KITTI_SYNTH_CAM["bf"])
            with np.errstate(divide="ignore"):
                z_m = np.where(depth_raw > 1e-6, bf256 / depth_raw, 0.0)
            sigma = z_m * z_m / (725.0 * 0.5) * depth_noise_scale
            z_noisy = np.maximum(z_m + rng.normal(0.0, 1.0, z_m.shape) * sigma,
                                 0.5)
            depth_raw = np.where(
                depth_raw > 1e-6, bf256 / z_noisy, depth_raw
            ).astype(np.float32)
        flow = fd.flow
        if flow_sigma > 0 or flow_outlier_every:
            flow = flow + rng.normal(0.0, flow_sigma, flow.shape).astype(
                np.float32
            )
            if flow_outlier_every:
                m = rng.random(flow.shape[:2]) < (1.0 / flow_outlier_every)
                flow = np.where(
                    m[..., None],
                    flow + rng.normal(
                        0.0, flow_outlier_sigma, flow.shape
                    ).astype(np.float32),
                    flow,
                )
        gray = fd.gray
        if gray_sigma > 0:
            gray = np.clip(
                gray + rng.normal(0.0, gray_sigma, gray.shape), 0, 255
            ).astype(np.float32)
        out.append(dataclasses.replace(
            fd,
            gray=gray,
            depth_raw=depth_raw,
            flow=flow.astype(np.float32),
            sem_mask=_erode_labels(fd.sem_mask, mask_erode_px),
        ))
    return out

