"""The plain flow-BA in float64 NumPy, and the gap between K1's poses and
its own on the same problems.

A copy of the port's plain solver (``solvers/flow_ba.solve_flow_ba``, the
objective K1 runs in float32 on the card) written from its equations: one
SE(3) pose and one 2-D flow variable per point, the Huber-robust
reprojection edge (information ``reproj_info`` times the point's weight,
delta^2 = ``rp_thres``) and the flow prior (``prior_info``), the flow
eliminated by its Schur complement onto the pose, the same unrolled 6x6
Cholesky, the same Levenberg-Marquardt damping (lambda_0 = tau x the
largest diagonal seed, Nielsen's schedule) and the same stopping rule (an
accepted step that lowers the objective by less than ``rel_tol`` of it,
lambda past 1e8, or the iteration cap), each problem frozen from the
iteration it stops.  It imports nothing of the program.

``gap_numbers`` re-solves the problems a run captured at K1's entry (the
inputs the program handed to K1 and the poses K1 returned) and reports,
over the problems, the quantile ``GAP_QUANTILE`` of the translation gap
(metres) and of the rotation gap (degrees) between K1's pose and this
solver's; ``portbench/limits`` holds them.
"""

from __future__ import annotations

import math
import time

import numpy as np

from portbench import harness

_EPS = 1e-8
GAP_QUANTILE = 0.9          # the judged quantile over the re-solved problems (nearest rank)


def _hat(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_se3(xi):
    """(M, 6) tangent (omega, upsilon) -> (M, 4, 4), with the program's eps
    regularisation and small-angle branches."""
    omega, ups = xi[:, :3], xi[:, 3:]
    theta2 = (omega * omega).sum(-1)
    theta = np.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-10
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(small, 1.0 - theta2 / 6.0, np.sin(theta) / theta)
        b = np.where(small, 0.5 - theta2 / 24.0, (1.0 - np.cos(theta)) / (theta2 + _EPS * _EPS))
        c = np.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - np.sin(theta)) / (theta2 * theta + _EPS))
    K = _hat(omega)
    KK = K @ K
    eye = np.eye(3)
    R = eye + a[:, None, None] * K + b[:, None, None] * KK
    V = eye + b[:, None, None] * K + c[:, None, None] * KK
    T = np.zeros((xi.shape[0], 4, 4))
    T[:, :3, :3] = R
    T[:, :3, 3] = (V @ ups[..., None])[..., 0]
    T[:, 3, 3] = 1.0
    return T


def transform(T, X):
    """(M, 4, 4) applied to (M, N, 3)."""
    R, t = T[:, None, :3, :3], T[:, None, :3, 3]
    return np.stack([R[..., i, 0] * X[..., 0] + R[..., i, 1] * X[..., 1]
                     + R[..., i, 2] * X[..., 2] + t[..., i] for i in range(3)], -1)


def backproject(uv, depth, fx, fy, cx, cy):
    return np.stack([(uv[..., 0] - cx) * depth / fx, (uv[..., 1] - cy) * depth / fy, depth], -1)


def project(xyz, fx, fy, cx, cy):
    inv_z = 1.0 / (xyz[..., 2] + 1e-9)
    return np.stack([fx * xyz[..., 0] * inv_z + cx, fy * xyz[..., 1] * inv_z + cy], -1)


def solve_spd6(H, g):
    """x with H x = g by the unrolled Cholesky (diagonal clamped at 1e-30)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = np.sqrt(np.maximum(s, 1e-30)) if i == j else s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return np.stack(x, -1)


def _objective(T, f, Xw, obs, flow_meas, valid, w_pt, p, cam):
    """The robust total objective (M,)."""
    r_p = (obs + f) - project(transform(T, Xw), *cam)
    chi2_w = w_pt * (p["reproj_info"] * (r_p * r_p).sum(-1))
    d2 = p["rp_thres"]
    rho = np.where(chi2_w <= d2, chi2_w, 2.0 * np.sqrt(d2 * np.maximum(chi2_w, 1e-20)) - d2)
    r_f = f - flow_meas
    return np.where(valid, rho + p["prior_info"] * (r_f * r_f).sum(-1), 0.0).sum(-1)


def _step(T, f, Xw, obs, flow_meas, valid, w_pt, lam, p, cam):
    """One damped Gauss-Newton step with the flow eliminated: (dxi, df, pred)."""
    fx, fy, cx, cy = cam
    M, N = obs.shape[:2]
    y = transform(T, Xw)
    r_p = (obs + f) - project(y, *cam)
    r_f = f - flow_meas
    chi2_p = w_pt * p["reproj_info"] * (r_p * r_p).sum(-1)
    w_rob = np.where(chi2_p <= p["rp_thres"], 1.0,
                     np.sqrt(p["rp_thres"] / np.maximum(chi2_p, 1e-20)))
    wp = w_pt * p["reproj_info"] * np.where(valid, w_rob, 0.0)
    wf = p["prior_info"] * valid
    inv_z = 1.0 / np.maximum(y[..., 2], 1e-6)
    # A = d r_p / d xi = -dpi @ [-hat(y) | I]  (M, N, 2, 6)
    A = np.zeros((M, N, 2, 6))
    gx, gy = fx * inv_z, fy * inv_z
    hx, hy = -fx * y[..., 0] * inv_z * inv_z, -fy * y[..., 1] * inv_z * inv_z
    # dpi @ -hat(y): rows (gx, 0, hx) and (0, gy, hy) times -hat(y)
    A[..., 0, 0] = -(hx * y[..., 1])
    A[..., 0, 1] = -(gx * y[..., 2] - hx * y[..., 0])
    A[..., 0, 2] = -(-gx * y[..., 1])
    A[..., 1, 0] = -(-gy * y[..., 2] + hy * y[..., 1])
    A[..., 1, 1] = -(-hy * y[..., 0])
    A[..., 1, 2] = -(gy * y[..., 0])
    A[..., 0, 3], A[..., 0, 5] = -gx, -hx
    A[..., 1, 4], A[..., 1, 5] = -gy, -hy
    h_ff = wp + wf + lam[:, None]
    g_f = wp[..., None] * r_p + wf[..., None] * r_f
    A2 = A.reshape(M, 2 * N, 6)
    AtW = A * wp[..., None, None]
    AtW2 = AtW.reshape(M, 2 * N, 6)
    H_TT = AtW2.transpose(0, 2, 1) @ A2
    g_T = (AtW2 * r_p.reshape(M, 2 * N, 1)).sum(1)
    inv_h = np.repeat(1.0 / h_ff, 2, axis=1)[..., None]
    H_red = H_TT + lam[:, None, None] * np.eye(6) - (AtW2 * inv_h).transpose(0, 2, 1) @ AtW2
    g_red = g_T - (AtW2 * (g_f.reshape(M, 2 * N, 1) * inv_h)).sum(1)
    dxi = solve_spd6(H_red, -g_red)
    Adxi = (A @ dxi[:, None, :, None])[..., 0]
    df = -(g_f + wp[..., None] * Adxi) / h_ff[..., None]
    pred_flow = np.where(valid[..., None], df * (lam[:, None, None] * df - g_f), 0.0).sum((-2, -1))
    pred = 0.5 * ((dxi * (lam[:, None] * dxi - g_red)).sum(-1) + pred_flow)
    return dxi, df, pred


def solve(T_init, Twl, obs, flow_meas, depth, valid, fx, fy, cx, cy, params: dict,
          point_weight=None):
    """M independent problems in float64: (M, 4, 4) poses and (M,) LM
    iterations.  ``params``: reproj_info, prior_info, rp_thres, iters, tau,
    rel_tol; ``point_weight``: (M, N) or None."""
    f64 = lambda a: np.asarray(a, np.float64)
    T_init, Twl, obs, flow_meas, depth = map(f64, (T_init, Twl, obs, flow_meas, depth))
    p, cam = params, (float(fx), float(fy), float(cx), float(cy))
    M, N = obs.shape[:2]
    w_pt = np.ones((M, N)) if point_weight is None else np.broadcast_to(f64(point_weight), (M, N))
    Xw = transform(Twl, backproject(obs, depth, *cam))
    valid = np.asarray(valid, bool) & (depth > 0)
    T, f = T_init.copy(), flow_meas.copy()
    F = _objective(T, f, Xw, obs, flow_meas, valid, w_pt, p, cam)
    z = np.maximum(transform(T_init, Xw)[..., 2], 1e-6)
    seed = np.where(valid, w_pt * p["reproj_info"] * ((fx / z) ** 2 + (fy / z) ** 2), 0.0)
    lam = p["tau"] * np.maximum(seed.max(-1, initial=0.0), 1.0)
    nu = np.full(M, 2.0)
    done = np.zeros(M, bool)
    iters = np.zeros(M, np.int64)
    for _ in range(int(p["iters"])):
        a = np.flatnonzero(~done)           # a frozen problem's state never changes again
        if a.size == 0:
            break
        args = (Xw[a], obs[a], flow_meas[a], valid[a], w_pt[a])
        dxi, df, pred = _step(T[a], f[a], *args, lam[a], p, cam)
        T_new = exp_se3(dxi) @ T[a]
        f_new = f[a] + df
        F_new = _objective(T_new, f_new, *args, p, cam)
        Fa, la = F[a], lam[a]
        gain = (Fa - F_new) / np.maximum(pred, 1e-20)
        accept = (F_new < Fa) & np.isfinite(F_new)
        lam_acc = la * np.maximum(1.0 - (2.0 * gain - 1.0) ** 3, 1.0 / 3.0)
        done[a] = (accept & (Fa - F_new < p["rel_tol"] * Fa + 1e-10)) | (la > 1e8)
        T[a] = np.where(accept[:, None, None], T_new, T[a])
        f[a] = np.where(accept[:, None, None], f_new, f[a])
        F[a] = np.where(accept, F_new, Fa)
        lam[a] = np.where(accept, lam_acc, la * nu[a])
        nu[a] = np.where(accept, 2.0, nu[a] * 2.0)
        iters[a] += 1
    return T, iters


def pose_gaps(T_a, T_b):
    """Per problem: |t_a - t_b| (the translations' units) and the angle of
    R_a R_b^T in degrees (from its skew part, exact near 0)."""
    T_a, T_b = np.asarray(T_a, np.float64), np.asarray(T_b, np.float64)
    t = np.linalg.norm(T_a[:, :3, 3] - T_b[:, :3, 3], axis=-1)
    R = T_a[:, :3, :3] @ T_b[:, :3, :3].transpose(0, 2, 1)
    w = 0.5 * np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                        R[:, 1, 0] - R[:, 0, 1]], -1)
    c = 0.5 * (R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] - 1.0)
    r = np.degrees(np.arctan2(np.linalg.norm(w, axis=-1), c))
    bad = ~(np.isfinite(t) & np.isfinite(r))
    return np.where(bad, math.inf, t), np.where(bad, math.inf, r)


def gap_numbers(groups) -> dict:
    """Re-solve the captured problems and compare K1's poses with them.

    ``groups``: dicts with ``kind`` ('cam' | 'obj'), ``cam`` (fx, fy, cx,
    cy), ``params`` (dict), the inputs ``T_init``, ``Twl``, ``obs``,
    ``flow``, ``depth``, ``valid``, ``point_weight`` (or None) and ``T_k1``,
    K1's poses.  Returns the judged numbers ``k1_f64_t_gap_m`` and
    ``k1_f64_r_gap_deg`` (the ``GAP_QUANTILE`` over every problem) and, for
    the notes, per kind the median and the largest gap, the count and the
    seconds taken."""
    t0 = time.perf_counter()
    t_all, r_all, out = [], [], {}
    for kind in ("cam", "obj"):
        t_k, r_k = [], []
        for g in (g for g in groups if g["kind"] == kind):
            if len(g["T_k1"]) == 0:
                continue
            T64, _ = solve(g["T_init"], g["Twl"], g["obs"], g["flow"], g["depth"], g["valid"],
                           *g["cam"], g["params"], point_weight=g["point_weight"])
            t, r = pose_gaps(g["T_k1"], T64)
            t_k.extend(t.tolist())
            r_k.extend(r.tolist())
        out[f"k1_f64_{kind}_problems"] = float(len(t_k))
        if t_k:
            out[f"k1_f64_{kind}_t_gap_med_m"] = float(np.median(t_k))
            out[f"k1_f64_{kind}_t_gap_max_m"] = max(t_k)
            out[f"k1_f64_{kind}_r_gap_med_deg"] = float(np.median(r_k))
            out[f"k1_f64_{kind}_r_gap_max_deg"] = max(r_k)
        t_all += t_k
        r_all += r_k
    if t_all:
        out["k1_f64_t_gap_m"] = harness.nearest_rank(t_all, GAP_QUANTILE)
        out["k1_f64_r_gap_deg"] = harness.nearest_rank(r_all, GAP_QUANTILE)
    out["k1_f64_seconds"] = time.perf_counter() - t0
    return out
