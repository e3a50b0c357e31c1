"""Parallel-in-time tracking: a batch of frame pairs sharded over the ranks.

Port of ``multimot_track_tpu.parallel.pairwise``.  Expressed in the last
camera's frame every pair's relative solves are independent, so:

  1. every pair's relative camera motion T_rel[k] = Tcw_k @ Twc_{k-1} is
     solved at once (``solve_relative_batch``: a batched RANSAC, then the
     flow-BA over all B pairs in one call, kernel K1 on CUDA tensors); a
     rank solves its own rows (``shard_pairs``);
  2. the trajectory is composed with a log-depth scan.

A pair's RANSAC hypotheses are drawn at the sampler site
``(pair, "pairwise")``: the JAX function hands each pair's key to RANSAC
unsplit, so this site is distinct from the tracker's ``(pair, "ego")``,
whose key is the first half of that key's split.
"""

from __future__ import annotations

from typing import Sequence

import torch

from multimot_track_tpu_torch.config import PipelineConfig
from multimot_track_tpu_torch.geometry import camera
from multimot_track_tpu_torch.parallel.mesh import LocalRows, Mesh
from multimot_track_tpu_torch.solvers import ransac
from multimot_track_tpu_torch.solvers.flow_ba import (
    camera_params, flow_ba_route, solve_flow_ba_auto)


def solve_relative_batch(
    sampler: ransac.HypothesisSampler,
    pair_ids: Sequence[int],      # (B,) global pair indices: the draws' sites
    st_uv: torch.Tensor,          # (B, N, 2) last-frame static positions
    st_flow: torch.Tensor,        # (B, N, 2)
    st_depth: torch.Tensor,       # (B, N)
    st_cur_uv: torch.Tensor,      # (B, N, 2)
    st_cur_depth: torch.Tensor,   # (B, N)
    st_valid: torch.Tensor,       # (B, N) bool
    cfg: PipelineConfig,
) -> torch.Tensor:
    """Per-pair relative camera motion T_rel (B, 4, 4), batched; the
    flow-BA runs on ``cfg.solver.flow_ba_backend``."""
    cam, sol = cfg.camera, cfg.solver
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    B = st_uv.shape[0]
    eye = torch.eye(4, dtype=st_uv.dtype, device=st_uv.device).expand(B, 4, 4)
    Xl = camera.backproject(st_uv, st_depth, fx, fy, cx, cy)   # last-cam frame = "world"
    xyz_cur = camera.backproject(st_cur_uv, st_cur_depth, fx, fy, cx, cy)
    rr = ransac.ransac_rigid_pose(
        Xl, st_cur_uv, xyz_cur, st_valid & (st_cur_depth > 0), fx, fy, cx, cy,
        sampler=sampler, sites=ransac.Sites([(int(p), "pairwise") for p in pair_ids]),
        thresh=sol.ransac_reproj_px, iters=sol.ransac_iters,
        refine_iters=sol.refine_gn_iters,
    )
    res = solve_flow_ba_auto(
        rr.T, eye, st_uv, st_flow, st_depth, st_valid, fx, fy, cx, cy,
        params=camera_params(sol), backend=flow_ba_route(sol.flow_ba_backend),
    )
    return res.T


def compose_trajectory(T_rel: torch.Tensor) -> torch.Tensor:
    """Compose relative motions into absolute poses with a log-depth
    inclusive scan (Hillis-Steele: step d multiplies each pose by the one d
    before it).

    T_rel[k] maps frame-(k) camera coords from frame-(k-1) camera coords,
    i.e. Tcw_k = T_rel[k] @ Tcw_{k-1} with Tcw_0 = I.  Returns (B+1, 4, 4)
    of Tcw including the identity first frame."""
    comp = T_rel
    d = 1
    while d < comp.shape[0]:
        comp = torch.cat([comp[:d], comp[d:] @ comp[:-d]], 0)     # later @ earlier
        d *= 2
    eye = torch.eye(4, dtype=T_rel.dtype, device=T_rel.device)[None]
    return torch.cat([eye, comp], 0)


def shard_pairs(mesh: Mesh, tree) -> LocalRows:
    """This rank's rows of a whole pair batch, split over the mesh."""
    return mesh.shard_rows(tree)
