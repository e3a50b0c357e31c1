"""Multi-label motion segmentation: the graph-cut MRF over dynamic points.

Port of ``multimot_track_tpu.ops.graphcut``.  The energy is

  data term     D(i, l) = LAMBDA * min(reprojection error of i under motion l, COST_CAP)
  smoothness    Potts, weight SMOOTH_SCALE * exp(-d / SMOOTH_DECAY) over a
                k-NN adjacency in the image

and ``segment`` minimises it with a damped mean-field relaxation annealed
to hard labels, polished by ICM, with a guard that keeps the best single
label when that costs less.  ``segment_exact`` is the exact
alpha-expansion over max-flow, on the host, in ``native/graphcut.cc``
(built at first use by ``kernels.build_native``; a failed build raises).

Every function runs on the device of its inputs.  Hypothesis seeds are an
input of ``sample_motion_hypotheses``: the JAX package draws them
with ``jax.random.choice``, which torch cannot reproduce.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from multimot_track_tpu_torch import kernels
from multimot_track_tpu_torch.geometry import camera
from multimot_track_tpu_torch.solvers import horn

LAMBDA = 80.0         # data-term scale
COST_CAP = 16.0       # reprojection-error cap (px)
SMOOTH_SCALE = 100.0  # neighbour weight = 100 * exp(-d / 49)
SMOOTH_DECAY = 49.0


class SegGraph(NamedTuple):
    nbr_idx: torch.Tensor   # (N, K) int64 neighbour indices
    nbr_w: torch.Tensor     # (N, K) smoothness weights
    valid: torch.Tensor     # (N,) bool


def build_knn_graph(uv: torch.Tensor, valid: torch.Tensor, k: int = 6) -> SegGraph:
    """k-NN adjacency in image space.  Among equal distances the lower
    index comes first (a grid has many), as ``lax.top_k`` orders them."""
    d = uv[:, None, :] - uv[None, :, :]
    d2 = (d * d).sum(-1)
    big = 1e12
    N = uv.shape[0]
    eye = torch.eye(N, dtype=torch.bool, device=uv.device)
    d2 = torch.where(valid[None, :] & ~eye, d2, big)
    d2 = torch.where(valid[:, None], d2, big)
    top, idx = torch.sort(d2, dim=1, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    dist = torch.sqrt(torch.clamp(top, min=0.0))
    w = SMOOTH_SCALE * torch.exp(-dist / SMOOTH_DECAY)
    w = torch.where(top < big * 0.5, w, 0.0)
    return SegGraph(nbr_idx=idx, nbr_w=w, valid=valid)


def sample_motion_hypotheses(seeds: torch.Tensor, graph: SegGraph, Xw_last: torch.Tensor,
                             xyz_cur: torch.Tensor, mss_size: int = 4) -> torch.Tensor:
    """Minimal-sample-set hypotheses: each seed point (n_hyp,) with its
    ``mss_size - 1`` nearest neighbours, a rigid motion fitted by Horn
    3D-3D alignment.  Returns (n_hyp, 4, 4)."""
    take = min(mss_size - 1, graph.nbr_idx.shape[1])
    members = torch.cat([seeds[:, None], graph.nbr_idx[seeds][:, :take]], 1)
    return horn.rigid_align(Xw_last[members], xyz_cur[members])


def dedupe_hypotheses(T_hyp: torch.Tensor, rot_tol: float = 0.01,
                      t_tol: float = 0.05) -> torch.Tensor:
    """(L,) mask of representatives: a hypothesis within ``rot_tol`` rad
    and ``t_tol`` m of an earlier one is dropped (duplicates split one
    rigid region across labels and let parallel updates oscillate)."""
    rel = torch.einsum("aij,bjk->abik", T_hyp, torch.linalg.inv(T_hyp))
    t = torch.linalg.vector_norm(rel[..., :3, 3], dim=-1)
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    ang = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    same = (t < t_tol) & (ang < rot_tol)
    earlier = torch.tril(same, diagonal=-1)
    return ~earlier.any(1)


def data_costs(T_hyp: torch.Tensor, Xw_last: torch.Tensor, uv_cur: torch.Tensor,
               fx, fy, cx, cy) -> torch.Tensor:
    """(N, L) capped, scaled reprojection costs of N points under L motions."""
    y = torch.einsum("lij,nj->lni", T_hyp[:, :3, :3], Xw_last) + T_hyp[:, None, :3, 3]
    err = torch.linalg.vector_norm(camera.project(y, fx, fy, cx, cy) - uv_cur[None], dim=-1)
    return (LAMBDA * torch.clamp(err, max=COST_CAP)).T


def total_energy(labels: torch.Tensor, D: torch.Tensor, graph: SegGraph) -> torch.Tensor:
    """E = sum_i D(i, l_i) + sum_edges w_ij [l_i != l_j] (Potts, beta = 1)."""
    d = torch.gather(D, 1, labels[:, None])[:, 0]
    data = torch.where(graph.valid, d, 0.0).sum()
    diff = ((labels[graph.nbr_idx] != labels[:, None]) & graph.valid[:, None]
            & graph.valid[graph.nbr_idx])
    return data + 0.5 * torch.where(diff, graph.nbr_w, 0.0).sum()


def _potts_penalty(w: torch.Tensor, q_nbr: torch.Tensor) -> torch.Tensor:
    """(N, L) expected Potts cost of each label: sum_k w_ik (1 - q_nbr_ikl)."""
    return torch.einsum("nk,nkl->nl", w, 1.0 - q_nbr)


def segment(D: torch.Tensor, graph: SegGraph, n_mf_iters: int = 20, n_icm_iters: int = 5,
            temperature: float = 20.0):
    """Mean-field relaxation annealed to hard labels, ICM-polished, then the
    constant-labelling guard.  Returns (labels (N,) int64, energy ())."""
    L = D.shape[1]
    q = torch.softmax(-D / temperature, dim=-1)
    for i in range(n_mf_iters):
        temp = temperature * (0.5 ** (i / 5.0))
        logits = -(D + _potts_penalty(graph.nbr_w, q[graph.nbr_idx])) / max(temp, 1e-3)
        # damped: an undamped parallel mean-field update oscillates on a graph
        q = 0.5 * q + 0.5 * torch.softmax(logits, dim=-1)
    labels = torch.argmax(q, dim=-1)
    for _ in range(n_icm_iters):
        onehot = torch.nn.functional.one_hot(labels, L).to(D.dtype)
        labels = torch.argmin(D + _potts_penalty(graph.nbr_w, onehot[graph.nbr_idx]), dim=-1)
    e_mf = total_energy(labels, D, graph)
    # where the smoothness dominates, the parallel relaxation can fail to
    # break the label symmetry and fragment; the best single label has no
    # Potts cost, so keep whichever energy is lower
    data_cols = torch.where(graph.valid[:, None], D, 0.0).sum(0)
    const_lab = torch.argmin(data_cols)
    e_const = data_cols[const_lab]
    take_const = e_const < e_mf
    labels = torch.where(take_const, const_lab.expand_as(labels), labels)
    return labels, torch.minimum(e_mf, e_const)


# ---------------------------------------------------------------------------
# Exact labeler: alpha-expansion over Dinic max-flow (native/graphcut.cc)

_GC_DLL: Optional[ctypes.CDLL] = None


def _graphcut_dll() -> ctypes.CDLL:
    global _GC_DLL
    if _GC_DLL is None:
        dll = ctypes.CDLL(str(kernels.build_native("graphcut")))
        dll.mmt_alpha_expansion.restype = ctypes.c_int
        dll.mmt_alpha_expansion.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _GC_DLL = dll
    return _GC_DLL


def graph_to_edges(graph: SegGraph):
    """Undirected unique edge list (ei, ej, ew) of the k-NN adjacency, with
    the weights of ``total_energy``'s accounting: each directed slot adds
    half its weight, so an asymmetric neighbour pair carries half."""
    idx = graph.nbr_idx.cpu().numpy()
    w = graph.nbr_w.cpu().numpy()
    valid = graph.valid.cpu().numpy()
    acc = {}
    for i in np.flatnonzero(valid):
        for k in range(idx.shape[1]):
            j = int(idx[i, k])
            if w[i, k] <= 0 or not valid[j] or j == i:
                continue
            key = (int(i), j) if i < j else (j, int(i))
            acc[key] = acc.get(key, 0.0) + 0.5 * float(w[i, k])
    if not acc:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32)
    ei = np.asarray([k[0] for k in acc], np.int32)
    ej = np.asarray([k[1] for k in acc], np.int32)
    return ei, ej, np.asarray(list(acc.values()), np.float32)


def segment_exact(D: torch.Tensor, graph: SegGraph, init_labels=None, max_sweeps: int = 8):
    """Exact alpha-expansion on the host of D (N, L).  Invalid sites carry no cost in
    the solve and take their own argmin-D label afterwards.  Returns
    (labels (N,) int32 numpy, energy float), the energy comparable to
    ``total_energy``'s."""
    D_orig = D.cpu().numpy().astype(np.float32)
    valid = graph.valid.cpu().numpy()
    Dm = np.ascontiguousarray(np.where(valid[:, None], D_orig, 0.0).astype(np.float32))
    N, L = Dm.shape
    ei, ej, ew = graph_to_edges(graph)
    labels = (np.array(init_labels, np.int32) if init_labels is not None
              else np.argmin(Dm, axis=1).astype(np.int32))
    if labels.shape != (N,) or labels.min(initial=0) < 0 or labels.max(initial=0) >= L:
        raise ValueError(f"init_labels must be ({N},) labels in [0, {L})")
    energy = np.zeros(1, np.float32)
    ptr = lambda a: np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)
    _graphcut_dll().mmt_alpha_expansion(N, L, ptr(Dm), len(ew), ptr(ei), ptr(ej), ptr(ew),
                                        max_sweeps, ptr(labels), ptr(energy))
    if not valid.all():
        labels = np.where(valid, labels, np.argmin(D_orig, axis=1).astype(np.int32))
    return labels, float(energy[0])
