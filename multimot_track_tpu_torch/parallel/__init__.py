"""Ranks over torch.distributed: meshes, the pair-sharded tracker's batch,
and the point- and track-sharded bundle adjustments."""

from multimot_track_tpu_torch.parallel import (  # noqa: F401
    mesh,
    pairwise,
    dist_ba,
    dist_window_ba,
)
