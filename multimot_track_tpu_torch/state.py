"""Conversions between the JAX package's state and the port's tensors.

This system has no learned weights; what carries across is the state the
pair path computes from: ground-truth tables, frame observations, pair
inputs and the tracking context.  ``from_reference`` turns any of these,
as the JAX package returns them (jax or numpy arrays in NamedTuples with
the same field names), into the port's NamedTuple of tensors, so both
packages compute from identical inputs.  ``result_to_numpy`` turns a port
PairResult (or any NamedTuple of tensors) back into numpy.  Neither needs
jax: reference arrays are read through ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from multimot_track_tpu_torch.eval.metrics import SegConfusion
from multimot_track_tpu_torch.frontend.sampling import ObjSamples, StaticSamples
from multimot_track_tpu_torch.pipeline.frames import (
    FrameObservation, GTTable, PairInputs, tree_map,
)
from multimot_track_tpu_torch.pipeline.tracker import ObjectOutputs, PairResult

# nested NamedTuple fields, by port type
_CHILDREN = {
    FrameObservation: {"static": StaticSamples, "objects": ObjSamples, "gt": GTTable},
    PairInputs: {"gt_last": GTTable, "gt_cur": GTTable},
    PairResult: {"seg_confusion": SegConfusion, "objects": ObjectOutputs},
}


def from_reference(obj, cls, device="cpu", batch: bool = False):
    """The JAX package's ``obj`` (a GTTable, FrameObservation, PairInputs,
    TrackContext or PairResult) as the port's ``cls`` of tensors on
    ``device``.  ``batch=True`` adds the leading pair axis the port's
    batched functions take, for an unbatched reference value."""
    children = _CHILDREN.get(cls, {})
    out = {}
    for f in cls._fields:
        v = getattr(obj, f)
        if f in children:
            out[f] = from_reference(v, children[f], device, batch)
        else:
            t = torch.from_numpy(np.array(v))
            out[f] = (t[None] if batch else t).to(device)
    return cls(**out)


def result_to_numpy(res):
    """A NamedTuple of tensors (e.g. a PairResult) as numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), res)
