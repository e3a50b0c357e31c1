"""multimot_track_tpu_torch — the PyTorch/CUDA port of multimot_track_tpu.

The pair-tracking path of the JAX package (frontend, correspondence
handoff, ego and per-object flow-BA, metrics, batched and streaming
drivers) and the live RGB-D system (keyframes, TrackLocalMap, map-point
fusion and culling, relocalization) rewritten on torch tensors with an
explicit leading batch axis in place of ``vmap``.  Two hand-written CUDA
kernels run on CUDA tensors, and their plain torch versions on CPU
tensors: the flow-BA Levenberg-Marquardt solve (solvers/flow_ba_cuda.py,
csrc/flow_ba_lm.cu) and the projection-gated descriptor matcher
(ops/match_cuda.py, csrc/match_projected.cu).

Module layout mirrors the JAX package one to one:
  geometry/  SE(3) and pinhole camera math
  io/        the sequence readers (KITTI, stereo, TUM), PNG and
             OpenCV-YAML without PIL or PyYAML, .flo, the socket server, and
             numpy copies of the frame record and synthetic scenes
  ops/       wire decoders, patch ZNCC, the separable-weight image resize,
             descriptor matching (torch + CUDA kernel)
  frontend/  FAST pyramid, ORB descriptors, static and dense-object sampling,
             stereo disparity and the quad gate, pyramidal LK flow
  solvers/   Horn alignment, RANSAC, PnP, flow-BA (torch + CUDA kernel)
  pipeline/  frame observations, pair tracker, batched/streaming drivers,
             keyframe store, live refinement, the live system
  eval/      RPE / segmentation / histogram metrics
  cli.py     the command-line driver
  state.py   converts the JAX package's state to tensors and back

Importing the package has no side effects: no jax, no device work, no
kernel build.
"""

__version__ = "0.1.0"
