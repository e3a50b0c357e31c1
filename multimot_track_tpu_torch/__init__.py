"""multimot_track_tpu_torch — the PyTorch/CUDA port of multimot_track_tpu.

The pair-tracking path of the JAX package (frontend, correspondence
handoff, ego and per-object flow-BA, metrics, batched and streaming
drivers) rewritten on torch tensors with an explicit leading batch axis in
place of ``vmap``.  The flow-BA Levenberg-Marquardt solve runs as a
hand-written CUDA kernel on CUDA tensors (solvers/flow_ba_cuda.py,
csrc/flow_ba_lm.cu) and as plain torch on CPU tensors.

Module layout mirrors the JAX package one to one:
  geometry/  SE(3) and pinhole camera math
  io/        numpy copies of the host-side frame record and synthetic scenes
  ops/       wire decoders, patch ZNCC, the separable-weight image resize
  frontend/  FAST pyramid, static and dense-object sampling
  solvers/   Horn alignment, RANSAC, flow-BA (torch + CUDA kernel)
  pipeline/  frame observations, pair tracker, batched/streaming drivers
  eval/      RPE / segmentation / histogram metrics
  state.py   converts the JAX package's state to tensors and back

Importing the package has no side effects: no jax, no device work, no
kernel build.
"""

__version__ = "0.1.0"
