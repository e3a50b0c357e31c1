"""SE(3) and pinhole camera math on batched torch tensors."""
