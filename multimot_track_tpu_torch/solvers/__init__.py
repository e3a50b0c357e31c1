"""Horn alignment, RANSAC and the flow-BA (plain torch and CUDA kernel K1)."""
