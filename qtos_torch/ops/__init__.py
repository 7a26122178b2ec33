"""Math kernels: rotations, splines, block-tridiagonal solves (plain and CUDA)."""
