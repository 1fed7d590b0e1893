"""Point-cloud operators of the port; kernels live in `ops.kernels`."""
