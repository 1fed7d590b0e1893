"""pointcept_tpu_torch: the PyTorch/CUDA port of pointcept_tpu.

It imports torch and numpy, never JAX or the JAX package. Entry points
(`models.build_model`, `engines.make_point_batch`) run on the GPU unless the
caller passes ``device="cpu"``; the CUDA kernels of `ops.kernels` are built
from `csrc/` at first use.
"""
