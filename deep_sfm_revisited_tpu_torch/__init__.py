"""deep_sfm_revisited_tpu_torch — the PyTorch/CUDA port of deep_sfm_revisited_tpu.

The JAX package beside this one is the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU (Hopper, `sm_90a`), with the
JAX package's one main-path Pallas kernel (the bilinear gather of
`ops/pallas/sweep_warp.py`) rewritten by hand in CUDA C++ (`csrc/`).

It imports torch, numpy and the standard library only — never jax, flax or
`deep_sfm_revisited_tpu`. Public functions keep the JAX package's layouts
(NHWC images/features/flow, (B,3,3) intrinsics, (B,3,4) poses) so each
module can be held against its counterpart.

Layout mirrors the JAX package:
  ops/      geometry, the essential-matrix engine, the CUDA kernel wrapper
  models/   DICL flow, PSNet depth, the SFMNet composite
  utils/    device selection, the JAX -> torch weight bridge
"""

__version__ = "0.1.0"
