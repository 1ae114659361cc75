"""deep_sfm_revisited_tpu_torch — the PyTorch/CUDA port of deep_sfm_revisited_tpu.

The JAX package beside this one is the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU (Hopper, `sm_90a`), with the
JAX package's two Pallas kernels rewritten by hand in CUDA C++ (`csrc/`):
B1, the bilinear gather of `ops/pallas/sweep_warp.py`, and B2, the windowed
correlation of `ops/pallas/local_corr.py`; and RAFT's correlation lookup and
its backward (R1, R2), which JAX computes without a Pallas kernel.

It imports torch, numpy and the standard library only — never jax, flax or
`deep_sfm_revisited_tpu`. Public functions keep the JAX package's layouts
(NHWC images/features/flow, (B,3,3) intrinsics, (B,3,4) poses) so each
module can be held against its counterpart.

Layout mirrors the JAX package:
  cli.py    the `-v` entry point (Eigen evaluation of a KITTI split)
  ops/      geometry, correlation, the essential-matrix engine, the CUDA
            kernels' wrappers and their builder
  models/   DICL, PWC-DC and RAFT flow, PSNet depth, the SFMNet composite
  data/     KITTI datasets, transforms, batch loader, PNG decoder, the
            synthetic golden scenes
  train/    Eigen metrics and the evaluation loop
  utils/    device selection, the JAX -> torch weight bridge, logging
"""

__version__ = "0.1.0"
