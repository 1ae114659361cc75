"""Wrappers of the hand-written CUDA kernels in `deep_sfm_revisited_tpu_torch/csrc`."""
