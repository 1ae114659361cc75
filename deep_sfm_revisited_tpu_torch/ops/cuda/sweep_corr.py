"""Kernels K1 and K2: REGNet's sweep correlation and its backward, in CUDA for
Hopper.

K1 is B1's gather (`deep_sfm_revisited_tpu/ops/pallas/sweep_warp.py::
bilinear_sample_pallas`, `pallas_call` at `:145`) as the JAX package's REGNet
reaches it, over its pose hypotheses, fused with REGNet's channel mean
(JAX `models/depth_alternates.py:244-255`); K2 is its gradient with respect
to both feature maps. One source, `csrc/sweep_corr.cu` (its header says what
bounds each kernel and how its design answers that), built at first use by
`ops/cuda/build.py`; `csrc/sweep_corr_ops.cpp` registers its entry points as
the PyTorch operators `torch.ops.dsfm_sweep.*` (`OPS`), through which each
wrapper launches and adds one to its own count:

- `sweep_correlation_cuda` (`CORRELATION.launches`): the (B, S, D, H, W)
  float32 correlation, memory order (B, D, H, W, S). Plain version
  `ops/camera.py::sweep_correlation_plain`.
- `sweep_correlation_backward_cuda` (`CORRELATION_BACKWARD.launches`): its
  gradient with respect to ref and tgt. Plain version
  `ops/camera.py::sweep_correlation_backward_plain`.

`ops/camera.py::SweepCorrelationFn` sends CUDA tensors here, and CPU tensors
to the plain versions.
"""

from __future__ import annotations

import torch

from deep_sfm_revisited_tpu_torch.ops.cuda.build import CudaKernel, TorchOps


def _cuda_only(what: str, *tensors: torch.Tensor) -> None:
    """Refuse CPU tensors before anything is built (the operators check the
    rest)."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the {what} takes CUDA tensors only")


class SweepCorrelationKernel(CudaKernel):
    """K1's and K2's library (plain C launchers, linked by `OPS`); launches
    K1 and owns its launch count."""

    source = "sweep_corr.cu"

    def __init__(self):
        super().__init__()
        self._op = None

    def _bind(self, lib) -> None:
        """Nothing to bind: the operators of `OPS` call the launchers."""

    def __call__(self, ref: torch.Tensor, tgt: torch.Tensor, depths: torch.Tensor,
                 M: torch.Tensor, Kt: torch.Tensor) -> torch.Tensor:
        """ref, tgt (B, H, W, C) f32/bf16; depths (D,), M (B S, 3, 3), Kt (B S,
        3) f32 -> (B, S, D, H, W) float32 with channels-last-3d strides."""
        op = self._op
        if op is None:
            _cuda_only("sweep correlation", ref, tgt, depths, M, Kt)
            op = self._op = OPS.build().sweep_correlation.default
        out = op(ref, tgt, depths, M, Kt)
        self.launches += 1
        return out


class SweepCorrelationBackward:
    """Launches K2 through `OPS`; owns its launch count."""

    def __init__(self):
        self.launches = 0
        self._op = None

    def __call__(self, g: torch.Tensor, ref: torch.Tensor, tgt: torch.Tensor,
                 depths: torch.Tensor, M: torch.Tensor,
                 Kt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """g (B, S, D, H, W) float32 with channels-last-3d strides, the
        correlation's gradient; the rest as K1 took them -> (dref, dtgt), each
        (B, H, W, C) in the features' dtype."""
        op = self._op
        if op is None:
            _cuda_only("sweep correlation backward", g, ref, tgt, depths, M, Kt)
            op = self._op = OPS.build().sweep_correlation_backward.default
        dref, dtgt = op(g, ref, tgt, depths, M, Kt)
        self.launches += 1
        return dref, dtgt


CORRELATION = SweepCorrelationKernel()
CORRELATION_BACKWARD = SweepCorrelationBackward()
OPS = TorchOps("sweep_corr_ops.cpp", CORRELATION, "dsfm_sweep")
BUILDS = (CORRELATION, OPS)   # what chip_smoke.py's setup builds, with B1's, B2's and R1's


def sweep_correlation_cuda(ref: torch.Tensor, tgt: torch.Tensor, depths: torch.Tensor,
                           M: torch.Tensor, Kt: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the current stream (see `SweepCorrelationKernel.__call__`)."""
    return CORRELATION(ref, tgt, depths, M, Kt)


def sweep_correlation_backward_cuda(g: torch.Tensor, ref: torch.Tensor, tgt: torch.Tensor,
                                    depths: torch.Tensor, M: torch.Tensor, Kt: torch.Tensor):
    """Launch K2 on the current stream (see `SweepCorrelationBackward.__call__`)."""
    return CORRELATION_BACKWARD(g, ref, tgt, depths, M, Kt)
