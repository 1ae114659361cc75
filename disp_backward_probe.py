#!/usr/bin/env python3
"""Kernel-only check and timing of B1's displacement-volume backward on one CUDA device.

    python3 disp_backward_probe.py      # from the repository root

Builds B1's source and operators and prints `nvcc -Xptxas -v`'s registers
and spills for the backward's instantiations, then at the five levels of a
DICL flow-training step (b = 4, 256x768: 64x192 down to 4x12, C = 32; no
flow at the coarsest) and at md 0 and 4 on the two finest, with random
gradients, features holding an all-zero patch and random flows of a few
pixels: the kernel's dx and dy against
`models/dicl.py::displacement_volume_backward_plain` (equality and the
largest |kernel - plain| over the plain tensor's max), two launches against
each other, and in bf16 at md 3 the mean time of 20 launches by CUDA events,
summed over the five levels. Then one DICL train forward and backward at
that shape in bf16 autocast, counting the backward's launches and the peak
memory. `chip_smoke.py` phase 17 checks and times the kernel on the inputs
the real training step gives it (with `--old-b1`, an earlier kernel in
turns); this script needs no training run.
"""

import re
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from deep_sfm_revisited_tpu_torch.config import SfMConfig  # noqa: E402
from deep_sfm_revisited_tpu_torch.models import dicl  # noqa: E402
from deep_sfm_revisited_tpu_torch.ops.cuda import sweep_warp  # noqa: E402

LEVELS = [((4, 32, 64, 192), True), ((4, 32, 32, 96), True), ((4, 32, 16, 48), True),
          ((4, 32, 8, 24), True), ((4, 32, 4, 12), False)]


def events_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def backward_registers(build_log: str) -> list:
    """(instantiation, registers, stack bytes, spill store bytes, spill load
    bytes) of each `displacement_backward_kernel` in `nvcc -Xptxas -v`'s
    output; the instantiation is the tail of its mangled name (T, MD,
    VEC)."""
    pat = (r"Compiling entry function '(\S*displacement_backward_kernel\S*)'.*?(\d+) bytes "
           r"stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) "
           r"registers")
    return [(m[1][-40:], int(m[5]), int(m[2]), int(m[3]), int(m[4]))
            for m in re.finditer(pat, build_log, re.S)]


def main() -> int:
    if not torch.cuda.is_available():
        print("disp_backward_probe: needs a CUDA device", file=sys.stderr)
        return 2
    t0 = time.time()
    for b in sweep_warp.BUILDS:
        b.build()
    print(f"built in {time.time() - t0:.1f} s")
    for name, regs, stack, spill_st, spill_ld in backward_registers(sweep_warp.KERNEL.build_log):
        print(f"  nvcc: {name} registers {regs}, stack {stack} B, spill stores {spill_st} B, "
              f"loads {spill_ld} B")
    step_ms = 0.0
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    for md in (3, 0, 4):
        for shape, warped in LEVELS[:(5 if md == 3 else 2)]:
            B, C, h, w = shape
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn(shape, device=dev, generator=g).to(dt)
                y = torch.randn(shape, device=dev, generator=g).to(dt)
                y[:, :, h // 4:h // 2, w // 4:w // 2] = 0
                flow = (torch.randn((B, 2, h, w), device=dev, generator=g) * 4) if warped else None
                S = 2 * md + 1
                dout = torch.randn((B, S * S, 2 * C, h, w), device=dev, generator=g).to(dt)
                dx, dy = sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)
                dx2, dy2 = sweep_warp.displacement_volume_backward_cuda(dout, y, flow, md)
                px, py = dicl.displacement_volume_backward_plain(dout, x, y, flow, md)
                torch.cuda.synchronize()
                ex = float((dx.float() - px.float()).abs().max() / px.float().abs().max())
                ey = float((dy.float() - py.float()).abs().max() / py.float().abs().max())
                print(f"md {md} {shape} flow {warped} {str(dt)[6:]}: dx == plain "
                      f"{torch.equal(dx, px)} ({ex:.2e}), dy == plain {torch.equal(dy, py)} "
                      f"({ey:.2e}); relaunch dx equal {torch.equal(dx, dx2)}, dy differs by "
                      f"{float((dy2.float() - dy.float()).abs().max()):.2e}")
                if md == 3 and dt == torch.bfloat16:
                    ms = events_ms(lambda: sweep_warp.displacement_volume_backward_cuda(
                        dout, y, flow, md))
                    step_ms += ms
                    print(f"   {ms:.4f} ms by events, dout {dout.numel() * 2 / 1e6:.1f} MB")
    print(f"per flow-training step (five levels, md 3, bf16): {step_ms:.4f} ms by events")
    net = dicl.DICLFlow(SfMConfig.kitti().flow).to(dev).train()
    pair = torch.randn((4, 256, 768, 6), device=dev, generator=g)
    n0 = sweep_warp.DISPLACEMENT_BACKWARD.launches
    with torch.autocast("cuda", torch.bfloat16):
        stack, _ = net(pair, all_iters=True)
    stack.float().square().mean().backward()
    torch.cuda.synchronize()
    finite = all(torch.isfinite(p.grad).all().item() for p in net.parameters()
                 if p.grad is not None)
    print(f"DICL train backward: {sweep_warp.DISPLACEMENT_BACKWARD.launches - n0} launches, "
          f"gradients finite {finite}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
