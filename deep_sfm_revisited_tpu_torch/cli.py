"""Command-line entry point of the port (port of `deep_sfm_revisited_tpu/cli.py`).

The JAX CLI's flags for evaluation (the reference's `main.py:66-115`
surface plus `--override k=v`). Ported: `-v`, the Eigen-protocol
evaluation of SFMNet over the KITTI raw (or VO) test split, with random
weights from `train.seed` or a reference-named state dict
(`--pretrained-torch`, loaded strictly). The JAX CLI's other modes
(training, `--train-flow`, `--record-pose`, `--save-pose`, the
`--pretrained*` checkpoint restores) are accepted and raise
NotImplementedError; the flags only they read are not taken.

    python -m deep_sfm_revisited_tpu_torch.cli --data /path/KITTI --cfg kitti -v \\
        [--override flow.estimator=PWC] [--pretrained-torch kitti.pth.tar]

The evaluation runs on the GPU; `main(argv, device="cpu")` asks for the CPU
(the tests do). Without a GPU and without that argument it raises.
"""

from __future__ import annotations

import argparse
import ast
import os

import torch

from deep_sfm_revisited_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Deep-SfM on PyTorch/CUDA: two-view flow + pose + depth")
    p.add_argument("--data", required=True, help="dataset root")
    p.add_argument("--cfg", default=None,
                   help="'kitti' for the builtin recipe, or a YAML path")
    p.add_argument("--dataset", default=None, choices=[None, "kitti_raw", "kitti_vo"])
    p.add_argument("-b", "--batch-size", type=int, default=None)
    p.add_argument("--nlabel", type=int, default=None)
    p.add_argument("-v", "--validate", action="store_true")
    p.add_argument("--pretrained", default=None, help="checkpoint dir to restore")
    p.add_argument("--pretrained-flow", default=None)
    p.add_argument("--pretrained-depth", default=None)
    p.add_argument("--pretrained-torch", default=None,
                   help="state dict under the reference's module names "
                        "(a reference .pth.tar), loaded strictly")
    p.add_argument("--gt-depth-dir", default=None)
    p.add_argument("--train-flow", action="store_true")
    p.add_argument("--record-pose", action="store_true")
    p.add_argument("--save-pose", action="store_true")
    p.add_argument("--out", default="output")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides, e.g. pose.ransac_iter=3")
    return p


def config_from_args(args):
    """The JAX CLI's config assembly (`cli.py:70-103`), eval flags."""
    from deep_sfm_revisited_tpu_torch.config import SfMConfig, config_from_yaml

    if args.cfg == "kitti":
        cfg = SfMConfig.kitti(nlabel=args.nlabel or 128)
    elif args.cfg:
        cfg = config_from_yaml(args.cfg)
    else:
        cfg = SfMConfig()
    over = {}
    if args.batch_size is not None:
        over["train.batch_size"] = args.batch_size
    if args.nlabel is not None:
        over["depth.nlabel"] = args.nlabel
    if args.dataset is not None:
        over["data.dataset"] = args.dataset
    if args.workers:
        over["data.workers"] = args.workers
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            over[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            over[k] = v
    return cfg.override(**over)


def _check_ported(args) -> None:
    unported = [("--train-flow", args.train_flow), ("--record-pose", args.record_pose),
                ("--save-pose", args.save_pose), ("--pretrained", args.pretrained),
                ("--pretrained-flow", args.pretrained_flow),
                ("--pretrained-depth", args.pretrained_depth),
                ("training (no -v)", not args.validate)]
    for flag, given in unported:
        if given:
            raise NotImplementedError(f"{flag} is not ported yet")


def build_val_loader(cfg, args):
    """The eval half of the JAX CLI's `build_loaders` (`cli.py:106-164`)."""
    from deep_sfm_revisited_tpu_torch.data import (BatchLoader, Compose, KittiRawDataset,
                                                   KittiVODataset, Normalize)

    tf = Compose([Normalize()])
    if cfg.data.dataset == "kitti_vo":
        ds = KittiVODataset(args.data, train=False, transform=tf)
    else:
        ds = KittiRawDataset(args.data, train=False, kitti_697=cfg.data.kitti_697,
                             gt_depth_dir=args.gt_depth_dir, transform=tf,
                             eigen_sfm=cfg.data.eigen_sfm,
                             filtered_pair=cfg.data.filtered_pair)
    return BatchLoader(ds, 1, shuffle=False, workers=cfg.data.workers,
                       pad_multiple=cfg.data.pad_multiple, drop_last=False)


def main(argv=None, device: str | torch.device = "cuda"):
    """Run the CLI; `-v` returns the mean Eigen metrics {name: float}."""
    from deep_sfm_revisited_tpu_torch.config import save_config
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
    from deep_sfm_revisited_tpu_torch.train.evaluate import validate
    from deep_sfm_revisited_tpu_torch.utils.logging import MetricLogger
    from deep_sfm_revisited_tpu_torch.utils.weights import load_reference_checkpoint

    args = build_parser().parse_args(argv)
    _check_ported(args)
    cfg = config_from_args(args)
    dev = resolve_device(device)

    out = os.path.join(args.out, cfg.tag)
    os.makedirs(out, exist_ok=True)
    save_config(cfg, os.path.join(out, "config.yaml"))
    loader = build_val_loader(cfg, args)
    dtype = torch.bfloat16 if cfg.train.mixed_prec else torch.float32
    model = SFMNet(cfg, dtype=dtype, device=dev, seed=cfg.train.seed)
    if args.pretrained_torch:
        model.load_state_dict(load_reference_checkpoint(args.pretrained_torch), strict=True)
    results = validate(loader, model, cfg, generator=torch.Generator(device=dev).manual_seed(0))
    mlog = MetricLogger(out, "test")
    mlog.scalars(results, 0)
    mlog.close()
    print({k: round(v, 4) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
