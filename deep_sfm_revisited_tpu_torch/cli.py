"""Command-line entry point of the port (port of `deep_sfm_revisited_tpu/cli.py`).

The JAX CLI's flags (the reference's `main.py:66-115` surface plus
`--override k=v`). Ported:

- `-v`: the Eigen-protocol evaluation of SFMNet over the KITTI raw (or VO)
  test split;
- without `-v`: training, the recipe's frozen-flow depth step (`train/
  loop.py::fit`): the KITTI train split with the recipe's augmentation,
  `train.epochs` epochs, a validation and a checkpoint after each, resumed
  from `--start-epoch` with `--pretrained`; with `--override
  train.fix_flownet=False` the flow net (DICL or PWC-DC) trains too, on the
  flow loss of batches that carry flow GT;
- `--record-pose`: the pose errors of the test split in both directions
  (`train/pose_eval.py::record_pose_errors`) and, with `--dataset
  kitti_vo`, the odometry report of each test sequence (ATE, RPE, the KITTI
  segment errors);
- `--save-pose`: the predicted poses of both splits, written into the
  dataset tree where the loaders read them back for training with
  `--override pred_pose_online=False`;
- `--train-flow`: flow pretraining of DICL, PWC-DC or RAFT (`--override
  flow.estimator=PWC` / `RAFT`; `train/flow_trainer.py::flow_fit`) over a
  flow benchmark (`--flow-dataset`, augmented and cropped to `--flow-crop`),
  the per-epoch EPE / Fl-all validation, checkpoints under
  `{out}/{tag}_flow/ckpt`, which `--pretrained-flow` restores into the
  composite. DICL pads its input to /128 and the flow GT is not padded, so
  the crop's sides must be multiples of 128 (as in JAX). PWC-DC's and
  RAFT's batches and validation pairs are padded to /8, as in JAX. PWC-DC
  takes only sides that are multiples of 64: a crop or validation pair
  that is not one after the padding is refused with a ValueError before
  the first step (JAX fails there at the validation, after the epoch).
  RAFT's crop must be a multiple of 8 itself (the padding would part the
  prediction from the unpadded flow GT): another is refused likewise.

Weights are random from `train.seed`, or restored: `--pretrained` (the
port's checkpoint: model, optimizer and step in training, the model alone
with `-v`), `--pretrained-flow` / `--pretrained-depth` (one network of a
port checkpoint) and `--pretrained-torch` (a reference-named state dict:
what the weight tables cover is loaded, the counts of missing and unused
keys are printed, as the JAX CLI does; the pose net is left untouched, as
the JAX CLI's converter call leaves it).

    python -m deep_sfm_revisited_tpu_torch.cli --data /path/KITTI --cfg kitti -v \\
        [--override flow.estimator=PWC|RAFT] [--pretrained-torch kitti.pth.tar]
    python -m deep_sfm_revisited_tpu_torch.cli --data /path/KITTI --cfg kitti -b 4 \\
        --gt-depth-dir /path/gt_depth [--epochs 12] [--pretrained out/kitti/ckpt --start-epoch 3]
    python -m deep_sfm_revisited_tpu_torch.cli --data /path/KITTI_odometry --cfg kitti \\
        --dataset kitti_vo --record-pose [--override pose.estimator=POSENET]
    python -m deep_sfm_revisited_tpu_torch.cli --data /path/KITTI --cfg kitti --save-pose
    python -m deep_sfm_revisited_tpu_torch.cli --data /path/data_scene_flow --cfg kitti \
        --train-flow --flow-dataset kitti --flow-crop 256 768 -b 4 --epochs 1

All run on the GPU; `main(argv, device="cpu")` asks for the CPU (the tests
do). Without a GPU and without that argument it raises.
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
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--nlabel", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("-v", "--validate", action="store_true")
    p.add_argument("--fix-flownet", action="store_true")
    p.add_argument("--fix-depthnet", action="store_true")
    p.add_argument("--pretrained", default=None,
                   help="the port's checkpoint directory (or file) to restore")
    p.add_argument("--pretrained-flow", default=None)
    p.add_argument("--pretrained-depth", default=None)
    p.add_argument("--pretrained-torch", default=None,
                   help="state dict under the reference's module names "
                        "(a reference .pth.tar); loads what the weight tables cover")
    p.add_argument("--gt-depth-dir", default=None)
    p.add_argument("--train-flow", action="store_true",
                   help="flow pretraining of the flow net over a flow benchmark "
                        "(the reference's cfg.TRAIN_FLOW path)")
    p.add_argument("--flow-dataset", default="kitti",
                   choices=["chairs", "things", "sintel", "kitti", "hd1k"])
    p.add_argument("--flow-crop", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="override the flow augmentor's crop size")
    p.add_argument("--record-pose", action="store_true")
    p.add_argument("--save-pose", action="store_true")
    p.add_argument("--out", default="output")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides, e.g. pose.ransac_iter=3")
    return p


def config_from_args(args):
    """The JAX CLI's config assembly (`cli.py:70-103`): the recipe or YAML,
    then the flags (`--lr`, `--fix-flownet`, `--fix-depthnet` among them),
    then `--override`."""
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
    if args.lr is not None:
        over["train.lr"] = args.lr
    if args.nlabel is not None:
        over["depth.nlabel"] = args.nlabel
    if args.epochs is not None:
        over["train.epochs"] = args.epochs
    if args.dataset is not None:
        over["data.dataset"] = args.dataset
    if args.fix_flownet:
        over["train.fix_flownet"] = True
    if args.fix_depthnet:
        over["train.fix_depthnet"] = True
    if args.workers:
        over["data.workers"] = args.workers
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            over[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            over[k] = v
    return cfg.override(**over)


def build_flow_dataset(name: str, root: str, augment: bool, crop=None):
    """One flow benchmark's dataset (JAX `build_flow_dataset`, `cli.py:252-265`),
    with `crop` replacing the augmentor's default crop size."""
    from deep_sfm_revisited_tpu_torch.data import flow_datasets as fd

    kw = {"augment": augment}
    if crop is not None:
        kw["crop_size"] = tuple(crop)
    builders = {"chairs": fd.FlyingChairs, "things": fd.FlyingThings3D, "sintel": fd.MpiSintel,
                "kitti": fd.KITTIFlow, "hd1k": fd.HD1K}
    return builders[name](root, **kw)


def train_flow_main(args, cfg, dev):
    """The `--train-flow` branch (JAX `train_flow_main`, `cli.py:268-296`):
    the augmented train split and the plain validation split of
    `--flow-dataset`, batches padded to /128 for DICL (/8 otherwise), and
    `flow_fit` writing into `{out}/{tag}_flow`. For PWC-DC the padded crop
    and the padded size of the first validation pair must be multiples of
    64 (`models/pwcnet.py::check_size`), for RAFT the crop a multiple of 8
    (`models/raft.py::check_size`), checked before the first step.
    Returns its epoch records."""
    from deep_sfm_revisited_tpu_torch.data.loader import BatchLoader
    from deep_sfm_revisited_tpu_torch.train.flow_trainer import flow_fit

    train_ds = build_flow_dataset(args.flow_dataset, args.data, augment=True,
                                  crop=args.flow_crop)
    val_ds = build_flow_dataset(args.flow_dataset, args.data, augment=False)
    pad = 128 if cfg.flow.estimator == "DICL" else 8
    if cfg.flow.estimator == "PWC":
        from deep_sfm_revisited_tpu_torch.models.pwcnet import check_size

        up = lambda n: -(-n // pad) * pad   # noqa: E731
        sizes = [tuple(train_ds.augmentor.crop_size)] if train_ds.augmentor is not None else []
        if len(val_ds):
            sizes.append(val_ds[0]["ref"].shape[:2])
        for h, w in sizes:
            check_size(up(h), up(w))
    elif cfg.flow.estimator == "RAFT" and train_ds.augmentor is not None:
        from deep_sfm_revisited_tpu_torch.models.raft import check_size

        check_size(*train_ds.augmentor.crop_size)
    loader = BatchLoader(train_ds, cfg.train.batch_size, workers=cfg.data.workers,
                         pad_multiple=pad, seed=cfg.train.seed)
    return flow_fit(cfg, loader, f"{args.out}/{cfg.tag}_flow", val_dataset=val_ds, device=dev,
                    eval_pad_multiple=pad)


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


def build_train_loader(cfg, args):
    """The train half of the JAX CLI's `build_loaders` (`cli.py:106-164`):
    random zoom, crop to `data.train_size`, horizontal flip, color jitter,
    and the raw split's random pair offset and direction."""
    from deep_sfm_revisited_tpu_torch.data import (BatchLoader, Compose, KittiRawDataset,
                                                   KittiVODataset, Normalize, RandomCrop,
                                                   RandomZoom)
    from deep_sfm_revisited_tpu_torch.data.transforms import ColorJitter, RandomHorizontalFlip

    d = cfg.data
    tf = Compose(([RandomZoom()] if d.zoom_input else []) + [RandomCrop(d.train_size)]
                 + ([RandomHorizontalFlip()] if d.flip_aug else []) + [ColorJitter(), Normalize()])
    if d.dataset == "kitti_vo":
        ds = KittiVODataset(args.data, train=True, skip=d.skip, transform=tf)
    else:
        ds = KittiRawDataset(args.data, train=True, gt_depth_dir=args.gt_depth_dir, transform=tf,
                             random_offset=d.random_offset, random_fw_bw=d.random_fw_bw)
    return BatchLoader(ds, cfg.train.batch_size, workers=d.workers,
                       pad_multiple=d.pad_multiple, seed=cfg.train.seed)


def apply_pretrained(args, model, trainer=None) -> None:
    """The `--pretrained*` restores (JAX `apply_pretrained`, `cli.py:167-221`)
    onto a fresh model: `--pretrained` restores the whole trainer (model,
    optimizer, step) when one is given and the model alone otherwise;
    `--pretrained-flow` / `--pretrained-depth` merge one network;
    `--pretrained-torch` loads what the weight tables cover of a
    reference-named state dict (`load_pretrained_torch`)."""
    from deep_sfm_revisited_tpu_torch.train import checkpoint as ckpt

    if args.pretrained:
        if trainer is not None:
            ckpt.restore_checkpoint(args.pretrained, trainer)
        else:
            ckpt.restore_model(args.pretrained, model)
    if args.pretrained_flow:
        ckpt.restore_subtree(args.pretrained_flow, model, "flow_net")
    if args.pretrained_depth:
        ckpt.restore_subtree(args.pretrained_depth, model, "depth_net")
    if args.pretrained_torch:
        load_pretrained_torch(args.pretrained_torch, model, model.cfg)


def load_pretrained_torch(path: str, model, cfg) -> dict:
    """JAX `apply_pretrained`'s `--pretrained-torch` branch (`cli.py:187-219`):
    a network whose estimator has no weight table is left untouched (both
    without one: exit), the other is loaded from what the tables cover, and
    the counts of missing and unused keys are printed. Returns the report of
    `utils/weights.py::load_reference_state`."""
    from deep_sfm_revisited_tpu_torch.utils.weights import (FLOW_ENTRIES, load_reference_checkpoint,
                                                            load_reference_state)

    flow = cfg.flow.estimator if cfg.flow.estimator in FLOW_ENTRIES else None
    depth = cfg.depth.estimator if cfg.depth.estimator == "PSNET" else None
    if flow is None:
        print(f"torch port: no table for flow estimator {cfg.flow.estimator} "
              "- leaving flow_net untouched")
    if depth is None:
        print(f"torch port: no table for depth estimator {cfg.depth.estimator} "
              "- leaving depth_net untouched")
    if flow is None and depth is None:
        raise SystemExit("--pretrained-torch: no port table for either configured estimator")
    report = load_reference_state(model, load_reference_checkpoint(path), flow, depth,
                                  context_bn=cfg.depth.context_bn,
                                  dep_context=cfg.depth.psnet_dep_context)
    if report["missing"] or report["unused"]:
        print(f"torch port: {len(report['missing'])} missing, {len(report['unused'])} unused "
              "torch keys (strict=False semantics, main.py:203)")
    return report


def make_pose_forward(model, diag: bool = False):
    """The early-return pose forward (JAX `make_pose_forward`, `cli.py:223-
    249`) of `model`, an SFMNet built with `record_pose=True` (in bf16
    autocast where `train.mixed_prec` is set, as `main` builds it):
    (ref, target, K, generator) -> pose (B, 3, 4), or with `diag` (pose,
    num_matches), num_matches None on routes without a confidence. Inputs
    move to the model's device; eval mode, no gradient."""
    if not model.cfg.record_pose:
        raise ValueError("make_pose_forward wants a model built with record_pose=True")
    dev = model.device

    def fwd(ref, target, K, generator):
        model.eval()
        with torch.no_grad():
            out = model(ref.to(dev), target.to(dev), K.to(dev), generator=generator)
        return (out["pose"], out.get("num_matches")) if diag else out["pose"]

    return fwd


def _pose_tools(args, cfg, dev, model):
    """The `--record-pose` / `--save-pose` branches (JAX `_eval_tools`,
    `cli.py:397-478`). The port is one process, so no barrier."""
    from deep_sfm_revisited_tpu_torch.data import (Compose, KittiRawDataset, KittiVODataset,
                                                   Normalize)
    from deep_sfm_revisited_tpu_torch.train import pose_eval

    def generator():
        return torch.Generator(device=dev).manual_seed(0)

    tf = Compose([Normalize()])
    if args.record_pose:
        results = pose_eval.record_pose_errors(build_val_loader(cfg, args),
                                               make_pose_forward(model, diag=True), generator(),
                                               min_matches=cfg.pose.min_matches)
        print({k: round(v, 6) for k, v in results.items()})
        if cfg.data.dataset == "kitti_vo":
            ds = KittiVODataset(args.data, train=False, skip=cfg.data.skip, transform=tf)
            odo = pose_eval.evaluate_vo_odometry(ds, make_pose_forward(model), generator(),
                                                 pad_multiple=cfg.data.pad_multiple)
            for seq, rep in odo.items():
                print(f"seq {seq:02d}: ATE {rep['ate_rmse']:.3f} m  "
                      f"t_err {rep['t_err_pct']:.2f} %  "
                      f"r_err {rep['r_err_deg_per_100m']:.4f} deg/100m")
            results["odometry"] = odo
        return results

    # --save-pose: deterministic datasets over both splits, for
    # pred_pose_online=False training (save_pose, main.py:636-703)
    fwd = make_pose_forward(model)
    written = []
    for train_split in (True, False):
        if cfg.data.dataset == "kitti_vo":
            ds = KittiVODataset(args.data, train=train_split, skip=cfg.data.skip, transform=tf)
            written.extend(pose_eval.save_vo_pred_poses(ds, fwd, args.data, generator(),
                                                        pad_multiple=cfg.data.pad_multiple))
        else:
            ds = KittiRawDataset(args.data, train=train_split, gt_depth_dir=args.gt_depth_dir,
                                 transform=tf, random_offset=False, random_fw_bw=False)
            written.extend(pose_eval.save_raw_pred_poses(ds, fwd, args.data, generator(),
                                                         pad_multiple=cfg.data.pad_multiple))
    print(f"saved predicted poses for {len(written)} entries")
    return written


def main(argv=None, device: str | torch.device = "cuda"):
    """Run the CLI. `-v` returns the mean Eigen metrics {name: float};
    training returns `fit`'s record of each epoch it ran (`--train-flow`
    `flow_fit`'s); `--record-pose`
    the pose errors {name: float} (with `odometry`: {seq: report} on
    kitti_vo); `--save-pose` what it wrote (file paths on the raw split,
    sequence numbers on VO)."""
    from deep_sfm_revisited_tpu_torch.config import save_config
    from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
    from deep_sfm_revisited_tpu_torch.train.evaluate import validate
    from deep_sfm_revisited_tpu_torch.utils.logging import MetricLogger

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    dev = resolve_device(device)
    if args.train_flow:
        return train_flow_main(args, cfg, dev)

    if not (args.validate or args.record_pose or args.save_pose):
        from deep_sfm_revisited_tpu_torch.train.loop import fit

        return fit(cfg, build_train_loader(cfg, args), build_val_loader(cfg, args),
                   out_dir=args.out, device=dev,
                   restore_fn=lambda trainer: apply_pretrained(args, trainer.model, trainer),
                   start_epoch=args.start_epoch)

    out = os.path.join(args.out, cfg.tag)
    os.makedirs(out, exist_ok=True)
    save_config(cfg, os.path.join(out, "config.yaml"))
    dtype = torch.bfloat16 if cfg.train.mixed_prec else torch.float32
    if args.record_pose or args.save_pose:
        model = SFMNet(cfg.override(record_pose=True), dtype=dtype, device=dev,
                       seed=cfg.train.seed)
        apply_pretrained(args, model)
        return _pose_tools(args, cfg, dev, model)
    loader = build_val_loader(cfg, args)
    model = SFMNet(cfg, dtype=dtype, device=dev, seed=cfg.train.seed)
    apply_pretrained(args, model)
    mlog = MetricLogger(out, "test")
    results = validate(loader, model, cfg, generator=torch.Generator(device=dev).manual_seed(0),
                       metric_logger=mlog)
    mlog.scalars(results, 0)
    mlog.close()
    print({k: round(v, 4) for k, v in results.items()})
    return results


if __name__ == "__main__":
    main()
