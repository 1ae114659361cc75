"""The training step (port of `deep_sfm_revisited_tpu/train/trainer.py`).

The reference's `train_epoch` step (`main.py:295-450`) as the JAX package
builds it: random photometric noise, SFMNet in train mode, the masked
smooth-L1 depth loss (plus the MSE pose loss on the PoseNet route), Adam with milestone decay (`main.py:212,245`), frozen
subtrees left out of the optimizer (the effect of optax's `set_to_zero`,
`--fix-flownet` / `--fix-depthnet`, `main.py:222-233`); with the flow net
trained (`train.fix_flownet=False`, DICL), the flow loss of a batch that
carries flow GT. Mixed precision is
the model's bf16 autocast; parameters and the optimizer stay float32, and
bf16's float32 exponent range needs no loss scaling (the JAX package's
reasoning, `trainer.py:11-13`).

The JAX package's `ChainedStep` fuses K steps into one TPU dispatch; here
each step is one eager forward, backward and Adam update.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from deep_sfm_revisited_tpu_torch.config import SfMConfig
from deep_sfm_revisited_tpu_torch.train.losses import depth_training_loss, pose_regression_loss

# SFMNet's submodule for each subtree name of the JAX package's parameters
# that can be frozen; PoseNet (`posenet`, JAX `pose_net`) always trains
# (JAX `trainer.py:80-82`)
SUBTREES = {"flow_net": "flow_estimator", "depth_net": "depth_estimator"}


def milestone_schedule(lr: float, milestones, gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """MultiStepLR per optimizer step (JAX `milestone_schedule`, optax's
    piecewise-constant schedule): lr times gamma for every milestone epoch m
    with step >= m steps_per_epoch."""
    boundaries = sorted({int(m) * steps_per_epoch for m in milestones})

    def schedule(step: int) -> float:
        v = lr
        for b in boundaries:
            if step >= b:
                v = v * gamma
        return v

    return schedule


def build_optimizer(model: torch.nn.Module, cfg: SfMConfig) -> torch.optim.Adam:
    """Adam (betas from the config, eps 1e-8 as optax's) over every
    parameter outside the frozen subtrees (JAX `build_optimizer`,
    `trainer.py:69-92`); the learning rate is set per step by the schedule."""
    t = cfg.train
    frozen = {SUBTREES[name] for name, fixed in (("flow_net", t.fix_flownet),
                                                 ("depth_net", t.fix_depthnet)) if fixed}
    params = [p for name, p in model.named_parameters() if name.split(".")[0] not in frozen]
    return torch.optim.Adam([{"params": params}], lr=t.lr, betas=(t.beta1, t.beta2), eps=1e-8)


def add_image_noise(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                    max_std: float = 3.0 / 255) -> Dict[str, torch.Tensor]:
    """Gaussian photometric noise with one std ~ U(0, max_std) per batch on
    ref and target, clipped to [-1, 1] (`main.py:315-317`). The draws come
    from `generator`, which lives on the batch's device."""
    dev = batch["ref"].device
    std = torch.rand((), generator=generator, device=dev) * max_std
    out = dict(batch)
    for k in ("ref", "target"):
        noise = torch.randn(batch[k].shape, generator=generator, device=dev)
        out[k] = torch.clamp(batch[k] + std * noise, -1.0, 1.0)
    return out


# depth nets whose forward returns no `depth_init` (JAX `PANet` returns
# (None, depth), `models/depth_alternates.py:219`)
NO_DEPTH_INIT = ("PANET",)


def refuse_depth_without_init(cfg: SfMConfig) -> None:
    """Refuse, before a step, a depth net that returns no `depth_init`: the
    JAX trainer hands `out["depth_init"]` to `depth_training_loss`
    (`train/trainer.py:216-217`), whose `smooth_l1(None, gt)` fails
    (`train/losses.py:24-27`), so JAX cannot train it, and the port adds no
    loss that JAX lacks."""
    if cfg.depth.estimator in NO_DEPTH_INIT:
        raise NotImplementedError(
            f"depth.estimator = {cfg.depth.estimator!r} returns no depth_init, which the depth "
            "loss takes: the JAX trainer fails on it too (train/trainer.py:216-217 passes None "
            "to depth_training_loss, train/losses.py:24-27), so it does not train")


def loss_and_metrics(model, cfg: SfMConfig, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Dict[str, torch.Tensor]] = None):
    """One forward of the training objective (JAX `_build_loss_fn`,
    `trainer.py:193-284`: the depth-loss, flow-loss, pose-loss and
    degenerate-pair terms) ->
    (loss, {metric: 0-d tensor}, model outputs)."""
    t, d = cfg.train, cfg.depth
    out = model(batch["ref"], batch["target"], batch["intrinsics"],
                pose_gt=batch.get("pose_gt"), pred_pose=batch.get("pred_pose"),
                use_gt_pose=cfg.use_gt_pose, generator=generator, draws=draws)
    loss, aux = depth_training_loss(
        out["depth_init"].float(), out["depth"].float(), batch["depth_gt"].float(),
        batch["pose_gt"].float(), nlabel=d.nlabel, min_depth=d.min_depth,
        rescale_depth=t.rescale_depth, norm_target=t.norm_target,
        min_train_scale=t.min_train_scale, max_train_scale=t.max_train_scale,
        init_weight=t.depth_init_weight, remask=t.rescale_depth_remask)
    if not t.fix_flownet and out.get("flow_all") is not None and "flow_gt" in batch:
        # the flow loss of a batch with flow GT when the flow net trains
        # (JAX `trainer.py:230-258`); KITTI depth batches carry none
        from deep_sfm_revisited_tpu_torch.train.flow_trainer import flow_loss

        fl = flow_loss(cfg.flow, out["flow_all"], batch["flow_gt"].float(),
                       batch.get("flow_valid"))
        loss = loss + fl
        aux = dict(aux, flow_loss=fl)
    if out.get("num_matches") is not None:
        # degenerate-pair observability: mean confident-candidate count and
        # the share of frames that fell back to the uniform grid
        nm = out["num_matches"].float()
        aux = dict(aux, num_matches=torch.mean(nm),
                   uniform_fallback=torch.mean((nm < cfg.pose.min_matches).float()))
    if out.get("rt") is not None:
        # PoseNet supervision on its raw output, whenever it predicts the
        # pose online (main.py:396-408)
        pl = pose_regression_loss(out["rt"].float(), batch["pose_gt"].float(),
                                  rot_weight=t.pose_rot_weight)
        loss = loss + pl
        aux = dict(aux, pose_loss=pl)
    return loss, aux, out


class Trainer:
    """The model, its optimizer and the step count; `train_step` is one
    optimization step (JAX `_apply_train_step` with the noise of
    `ChainedStep`)."""

    def __init__(self, model, cfg: SfMConfig, steps_per_epoch: int):
        refuse_depth_without_init(cfg)
        self.model = model
        self.cfg = cfg
        self.optimizer = build_optimizer(model, cfg)
        t = cfg.train
        self.schedule = milestone_schedule(t.lr, t.milestones, t.lr_decay, steps_per_epoch)
        self.step = 0

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, noise: bool = True,
                   draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Noise (unless `noise=False`), forward in train mode, backward, one
        Adam update at the schedule's rate for this step. Returns the
        metrics {loss, depth_init, depth_out, valid_frac[, num_matches,
        uniform_fallback][, pose_loss]} as detached 0-d tensors on the device."""
        self.model.train()
        if noise:
            batch = add_image_noise(batch, generator)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        loss, aux, _ = loss_and_metrics(self.model, self.cfg, batch, generator, draws)
        self.model.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in dict(aux, loss=loss).items()}

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
