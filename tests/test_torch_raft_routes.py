"""The composite's other routes with RAFT as the flow net, on the CPU.

- `train.fix_flownet=False`: one depth step on a batch with flow GT trains
  RAFT through the flow loss (its sequence loss over the `all_iters`
  stack); every RAFT parameter gets the gradient of that loss alone,
  computed through a copy of RAFT at the step's starting weights (to 1e-6
  of each tensor's largest: the same graph, summed alike), and moves; the
  instance norms' scale and bias included. RANSAC's inputs are detached.
- `pose.estimator=POSENET` with RAFT: PoseNet takes RAFT's flow and no
  confidence (as on the PWC-DC route); a finite pose and `rt`.
- `cli --record-pose --dataset kitti_vo` with RAFT on a golden VO tree: the
  pose errors of both directions and each sequence's odometry report, with
  no confident-candidate counts (RAFT gives no confidence, so the sampler
  takes its uniform grid).

The numbers are held to JAX by tests/test_torch_raft.py (the network) and
tests/test_torch_train_raft_flow.py (its flow step); these check the
routes around it.
"""

import copy
import math

import numpy as np
import torch
from test_torch_train_step import OVER, _batch

from deep_sfm_revisited_tpu_torch import cli
from deep_sfm_revisited_tpu_torch.config import SfMConfig as TConfig
from deep_sfm_revisited_tpu_torch.data.synthetic import write_kitti_vo_tree
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
from deep_sfm_revisited_tpu_torch.train.flow_trainer import flow_loss
from deep_sfm_revisited_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
RAFT2 = {"flow.estimator": "RAFT", "flow.raft_iters_train": 2, "flow.raft_iters_eval": 2}


def test_depth_step_trains_raft_through_the_flow_loss():
    cfg = TConfig.kitti().override(**OVER, **RAFT2, **{"train.fix_flownet": False})
    model = SFMNet(cfg, device="cpu", seed=3)
    alone = copy.deepcopy(model.flow_estimator).train()
    trainer = Trainer(model, cfg, steps_per_epoch=10)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in _batch().items()}
    rng = np.random.RandomState(1)
    B, H, W = batch["ref"].shape[:3]
    batch["flow_gt"] = torch.from_numpy((np.broadcast_to(np.array([3.0, 1.0]), (B, H, W, 2))
                                         + rng.randn(B, H, W, 2)).astype(np.float32))
    batch["flow_valid"] = torch.from_numpy(rng.rand(B, H, W) < 0.6)
    m = trainer.train_step(batch, noise=False)
    assert math.isfinite(float(m["flow_loss"])) and float(m["flow_loss"]) > 0
    stack, _ = alone(torch.cat([batch["ref"], batch["target"]], dim=-1), all_iters=True)
    assert stack.shape == (2, B, H, W, 2)
    flow_loss(cfg.flow, stack, batch["flow_gt"], batch["flow_valid"]).backward()
    want = dict(alone.named_parameters())
    for k, p in model.flow_estimator.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, k
        scale = float(want[k].grad.abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[k].grad.numpy(), rtol=0,
                                   atol=1e-6 * scale, err_msg=k)
        assert not torch.equal(p.detach(), before[f"flow_estimator.{k}"]), k


def test_posenet_route_takes_raft_flow():
    cfg = TConfig.kitti().override(**OVER, **RAFT2, **{"pose.estimator": "POSENET"})
    model = SFMNet(cfg, device="cpu", seed=4)
    b = _batch()
    ref, tgt = (torch.from_numpy(b[k].astype(np.float32)) for k in ("ref", "target"))
    with torch.no_grad():
        out = model(ref, tgt, torch.from_numpy(b["intrinsics"].astype(np.float32)))
    assert out["rt"].shape == (ref.shape[0], 6) and torch.isfinite(out["rt"]).all()
    assert out["pose"].shape == (ref.shape[0], 3, 4) and torch.isfinite(out["pose"]).all()
    assert out["flow"].shape == (*ref.shape[:3], 2) and torch.isfinite(out["depth"]).all()


def test_cli_record_pose_on_the_raft_route(tmp_path):
    root = str(tmp_path / "vo")
    write_kitti_vo_tree(root, seqs=(0, 9, 10), n_frames=4, hw=(64, 128))
    over = {**RAFT2, "data.pad_multiple": 64, "train.mixed_prec": False, "depth.nlabel": 8,
            "pose.num_hypotheses": 16, "pose.ransac_iter": 1, "pose.num_correspondences": 128}
    got = cli.main(["--data", root, "--cfg", "kitti", "--dataset", "kitti_vo", "--out",
                    str(tmp_path / "out"), "--workers", "1", "--record-pose", "--override",
                    *[f"{k}={v}" for k, v in over.items()]], device="cpu")
    for k in ("rot_err", "trans_angle", "rot_err_fw", "trans_angle_fw"):
        assert math.isfinite(got[k]), k
    assert set(got["odometry"]) == {9, 10}     # the test sequences
    for rep in got["odometry"].values():
        assert math.isfinite(rep["ate_rmse"])
