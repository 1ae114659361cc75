"""The port's training checkpoints (`train/checkpoint.py`) on the CPU.

A save/restore round trip must resume exactly: the step after a restore
equals the uninterrupted run's step, bit for bit. `restore_subtree` merges
one network from a composite checkpoint or from one that holds that network
alone; five epochs are kept. The steps run the GT-pose route at 64x128 with
nlabel 8 (the checkpoint holds the whole model either way), batch 2.
"""

import os

import numpy as np
import pytest
import torch

from deep_sfm_revisited_tpu_torch.config import SfMConfig
from deep_sfm_revisited_tpu_torch.models.sfmnet import SFMNet
from deep_sfm_revisited_tpu_torch.train import checkpoint as ckpt
from deep_sfm_revisited_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
B, H, W = 2, 64, 128
CFG = SfMConfig.kitti().override(**{"depth.nlabel": 8, "use_gt_pose": True,
                                    "train.mixed_prec": False, "train.milestones": (1,)})


def _batch(seed):
    rng = np.random.RandomState(seed)
    pose = np.tile(np.concatenate([np.eye(3), [[0.1], [0.0], [0.6]]], 1), (B, 1, 1))
    gt = rng.uniform(1.5, 7.5, (B, H, W))
    gt[rng.rand(B, H, W) < 0.7] = 0.0
    arrays = {"ref": rng.uniform(-1, 1, (B, H, W, 3)), "target": rng.uniform(-1, 1, (B, H, W, 3)),
              "intrinsics": np.tile([[[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]]], (B, 1, 1)),
              "pose_gt": pose, "depth_gt": gt}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrays.items()}


def _trainer(seed):
    return Trainer(SFMNet(CFG, device="cpu", seed=seed), CFG, steps_per_epoch=1)


def _step(trainer, seed):
    return trainer.train_step(_batch(seed), torch.Generator().manual_seed(seed))


def test_resumed_step_equals_the_uninterrupted_step(tmp_path):
    """Two steps straight, against one step, a checkpoint, a restore into a
    model built from another seed, and the second step: the same loss, the
    same parameters, statistics and Adam moments, bit for bit. The second
    step crosses the milestone (steps_per_epoch 1, milestone 1), so the
    restored step count sets its rate."""
    straight = _trainer(0)
    _step(straight, 1)
    path = ckpt.save_checkpoint(str(tmp_path / "ckpt"), straight, epoch=0)
    assert os.path.basename(path) == "0.pt"
    want = _step(straight, 2)

    resumed = _trainer(7)
    assert ckpt.restore_checkpoint(str(tmp_path / "ckpt"), resumed) == 0
    assert resumed.step == 1 and resumed.schedule(resumed.step) == CFG.train.lr * 0.5
    got = _step(resumed, 2)
    assert got["loss"].item() == want["loss"].item()
    for (k, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


@pytest.mark.parametrize("layout", ["composite", "network_only"])
def test_restore_subtree(tmp_path, layout):
    """--pretrained-depth: PSNet's weights and statistics come from the
    checkpoint, DICL's stay the fresh model's."""
    source = _trainer(1)
    _step(source, 1)
    if layout == "composite":
        where = ckpt.save_checkpoint(str(tmp_path), source, epoch=3)
    else:
        where = str(tmp_path / "psnet.pt")
        torch.save({"model": source.model.depth_estimator.state_dict()}, where)
    target = SFMNet(CFG, device="cpu", seed=2)
    flow_before = {k: v.clone() for k, v in target.flow_estimator.state_dict().items()}
    ckpt.restore_subtree(str(tmp_path) if layout == "composite" else where, target, "depth_net")
    for k, v in source.model.depth_estimator.state_dict().items():
        assert torch.equal(target.depth_estimator.state_dict()[k], v), k
    for k, v in target.flow_estimator.state_dict().items():
        assert torch.equal(v, flow_before[k]), k
    assert not torch.equal(target.flow_estimator.feature.conv_start[0].conv.weight,
                           source.model.flow_estimator.feature.conv_start[0].conv.weight)


def test_keeps_five_and_the_best(tmp_path):
    trainer = _trainer(0)
    for epoch in range(7):
        ckpt.save_checkpoint(str(tmp_path), trainer, epoch, is_best=epoch == 2)
    assert sorted(os.listdir(tmp_path)) == ["2.pt", "3.pt", "4.pt", "5.pt", "6.pt",
                                            "model_best.pt"]
    state = torch.load(tmp_path / "model_best.pt", weights_only=True)
    assert state["epoch"] == 2 and state["config"]["depth"]["nlabel"] == 8
    model = SFMNet(CFG, device="cpu", seed=5)
    ckpt.restore_model(str(tmp_path), model)           # the newest epoch
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        ckpt.restore_model(str(tmp_path / "none"), model)
