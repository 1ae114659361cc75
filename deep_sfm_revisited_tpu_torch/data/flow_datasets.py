"""Optical-flow pretraining datasets.

The PyTorch port's copy of `deep_sfm_revisited_tpu/data/flow_datasets.py`
(the port imports nothing of the JAX package); files are read by the port's
`data/flow_io.py`, whose KITTI reader keeps the channels in R, G, B order
where the JAX package's cv2 reads B, G, R, to the same flow and mask.

Rebuild of `models/RAFT/core/datasets.py` (235 LoC): FlyingChairs,
FlyingThings3D, Sintel, KITTI-flow, and HD1K dataset classes over the
standard directory layouts, combinable for the usual C+T+S+K+H schedule.
Each item: dict(img1, img2 (H, W, 3) float32 [0..255] pre-augment,
flow (H, W, 2), valid (H, W)). Augmentation via data/flow_augment.py.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from deep_sfm_revisited_tpu_torch.data.flow_augment import (
    FlowAugmentor,
    SparseFlowAugmentor,
)
from deep_sfm_revisited_tpu_torch.data.flow_io import (
    read_flow_kitti,
    read_gen,
)


class FlowDataset:
    """Base: list of (img1, img2) paths + flow paths."""

    sparse = False

    def __init__(self, augmentor=None):
        self.image_list: List[Tuple[str, str]] = []
        self.flow_list: List[Optional[str]] = []
        self.augmentor = augmentor

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, index, rng=None):
        rng = rng or np.random.default_rng()
        p1, p2 = self.image_list[index]
        img1 = np.asarray(read_gen(p1), np.float32)[..., :3]
        img2 = np.asarray(read_gen(p2), np.float32)[..., :3]
        fpath = self.flow_list[index]
        if self.sparse:
            flow, valid = read_flow_kitti(fpath)
        else:
            flow = np.asarray(read_gen(fpath), np.float32)[..., :2]
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(
                    img1, img2, flow, valid, rng
                )
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng)
                valid = (np.abs(flow[..., 0]) < 1000) & (
                    np.abs(flow[..., 1]) < 1000
                )
        # [-1, 1] normalization to match the SfM pipeline's convention
        img1 = img1 / 127.5 - 1.0
        img2 = img2 / 127.5 - 1.0
        return {
            "ref": img1.astype(np.float32),
            "target": img2.astype(np.float32),
            "flow_gt": flow.astype(np.float32),
            "flow_valid": valid,
        }


class FlyingChairs(FlowDataset):
    def __init__(self, root, split="training", crop_size=(368, 496),
                 augment=True, split_file=None):
        super().__init__(FlowAugmentor(crop_size, -0.1, 1.0) if augment
                         else None)
        images = sorted(glob.glob(os.path.join(root, "data", "*.ppm")))
        flows = sorted(glob.glob(os.path.join(root, "data", "*.flo")))
        assert len(images) // 2 == len(flows)
        split_ids = None
        split_file = split_file or os.path.join(root, "chairs_split.txt")
        if os.path.exists(split_file):
            split_ids = np.loadtxt(split_file, dtype=np.int32)
        for i, f in enumerate(flows):
            if split_ids is not None:
                tag = split_ids[i]
                if (split == "training") != (tag == 1):
                    continue
            self.flow_list.append(f)
            self.image_list.append((images[2 * i], images[2 * i + 1]))


class FlyingThings3D(FlowDataset):
    def __init__(self, root, dstype="frames_cleanpass",
                 crop_size=(400, 720), augment=True):
        super().__init__(FlowAugmentor(crop_size, -0.4, 0.8) if augment
                         else None)
        for cam in ("left",):
            for direction in ("into_future", "into_past"):
                idirs = sorted(glob.glob(os.path.join(root, dstype,
                                                      "TRAIN/*/*")))
                fdirs = sorted(glob.glob(os.path.join(
                    root, "optical_flow/TRAIN/*/*")))
                for idir, fdir in zip(idirs, fdirs):
                    images = sorted(glob.glob(
                        os.path.join(idir, cam, "*.png")))
                    flows = sorted(glob.glob(
                        os.path.join(fdir, direction, cam, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list.append((images[i], images[i + 1]))
                            self.flow_list.append(flows[i])
                        else:
                            self.image_list.append((images[i + 1], images[i]))
                            self.flow_list.append(flows[i + 1])


class MpiSintel(FlowDataset):
    def __init__(self, root, split="training", dstype="clean",
                 crop_size=(368, 768), augment=True):
        super().__init__(FlowAugmentor(crop_size, -0.2, 0.6) if augment
                         else None)
        image_root = os.path.join(root, split, dstype)
        flow_root = os.path.join(root, split, "flow")
        for scene in sorted(os.listdir(image_root)) if os.path.isdir(
            image_root
        ) else []:
            images = sorted(glob.glob(
                os.path.join(image_root, scene, "*.png")))
            for i in range(len(images) - 1):
                self.image_list.append((images[i], images[i + 1]))
                self.flow_list.append(os.path.join(
                    flow_root, scene, f"frame_{i + 1:04d}.flo"))


class KITTIFlow(FlowDataset):
    sparse = True

    def __init__(self, root, split="training", crop_size=(288, 960),
                 augment=True):
        super().__init__(
            SparseFlowAugmentor(crop_size, -0.2, 0.4) if augment else None
        )
        images1 = sorted(glob.glob(
            os.path.join(root, split, "image_2/*_10.png")))
        images2 = sorted(glob.glob(
            os.path.join(root, split, "image_2/*_11.png")))
        self.image_list = list(zip(images1, images2))
        self.flow_list = sorted(glob.glob(
            os.path.join(root, split, "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    sparse = True

    def __init__(self, root, crop_size=(288, 960), augment=True):
        super().__init__(
            SparseFlowAugmentor(crop_size, -0.5, 0.2) if augment else None
        )
        seq = 0
        while True:
            flows = sorted(glob.glob(os.path.join(
                root, "hd1k_flow_gt", f"flow_occ/{seq:06d}_*.png")))
            images = sorted(glob.glob(os.path.join(
                root, "hd1k_input", f"image_2/{seq:06d}_*.png")))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.image_list.append((images[i], images[i + 1]))
                self.flow_list.append(flows[i])
            seq += 1


class CombinedDataset(FlowDataset):
    """Weighted concatenation (the C+T+S+K+H training mix)."""

    def __init__(self, datasets: List[FlowDataset],
                 weights: Optional[List[int]] = None):
        super().__init__(None)
        self.datasets = datasets
        weights = weights or [1] * len(datasets)
        self.index: List[Tuple[int, int]] = []
        for d_idx, (ds, wt) in enumerate(zip(datasets, weights)):
            for _ in range(wt):
                self.index.extend((d_idx, i) for i in range(len(ds)))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, index, rng=None):
        d_idx, i = self.index[index]
        return self.datasets[d_idx].__getitem__(i, rng=rng)
