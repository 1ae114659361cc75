"""KITTI data pipelines, host-side numpy (the port's copy of
`deep_sfm_revisited_tpu/data/`, eval side): datasets index frame pairs and
decode on CPU worker threads; batches cross to the device once per step.
"""

from deep_sfm_revisited_tpu_torch.data.kitti import (  # noqa: F401
    KittiRawDataset,
    KittiVODataset,
    compute_delta_rt,
    load_calib_intrinsics,
    load_vo_poses,
)
from deep_sfm_revisited_tpu_torch.data.transforms import (  # noqa: F401
    Compose,
    Normalize,
    RandomCrop,
    CenterCrop,
    RandomZoom,
)
from deep_sfm_revisited_tpu_torch.data.loader import BatchLoader  # noqa: F401
