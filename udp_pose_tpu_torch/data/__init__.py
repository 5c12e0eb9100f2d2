"""Data layer (port of ``udp_pose_tpu/data``): the COCO and MPII
keypoint datasets, their host augmentation pipeline, and the
multiprocess training input (``worker_loader``, ``prefetch``).  The RSN
datasets are not ported yet."""

from .coco import COCODataset
from .mpii import MPIIDataset

DATASETS = {"coco": COCODataset, "mpii": MPIIDataset}


def build_dataset(cfg, image_set=None, is_train=False):
    name = cfg.DATASET.DATASET
    if cfg.MODEL.NAME == "rsn":
        raise KeyError("the RSN datasets are not ported yet; ported: "
                       f"{sorted(DATASETS)} for the other models")
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; ported: "
                       f"{sorted(DATASETS)}")
    if image_set is None:
        image_set = cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET
    return DATASETS[name](cfg, cfg.DATASET.ROOT, image_set, is_train)
