"""Data layer (port of ``udp_pose_tpu/data``): the COCO keypoint dataset
and its host augmentation pipeline.  MPII and the RSN datasets are not
ported yet."""

from .coco import COCODataset

DATASETS = {"coco": COCODataset}


def build_dataset(cfg, image_set=None, is_train=False):
    name = cfg.DATASET.DATASET
    if cfg.MODEL.NAME == "rsn":
        raise KeyError("the RSN datasets are not ported yet; ported: "
                       f"{sorted(DATASETS)} for pose_hrnet")
    if name not in DATASETS:
        raise KeyError(f"dataset {name!r} is not ported yet; ported: "
                       f"{sorted(DATASETS)}")
    if image_set is None:
        image_set = cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET
    return DATASETS[name](cfg, cfg.DATASET.ROOT, image_set, is_train)
