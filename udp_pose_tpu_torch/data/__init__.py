"""Data layer (port of ``udp_pose_tpu/data``): the COCO and MPII
keypoint datasets, RSN's variants of both, their host augmentation
pipeline, and the multiprocess training input (``worker_loader``,
``prefetch``)."""

from .coco import COCODataset
from .mpii import MPIIDataset

DATASETS = {"coco": COCODataset, "mpii": MPIIDataset}


def build_dataset(cfg, image_set=None, is_train=False):
    """``cfg.DATASET.DATASET``'s dataset of ``image_set`` (by default the
    train or test set); for ``MODEL.NAME rsn`` its RSN variant."""
    name = cfg.DATASET.DATASET
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; ported: "
                       f"{sorted(DATASETS)}")
    if image_set is None:
        image_set = cfg.DATASET.TRAIN_SET if is_train else cfg.DATASET.TEST_SET
    cls = DATASETS[name]
    if cfg.MODEL.NAME == "rsn":
        from .rsn import RSNCOCODataset, RSNMPIIDataset
        cls = RSNMPIIDataset if name == "mpii" else RSNCOCODataset
    return cls(cfg, cfg.DATASET.ROOT, image_set, is_train)
