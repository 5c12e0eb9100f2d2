"""JointsDataset base: UDP crop + augmentation pipeline on the host.

Port of ``udp_pose_tpu/data/base.py`` (parity target: deep_hrnet/lib/
dataset/JointsDataset.py:75-385).  Every augmentation is drawn from one
``np.random.Generator`` in the JAX package's order, so ``seed(k)`` gives
the same samples in both packages.  Targets come from the numpy twins of
:mod:`..ops.targets`.  Samples are dicts of numpy arrays; images stay
uint8 until the normalise on the device (:func:`..core.infer.
normalize_images`), a quarter of float32's bytes on the upload.

OpenCV is imported inside :meth:`JointsDataset._read_image` and
:meth:`JointsDataset._warp` only, so the package imports without it.
"""

from __future__ import annotations

import bisect
import copy

import numpy as np

from ..ops.affine import udp_rotate_joints_np, udp_warp_matrix_np
from ..ops.flip import fliplr_joints_np
from ..ops.targets import gaussian_targets_np, offset_targets_np
from .augment import Cutout, HideAndSeek


class JointsDataset:
    """Base top-down keypoint dataset.  Subclasses fill ``self.db``."""

    num_joints = 0
    flip_pairs = []
    upper_body_ids = ()
    lower_body_ids = ()
    joints_weight = 1
    pixel_std = 200

    def __init__(self, cfg, root, image_set, is_train):
        self.cfg = cfg
        self.root = root
        self.image_set = image_set
        self.is_train = is_train

        self.output_path = cfg.OUTPUT_DIR
        self.data_format = cfg.DATASET.DATA_FORMAT
        self.scale_factor = cfg.DATASET.SCALE_FACTOR
        self.rotation_factor = cfg.DATASET.ROT_FACTOR
        self.flip = cfg.DATASET.FLIP
        self.num_joints_half_body = cfg.DATASET.NUM_JOINTS_HALF_BODY
        self.prob_half_body = cfg.DATASET.PROB_HALF_BODY
        self.color_rgb = cfg.DATASET.COLOR_RGB

        self.cutout = None
        if cfg.DATASET.CUTOUT:
            self.cutout = Cutout(*cfg.DATASET.CUTOUT)
        self.hide_and_seek = None
        if cfg.DATASET.HIDE_AND_SEEK:
            self.hide_and_seek = HideAndSeek(*cfg.DATASET.HIDE_AND_SEEK)

        self.target_type = cfg.MODEL.TARGET_TYPE
        self.image_size = np.array(cfg.MODEL.IMAGE_SIZE)
        self.heatmap_size = np.array(cfg.MODEL.HEATMAP_SIZE)
        self.sigma = cfg.MODEL.SIGMA
        self.use_different_joints_weight = cfg.LOSS.USE_DIFFERENT_JOINTS_WEIGHT
        self.kpd = cfg.LOSS.KPD
        self.aspect_ratio = self.image_size[0] / self.image_size[1]
        self.db = []
        self._rng = np.random.default_rng()

    def seed(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.db)

    # -- augmentation pieces ------------------------------------------------

    def half_body_transform(self, joints, joints_vis, rng):
        """Parity: JointsDataset.py:124-167."""
        upper, lower = [], []
        for j in range(self.num_joints):
            if joints_vis[j][0] > 0:
                (upper if j in self.upper_body_ids else lower).append(joints[j])
        if rng.standard_normal() < 0.5 and len(upper) > 2:
            selected = upper
        else:
            selected = lower if len(lower) > 2 else upper
        if len(selected) < 2:
            return None, None
        selected = np.array(selected, np.float32)
        center = selected.mean(axis=0)[:2]
        lt = selected.min(axis=0)
        rb = selected.max(axis=0)
        w, h = rb[0] - lt[0], rb[1] - lt[1]
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.array([w / self.pixel_std, h / self.pixel_std],
                         np.float32) * 1.5
        return center, scale

    def _read_image(self, path):
        """The (H, W, 3) uint8 image at ``path``, RGB if ``COLOR_RGB``; an
        ``archive.zip@member`` path (``DATA_FORMAT zip``) reads the member
        (:mod:`..utils.zipreader`)."""
        import cv2
        if self.data_format == "zip" or "@" in path:
            from ..utils import zipreader
            img = zipreader.imread(path)
        else:
            img = cv2.imread(
                path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            raise ValueError(f"fail to read {path}")
        if self.color_rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img

    def _warp(self, img, trans):
        """The uint8 crop of ``img`` under the dst→src matrix ``trans``
        (bilinear, zero border; JointsDataset.py:226-228)."""
        import cv2
        return cv2.warpAffine(
            img, trans, (int(self.image_size[0]), int(self.image_size[1])),
            flags=cv2.WARP_INVERSE_MAP | cv2.INTER_LINEAR)

    def __getitem__(self, idx):
        """Parity: JointsDataset.py:172-256, the draws in the JAX
        package's order."""
        rec = copy.deepcopy(self.db[idx])
        rng = self._rng

        img = self._read_image(rec["image"])
        joints = rec["joints_3d"]
        joints_vis = rec["joints_3d_vis"]
        c = rec["center"].copy()
        s = rec["scale"].copy()
        score = rec.get("score", 1)
        r = 0.0

        if self.is_train:
            if (np.sum(joints_vis[:, 0]) > self.num_joints_half_body
                    and rng.random() < self.prob_half_body):
                c_hb, s_hb = self.half_body_transform(joints, joints_vis, rng)
                if c_hb is not None:
                    c, s = c_hb, s_hb
            sf, rf = self.scale_factor, self.rotation_factor
            s = s * np.clip(rng.standard_normal() * sf + 1, 1 - sf, 1 + sf)
            r = (np.clip(rng.standard_normal() * rf, -rf * 2, rf * 2)
                 if rng.random() <= 0.6 else 0.0)
            if self.flip and rng.random() <= 0.5:
                img = img[:, ::-1, :]
                joints, joints_vis = fliplr_joints_np(
                    joints, joints_vis, img.shape[1], self.flip_pairs)
                c[0] = img.shape[1] - c[0] - 1

        trans = udp_warp_matrix_np(r, c, s, self.image_size)
        crop = self._warp(img, trans)
        joints = joints.copy()
        joints[:, 0:2] = udp_rotate_joints_np(joints[:, 0:2], r, c, s,
                                              self.image_size)

        if self.is_train:
            if self.cutout:
                crop = self.cutout(crop, rng)
            if self.hide_and_seek:
                crop = self.hide_and_seek(crop, rng)

        target, weight = self.generate_target(joints, joints_vis)
        return {
            "image": np.ascontiguousarray(crop),
            "target": target,
            "target_weight": weight,
            "center": c.astype(np.float32),
            "scale": s.astype(np.float32),
            "rotation": np.float32(r),
            "score": np.float32(score),
            "image_path": rec["image"],
            "joints": joints.astype(np.float32),
            "joints_vis": joints_vis.astype(np.float32),
        }

    def generate_target(self, joints, joints_vis):
        """Parity: JointsDataset.py:291-385 incl. per-joint weights."""
        if self.target_type == "offset":
            target, weight = offset_targets_np(
                joints, joints_vis, tuple(self.heatmap_size),
                tuple(self.image_size), self.kpd)
        else:
            target, weight = gaussian_targets_np(
                joints, joints_vis, tuple(self.heatmap_size),
                tuple(self.image_size), self.sigma)
        if self.use_different_joints_weight:
            weight = weight * np.asarray(self.joints_weight).reshape(-1)
        return target, weight.astype(np.float32)

    def select_data(self, db):
        """Parity: JointsDataset.py:258-289 (ks-metric filtering)."""
        selected = []
        for rec in db:
            vis = rec["joints_3d_vis"][:, 0] > 0
            num_vis = int(vis.sum())
            if num_vis == 0:
                continue
            joints_center = rec["joints_3d"][vis, :2].mean(axis=0)
            area = rec["scale"][0] * rec["scale"][1] * (self.pixel_std ** 2)
            d2 = np.sum((joints_center - np.asarray(rec["center"])) ** 2)
            ks = np.exp(-1.0 * d2 / ((0.2 ** 2) * 2.0 * area))
            metric = (0.2 / 16) * num_vis + 0.45 - 0.2 / 16
            if ks > metric:
                selected.append(rec)
        return selected


def collate(samples):
    """Stack a list of sample dicts into a batch dict (meta kept as lists)."""
    batch = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or \
                isinstance(vals[0], np.generic):
            batch[k] = np.stack([np.asarray(v) for v in vals])
        else:
            batch[k] = vals
    return batch


def grouped_batch_indices(sampled_ids, group_ids, batch_size,
                          drop_uneven=False):
    """Aspect-ratio grouped batching (parity: RSN/cvpack/dataset/
    torch_samplers/grouped_batch_sampler.py:62-124): each batch is drawn
    from one group, groups keep the sampler's order, and batches are
    sorted by the sampler position of their first element."""
    sampled_ids = np.asarray(sampled_ids)
    group_ids = np.asarray(group_ids)
    pos = {int(v): i for i, v in enumerate(sampled_ids)}
    merged = []
    for g in np.unique(group_ids):
        members = [i for i in sampled_ids if group_ids[i] == g]
        for s in range(0, len(members), batch_size):
            merged.append(members[s:s + batch_size])
    merged.sort(key=lambda b: pos[int(b[0])])
    if drop_uneven:
        merged = [b for b in merged if len(b) == batch_size]
    return merged


def aspect_ratio_group_ids(dataset, bins=(1.0,)):
    """Quantised h/w group id per db record (grouped_batch_sampler.py:
    11-25; the reference bins at aspect 1)."""
    ids = []
    for rec in dataset.db:
        s = rec["scale"]
        ratio = float(s[1]) / max(float(s[0]), 1e-9)
        ids.append(bisect.bisect_right(sorted(bins), ratio))
    return np.asarray(ids)


def epoch_batch_indices(dataset, batch_size, shuffle=True, seed=0,
                        drop_last=True, shard_index=0, num_shards=1,
                        group_ids=None, n_micro=1):
    """This shard's batch plan for one epoch, a list of index chunks,
    computed without touching a sample: an epoch-seeded permutation,
    padded to a shard-divisible length and strided per shard.  With
    ``n_micro`` > 1 over several shards (a pipelined step), step ``j``'s
    global batch is every shard's chunk ``j`` in shard order, and this
    shard takes its rows of each of the ``n_micro`` microbatches
    (:func:`..parallel.pipeline.pipeline_rows`)."""
    if n_micro > 1 and num_shards > 1:
        from ..parallel.pipeline import pipeline_rows
        per = [epoch_batch_indices(dataset, batch_size, shuffle, seed,
                                   drop_last, si, num_shards, group_ids)
               for si in range(num_shards)]
        rows = pipeline_rows(batch_size * num_shards, n_micro, shard_index,
                             num_shards)
        return [np.concatenate([p[j] for p in per])[rows]
                for j in range(min(len(p) for p in per))]
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(n)
    padded = idx
    if num_shards > 1:
        total = ((n + num_shards - 1) // num_shards) * num_shards
        padded = np.concatenate([idx, idx[: total - n]])
        idx = padded[shard_index::num_shards]
    if group_ids is not None:
        batches = list(grouped_batch_indices(idx, group_ids, batch_size,
                                             drop_uneven=drop_last))
        if num_shards > 1:
            # group composition varies per shard: every shard truncates to
            # the smallest shard's batch count, keeping steps aligned
            counts = []
            for si in range(num_shards):
                sidx = padded[si::num_shards]
                counts.append(len(grouped_batch_indices(
                    sidx, group_ids, batch_size, drop_uneven=drop_last)))
            batches = batches[:min(counts)]
        return batches
    end = (len(idx) // batch_size) * batch_size if drop_last else len(idx)
    return [idx[start:start + batch_size]
            for start in range(0, end, batch_size)]


def epoch_plan_size(dataset, batch_size, shuffle=True, seed=0,
                    drop_last=True, group_ids=None, shard_index=0,
                    num_shards=1):
    """The batches of epoch ``seed``'s plan for this shard, counted from
    the indices alone: no sample is built (a resume skips whole epochs
    with it, ``tools/train.py:312-320``)."""
    return len(epoch_batch_indices(dataset, batch_size, shuffle=shuffle,
                                   seed=seed, drop_last=drop_last,
                                   shard_index=shard_index,
                                   num_shards=num_shards,
                                   group_ids=group_ids))


def epoch_loader(dataset, batch_size, shuffle=True, seed=0, drop_last=True,
                 shard_index=0, num_shards=1, group_ids=None,
                 skip_batches=0, n_micro=1):
    """Epoch-seeded batch iterator over :func:`epoch_batch_indices`, in
    this process (the reference's DataLoader + DistributedSampler,
    RSN/cvpack/dataset/torch_samplers/distributed.py:10-66).
    ``skip_batches`` drops the plan's first chunks without building them:
    an index skip, which does not replay the augmentation draws of the
    dataset's one generator; an exact mid-epoch resume builds and throws
    away the prefix instead (:func:`..train.run`)."""
    for chunk in epoch_batch_indices(dataset, batch_size, shuffle=shuffle,
                                     seed=seed, drop_last=drop_last,
                                     shard_index=shard_index,
                                     num_shards=num_shards,
                                     group_ids=group_ids,
                                     n_micro=n_micro)[skip_batches:]:
        yield collate([dataset[int(i)] for i in chunk])
