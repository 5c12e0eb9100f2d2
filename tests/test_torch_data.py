"""The port's training data path against the JAX package, on the CPU.

Target encoders (torch and numpy), the UDP crop matrix and joint
rotation, the flip and AID augmentations, the COCO dataset's samples in
train and val mode under the same seeds, the epoch batch plans, OKS-NMS
and the COCO evaluation: the same numpy-seeded inputs through both
packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_harness import make_mini_coco
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.data import build_dataset as jax_build_dataset
from udp_pose_tpu.data import augment as jax_augment
from udp_pose_tpu.data import base as jax_base
from udp_pose_tpu.ops import affine as jax_affine
from udp_pose_tpu.ops import flip as jax_flip
from udp_pose_tpu.ops import nms as jax_nms
from udp_pose_tpu.ops import targets as jax_targets
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.data import augment, base, build_dataset
from udp_pose_tpu_torch.ops import affine, flip, nms, targets

HEATMAP = (48, 64)   # (w, h)
IMAGE = (192, 256)
COCO_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
              [15, 16]]


def _joints(seed, n=17, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    joints = np.stack([rng.uniform(-20, IMAGE[0] + 20, shape),
                       rng.uniform(-20, IMAGE[1] + 20, shape),
                       np.zeros(shape)], -1).astype(np.float32)
    vis = rng.choice([0.0, 1.0], shape + (1,), p=[0.3, 0.7]).repeat(3, -1)
    return joints, vis.astype(np.float32)


# ---------------------------------------------------------------- targets
@pytest.mark.parametrize("kind,arg", [("offset", 4.0), ("gaussian", 2),
                                      ("gaussian", 3)])
def test_targets_equal_jax(kind, arg):
    """Single-sample and batched torch encoders, and the numpy twins, bit
    for bit; the torch Gaussian within one ulp, where PyTorch's and XLA's
    ``exp`` round differently."""
    def same(g, w):
        if kind == "gaussian":
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(g, w)

    joints, vis = _joints(0)
    fn, jfn = getattr(targets, f"{kind}_targets"), \
        getattr(jax_targets, f"{kind}_targets")
    got = fn(torch.from_numpy(joints), torch.from_numpy(vis), HEATMAP, IMAGE,
             arg)
    want = jfn(jnp.asarray(joints), jnp.asarray(vis), HEATMAP, IMAGE, arg)
    same(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    bj, bv = _joints(1, batch=3)
    got = getattr(targets, f"batch_{kind}_targets")(
        torch.from_numpy(bj), torch.from_numpy(bv[..., 0]), HEATMAP, IMAGE,
        arg)
    want = getattr(jax_targets, f"batch_{kind}_targets")(
        jnp.asarray(bj), jnp.asarray(bv[..., 0]), HEATMAP, IMAGE, arg)
    same(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    got = getattr(targets, f"{kind}_targets_np")(joints, vis, HEATMAP, IMAGE,
                                                 arg)
    want = getattr(jax_targets, f"{kind}_targets_np")(joints, vis, HEATMAP,
                                                      IMAGE, arg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- affine
@pytest.mark.parametrize("rot", [0.0, 30.0, -77.5])
def test_udp_matrices_and_joint_rotation_equal_jax(rot):
    rng = np.random.default_rng(3)
    center = rng.uniform(50, 400, 2).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 2).astype(np.float32)
    joints = rng.uniform(0, 500, (17, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        affine.udp_warp_matrix_np(rot, center, scale, IMAGE),
        jax_affine.udp_warp_matrix_np(rot, center, scale, IMAGE))
    for clip in (False, True):
        np.testing.assert_array_equal(
            affine.udp_rotate_joints_np(joints, rot, center, scale, IMAGE,
                                        clip),
            jax_affine.udp_rotate_joints_np(joints, rot, center, scale, IMAGE,
                                            clip))
        np.testing.assert_array_equal(
            affine.udp_rotate_joints(torch.from_numpy(joints), rot, center,
                                     scale, IMAGE, clip).numpy(),
            np.asarray(jax_affine.udp_rotate_joints(joints, rot, center,
                                                    scale, IMAGE, clip)))
    np.testing.assert_array_equal(
        affine.udp_warp_matrix(rot, center, scale, IMAGE).numpy(),
        np.asarray(jax_affine.udp_warp_matrix(rot, center, scale, IMAGE)))


# ---------------------------------------------------- flip and AID augments
def test_fliplr_joints_equal_jax():
    joints, vis = _joints(4)
    got = flip.fliplr_joints_np(joints, vis, 640, COCO_PAIRS)
    want = jax_flip.fliplr_joints_np(joints, vis, 640, COCO_PAIRS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = flip.fliplr_joints(torch.from_numpy(joints), torch.from_numpy(vis),
                             640, COCO_PAIRS)
    want = jax_flip.fliplr_joints(jnp.asarray(joints), jnp.asarray(vis), 640,
                                  COCO_PAIRS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name,args", [
    ("Cutout", (1.0, 0.2, 3)), ("Cutout", (0.5, 0.3, 1)),
    ("HideAndSeek", (1.0, 0.5)), ("HideAndSeek", (0.7, 0.3, (0, 8, 16)))])
def test_aid_augments_equal_jax_under_one_seed(name, args):
    img = np.random.default_rng(5).integers(0, 256, (64, 48, 3), np.uint8)
    ours, theirs = getattr(augment, name)(*args), \
        getattr(jax_augment, name)(*args)
    rng_a, rng_b = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(6):
        np.testing.assert_array_equal(ours(img.copy(), rng_a),
                                      theirs(img.copy(), rng_b))
    # both drew the same numbers, in the same order
    assert rng_a.random() == rng_b.random()


# ------------------------------------------------------------ the dataset
@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    make_mini_coco(str(root), image_set="train2017", n_images=6, seed=11,
                   all_visible=True)
    make_mini_coco(str(root), image_set="val2017", n_images=4, seed=12,
                   det_file=str(root / "dets.json"), image_thre=0.3)
    return str(root)


def _cfg(default_config_fn, root, test=None, **dataset):
    cfg = default_config_fn()
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TRAIN_SET = "train2017"
    cfg.DATASET.TEST_SET = "val2017"
    cfg.DATASET.COLOR_RGB = True
    cfg.DATASET.PROB_HALF_BODY = 0.5
    cfg.DATASET.ROT_FACTOR = 45
    cfg.DATASET.SCALE_FACTOR = 0.35
    cfg.DATASET.merge_from_dict(dataset)
    cfg.MODEL.TARGET_TYPE = "offset"
    cfg.MODEL.IMAGE_SIZE = [48, 64]
    cfg.MODEL.HEATMAP_SIZE = [12, 16]
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.merge_from_dict(test or {})
    return cfg


DETECTIONS = {"USE_GT_BBOX": False, "COCO_BBOX_FILE": "dets.json",
              "IMAGE_THRE": 0.3}


@pytest.mark.parametrize("is_train,dataset,target_type,test", [
    (True, {}, "offset", None),
    (True, {"CUTOUT": [0.8, 0.2, 1], "HIDE_AND_SEEK": [0.8, 0.5]},
     "gaussian", None),
    (True, {"SELECT_DATA": True}, "offset", None),
    (False, {}, "offset", None),
    (False, {}, "offset", DETECTIONS),
])
def test_coco_samples_equal_jax(coco_root, is_train, dataset, target_type,
                                test):
    """``__getitem__`` under ``seed(k)``: the same crops, targets, weights,
    centers, scales and joints, bit for bit (both warp with OpenCV); in
    val mode from ground-truth boxes and from a detection file."""
    if test:
        test = dict(test, COCO_BBOX_FILE=f"{coco_root}/dets.json")
    cfgs = [_cfg(fn, coco_root, test, **dataset)
            for fn in (default_config, jax_default_config)]
    for cfg in cfgs:
        cfg.MODEL.TARGET_TYPE = target_type
    ours = build_dataset(cfgs[0], is_train=is_train)
    theirs = jax_build_dataset(cfgs[1], is_train=is_train)
    assert len(ours) == len(theirs) > 4
    for k in (0, 3):
        ours.seed(k)
        theirs.seed(k)
        for idx in range(len(ours)):
            a, b = ours[idx], theirs[idx]
            assert sorted(a) == sorted(b)
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]),
                                              err_msg=f"{key} of {idx}")


def test_epoch_batch_indices_equal_jax(coco_root):
    cfg = _cfg(default_config, coco_root)
    ds = build_dataset(cfg, is_train=True)
    groups = base.aspect_ratio_group_ids(ds)
    jds = jax_build_dataset(_cfg(jax_default_config, coco_root),
                            is_train=True)
    np.testing.assert_array_equal(groups, jax_base.aspect_ratio_group_ids(jds))
    for kw in ({}, {"shuffle": False, "drop_last": False},
               {"seed": 3, "shard_index": 1, "num_shards": 3},
               {"seed": 2, "group_ids": groups},
               {"seed": 1, "group_ids": groups, "shard_index": 0,
                "num_shards": 2, "drop_last": False}):
        got = base.epoch_batch_indices(ds, 3, **kw)
        want = jax_base.epoch_batch_indices(ds, 3, **kw)
        assert [list(map(int, b)) for b in got] == \
            [list(map(int, b)) for b in want], kw


def test_oks_nms_and_soft_oks_nms_equal_jax():
    rng = np.random.default_rng(8)
    base_pose = rng.uniform(50, 150, (1, 51))
    kpts = base_pose + rng.normal(0, 6, (12, 51))
    kpts[:, 2::3] = rng.uniform(0, 1, (12, 17))
    scores = rng.uniform(0.1, 1, 12)
    areas = rng.uniform(2000, 8000, 12)
    for thr in (0.3, 0.9):
        for vis in (None, 0.2):
            assert nms.oks_nms(kpts, scores, areas, thr, in_vis_thre=vis) == \
                jax_nms.oks_nms(kpts, scores, areas, thr, in_vis_thre=vis)
            assert nms.soft_oks_nms(kpts, scores, areas, thr,
                                    in_vis_thre=vis) == \
                jax_nms.soft_oks_nms(kpts, scores, areas, thr,
                                     in_vis_thre=vis)
    dets = np.concatenate([rng.uniform(0, 50, (10, 2)),
                           rng.uniform(60, 120, (10, 2)),
                           rng.uniform(0, 1, (10, 1))], 1)
    for plus_one in (True, False):
        assert nms.nms_np(dets, 0.5, plus_one) == \
            jax_nms.nms_np(dets, 0.5, plus_one)


def test_evaluate_name_values_equal_jax(coco_root, tmp_path):
    """The same preds through both packages' rescoring, OKS-NMS and COCO
    keypoint AP."""
    ours = build_dataset(_cfg(default_config, coco_root), is_train=False)
    theirs = jax_build_dataset(_cfg(jax_default_config, coco_root),
                               is_train=False)
    rng = np.random.default_rng(9)
    n = len(ours)
    preds = np.zeros((n, 17, 3), np.float32)
    boxes = np.zeros((n, 6))
    for i, rec in enumerate(ours.db):
        preds[i, :, :2] = rec["joints_3d"][:, :2] + rng.normal(0, 3, (17, 2))
        preds[i, :, 2] = rng.uniform(0, 1, 17)
        boxes[i, 0:2] = rec["center"]
        boxes[i, 2:4] = rec["scale"]
        boxes[i, 4] = np.prod(rec["scale"] * 200)
        boxes[i, 5] = 1.0
    paths = [rec["image"] for rec in ours.db]
    got = ours.evaluate(ours.cfg, preds, str(tmp_path / "a"), boxes, paths)
    want = theirs.evaluate(theirs.cfg, preds, str(tmp_path / "b"), boxes,
                           paths)
    assert got == want
    assert 0.0 < got[1] < 1.0
