"""The port's MPII dataset and PCKh evaluation against the JAX package,
and the port's train, test and serve entry points on a reduced MPII
yaml, on the CPU.

The db and the samples (train and val mode, under the same seeds) are
held bit for bit against the JAX ``MPIIDataset``; the PCKh name_values
against the JAX ``evaluate`` on the synthetic ``.mat`` of
``tests/test_mpii.py``; then the reduced HRNet of ``test_torch_hrnet``
trains one epoch on a seeded mini-MPII, is evaluated from the
``final_state.pth`` it wrote, and serves ``/v1/pose`` with 16 joints.
"""

import json
import logging
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml
from scipy.io import loadmat, savemat

from test_mpii import JOINT_NAMES, syn_mpii  # noqa: F401 (fixture)
from test_torch_hrnet import REDUCED_EXTRA
from test_torch_serve import _post_npy
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.data import build_dataset as jax_build_dataset
from udp_pose_tpu_torch.config import default_config, load_config
from udp_pose_tpu_torch.data import build_dataset
from udp_pose_tpu_torch.engine.pose_engine import SKELETONS

REPO = Path(__file__).resolve().parents[1]
MPII_YAML = REPO / "configs/mpii/hrnet_w32_256x256_udp.yaml"


def make_mini_mpii(root, n_train=8, n_valid=6, seed=0, hw=(160, 144)):
    """A seeded mini-MPII at ``root``: smooth ``hw`` images, the
    ``annot/{train,valid}.json`` of the reference format (1-based
    coordinates, a few joints invisible) and ``annot/gt_valid.mat``."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    (root / "annot").mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    H, W = hw
    gt = None
    for image_set, n in (("train", n_train), ("valid", n_valid)):
        anno = []
        gt = {"joints": np.zeros((16, 2, n)), "missing": np.zeros((16, n)),
              "head": np.zeros((2, 2, n))}
        for i in range(n):
            name = f"{image_set}{i:03d}.jpg"
            small = rng.integers(0, 255, (9, 9, 3)).astype(np.uint8)
            cv2.imwrite(str(root / "images" / name),
                        cv2.resize(small, (W, H),
                                   interpolation=cv2.INTER_CUBIC))
            c = rng.uniform([W * 0.4, H * 0.35], [W * 0.6, H * 0.5])
            s = rng.uniform(0.4, 0.6)
            joints = c + rng.uniform(-40, 40, (16, 2)) * s / 0.5
            vis = (rng.random(16) > 0.15).astype(int)
            anno.append({"image": name, "center": (c + 1).tolist(),
                         "scale": float(s), "joints": (joints + 1).tolist(),
                         "joints_vis": vis.tolist()})
            gt["joints"][:, :, i] = joints + 1
            gt["missing"][:, i] = 1 - vis
            top = joints[9] + 1
            gt["head"][:, :, i] = [top - [12, 16], top + [12, 4]]
        with open(root / "annot" / f"{image_set}.json", "w") as f:
            json.dump(anno, f)
    savemat(str(root / "annot" / "gt_valid.mat"), {
        "dataset_joints": np.array([JOINT_NAMES], dtype=object),
        "jnt_missing": gt["missing"], "pos_gt_src": gt["joints"],
        "headboxes_src": gt["head"]})
    return str(root)


@pytest.fixture(scope="module")
def mpii_root(tmp_path_factory):
    return make_mini_mpii(tmp_path_factory.mktemp("mini_mpii"))


def mpii_cfg(default_config_fn, root, target_type="offset"):
    """The MPII HRNet yaml's dataset and test settings on the reduced
    HRNet (64×64 input, 16×16 maps, float32) over ``root``."""
    cfg = default_config_fn()
    cfg.merge_from_dict(yaml.safe_load(MPII_YAML.read_text()))
    cfg.DATASET.ROOT = str(root)
    cfg.MODEL.TARGET_TYPE = target_type
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.HEATMAP_SIZE = [16, 16]
    cfg.MODEL.EXTRA.merge_from_dict(REDUCED_EXTRA)
    cfg.TPU.DTYPE = "float32"
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 4
    cfg.TEST.BATCH_SIZE_PER_GPU = 4
    return cfg


def _same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "image_path":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("is_train,target_type", [
    (False, "offset"), (True, "offset"), (True, "gaussian")])
def test_mpii_samples_equal_jax(mpii_root, is_train, target_type):
    """The db (center y-shift, ×1.25 scale, 0-based joints) and every
    sample of one pass under the same seed, bit for bit."""
    ours = build_dataset(mpii_cfg(default_config, mpii_root, target_type),
                         is_train=is_train)
    theirs = jax_build_dataset(mpii_cfg(jax_default_config, mpii_root,
                                        target_type), is_train=is_train)
    assert type(ours).__name__ == "MPIIDataset" and len(ours) == len(theirs)
    assert ours.flip_pairs == theirs.flip_pairs and ours.num_joints == 16
    for a, b in zip(ours.db, theirs.db):
        _same_sample(a, b)
    ours.seed(3)
    theirs.seed(3)
    for i in range(len(ours)):
        _same_sample(ours[i], theirs[i])


def test_mpii_evaluate_equals_jax(syn_mpii, tmp_path):  # noqa: F811
    """PCKh@0.5 and @0.1 name_values and ``pred.mat`` on the synthetic
    ``.mat`` of ``tests/test_mpii.py``: perfect, near and far predictions,
    a joint missing."""
    cfg = mpii_cfg(default_config, syn_mpii)
    jcfg = mpii_cfg(jax_default_config, syn_mpii)
    ours = build_dataset(cfg, is_train=False)
    theirs = jax_build_dataset(jcfg, is_train=False)
    exact = np.stack([a["joints_3d"][:, :2] for a in ours.db])
    rng = np.random.default_rng(11)
    for shift in (0.0, 4.0, 30.0):
        preds = np.concatenate([exact + rng.normal(0, shift, exact.shape),
                                np.ones(exact.shape[:2] + (1,))], -1)
        nv, mean = ours.evaluate(cfg, preds, str(tmp_path / "a"))
        jnv, jmean = theirs.evaluate(jcfg, preds, str(tmp_path / "b"))
        assert list(nv) == list(jnv) and mean == jmean
        for k in jnv:
            assert nv[k] == jnv[k], k
        np.testing.assert_array_equal(
            loadmat(str(tmp_path / "a" / "pred.mat"))["preds"],
            loadmat(str(tmp_path / "b" / "pred.mat"))["preds"])
    assert mean < 50.0


@pytest.fixture
def restore_root_logger():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
    root.setLevel(level)


def test_mpii_train_test_serve_entry_points(mpii_root, tmp_path,
                                            restore_root_logger):
    """``train.main`` one epoch on the reduced MPII yaml (validation
    through ``MPIIDataset.evaluate``: PCKh name_values), ``test.main`` on
    its ``final_state.pth`` (the same PCKh), and a ``/v1/pose`` server
    from the yaml and those weights: 16 joints and the MPII skeleton."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.engine.server import (PoseServer, PoseService,
                                                  host_crops)
    cfg = mpii_cfg(default_config, mpii_root)
    cfg.TRAIN.END_EPOCH = 1
    cfg.WORKERS = 0
    cfg.OUTPUT_DIR = str(tmp_path / "output")
    cfg.LOG_DIR = str(tmp_path / "log")
    path = tmp_path / "mpii_reduced.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))

    record = train_cli.main(["--cfg", str(path), "--device", "cpu"])
    assert len(record["steps"]) == 2
    assert all(np.isfinite(s["loss"]) for s in record["steps"])
    nv = record["name_values"]
    assert list(nv)[:2] == ["Head", "Shoulder"] and "Mean@0.1" in nv
    weights = tmp_path / "output" / "mpii" / "pose_hrnet" / \
        "mpii_reduced" / "final_state.pth"
    assert weights.exists()
    tnv, perf = test_cli.main(["--cfg", str(path), "--device", "cpu",
                               "TEST.MODEL_FILE", str(weights)])
    assert tnv == nv and perf == nv["Mean"]

    service = PoseService(load_config(str(path)), weights=str(weights),
                          device="cpu", window_ms=1.0)
    assert service.pipe.skeleton == SKELETONS["mpii"]
    assert service.pipe.flip_pairs == tuple(map(tuple, build_dataset(
        cfg).flip_pairs))
    srv = PoseServer(service, host="127.0.0.1", port=0)
    thread = srv.serve_in_thread()
    try:
        frame = np.random.default_rng(5).integers(0, 256, (120, 100, 3),
                                                  dtype=np.uint8)
        boxes = np.float32([[10, 10, 60, 100], [40, 5, 95, 110]])
        status, body = _post_npy(srv.port, frame, boxes)
        assert status == 200, body
        assert np.asarray(body["keypoints"]).shape == (2, 16, 2)
        kp, _ = service.pipe.infer_crops(*host_crops(
            frame, boxes, service.pipe.input_wh))
        np.testing.assert_allclose(body["keypoints"], kp, rtol=0, atol=1e-3)
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert torch.load(weights)["final_layer.weight"].shape[0] == 48
