"""Sharded evaluation and the engines' ``mesh=``, on the CPU.

``validate`` over 3 shards in one process (each shard's decoded arrays
gathered by an injected ``gather_fn`` that replays them) against the
unsharded run, and a db digest mismatch refused; ``test.run`` on 2
spawned gloo ranks against one process; ``UdpPosePipeline`` and
``FusedDetectPose`` over a mesh of two CPU devices against no mesh and
against the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

import torch_ranks
from ref_harness import make_mini_coco
from test_torch_hrnet import reduced_cfg
from test_torch_fused_engine import _assert_same
from test_torch_infer import HM_ATOL, _ambiguous_joints
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from test_torch_yolov5 import numpy_variables
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.engine.fused import FusedDetectPose as JaxFused
from udp_pose_tpu.engine.pose_engine import UdpPosePipeline as JaxPipe
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from udp_pose_tpu_torch import test as test_cli
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.core.infer import make_infer_fn
from udp_pose_tpu_torch.core.validate import validate
from udp_pose_tpu_torch.data import build_dataset
from udp_pose_tpu_torch.engine.fused import FusedDetectPose
from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.parallel import make_mesh

CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def val_cfg(tmp_path_factory):
    """The reduced HRNet on a mini-COCO val set of 10 crops."""
    root = str(tmp_path_factory.mktemp("coco"))
    make_mini_coco(root, image_set="val2017", n_images=4, seed=22,
                   all_visible=True)
    cfg = reduced_cfg(default_config)
    cfg.DATASET.DATASET, cfg.DATASET.ROOT = "coco", root
    cfg.DATASET.TEST_SET = "val2017"
    cfg.DATASET.COLOR_RGB = True
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.BATCH_SIZE_PER_GPU = 4
    return cfg


def _evaluated(ds):
    """Spy on ``ds.evaluate``: the preds and paths it was given."""
    seen = {}
    evaluate = ds.evaluate

    def spy(cfg, preds, output_dir, boxes, paths):
        seen.update(preds=np.array(preds), boxes=np.array(boxes),
                    paths=list(paths))
        return evaluate(cfg, preds, output_dir, boxes, paths)

    ds.evaluate = spy
    return seen


def _sharded(cfg, ds, model, num_shards, corrupt=None):
    """``validate`` of shard 0 of ``num_shards`` whose ``gather_fn``
    returns every shard's arrays: each shard is run first with a gather
    that records what it sends (and returns copies of it), then shard 0
    again with a gather that replays the recordings, call by call.
    ``corrupt(s, i, x)`` may alter what shard ``s`` sent at call ``i``."""
    sent = [[] for _ in range(num_shards)]
    for s in range(num_shards):
        def record(x, s=s):
            sent[s].append(x)
            return np.stack([x] * num_shards)
        validate(cfg, ds, model, shard_index=s, num_shards=num_shards,
                 gather_fn=record)
    calls = iter(range(3))

    def replay(x):
        i = next(calls)
        return np.stack([corrupt(s, i, sent[s][i]) if corrupt
                         else sent[s][i] for s in range(num_shards)])

    return validate(cfg, ds, model, shard_index=0, num_shards=num_shards,
                    gather_fn=replay)


def test_sharded_validate_equals_unsharded(val_cfg):
    """10 crops over 3 shards (padded to 12, each shard's strided rows):
    the reassembled preds and boxes equal the unsharded run's (crops
    forward in batches of other rows: 1e-5 px, 1e-6 in maxvals), the
    image paths in the dataset's order, the same AP; a db digest that
    differs on one shard raises."""
    model = build_model(val_cfg, device="cpu")
    ds = build_dataset(val_cfg, is_train=False)
    seen = _evaluated(ds)
    nv, perf = validate(val_cfg, ds, model)
    want = dict(seen)
    nv3, perf3 = _sharded(val_cfg, ds, model, 3)
    assert seen["paths"] == want["paths"] and len(ds) == 10
    np.testing.assert_allclose(seen["preds"][..., :2], want["preds"][..., :2],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(seen["preds"][..., 2], want["preds"][..., 2],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(seen["boxes"], want["boxes"])
    assert perf3 == pytest.approx(perf, abs=1e-9)
    assert nv3 == pytest.approx(nv, abs=1e-9)

    def other_db(s, i, x):
        return x + 1 if (s, i) == (2, 2) else x

    with pytest.raises(RuntimeError, match="db differs"):
        _sharded(val_cfg, ds, model, 3, corrupt=other_db)


def test_test_run_on_two_ranks_equals_one_process(val_cfg, tmp_path):
    """``test.run`` of one weight file on 2 gloo ranks (each decoding its
    shard, the results all-gathered) prints the AP table of one process
    on every rank."""
    weights = str(tmp_path / "w.pth")
    torch.save(build_model(val_cfg, device="cpu", seed=3).state_dict(),
               weights)
    ranks = torch_ranks.Ranks(torch_ranks.eval_run, 2, tmp_path, val_cfg,
                              weights)
    nv, perf = test_cli.run(val_cfg, weights,
                            build_dataset(val_cfg, is_train=False), "",
                            "cpu")
    for nv_r, perf_r in ranks.results():
        assert perf_r == pytest.approx(perf, abs=1e-9)
        assert nv_r == pytest.approx(nv, abs=1e-9)
    assert os.listdir(tmp_path / "test-rank1") == []


def test_pipeline_over_a_mesh_equals_no_mesh_and_jax():
    """``UdpPosePipeline`` over a mesh of two CPU devices: 5 persons (a
    bucket of 8, 4 a device) and 1 crop (a bucket of 1 padded to 2)
    equal the pipeline without a mesh (1e-5 px, 1e-6 in maxvals: other
    batch sizes), and the pipeline equals the JAX package's at
    ``test_torch_serve.test_infer_pose_equals_jax``'s tolerances."""
    jcfg = reduced_cfg(jax_default_config)
    cfg = reduced_cfg(default_config)
    variables = numpy_variables(jax_build_model(jcfg), (1, 64, 64, 3),
                                seed=2)
    rng = np.random.default_rng(23)
    frame = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    boxes = np.array([[-12, -6, 50, 70], [40, 20, 135, 100],
                      [10, 30, 60, 85], [60, 5, 110, 80],
                      [0, 40, 45, 95]], np.float32)
    pipe = UdpPosePipeline(cfg, weights=variables, flip_test=True,
                           device="cpu")
    mesh = UdpPosePipeline(cfg, weights=variables, flip_test=True,
                           device="cpu", mesh=make_mesh(CPU2))
    got, plain = mesh.infer_pose(frame, boxes), pipe.infer_pose(frame, boxes)
    crop = rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    cs = (np.array([[32.0, 32.0]]), np.array([[0.32, 0.32]]))
    for a, b in ((got, plain), (mesh.infer_crops(crop, *cs),
                                pipe.infer_crops(crop, *cs))):
        assert a[0].shape == b[0].shape
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-6)
    assert len(mesh.mesh_infers()) == 2

    gold = JaxPipe(jcfg, weights=variables, flip_test=True).infer_pose(
        frame, boxes)
    from udp_pose_tpu_torch.ops.boxes import xyxy_to_cs
    center, scale = xyxy_to_cs(boxes, (64, 64))
    crops = pipe.crop_frame(frame, center, scale)
    hm = make_infer_fn(pipe.model, target_type="offset")(
        crops, center, scale)[2].numpy()
    # the heatmaps' own difference from the JAX package's is held by the
    # serve test; here its bound decides which joints are decisive
    amb = _ambiguous_joints(hm, HM_ATOL, "offset", center, scale)
    assert amb.sum() <= amb.size // 4
    np.testing.assert_allclose(got[1], gold[1], rtol=0, atol=1e-6 + HM_ATOL)
    np.testing.assert_allclose(got[0][~amb], gold[0][~amb], rtol=0,
                               atol=1e-4)


def test_fused_infer_frames_over_a_mesh_equals_no_mesh():
    """``FusedDetectPose.infer_frames`` on a chunk of 3 frames over a
    mesh of two CPU devices (padded to 4, 2 a device; replicas of a
    seeded YOLOv5n at a low threshold, so that persons are found): the
    boxes, scores and person counts of the engine without a mesh, its
    keypoints within 1e-3 px; and the JAX package's engine on the same
    chunk at ``test_torch_fused_engine``'s tolerances (boxes equal, scores
    within an ulp, keypoints within ``KP_ATOL``).  The engine no longer
    refuses ``mesh=``."""
    jcfg = reduced_cfg(jax_default_config)
    cfg = reduced_cfg(default_config)
    jcfg.TEST.FLIP_TEST = cfg.TEST.FLIP_TEST = True
    v = numpy_variables(jax_build_model(jcfg), (1, 64, 64, 3))
    yolo = numpy_variables(JaxYOLOv5(variant="n"), (1, 64, 64, 3), seed=4)
    kw = dict(yolo_variant="n", yolo_weights=yolo, max_persons=4,
              det_size=128, topk=32, conf_thres=0.001, iou_thres=0.45,
              device="cpu")
    plain = FusedDetectPose(cfg, v, **kw)
    mesh = FusedDetectPose(cfg, v, mesh=make_mesh(CPU2), **kw)
    frames = np.random.default_rng(5).integers(0, 256, (3, 96, 128, 3),
                                               dtype=np.uint8)
    got, want = mesh.infer_frames(frames), plain.infer_frames(frames)
    assert len(got) == 3 and sum(len(w["boxes"]) for w in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-6)
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=0,
                                   atol=1e-3)
    gold = JaxFused(jcfg, v, **{k: a for k, a in kw.items()
                                if k != "device"}).infer_frames(frames)
    assert len(gold) == 3
    for g, w in zip(got, gold):
        _assert_same(g, w, score_rtol=1e-6)
