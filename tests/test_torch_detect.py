"""The port's detector-side ops against the JAX package on the CPU.

Host YOLO pre/post-processing (``ops/yolo``), the device NMS and its
top-k order, the box and crop geometry, the device letterbox, the native
NMS and resize, and the two-stage detectors, each on the same seeded
numpy inputs as its JAX counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu import native as jax_native
from udp_pose_tpu.engine.detector import LabelBoxDetector as JaxLabelBoxes
from udp_pose_tpu.engine.detector import YoloDetector as JaxYoloDetector
from udp_pose_tpu.ops import affine as jax_affine
from udp_pose_tpu.ops import boxes as jax_boxes
from udp_pose_tpu.ops import yolo as jax_yolo
from udp_pose_tpu.ops.nms import nms_jax, nms_np
from udp_pose_tpu_torch import native
from udp_pose_tpu_torch.engine.detector import (LabelBoxDetector,
                                                YoloDetector, topk_rows)
from udp_pose_tpu_torch.ops import affine, boxes, yolo
from udp_pose_tpu_torch.ops.nms import nms_torch, nms_torch_batched


def _raw_pred(rng, n=300, nc=80, scale=128):
    """A raw YOLO head output (1, n, 5 + nc): clustered boxes, scores in
    (0, 1), with exact ties planted."""
    pred = np.zeros((1, n, 5 + nc), np.float32)
    centres = rng.uniform(10, scale - 10, (8, 2))
    pick = rng.integers(0, 8, n)
    pred[0, :, :2] = centres[pick] + rng.normal(0, 3, (n, 2))
    pred[0, :, 2:4] = rng.uniform(8, 40, (n, 2))
    pred[0, :, 4] = rng.uniform(0, 1, n)
    pred[0, :, 5:] = rng.uniform(0, 1, (n, nc)) ** 4
    pred[0, ::7, 5] = 0.99                      # person is the best class
    pred[0, 20:30, 4] = 0.75                    # tied objectness ...
    pred[0, 20:30, 5:] = 0.0
    pred[0, 20:30, 5] = 0.8                     # ... and tied conf
    return pred


def _dets(rng, n, tie_every=3):
    """(n, 5) float32 [x1, y1, x2, y2, score] with overlapping clusters
    and runs of exactly equal scores."""
    xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    wh = rng.uniform(5, 40, (n, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[::tie_every] = scores[0]
    xy[n // 2:] = xy[:n - n // 2] + rng.normal(0, 2, (n - n // 2, 2))
    return np.concatenate([xy, xy + wh, scores[:, None]], 1).astype(
        np.float32)


def test_letterbox_and_box_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for hw in ((240, 320), (500, 333), (128, 128), (720, 1280)):
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        for size in (128, 320):
            np.testing.assert_array_equal(yolo.letterbox(img, size),
                                          jax_yolo.letterbox(img, size))
    b = rng.uniform(-20, 400, (12, 4))
    np.testing.assert_array_equal(
        yolo.scale_boxes(b, (300, 400), (256, 320)),
        jax_yolo.scale_boxes(b, (300, 400), (256, 320)))
    np.testing.assert_array_equal(yolo.xywh2xyxy(b), jax_yolo.xywh2xyxy(b))
    for box in ((3, 4, 50, 60), (0, 0, 399, 299), (380, 290, 420, 330)):
        assert yolo.padding_bbox(*box, (300, 400)) == \
            jax_yolo.padding_bbox(*box, (300, 400))
        assert yolo.padding_bbox(*box, (300, 400), 9) == \
            jax_yolo.padding_bbox(*box, (300, 400), 9)
    for lab in ((0.5, 0.5, 0.2, 0.4), (0.01, 0.99, 0.5, 0.5)):
        assert yolo.yolo2xyxy((300, 400), lab) == \
            jax_yolo.yolo2xyxy((300, 400), lab)
    # xyxy → center/scale on numpy, on torch tensors, and xywh → cs
    xyxy = np.sort(rng.uniform(0, 300, (6, 2, 2)), 1).reshape(6, 4).astype(
        np.float32)
    for got, want in zip(boxes.xyxy_to_cs(xyxy, (192, 256)),
                         jax_boxes.xyxy_to_cs(xyxy, (192, 256))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(boxes.xyxy_to_cs(torch.from_numpy(xyxy),
                                          (192, 256)),
                         jax_boxes.xyxy_to_cs(jnp.asarray(xyxy), (192, 256))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(boxes.xyxy2cxcywh(xyxy),
                                  jax_boxes.xyxy2cxcywh(xyxy))
    np.testing.assert_array_equal(
        boxes.xyxy2cxcywh(torch.from_numpy(xyxy)).numpy(),
        jax_boxes.xyxy2cxcywh(xyxy))
    for box in ((10, 20, 30, 80), (10, 20, 90, 30), (5, 5, 48, 64)):
        for got, want in zip(boxes.xywh_to_cs(*box, 0.75),
                             jax_boxes.xywh_to_cs(*box, 0.75)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("agnostic,classes", [(False, None), (True, None),
                                              (False, [0, 3])])
def test_non_max_suppression_equals_jax(agnostic, classes):
    pred = _raw_pred(np.random.default_rng(1))
    for conf in (0.05, 0.25):
        got = yolo.non_max_suppression(pred, conf, 0.45, classes=classes,
                                       agnostic=agnostic, max_det=40)
        want = jax_yolo.non_max_suppression(pred, conf, 0.45,
                                            classes=classes,
                                            agnostic=agnostic, max_det=40)
        assert len(got[0]) > 3
        np.testing.assert_array_equal(got[0], want[0])


def test_native_nms_and_resize_equal_jax_native():
    rng = np.random.default_rng(2)
    dets = _dets(rng, 200)
    for plus_one in (True, False):
        assert native.greedy_nms(dets, 0.4, plus_one) == \
            jax_native.greedy_nms(dets, 0.4, plus_one)
    assert native.greedy_nms(np.zeros((0, 5), np.float32), 0.5) == []
    img = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    for out_hw in ((20, 31), (90, 140), (45, 70)):
        np.testing.assert_array_equal(native.resize_bilinear(img, out_hw),
                                      jax_native.resize_bilinear(img, out_hw))
    assert native.native_version() == 2


@pytest.mark.parametrize("plus_one", [True, False])
@pytest.mark.parametrize("max_out", [4, 16, 64])
def test_nms_torch_equals_nms_jax(plus_one, max_out):
    """Exact indices, ties included, with -inf padding rows; the same
    order as the native NMS, and the same kept set as ``nms_np`` where no
    tied boxes overlap."""
    rng = np.random.default_rng(max_out + plus_one)
    dets = _dets(rng, 48)
    scores = dets[:, 4].copy()
    scores[40:] = -np.inf                        # padding rows
    for thresh in (0.3, 0.6):
        ki, km = nms_torch(torch.from_numpy(dets[:, :4]),
                           torch.from_numpy(scores), thresh, max_out,
                           plus_one=plus_one)
        wi, wm = nms_jax(jnp.asarray(dets[:, :4]), jnp.asarray(scores),
                         thresh, max_out, plus_one=plus_one)
        assert ki.dtype == torch.int32 and ki.shape == (max_out,)
        np.testing.assert_array_equal(ki.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(km.numpy(), np.asarray(wm))
        kept = ki.numpy()[ki.numpy() >= 0].tolist()
        real = np.concatenate([dets[:40, :4], scores[:40, None]], 1)
        assert kept == native.greedy_nms(real, thresh, plus_one)[:max_out]
    # no tied scores: nms_np (argsort reversed) picks the same boxes
    dets = _dets(rng, 40, tie_every=10 ** 6)
    ki, _ = nms_torch(torch.from_numpy(dets[:, :4]),
                      torch.from_numpy(dets[:, 4]), 0.5, 40, plus_one)
    kept = ki.numpy()[ki.numpy() >= 0].tolist()
    assert kept == nms_np(dets.astype(np.float64), 0.5, plus_one)


def test_nms_torch_batched_equals_per_frame():
    rng = np.random.default_rng(5)
    dets = np.stack([_dets(rng, 30) for _ in range(4)])
    dets[2, :, 4] = -np.inf                      # a frame with nothing
    b = torch.from_numpy(dets)
    ki, km = nms_torch_batched(b[..., :4], b[..., 4], 0.45, 8,
                               plus_one=False)
    assert ki.shape == (4, 8) and (ki[2] == -1).all()
    for f in range(4):
        wi, wm = nms_jax(jnp.asarray(dets[f, :, :4]),
                         jnp.asarray(dets[f, :, 4]), 0.45, 8, plus_one=False)
        np.testing.assert_array_equal(ki[f].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(km[f].numpy(), np.asarray(wm))


def test_topk_order_equals_lax_top_k_on_ties():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 5, (3, 400)).astype(np.float32)   # many ties
    x[:, ::3] = -np.inf
    for k in (1, 17, 400):
        _, want = jax.lax.top_k(jnp.asarray(x), k)
        got = topk_rows(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_classic_affine_matrix_and_crops_equal_jax():
    rng = np.random.default_rng(7)
    n = 6
    center = rng.uniform(20, 200, (n, 2)).astype(np.float32)
    scale = rng.uniform(0.2, 1.5, (n, 2)).astype(np.float32)
    for inv in (False, True):
        for rot, shift in ((0.0, (0.0, 0.0)), (30.0, (0.1, -0.2))):
            got = affine.classic_affine_matrix(
                torch.from_numpy(center), torch.from_numpy(scale), rot,
                (48, 64), inv=inv, shift=shift)
            want = np.stack([np.asarray(jax_affine.classic_affine_matrix(
                c, s, rot, (48, 64), inv=inv, shift=shift))
                for c, s in zip(center, scale)])
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-4)
    mats = affine.classic_affine_matrix(torch.from_numpy(center),
                                        torch.from_numpy(scale), 0.0,
                                        (48, 64), inv=True)
    # the host twin of the same matrices
    np.testing.assert_allclose(
        affine.classic_affine_mats_np(center, scale, (48, 64)),
        mats.numpy(), rtol=1e-5, atol=1e-4)
    pts = rng.uniform(0, 50, (5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        affine.apply_affine(torch.from_numpy(pts), mats[0]).numpy(),
        np.asarray(jax_affine.apply_affine(pts, jnp.asarray(mats[0]))),
        rtol=1e-6, atol=1e-4)

    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    m = mats.numpy()
    want = np.asarray(jax_affine.crop_boxes(
        jnp.asarray(frame, jnp.float32), jnp.asarray(m), (64, 48)))
    for img in (torch.from_numpy(frame).float(), torch.from_numpy(frame)):
        got = affine.crop_boxes(img, mats, (64, 48))
        assert got.dtype == torch.float32 and got.shape == (n, 64, 48, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        affine.warp_affine(torch.from_numpy(frame).float(), mats[1],
                           (64, 48)).numpy(), want[1], rtol=0, atol=1e-4)
    # F frames at once
    frames = rng.integers(0, 256, (3, 120, 160, 3), dtype=np.uint8)
    got = affine.crop_boxes(torch.from_numpy(frames).float(),
                            mats[None].expand(3, -1, -1, -1), (64, 48))
    for f in range(3):
        want = np.asarray(jax_affine.crop_boxes(
            jnp.asarray(frames[f], jnp.float32), jnp.asarray(m), (64, 48)))
        np.testing.assert_allclose(got[f].numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw", [(240, 320), (720, 1280), (500, 333),
                                (96, 128)])
def test_device_letterbox_equals_jax(hw):
    """The fused engine's letterbox (torch bilinear, no antialias) against
    the JAX graph's ``jax.image.resize`` + pad on the same frame."""
    from udp_pose_tpu_torch.engine.fused import FusedDetectPose
    H, W = hw
    det = 128
    frame = np.random.default_rng(11).integers(0, 256, (H, W, 3),
                                               dtype=np.uint8)
    eng = FusedDetectPose.__new__(FusedDetectPose)
    eng.det_size = det
    g = eng._letterbox_geom(H, W)
    got = eng._letterbox(torch.from_numpy(frame).float()[None], g)[0]
    img = jax.image.resize(jnp.asarray(frame, jnp.float32),
                           (g["nH"], g["nW"], 3), method="linear",
                           antialias=False)
    want = np.asarray(jnp.pad(img, ((g["top"], g["bottom"]),
                                    (g["left"], g["right"]), (0, 0)),
                              constant_values=114.0))
    assert tuple(got.shape) == (3,) + want.shape[:2]
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, rtol=0,
                               atol=1e-3)
    # and the host letterbox's canvas has the same size
    assert yolo.letterbox(frame, det).shape == want.shape


def test_yolo_detector_and_label_boxes_equal_jax(tmp_path):
    """The two-stage detectors on the same raw head output and the same
    label files."""
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    pred = _raw_pred(rng, scale=128)
    for kw in ({}, {"padding": 9, "conf_thres": 0.05},
               {"classes": [0], "agnostic_nms": True}):
        got = YoloDetector(lambda x: pred, input_size=128, **kw).infer(img)
        want = JaxYoloDetector(lambda x: pred, input_size=128,
                               **kw).infer(img)
        assert got is not None and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    none = np.zeros_like(pred)
    assert YoloDetector(lambda x: none, input_size=128).infer(img) is None

    (tmp_path / "a.txt").write_text("0 0.5 0.5 0.2 0.4\n1 0.3 0.3 0.1 0.1\n"
                                    "\n0 0.1 0.9 0.15 0.15\n")
    for path in (str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")):
        got = LabelBoxDetector(str(tmp_path)).infer_for(img, path)
        want = JaxLabelBoxes(str(tmp_path)).infer_for(img, path)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_build_yolo_detector_on_the_cpu():
    """The port's YOLOv5 as a two-stage detector: its device top-k keeps
    the rows ``non_max_suppression`` would keep."""
    from udp_pose_tpu_torch.engine.detector import build_yolo_detector
    det = build_yolo_detector("n", input_size=128, conf_thres=0.3,
                              device="cpu", device_topk=64)
    full = build_yolo_detector("n", input_size=128, conf_thres=0.3,
                               device="cpu", device_topk=0)
    img = np.random.default_rng(13).integers(0, 256, (96, 128, 3),
                                             dtype=np.uint8)
    x = yolo.letterbox(img, 128)[None].astype(np.float32) / 255.0
    top, raw = det.model_fn(x), full.model_fn(x)
    # a 96x128 canvas: 3 anchors on 12x16, 6x8 and 3x4 cells
    assert top.shape == (1, 64, 85) and raw.shape == (1, 3 * (192 + 48 + 12),
                                                      85)
    order = np.argsort(-raw[0, :, 4], kind="stable")[:64]
    np.testing.assert_array_equal(top[0], raw[0, order])
    got, want = det.infer(img), full.infer(img)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.shape[1] == 4


def test_build_yolo_detector_int8_self_calibration(tmp_path):
    """``quantize="int8"``: the first ``calib_batches`` frames serve in
    float while recording every site's amax (the heads too, as the JAX
    package's collector does), then int8 with the heads in float; the
    table persists, and a table alone asks for int8."""
    from udp_pose_tpu_torch.engine.detector import build_yolo_detector
    from udp_pose_tpu_torch.models import build_detector
    from udp_pose_tpu_torch.models import quantize as tq
    fp = build_yolo_detector("n", input_size=128, device="cpu",
                             device_topk=0)
    det = build_yolo_detector("n", input_size=128, device="cpu",
                              device_topk=0, quantize="int8",
                              calib_batches=2)
    rng = np.random.default_rng(3)
    xs = [rng.uniform(0, 1, (1, 96, 128, 3)).astype(np.float32)
          for _ in range(3)]
    want = tq.Calibrator(2)
    model = build_detector("n", device="cpu")
    for x in xs[:2]:
        assert det.get_act_scales() is None
        np.testing.assert_array_equal(det.model_fn(x), fp.model_fn(x))
        want.update(tq.collect_conv_amax(
            model, torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert det.get_act_scales() == want.table()
    assert "detect0" in want.table()
    qm = tq.QuantizedModel(model, want.table())
    with torch.inference_mode():
        ref = qm(torch.from_numpy(xs[2]).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_array_equal(det.model_fn(xs[2]), ref)
    path = str(tmp_path / "det.json")
    det.save_act_scales(path)
    by_table = build_yolo_detector("n", input_size=128, device="cpu",
                                   device_topk=0, act_scales=path)
    np.testing.assert_array_equal(by_table.model_fn(xs[2]), ref)
    with pytest.raises(RuntimeError, match="not calibrated"):
        build_yolo_detector("n", device="cpu",
                            quantize="int8").save_act_scales(path)
