"""The port's ``FusedDetectPose`` against the JAX package's on the CPU.

Both engines get the same reduced HRNet (bridged flax variables) and,
for the detector, either the same stubbed head output (known candidates,
as ``tests/test_fused_engine.py`` does) or the same bridged random
YOLOv5n.  Boxes, scores and the person count must be equal exactly;
keypoints agree within 1e-3 px.  Each serving shape of the port (one
frame, a chunk, submit/fetch, the low-bandwidth mode and its stream) is
also held against its own single-frame answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hrnet import reduced_cfg
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from test_torch_yolov5 import numpy_variables
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.engine.fused import FusedDetectPose as JaxFused
from udp_pose_tpu.models import build_model as jax_build_model
from udp_pose_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from udp_pose_tpu.ops.yolo import (non_max_suppression, padding_bbox,
                                   scale_boxes)
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.engine.fused import FusedDetectPose

KP_ATOL = 1e-3                   # px: CPU conv rounding, XLA vs PyTorch
H, W, DET = 240, 320, 128        # letterbox r=0.4: a 96x128 canvas

# candidates in letterbox coords (cx, cy, w, h, obj, person score): an
# overlapping pair, a lone box, a tie with the lone box that does not
# overlap it, and a box whose class is not the person's
ROWS = [(28, 46, 40, 68, 0.95, 0.95), (30, 46, 40, 68, 0.90, 0.90),
        (90, 40, 30, 60, 0.80, 0.90), (110, 70, 16, 30, 0.80, 0.90)]


def _mk_pred(rows, n_anchors=64, nc=80):
    pred = np.zeros((n_anchors, 5 + nc), np.float32)
    pred[:, 4] = 1e-4
    pred[:, 5] = 1e-4
    for i, (cx, cy, w, h, obj, c0) in enumerate(rows):
        pred[i, :4] = (cx, cy, w, h)
        pred[i, 4] = obj
        pred[i, 5] = c0
    pred[len(rows), :5] = (60, 30, 20, 20, 0.9)
    pred[len(rows), 7] = 0.9                    # best class 2: filtered
    return pred


class _JaxStub:
    def __init__(self, pred):
        self._pred = pred

    def apply(self, variables, x, train=False):
        return jnp.asarray(self._pred)[None]


def _torch_stub(pred):
    t = torch.from_numpy(pred)
    return lambda x: t[None].expand(x.shape[0], -1, -1)


@pytest.fixture(scope="module")
def pose_vars():
    """(the JAX config, seeded variables of the reduced HRNet, seeded
    variables of YOLOv5n), made in numpy: no init compiles."""
    jcfg = reduced_cfg(jax_default_config)
    jcfg.TEST.FLIP_TEST = True
    return (jcfg, numpy_variables(jax_build_model(jcfg), (1, 64, 64, 3)),
            numpy_variables(JaxYOLOv5(variant="n"), (1, 64, 64, 3), seed=4))


def _pair(pose_vars, rows=ROWS, **kw):
    jcfg, v, yolo_vars = pose_vars
    cfg = reduced_cfg(default_config)
    cfg.TEST.FLIP_TEST = True
    kw = dict(yolo_variant="n", yolo_weights=yolo_vars, max_persons=8,
              det_size=DET, topk=32, conf_thres=0.25, iou_thres=0.45, **kw)
    je = JaxFused(jcfg, v, **kw)
    te = FusedDetectPose(cfg, v, device="cpu", **kw)
    pred = _mk_pred(rows)
    je.yolo = _JaxStub(pred)
    te.yolo = _torch_stub(pred)
    return je, te, pred


@pytest.fixture(scope="module")
def engines(pose_vars):
    return _pair(pose_vars)


def _frame(seed, hw=(H, W)):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3),
                                                dtype=np.uint8)


def _assert_same(got, want, exact_kp=False, score_rtol=0.0):
    n = len(want["boxes"])
    assert got["keypoints"].shape == (n, 17, 2)
    np.testing.assert_array_equal(got["boxes"], np.asarray(want["boxes"]))
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               rtol=score_rtol, atol=0)
    if exact_kp:
        for k in ("keypoints", "maxvals"):
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_allclose(got["keypoints"], want["keypoints"],
                                   rtol=0, atol=KP_ATOL)
        np.testing.assert_allclose(got["maxvals"], want["maxvals"],
                                   rtol=1e-4, atol=1e-5)


def test_infer_frame_equals_jax_and_the_host_path(engines):
    je, te, pred = engines
    frame = _frame(3)
    got = te.infer_frame(frame)
    _assert_same(got, je.infer_frame(frame))
    assert len(got["boxes"]) == 3
    # the host detection path on the same raw head output
    det = non_max_suppression(pred[None], 0.25, 0.45)[0]
    want = np.array([padding_bbox(*(int(v) for v in b), (H, W))
                     for b in scale_boxes(det[:, :4], (H, W), (96, 128))],
                    np.float32)
    keep = det[:, 5] == 0
    np.testing.assert_array_equal(got["boxes"], want[keep])
    np.testing.assert_array_equal(got["scores"],
                                  det[keep, 4].astype(np.float32))


def test_empty_frame(engines):
    je, te, _ = engines
    eng = FusedDetectPose.__new__(FusedDetectPose)
    eng.__dict__.update(te.__dict__)
    eng.yolo = _torch_stub(_mk_pred([]))
    frame = np.zeros((160, 160, 3), np.uint8)
    out = eng.infer_frame(frame)
    assert out["keypoints"].shape == (0, 17, 2)
    assert out["boxes"].shape == (0, 4) and out["scores"].shape == (0,)
    lb = eng.infer_frame_low_bw(frame)
    assert lb["keypoints"].shape == (0, 17, 2)
    assert lb["bytes_uploaded"] < frame.nbytes


def test_infer_frames_and_pipelining_equal_single_frames(engines):
    _, te, _ = engines
    frames = np.stack([_frame(9 + f) for f in range(3)])
    singles = [te.infer_frame(f) for f in frames]
    for got, want in zip(te.infer_frames(frames), singles):
        _assert_same(got, want)
    handles = [te.submit_frame(f) for f in frames]     # all in flight
    for h, want in zip(handles, singles):
        _assert_same(te.fetch(h), want, exact_kp=True)
    assert te.infer_frames(frames[:0]) == []


def test_low_bw_equals_jax_low_bw(engines):
    """Host letterbox and native host crops (u8): the same boxes as the
    fused path, keypoints as the JAX low-bw path's."""
    je, te, _ = engines
    frame = _frame(3)
    got = te.infer_frame_low_bw(frame)
    want = je.infer_frame_low_bw(frame)
    _assert_same(got, want)
    assert got["bytes_uploaded"] == want["bytes_uploaded"] < frame.nbytes
    np.testing.assert_array_equal(got["boxes"],
                                  te.infer_frame(frame)["boxes"])


def test_low_bw_stream_equals_sequential(engines):
    """The two-deep low-bw stream in input order, equal to frame-by-frame
    low-bw; and a stream of frames with no person."""
    _, te, _ = engines
    empty = FusedDetectPose.__new__(FusedDetectPose)
    empty.__dict__.update(te.__dict__)
    frames = [_frame(20 + f) for f in range(4)]
    seq = [te.infer_frame_low_bw(f) for f in frames]
    piped = list(te.infer_stream_low_bw(iter(frames)))
    assert len(piped) == 4
    for got, want in zip(piped, seq):
        for k in ("keypoints", "maxvals", "boxes", "scores"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["bytes_uploaded"] == want["bytes_uploaded"]
    empty.yolo = _torch_stub(_mk_pred([]))
    outs = list(empty.infer_stream_low_bw(iter(frames[:3])))
    assert [o["keypoints"].shape for o in outs] == [(0, 17, 2)] * 3


def test_random_yolo_and_weights_forms_equal_jax(pose_vars):
    """No stub: the same random YOLOv5n variables in both engines (the
    port gets the flax variables and bridges them) on a 16:9 frame at a
    threshold low enough to fill every row."""
    jcfg, v, yolo_vars = pose_vars
    cfg = reduced_cfg(default_config)
    cfg.TEST.FLIP_TEST = True
    kw = dict(yolo_variant="n", yolo_weights=yolo_vars, max_persons=4,
              det_size=DET, conf_thres=0.001, topk=64)
    je = JaxFused(jcfg, v, **kw)
    te = FusedDetectPose(cfg, v, device="cpu", **kw)
    frame = _frame(31, hw=(72, 128))
    got = te.infer_frame(frame)
    assert len(got["boxes"]) == 4                    # every row filled
    # the two networks' float32 sums differ in the last bits: the scores
    # by up to an ulp, the rounded boxes not at all
    _assert_same(got, je.infer_frame(frame), score_rtol=1e-6)


def test_refusals_and_the_device_rule(pose_vars):
    _, v, _ = pose_vars
    cfg = reduced_cfg(default_config)
    with pytest.raises(NotImplementedError, match="mesh"):
        FusedDetectPose(cfg, v, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="quantize mode"):
        FusedDetectPose(cfg, v, device="cpu", quantize="int4")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedDetectPose(cfg, v)


# ------------------------------------------------------------------ int8

def _int8_kw(pose_vars):
    _, v, yolo_vars = pose_vars
    cfg = reduced_cfg(default_config)
    cfg.TEST.FLIP_TEST = True
    return cfg, v, dict(yolo_variant="n", yolo_weights=yolo_vars,
                        max_persons=4, det_size=DET, conf_thres=0.001,
                        topk=64, device="cpu")


def _pose_table(eng):
    """A pose table recorded on seeded crops of the engine's pose net."""
    crops = np.random.default_rng(2).integers(0, 256, (4, 64, 64, 3),
                                              dtype=np.uint8)
    eng._pose.calibrate_crops(crops)
    return dict(eng._pose.int8.calib.table())


def test_int8_table_rules(pose_vars, tmp_path):
    """The JAX package's per-subgraph gating: an explicit quantize= wins,
    else a subgraph's own table asks for int8, else cfg.TPU.QUANTIZE
    applies to both; the single-dispatch pose path needs a pose table."""
    from udp_pose_tpu_torch.engine.errors import EngineStateError
    from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
    cfg, v, kw = _int8_kw(pose_vars)
    eng = FusedDetectPose(cfg, v, quantize="int8", **kw)
    assert eng._pose.int8.calibrating and eng.det_int8.calibrating
    for run in (lambda: eng.infer_frame(_frame(1, hw=(72, 128))),
                lambda: eng.infer_frames(np.stack([_frame(1, hw=(72, 128))]))):
        with pytest.raises(EngineStateError, match="calibration table"):
            run()
    assert eng.det_act_scales is None
    with pytest.raises(EngineStateError, match="not calibrated"):
        eng.save_det_act_scales(str(tmp_path / "d.json"))
    table = _pose_table(eng)
    det_only = FusedDetectPose(cfg, v, det_act_scales={"b0/conv": 1.0}, **kw)
    assert det_only.det_int8.quantize == "int8"
    assert det_only._pose.int8.quantize is None
    pose_only = FusedDetectPose(cfg, v, pose_act_scales=table, **kw)
    assert pose_only.det_int8.quantize is None
    assert not pose_only._pose.int8.calibrating
    off = FusedDetectPose(cfg, v, quantize="", pose_act_scales=table,
                          det_act_scales={"b0/conv": 1.0}, **kw)
    assert off.det_int8.quantize is None and off._pose.active_infer() is \
        off._pose._infer_fp
    qcfg = cfg.clone()
    qcfg.TPU.QUANTIZE = "int8"
    both = FusedDetectPose(qcfg, v, **kw)
    assert both.det_int8.calibrating and both._pose.int8.calibrating
    pipe = UdpPosePipeline(cfg, v, device="cpu")
    with pytest.raises(ValueError, match="pose_act_scales"):
        FusedDetectPose(pipe, pose_act_scales=table, **{
            k: a for k, a in kw.items() if k != "device"})


def test_int8_detector_self_calibrates_on_letterboxed_frames(pose_vars,
                                                             tmp_path):
    """With a pose table the frame path runs; the detector records the
    host letterbox of its first ``TPU.QUANTIZE_CALIB_BATCHES`` (2)
    frames and serves them in float (the float engine's boxes and
    scores) until the table freezes, the freeze frame already int8 as in
    the JAX package; then it runs int8 with its heads in float."""
    from udp_pose_tpu_torch.models import quantize as tq
    from udp_pose_tpu_torch.ops.yolo import letterbox
    cfg, v, kw = _int8_kw(pose_vars)
    fp = FusedDetectPose(cfg, v, **kw)
    table = _pose_table(fp)
    eng = FusedDetectPose(cfg, v, quantize="int8", pose_act_scales=table,
                          **kw)
    frames = [_frame(s, hw=(72, 128)) for s in (11, 12, 13)]
    want = tq.Calibrator(2)
    for i, f in enumerate(frames[:2]):
        got, ref = eng.infer_frame(f), fp.infer_frame(f)
        if i == 0:
            np.testing.assert_array_equal(got["boxes"], ref["boxes"])
            np.testing.assert_array_equal(got["scores"], ref["scores"])
        x = torch.from_numpy(letterbox(f, DET)).permute(2, 0, 1)[None]
        want.update(tq.collect_conv_amax(fp.yolo, x.float() / 255.0))
    assert eng.det_act_scales == want.table()
    assert {"detect0", "detect1", "detect2"} <= set(eng.det_act_scales)
    eng.save_det_act_scales(str(tmp_path / "d.json"))
    assert tq.load_act_scales(str(tmp_path / "d.json")) == want.table()
    out = eng.infer_frames(np.stack(frames))
    assert len(out) == 3
    yolo_q = eng.det_int8.active()
    assert yolo_q.engaged == set(want.table()) - {"detect0", "detect1",
                                                  "detect2"}
    assert len(eng._pose.int8.qmodel.engaged) == len(table) - 1


def test_int8_low_bw_pose_self_calibration(pose_vars):
    """The low-bw stream crops on the host, so it calibrates the pose net
    from its crops as well as the detector from its canvases; then both
    run int8."""
    cfg, v, kw = _int8_kw(pose_vars)
    eng = FusedDetectPose(cfg, v, quantize="int8", **kw)
    frames = [_frame(s, hw=(72, 128)) for s in (21, 22, 23)]
    out = list(eng.infer_stream_low_bw(frames))
    assert [len(o["boxes"]) for o in out] == [4, 4, 4]
    assert not eng._pose.int8.calibrating and eng.det_act_scales is not None
    assert eng._pose.int8.qmodel is not None
    assert "final_layer" in eng._pose.int8.table
