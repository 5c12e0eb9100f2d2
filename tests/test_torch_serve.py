"""The port's serving path on the CPU, its device rule and its imports.

A CPU ``PoseServer`` on the reduced HRNet answers concurrent
``application/x-npy`` ``/v1/pose`` requests as ``UdpPosePipeline.infer_crops``
does on the same host crops, and, with a detector, concurrent ``/v1/detect_pose`` requests as
``FusedDetectPose.infer_frame`` does, their frames batched together;
entry points called without ``device="cpu"`` raise on a host without
CUDA; nothing in the port or in ``chip_smoke.py`` imports JAX or the JAX
package.
"""

import ast
import http.client
import importlib.util
import io
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_hrnet import reduced_cfg
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.engine.pose_engine import _next_bucket as jax_next_bucket
from udp_pose_tpu.engine.server import host_crops as jax_host_crops
from udp_pose_tpu_torch.config import default_config, load_config
from udp_pose_tpu_torch.engine.pose_engine import (UdpPosePipeline,
                                                   _next_bucket)
from udp_pose_tpu_torch.engine.server import (PoseServer, PoseService,
                                              host_crops)
from udp_pose_tpu_torch.models import build_model

REPO = Path(__file__).resolve().parents[1]
W32_YAML = REPO / "configs/coco/hrnet_w32_256x192_udp_offset.yaml"


def _cfg():
    cfg = reduced_cfg(default_config)
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.POST_PROCESS = True
    return cfg


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _post_npy(port, frame, boxes=None, path="/v1/pose"):
    buf = io.BytesIO()
    np.save(buf, frame)
    headers = {"Content-Type": "application/x-npy"}
    if boxes is not None:
        headers["X-Boxes"] = json.dumps(np.asarray(boxes).tolist())
    status, body = _request(port, "POST", path, buf.getvalue(), headers)
    return status, json.loads(body)


@pytest.fixture(scope="module")
def server():
    service = PoseService(_cfg(), device="cpu", window_ms=200.0)
    srv = PoseServer(service, host="127.0.0.1", port=0)
    thread = srv.serve_in_thread()
    yield srv
    srv.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_concurrent_npy_requests_match_pipeline(server):
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8),
             np.array(b, np.float32)) for b in
            ([[10, 5, 50, 80], [60, 20, 120, 90]],
             [[0, 0, 40, 60], [30, 10, 90, 95], [70, 40, 127, 95]])]
    out = [None] * len(reqs)
    gate = threading.Barrier(len(reqs))

    def client(i):
        gate.wait()
        out[i] = _post_npy(server.port, *reqs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    # both requests rode one batch of 5 crops (bucket 8)
    assert list(server.service.batcher.log_snapshot()) == [5]
    pipe = server.service.pipe
    for (frame, boxes), (status, body) in zip(reqs, out):
        assert status == 200, body
        kp, sc = pipe.infer_crops(*host_crops(frame, boxes, pipe.input_wh))
        assert np.asarray(body["keypoints"]).shape == (len(boxes), 17, 2)
        assert np.asarray(body["scores"]).shape == (len(boxes), 17, 1)
        # other batch sizes (8 vs 2 and 4): CPU conv rounding may differ
        np.testing.assert_allclose(body["keypoints"], kp, rtol=0, atol=1e-3)
        np.testing.assert_allclose(body["scores"], sc, rtol=0, atol=1e-5)


def test_other_routes(server):
    status, body = _request(server.port, "GET", "/healthz")
    state = json.loads(body)
    assert status == 200 and state["platform"] == "cpu"
    assert state["model"] == "pose_hrnet" and state["flip_test"] is True
    assert state["quantize"] == "" and state["calibrated"] is False
    frame = np.zeros((32, 32, 3), np.uint8)
    buf = io.BytesIO()
    np.save(buf, frame)
    status, _ = _request(server.port, "POST", "/v1/detect_pose",
                         buf.getvalue(),
                         {"Content-Type": "application/x-npy"})
    assert status == 409
    status, _ = _post_npy(server.port, frame, [[1, 2, 3]])
    assert status == 400
    res = server.service.pose(frame, np.zeros((0, 4), np.float32))
    assert res["keypoints"].shape == (0, 17, 2)
    status, text = _request(server.port, "GET", "/metrics")
    assert status == 200 and b'code="409"' in text


@pytest.fixture(scope="module")
def detect_server():
    service = PoseService(_cfg(), device="cpu", window_ms=300.0,
                          detector="yolov5n", max_persons=4, max_frames=8,
                          det_kwargs={"det_size": 128, "conf_thres": 0.01})
    srv = PoseServer(service, host="127.0.0.1", port=0)
    thread = srv.serve_in_thread()
    yield srv
    srv.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_detect_pose_requests_batch_frames(detect_server):
    """Four concurrent /v1/detect_pose requests of one frame size and one
    of another: 200 with boxes, det_scores, keypoints and scores; the
    same-size frames share a dispatch (``/metrics``), and each answer is
    the engine's single-frame one."""
    service = detect_server.service
    assert service.fused._pose is service.pipe      # one pose model
    rng = np.random.default_rng(12)
    frames = [rng.integers(0, 256, (72, 128, 3), dtype=np.uint8)
              for _ in range(4)]
    frames.append(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    out = [None] * len(frames)
    gate = threading.Barrier(len(frames))

    def client(i):
        gate.wait()
        out[i] = _post_npy(detect_server.port, frames[i],
                           path="/v1/detect_pose")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    log = service.frame_batcher.log_snapshot()
    assert sum(log) == 5 and max(log) > 1, log
    for frame, (status, body) in zip(frames, out):
        assert status == 200, body
        want = service.fused.infer_frame(frame)
        n = len(want["boxes"])
        assert n >= 1
        np.testing.assert_array_equal(body["boxes"], want["boxes"])
        np.testing.assert_allclose(body["det_scores"], want["scores"],
                                   rtol=1e-6)
        assert np.asarray(body["keypoints"]).shape == (n, 17, 2)
        assert np.asarray(body["scores"]).shape == (n, 17, 1)
        np.testing.assert_allclose(body["keypoints"], want["keypoints"],
                                   rtol=0, atol=1e-3)
    status, text = _request(detect_server.port, "GET", "/metrics")
    assert status == 200 and b"udp_pose_frame_batches_total" in text
    assert b'udp_pose_batch_frames{stat="max"} ' + \
        str(max(log)).encode() in text
    status, body = _request(detect_server.port, "GET", "/healthz")
    assert status == 200 and json.loads(body)["detector"] is True


def test_int8_server_calibrates_on_its_first_batches():
    """``quantize="int8"`` with no table: ``/healthz`` says it is not
    calibrated; the first ``TPU.QUANTIZE_CALIB_BATCHES`` (2) crop batches
    serve in float, bucket-padded as the pipeline records them; then it
    reports ``calibrated`` and answers through the int8 model."""
    from udp_pose_tpu_torch.utils.convert import conv_sites
    cfg = _cfg()
    service = PoseService(cfg, device="cpu", quantize="int8", window_ms=1.0)
    srv = PoseServer(service, host="127.0.0.1", port=0)
    thread = srv.serve_in_thread()
    try:
        state = json.loads(_request(srv.port, "GET", "/healthz")[1])
        assert state["quantize"] == "int8" and state["calibrated"] is False
        rng = np.random.default_rng(4)
        frame = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
        boxes = np.array([[10, 5, 50, 80], [60, 20, 120, 90],
                          [0, 0, 40, 60]], np.float32)
        fp = UdpPosePipeline(cfg, device="cpu")
        crops = host_crops(frame, boxes, fp.input_wh)
        for _ in range(2):
            status, body = _post_npy(srv.port, frame, boxes)
            assert status == 200, body
            np.testing.assert_array_equal(
                np.asarray(body["keypoints"], np.float32),
                fp.infer_crops(*crops)[0])
        state = json.loads(_request(srv.port, "GET", "/healthz")[1])
        assert state["calibrated"] is True
        table = service.pipe.int8.table
        assert len(table) == len(conv_sites(service.pipe.model))
        status, body = _post_npy(srv.port, frame, boxes)
        q = UdpPosePipeline(cfg, device="cpu", act_scales=table)
        np.testing.assert_array_equal(
            np.asarray(body["keypoints"], np.float32),
            q.infer_crops(*crops)[0])
        assert list(service.batcher.log_snapshot()) == [3, 3, 3]
    finally:
        srv.shutdown()
        thread.join(timeout=30)


@pytest.mark.parametrize("target_type", ["offset", "gaussian"])
def test_infer_pose_equals_jax(target_type):
    """``UdpPosePipeline.infer_pose`` against the JAX package's, on the
    reduced HRNet in float32 with bridged weights (seeded numpy
    variables) and the flip test: a seeded frame, three boxes (a bucket
    of 4) reaching past its edges.  The crops warped on the device,
    normalised, equal the JAX graph's
    ``_make_prep`` batch; the heatmaps agree to ``HM_ATOL``; keypoints
    and scores are held at the decode's tolerances
    (``test_torch_infer.py:53-74``: maxvals 1e-6, preds 1e-4 px offset
    and 1e-3 px Gaussian) beyond the heatmaps' own difference, on the
    joints whose peak that difference cannot move."""
    import jax.numpy as jnp
    from test_torch_infer import HM_ATOL, _ambiguous_joints
    from test_torch_yolov5 import numpy_variables
    from udp_pose_tpu.core.infer import make_infer_fn as jax_make_infer_fn
    from udp_pose_tpu.engine.pose_engine import UdpPosePipeline as JaxPipe
    from udp_pose_tpu.models import build_model as jax_build_model
    from udp_pose_tpu.ops.boxes import xyxy_to_cs
    from udp_pose_tpu_torch.core.infer import make_infer_fn, normalize_images

    jcfg = reduced_cfg(jax_default_config, target_type)
    cfg = reduced_cfg(default_config, target_type)
    jmodel = jax_build_model(jcfg)
    variables = numpy_variables(jmodel, (1, 64, 64, 3), seed=2)
    rng = np.random.default_rng(21)
    frame = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    boxes = np.array([[-12, -6, 50, 70], [40, 20, 135, 100],
                      [10, 30, 60, 85]], np.float32)
    jpipe = JaxPipe(jcfg, weights=variables, flip_test=True)
    pipe = UdpPosePipeline(cfg, weights=variables, flip_test=True,
                           device="cpu")
    gold = jpipe.infer_pose(frame, boxes)
    got = pipe.infer_pose(frame, boxes)

    center, scale = xyxy_to_cs(boxes, (64, 64))
    cp, sp = (np.concatenate([a, a[:1]]) for a in (center, scale))
    x = np.asarray(jpipe._make_prep()(jnp.asarray(frame), cp, sp))
    crops = pipe.crop_frame(frame, cp, sp)
    assert crops.dtype == torch.float32 and crops.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(normalize_images(crops).numpy(), x, rtol=0,
                               atol=1e-6)
    opts = dict(target_type=target_type, flip_test=True,
                post_process=jcfg.TEST.POST_PROCESS, kpd=jcfg.LOSS.KPD)
    hm_gold = np.asarray(jax_make_infer_fn(jmodel, normalize=False, **opts)(
        variables, x, cp, sp)[2])
    hm = make_infer_fn(pipe.model, **opts)(crops, cp, sp)[2].numpy()
    hm_err = float(np.abs(hm - hm_gold).max())
    assert hm_err <= HM_ATOL
    amb = _ambiguous_joints(hm_gold, hm_err, target_type, cp, sp)[:3]
    assert amb.sum() <= amb.size // 4
    assert got[0].shape == (3, 17, 2) and got[1].shape == (3, 17, 1)
    np.testing.assert_allclose(got[1], gold[1], rtol=0, atol=1e-6 + hm_err)
    np.testing.assert_allclose(
        got[0][~amb], gold[0][~amb], rtol=0,
        atol=1e-4 if target_type == "offset" else 1e-3)


def test_pad_on_device_equals_host_tiling():
    """``CropBatcher(pad_on_device=True)`` uploads the real rows only and
    zero-pads to the bucket on the device: the same keypoints as the
    host-tiled batch, ``upload_log`` counting 3 rows of a bucket of 4
    against 4; while int8 calibrates it tiles on the host, so the table
    equals the host-tiled pipeline's."""
    from udp_pose_tpu_torch.engine.server import CropBatcher
    cfg = _cfg()
    rng = np.random.default_rng(17)
    frame = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    boxes = np.array([[10, 5, 50, 80], [60, 20, 120, 90], [0, 0, 40, 60]],
                     np.float32)
    crops, center, scale = host_crops(frame, boxes, (64, 64))
    row = crops[0].nbytes
    for quantize in ("", "int8"):
        pipes = [UdpPosePipeline(cfg, device="cpu", quantize=quantize,
                                 calib_batches=1) for _ in range(2)]
        batchers = [CropBatcher(p, window_ms=1.0, pad_on_device=on)
                    for p, on in zip(pipes, (False, True))]
        try:
            for _ in range(2):
                host, dev = (b.infer(crops, center, scale) for b in batchers)
                for a, b in zip(host, dev):
                    np.testing.assert_array_equal(a, b)
            logs = [list(b.upload_log) for b in batchers]
        finally:
            for b in batchers:
                b.close()
        assert logs[0] == [4 * row, 4 * row]
        # int8: the first batch calibrates, tiled on the host
        assert logs[1] == ([4 * row, 3 * row] if quantize else
                           [3 * row, 3 * row])
        if quantize:
            assert pipes[0].int8.table == pipes[1].int8.table


def test_host_crops_and_buckets_equal_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = np.array([[5, 8, 60, 110], [40, 10, 150, 70]], np.float32)
    got = host_crops(img, boxes, (48, 64))
    gold = jax_host_crops(img, boxes, (48, 64))
    for g, w in zip(got, gold):
        np.testing.assert_array_equal(g, w)
    assert [_next_bucket(n) for n in (1, 3, 64, 65, 129)] == \
        [jax_next_bucket(n) for n in (1, 3, 64, 65, 129)]


def test_native_warp_builds_without_openmp(tmp_path, monkeypatch):
    """A compiler with no OpenMP runtime still builds the warp (one
    thread), and its crops are the same."""
    from udp_pose_tpu_torch import native
    real_run = subprocess.run

    def run_without_openmp(cmd, **kwargs):
        if "-fopenmp" in cmd:
            return subprocess.CompletedProcess(
                cmd, 1, "", "cannot read spec file 'libgomp.spec'")
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.subprocess, "run", run_without_openmp)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (90, 70, 3), dtype=np.uint8)
    boxes = np.array([[3, 4, 50, 80], [20, 10, 69, 60]], np.float32)
    got = host_crops(img, boxes, (48, 64))
    assert len(list(tmp_path.glob("libudppose-*.so"))) == 1
    np.testing.assert_array_equal(got[0], jax_host_crops(img, boxes,
                                                         (48, 64))[0])


def test_entry_points_need_cuda_unless_asked_for_cpu():
    assert not torch.cuda.is_available()
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UdpPosePipeline(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseService(cfg)
    from udp_pose_tpu_torch.engine.detector import build_yolo_detector
    from udp_pose_tpu_torch.engine.fused import FusedDetectPose
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedDetectPose(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_yolo_detector()
    from udp_pose_tpu_torch import infer as infer_cli
    from udp_pose_tpu_torch import serve
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    for main in (serve.main, train_cli.main, test_cli.main):
        args = ["--cfg", str(W32_YAML)]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(args + (["--port", "0"] if main is serve.main else []))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--cfg", str(W32_YAML), "--port", "0",
                    "--detector", "yolov5n"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_cli.main(["--source", str(REPO), "--pose-cfg", str(W32_YAML),
                        "--detector", "yolov5n", "--fused"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.run(cfg, None, None, None, "", device="cuda")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("value,want", [
    ("n", "yolov5n"), ("s", "yolov5s"), ("m", "yolov5m"), ("l", "yolov5l"),
    ("yolov5n", "yolov5n"), ("", "")])
def test_serve_detector_takes_the_bare_letter(value, want):
    """``--detector n`` is ``--detector yolov5n``, as in tools/serve.py."""
    from udp_pose_tpu_torch import serve
    args = serve.parse_args(["--cfg", str(W32_YAML), "--detector", value])
    assert args.detector == want
    with pytest.raises(SystemExit):
        serve.parse_args(["--cfg", str(W32_YAML), "--detector", "x"])


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "udp_pose_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    port = REPO / "udp_pose_tpu_torch"
    assert {port / "engine/standalone.py", port / "export/__main__.py"} | {
        port / "export" / f"onnx_{m}.py" for m in (
            "pb", "build", "families", "mobile", "rsn", "yolo", "eval")
    } | {port / f"{m}.py" for m in (
        "reproduce_zoo", "generalization_proof", "overfit_proof",
        "convert_weights", "plot_coco", "parallel/pipeline")} <= set(files)
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax",
                               "msgpack", "udp_pose_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_config_is_the_w32_yaml():
    cfg = default_config()
    cfg.merge_from_dict(_chip_smoke().W32_UDP_OFFSET)
    assert cfg.to_dict() == load_config(str(W32_YAML)).to_dict()
    # and the port's default tree is the JAX package's
    assert default_config().to_dict() == jax_default_config().to_dict()


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No CUDA here: exit nonzero, print no result.  Alone in a directory
    it cannot import the port either."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
