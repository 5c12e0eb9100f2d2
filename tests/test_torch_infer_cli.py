"""``python -m udp_pose_tpu_torch.infer`` on the CPU: an image directory
through the fused engine, its low-bandwidth mode and the two-stage path,
a short video chunked and pipelined, the label-box mode with pose label
files, and the flag guards of ``tools/infer.py``.  Reduced HRNet, YOLOv5n
at ``--det-size 128``, seeded random weights.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from test_torch_hrnet import REDUCED_EXTRA
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu_torch import infer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    import cv2
    tmp = tmp_path_factory.mktemp("torch_infer_cli")
    cfg = tmp / "reduced.yaml"
    cfg.write_text(yaml.safe_dump({
        "MODEL": {"NAME": "pose_hrnet", "TARGET_TYPE": "offset",
                  "IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16],
                  "EXTRA": REDUCED_EXTRA},
        "TPU": {"DTYPE": "float32"}, "TEST": {"FLIP_TEST": True}}))
    src = tmp / "imgs"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        img = cv2.resize(rng.integers(0, 255, (9, 9, 3)).astype(np.uint8),
                         (160, 120), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(str(src / f"f{i}.jpg"), img)
    video = str(tmp / "clip.mp4")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 5.0,
                        (160, 120))
    assert w.isOpened(), "cv2 mp4v writer unavailable"
    for _ in range(5):
        w.write(cv2.resize(rng.integers(0, 255, (9, 9, 3)).astype(np.uint8),
                           (160, 120), interpolation=cv2.INTER_CUBIC))
    w.release()
    return {"cfg": str(cfg), "src": str(src), "video": video, "tmp": tmp}


def _args(env, out, *extra):
    return ["--source", env["src"], "--pose-cfg", env["cfg"],
            "--det-size", "128", "--max-persons", "4", "--conf-thres",
            "0.01", "--device", "cpu", "--save-dir", str(out), *extra]


@pytest.mark.parametrize("letter", ["n", "s", "m", "l"])
def test_detector_takes_the_bare_letter(letter):
    """``--detector n`` parses as ``--detector yolov5n`` (tools/infer.py
    strips the prefix the same way)."""
    args = infer.parse_args(["--source", "x", "--pose-cfg", "y",
                             "--detector", letter])
    assert args.detector == f"yolov5{letter}"


@pytest.mark.parametrize("mode", [["--fused"], ["--fused", "--low-bw"], []])
def test_image_dir(cli_env, mode):
    out = cli_env["tmp"] / ("out" + "".join(mode))
    assert infer.main(_args(cli_env, out, "--detector", "yolov5n",
                            *mode)) == 0
    assert sorted(os.listdir(out)) == ["f0.jpg", "f1.jpg"]


@pytest.mark.parametrize("mode", [["--chunk", "2"], ["--pipeline", "3"],
                                  ["--low-bw", "--pipeline", "2"]])
def test_video(cli_env, mode):
    out = cli_env["tmp"] / ("vid" + "".join(mode))
    args = _args(cli_env, out, "--detector", "yolov5n", "--fused", *mode)
    args[1] = cli_env["video"]
    assert infer.main(args) == 0
    assert os.listdir(out) == ["out_clip.mp4"]


def test_label_boxes_write_pose_txt(cli_env):
    labels = cli_env["tmp"] / "labels"
    labels.mkdir()
    (labels / "f0.txt").write_text("0 0.5 0.5 0.4 0.8\n")
    out = cli_env["tmp"] / "out_labels"
    assert infer.main(["--source", cli_env["src"], "--pose-cfg",
                       cli_env["cfg"], "--bbox-dir", str(labels),
                       "--save-pose-txt", "--device", "cpu", "--save-dir",
                       str(out)]) == 0
    rows = (out / "f0.txt").read_text().split("\n")
    assert len([r for r in rows if r]) == 13
    assert sorted(os.listdir(out)) == ["f0.jpg", "f0.txt", "f1.jpg"]


@pytest.mark.parametrize("extra,msg", [
    (["--low-bw"], "--low-bw needs --fused"),
    (["--detector", "yolov5n", "--fused", "--low-bw", "--chunk", "2"],
     "mutually exclusive"),
    (["--pipeline", "2"], "--pipeline needs --fused"),
    (["--fused"], "--fused needs --detector"),
    (["--detector", "yolov5n", "--fused", "--agnostic-nms"],
     "two-stage path only"),
    (["--classes", "0"], "need --detector"),
    (["--det-size", "320"], "--det-size needs --detector"),
    (["--detector", "yolov5n", "--fused", "--pipeline", "2", "--chunk", "2"],
     "mutually exclusive"),
    (["--detector", "yolov5n", "--fused", "--pipeline", "2"],
     "video/webcam"),
    (["--detector", "yolov5n", "--fused", "--quantize", "int8"],
     "calibration table"),
    (["--detector", "yolov5n", "--fused", "--quantize", "int8",
      "--act-scales", "missing.json"], "calibration table"),
])
def test_flag_guards(cli_env, extra, msg):
    args = ["--source", cli_env["src"], "--pose-cfg", cli_env["cfg"],
            "--device", "cpu", "--save-dir",
            str(cli_env["tmp"] / "guards"), *extra]
    with pytest.raises(SystemExit, match=msg):
        infer.main(args)


def test_module_entry_point(cli_env):
    out = cli_env["tmp"] / "out_module"
    proc = subprocess.run(
        [sys.executable, "-m", "udp_pose_tpu_torch.infer",
         *_args(cli_env, out, "--detector", "yolov5n", "--fused")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert sorted(os.listdir(out)) == ["f0.jpg", "f1.jpg"]


def test_int8_tables_load_or_write(cli_env):
    """``--quantize int8`` with table paths that do not exist: a run
    without a detector (one box a frame) calibrates the pose net and
    writes its table; a two-stage run loads it and writes the detector's;
    a ``--fused`` run loads both and leaves them as they are; ``--fused
    --low-bw`` calibrates on its own host crops."""
    from udp_pose_tpu_torch.models.quantize import load_act_scales
    tmp = cli_env["tmp"]
    pose_t, det_t = tmp / "pose.json", tmp / "det.json"

    def run(out, *extra):
        args = _args(cli_env, tmp / out, "--quantize", "int8", *extra,
                     "TPU.QUANTIZE_CALIB_BATCHES", "1")
        args[1] = cli_env["video"]
        if "--detector" not in extra:
            args.remove("--det-size")
            args.remove("128")
        assert infer.main(args) == 0

    run("q_pose", "--act-scales", str(pose_t))
    pose_table = load_act_scales(str(pose_t))
    assert "final_layer" in pose_table
    stamp = pose_t.stat().st_mtime_ns
    run("q_two_stage", "--detector", "yolov5n", "--act-scales", str(pose_t),
        "--det-act-scales", str(det_t))
    det_table = load_act_scales(str(det_t))
    assert "detect0" in det_table and pose_t.stat().st_mtime_ns == stamp
    stamps = (stamp, det_t.stat().st_mtime_ns)
    run("q_fused", "--detector", "yolov5n", "--fused", "--act-scales",
        str(pose_t), "--det-act-scales", str(det_t))
    assert os.listdir(tmp / "q_fused") == ["out_clip.mp4"]
    assert (pose_t.stat().st_mtime_ns, det_t.stat().st_mtime_ns) == stamps
    low = tmp / "lowbw.json"
    run("q_lowbw", "--detector", "yolov5n", "--fused", "--low-bw",
        "--act-scales", str(low), "--conf-thres", "0.001")
    assert sorted(load_act_scales(str(low))) == sorted(pose_table)
