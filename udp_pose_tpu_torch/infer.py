"""Detect-then-pose inference CLI of the PyTorch port (port of
``tools/infer.py``; parity: inference_engine.py).

    python -m udp_pose_tpu_torch.infer --source dir/|video.mp4|URL|webcam:0 \\
        --pose-cfg configs/coco/hrnet_w32_256x192_udp_offset.yaml \\
        --detector yolov5n [--fused [--low-bw | --chunk 8 | --pipeline 3]] \\
        [--quantize int8 [--act-scales t.json] [--det-act-scales d.json]]

Boxes come from ``--bbox-dir`` (YOLO label files, the pose-labelling
mode), from the YOLOv5 ``--detector`` (two-stage: host NMS, then the
pose pipeline; or ``--fused``: the whole frame on the device), or else
one box covering the frame.  Annotated images and videos go to
``--save-dir``.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from collections import deque

import numpy as np

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")
STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://")


def parse_args(argv=None):
    from .engine.detector import DETECTORS, detector_name
    p = argparse.ArgumentParser(description="detect-then-pose inference")
    p.add_argument("--source", required=True,
                   help="image / dir / video path, stream URL, or "
                        "'webcam:<id>'")
    p.add_argument("--pose-cfg", required=True)
    p.add_argument("--pose-weights", default="",
                   help="reference .pth pose weights, a .msgpack of the "
                        "JAX package's variables, or an .onnx artifact of "
                        "the exporter (default: seeded random init)")
    p.add_argument("--bbox-dir", default="",
                   help="YOLO label dir (pose-labelling mode)")
    p.add_argument("--detector", default="", type=detector_name,
                   choices=("",) + DETECTORS,
                   help="YOLOv5 variant: n/s/m/l or yolov5n/...")
    p.add_argument("--detector-weights", default="",
                   help="ultralytics YOLOv5 state dict (.pt/.pth), or a "
                        ".msgpack of the JAX package's YOLOv5 variables")
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300,
                   help="NMS detection cap (inference_engine.py --max-det)")
    p.add_argument("--det-size", type=int, default=640,
                   help="detector letterbox size (inference_engine.py "
                        "--imgsz)")
    p.add_argument("--padding", type=int, default=5,
                   help="±px person-box padding before the pose crop")
    p.add_argument("--classes", type=int, nargs="+", default=None,
                   help="keep only these detector class ids before NMS "
                        "(two-stage path)")
    p.add_argument("--agnostic-nms", action="store_true",
                   help="class-agnostic NMS (two-stage path)")
    p.add_argument("--person-class", type=int, default=0)
    p.add_argument("--save-dir", default="infer_out")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--show-fps", action="store_true")
    p.add_argument("--save-pose-txt", action="store_true",
                   help="directory mode: write reference-format pose label "
                        "files (x/img_w y/img_h conf for the first "
                        "person's first 13 joints)")
    p.add_argument("--fused", action="store_true",
                   help="detect and pose each frame on the device with no "
                        "host round trip in between (needs --detector)")
    p.add_argument("--max-persons", type=int, default=16)
    p.add_argument("--low-bw", action="store_true",
                   help="with --fused: upload the host letterbox and host "
                        "crops instead of the frame")
    p.add_argument("--chunk", type=int, default=1,
                   help="with --fused on videos: frames per device batch")
    p.add_argument("--pipeline", type=int, default=1,
                   help="with --fused on videos and webcams: frames kept "
                        "in flight")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="int8 w8a8 serving of the pose net and the detector "
                        "(as TPU.QUANTIZE int8): the first frames serve in "
                        "float while calibrating")
    p.add_argument("--act-scales", default="",
                   help="pose-net calibration table (json): loaded if it "
                        "exists, else written there after "
                        "self-calibration")
    p.add_argument("--det-act-scales", default="",
                   help="detector calibration table (json), loaded or "
                        "written alike; with --quantize int8 and no table "
                        "the detector calibrates on its first letterboxed "
                        "frames")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides, KEY VALUE ...")
    return p.parse_args(argv)


def check_flags(args):
    """The flag guards of ``tools/infer.py``: a combination that would
    silently do nothing stops the run."""
    if args.fused and not args.detector:
        raise SystemExit("--fused needs --detector")
    if args.low_bw and not args.fused:
        raise SystemExit("--low-bw needs --fused")
    if args.low_bw and args.chunk > 1:
        raise SystemExit("--low-bw and --chunk are mutually exclusive "
                         "(the chunked path uploads whole frames)")
    if args.pipeline > 1 and not args.fused:
        raise SystemExit("--pipeline needs --fused")
    if args.fused and (args.classes is not None or args.agnostic_nms):
        raise SystemExit("--classes/--agnostic-nms apply to the two-stage "
                         "path only (the fused NMS is person-class by "
                         "construction)")
    if (args.classes is not None or args.agnostic_nms) \
            and not args.detector:
        raise SystemExit("--classes/--agnostic-nms need --detector")
    if args.det_size != 640 and not args.detector:
        raise SystemExit("--det-size needs --detector")
    if args.pipeline > 1 and args.chunk > 1:
        raise SystemExit("--pipeline and --chunk are mutually exclusive "
                         "(the chunked path is already batched)")
    if args.pipeline > 1 and args.low_bw and args.pipeline != 2:
        print("note: --low-bw pipelining is the fixed 2-stage stream; "
              f"--pipeline {args.pipeline} runs at depth 2", file=sys.stderr)


def main(argv=None):
    args = parse_args(argv)
    check_flags(args)
    src = args.source
    is_video = (os.path.splitext(src)[1].lower() in VIDEO_EXTS
                or src.startswith(STREAM_PREFIXES))
    if args.pipeline > 1 and not (is_video or src.startswith("webcam")):
        raise SystemExit("--pipeline applies to video/webcam sources "
                         "(directory and single-image modes run "
                         "frame-at-a-time)")
    import cv2

    from .config import load_config
    from .engine.detector import LabelBoxDetector, build_yolo_detector
    from .engine.io import FPS, VideoReader, VideoWriter, WebcamStream
    from .engine.pose_engine import UdpPosePipeline

    cfg = load_config(args.pose_cfg, args.opts)
    variant = args.detector.replace("yolov5", "")
    quantize = args.quantize or (cfg.TPU.QUANTIZE or "")
    # a table path is loaded when the file exists, else written at the end
    pose_scales, det_scales = (
        path if path and os.path.exists(path) else None
        for path in (args.act_scales, args.det_act_scales))
    if quantize and args.fused and not args.low_bw and pose_scales is None:
        raise SystemExit(
            "--quantize with --fused needs a calibration table (--act-scales "
            "naming an existing json): the fused path's crops exist only on "
            "the device, so it does not self-calibrate. Produce the table "
            "with a two-stage run (--quantize int8 --act-scales f.json, no "
            "--fused), the test CLI with TPU.QUANTIZE int8, or --low-bw, "
            "which crops on the host and self-calibrates")
    fused = yolo_det = None
    if args.fused:
        from .engine.fused import FusedDetectPose
        fused = FusedDetectPose(
            cfg, args.pose_weights or None, yolo_variant=variant,
            yolo_weights=args.detector_weights or None,
            max_persons=args.max_persons, det_size=args.det_size,
            conf_thres=args.conf_thres, iou_thres=args.iou_thres,
            person_class=args.person_class, padding=args.padding,
            quantize=quantize or None, pose_act_scales=pose_scales,
            det_act_scales=det_scales, device=args.device)
        pose = fused._pose
    else:
        pose = UdpPosePipeline(cfg, args.pose_weights or None,
                               quantize=quantize or None,
                               act_scales=pose_scales, device=args.device)
        if args.detector:
            yolo_det = build_yolo_detector(
                variant=variant, weights=args.detector_weights or None,
                input_size=args.det_size, conf_thres=args.conf_thres,
                iou_thres=args.iou_thres, person_class=args.person_class,
                max_det=args.max_det, classes=args.classes,
                agnostic_nms=args.agnostic_nms, padding=args.padding,
                quantize=quantize or None, act_scales=det_scales,
                calib_batches=cfg.TPU.QUANTIZE_CALIB_BATCHES,
                device=args.device)
    label_det = (LabelBoxDetector(args.bbox_dir, args.person_class)
                 if args.bbox_dir else None)
    os.makedirs(args.save_dir, exist_ok=True)
    fps = FPS()

    def boxes_for(frame, path=None):
        if label_det is not None and path is not None:
            return label_det.infer_for(frame, path)
        if yolo_det is not None:
            return yolo_det.infer(frame)
        h, w = frame.shape[:2]
        return np.array([[0, 0, w - 1, h - 1]], np.float32)

    def write_pose_txt(path, kps, maxvals, img_hw, n_joints=13):
        """Reference label format (inference_engine.py:314-332)."""
        h, w = img_hw
        txt = os.path.join(
            args.save_dir,
            os.path.splitext(os.path.basename(path))[0] + ".txt")
        with open(txt, "w") as f:
            for k, mv in zip(kps[0][:n_joints], maxvals[0][:n_joints]):
                f.write("%f %f %f\n" % (k[0] / w, k[1] / h, float(mv[0])))

    def overlay_fps(img):
        if args.show_fps and fps.fps:
            cv2.putText(img, f"Pose FPS: {fps.fps}", (10, 30),
                        cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 0), 2)
        return img

    def draw(frame, kps):
        return overlay_fps(pose.draw_keypoints(frame, kps))

    def process(frame, path=None):
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if fused is not None and not (label_det and path):
            fps.start()
            out = (fused.infer_frame_low_bw(rgb) if args.low_bw
                   else fused.infer_frame(rgb))
            kps, maxvals = out["keypoints"], out["maxvals"]
            fps.stop(debug=args.show_fps)
        else:
            boxes = boxes_for(rgb, path)
            if boxes is None:
                return frame
            fps.start()
            kps, maxvals = pose.infer_pose(rgb, boxes)
            fps.stop(debug=args.show_fps)
        if args.save_pose_txt and path and len(kps):
            write_pose_txt(path, kps, maxvals, frame.shape[:2])
        return draw(frame, kps)

    def flush_chunk(frames_bgr, writer):
        """One fused device batch over a chunk of BGR frames (the tail
        chunk may be shorter)."""
        rgb = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
                        for f in frames_bgr])
        fps.start()
        results = fused.infer_frames(rgb)
        fps.stop(debug=args.show_fps, count=len(frames_bgr))
        for frame, res in zip(frames_bgr, results):
            out = draw(frame, res["keypoints"])
            if not args.no_save:
                writer.update(out)

    def pipelined(frames_bgr, emit):
        """Keep ``--pipeline`` frames in flight (submit_frame / fetch; with
        --low-bw the two-stage stream).  ``emit(annotated) -> bool``
        (False stops)."""
        if args.low_bw:
            buf = deque()

            def rgb_frames():
                for frame in frames_bgr:
                    buf.append(frame)
                    yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

            fps.start()
            for out in fused.infer_stream_low_bw(rgb_frames()):
                fps.stop(debug=args.show_fps)
                fps.start()
                if emit(draw(buf.popleft(), out["keypoints"])) is False:
                    return
            return
        inflight = deque()
        fps.start()

        def drain_one():
            bgr, handle = inflight.popleft()
            out = fused.fetch(handle)
            fps.stop(debug=args.show_fps)
            fps.start()
            return emit(draw(bgr, out["keypoints"]))

        for frame in frames_bgr:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            inflight.append((frame, fused.submit_frame(rgb)))
            if len(inflight) >= args.pipeline and drain_one() is False:
                return
        while inflight:
            if drain_one() is False:
                return

    if src.startswith("webcam"):
        cam = WebcamStream(int(src.split(":")[1]) if ":" in src else 0)

        def show(out):
            cv2.imshow("pose", out)
            return cv2.waitKey(1) != ord("q")

        if fused is not None and args.pipeline > 1:
            pipelined(cam, show)
        else:
            for frame in cam:
                if not show(process(frame)):
                    break
    elif os.path.isdir(src):
        for path in sorted(glob.glob(os.path.join(src, "*"))):
            frame = cv2.imread(path)
            if frame is None:
                continue
            out = process(frame, path)
            if not args.no_save:
                cv2.imwrite(os.path.join(args.save_dir,
                                         os.path.basename(path)), out)
    elif is_video:
        reader = VideoReader(src)
        name = os.path.basename(src).split("?")[0] or "stream.mp4"
        writer = VideoWriter(os.path.join(args.save_dir, "out_" + name),
                             reader.fps or 30.0)
        if fused is not None and args.chunk > 1:
            pending = []
            for frame in reader:
                pending.append(frame)
                if len(pending) == args.chunk:
                    flush_chunk(pending, writer)
                    pending = []
            if pending:
                flush_chunk(pending, writer)
        elif fused is not None and args.pipeline > 1:
            def emit(out):
                if not args.no_save:
                    writer.update(out)
                return True
            pipelined(reader, emit)
        else:
            for frame in reader:
                out = process(frame)
                if not args.no_save:
                    writer.update(out)
        writer.write()
    else:
        frame = cv2.imread(src)
        if frame is None:
            raise SystemExit(f"cannot read {src}")
        out = process(frame, src)
        if not args.no_save:
            out_path = os.path.join(args.save_dir, os.path.basename(src))
            cv2.imwrite(out_path, out)
            print(f"saved {out_path}")
    save_tables(args, pose, fused, yolo_det)
    return 0


def save_tables(args, pose, fused, yolo_det):
    """Write the calibration tables that this run recorded to the
    ``--act-scales`` / ``--det-act-scales`` paths that did not exist."""
    from .models.quantize import save_act_scales
    if (args.act_scales and pose.int8.table
            and not os.path.exists(args.act_scales)):
        pose.save_act_scales(args.act_scales)
        print(f"saved int8 calibration table to {args.act_scales}")
    if args.det_act_scales and not os.path.exists(args.det_act_scales):
        got = (fused.det_act_scales if fused is not None else
               yolo_det.get_act_scales() if yolo_det is not None else None)
        if got:
            save_act_scales(args.det_act_scales, got)
            print("saved detector int8 calibration table to "
                  f"{args.det_act_scales}")


if __name__ == "__main__":
    sys.exit(main())
