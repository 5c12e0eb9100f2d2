"""Media IO and drawing for the inference CLI (port of
``udp_pose_tpu/engine/io.py``).

Parity: tools/infer_utils/utils.py — draw_keypoints :31-43, WebcamStream
:46-75 (threaded), VideoReader/Writer :78-116 (OpenCV-backed), FPS
:119-141.  ``FPS.stop`` is called once the interval's results are on the
host: their readback has waited for the card.
"""

from __future__ import annotations

import time
from threading import Thread

import numpy as np


def draw_keypoints(img, keypoints, skeleton=None, r=1):
    """keypoints (N, J, 2); skeleton is a list of 1-based joint pairs."""
    import cv2
    for kpts in keypoints:
        pts = [tuple(map(int, p[:2])) for p in kpts]
        if skeleton:
            for k1, k2 in skeleton:
                cv2.line(img, pts[k1 - 1], pts[k2 - 1], (0, 255, 0), 2,
                         cv2.LINE_AA)
        for p in pts:
            cv2.circle(img, p, r, (255, 0, 0), 2, cv2.LINE_AA)
    return img


class WebcamStream:
    """Latest frame of a camera, read by a daemon thread."""

    def __init__(self, src=0):
        import cv2
        self.cap = cv2.VideoCapture(src)
        if not self.cap.isOpened():
            raise OSError(f"failed to open webcam {src}")
        _, self.frame = self.cap.read()
        Thread(target=self._update, daemon=True).start()

    def _update(self):
        while self.cap.isOpened():
            _, self.frame = self.cap.read()

    def __iter__(self):
        return self

    def __next__(self):
        if self.frame is None:
            raise StopIteration
        return self.frame.copy()


class VideoReader:
    """BGR frames of a video file or stream URL."""

    def __init__(self, path):
        import cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise OSError(f"failed to open video {path}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.n_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def __len__(self):
        return self.n_frames

    def __iter__(self):
        return self

    def __next__(self):
        ok, frame = self.cap.read()
        if not ok:
            self.cap.release()
            raise StopIteration
        return frame


class VideoWriter:
    """mp4v writer opened at the first frame's size."""

    def __init__(self, path, fps):
        self.path = path
        self.fps = fps
        self._writer = None

    def update(self, frame):
        import cv2
        if self._writer is None:
            h, w = frame.shape[:2]
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        self._writer.write(np.asarray(frame))

    def write(self):
        if self._writer is not None:
            self._writer.release()


class FPS:
    """Rolling frames-per-second meter over ``avg`` frames."""

    def __init__(self, avg=10):
        self.accum_time = 0.0
        self.counts = 0
        self.avg = avg
        self.fps = 0.0

    def start(self):
        self.prev_time = time.time()

    def stop(self, debug=True, count=1):
        """End an interval whose results the host holds; ``count``: the
        frames it covered."""
        self.accum_time += time.time() - self.prev_time
        self.counts += count
        if self.counts >= self.avg:
            self.fps = round(self.counts / self.accum_time)
            if debug:
                print(f"FPS: {self.fps}")
            self.counts = 0
            self.accum_time = 0.0
        return self.fps
