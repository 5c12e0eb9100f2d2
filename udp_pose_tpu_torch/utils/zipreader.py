"""Images inside zip archives: ``archive.zip@member.jpg`` paths.

Port of ``udp_pose_tpu/utils/zipreader.py`` (parity: deep_hrnet/lib/
utils/zipreader.py:23-46).  Each process keeps its own cache of open
archives, keyed by path and owned by the process that opened them: a
worker process that inherits the parent's cache opens its own handles
(a ``ZipFile``'s file offset is not shared safely across a fork).
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

_handles = {}          # (pid, archive path) → ZipFile


def split_zip_path(path):
    """``a.zip@m/x.jpg`` → (``a.zip``, ``m/x.jpg``)."""
    pos = path.index("@")
    return path[:pos], path[pos + 1:]


def read_bytes(path):
    """The bytes of the member that ``path`` names."""
    zip_path, member = split_zip_path(path)
    key = (os.getpid(), zip_path)
    zf = _handles.get(key)
    if zf is None:
        zf = _handles[key] = zipfile.ZipFile(zip_path, "r")
    return zf.read(member.lstrip("/"))


def imread(path, flags=None):
    """``cv2.imread`` for a zip-member path (BGR uint8, or None when the
    bytes do not decode)."""
    import cv2
    data = np.frombuffer(read_bytes(path), np.uint8)
    if flags is None:
        flags = cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION
    return cv2.imdecode(data, flags)
