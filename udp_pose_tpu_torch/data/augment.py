"""AID information-dropping augmentation (port of
``udp_pose_tpu/data/augment.py``).

Parity: Cutout / HideAndSeek (deep_hrnet/lib/utils/transforms.py:144-224).
They run in the host data workers on the warped crop and draw from the
caller's ``np.random.Generator`` in the JAX package's order.
"""

from __future__ import annotations

import numpy as np


class Cutout:
    """Zero out ``num_patch`` random elliptic discs (transforms.py:186-224)."""

    def __init__(self, prob=1.0, radius_factor=0.2, num_patch=1):
        self.prob = prob
        self.radius_factor = radius_factor
        self.num_patch = num_patch

    def __call__(self, img, rng: np.random.Generator):
        if rng.random() >= self.prob:
            return img
        h, w = img.shape[:2]
        flat = img.reshape(h * w, -1)
        fx, fy = np.meshgrid(np.arange(w), np.arange(h))
        fx, fy = fx.ravel(), fy.ravel()
        for _ in range(self.num_patch):
            cx, cy = rng.random() * w, rng.random() * h
            radius = self.radius_factor * (1 + rng.random(2)) * w
            dis = ((cx - fx) / radius[0]) ** 2 + ((cy - fy) / radius[1]) ** 2
            flat[dis <= 1] = 0
        return flat.reshape(h, w, -1)


class HideAndSeek:
    """Zero out random grid patches (transforms.py:144-183).

    Note the reference indexes ``img[x:x_end, y:y_end]`` — i.e. its "x"
    iterates *rows*; reproduced faithfully (the aug is symmetric in
    distribution anyway).
    """

    def __init__(self, prob=1.0, prob_hiding_patches=0.5,
                 grid_sizes=(0, 16, 32, 44, 56)):
        self.prob = prob
        self.prob_hiding_patches = prob_hiding_patches
        self.grid_sizes = tuple(grid_sizes)

    def __call__(self, img, rng: np.random.Generator):
        if rng.random() >= self.prob:
            return img
        h, w = img.shape[:2]
        grid = self.grid_sizes[rng.integers(0, len(self.grid_sizes) - 1)]
        if grid == 0:
            return img
        for x in range(0, w, grid):
            for y in range(0, h, grid):
                if rng.random() <= self.prob_hiding_patches:
                    img[x:min(w, x + grid), y:min(h, y + grid)] = 0
        return img
