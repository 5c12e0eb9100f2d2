"""On-device augmentation and targets (port of ``udp_pose_tpu/data/
device_pipeline.py``, ``DATASET.DEVICE_AUG``).

The reference augments each sample on the host with OpenCV
(JointsDataset.py:204-239).  Here the host only decodes each image onto
a fixed canvas (:class:`RawSampleView`); the batch's canvases go to the
card once as uint8, and everything else runs there on the whole batch:
the augmentation parameters, the UDP warp as one bilinear gather
(:func:`..ops.affine.warp_affine_batch`), AID's information dropping as
multiplicative masks, and the target encoding.

The randomness is split in two, so that any source of draws can drive
the same augmentation:

* :meth:`DeviceAugment.draw`: raw normals, uniforms and a grid index
  a sample from a ``torch.Generator``, on the batch's device;
* :func:`aug_params` and :func:`aid_masks`: deterministic functions of
  those draws and the samples (``_sample_aug_params`` and ``_aid_mask``
  of the JAX package, batched), then :meth:`DeviceAugment.__call__`.

The trainer seeds the draws of step ``i`` of epoch ``e`` from
``(1234, e, i)`` alone (:func:`step_draws`), the JAX trainer's
``fold_in`` keying, so a resumed epoch draws what the uninterrupted one
drew; each rank of a data-parallel run draws the global batch's and
takes its rows.  The distributions are the reference's (clip and
probability semantics of JointsDataset.py:204-224); the draws are not
its (nor the JAX package's) bits.  The horizontal flip is folded into
the warp matrix (the source x mirrored) instead of flipping the image.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.affine import udp_rotate_joints, udp_warp_matrix, warp_affine_batch
from ..ops.targets import _recip, batch_gaussian_targets, batch_offset_targets

#: the arrays of a raw batch that go to the card
CANVAS_KEYS = ("canvas", "joints", "joints_vis", "center", "scale", "width")
#: the trainer's root seed of the draws (the JAX trainer's PRNGKey(1234))
AUG_SEED = 1234
#: hide-and-seek cells a side of its lookup table (``cell_y * 64 + cell_x``)
CELLS = 64
#: grid sizes when ``HIDE_AND_SEEK`` names only (prob, prob_hide), as the
#: host augmentation's ``HideAndSeek`` defaults them
GRID_SIZES = (0, 16, 32, 44, 56)


def pad_to_canvas(img, canvas_hw):
    """Host helper: ``img`` at the top-left of a zero (h, w, 3) uint8
    canvas (cut to it where larger) → (canvas, (img h, img w)).  Joints
    and centres stay valid because the image sits at the origin."""
    ch, cw = canvas_hw
    out = np.zeros((ch, cw, 3), np.uint8)
    h = min(img.shape[0], ch)
    w = min(img.shape[1], cw)
    out[:h, :w] = img[:h, :w]
    return out, (img.shape[0], img.shape[1])


class RawSampleView:
    """Dataset adapter of the device-aug path: a sample is the raw
    decoded image on a fixed canvas and its geometry (joints, visibility,
    centre, scale, the image's width for the flip), with no warp, no
    augmentation and no target.  ``__len__``, ``seed`` and ``db`` are the
    dataset's, so :func:`.base.epoch_loader` and
    :func:`.worker_loader.worker_loader` carry it unchanged, and
    :func:`.base.collate` stacks its canvases."""

    def __init__(self, dataset, canvas_hw):
        self.dataset = dataset
        self.canvas_hw = (int(canvas_hw[0]), int(canvas_hw[1]))

    def __len__(self):
        return len(self.dataset)

    def seed(self, s):
        self.dataset.seed(s)

    @property
    def db(self):
        return self.dataset.db

    def __getitem__(self, idx):
        ds = self.dataset
        rec = ds.db[idx]
        img = ds._read_image(rec["image"])
        canvas, (_h, w) = pad_to_canvas(img, self.canvas_hw)
        vis = np.asarray(rec["joints_3d_vis"], np.float32)
        if vis.ndim == 2:
            vis = vis[:, 0]
        return {
            "canvas": canvas,
            "joints": np.asarray(rec["joints_3d"], np.float32)[:, :2],
            "joints_vis": vis,
            "center": np.asarray(rec["center"], np.float32),
            "scale": np.asarray(rec["scale"], np.float32),
            "width": np.float32(w),
        }


def upload_raw(batch, device) -> Dict[str, torch.Tensor]:
    """The :data:`CANVAS_KEYS` arrays of a raw host batch on ``device``:
    numpy arrays copied once into pinned memory and uploaded without
    blocking (on the card), tensors moved as they are (the prefetch's
    are there already)."""
    device = torch.device(device)
    out = {}
    for k in CANVAS_KEYS:
        v = batch[k]
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
            if device.type == "cuda":
                v = v.pin_memory()
        out[k] = v.to(device, non_blocking=True)
    return out


def aug_params(draws, center, scale, joints, joints_vis, *, scale_factor,
               rotation_factor, prob_half_body, num_joints_half_body,
               upper_mask, aspect_ratio, do_flip):
    """Each sample's (center (B, 2), scale (B, 2), rot (B,) degrees, flip
    (B,) bool) from its raw draws (``normal`` (B, 3): half-body side,
    scale, rotation; ``uniform`` (B, 3): half-body gate, rotation gate,
    flip), with the semantics of JointsDataset.py:124-167, :204-224 as
    the JAX package's ``_sample_aug_params`` has them, its quirk
    ``normal < 0.5`` for the upper body included.  joints (B, J, 2),
    joints_vis (B, J), upper_mask (J,) float."""
    n_hbsel, n_s, n_r = draws["normal"].unbind(-1)
    u_hb, u_rgate, u_f = draws["uniform"].unbind(-1)
    vis = joints_vis
    up_sel = vis * upper_mask
    lo_sel = vis * (1.0 - upper_mask)
    n_up = up_sel.sum(-1)
    n_lo = lo_sel.sum(-1)
    use_upper = ((n_hbsel < 0.5) & (n_up > 2))[:, None]
    sel = torch.where(use_upper, up_sel,
                      torch.where((n_lo > 2)[:, None], lo_sel, up_sel))
    n_sel = sel.sum(-1)
    safe = n_sel.clamp_min(1.0)
    sel_pts = joints * sel[..., None]
    hb_center = sel_pts[:, 0]
    # summed in joint order, the order the JAX graph adds them in (a
    # centre an ulp apart moves a crop of noise by ~1e-2)
    for j in range(1, sel_pts.shape[1]):
        hb_center = hb_center + sel_pts[:, j]
    hb_center = hb_center / safe[:, None]
    big = 1e9
    on = sel[..., None] > 0
    lt = torch.where(on, joints, big).amin(1)
    rb = torch.where(on, joints, -big).amax(1)
    w = rb[:, 0] - lt[:, 0]
    h = rb[:, 1] - lt[:, 1]
    # constant divisions as XLA compiles them (a product with the
    # float32 reciprocal; ``/ 200 * 1.5`` folded into one product)
    h = torch.where(w > aspect_ratio * h, w * _recip(aspect_ratio), h)
    w = torch.where(w < aspect_ratio * h, h * aspect_ratio, w)
    hb_scale = torch.stack([w, h], -1) * float(
        np.float32(1.5) * np.float32(_recip(200.0)))
    hb_ok = ((vis.sum(-1) > num_joints_half_body)
             & (u_hb < prob_half_body) & (n_sel >= 2))[:, None]
    center = torch.where(hb_ok, hb_center, center)
    scale = torch.where(hb_ok, hb_scale, scale)

    sf, rf = scale_factor, rotation_factor
    scale = scale * torch.clamp(n_s * sf + 1, 1 - sf, 1 + sf)[:, None]
    rot = torch.clamp(n_r * rf, -rf * 2, rf * 2)
    rot = torch.where(u_rgate <= 0.6, rot, 0.0)
    flip = (u_f <= 0.5) & bool(do_flip)
    return center, scale, rot, flip


def aid_masks(draws, hw, cutout=None, hide_and_seek=None):
    """AID's multiplicative (B, H, W) float32 masks (transforms.py:
    144-224 as the JAX package's ``_aid_mask`` has them) from the raw
    draws: ``cut_center``, ``cut_radius`` (B, P, 2) and ``cut_gate`` (B,
    P) uniforms for the cutout's P patches (an ellipse of radii
    ``radius_factor · (1 + u) · W`` a patch, zeroed when its gate is
    under ``prob``); ``hs_gate`` (B,) and ``hs_cells`` (B, 64·64)
    uniforms and ``hs_grid`` (B,) indices into the grid sizes for
    hide-and-seek (each ``grid``-sided cell hidden when its uniform is at
    most ``prob_hide``; the index never picks the last grid size, and a
    grid of 0 hides nothing)."""
    H, W = hw
    dev = draws["hs_gate"].device
    B = draws["hs_gate"].shape[0]
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    mask = torch.ones((B, H, W), dtype=torch.float32, device=dev)
    if cutout:
        prob, radius_factor, num_patch = cutout
        scale = torch.tensor([W, H], dtype=torch.float32, device=dev)
        for i in range(int(num_patch)):
            cx = draws["cut_center"][:, i] * scale
            radius = radius_factor * (1 + draws["cut_radius"][:, i]) * W
            dis = (((cx[:, 0, None, None] - px) / radius[:, 0, None, None])
                   ** 2
                   + ((cx[:, 1, None, None] - py) / radius[:, 1, None, None])
                   ** 2)
            gate = (draws["cut_gate"][:, i] < prob)[:, None, None]
            mask = mask * torch.where(gate & (dis <= 1.0), 0.0, 1.0)
    if hide_and_seek:
        prob, prob_hide, grid_sizes = _hide_and_seek(hide_and_seek)
        grid = torch.tensor(grid_sizes, dtype=torch.int64,
                            device=dev)[draws["hs_grid"]]
        grid_f = grid.clamp_min(1).float()[:, None, None]
        cell_id = (torch.floor(py / grid_f).long() * CELLS
                   + torch.floor(px / grid_f).long())
        inside = cell_id < CELLS * CELLS
        cells = draws["hs_cells"].gather(
            1, cell_id.clamp_max(CELLS * CELLS - 1).reshape(B, -1))
        hide = (cells.reshape(B, H, W) <= prob_hide) & inside
        active = ((draws["hs_gate"] < prob) & (grid > 0))[:, None, None]
        mask = mask * torch.where(active & hide, 0.0, 1.0)
    return mask


def _hide_and_seek(spec):
    """(prob, prob_hide, grid sizes) of ``DATASET.HIDE_AND_SEEK``."""
    spec = tuple(spec)
    if len(spec) == 2:
        spec = spec + (GRID_SIZES,)
    prob, prob_hide, grid_sizes = spec
    return float(prob), float(prob_hide), tuple(int(g) for g in grid_sizes)


def aug_seed(epoch: int, step: int) -> int:
    """The generator seed of the draws of step ``step`` of epoch
    ``epoch``: a function of (:data:`AUG_SEED`, epoch, step) alone."""
    return int(np.random.SeedSequence([AUG_SEED, int(epoch), int(step)])
               .generate_state(1, np.uint64)[0] >> 1)


class DeviceAugment:
    """``augment(batch, draws) -> (images, target, target_weight)`` of
    ``cfg``'s crop, augmentation and targets (the JAX package's
    ``make_device_augment``).

    ``batch``: tensors on one device, canvas (B, Hc, Wc, 3) uint8, joints
    (B, J, 2), joints_vis (B, J) or (B, J, K), center (B, 2), scale (B,
    2), width (B,) the original images' widths (for the flip's mirror);
    ``draws`` from :meth:`draw` (or any source of the same raw values).
    Returns the float32 crops (B, h, w, 3) in [0, 255], AID's masks
    multiplied in and never rounded, and the targets of the UDP-rotated
    joints, all on the batch's device."""

    def __init__(self, cfg, num_joints, flip_pairs, upper_body_ids,
                 canvas_hw: Tuple[int, int]):
        self.canvas_hw = (int(canvas_hw[0]), int(canvas_hw[1]))
        self.img_wh = tuple(int(v) for v in cfg.MODEL.IMAGE_SIZE)
        self.hm_wh = tuple(int(v) for v in cfg.MODEL.HEATMAP_SIZE)
        upper = np.zeros((num_joints,), np.float32)
        upper[list(upper_body_ids)] = 1.0
        self.upper_mask = torch.from_numpy(upper)
        perm = np.arange(num_joints)
        for a, b in flip_pairs:
            perm[a], perm[b] = perm[b], perm[a]
        self.perm = torch.from_numpy(perm)
        d = cfg.DATASET
        self.cutout = tuple(d.CUTOUT) if d.CUTOUT else None
        self.hide_and_seek = (_hide_and_seek(d.HIDE_AND_SEEK)
                              if d.HIDE_AND_SEEK else None)
        self.target_type = cfg.MODEL.TARGET_TYPE
        self.sigma, self.kpd = cfg.MODEL.SIGMA, cfg.LOSS.KPD
        self.params = dict(
            scale_factor=d.SCALE_FACTOR, rotation_factor=d.ROT_FACTOR,
            prob_half_body=d.PROB_HALF_BODY,
            num_joints_half_body=d.NUM_JOINTS_HALF_BODY,
            aspect_ratio=self.img_wh[0] / self.img_wh[1],
            do_flip=bool(d.FLIP))

    def draw(self, generator, batch_size, device=None):
        """``batch_size`` samples' raw draws from ``generator`` (on its
        device unless ``device`` is given): three normals, three uniforms,
        the cutout's five uniforms a patch, hide-and-seek's gate, cells
        and grid index.  The key set is fixed, so :func:`shard_rows` and
        copies between devices see every configuration alike."""
        device = generator.device if device is None else torch.device(device)
        B = int(batch_size)
        n_patch = int(self.cutout[2]) if self.cutout else 0
        n_grid = len(self.hide_and_seek[2]) if self.hide_and_seek else 1

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        return {
            "normal": torch.randn((B, 3), generator=generator,
                                  device=device),
            "uniform": rand(B, 3),
            "cut_center": rand(B, n_patch, 2),
            "cut_radius": rand(B, n_patch, 2),
            "cut_gate": rand(B, n_patch),
            "hs_gate": rand(B),
            "hs_cells": rand(B, CELLS * CELLS),
            # randint(0, len - 1): the last grid size is never drawn
            "hs_grid": torch.randint(0, max(n_grid - 1, 1), (B,),
                                     generator=generator, device=device),
        }

    def __call__(self, batch, draws):
        img_w, img_h = self.img_wh
        joints = batch["joints"].float()
        dev = joints.device
        vis = batch["joints_vis"].float()
        if vis.dim() == 3:
            vis = vis[..., 0]
        w_img = batch["width"].float()
        center, scale, rot, flip = aug_params(
            draws, batch["center"].float(), batch["scale"].float(), joints,
            vis, upper_mask=self.upper_mask.to(dev), **self.params)
        # the flip folded into the geometry: mirrored joints (swapped
        # pairs, zeroed where invisible) and centre, and a warp that
        # mirrors the source x
        perm = self.perm.to(dev)
        j_f = torch.stack([w_img[:, None] - joints[..., 0] - 1,
                           joints[..., 1]], -1)[:, perm] * vis[:, perm, None]
        f = flip[:, None]
        j_use = torch.where(f[..., None], j_f, joints)
        v_use = torch.where(f, vis[:, perm], vis)
        c_use = torch.where(
            f, torch.stack([w_img - center[:, 0] - 1, center[:, 1]], -1),
            center)
        M = udp_warp_matrix(rot, c_use, scale, (img_w, img_h),
                            compiled_div=True)
        M_flip = torch.stack([
            torch.stack([-M[:, 0, 0], -M[:, 0, 1],
                         w_img - 1.0 - M[:, 0, 2]], -1),
            M[:, 1]], -2)
        M_use = torch.where(flip[:, None, None], M_flip, M)
        # the canvases stay uint8 into the warp: its taps are gathered as
        # bytes and weighted in float32
        crops = warp_affine_batch(batch["canvas"], M_use, (img_h, img_w))
        mapped = udp_rotate_joints(j_use, rot[:, None], c_use[:, None],
                                   scale[:, None], (img_w, img_h))
        mask = aid_masks(draws, (img_h, img_w), self.cutout,
                         self.hide_and_seek)
        crops = crops * mask[..., None]
        if self.target_type == "offset":
            target, weight = batch_offset_targets(
                mapped, v_use, self.hm_wh, self.img_wh, self.kpd)
        else:
            target, weight = batch_gaussian_targets(
                mapped, v_use, self.hm_wh, self.img_wh, self.sigma)
        return crops, target, weight


def make_device_augment(cfg, num_joints, flip_pairs, upper_body_ids,
                        canvas_hw):
    """The :class:`DeviceAugment` of ``cfg`` (the JAX package's
    ``make_device_augment``)."""
    return DeviceAugment(cfg, num_joints, flip_pairs, upper_body_ids,
                         canvas_hw)


def shard_rows(draws, shard_index: int, num_shards: int):
    """Shard ``shard_index``'s rows of draws made for the global batch:
    the ``shard_index``-th of ``num_shards`` equal row blocks, the rows
    its batch holds in the global one."""
    if num_shards == 1:
        return draws
    n = draws["hs_gate"].shape[0] // num_shards
    rows = slice(shard_index * n, (shard_index + 1) * n)
    return {k: v[rows] for k, v in draws.items()}


def step_draws(augment: DeviceAugment, epoch: int, step: int,
               global_batch: int, device, shard_index: int = 0,
               num_shards: int = 1):
    """The draws of step ``step`` of epoch ``epoch`` for shard
    ``shard_index`` of ``num_shards``: the global batch's from a
    generator on ``device`` seeded by :func:`aug_seed`, cut to the
    shard's rows."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(aug_seed(epoch, step))
    return shard_rows(augment.draw(gen, global_batch), shard_index,
                      num_shards)
