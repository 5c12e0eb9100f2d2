"""The port's on-device augmentation (``DATASET.DEVICE_AUG``) against the
JAX package's ``make_device_augment``, on the CPU.

The JAX draws are reproduced by splitting the key as ``augment`` does
(``udp_pose_tpu/data/device_pipeline.py:203``, ``:94``, ``:144``,
``:153``) and fed into the port's deterministic half, so both packages
augment from the same normals, uniforms and grid indices: the
parameters within 1e-5, the AID masks exactly, the whole augment's
crops within 1e-3 (of 255; 2e-2 where the drawn scale and rotation
enter, see :func:`test_augment_equals_jax`), targets within 1e-5 and
weights exactly.
The port's own draws, its data-parallel rows and a preempted device-aug
epoch are checked on their own.
"""

import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_harness import make_mini_coco
from test_torch_hrnet import reduced_cfg
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.data import device_pipeline as jdp
from udp_pose_tpu_torch import train as train_cli
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.data import build_dataset
from udp_pose_tpu_torch.data import device_pipeline as dp
from udp_pose_tpu_torch.models import build_model

COCO_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
              [15, 16]]
UPPER = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
CANVAS = (240, 320)
CUTOUT = [1.0, 0.2, 2]
HIDE = [1.0, 0.5, [0, 16, 32, 44, 56]]
CROP_ATOL = 1e-3
CROP_ATOL_DRAWN = 2e-2     # see test_augment_equals_jax
TARGET_ATOL = 1e-5


def _cfgs(target_type="gaussian", half_body=0.0, cutout=None, hide=None):
    """(JAX cfg, port cfg) of a 96x128 crop with flip, scale and
    rotation."""
    out = []
    for fn in (jax_default_config, default_config):
        cfg = fn()
        cfg.MODEL.IMAGE_SIZE = [96, 128]
        cfg.MODEL.HEATMAP_SIZE = [24, 32]
        cfg.MODEL.TARGET_TYPE = target_type
        cfg.LOSS.KPD = 3.5
        cfg.DATASET.FLIP = True
        cfg.DATASET.SCALE_FACTOR = 0.35
        cfg.DATASET.ROT_FACTOR = 45
        cfg.DATASET.PROB_HALF_BODY = half_body
        cfg.DATASET.NUM_JOINTS_HALF_BODY = 8
        cfg.DATASET.CUTOUT = cutout
        cfg.DATASET.HIDE_AND_SEEK = hide
        out.append(cfg)
    return out


def _batch(seed, B):
    """A raw batch as the loaders build it: canvases of 200x280 images,
    joints around the box, some invisible."""
    rng = np.random.default_rng(seed)
    canvases, widths = [], []
    for _ in range(B):
        img = rng.integers(0, 256, (200, 280, 3), np.uint8)
        c, (_, w) = dp.pad_to_canvas(img, CANVAS)
        canvases.append(c)
        widths.append(w)
    vis = (rng.uniform(size=(B, 17)) < 0.8).astype(np.float32)
    return {"canvas": np.stack(canvases),
            "joints": rng.uniform(60, 200, (B, 17, 2)).astype(np.float32),
            "joints_vis": vis,
            "center": rng.uniform(100, 180, (B, 2)).astype(np.float32),
            "scale": rng.uniform(0.5, 0.8, (B, 2)).astype(np.float32),
            "width": np.asarray(widths, np.float32)}


def _jax_sample_draws(ks, n_patch, grid_count):
    """One sample's raw draws from its key pair ``ks``, split as the JAX
    ``augment``, ``_sample_aug_params`` and ``_aid_mask`` split it."""
    k_hb, k_hbsel, k_s, k_r, k_rgate, k_f = jax.random.split(ks[0], 6)
    out = {"normal": jnp.stack([jax.random.normal(k) for k in
                                (k_hbsel, k_s, k_r)]),
           "uniform": jnp.stack([jax.random.uniform(k) for k in
                                 (k_hb, k_rgate, k_f)])}
    key = ks[1]
    centre, radius, gate = [], [], []
    for _ in range(n_patch):
        key, kc, kr, kg = jax.random.split(key, 4)
        centre.append(jax.random.uniform(kc, (2,)))
        radius.append(jax.random.uniform(kr, (2,)))
        gate.append(jax.random.uniform(kg))
    out["cut_center"] = jnp.stack(centre) if centre else jnp.zeros((0, 2))
    out["cut_radius"] = jnp.stack(radius) if radius else jnp.zeros((0, 2))
    out["cut_gate"] = jnp.stack(gate) if gate else jnp.zeros((0,))
    key, kg, kgrid, kcell = jax.random.split(key, 4)
    out["hs_gate"] = jax.random.uniform(kg)
    out["hs_grid"] = jax.random.randint(kgrid, (), 0, grid_count - 1)
    out["hs_cells"] = jax.random.uniform(kcell, (64 * 64,))
    return out


def _jax_draws(key, B, n_patch, grid_count):
    keys = jax.random.split(key, B * 2).reshape(B, 2, 2)
    return jax.vmap(functools.partial(_jax_sample_draws, n_patch=n_patch,
                                      grid_count=grid_count))(keys)


def _as_torch(draws):
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in draws.items()}


def jax_draws(key, B, n_patch=0, grid_count=5):
    """The draws the JAX ``augment(key, batch)`` makes for B samples, as
    the port's draw dict (CPU tensors)."""
    return _as_torch(_jax_draws(key, B, n_patch, grid_count))


def jax_augment_and_draws(augment, key, batch, n_patch, grid_count=5):
    """The JAX ``augment(key, batch)`` and its draws from ONE compiled
    graph: XLA merges the two copies of each draw, so the draws are the
    values the augment used (a normal's inverse-erf polynomial rounds by
    the graph it is compiled in)."""
    B = len(batch["canvas"])
    out, draws = jax.jit(lambda k, b: (augment(k, b), _jax_draws(
        k, B, n_patch, grid_count)))(key, batch)
    return out, _as_torch(draws)


@pytest.mark.parametrize("half_body", [0.0, 1.0])
def test_params_from_draws_equal_jax(half_body):
    """``aug_params`` on the JAX draws equals ``_sample_aug_params`` at
    B=8, half-body off and always on (1e-5)."""
    jcfg, cfg = _cfgs(half_body=half_body)
    batch = _batch(0, 8)
    batch["joints_vis"][1, :11] = 0         # one sample with no upper body
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 16).reshape(8, 2, 2)
    upper = np.zeros(17, np.float32)
    upper[list(UPPER)] = 1.0
    kw = dict(scale_factor=0.35, rotation_factor=45,
              prob_half_body=half_body, num_joints_half_body=8,
              aspect_ratio=96 / 128, do_flip=True)
    want = jax.vmap(lambda k, c, s, j, v: jdp._sample_aug_params(
        k, c, s, j, v, upper_mask=jnp.asarray(upper), **kw))(
        keys[:, 0], batch["center"], batch["scale"], batch["joints"],
        batch["joints_vis"])
    got = dp.aug_params(
        jax_draws(key, 8), torch.from_numpy(batch["center"]),
        torch.from_numpy(batch["scale"]), torch.from_numpy(batch["joints"]),
        torch.from_numpy(batch["joints_vis"]),
        upper_mask=torch.from_numpy(upper), **kw)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if half_body:                  # the half-body branch moved the boxes
        assert not np.allclose(got[0].numpy(), batch["center"])


@pytest.mark.parametrize("cutout,hide", [(CUTOUT, None), (None, HIDE),
                                         (CUTOUT, HIDE)])
def test_aid_masks_equal_jax(cutout, hide):
    """``aid_masks`` on the JAX draws equals ``_aid_mask`` exactly, for
    cutout, hide-and-seek and both, at B=16 on 96x128 crops."""
    B, hw = 16, (128, 96)
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, B * 2).reshape(B, 2, 2)
    want = jax.vmap(lambda k: jdp._aid_mask(
        k, hw, tuple(cutout) if cutout else None,
        (HIDE[0], HIDE[1], tuple(HIDE[2])) if hide else None))(keys[:, 1])
    draws = jax_draws(key, B, n_patch=cutout[2] if cutout else 0)
    got = dp.aid_masks(draws, hw, tuple(cutout) if cutout else None,
                       dp._hide_and_seek(hide) if hide else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.0 < got.mean() < 1.0


@pytest.mark.parametrize("target_type", ["gaussian", "offset"])
@pytest.mark.parametrize("drawn_geometry", [False, True])
def test_augment_equals_jax(target_type, drawn_geometry):
    """The whole augment at B=4 on 240x320 canvases, 96x128 crops, with
    half-body, flip, cutout and hide-and-seek, from the JAX draws:
    targets 1e-5, weights exactly, crops 1e-3 (of 255).  With
    ``drawn_geometry`` also the drawn scale (±0.35) and rotation (±45°):
    XLA's normal draws (an inverse-erf polynomial) round by the graph
    they are compiled in, one ulp apart between the augment's graph and
    any graph that hands them out; one ulp of a scale or an angle moves
    a crop of noise by up to ~1e-2, so these crops are held at
    :data:`CROP_ATOL_DRAWN`."""
    jcfg, cfg = _cfgs(target_type, half_body=0.5, cutout=CUTOUT, hide=HIDE)
    if not drawn_geometry:
        for c in (jcfg, cfg):
            c.DATASET.SCALE_FACTOR = c.DATASET.ROT_FACTOR = 0.0
    B = 4
    batch = _batch(1, B)
    key = jax.random.PRNGKey(11)
    jaug = jdp.make_device_augment(jcfg, 17, COCO_PAIRS, UPPER, CANVAS)
    want, draws = jax_augment_and_draws(jaug, key, batch, CUTOUT[2])
    aug = dp.make_device_augment(cfg, 17, COCO_PAIRS, UPPER, CANVAS)
    got = aug(dp.upload_raw(batch, "cpu"), draws)
    crops, target, weight = (t.numpy() for t in got)
    np.testing.assert_allclose(
        crops, np.asarray(want[0]), rtol=0,
        atol=CROP_ATOL_DRAWN if drawn_geometry else CROP_ATOL)
    np.testing.assert_allclose(target, np.asarray(want[1]), rtol=0,
                               atol=TARGET_ATOL)
    np.testing.assert_array_equal(weight, np.asarray(want[2]))
    assert crops.dtype == np.float32 and (crops == 0).mean() > 0.01
    flip = draws["uniform"][:, 2] <= 0.5
    assert 0 < flip.sum() < B                   # both branches taken


def test_own_draws_respect_the_clips_and_flip_half():
    """The port's generator draws: 512 samples' scales within
    1 ± SCALE_FACTOR of the box, rotations within ±2·ROT_FACTOR and 0
    for about 40%, about half flipped; the same seed gives the same
    draws, another seed others."""
    _, cfg = _cfgs(cutout=CUTOUT, hide=HIDE)
    aug = dp.make_device_augment(cfg, 17, COCO_PAIRS, UPPER, CANVAS)
    B = 512
    draws = dp.step_draws(aug, 0, 0, B, "cpu")
    center = torch.full((B, 2), 100.0)
    scale = torch.ones((B, 2))
    joints = torch.zeros((B, 17, 2))
    c, s, rot, flip = dp.aug_params(
        draws, center, scale, joints, torch.ones((B, 17)),
        upper_mask=aug.upper_mask, **aug.params)
    assert torch.equal(c, center)
    assert ((s >= 0.65 - 1e-6) & (s <= 1.35 + 1e-6)).all()
    assert (rot.abs() <= 90).all() and 0.3 < (rot == 0).float().mean() < 0.5
    assert 0.4 < flip.float().mean() < 0.6
    assert draws["hs_grid"].max() < 4            # never the last grid
    again = dp.step_draws(aug, 0, 0, B, "cpu")
    assert all(torch.equal(draws[k], again[k]) for k in draws)
    other = dp.step_draws(aug, 0, 1, B, "cpu")
    assert not torch.equal(draws["normal"], other["normal"])


def test_two_ranks_take_the_rows_one_process_draws(tmp_path):
    """2 gloo ranks, each augmenting its half of a B=8 step from the draws
    of the global batch (the trainer's ``step_draws`` with the rank and
    world of ``process_shard_info``), give the rows one process gives on
    the whole batch, bit for bit."""
    from torch_ranks import Ranks, device_aug_rows
    _, cfg = _cfgs("offset", half_body=0.5, cutout=CUTOUT, hide=HIDE)
    batch = _batch(2, 8)
    alone = Ranks(device_aug_rows, 1, tmp_path, cfg, batch,
                  group=False).results()[0]
    ranks = Ranks(device_aug_rows, 2, tmp_path, cfg, batch).results()
    for i, name in enumerate(("crops", "target", "weight")):
        np.testing.assert_array_equal(
            np.concatenate([r[i] for r in ranks]), alone[i], err_msg=name)


# ------------------------------------------------------- training, resume
@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    make_mini_coco(str(root), image_set="train2017", n_images=6, seed=21)
    make_mini_coco(str(root), image_set="val2017", n_images=2, seed=22,
                   all_visible=True)
    return str(root)


def _train_cfg(root, out_dir, **over):
    cfg = reduced_cfg(default_config)
    cfg.DATASET.merge_from_dict({
        "DATASET": "coco", "ROOT": root, "TRAIN_SET": "train2017",
        "TEST_SET": "val2017", "COLOR_RGB": True, "DEVICE_AUG": True,
        "DEVICE_AUG_CANVAS": [320, 240], "CUTOUT": CUTOUT,
        "HIDE_AND_SEEK": HIDE})
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.BATCH_SIZE_PER_GPU = cfg.TRAIN.BATCH_SIZE_PER_GPU = 2
    cfg.TRAIN.END_EPOCH = 2
    cfg.WORKERS = 0
    cfg.PRINT_FREQ = 1
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.merge_from_dict(over)
    return cfg


class StopAfter:
    """A guard that says stop at its ``n``-th poll (after step ``n``)."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    def should_stop(self, num_shards=1, sync=True):
        self.polls += 1
        return self.polls == self.n


@pytest.fixture
def step_digests(monkeypatch):
    """A digest of each train step's device batch (normalised crops,
    targets, weights), in the order the steps take them."""
    seen = []
    call = dp.DeviceAugment.__call__

    def spy(self, batch, draws):
        out = call(self, batch, draws)
        h = hashlib.sha1()
        for t in out:
            h.update(t.contiguous().numpy().tobytes())
        seen.append(h.hexdigest())
        return out

    monkeypatch.setattr(dp.DeviceAugment, "__call__", spy)
    return seen


def _train(cfg, guard=None):
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    return train_cli.run(cfg, build_model(cfg, device="cpu", train=True),
                         build_dataset(cfg, is_train=True),
                         build_dataset(cfg, is_train=False), cfg.OUTPUT_DIR,
                         "cpu", guard=guard)


@pytest.mark.parametrize("loader", ["in_process", "workers"])
def test_preempted_device_aug_epoch_resumes_bit_equal(coco_root, tmp_path,
                                                      step_digests, loader,
                                                      monkeypatch):
    """Reduced HRNet with ``DATASET.DEVICE_AUG`` (AID's cutout and
    hide-and-seek, B=2), 2 epochs, the in-process loader or 2 worker
    processes (whose canvases come as tensors in shared memory): a run
    stopped after step 2 of epoch 1 and resumed with ``AUTO_RESUME``
    augments each step as the uninterrupted run did (a digest of every
    step's crops and targets) and ends with its weights bit for bit."""
    over = {}
    if loader == "workers":
        from udp_pose_tpu_torch.data import worker_loader as wl
        monkeypatch.setattr(wl, "worker_loader", functools.partial(
            wl.worker_loader, multiprocessing_context="spawn", timeout=60))
        over["WORKERS"] = 2
    whole = _train(_train_cfg(coco_root, tmp_path / "a", **over))
    want = list(step_digests)
    k = len(whole["steps"]) // 2
    assert k >= 3 and len(set(want)) == len(want)
    step_digests.clear()
    stopped = _train(_train_cfg(coco_root, tmp_path / "b", **over),
                     StopAfter(k + 2))
    assert stopped["preempted"] and len(stopped["steps"]) == k + 2
    resumed = _train(_train_cfg(coco_root, tmp_path / "b", AUTO_RESUME=True,
                                **over))
    assert [s["iteration"] for s in resumed["steps"]] == list(
        range(k + 2, 2 * k))
    assert step_digests == want
    got, ref = (torch.load(tmp_path / d / "final_state.pth")
                for d in ("b", "a"))
    assert got.keys() == ref.keys()
    for name, v in ref.items():
        assert torch.equal(got[name], v), name
    assert resumed["name_values"] == whole["name_values"]
