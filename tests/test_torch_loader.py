"""The port's multiprocess training input on the CPU: the worker loader,
zip-member images, the prefetch, and the train / test / serve entry
points on a reduced ``pose_resnet`` yaml with ``WORKERS`` > 0.

Worker processes start with ``spawn`` and each ``DataLoader`` has a
60 s timeout: this process has JAX loaded, and a forked child of it may
deadlock.  Samples are held bit for bit against the JAX package's
dataset after the same per-record seed as its grain loader
(``udp_pose_tpu/data/grain_loader.py:41-45``).
"""

import functools
import logging
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ref_harness import make_mini_coco
from test_torch_mpii import make_mini_mpii, mpii_cfg
from test_torch_serve import _post_npy
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.data import build_dataset as jax_build_dataset
from udp_pose_tpu_torch.config import default_config, load_config
from udp_pose_tpu_torch.data import build_dataset, worker_loader as wl
from udp_pose_tpu_torch.data.base import epoch_batch_indices, epoch_loader
from udp_pose_tpu_torch.data.prefetch import device_prefetch

REPO = Path(__file__).resolve().parents[1]
SPAWN = dict(multiprocessing_context="spawn", timeout=60)
B = 4


@pytest.fixture(scope="module")
def mpii_root(tmp_path_factory):
    """A mini-MPII whose train images are also packed in
    ``images.zip`` (members ``images/<name>``)."""
    root = Path(make_mini_mpii(tmp_path_factory.mktemp("loader_mpii"),
                               n_train=10, seed=4))
    with zipfile.ZipFile(root / "images.zip", "w") as zf:
        for f in sorted((root / "images").glob("train*.jpg")):
            zf.write(f, f"images/{f.name}")
    return root


def _train_ds(default_config_fn, build, root, zipped=False):
    ds = build(mpii_cfg(default_config_fn, root), is_train=True)
    if zipped:
        for rec in ds.db:
            name = Path(rec["image"]).name
            rec["image"] = f"{root}/images.zip@images/{name}"
    return ds


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_worker_batches_do_not_depend_on_workers(mpii_root):
    """Epoch 3's batches in process and from two spawned workers reading
    the images from the zip: the same batches, in the plan's order (the
    in-process loader's ``epoch_batch_indices``), and each sample equal to
    the JAX dataset's after the grain loader's per-record seed."""
    ds = _train_ds(default_config, build_dataset, mpii_root)
    zipped = _train_ds(default_config, build_dataset, mpii_root, True)
    jds = _train_ds(jax_default_config, jax_build_dataset, mpii_root)
    plan = epoch_batch_indices(ds, B, seed=3)
    in_process = list(wl.worker_loader(ds, B, seed=3, num_workers=0))
    workers = list(wl.worker_loader(zipped, B, seed=3, num_workers=2,
                                    **SPAWN))
    assert len(in_process) == len(workers) == len(plan) == 2
    for chunk, got, other in zip(plan, in_process, workers):
        _same_batch({k: v for k, v in other.items() if k != "image_path"},
                    {k: v for k, v in got.items() if k != "image_path"})
        for i, idx in enumerate(chunk):
            seed = int(np.random.SeedSequence([3, int(idx)])
                       .generate_state(1)[0])
            assert wl.record_seed(3, idx) == seed
            jds.seed(seed)
            want = jds[int(idx)]
            for k, v in want.items():
                if k != "image_path":
                    np.testing.assert_array_equal(got[k][i], v, err_msg=k)
            assert got["image_path"][i] == want["image_path"]


def test_zip_member_reads_the_unpacked_image(mpii_root):
    """An ``archive.zip@member`` path gives the bytes-for-bytes image of
    the unpacked file, and a whole sample equal to the file's."""
    ds = _train_ds(default_config, build_dataset, mpii_root)
    zipped = _train_ds(default_config, build_dataset, mpii_root, True)
    assert "@" in zipped.db[0]["image"]
    np.testing.assert_array_equal(zipped._read_image(zipped.db[0]["image"]),
                                  ds._read_image(ds.db[0]["image"]))
    ds.seed(1)
    zipped.seed(1)
    a, b = ds[2], zipped[2]
    for k in a:
        if k != "image_path":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetch_keeps_batch_order_on_the_cpu(mpii_root):
    """On the CPU the prefetch passes the loader's batches through in
    order; an error in the loader reaches the consumer; without a card
    it refuses the default device."""
    ds = _train_ds(default_config, build_dataset, mpii_root)
    ds.seed(0)
    want = list(epoch_loader(ds, B, seed=0))
    ds.seed(0)
    got = list(device_prefetch(epoch_loader(ds, B, seed=0), "cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_batch(g, w)

    def failing():
        yield want[0]
        raise OSError("worker died")

    it = device_prefetch(failing(), "cpu")
    _same_batch(next(it), want[0])
    with pytest.raises(OSError, match="worker died"):
        next(it)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(device_prefetch(iter(want)))


@pytest.fixture
def restore_root_logger():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
    root.setLevel(level)


def test_pose_resnet_entry_points_with_workers(tmp_path, monkeypatch,
                                               restore_root_logger):
    """The reduced ``configs/coco/resnet50_256x192_gaussian.yaml``
    (ResNet-18, 32-wide deconvolutions, 64×64) with ``WORKERS`` 2:
    ``train.main`` builds its batches in two spawned workers through the
    prefetch (the same losses as ``WORKERS`` 0 would not hold: the
    augmentation is seeded per record), ``test.main`` evaluates its
    ``final_state.pth``, and a ``/v1/pose`` server from the yaml answers
    with 17 joints."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.engine.server import PoseServer, PoseService
    root = tmp_path / "coco"
    make_mini_coco(str(root), image_set="train2017", n_images=6, seed=31)
    make_mini_coco(str(root), image_set="val2017", n_images=3, seed=32,
                   all_visible=True)
    cfg = load_config(str(REPO / "configs/coco/resnet50_256x192_gaussian"
                                 ".yaml"))
    cfg.merge_from_dict({
        "OUTPUT_DIR": str(tmp_path / "output"), "LOG_DIR": str(tmp_path),
        "WORKERS": 2, "PRINT_FREQ": 1,
        "DATASET": {"ROOT": str(root)},
        "MODEL": {"IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16],
                  "EXTRA": {"NUM_LAYERS": 18,
                            "NUM_DECONV_FILTERS": [32, 32, 32]}},
        "TRAIN": {"END_EPOCH": 1, "BATCH_SIZE_PER_GPU": B},
        "TEST": {"BATCH_SIZE_PER_GPU": B},
        "TPU": {"DTYPE": "float32"}})
    path = tmp_path / "resnet_reduced.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    calls, loader = [], wl.worker_loader

    @functools.wraps(loader)
    def spawned(*args, **kwargs):
        calls.append(kwargs["num_workers"])
        return loader(*args, **kwargs, **SPAWN)

    monkeypatch.setattr(wl, "worker_loader", spawned)
    record = train_cli.main(["--cfg", str(path), "--device", "cpu"])
    assert calls == [2]
    n_train = len(build_dataset(cfg, is_train=True))
    assert len(record["steps"]) == n_train // B > 1
    assert all(np.isfinite(s["loss"]) for s in record["steps"])
    weights = tmp_path / "output" / "coco" / "pose_resnet" / \
        "resnet_reduced" / "final_state.pth"
    nv, perf = test_cli.main(["--cfg", str(path), "--device", "cpu",
                              "TEST.MODEL_FILE", str(weights)])
    assert nv == record["name_values"]

    service = PoseService(load_config(str(path)), weights=str(weights),
                          device="cpu", window_ms=1.0)
    srv = PoseServer(service, host="127.0.0.1", port=0)
    thread = srv.serve_in_thread()
    try:
        frame = np.random.default_rng(2).integers(0, 256, (90, 120, 3),
                                                  dtype=np.uint8)
        status, body = _post_npy(srv.port, frame,
                                 np.float32([[5, 5, 60, 85]]))
        assert status == 200, body
        assert np.asarray(body["keypoints"]).shape == (1, 17, 2)
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_jax_loaders_draw_different_augmentation(mpii_root):
    """The JAX package's two training loaders are not the same for one
    seed (``tools/train.py:289-290`` calls them identical): in process,
    its grain loader (``num_workers=0``) visits the same records as its
    ``epoch_loader`` without shuffling but augments them differently,
    with a seed per record where ``epoch_loader`` draws from one stream
    an epoch.  The port keeps both behaviours, one per loader: without
    shuffling its worker loader gives the grain loader's batches."""
    from udp_pose_tpu.data.base import epoch_loader as jax_epoch_loader
    from udp_pose_tpu.data.grain_loader import grain_loader
    jds = _train_ds(jax_default_config, jax_build_dataset, mpii_root)
    jds.seed(0)
    stream = list(jax_epoch_loader(jds, B, shuffle=False, seed=0))
    grain = list(grain_loader(jds, B, seed=0, shuffle=False,
                              num_workers=0))
    assert len(stream) == len(grain) == 2
    for a, b in zip(stream, grain):
        np.testing.assert_array_equal(a["image_path"], b["image_path"])
        assert not np.array_equal(a["center"], b["center"])
    ds = _train_ds(default_config, build_dataset, mpii_root)
    ours = list(wl.worker_loader(ds, B, seed=0, shuffle=False,
                                 num_workers=0))
    for a, b in zip(ours, grain):
        _same_batch(a, {k: np.asarray(v) for k, v in b.items()})
