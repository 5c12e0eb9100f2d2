"""The port's checkpoints, resume and weight files against the JAX
package, on the CPU.

The pure-Python msgpack reader and writer against ``flax.serialization``
(bytes and arrays), the state-dict → flax bridge against the JAX
package's converter, ``.msgpack`` weights written by the JAX package in
``UdpPosePipeline``, ``test``, ``serve`` and the detector loader,
``epoch_loader(skip_batches=)`` against the JAX loader, preempted and
resumed ``train.run`` against the uninterrupted run (epoch mode on the
in-process and the worker loader, RSN's iteration mode; bit for bit),
the CLI with ``AUTO_RESUME`` and the rolling backend, ``load_any``
against the JAX ``load_any``, and the SIGTERM guard.
"""

import functools
import hashlib
import logging
import os
import signal
import socket
import types

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from ref_harness import make_mini_coco
from test_torch_hrnet import reduced_cfg
from test_torch_rsn import rsn_cfg
from test_torch_train import restore_root_logger  # noqa: F401
from test_torch_yolov5 import few_threads, numpy_variables  # noqa: F401
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.data import base as jax_base
from udp_pose_tpu.utils import checkpoint as jax_checkpoint
from udp_pose_tpu.utils import orbax_ckpt as jax_orbax
from udp_pose_tpu.utils.torch_convert import torch_to_flax_from_cfg
from udp_pose_tpu_torch import test as test_cli
from udp_pose_tpu_torch import train as train_cli
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.core import train as core_train
from udp_pose_tpu_torch.core.train import TrainState
from udp_pose_tpu_torch.data import base
from udp_pose_tpu_torch.data import build_dataset
from udp_pose_tpu_torch.data import worker_loader as wl
from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.utils import checkpoint as ckpt
from udp_pose_tpu_torch.utils import msgpack
from udp_pose_tpu_torch.utils.convert import (load_yolov5_weights,
                                              state_dict_to_variables,
                                              write_msgpack_weights)
from udp_pose_tpu_torch.utils.orbax_ckpt import OrbaxBackend, load_any
from udp_pose_tpu_torch.utils.preemption import PreemptionGuard


def _tree_equal(got, want, path=""):
    """Same keys, and arrays of the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def hrnet():
    """(port cfg, JAX cfg, a seeded reduced HRNet on the CPU, its flax
    variables through the JAX package's converter)."""
    cfg, jcfg = reduced_cfg(default_config), reduced_cfg(jax_default_config)
    model = build_model(cfg, device="cpu", seed=3)
    variables, unused = torch_to_flax_from_cfg(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    assert not unused
    return cfg, jcfg, model, jax.tree_util.tree_map(np.asarray,
                                                    dict(variables))


def _misc_tree():
    """Every kind of leaf flax writes: ints of each width and sign,
    floats, long strings and bytes, bools, nil, lists, numpy scalars, 0-d
    arrays, a bfloat16 array, and a map of more than 15 integer-named
    keys."""
    rng = np.random.default_rng(1)
    return {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                     -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
            "float": 0.1, "text": "x" * 40, "long": "y" * 300,
            "bytes": b"\x01" * 300, "flag": True, "off": False, "nil": None,
            "scalar": np.float32(2.5), "count": np.int64(-7),
            "zero_d": np.array(3.0), "empty": np.zeros((0, 4), np.int32),
            "u8": rng.integers(0, 255, (3, 100), dtype=np.uint8),
            "bf16": jax.numpy.asarray(rng.normal(size=(2, 3)),
                                      jax.numpy.bfloat16),
            "many": {str(i): np.full((i,), i, np.float32)
                     for i in range(20)}}


# ---------------------------------------------------------------- msgpack
def test_msgpack_reader_equals_flax_restore(hrnet, tmp_path):
    """On the bytes of the JAX package's ``save_weights`` and of a tree of
    every leaf kind: the arrays and values of ``msgpack_restore``, bit
    for bit (a bfloat16 array comes back as float32 of the same
    values)."""
    _, _, _, variables = hrnet
    path = tmp_path / "w.msgpack"
    jax_checkpoint.save_weights(path, types.SimpleNamespace(**variables))
    _tree_equal(msgpack.read_file(path),
                serialization.msgpack_restore(path.read_bytes()))

    blob = serialization.msgpack_serialize(_misc_tree())
    want = serialization.msgpack_restore(blob)
    got = msgpack.restore(blob)
    np.testing.assert_array_equal(got.pop("bf16"),
                                  np.asarray(want.pop("bf16"), np.float32))
    _tree_equal(got, want)


def test_msgpack_writer_bytes_equal_flax(hrnet):
    _, _, _, variables = hrnet
    assert msgpack.serialize(variables) == serialization.msgpack_serialize(
        variables)
    tree = _misc_tree()
    del tree["bf16"]                  # numpy has no bfloat16 to write
    assert msgpack.serialize(tree) == serialization.msgpack_serialize(tree)


def test_state_dict_to_variables_equals_jax_converter(hrnet):
    cfg, _, model, variables = hrnet
    _tree_equal(state_dict_to_variables(model.state_dict(), cfg), variables)


def test_jax_msgpack_weights_serve_as_the_variables(hrnet, tmp_path,
                                                    few_threads):  # noqa: F811
    """``.msgpack`` weights of the JAX package's ``save_weights`` in
    ``UdpPosePipeline`` and a ``serve`` service: the keypoints of the
    same variables passed in directly, bit for bit; the port's own
    writer gives the same file."""
    from udp_pose_tpu_torch.engine.server import PoseService
    cfg, _, model, variables = hrnet
    path = tmp_path / "w.msgpack"
    jax_checkpoint.save_weights(path, types.SimpleNamespace(**variables))
    ours = tmp_path / "ours.msgpack"
    write_msgpack_weights(ours, model.state_dict(), cfg)
    assert ours.read_bytes() == path.read_bytes()

    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (120, 160, 3), np.uint8)
    boxes = np.float32([[10, 10, 80, 110], [60, 20, 150, 115]])
    want = UdpPosePipeline(cfg, variables, device="cpu").infer_pose(
        img, boxes)
    service = PoseService(cfg, weights=str(path), device="cpu")
    try:
        for pipe in (UdpPosePipeline(cfg, str(path), device="cpu"),
                     service.pipe):
            for g, w in zip(pipe.infer_pose(img, boxes), want):
                np.testing.assert_array_equal(g, w)
    finally:
        service.close()


def test_detector_msgpack_weights(tmp_path):
    """A ``.msgpack`` of the JAX package's YOLOv5 variables: the state dict
    of the variables passed in directly."""
    from udp_pose_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
    variables = numpy_variables(JaxYOLOv5(variant="n"), (1, 64, 64, 3))
    path = tmp_path / "det.msgpack"
    path.write_bytes(serialization.msgpack_serialize(variables))
    got, want = load_yolov5_weights(str(path)), load_yolov5_weights(
        jax.tree_util.tree_map(np.asarray, dict(variables)))
    assert sorted(got) == sorted(want) and len(want) > 100
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ the loader
class _Indices:
    """A dataset whose sample is its index."""
    is_train = True

    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"idx": np.int64(i)}


@pytest.mark.parametrize("skip", [0, 2, 5])
def test_epoch_loader_skip_batches_equals_jax(skip):
    ds = _Indices()
    got = [b["idx"] for b in base.epoch_loader(ds, 4, seed=3,
                                               skip_batches=skip)]
    want = [b["idx"] for b in jax_base.epoch_loader(ds, 4, seed=3,
                                                    skip_batches=skip)]
    assert len(got) == len(want) == 5 - skip
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert base.epoch_plan_size(ds, 4, seed=3) == len(
        jax_base.epoch_batch_indices(ds, 4, seed=3)) == 5


# -------------------------------------------------------- resume, bitwise
@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    make_mini_coco(str(root), image_set="train2017", n_images=6, seed=21)
    make_mini_coco(str(root), image_set="val2017", n_images=2, seed=22,
                   all_visible=True)
    return str(root)


def _coco_cfg(cfg, root, out_dir, **over):
    cfg.DATASET.merge_from_dict({"DATASET": "coco", "ROOT": root,
                                 "TRAIN_SET": "train2017",
                                 "TEST_SET": "val2017", "COLOR_RGB": True})
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.BATCH_SIZE_PER_GPU = cfg.TRAIN.BATCH_SIZE_PER_GPU = 4
    cfg.TRAIN.SHUFFLE = True
    cfg.WORKERS = 0
    cfg.PRINT_FREQ = 100
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.merge_from_dict(over)
    return cfg


class StopAfter:
    """A guard whose ``should_stop`` says stop at its ``n``-th poll, that
    is after the run's ``n``-th train step."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    def should_stop(self, num_shards=1, sync=True):
        self.polls += 1
        return self.polls == self.n


@pytest.fixture
def batch_digests(monkeypatch):
    """Each train step's batch, as a digest of its u8 images and
    targets, in the order the steps take them."""
    seen = []
    upload = core_train.upload_batch

    @functools.wraps(upload)
    def spy(batch, device, keys=("target", "target_weight"), *args):
        h = hashlib.sha1()
        for k in ("image",) + tuple(keys):
            h.update(torch.as_tensor(batch[k]).cpu().contiguous().numpy()
                     .tobytes())
        seen.append(h.hexdigest())
        return upload(batch, device, keys, *args)

    monkeypatch.setattr(core_train, "upload_batch", spy)
    return seen


def _train(cfg, guard=None):
    train_ds = build_dataset(cfg, is_train=True)
    val_ds = build_dataset(cfg, is_train=False)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    return train_cli.run(cfg, build_model(cfg, device="cpu", train=True),
                         train_ds, val_ds, cfg.OUTPUT_DIR, "cpu",
                         guard=guard)


def _assert_same_run_state(got_path, want_path):
    """Two checkpoints bit for bit: the model, both Adam moments and the
    step counts, the scheduler (its step and LR) and the train step."""
    got, want = (torch.load(p, weights_only=False)
                 for p in (got_path, want_path))
    assert got.keys() == want.keys()
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    for i, s in want["optimizer"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["optimizer"]["state"][i][name],
                               s[name]), (i, name)
    assert got["optimizer"]["param_groups"] == want["optimizer"][
        "param_groups"]
    assert got["scheduler"] == want["scheduler"]
    for k in set(want) - {"state_dict", "optimizer", "scheduler"}:
        assert got[k] == want[k], k


@pytest.mark.parametrize("loader", ["in_process", "workers"])
def test_preempted_epoch_run_resumes_bit_equal(coco_root, tmp_path, loader,
                                               batch_digests, monkeypatch,
                                               few_threads):  # noqa: F811
    """Epoch mode, reduced HRNet, ``k`` >= 3 steps an epoch: a run that
    the guard stops in the middle of an epoch (epoch 1 step 1 of two in
    process; epoch 0 step 1 of one with the worker loader) and then
    resumes with ``AUTO_RESUME`` takes the uninterrupted run's batches (a
    digest of the u8 images and targets at every step) and ends with its
    checkpoint: weights, Adam moments, scheduler and step, bit for
    bit."""
    epochs = 2 if loader == "in_process" else 1
    over = {"TRAIN": {"END_EPOCH": epochs, "BATCH_SIZE_PER_GPU": 2}}
    if loader == "workers":
        spawn = wl.worker_loader
        monkeypatch.setattr(wl, "worker_loader", functools.partial(
            spawn, multiprocessing_context="spawn", timeout=60))
        over["WORKERS"] = 2

    def cfg_for(name, **more):
        return _coco_cfg(reduced_cfg(default_config), coco_root,
                         tmp_path / name, **over, **more)

    k = len(build_dataset(cfg_for("a"), is_train=True)) // 2
    assert k >= 3
    stop_at = (epochs - 1) * k + 2
    whole = _train(cfg_for("a"))
    want = list(batch_digests)
    n = len(whole["steps"])
    assert n == k * epochs == len(want)

    batch_digests.clear()
    stopped = _train(cfg_for("b"), StopAfter(stop_at))
    assert stopped["preempted"] and len(stopped["steps"]) == stop_at
    assert not (tmp_path / "b" / "final_state.pth").exists()
    payload = torch.load(tmp_path / "b" / "checkpoint.pth",
                         weights_only=False)
    assert (payload["epoch"], payload["step_in_epoch"],
            payload["step"]) == (epochs - 2, 2, stop_at)

    resumed = _train(cfg_for("b", AUTO_RESUME=True))
    assert not resumed["preempted"]
    assert [s["iteration"] for s in resumed["steps"]] == list(
        range(stop_at, n))
    assert batch_digests == want
    _assert_same_run_state(tmp_path / "b" / "checkpoint.pth",
                           tmp_path / "a" / "checkpoint.pth")
    assert resumed["name_values"] == whole["name_values"]


def test_preempted_iteration_run_resumes_bit_equal(coco_root, tmp_path,
                                                   batch_digests,
                                                   few_threads):  # noqa: F811
    """RSN's iteration mode (reduced RSN with ``TPU.REMAT``, 5 iterations,
    3 an epoch, checkpoints every 2): stopped after iteration 3, resumed
    from ``iter-last.pth`` past a whole epoch and one batch of the next,
    it ends with the uninterrupted run's batches and last checkpoint,
    bit for bit."""
    def cfg_for(name, **more):
        return _coco_cfg(rsn_cfg(default_config), coco_root,
                         tmp_path / name, TPU={"REMAT": True},
                         TRAIN={"MAX_ITER": 5, "CHECKPOINT_PERIOD": 2,
                                "ITER_BASELINE_DEVICES": 1,
                                "WARMUP_ITERS": 2, "LR": 1e-3}, **more)

    whole = _train(cfg_for("a"))
    want = list(batch_digests)
    assert [s["iteration"] for s in whole["steps"]] == list(range(5))
    assert whole["steps"][3]["epoch"] == 1

    batch_digests.clear()
    stopped = _train(cfg_for("b"), StopAfter(4))
    assert stopped["preempted"] and os.readlink(
        tmp_path / "b" / "iter-last.pth") == "iter-3.pth"
    resumed = _train(cfg_for("b", AUTO_RESUME=True))
    assert [s["iteration"] for s in resumed["steps"]] == [4]
    assert batch_digests == want
    _assert_same_run_state(tmp_path / "b" / "iter-last.pth",
                           tmp_path / "a" / "iter-last.pth")


# ------------------------------------------------------------ entry point
def test_cli_resumes_with_the_rolling_backend(
        coco_root, tmp_path, caplog, restore_root_logger,  # noqa: F811
        few_threads):  # noqa: F811
    """``train.main`` with ``TPU.CKPT_BACKEND orbax``, ``MODEL.PRETRAINED``
    and ``DEBUG.DEBUG`` for one epoch, then with ``AUTO_RESUME`` for a
    second: the pretrained leaves are grafted, the debug images written,
    the step directories kept, and the second run goes on at the first
    run's step; ``test.main`` evaluates the ``final_state.msgpack`` that
    the JAX trainer would have written as it evaluates the ``.pth``."""
    cfg = _coco_cfg(reduced_cfg(default_config), coco_root,
                    tmp_path / "output", LOG_DIR=str(tmp_path / "log"),
                    PRINT_FREQ=2, TRAIN={"BATCH_SIZE_PER_GPU": 2})
    pretrained = tmp_path / "pre.pth"
    torch.save({k: v for k, v in build_model(cfg, device="cpu", seed=9)
                .state_dict().items() if k.startswith("conv1")}, pretrained)
    cfg.merge_from_dict({
        "TPU": {"CKPT_BACKEND": "orbax", "CKPT_MAX_TO_KEEP": 1},
        "MODEL": {"PRETRAINED": str(pretrained)},
        "DEBUG": {"DEBUG": True, "SAVE_BATCH_IMAGES_GT": True,
                  "SAVE_HEATMAPS_PRED": True}})
    path = tmp_path / "reduced.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    argv = ["--cfg", str(path), "--device", "cpu"]
    caplog.set_level(logging.INFO)
    first = train_cli.main(argv + ["TRAIN.END_EPOCH", "1"])
    run_dir = tmp_path / "output" / "coco" / "pose_hrnet" / "reduced"
    assert f"=> loaded pretrained {pretrained} (1 leaves)" in caplog.text
    for name in ("train_0_0_gt.jpg", "train_0_2_hm_pred.jpg",
                 "val_0_gt.jpg", "val_0_hm_pred.jpg"):
        assert (run_dir / name).exists(), name
    n = len(first["steps"])
    assert os.listdir(run_dir / "orbax") == [str(n)]

    second = train_cli.main(argv + ["TRAIN.END_EPOCH", "2",
                                    "AUTO_RESUME", "True"])
    assert [s["epoch"] for s in second["steps"]] == [1] * n
    assert second["steps"][0]["iteration"] == n
    assert os.listdir(run_dir / "orbax") == [str(2 * n)]

    weights = run_dir / "final_state.pth"
    write_msgpack_weights(run_dir / "final_state.msgpack",
                          torch.load(weights), cfg)
    nv_pth, _ = test_cli.main(argv + ["TEST.MODEL_FILE", str(weights)])
    weights.unlink()
    nv_msgpack, _ = test_cli.main(argv)
    assert nv_msgpack == nv_pth == second["name_values"]


# ------------------------------------------------------ backend and guard
def _tiny_state():
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [2], 0.1)
    state = TrainState(model=model, optimizer=opt, scheduler=sched)
    for _ in range(3):
        model(torch.ones(4, 3)).sum().backward()
        opt.step()
        sched.step()
        state.step += 1
    return model, state


def test_load_any_equals_jax_and_keeps_the_newest(tmp_path):
    """``load_any`` on each meta the trainer saves gives the JAX
    ``load_any``'s tuple for the same meta (a stub backend hands it the
    port's), after a bit-exact restore; three saves with
    ``max_to_keep`` 2 leave the newest two steps."""
    metas = [{"epoch": 3, "perf": 0.5}, {"epoch": 2, "perf": 0.25,
                                         "step_in_epoch": 4},
             {"iteration": 7}]
    model, state = _tiny_state()
    backend = OrbaxBackend(tmp_path, max_to_keep=2)

    class Stub:
        def load(self, jstate):
            return jstate, meta

    for iter_mode in (False, True):
        meta = None
        want = jax_orbax.load_any(Stub(), tmp_path, "state", iter_mode)[1:]
        got = load_any(OrbaxBackend(tmp_path / "none"), model, state,
                       iter_mode, "cpu")
        assert (got if iter_mode else tuple(got)) == (
            want[0] if iter_mode else want)
    for k, m in enumerate(metas):
        state.step = 10 + k
        backend.save(model, state, m)
        backend.wait()
        fresh_model, fresh = _tiny_state()
        with torch.no_grad():
            fresh_model.weight.zero_()
        iter_mode = "iteration" in m
        got = load_any(backend, fresh_model, fresh, iter_mode, "cpu")
        meta = backend.load(fresh_model, fresh, "cpu")
        want = jax_orbax.load_any(Stub(), tmp_path, "state", iter_mode)[1:]
        assert (got if iter_mode else tuple(got)) == (
            want[0] if iter_mode else want)
        assert fresh.step == 10 + k and torch.equal(fresh_model.weight,
                                                    model.weight)
        assert fresh.scheduler.state_dict() == state.scheduler.state_dict()
    assert backend.steps() == [11, 12]
    assert sorted(os.listdir(backend.root)) == ["11", "12"]


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    model, state = _tiny_state()
    ckpt.save_checkpoint(tmp_path, model, state, 4, 0.75, is_best=True,
                         step_in_epoch=2)
    fresh_model, fresh = _tiny_state()
    with torch.no_grad():
        fresh_model.bias.add_(1)
    assert ckpt.load_checkpoint(tmp_path, fresh_model, fresh, "cpu") == (
        5, 0.75, 2)
    assert torch.equal(fresh_model.bias, model.bias)
    for p, q in zip(fresh.optimizer.state.values(),
                    state.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(p[k], q[k]) and p[k].device == q[k].device
    assert fresh.scheduler.get_last_lr() == state.scheduler.get_last_lr()
    assert (tmp_path / "model_best.pth").exists()
    assert ckpt.load_checkpoint(tmp_path / "none", fresh_model, fresh,
                                "cpu") == (0, 0.0, 0)


def test_guard_catches_sigterm_and_reduces_over_processes(tmp_path):
    """A ``SIGTERM`` to this process sets the flag and nothing else; over
    a (one-process) gloo group the flag is all-reduced; the previous
    handler is back afterwards."""
    import torch.distributed as dist
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    try:
        assert not guard.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted and guard.should_stop()
        assert not guard.should_stop(num_shards=2, sync=False)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{port}", world_size=1, rank=0)
        try:
            assert guard.should_stop(num_shards=2)
        finally:
            dist.destroy_process_group()
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGTERM) is prev
