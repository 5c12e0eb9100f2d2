"""The port's training path against the JAX package, on the CPU.

Losses and PCK, the optimizer and its LR schedule against optax, the
flax-style BatchNorm running stats, one fp32 train step of the reduced
HRNet (loss and every gradient against ``jax.value_and_grad``), the
flip-test validation against the JAX ``validate``, and the ``train`` and
``test`` entry points on a mini-COCO.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ref_harness import make_mini_coco
from test_torch_hrnet import bridged_pair, reduced_cfg
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.core import accuracy as jax_accuracy
from udp_pose_tpu.core import loss as jax_loss
from udp_pose_tpu.core import train as jax_train
from udp_pose_tpu.core.validate import validate as jax_validate
from udp_pose_tpu.data import build_dataset as jax_build_dataset
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.core import accuracy, loss
from udp_pose_tpu_torch.core.train import (create_train_state, make_optimizer,
                                           make_train_step)
from udp_pose_tpu_torch.core.validate import validate
from udp_pose_tpu_torch.data import build_dataset
from udp_pose_tpu_torch.engine.pose_engine import UdpPosePipeline
from udp_pose_tpu_torch.ops.targets import offset_targets_np
from udp_pose_tpu_torch.utils.convert import variables_to_state_dict


@pytest.fixture(scope="module")
def pair():
    return bridged_pair()


def _loss_inputs(seed, offset, weight_ndim):
    rng = np.random.default_rng(seed)
    C = 51 if offset else 17
    out = rng.normal(0, 0.5, (3, C, 16, 12)).astype(np.float32)
    tgt = rng.uniform(0, 1, (3, C, 16, 12)).astype(np.float32)
    if offset:
        tgt[:, 0::3] = (tgt[:, 0::3] > 0.6).astype(np.float32)
    w = rng.choice([0.0, 1.0, 1.5], (3, 17)).astype(np.float32)
    return out, tgt, (w if weight_ndim == 2 else w[..., None])


@pytest.mark.parametrize("name,weight_ndim", [
    ("joints_mse_loss", 2), ("joints_mse_loss_offset", 3),
    ("joints_l1_loss_offset", 2), ("joints_ohkm_mse_loss", 3)])
def test_losses_equal_jax(name, weight_ndim):
    out, tgt, w = _loss_inputs(1, "offset" in name, weight_ndim)
    got = getattr(loss, name)(torch.from_numpy(out), torch.from_numpy(tgt),
                              torch.from_numpy(w))
    want = getattr(jax_loss, name)(jnp.asarray(out), jnp.asarray(tgt),
                                   jnp.asarray(w))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, v in zip(got, want):
        np.testing.assert_allclose(float(g), float(v), rtol=1e-6, atol=0)


def test_pck_accuracy_equal_jax():
    out, tgt, _ = _loss_inputs(2, False, 2)
    tgt[0, 3] = 0.0                   # a joint whose target peaks at (0, 0)
    got = accuracy.pck_accuracy(out, tgt)
    want = jax_accuracy.pck_accuracy(out, tgt)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    np.testing.assert_array_equal(got[3], want[3])


# -------------------------------------------------------------- optimizer
def _opt_cfg(name):
    cfg = default_config()
    cfg.TRAIN.OPTIMIZER = name
    cfg.TRAIN.LR = 1e-2
    cfg.TRAIN.LR_STEP = [2, 3]
    cfg.TRAIN.LR_FACTOR = 0.1
    cfg.TRAIN.NESTEROV = True
    cfg.TRAIN.WD = 1e-3
    return cfg


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_equals_optax_across_lr_boundaries(name):
    """Identical gradient trees for 10 steps at 3 steps an epoch (LR
    boundaries at steps 6 and 9): the parameters agree to 1e-6, and the
    LR at each boundary -1, 0, +1 is optax's."""
    cfg, spe = _opt_cfg(name), 3
    rng = np.random.default_rng(4)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(10)]

    jcfg = jax_default_config()
    jcfg.TRAIN.merge_from_dict(cfg.TRAIN.to_dict())
    tx = jax_train.make_optimizer(jcfg, spe)
    sched = jax_train.multistep_lr(cfg.TRAIN.LR, cfg.TRAIN.LR_STEP,
                                   cfg.TRAIN.LR_FACTOR, spe)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jparams)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt, scheduler = make_optimizer(cfg, params.values(), spe)
    for step, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(sched(step)), rel=1e-6), step
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        scheduler.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} step {step}")
    lrs = [float(sched(s)) for s in (5, 6, 7, 8, 9, 10)]
    assert lrs == pytest.approx([1e-2, 1e-3, 1e-3, 1e-3, 1e-4, 1e-4])


# ------------------------------------------------------ BN and one step
def _train_batch(cfg, B=2, seed=5):
    rng = np.random.default_rng(seed)
    w, h = cfg.MODEL.IMAGE_SIZE
    image = rng.normal(size=(B, h, w, 3)).astype(np.float32)
    tgts, wts = [], []
    for _ in range(B):
        joints = np.concatenate([rng.uniform(0, w - 1, (17, 1)),
                                 rng.uniform(0, h - 1, (17, 1)),
                                 np.zeros((17, 1))], 1)
        vis = rng.choice([0.0, 1.0], (17, 1), p=[0.2, 0.8]).repeat(3, 1)
        t, wt = offset_targets_np(joints, vis, cfg.MODEL.HEATMAP_SIZE,
                                  cfg.MODEL.IMAGE_SIZE, cfg.LOSS.KPD)
        tgts.append(t)
        wts.append(wt)
    return {"image": image, "target": np.stack(tgts),
            "target_weight": np.stack(wts)}


def _bn_stats(sd):
    return {k: np.asarray(v) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def test_bn_running_stats_equal_flax(pair):
    """Train-mode forward at B=2: the running stats of every BN, the 2×2
    branch's included (where torch's unbiased update would differ by
    8/7), against flax's ``mutable=['batch_stats']``."""
    jmodel, variables, model, cfg = pair
    model = _copy(model, cfg)
    x = _train_batch(cfg)["image"]
    _, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    want = _bn_stats(variables_to_state_dict(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]},
        cfg))
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = _bn_stats({k: v.numpy() for k, v in model.state_dict().items()})
    assert sorted(got) == sorted(want) and len(got) > 50
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _copy(model, cfg):
    from udp_pose_tpu_torch.models import build_model
    fresh = build_model(cfg, device="cpu", train=True)
    fresh.load_state_dict(model.state_dict())
    return fresh


def _jax_value_and_grad(jmodel, variables, batch, dtype):
    """``jax.value_and_grad`` of the JAX package's train-step loss
    (udp_pose_tpu/core/train.py:103-110) with the model computing in
    ``dtype``: (loss, aux, grads as numpy)."""
    loss_fn = jax_loss.make_loss_fn(reduced_cfg(jax_default_config))
    jmodel = jmodel.clone(dtype=dtype)
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                       variables)

    def loss_of(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(batch["image"], dtype), train=True,
            mutable=["batch_stats"])
        nchw = out.transpose(0, 3, 1, 2).astype(jnp.float32)
        return loss_fn(nchw, jnp.asarray(batch["target"]),
                       jnp.asarray(batch["target_weight"]))

    (jl, jaux), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"])
    return jl, jaux, jax.tree_util.tree_map(np.asarray, grads)


def test_one_fp32_step_equals_jax_value_and_grad(pair):
    """One fp32 train step: loss, loss_hm and loss_os to rtol 1e-5 against
    the JAX package's fp32 ``value_and_grad``; every gradient to 1e-4 x
    its tensor's max |g| against the same function computed in float64.
    (In float32 the JAX gradients of layer1 and the stem are themselves
    off by up to 1.7% of a tensor's max, where layer1's output feeds
    the transitions' batch norms; the port's are within 2e-5 of float64
    there.)"""
    jmodel, variables, model, cfg = pair
    batch = _train_batch(cfg)
    jl, jaux, _ = _jax_value_and_grad(jmodel, variables, batch, jnp.float32)
    with jax.enable_x64(True):
        _, _, grads64 = _jax_value_and_grad(jmodel, variables, batch,
                                            jnp.float64)
    want = variables_to_state_dict(
        {"params": grads64, "batch_stats": variables["batch_stats"]}, cfg)

    state = create_train_state(cfg, _copy(model, cfg), steps_per_epoch=10)
    metrics = make_train_step(loss.make_loss_fn(cfg))(state, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
    for k in ("loss_hm", "loss_os"):
        np.testing.assert_allclose(float(metrics[k]), float(jaux[k]),
                                   rtol=1e-5)
    named = dict(state.model.named_parameters())
    assert len(named) > 100 and set(named) <= set(want)
    for k, p in named.items():
        assert want[k].dtype == np.float64
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    assert state.step == 1


# -------------------------------------------------------------- validate
@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    make_mini_coco(str(root), image_set="train2017", n_images=6, seed=21)
    make_mini_coco(str(root), image_set="val2017", n_images=4, seed=22,
                   all_visible=True)
    return str(root)


def _data_cfg(default_config_fn, root):
    cfg = reduced_cfg(default_config_fn)
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = root
    cfg.DATASET.TRAIN_SET = "train2017"
    cfg.DATASET.TEST_SET = "val2017"
    cfg.DATASET.COLOR_RGB = True
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.FLIP_TEST = True
    cfg.TEST.POST_PROCESS = True
    cfg.TEST.BATCH_SIZE_PER_GPU = 4
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 4
    # batches built in process: this process has JAX loaded, and the
    # trainer's forked loader workers of it could deadlock
    # (tests/test_torch_loader.py runs the workers, spawned)
    cfg.WORKERS = 0
    return cfg


def _spy_on_evaluate(ds):
    seen = {}
    evaluate = ds.evaluate

    def spy(cfg, preds, *args, **kwargs):
        seen["preds"] = np.array(preds)
        return evaluate(cfg, preds, *args, **kwargs)

    ds.evaluate = spy
    return seen


def test_validate_equals_jax(pair, coco_root, tmp_path):
    """Flip-test validation of the same weights: preds within 1e-3 px,
    maxvals within 1e-5, AP and the other stats within 1e-6 (the JAX
    loop pads its last batch, the port's does not)."""
    jmodel, variables, model, _ = pair
    ours = build_dataset(_data_cfg(default_config, coco_root))
    theirs = jax_build_dataset(_data_cfg(jax_default_config, coco_root))
    seen_ours, seen_theirs = _spy_on_evaluate(ours), _spy_on_evaluate(theirs)
    assert len(ours) % 4, "the last batch should be a partial one"
    nv, perf = validate(ours.cfg, ours, model.eval(), str(tmp_path / "a"))
    jnv, jperf = jax_validate(theirs.cfg, theirs, jmodel, variables,
                              str(tmp_path / "b"))
    got, want = seen_ours["preds"], seen_theirs["preds"]
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5)
    assert perf == pytest.approx(jperf, abs=1e-6)
    for k in jnv:
        assert nv[k] == pytest.approx(jnv[k], abs=1e-6), k


def test_validate_preds_are_the_pipelines(pair, coco_root):
    """For the same weights the validation's preds are what
    ``UdpPosePipeline`` returns for the same crops and boxes."""
    _, _, model, cfg = pair
    ds = build_dataset(_data_cfg(default_config, coco_root))
    seen = _spy_on_evaluate(ds)
    validate(ds.cfg, ds, model.eval(), batch_size=len(ds))
    pipe = UdpPosePipeline(ds.cfg, weights=model.state_dict(), device="cpu")
    samples = [ds[i] for i in range(len(ds))]
    preds, maxvals = pipe.infer_fn(
        np.stack([s["image"] for s in samples]),
        np.stack([s["center"] for s in samples]),
        np.stack([s["scale"] for s in samples]))[:2]
    np.testing.assert_array_equal(seen["preds"][..., :2], preds.numpy())
    np.testing.assert_array_equal(seen["preds"][..., 2:], maxvals.numpy())


# ------------------------------------------------------------ entry points
@pytest.fixture
def restore_root_logger():
    """``create_logger`` adds a console handler to the root logger, as
    the reference's does; take it off again after the test."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
    root.setLevel(level)


def test_train_and_test_entry_points_on_cpu(coco_root, tmp_path,
                                            restore_root_logger):
    """``train.main`` for one epoch, ``test.main`` on its
    ``final_state.pth``, and a ``strict=True`` load of that file."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    cfg = _data_cfg(default_config, coco_root)
    cfg.TRAIN.END_EPOCH = 1
    cfg.PRINT_FREQ = 2
    cfg.OUTPUT_DIR = str(tmp_path / "output")
    cfg.LOG_DIR = str(tmp_path / "log")
    path = tmp_path / "reduced.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))

    record = train_cli.main(["--cfg", str(path), "--device", "cpu"])
    steps = record["steps"]
    assert len(steps) == len(build_dataset(cfg, is_train=True)) // 4 > 1
    assert all(np.isfinite(s["loss"]) for s in steps)
    run_dir = tmp_path / "output" / "coco" / "pose_hrnet" / "reduced"
    weights = run_dir / "final_state.pth"
    assert weights.exists()

    pipe = UdpPosePipeline(cfg, weights=str(weights), device="cpu")
    saved = torch.load(weights)
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert int(saved["bn1.num_batches_tracked"]) == len(steps)

    nv, perf = test_cli.main(["--cfg", str(path), "--device", "cpu",
                              "TEST.MODEL_FILE", str(weights)])
    assert nv == record["name_values"]
    assert (run_dir / "results" /
            "keypoints_val2017_results_0.json").exists()


def test_entry_points_refuse_what_is_not_ported(tmp_path, coco_root):
    """``TPU.TP`` on a model axis > 1 still raises; ``TPU.PP`` there
    trains an RSN pipelined (two stages on the CPU twice) and any other
    model the plain step, as the JAX trainer (``tools/train.py:181``);
    on a model axis of 1 both keys train and test the plain step through
    the CLIs (``:181``, ``:213``), and ``TPU.QAT int8`` with ``TPU.PP``
    raises ``ValueError`` whatever the mesh (``:81-88``).  ``DATASET.DEVICE_AUG`` (ported) trains a reduced
    step through ``train.main``, its crops and targets made by the device
    augmentation, and raises for RSN as the JAX trainer does."""
    from udp_pose_tpu_torch import test as test_cli
    from udp_pose_tpu_torch import train as train_cli
    from udp_pose_tpu_torch.data import device_pipeline as dp
    cfg = reduced_cfg(default_config)
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train_cli.main(["--cfg", str(path), "--device", "cpu", "TPU.TP",
                        "True", "TPU.MESH.MODEL", "2"])
    for mesh in ("1", "2"):
        with pytest.raises(ValueError, match="TPU.QAT is not supported "
                                             "together with TPU.PP"):
            train_cli.main(["--cfg", str(path), "--device", "cpu",
                            "TPU.QAT", "int8", "TPU.PP", "True",
                            "TPU.MESH.MODEL", mesh])
    cfg = _data_cfg(default_config, coco_root)
    cfg.TRAIN.END_EPOCH = 1
    cfg.TEST.FLIP_TEST = False
    cfg.LOG_DIR = str(tmp_path / "log")
    path.write_text(yaml.safe_dump(cfg.to_dict()))

    def trained(name, *opts):
        out = str(tmp_path / name)
        record = train_cli.main(["--cfg", str(path), "--device", "cpu",
                                 "OUTPUT_DIR", out, *opts])
        weights = tmp_path / name / "coco" / "pose_hrnet" / "c" / \
            "final_state.pth"
        return record, torch.load(weights), str(weights)

    # both keys at once: at a model axis of 1 the JAX trainer takes
    # neither branch, so it neither pipelines nor refuses TPU.PP + TPU.TP
    axis = ["TPU.PP", "True", "TPU.TP", "True", "TPU.MESH.MODEL", "1"]
    plain, plain_sd, _ = trained("plain")
    record, sd, weights = trained("axis", *axis)
    assert [s["loss"] for s in record["steps"]] == \
        [s["loss"] for s in plain["steps"]]
    assert sd.keys() == plain_sd.keys()
    for k, v in sd.items():
        assert torch.equal(v, plain_sd[k]), k
    nv, _ = test_cli.main(["--cfg", str(path), "--device", "cpu",
                           "OUTPUT_DIR", str(tmp_path / "axis"), *axis,
                           "TEST.MODEL_FILE", weights])
    assert nv == plain["name_values"]
    # TPU.PP on a model axis of 2: the plain step for HRNet
    record, sd, _ = trained("pp2", "TPU.PP", "True", "TPU.MESH.MODEL", "2")
    assert [s["loss"] for s in record["steps"]] == \
        [s["loss"] for s in plain["steps"]]
    for k, v in sd.items():
        assert torch.equal(v, plain_sd[k]), k
    # and pipelined for a two-stage RSN, whose weights load into the plain
    # RSN
    rsn_cfg = _data_cfg(default_config, coco_root)
    rsn_cfg.TRAIN.END_EPOCH = 1
    rsn_cfg.TEST.FLIP_TEST = False
    rsn_cfg.LOG_DIR = str(tmp_path / "log")
    rsn_cfg.OUTPUT_DIR = str(tmp_path / "rsn")
    rsn_cfg.MODEL.NAME = "rsn"
    rsn_cfg.MODEL.EXTRA.merge_from_dict({"STAGE_NUM": 2, "LAYERS": [1] * 4,
                                         "UPSAMPLE_CHANNEL_NUM": 32})
    path.write_text(yaml.safe_dump(rsn_cfg.to_dict()))
    record = train_cli.main(["--cfg", str(path), "--device", "cpu",
                             "TPU.PP", "True", "TPU.MESH.MODEL", "2"])
    assert len(record["steps"]) >= 1 and np.isfinite(
        record["steps"][0]["loss"])
    from udp_pose_tpu_torch.models import build_model
    rsn = build_model(rsn_cfg, device="cpu")
    rsn.load_state_dict(torch.load(
        tmp_path / "rsn" / "coco" / "rsn" / "c" / "final_state.pth"),
        strict=True)
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    made = []
    augment = dp.DeviceAugment.__call__

    def spy(self, batch, draws):
        made.append(tuple(batch["canvas"].shape))
        return augment(self, batch, draws)

    dp.DeviceAugment.__call__ = spy
    try:
        record = train_cli.main(["--cfg", str(path), "--device", "cpu",
                                 "DATASET.DEVICE_AUG", "True",
                                 "DATASET.DEVICE_AUG_CANVAS", "[320, 240]"])
    finally:
        dp.DeviceAugment.__call__ = augment
    assert len(record["steps"]) >= 1 and np.isfinite(
        record["steps"][0]["loss"])
    assert made[0] == (4, 240, 320, 3) and len(made) == len(record["steps"])
    cfg.MODEL.NAME = "rsn"
    cfg.DATASET.DEVICE_AUG = True
    with pytest.raises(ValueError, match="DEVICE_AUG"):
        train_cli.run(cfg, None, None, None, str(tmp_path), "cpu")
    cfg.DATASET.DATASET = "crowdpose"
    with pytest.raises(KeyError, match="coco"):
        build_dataset(cfg)
    # RSN's datasets are ported: ``rsn`` gets RSN's COCO dataset
    from udp_pose_tpu_torch.data.rsn import RSNCOCODataset
    cfg = _data_cfg(default_config, coco_root)
    cfg.MODEL.NAME = "rsn"
    assert type(build_dataset(cfg)) is RSNCOCODataset
