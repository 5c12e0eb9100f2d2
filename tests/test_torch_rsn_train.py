"""The port's RSN training and evaluation against the JAX package, on
the CPU: the warmup-linear-decay schedule and RSN's Adam against optax,
one train step of a reduced two-stage RSN against the JAX function run
in float64, iteration mode through ``train.main`` (the scaled count,
the checkpoints, the batch plan across epochs, the validation), the
flip-test validation against the JAX ``validate``, and QAT.

The nets and data are those of ``test_torch_rsn``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from test_torch_quantize import _nchw
from test_torch_rsn import (HM, _x, bridged_rsn, data_cfg,
                            rsn_data)  # noqa: F401 (fixture)
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.core import loss as jax_loss
from udp_pose_tpu.core import rsn as jax_rsn
from udp_pose_tpu.core.validate import validate as jax_validate
from udp_pose_tpu.data import build_dataset as jax_build_dataset
from udp_pose_tpu.data import base as jax_base
from udp_pose_tpu.models import quantize as jq
from udp_pose_tpu_torch import train as train_cli
from udp_pose_tpu_torch.config import default_config, load_config
from udp_pose_tpu_torch.core import rsn
from udp_pose_tpu_torch.core.validate import validate
from udp_pose_tpu_torch.data import base
from udp_pose_tpu_torch.data import build_dataset
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.models import quantize as tq
from udp_pose_tpu_torch.ops.targets import rsn_targets_np
from udp_pose_tpu_torch.utils.convert import variables_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("warmup,max_iters", [(4, 12), (1, 3)])
def test_schedule_and_adam_equal_optax(warmup, max_iters):
    """``warmup_linear_decay`` at steps 0 … max_iters + 3 (across the
    warmup's end and past the last iteration) is the JAX schedule, and
    ``make_rsn_optimizer`` (Adam with L2 weight decay, the LR a
    ``LambdaLR``) runs at it and moves parameters as optax's
    ``chain(add_decayed_weights, adam(sched))`` does, to 1e-6."""
    base_lr, wd = 1e-2, 1e-3
    want = jax_rsn.warmup_linear_decay(base_lr, warmup, max_iters)
    got = rsn.warmup_linear_decay(base_lr, warmup, max_iters)
    steps = range(max_iters + 4)
    lrs = [got(s) for s in steps]
    np.testing.assert_allclose(lrs, [float(want(s)) for s in steps],
                               rtol=1e-6, atol=1e-12)
    assert lrs[0] == pytest.approx(0.1 * base_lr)
    assert lrs[warmup] == pytest.approx(base_lr)
    assert lrs[max_iters:] == [0.0] * 4

    rng = np.random.default_rng(4)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jax_rsn.make_rsn_optimizer(base_lr, wd, max_iters, warmup)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt, sched = rsn.make_rsn_optimizer(params.values(), base_lr, wd,
                                        max_iters, warmup)
    for step in steps:
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(want(step)), rel=1e-6, abs=1e-12), step
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in init.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} step {step}")


def test_rsn_schedule_of_the_yamls():
    """Iteration mode on one card scales the 8-device recipe by 8; epoch
    mode trains ``steps_per_epoch · END_EPOCH`` steps."""
    cfg = load_config(os.path.join(REPO, "configs/coco/4xrsn18_256x192.yaml"))
    assert train_cli.rsn_schedule(cfg, 100) == (768000, 19200, 5e-4, 2400)
    cfg = load_config(os.path.join(REPO, "configs/coco/rsn18_256x192.yaml"))
    assert cfg.TRAIN.MAX_ITER == 0
    assert train_cli.rsn_schedule(cfg, 100) == (
        100 * cfg.TRAIN.END_EPOCH, 0, 5e-4, 100)


def rsn_batch(cfg, B=2, seed=5):
    """Seeded normalised images, five-kernel labels and visibility."""
    rng = np.random.default_rng(seed)
    w, h = cfg.MODEL.IMAGE_SIZE
    labels, valids = [], []
    for _ in range(B):
        joints = np.concatenate([rng.uniform(0, w - 1, (17, 1)),
                                 rng.uniform(0, h - 1, (17, 1))], 1)
        valid = rng.choice([0.0, 1.0, 2.0], (17, 1), p=[0.2, 0.3, 0.5])
        labels.append(rsn_targets_np(joints, valid, cfg.MODEL.HEATMAP_SIZE,
                                     cfg.MODEL.IMAGE_SIZE))
        valids.append(valid.astype(np.float32))
    return {"image": _x(seed, B), "labels": np.stack(labels),
            "valid": np.stack(valids)}


def test_one_step_equals_jax_float64():
    """One train step of a reduced two-stage RSN (OHKM, coarse to fine)
    against the JAX package's loss of the same weights and batch,
    differentiated in float64 (the scheme of ``test_torch_train``): the
    port's step in float64 gives the loss to rtol 1e-5 and every
    gradient to 1e-4 × its tensor's max |g|; a conv bias that feeds a
    train-mode BatchNorm has no gradient (the BN takes the mean out), so
    its values in both are rounding noise, held to 1e-6 × its conv
    weight's max |g|.  The float32 step gives the loss to rtol 1e-5.
    (The float32 gradients of this seeded two-stage net at B=2 lie up to
    a fifth of a tensor's max from float64, in either package: each
    stage of a random multi-stage RSN multiplies rounding differences,
    and the layer4 BatchNorms see 8 values a channel.)"""
    jmodel, v, model, cfg = bridged_rsn(seed=3, STAGE_NUM=2)
    batch = rsn_batch(cfg)

    with jax.enable_x64(True):
        jm64 = jmodel.clone(dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

        def loss_of(params):
            out, _ = jm64.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(batch["image"], jnp.float64), train=True,
                mutable=["batch_stats"])
            outputs = [[o.transpose(0, 3, 1, 2) for o in s] for s in out]
            return jax_loss.rsn_multi_stage_loss(
                outputs, jnp.asarray(batch["valid"], jnp.float64),
                jnp.asarray(batch["labels"], jnp.float64), 2)

        jl, grads = jax.jit(jax.value_and_grad(loss_of))(v64["params"])
        jl = float(jl)
        grads = jax.tree_util.tree_map(np.asarray, grads)
    want = variables_to_state_dict(
        {"params": grads, "batch_stats": v["batch_stats"]}, cfg)

    for dtype in (torch.float64, torch.float32):
        train_model = build_model(cfg, device="cpu", train=True)
        train_model.load_state_dict(model.state_dict(), strict=True)
        train_model = train_model.to(dtype)
        state = rsn.create_rsn_train_state(cfg, train_model, 1e-3, 10, 2)
        metrics = rsn.make_rsn_train_step(2)(state, {
            k: torch.from_numpy(a).to(dtype) for k, a in batch.items()})
        assert metrics["loss"].dtype == dtype
        np.testing.assert_allclose(float(metrics["loss"]), jl, rtol=1e-5)
        assert state.step == 1
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
            1e-3 * (0.1 + 0.9 / 2))
    named = {k: p.grad for k, p in train_model.named_parameters()}
    assert len(named) > 200 and set(named) <= set(want)
    train_model = build_model(cfg, device="cpu", train=True).double()
    train_model.load_state_dict(model.state_dict(), strict=True)
    state = rsn.create_rsn_train_state(cfg, train_model, 1e-3, 10, 2)
    rsn.make_rsn_train_step(2)(state, {
        k: torch.from_numpy(a).double() for k, a in batch.items()})
    got = {k: p.grad.numpy() for k, p in train_model.named_parameters()}
    for k, g in got.items():
        assert want[k].dtype == g.dtype == np.float64
        if k.endswith("conv.bias"):
            scale = 1e-6 * float(np.abs(want[k[:-4] + "weight"]).max())
            assert np.abs(g).max() <= scale and np.abs(want[k]).max() <= scale
            continue
        np.testing.assert_allclose(g, want[k], rtol=0,
                                   atol=1e-4 * float(np.abs(want[k]).max()),
                                   err_msg=k)


def test_iteration_mode_through_main(rsn_data, tmp_path, monkeypatch):
    """``train.main`` of an RSN with ``TRAIN.MAX_ITER 2`` on the CPU: 16
    iterations (×8 on one card), checkpoints after iterations 7 and 15
    with ``iter-last.pth`` on the last, each loading; the LR of every
    step the schedule's; the batches those of the JAX package's
    ``epoch_batch_indices`` plans, epoch after epoch; one validation;
    ``final_state.pth`` loading ``strict=True``."""
    cfg = data_cfg(default_config, rsn_data, "coco")
    cfg.TRAIN.BATCH_SIZE_PER_GPU = cfg.TEST.BATCH_SIZE_PER_GPU = 4
    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.WARMUP_ITERS = 3
    cfg.TRAIN.SHUFFLE = True
    cfg.WORKERS = 0        # this process has JAX loaded: no forked workers
    cfg.PRINT_FREQ = 5
    cfg.OUTPUT_DIR = str(tmp_path / "output")
    cfg.LOG_DIR = str(tmp_path / "log")
    path = tmp_path / "rsn_reduced.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))

    plans = {}
    plan_of = base.epoch_batch_indices

    def spy(dataset, batch_size, shuffle=True, seed=0, **kw):
        plan = plan_of(dataset, batch_size, shuffle=shuffle, seed=seed, **kw)
        if dataset.is_train:
            plans[seed] = plan
        return plan

    monkeypatch.setattr(base, "epoch_batch_indices", spy)
    record = train_cli.main(["--cfg", str(path), "--device", "cpu",
                             "TRAIN.MAX_ITER", "2",
                             "TRAIN.CHECKPOINT_PERIOD", "1"])
    steps = record["steps"]
    assert [s["iteration"] for s in steps] == list(range(16))
    assert all(np.isfinite(s["loss"]) for s in steps)
    sched = rsn.warmup_linear_decay(1e-3, 3, 16)
    np.testing.assert_allclose([s["lr"] for s in steps],
                               [sched(i) for i in range(16)], rtol=1e-12)

    # the batches: the JAX plans of epochs 0, 1, ... in turn
    jds = jax_build_dataset(data_cfg(jax_default_config, rsn_data, "coco"),
                            is_train=True)
    want = [chunk for p in range(max(plans) + 1) for chunk in
            jax_base.epoch_batch_indices(jds, 4, shuffle=True, seed=p)]
    got = [plans[s["epoch"]][s["step"]] for s in steps]
    assert max(plans) >= 2 and steps[-1]["epoch"] >= 2
    assert len(want) >= 16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    run_dir = tmp_path / "output" / "coco" / "rsn" / "rsn_reduced"
    assert os.readlink(run_dir / "iter-last.pth") == "iter-15.pth"
    assert [os.path.basename(p) for p in record["checkpoints"]] == [
        "iter-7.pth", "iter-15.pth", "iter-15.pth"]
    for it in (7, 15):
        ckpt = torch.load(run_dir / f"iter-{it}.pth")
        assert (ckpt["iteration"], ckpt["step"]) == (it, it + 1)
        net = build_model(cfg, device="cpu", train=True)
        net.load_state_dict(ckpt["state_dict"], strict=True)
        opt, lr_sched = rsn.make_rsn_optimizer(net.parameters(), 1e-3,
                                               cfg.TRAIN.WD, 16, 3)
        opt.load_state_dict(ckpt["optimizer"])
        lr_sched.load_state_dict(ckpt["scheduler"])
        assert lr_sched.last_epoch == it + 1
    last = torch.load(run_dir / "iter-last.pth")
    final = torch.load(run_dir / "final_state.pth")
    assert all(torch.equal(final[k], last["state_dict"][k]) for k in final)
    build_model(cfg, device="cpu").load_state_dict(final, strict=True)
    assert len(record["validations"]) == 1
    assert "AP" in record["name_values"]
    assert (run_dir / "results" / "keypoints_val2017_results_0.json").exists()


def test_epoch_mode_through_main(rsn_data, tmp_path):
    """An RSN without ``TRAIN.MAX_ITER`` trains in epoch mode: one epoch
    of ``len // B`` steps whose LR is ``warmup_linear_decay`` with
    ``max_iters = steps_per_epoch · END_EPOCH`` and a warmup of
    min(1000, steps_per_epoch) (here both end at the epoch's end), one
    validation, ``model_best.pth`` only if the AP rose, and
    ``final_state.pth``."""
    cfg = data_cfg(default_config, rsn_data, "coco")
    cfg.TRAIN.BATCH_SIZE_PER_GPU = cfg.TEST.BATCH_SIZE_PER_GPU = 4
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.LR = 1e-3
    cfg.WORKERS = 0
    cfg.OUTPUT_DIR = str(tmp_path / "output")
    cfg.LOG_DIR = str(tmp_path / "log")
    path = tmp_path / "rsn_epoch.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    record = train_cli.main(["--cfg", str(path), "--device", "cpu"])
    spe = len(build_dataset(cfg, is_train=True)) // 4
    steps = record["steps"]
    assert len(steps) == spe > 1 and all(np.isfinite(s["loss"])
                                         for s in steps)
    sched = rsn.warmup_linear_decay(1e-3, min(1000, spe), spe)
    np.testing.assert_allclose([s["lr"] for s in steps],
                               [sched(i) for i in range(spe)], rtol=1e-12)
    assert sched(spe) == 0.0 and len(record["validations"]) == 1
    run_dir = tmp_path / "output" / "coco" / "rsn" / "rsn_epoch"
    assert (run_dir / "final_state.pth").exists()
    assert (run_dir / "model_best.pth").exists() == (record["best_perf"] > 0)
    assert not list(run_dir.glob("iter-*.pth"))


def test_validate_equals_jax(rsn_data, tmp_path):
    """RSN's flip-test validation of the same weights on the mini-COCO
    (its detection-free gt boxes, RSN's box extension, the decode with
    k = 5): preds within 1e-3 px, maxvals within 1e-5, the AP table
    within 1e-6."""
    jmodel, v, model, _ = bridged_rsn(seed=4)
    ours = build_dataset(data_cfg(default_config, rsn_data, "coco"))
    theirs = jax_build_dataset(data_cfg(jax_default_config, rsn_data,
                                        "coco"))
    seen = {}
    for name, ds in (("ours", ours), ("theirs", theirs)):
        evaluate = ds.evaluate

        def spy(cfg, preds, *args, name=name, evaluate=evaluate, **kw):
            seen[name] = np.array(preds)
            return evaluate(cfg, preds, *args, **kw)

        ds.evaluate = spy
    nv, perf = validate(ours.cfg, ours, model.eval(), str(tmp_path / "a"),
                        batch_size=4)
    jnv, jperf = jax_validate(theirs.cfg, theirs, jmodel, v,
                              str(tmp_path / "b"), batch_size=4)
    got, want = seen["ours"], seen["theirs"]
    assert got.shape == (len(ours), 17, 3)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5)
    assert nv == pytest.approx(jnv, abs=1e-6)
    assert perf == pytest.approx(jperf, abs=1e-6)


def test_qat_engages_the_jax_sites_and_trains():
    """``TPU.QAT int8``: the RSN's fake-quantised sites are the JAX
    package's (``*res_conv2*`` in float), and one QAT train step moves
    every parameter."""
    jmodel, v, model, cfg = bridged_rsn(seed=5)
    jfq = jq.FakeQuantModel(jmodel)
    jax.eval_shape(lambda v, x: jfq.apply(v, x, train=False), v,
                   jnp.zeros((1,) + _x(0).shape[1:]))
    assert tq.FakeQuantModel(model).engaged == jfq.engaged
    assert not any("res_conv2" in p for p in jfq.engaged)
    cfg = cfg.clone()
    cfg.TPU.QAT = "int8"
    train_model = build_model(cfg, device="cpu", train=True)
    train_model.load_state_dict(model.state_dict(), strict=True)
    state = rsn.create_rsn_train_state(cfg, train_model, 1e-3, 10, 2)
    assert isinstance(state.model, tq.FakeQuantModel)
    before = {k: p.detach().clone()
              for k, p in train_model.named_parameters()}
    batch = rsn_batch(cfg, seed=6)
    metrics = rsn.make_rsn_train_step(1)(state, {
        k: torch.from_numpy(a) for k, a in batch.items()})
    assert np.isfinite(float(metrics["loss"]))
    moved = {k for k, p in train_model.named_parameters()
             if not torch.equal(p, before[k])}
    assert moved == set(before)
    with torch.no_grad():
        out = state.model.eval()(_nchw(batch["image"]))
    assert out.shape == (2, 17) + HM and torch.isfinite(out).all()
