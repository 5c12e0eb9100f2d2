"""The port's data parallelism against the JAX package, on the CPU.

Multi-rank cases run in spawned gloo ranks (``torch_ranks``: a
``file://`` rendezvous in the test's directory, one thread a rank).  The
rendezvous from torchrun's and the JAX CLIs' variables; the global-batch
BatchNorm on 2 ranks against flax's ``nn.BatchNorm`` on the whole batch;
one step of the reduced HRNet on 2 ranks against the JAX train step on
the concatenated batch; ``train.run`` on 2 ranks against one process at
the same global batch (float and QAT), and a preemption flagged on one
rank; RSN's iteration schedule for ``n_dev`` devices.
"""

import copy
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from ref_harness import make_mini_coco
from test_torch_hrnet import bridged_pair, reduced_cfg
from test_torch_train import _train_batch
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.core import loss as jax_loss
from udp_pose_tpu.core import train as jax_train
from udp_pose_tpu_torch import train as train_cli
from udp_pose_tpu_torch.config import default_config
from udp_pose_tpu_torch.parallel import (data_axis_size, initialize,
                                         make_mesh, rendezvous_from_env)
from udp_pose_tpu_torch.utils.convert import (state_dict_to_torch,
                                              variables_to_state_dict)


# ------------------------------------------------------------ rendezvous
TORCHRUN = {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
            "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.2",
            "MASTER_PORT": "29500"}
JAX_CLI = {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
           "JAX_COORDINATOR": "host0:12321"}


@pytest.mark.parametrize("env,want", [
    (TORCHRUN, (3, 8, 1, 4, "tcp://10.0.0.2:29500")),
    (JAX_CLI, (1, 2, 0, 1, "tcp://host0:12321")),
    ({"JAX_NUM_PROCESSES": "1"}, None),
    ({}, None),
])
def test_rendezvous_from_torchrun_and_jax_variables(env, want):
    got = rendezvous_from_env(env)
    assert (got if got is None else tuple(got)) == want


def test_rendezvous_refuses_what_it_cannot_run(monkeypatch):
    """No silent single process: ``JAX_MULTIHOST`` alone, a torchrun
    environment without a port, ``cuda`` without a card, and more local
    ranks than visible cards all raise; so do an empty mesh, a
    ``TPU.MESH.DATA`` that is not the world size and a model axis."""
    with pytest.raises(RuntimeError, match="JAX_MULTIHOST"):
        rendezvous_from_env({"JAX_MULTIHOST": "1"})
    no_port = {k: v for k, v in TORCHRUN.items() if k != "MASTER_PORT"}
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        initialize("cpu", no_port)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize("cuda", TORCHRUN)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="4 ranks on this host but 2"):
        initialize("cuda", TORCHRUN)
    assert make_mesh(["cpu"]).size == 1 and make_mesh(["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh([])
    # without a group the data axis is 1: TPU.MESH.DATA -1 or 1, and the
    # model axis is refused
    cfg = default_config()
    assert data_axis_size(cfg) == 1
    cfg.TPU.MESH.DATA = 2
    with pytest.raises(ValueError, match="1 rank"):
        data_axis_size(cfg)
    cfg.TPU.MESH.DATA, cfg.TPU.MESH.MODEL = -1, 2
    with pytest.raises(NotImplementedError, match="TPU.PP"):
        data_axis_size(cfg)


# ------------------------------------------------- BN and one train step
@pytest.fixture(scope="module")
def two_rank_step(tmp_path_factory):
    """2 ranks: the global BatchNorm on halves of one float64 batch, and
    one float64 SGD step of the reduced HRNet from the bridged weights on
    halves of a B=4 batch.  Returns the inputs and each rank's results."""
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(3)
    bn = {"x": rng.normal(size=(4, 6, 5, 3)) * 2.0 + 0.7,
          "dy": rng.normal(size=(4, 6, 5, 3)),
          "weight": rng.normal(size=6), "bias": rng.normal(size=6)}
    jmodel, variables, _, cfg = bridged_pair()
    cfg.TRAIN.OPTIMIZER, cfg.TRAIN.LR = "sgd", 0.1
    batch = {k: v.astype(np.float64)
             for k, v in _train_batch(cfg, B=4).items()}
    sd = {k: v.double() for k, v in state_dict_to_torch(
        variables_to_state_dict(variables, cfg)).items()}
    bn_ranks = torch_ranks.Ranks(torch_ranks.batchnorm_halves, 2, tmp,
                                 bn["x"], bn["dy"], bn["weight"], bn["bias"])
    step_ranks = torch_ranks.Ranks(torch_ranks.hrnet_step, 2, tmp, cfg, sd,
                                   batch)
    return {"bn": bn, "bn_ranks": bn_ranks.results(), "jmodel": jmodel,
            "variables": variables, "cfg": cfg, "batch": batch, "sd": sd,
            "step_ranks": step_ranks.results()}


def test_global_batchnorm_on_two_ranks_equals_flax(two_rank_step):
    """float64: the output, the running stats (flax's biased variance)
    and the gradients of the input, scale and bias to 1e-12 of each
    array's max against flax ``nn.BatchNorm`` in train mode on the whole
    batch; the scale and bias gradients are the sum of the ranks' (DDP
    averages the ranks' sums of a loss that is a mean)."""
    bn, ranks = two_rank_step["bn"], two_rank_step["bn_ranks"]
    with jax.enable_x64(True):
        x = jnp.asarray(bn["x"].transpose(0, 2, 3, 1))
        dy = jnp.asarray(bn["dy"].transpose(0, 2, 3, 1))
        layer = nn.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5, dtype=jnp.float64,
                             param_dtype=jnp.float64)
        params = {"scale": jnp.asarray(bn["weight"]),
                  "bias": jnp.asarray(bn["bias"])}
        # torch's initial running stats, in float64 (flax makes them
        # float32, where its 0.9 x var rounds)
        stats = {"mean": jnp.zeros(6, jnp.float64),
                 "var": jnp.ones(6, jnp.float64)}

        def f(x, params):
            out, mut = layer.apply(
                {"params": params, "batch_stats": stats}, x,
                mutable=["batch_stats"])
            return (out * dy).sum(), (out, mut["batch_stats"])

        (_, (out, stats)), (dx, dparams) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(x, params)
        want = {"out": np.asarray(out).transpose(0, 3, 1, 2),
                "dx": np.asarray(dx).transpose(0, 3, 1, 2),
                "dweight": np.asarray(dparams["scale"]),
                "dbias": np.asarray(dparams["bias"]),
                "running_mean": np.asarray(stats["mean"]),
                "running_var": np.asarray(stats["var"])}
    got = {"out": np.concatenate([r[0] for r in ranks]),
           "dx": np.concatenate([r[1] for r in ranks]),
           "dweight": ranks[0][2] + ranks[1][2],
           "dbias": ranks[0][3] + ranks[1][3],
           "running_mean": ranks[0][4], "running_var": ranks[0][5]}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-12 * np.abs(w).max(), err_msg=k)
    for i in (4, 5):
        np.testing.assert_array_equal(ranks[0][i], ranks[1][i])


def test_hrnet_step_on_two_ranks_equals_jax_step_on_the_whole_batch(
        two_rank_step):
    """One SGD step of the reduced HRNet, float64 weights and activations
    (the loss is float32 in both packages' steps), on 2 ranks of B=2
    against the JAX package's train step on the B=4 batch: the global
    loss to rtol 1e-6, each weight tensor's update to 1e-5 of its
    largest, each running stat to 1e-10 of its max, both ranks equal."""
    t = two_rank_step
    cfg, batch, sd = t["cfg"], t["batch"], t["sd"]
    jcfg = reduced_cfg(jax_default_config)
    jcfg.TRAIN.OPTIMIZER, jcfg.TRAIN.LR = "sgd", 0.1
    with jax.enable_x64(True):
        jmodel = t["jmodel"].clone(dtype=jnp.float64)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   t["variables"])
        state = jax_train.TrainState.create(
            jmodel.apply, v["params"], v["batch_stats"],
            jax_train.make_optimizer(jcfg, 10))
        state, metrics = jax_train.make_train_step(
            jax_loss.make_loss_fn(jcfg))(state, {
                k: jnp.asarray(a) for k, a in batch.items()})
        want = variables_to_state_dict(jax.tree_util.tree_map(
            np.asarray, {"params": state.params,
                         "batch_stats": state.batch_stats}), cfg)
        jloss = float(metrics["loss"])
    (loss0, got), (loss1, got1) = t["step_ranks"]
    assert loss0 == loss1
    np.testing.assert_allclose(loss0, jloss, rtol=1e-6)
    checked = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):      # no flax counterpart
            continue
        before = sd[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-10 * np.abs(w).max()
            np.testing.assert_allclose(got[k], w, rtol=0, atol=tol,
                                       err_msg=k)
        else:
            step = w - before
            np.testing.assert_allclose(got[k] - before, step, rtol=0,
                                       atol=1e-5 * np.abs(step).max(),
                                       err_msg=k)
        np.testing.assert_array_equal(got[k], got1[k], err_msg=k)
        checked += 1
    assert checked > 150


# ------------------------------------------------------------- train.run
@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """12 training records (3 global batches of 4) and 10 val crops."""
    root = tmp_path_factory.mktemp("coco")
    make_mini_coco(str(root), image_set="train2017", n_images=7, seed=21)
    make_mini_coco(str(root), image_set="val2017", n_images=4, seed=22,
                   all_visible=True)
    return str(root)


def data_cfg(root, per_rank):
    """The reduced HRNet on the mini-COCO at ``per_rank`` rows a rank:
    SGD (a step's change is proportional to its gradient, which keeps the
    comparison of two runs' weights sensitive), WORKERS 1 (the loader
    seeded per record, so the shards of a global batch build the records
    one process builds), one epoch."""
    cfg = reduced_cfg(default_config)
    cfg.DATASET.DATASET, cfg.DATASET.ROOT = "coco", root
    cfg.DATASET.TRAIN_SET, cfg.DATASET.TEST_SET = "train2017", "val2017"
    cfg.DATASET.COLOR_RGB = True
    cfg.TEST.USE_GT_BBOX = True
    cfg.TEST.BATCH_SIZE_PER_GPU = 4
    cfg.TRAIN.BATCH_SIZE_PER_GPU = per_rank
    cfg.TRAIN.END_EPOCH = 1
    cfg.TRAIN.OPTIMIZER, cfg.TRAIN.LR = "sgd", 0.01
    cfg.WORKERS = 1
    cfg.PRINT_FREQ = 1
    return cfg


RUN_FILES = ["checkpoint.pth", "final_state.pth",
             "results/keypoints_val2017_results_0.json"]


@pytest.mark.parametrize("mode,per_rank,tol", [
    # 3 steps with float64 weights and activations
    ("float", 2, 1e-6),
    # QAT's fake-quantised convs compute in float32: one step of 6 rows
    # a rank, the dynamic activation amax the global batch's
    ("qat", 6, 1e-4),
    # rank 1's guard flagged at its first poll: both ranks stop there
    ("preempted", 2, None),
])
def test_train_run_on_two_ranks_ends_where_one_process_ends(
        coco_root, tmp_path, mode, per_rank, tol):
    """``train.run`` on 2 gloo ranks against one process with no group
    at the same global batch: the same steps and losses, each weight
    tensor within ``tol`` of its change over the run, the same AP; every
    rank's weights and running stats equal; files written by rank 0
    only.  A preemption flagged on one rank stops both ranks after the
    same step, with the mid-epoch checkpoint written by rank 0 alone."""
    cfg = data_cfg(coco_root, per_rank)
    if mode == "qat":
        cfg.TPU.QAT = "int8"
    ranks = torch_ranks.Ranks(torch_ranks.train_run, 2, tmp_path, cfg,
                              1 if mode == "preempted" else 0)
    if mode != "preempted":
        alone_cfg = copy.deepcopy(cfg)
        alone_cfg.TRAIN.BATCH_SIZE_PER_GPU = 2 * per_rank
        alone = torch_ranks.Ranks(torch_ranks.train_run, 1, tmp_path,
                                  alone_cfg, group=False)
    (rec0, _, sd0, files0), (rec1, _, sd1, files1) = ranks.results()
    assert files1 == []
    for k in sd0:
        np.testing.assert_array_equal(sd0[k], sd1[k], err_msg=k)
    if mode == "preempted":
        assert rec0["preempted"] and rec1["preempted"]
        assert len(rec0["steps"]) == len(rec1["steps"]) == 1
        assert files0 == ["checkpoint.pth"]
        saved = torch.load(os.path.join(tmp_path, "rank0", files0[0]),
                           weights_only=False)
        assert (saved["epoch"], saved["step_in_epoch"]) == (-1, 1)
        return
    rec, init, sd, files = alone.results()[0]
    assert files0 == files == RUN_FILES
    steps = 12 // (2 * per_rank)
    assert [s["iteration"] for s in rec0["steps"]] == list(range(steps))
    np.testing.assert_allclose([s["loss"] for s in rec0["steps"]],
                               [s["loss"] for s in rec["steps"]], rtol=1e-6)
    worst = {}
    for k, w in sd.items():
        if not np.issubdtype(w.dtype, np.floating):
            continue
        change = np.abs(w - init[k]).max()
        worst[k] = float(np.abs(sd0[k] - w).max() / max(change, 1e-300))
    name = max(worst, key=worst.get)
    assert worst[name] <= tol, (name, worst[name])
    assert rec0["best_perf"] == pytest.approx(rec["best_perf"], abs=1e-9)
    assert rec0["name_values"] == pytest.approx(rec["name_values"], abs=1e-9)


# ------------------------------------------------------------ RSN schedule
@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_rsn_schedule_follows_the_jax_cli_for_n_devices(n_dev):
    """``tools/train.py:157-172``: iterations and checkpoint period scaled
    by ITER_BASELINE_DEVICES / n_dev, the LR by n_dev; epoch mode keeps
    the LR."""
    cfg = default_config()
    cfg.MODEL.NAME = "rsn"
    cfg.TRAIN.MAX_ITER, cfg.TRAIN.CHECKPOINT_PERIOD = 9600, 1000
    cfg.TRAIN.LR, cfg.TRAIN.WARMUP_ITERS = 5e-4, 1500
    scale = cfg.TRAIN.ITER_BASELINE_DEVICES / n_dev
    want = (max(int(cfg.TRAIN.MAX_ITER * scale), 2),
            max(int(cfg.TRAIN.CHECKPOINT_PERIOD * scale), 1),
            cfg.TRAIN.LR * n_dev, cfg.TRAIN.WARMUP_ITERS)
    assert tuple(train_cli.rsn_schedule(cfg, 50, n_dev)) == want
    cfg.TRAIN.MAX_ITER = 0
    assert tuple(train_cli.rsn_schedule(cfg, 50, n_dev)) == (
        50 * cfg.TRAIN.END_EPOCH, 0, cfg.TRAIN.LR, 50)
