"""The port's GPipe pipeline (``udp_pose_tpu_torch/parallel/pipeline.py``,
``TPU.PP``) against the JAX package, on the CPU.

A reduced two-stage RSN (``test_torch_rsn.bridged_rsn``: LAYERS
[1,1,1,1], 32 upsample channels, 64×48 input) with two microbatches, its
stages on ``["cpu", "cpu"]``:

* the pipelined eval forward against the JAX ``RSN.apply(all_stages=
  True)`` of the same weights;
* one float64 pipelined train step (with and without ``TPU.REMAT``)
  against a JAX reference built from ``stem_from_cfg`` and
  ``uniform_stage_from_cfg`` with the JAX pipeline's semantics (the stem
  on the whole batch, each stage's BatchNorm per microbatch and data
  shard, the running stats updated microbatch after microbatch and
  averaged over the data axis), as ``tests/test_pipeline_parallel.py``
  builds it: loss, every gradient, the new running stats;
* the same at a data axis of 2 over two gloo ranks
  (``torch_ranks.pipelined_step``), each rank on its rows of every
  microbatch, the stem's statistics those of the global batch;
* the loader's rows for a pipelined data axis; the per-device state of
  4×RSN-50 (on the ``meta`` device); ``train.run`` pipelined in
  iteration and epoch mode (artifacts load into the plain RSN,
  ``AUTO_RESUME`` bit-equal on both checkpoint backends); the refusals;
  the JAX pipelined ``.msgpack`` layout loading into the port.

No test compiles the JAX ``make_pipeline_forward``: the JAX references
are built once per module from the stage modules.
"""

import copy
import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_checkpoint import (StopAfter, _assert_same_run_state,
                                   _coco_cfg, coco_root)  # noqa: F401
from test_torch_quantize import _nchw
from test_torch_rsn import _x, bridged_rsn, rsn_cfg
from test_torch_rsn_train import rsn_batch
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from torch_ranks import Ranks, pipelined_step
from udp_pose_tpu.config import default_config as jax_default_config
from udp_pose_tpu.core import loss as jax_loss
from udp_pose_tpu.models.rsn import stem_from_cfg, uniform_stage_from_cfg
from udp_pose_tpu.parallel import pipeline as jax_pp
from udp_pose_tpu.utils import checkpoint as jax_checkpoint
from udp_pose_tpu_torch import train as train_cli
from udp_pose_tpu_torch.config import default_config, load_config
from udp_pose_tpu_torch.core import rsn
from udp_pose_tpu_torch.data import base, build_dataset
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.models.rsn import rsn_from_cfg
from udp_pose_tpu_torch.parallel import pipeline as pp
from udp_pose_tpu_torch.utils import checkpoint as ckpt
from udp_pose_tpu_torch.utils.convert import (read_weights,
                                              state_dict_to_torch,
                                              variables_to_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 2                    # stages == model devices
N_MICRO = 2
DEVICES = ["cpu"] * S
EVAL_TOL = 2e-5          # the JAX pipeline test's tolerance


@pytest.fixture(scope="module")
def net():
    """(jax model, numpy flax variables, port model, port cfg) of the
    reduced two-stage RSN, the cfg pipelined over 2 model devices."""
    jmodel, v, model, cfg = bridged_rsn(seed=3, STAGE_NUM=S)
    cfg.TPU.PP, cfg.TPU.MESH.MODEL = True, S
    cfg.TPU.PP_MICROBATCHES = N_MICRO
    return jmodel, v, model, cfg


@functools.lru_cache(maxsize=None)
def _template(dtype):
    """A uniform stage's variables in numpy zeros, from the shapes of its
    init (no compile): the values of the leaves the last stage lacks."""
    stage = uniform_stage_from_cfg(rsn_cfg(jax_default_config, STAGE_NUM=S))
    h, w = stage.output_shape
    x_sh, skip_sh = jax_pp._stage_io_shapes((h, w), 1, dtype)
    zs = [jnp.zeros(s.shape, dtype) for s in skip_sh]
    shapes = jax.eval_shape(lambda: stage.init(
        jax.random.PRNGKey(0), jnp.zeros(x_sh.shape, dtype), zs, zs,
        train=False))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, dtype),
                                  shapes)


class JaxStages:
    """The JAX package's stem and uniform stage of the reduced RSN in
    float64 (train mode, batch stats mutable), each as one jitted
    function of (params, batch stats, inputs, output cotangent) that
    returns the outputs, the new batch stats and the VJP, and the loss
    with its gradient: the references chain them microbatch after
    microbatch in numpy, forward (zero cotangents) then backward, so no
    graph of the whole pipeline is compiled."""

    def __init__(self):
        self.jcfg = rsn_cfg(jax_default_config, STAGE_NUM=S)
        stem = stem_from_cfg(self.jcfg).clone(dtype=jnp.float64)
        stage = uniform_stage_from_cfg(self.jcfg).clone(dtype=jnp.float64)
        self.hw = stage.output_shape

        def stem_apply(p, bs, x):
            return stem.apply({"params": p, "batch_stats": bs}, x,
                              train=True, mutable=["batch_stats"])

        def stage_apply(p, bs, x, s1, s2):
            return stage.apply({"params": p, "batch_stats": bs}, x, s1, s2,
                               train=True, mutable=["batch_stats"])

        def stem_step(p, bs, x, ct):
            out, vjp, mut = jax.vjp(lambda p: stem_apply(p, bs, x), p,
                                    has_aux=True)
            return out, mut["batch_stats"], vjp(ct)[0]

        def stage_step(p, bs, x, s1, s2, ct):
            out, vjp, mut = jax.vjp(lambda *a: stage_apply(a[0], bs, *a[1:]),
                                    p, x, s1, s2, has_aux=True)
            return out, mut["batch_stats"], vjp(ct)

        def loss(outputs, valid, labels):
            return jax_loss.rsn_multi_stage_loss(outputs, valid, labels, S)

        self.stem_step = jax.jit(stem_step)
        self.stage_step = jax.jit(stage_step)
        self.loss_grad = jax.jit(jax.value_and_grad(loss))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_split = jax.jit(jax_pp.split_rsn_variables, static_argnums=1)


def _jax_split(v, template):
    """The JAX ``split_rsn_variables`` in numpy, from one compiled graph
    (not an eager stack a leaf)."""
    return _np(_split(v, S, template))


def _add(a, b):
    return b if a is None else jax.tree_util.tree_map(np.add, a, b)


def jax_pipelined_reference(jx, cfg, v, batch, n_micro, n_data):
    """The JAX pipelined step's loss, gradients and new batch stats on the
    normalised ``batch``, in float64, as the port's state dicts: the stem
    on the whole batch, then for each microbatch ``m`` and data shard
    ``d`` (rows ``m·mb + d·mb/D`` on) the uniform stages in turn, each
    stage's batch stats threaded over its shard's microbatches and
    averaged over the shards, zero skips into the first stage and the
    last stage's skips and cross feature discarded; the loss over every
    row (the JAX pipeline's semantics, ``udp_pose_tpu/parallel/
    pipeline.py:156-235``, as ``tests/test_pipeline_parallel.py:123-190``
    builds them).  The backward runs the stages' VJPs in reverse."""
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        stem_v, stacked = _jax_split(v64, _template(np.float64))
        pst = [jax.tree_util.tree_map(lambda a: a[s], stacked["params"])
               for s in range(S)]
        x = np.asarray(batch["image"], np.float64)
        h, w = jx.hw
        x0, stem_bs, _ = _np(jx.stem_step(
            stem_v["params"], stem_v["batch_stats"], x,
            np.zeros((len(x), h, w, 64))))
        mb = x0.shape[0] // n_micro
        q = mb // n_data
        _, skip_sh = jax_pp._stage_io_shapes(jx.hw, q, x0.dtype)
        zeros = [np.zeros(k.shape, x0.dtype) for k in skip_sh]
        bs = [[jax.tree_util.tree_map(lambda a: a[s],
                                      stacked["batch_stats"])
               for _ in range(n_data)] for s in range(S)]
        calls, res = {}, {}
        # the stage's outputs (heatmaps, the two skip pyramids, cross)
        zero_ct = ([np.zeros((q, h, w, 17))] * 4, zeros, zeros,
                   np.zeros((q, h, w, 64)))
        for m in range(n_micro):
            for d in range(n_data):
                rows = slice(m * mb + d * q, m * mb + (d + 1) * q)
                args = (x0[rows], zeros, zeros)
                for s in range(S):
                    out, new_bs, _ = _np(jx.stage_step(pst[s], bs[s][d],
                                                       *args, zero_ct))
                    calls[m, d, s] = (bs[s][d], args, out)
                    bs[s][d] = new_bs
                    res[m, d, s] = out[0]
                    args = (out[3], out[1], out[2])
        # every row's outputs in the global batch's order, NCHW
        outputs = [[np.concatenate([res[m, d, s][j] for m in range(n_micro)
                                    for d in range(n_data)])
                    .transpose(0, 3, 1, 2) for j in range(4)]
                   for s in range(S)]
        loss, g_out = jx.loss_grad(outputs, batch["valid"].astype(
            np.float64), batch["labels"].astype(np.float64))
        g_out = _np(g_out)
        g_stages, g_x0 = [None] * S, np.zeros_like(x0)
        for m in range(n_micro):
            for d in range(n_data):
                rows = slice(m * mb + d * q, m * mb + (d + 1) * q)
                g_next = None           # d(cross, skip1, skip2) of stage s
                for s in reversed(range(S)):
                    bs_in, args, out = calls[m, d, s]
                    ct_res = [g_out[s][j][rows].transpose(0, 2, 3, 1)
                              for j in range(4)]
                    if g_next is None:
                        g_next = (np.zeros_like(out[3]),
                                  [np.zeros_like(k) for k in out[1]],
                                  [np.zeros_like(k) for k in out[2]])
                    ct = jax.tree_util.tree_unflatten(
                        jax.tree_util.tree_structure(out),
                        jax.tree_util.tree_leaves(
                            (ct_res, g_next[1], g_next[2], g_next[0])))
                    gp, gx, gs1, gs2 = _np(jx.stage_step(
                        pst[s], bs_in, *args, ct)[2])
                    g_stages[s] = _add(g_stages[s], gp)
                    g_next = (gx, gs1, gs2)
                g_x0[rows] = g_next[0]
        g_stem = _np(jx.stem_step(stem_v["params"], stem_v["batch_stats"],
                                  x, g_x0)[2])
        stage_bs = jax.tree_util.tree_map(
            lambda *a: np.stack(a),
            *[jax.tree_util.tree_map(lambda *r: sum(r) / n_data, *bs[s])
              for s in range(S)])
        g_stacked = jax.tree_util.tree_map(lambda *a: np.stack(a),
                                           *g_stages)
    g = jax_pp.merge_rsn_variables({"params": g_stem},
                                   {"params": g_stacked},
                                   {"params": v["params"]})
    new_bs = jax_pp.merge_rsn_variables({"batch_stats": stem_bs},
                                        {"batch_stats": stage_bs},
                                        {"batch_stats": v["batch_stats"]})
    want_g = variables_to_state_dict({"params": g["params"],
                                      "batch_stats": v["batch_stats"]}, cfg)
    want_bs = variables_to_state_dict({"params": v["params"],
                                       "batch_stats": new_bs["batch_stats"]},
                                      cfg)
    return float(loss), want_g, {k: a for k, a in want_bs.items()
                                 if k.endswith(("running_mean",
                                                "running_var"))}


@pytest.fixture(scope="module")
def references(net):
    """The JAX references, each built once: a B=4 batch at a data axis of
    1 and a B=8 batch at a data axis of 2 (both two-row shards of a
    microbatch, so the jitted stage serves both)."""
    _, v, _, cfg = net
    jx = JaxStages()
    out = {}
    for n_data, B in ((1, 4), (2, 8)):
        batch = rsn_batch(cfg, B=B, seed=11 + n_data)
        out[n_data] = (batch, jax_pipelined_reference(jx, cfg, v, batch,
                                                      N_MICRO, n_data))
    return out


def assert_step_equals(loss, grads, stats, want):
    """The tolerances of ``test_torch_rsn_train.test_one_step_equals_jax_
    float64``: the loss to rtol 1e-5, every gradient to 1e-4 × its
    tensor's max |g|, a conv bias that feeds a train-mode BatchNorm (no
    gradient in exact arithmetic) to 1e-6 × its conv weight's max |g|;
    the running stats to 1e-6 × their tensor's max (the JAX package's
    align-corners resize accumulates in float32 also in float64, which
    puts ~1e-7 of a value between them)."""
    wl, wg, wbs = want
    np.testing.assert_allclose(loss, wl, rtol=1e-5)
    assert set(grads) == set(wg) - {k for k in wg if k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    for k, g in grads.items():
        assert g.dtype == wg[k].dtype == np.float64, k
        if k.endswith("conv.bias"):
            scale = 1e-6 * float(np.abs(wg[k[:-4] + "weight"]).max())
            assert np.abs(g).max() <= scale and np.abs(wg[k]).max() <= scale
            continue
        np.testing.assert_allclose(g, wg[k], rtol=0,
                                   atol=1e-4 * float(np.abs(wg[k]).max()),
                                   err_msg=k)
    assert set(stats) == set(wbs)
    for k, a in stats.items():
        np.testing.assert_allclose(a, wbs[k], rtol=0,
                                   atol=1e-6 * float(np.abs(wbs[k]).max()),
                                   err_msg=k)


# --------------------------------------------------------------- forward
def test_pipelined_eval_forward_equals_jax(net):
    """Every stage's four heatmaps of the pipelined eval forward (stem
    once, two microbatches through two stages) against the JAX
    monolithic ``apply(all_stages=True)`` of the same weights, and bit
    for bit against the port's own monolithic forward."""
    jmodel, v, model, cfg = net
    x = _x(1, B=4)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False,
                                             all_stages=True))(v, x)
    placed = build_model(cfg, device="cpu")
    placed.load_state_dict(model.state_dict())
    pp.place_stages(placed, DEVICES)
    fwd = pp.make_pipeline_forward(cfg, DEVICES, N_MICRO)
    with torch.no_grad():
        got = fwd(placed, _nchw(x), False)
        mono = model(_nchw(x), all_stages=True)
    assert len(got) == S
    for s in range(S):
        for j in range(4):
            w = np.asarray(want[s][j]).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(got[s][j].numpy(), w, rtol=EVAL_TOL,
                                       atol=EVAL_TOL, err_msg=f"{s} {j}")
            assert torch.equal(got[s][j], mono[s][j])


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_step_equals_jax_float64(net, references, remat):
    """One float64 pipelined step (B=4, two microbatches of two rows)
    against the JAX reference: loss, gradients, running stats; with
    ``TPU.REMAT`` the same numbers (the recomputed forward leaves the
    running stats alone).  The step also moves the weights (Adam)."""
    _, _, model, cfg = net
    batch, want = references[1]
    cfg = copy.deepcopy(cfg)
    cfg.TPU.REMAT = remat
    train_model = build_model(cfg, device="cpu", train=True).double()
    train_model.load_state_dict(model.state_dict())
    assert train_model.stage0.downsample.remat is remat
    pp.place_stages(train_model, DEVICES)
    state = rsn.create_rsn_train_state(cfg, train_model, 1e-3, 10, 2)
    step = pp.make_pipelined_rsn_train_step(cfg, DEVICES, N_MICRO)
    before = {k: p.detach().clone()
              for k, p in train_model.named_parameters()}
    metrics = step(state, {k: torch.from_numpy(a).double()
                           for k, a in batch.items()})
    assert state.step == 1
    assert_step_equals(
        float(metrics["loss"]),
        {k: p.grad.numpy() for k, p in train_model.named_parameters()},
        {k: b.numpy() for k, b in train_model.state_dict().items()
         if k.endswith(("running_mean", "running_var"))}, want)
    moved = [not torch.equal(p.detach(), before[k])
             for k, p in train_model.named_parameters()]
    assert sum(moved) > 0.9 * len(moved)


def test_data_axis_two_ranks_equals_jax(net, references, tmp_path):
    """D = 2 × S = 2 over two gloo ranks: each rank its rows of both
    microbatches (``pipeline_rows``: rows 0-1 and 4-5, 2-3 and 6-7 of a
    B=8 batch), the stem's BatchNorm over the global batch, gradients
    and stage running stats averaged: every rank holds the JAX
    reference's numbers."""
    _, _, model, cfg = net
    batch, want = references[2]
    assert list(pp.pipeline_rows(8, 2, 0, 2)) == [0, 1, 4, 5]
    assert list(pp.pipeline_rows(8, 2, 1, 2)) == [2, 3, 6, 7]
    sd = {k: v.double() if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    results = Ranks(pipelined_step, 2, tmp_path, cfg, sd, batch,
                    N_MICRO).results()
    for loss, grads, stats in results:
        assert_step_equals(loss, grads, stats, want)


def test_loader_hands_each_rank_its_microbatch_rows(net, coco_root):
    """``epoch_batch_indices(n_micro=)`` over a data axis: step ``j``'s
    global batch is every shard's chunk ``j`` of the data-parallel plan,
    and each shard takes its ``pipeline_rows`` of it; the plan sizes
    are the plain plan's, which ``epoch_plan_size`` counts."""
    cfg = _coco_cfg(rsn_cfg(default_config), coco_root, "unused")
    ds = build_dataset(cfg, is_train=True)
    for D, b, n_micro in ((2, 2, 2), (2, 4, 2), (3, 2, 2)):
        plain = [base.epoch_batch_indices(ds, b, seed=4, shard_index=d,
                                          num_shards=D) for d in range(D)]
        for d in range(D):
            got = base.epoch_batch_indices(ds, b, seed=4, shard_index=d,
                                           num_shards=D, n_micro=n_micro)
            assert len(got) == len(plain[d]) == base.epoch_plan_size(
                ds, b, seed=4, shard_index=d, num_shards=D)
            for j, chunk in enumerate(got):
                glob = np.concatenate([p[j] for p in plain])
                np.testing.assert_array_equal(
                    chunk, glob[pp.pipeline_rows(b * D, n_micro, d, D)])
    with pytest.raises(ValueError, match="not divisible"):
        base.epoch_batch_indices(ds, 3, seed=4, shard_index=0,
                                 num_shards=2, n_micro=2)


def test_4xrsn50_state_per_device_is_one_over_S():
    """The 4×RSN-50 of ``configs/coco/4xrsn50_384x288.yaml`` on the
    ``meta`` device (no memory): parameters and both Adam moments (fp32)
    are over 800 MB, and each model device's share (its stage; the stem
    on device 0) is within 1/S + 0.06 of the whole, as
    ``tests/test_pipeline_parallel.py`` measures the JAX sharding."""
    cfg = load_config(os.path.join(REPO,
                                   "configs/coco/4xrsn50_384x288.yaml"))
    with torch.device("meta"):
        model = rsn_from_cfg(cfg)
    S4 = model.stage_num
    assert S4 == 4
    per = [0] * S4
    for module, s in pp.stage_modules(model):
        per[s] += 3 * sum(p.numel() * p.element_size()
                          for p in module.parameters())
    total = 3 * sum(p.numel() * p.element_size()
                    for p in model.parameters())
    assert sum(per) == total and total > 800e6, total
    assert max(per) / total < 1 / S4 + 0.06, [p / total for p in per]
    assert min(per) / total > 1 / S4 - 0.06


# ------------------------------------------------------------- train.run
def _pp_cfg(root, out, mode, backend="msgpack", **more):
    cfg = _coco_cfg(rsn_cfg(default_config, STAGE_NUM=S), root, out,
                    TPU={"PP": True, "MESH": {"MODEL": S},
                         "PP_MICROBATCHES": N_MICRO,
                         "CKPT_BACKEND": backend},
                    TRAIN={"LR": 1e-3, "WARMUP_ITERS": 2}, **more)
    if mode == "iteration":
        cfg.TRAIN.merge_from_dict({"MAX_ITER": 4, "CHECKPOINT_PERIOD": 2,
                                   "ITER_BASELINE_DEVICES": 1})
    else:
        cfg.TRAIN.END_EPOCH = 2
    return cfg


def _run(cfg, guard=None):
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    return train_cli.run(cfg, build_model(cfg, device="cpu", train=True),
                         build_dataset(cfg, is_train=True),
                         build_dataset(cfg, is_train=False),
                         cfg.OUTPUT_DIR, "cpu", guard=guard,
                         model_devices=DEVICES)


@pytest.mark.parametrize("mode,backend", [("iteration", "msgpack"),
                                          ("epoch", "orbax")])
def test_run_pipelined_resumes_bit_equal(coco_root, tmp_path, monkeypatch,
                                         caplog, mode, backend):
    """``train.run`` of the two-stage RSN pipelined over two model
    devices: uninterrupted, and stopped by the guard (SIGTERM's path)
    after step 3 then resumed with ``AUTO_RESUME``, which ends with the
    uninterrupted run's weights, Adam moments, scheduler and step bit
    for bit.  The weights (``final_state.pth``, ``model_best.pth``: the
    validation's AP is made to rise) load into the plain RSN with
    ``strict=True``; ``MODEL.PRETRAINED`` grafts onto the pipelined
    model."""
    from udp_pose_tpu_torch.core import validate as core_validate
    validate = core_validate.validate
    count = {}

    def rising(cfg, val_ds, net, out_dir, **kw):
        # the AP of a run's n-th validation: 0.1·n, in both runs alike
        nv, _ = validate(cfg, val_ds, net, out_dir, **kw)
        count[out_dir] = count.get(out_dir, 0) + 1
        return nv, 0.1 * count[out_dir]

    monkeypatch.setattr(core_validate, "validate", rising)
    seeded = tmp_path / "seeded.pth"
    ref = build_model(rsn_cfg(default_config, STAGE_NUM=S), device="cpu",
                      seed=7)
    torch.save(ref.state_dict(), seeded)

    def cfg_for(name, **more):
        return _pp_cfg(coco_root, tmp_path / name, mode, backend,
                       MODEL={"PRETRAINED": str(seeded)}, **more)

    with caplog.at_level(logging.INFO):
        whole = _run(cfg_for("a"))
    assert "pipeline-parallel over 2 stages" in caplog.text
    assert f"loaded pretrained {seeded}" in caplog.text
    n = len(whole["steps"])
    assert n >= 4
    stopped = _run(cfg_for("b"), StopAfter(3))
    assert stopped["preempted"] and len(stopped["steps"]) == 3
    resumed = _run(cfg_for("b", AUTO_RESUME=True))
    assert [s["iteration"] for s in resumed["steps"]] == list(range(3, n))
    assert [s["loss"] for s in resumed["steps"]] == [
        s["loss"] for s in whole["steps"][3:]]
    out = {k: tmp_path / k for k in "ab"}
    final = {k: torch.load(out[k] / "final_state.pth") for k in "ab"}
    for key, value in final["a"].items():
        assert torch.equal(final["b"][key], value), key
    if backend == "msgpack":
        name = "iter-last.pth" if mode == "iteration" else "checkpoint.pth"
        _assert_same_run_state(out["b"] / name, out["a"] / name)
    plain = build_model(rsn_cfg(default_config, STAGE_NUM=S), device="cpu")
    assert plain.load_state_dict(final["a"], strict=True)
    if mode == "epoch":
        assert plain.load_state_dict(torch.load(out["a"] /
                                                "model_best.pth"),
                                     strict=True)


# -------------------------------------------------------------- refusals
def test_pipeline_refusals(net, tmp_path, monkeypatch):
    """A model axis that is not ``STAGE_NUM``, a global batch that does
    not split into microbatches, ``TPU.PP`` with ``TPU.TP`` on an RSN
    (``ValueError``), ``TPU.TP`` alone on a model axis > 1
    (``NotImplementedError``), QAT with ``TPU.PP`` (``ValueError``), no
    card (``run`` and the CLI on ``cuda``), and the CLI on a host with
    fewer cards than the model axis."""
    _, _, _, cfg = net
    path = tmp_path / "c.yaml"

    def main(*opts, device="cpu", c=cfg):
        path.write_text(yaml.safe_dump(c.to_dict()))
        return train_cli.main(["--cfg", str(path), "--device", device,
                               "OUTPUT_DIR", str(tmp_path / "o"), *opts])

    with pytest.raises(ValueError, match="STAGE_NUM"):
        main("TPU.MESH.MODEL", "4")
    with pytest.raises(ValueError, match="mutually exclusive"):
        main("TPU.TP", "True")
    with pytest.raises(NotImplementedError, match="TPU.TP .*not ported"):
        main("TPU.PP", "False", "TPU.TP", "True")
    with pytest.raises(ValueError, match="TPU.QAT is not supported"):
        main("TPU.QAT", "int8")
    with pytest.raises(ValueError, match="not divisible by n_micro"):
        c = copy.deepcopy(cfg)
        c.TRAIN.BATCH_SIZE_PER_GPU = 3
        train_cli.run(c, build_model(c, device="cpu", train=True), None,
                      None, str(tmp_path), "cpu", model_devices=DEVICES)
    with pytest.raises(ValueError, match="one device a stage"):
        pp.place_stages(build_model(cfg, device="cpu"), ["cpu"] * 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.run(cfg, None, None, None, str(tmp_path), "cuda",
                      model_devices=DEVICES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match=r"cuda:0\.\.cuda:1 but this "
                                           r"host has 1 card"):
        main(device="cuda")


# ------------------------------------------------------- weight bridge
def test_jax_pipelined_msgpack_loads_into_the_port(net, tmp_path):
    """The JAX pipelined layout (``{'stem', 'stages'}``, the last stage
    padded from a template) as a weight file and as the JAX trainer's
    iteration checkpoint: ``read_weights`` unstacks it as the JAX
    ``merge_rsn_variables`` does and loads into the plain RSN with
    ``strict=True``, equal to the weights it came from; the port's
    ``merge_rsn_variables`` equals the JAX one."""
    import optax
    from udp_pose_tpu.core.train import TrainState
    _, v, model, cfg = net
    template = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, 0.5, a.dtype),
        _template(np.float32))
    stem, stacked = _jax_split(v, template)
    want = jax_pp.merge_rsn_variables(stem, stacked, v)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           pp.merge_rsn_variables(stem, stacked),
                           jax.tree_util.tree_map(np.asarray, want))
    state = TrainState.create(
        None, {"stem": stem["params"], "stages": stacked["params"]},
        {"stem": stem["batch_stats"], "stages": stacked["batch_stats"]},
        optax.identity())
    weights = tmp_path / "pipelined.msgpack"
    jax_checkpoint.save_weights(weights, state)
    it = jax_checkpoint.save_iter_checkpoint(str(tmp_path), state, 3)
    sd = model.state_dict()
    for path in (weights, it):
        got = read_weights(str(path), cfg)
        plain = build_model(cfg, device="cpu")
        plain.load_state_dict(state_dict_to_torch(got), strict=True)
        for k, t in plain.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(t, sd[k]), (path, k)
    fresh = build_model(cfg, device="cpu", seed=9)
    assert ckpt.load_weights_tolerant(str(it), fresh, cfg) == sum(
        1 for k in sd if not k.endswith("num_batches_tracked"))
    for k, t in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, sd[k]), k
