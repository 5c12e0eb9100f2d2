"""The port's int8 depthwise conv as the serving path runs it, on the CPU:
the plain version of the kernel (``ops/int8_dwconv``) against XLA's
grouped int8 conv (``lax.conv_general_dilated`` with
``feature_group_count`` = C and int32 results) and the JAX package's
``_quantized_conv`` epilogue, exactly; the routes of the wrapper; and
every int8 site of MobileNetV3-Small and ShuffleNetV2+, depthwise ones
included, bit-equal to the JAX ``QuantizedModel``'s, with QAT on the
mobile nets.  The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 12), where
it is held bit for bit against the plain version.
"""

import ctypes
import re
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_torch_mobile import HW, _gaussian_batch, _x, bridged
from test_torch_quantize import _nchw
from test_torch_yolov5 import few_threads  # noqa: F401 (autouse)
from udp_pose_tpu.models import quantize as jq
from udp_pose_tpu_torch.core import loss
from udp_pose_tpu_torch.core.train import create_train_state, make_train_step
from udp_pose_tpu_torch.models import build_model
from udp_pose_tpu_torch.models import quantize as tq
from udp_pose_tpu_torch.ops import int8_conv as ic
from udp_pose_tpu_torch.ops import int8_dwconv as dw
from udp_pose_tpu_torch.utils.convert import conv_sites

REPO = Path(__file__).resolve().parents[1]


def _one_dw(k, s, C, bias, seed):
    """A one-conv flax module named ``conv`` (depthwise: groups = C), its
    numpy variables, and the torch conv with the same weights."""
    p = (k - 1) // 2

    class One(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(C, (k, k), strides=(s, s),
                            padding=((p, p), (p, p)), feature_group_count=C,
                            use_bias=bias, name="conv")(x)

    rng = np.random.default_rng(seed)
    kernel = rng.normal(0, 1 / k, (k, k, 1, C)).astype(np.float32)
    kernel[..., 0] = 0.0                 # an all-zero channel: scale 1e-12
    params = {"kernel": kernel}
    conv = torch.nn.Conv2d(C, C, k, s, p, groups=C, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            params["bias"] = rng.normal(0, 0.5, C).astype(np.float32)
            conv.bias.copy_(torch.from_numpy(params["bias"]))
    return One(), {"params": {"conv": params}}, conv


def _layer_and_input(k, s, C, bias, seed, hw=(11, 9), B=2):
    module, v, conv = _one_dw(k, s, C, bias, seed)
    x = np.random.default_rng(seed + 1).normal(
        0, 1.5, (B,) + hw + (C,)).astype(np.float32)
    amax = float(np.abs(x).max()) * 0.7          # some inputs saturate
    return module, v, conv, x, amax


@pytest.mark.parametrize("C", [16, 18, 58, 576])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_plain_version_equals_xla_grouped_int8_conv(k, s, C):
    """``int8_dwconv_accumulators`` equals XLA's grouped int8 conv with
    int32 results on the same int8 operands, and ``int8_dwconv_reference``
    (which the card holds the kernel to) and the CPU
    ``Int8DepthwiseConv2d`` give the JAX ``_quantized_conv`` output bit
    for bit, as a channels-last tensor."""
    bias = C != 16
    module, v, conv, x, amax = _layer_and_input(k, s, C, bias, k + s + C,
                                                hw=(7, 6) if C > 100
                                                else (11, 9))
    layer = tq.Int8DepthwiseConv2d(conv, amax)
    assert tuple(layer.w_taps.shape) == (k * k, C)
    xt = _nchw(x)
    x_i8 = np.clip(np.round(x * np.float32(layer.inv_s_a)), -127, 127)
    w_i8 = layer.w_taps.numpy().reshape(k, k, 1, C)
    p = (k - 1) // 2
    acc = lax.conv_general_dilated(
        jnp.asarray(x_i8, jnp.int8), jnp.asarray(w_i8), (s, s),
        ((p, p), (p, p)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=C, preferred_element_type=jnp.int32)
    got_acc = dw.int8_dwconv_accumulators(xt, layer)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(acc))
    want = np.asarray(jq.QuantizedModel(module, {"conv": amax}).apply(
        v, jnp.asarray(x)))
    for got in (dw.int8_dwconv_reference(xt, layer), layer(xt)):
        assert got.dtype == torch.float32
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("view", ["odd_channels", "channel_slice", "bf16"])
def test_plain_version_on_views_and_bf16(view):
    """A channel-split view (ShuffleNet's odd channels, channel stride 2),
    a channel slice of a wider tensor, and a bf16 activation: the plain
    version equals the JAX ``_quantized_conv`` bit for bit."""
    C = 58
    module, v, conv, _, _ = _layer_and_input(3, 2, C, True, 5)
    wide = np.random.default_rng(6).normal(0, 1.5, (2, 10, 8, 2 * C)).astype(
        np.float32)
    xt = torch.from_numpy(wide).permute(0, 3, 1, 2)        # channels-last
    if view == "odd_channels":
        xt = xt[:, 1::2]
    elif view == "channel_slice":
        xt = xt[:, 7:7 + C]
    else:
        xt = xt[:, :C].to(torch.bfloat16)
    amax = float(xt.float().abs().amax()) * 0.8
    xj = jnp.asarray(xt.float().permute(0, 2, 3, 1).numpy())
    if view == "bf16":
        xj = xj.astype(jnp.bfloat16)
    want = jq.QuantizedModel(module, {"conv": amax}).apply(v, xj)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    layer = tq.Int8DepthwiseConv2d(conv, amax)
    got = dw.int8_dwconv_reference(xt, layer)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                  want)


def test_int8_conv_for_routes_depthwise_convs():
    """``QuantizedModel``'s sites serve a depthwise conv as an
    ``Int8DepthwiseConv2d`` and a dense one as an ``Int8Conv2d``; a
    grouped conv that is not depthwise still raises."""
    net = torch.nn.Sequential(torch.nn.Conv2d(16, 16, 3, 1, 1, groups=16),
                              torch.nn.Conv2d(16, 8, 1))
    assert isinstance(tq.int8_conv_for(net[0], 2.0), tq.Int8DepthwiseConv2d)
    assert isinstance(tq.int8_conv_for(net[1], 2.0), tq.Int8Conv2d)
    with pytest.raises(NotImplementedError, match="depthwise"):
        tq.int8_conv_for(torch.nn.Conv2d(16, 16, 3, 1, 1, groups=4), 2.0)
    with pytest.raises(NotImplementedError, match="depthwise"):
        tq.int8_conv_for(torch.nn.Conv2d(16, 32, 3, 1, 1, groups=16), 2.0)


def test_loads_of_a_layout():
    """``dw_loads``: the 16-byte route for channels-last views whose 8
    channel chunks are aligned, one channel a thread otherwise."""
    x = torch.zeros(2, 32, 6, 5)
    assert dw.dw_loads(x) == "scalar"                       # NCHW
    cl = x.contiguous(memory_format=torch.channels_last)
    assert dw.dw_loads(cl) == "vec"
    assert dw.dw_loads(cl[:, :, 1:5]) == "vec"
    assert dw.dw_loads(cl[:, 8:24]) == "vec"
    assert dw.dw_loads(cl[:, 3:19]) == "scalar"             # misaligned
    assert dw.dw_loads(cl[:, 1::2]) == "scalar"             # channel split
    assert dw.dw_loads(torch.zeros(2, 18, 6, 5).contiguous(
        memory_format=torch.channels_last)) == "scalar"     # C % 8


def test_cpu_route_is_the_plain_version():
    """On the CPU ``int8_dwconv`` returns the plain result and launches
    nothing; the kernel's checks refuse what it does not take."""
    _, _, conv, x, amax = _layer_and_input(5, 1, 24, True, 3)
    layer = tq.Int8DepthwiseConv2d(conv, amax)
    xt = _nchw(x)
    before = (dw.int8_dwconv.launches, ic.int8_conv_fused.launches)
    assert torch.equal(dw.int8_dwconv(xt, layer),
                       dw.int8_dwconv_reference(xt, layer))
    assert (dw.int8_dwconv.launches, ic.int8_conv_fused.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        dw._plan(xt, layer)
    with pytest.raises(TypeError):
        dw._plan(xt.half(), layer)
    with pytest.raises(TypeError):
        dw._plan(xt[0], layer)


def test_wrapper_finds_its_launcher_and_struct():
    """The launcher the wrapper binds is an ``extern "C"`` function of the
    source, and ``DwArgs`` has the fields of ``struct DwArgs``, in order
    and of the same C types."""
    src = (REPO / "udp_pose_tpu_torch/csrc/int8_dwconv.cu").read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', src)) == {
        "int8_dwconv_launch"}
    body = re.search(r"struct DwArgs \{(.*?)\};", src, re.S).group(1)
    ctype = {"long long": ctypes.c_longlong, "const void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if decl:
            kind = next(k for k in ctype if decl.startswith(k + " "))
            fields += [(n.strip(), ctype[kind])
                       for n in decl[len(kind):].split(",")]
    assert dw.DwArgs._fields_ == fields


# --------------------------------------------------------------- the nets
@pytest.fixture(scope="module")
def nets():
    return {name: bridged(name, seed=i) for i, name in enumerate(
        ("pose_mobilenetv3_small", "pose_shufflenetv2_plus"))}


def _prepared(v, table):
    """The int8 weights of the JAX ``prepare_variables`` made in numpy
    with a true division (the eager scales; under jit XLA multiplies by
    1/127)."""
    quant = {}
    for path in table:
        if not jq._matches(path, jq.DEFAULT_SKIP):
            node = v["params"]
            for part in path.split("/"):
                node = node[part]
            k = node["kernel"]
            s_w = np.maximum(np.abs(k).max(axis=(0, 1, 2)) / np.float32(127),
                             np.float32(1e-12))
            leaf = quant
            for part in path.split("/"):
                leaf = leaf.setdefault(part, {})
            leaf.update(kernel_i8=np.clip(np.round(k / s_w), -127,
                                          127).astype(np.int8), scale=s_w)
    return quant


def jax_int8_sites(jmodel, v, x):
    """(the JAX calibration table, the engaged sites of its
    ``QuantizedModel``, each site's input in one apply of it, the prepared
    int8 weights)."""
    table = jq.calibrate(jmodel, v, [jnp.asarray(x)])
    jqm = jq.QuantizedModel(jmodel, table)
    quant = _prepared(v, table)

    @jax.jit
    def site_inputs(variables, x):
        seen = {}

        def record(next_fun, args, kwargs, context):
            y = jqm._interceptor(next_fun, args, kwargs, context)
            path = jq._path_of(context.module)
            if path in jqm.engaged and path not in seen:
                seen[path] = args[0]
            return y

        with fnn.intercept_methods(record):
            jmodel.apply(variables, x, train=False)
        return seen

    seen = jax.tree_util.tree_map(np.asarray, site_inputs(
        {**v, "quant": quant}, jnp.asarray(x)))
    return table, jqm.engaged, seen, quant


def jax_int8_site(conv, params, site_in, amax, prepared):
    """The JAX package's ``_quantized_conv`` of one site, run eagerly (under
    jit XLA fuses the epilogue's multiply-add into one rounding)."""
    (kh, kw), (sh, sw), (ph, pw) = (conv.kernel_size, conv.stride,
                                    conv.padding)
    flax_conv = fnn.Conv(conv.out_channels, (kh, kw), strides=(sh, sw),
                         padding=((ph, ph), (pw, pw)),
                         feature_group_count=conv.groups,
                         use_bias="bias" in params,
                         dtype=jnp.float32).bind({"params": params})
    return np.asarray(jq._quantized_conv(flax_conv, jnp.asarray(site_in),
                                         amax, prepared))


@pytest.mark.parametrize("name", ["pose_mobilenetv3_small",
                                  "pose_shufflenetv2_plus"])
def test_int8_sites_equal_jax(nets, name):
    """int8 PTQ on the JAX package's calibration table: the same engaged
    sites (``final_layer`` and the transposed convs in float), and every
    int8 site, depthwise ones included (k 3/5/7, strides 1 and 2, C = 16
    to 576, many not multiples of 8, channel-split views), fed the input
    it gets inside the JAX ``QuantizedModel``, gives the JAX output bit
    for bit."""
    jmodel, v, model, _ = nets[name]
    table, engaged, seen, quant = jax_int8_sites(jmodel, v, _x(7))
    qm = tq.QuantizedModel(model, table)
    sites = conv_sites(model)
    assert qm.engaged == engaged == set(seen)
    assert qm.engaged == set(sites.values()) - {"final_layer"}
    names = {p: n for n, p in sites.items()}
    dw = {(c.kernel_size[0], c.stride[0]) for n, c in model.named_modules()
          if isinstance(c, torch.nn.Conv2d) and c.groups > 1}
    assert dw == ({(3, 2), (3, 1), (5, 2), (5, 1)} if "mobilenet" in name
                  else {(k, s) for k in (3, 5, 7) for s in (1, 2)})
    for path, site_in in seen.items():
        conv = model.get_submodule(names[path])
        params = v["params"]
        for part in path.split("/"):
            params = params[part]
        leaf = quant
        for part in path.split("/"):
            leaf = leaf[part]
        want = jax_int8_site(conv, params, site_in, table[path], leaf)
        with torch.inference_mode():
            got = qm.net.get_submodule(names[path])(_nchw(site_in))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      want, err_msg=path)


def test_qat_engages_the_jax_sites_and_trains(nets):
    """``TPU.QAT int8`` on MobileNetV3-Small: the port's
    ``FakeQuantModel`` fake-quantises the sites the JAX package's does
    (its depthwise convs included), and one QAT train step moves every
    parameter that the float model trains."""
    name = "pose_mobilenetv3_small"
    jmodel, v, model, cfg = nets[name]
    jfq = jq.FakeQuantModel(jmodel)
    jax.eval_shape(lambda v, x: jfq.apply(v, x, train=False), v,
                   jnp.zeros((1,) + HW + (3,)))
    fq = tq.FakeQuantModel(model)
    assert fq.engaged == jfq.engaged
    assert any(c.conv.groups > 1 for c in fq.modules()
               if isinstance(c, tq.FakeQuantConv2d))
    cfg = cfg.clone()
    cfg.TPU.QAT = "int8"
    train_model = build_model(cfg, device="cpu", train=True)
    train_model.load_state_dict(model.state_dict(), strict=True)
    state = create_train_state(cfg, train_model, steps_per_epoch=1)
    assert isinstance(state.model, tq.FakeQuantModel)
    before = {k: p.detach().clone()
              for k, p in train_model.named_parameters()}
    batch = _gaussian_batch(cfg, seed=11)
    metrics = make_train_step(loss.make_loss_fn(cfg))(state, {
        k: torch.from_numpy(b) for k, b in batch.items()})
    assert np.isfinite(float(metrics["loss"]))
    moved = {k for k, p in train_model.named_parameters()
             if not torch.equal(p, before[k])}
    assert moved == set(before)
