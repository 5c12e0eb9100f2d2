"""The Hopper engine of the int8 conv (``csrc/int8_conv_sm90.cu``, the
``"wgmma"`` route of ``ops/int8_conv.int8_conv_fused``) as far as the CPU
can check it: the packed weight against ``w_gemm``, and a walk in Python
of the kernel's addressing (the extended tiles of int8 rows, each tap's
shifted rows, the padding mask, the padded channels, the packed weight's
offsets, the tiles a block walks, the padded positions of the
A-from-shared-memory path) that must rebuild
``quant_im2col_reference``'s patches and the exact integer product.  The
kernel itself runs only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py`` 9a, 9g)."""

import numpy as np
import pytest
import torch

from udp_pose_tpu_torch.models import quantize as tq
from udp_pose_tpu_torch.ops import int8_conv as ic

STEP = ic.K_TILE


def _layer(C, Cout, k, seed, bias=True):
    torch.manual_seed(seed)
    conv = torch.nn.Conv2d(C, Cout, k, 1, k // 2, bias=bias)
    return tq.Int8Conv2d(conv, 2.5)


def _b_offset(n, k):
    """Byte (n, k) of one K step of the packed weight (the MMA's
    canonical K-major no-swizzle layout)."""
    return (n // 8) * 256 + (k // 16) * 128 + (n % 8) * 16 + k % 16


def unpack(packed, C, kernel, cout, nt):
    """``pack_wgmma_weight``'s bytes read back through the kernel's
    offsets: (chunks·nt, steps·32) int8, K in (tap, c_pad32) order."""
    steps = ic.wgmma_k_steps(C, kernel)
    chunks = -(-ic.gemm_pad(cout) // nt)
    flat = packed.numpy()
    assert flat.size == chunks * steps * nt * STEP
    n = np.arange(nt)[:, None]
    k = np.arange(STEP)[None, :]
    out = np.zeros((chunks * nt, steps * STEP), np.int8)
    for c in range(chunks):
        for s in range(steps):
            run = flat[(c * steps + s) * nt * STEP:][:nt * STEP]
            out[c * nt:(c + 1) * nt, s * STEP:(s + 1) * STEP] = run[
                _b_offset(n, k)]
    return out


@pytest.mark.parametrize("C", [26, 32, 52, 256])
@pytest.mark.parametrize("cout", [26, 32, 256, 2048])
def test_packed_weight_is_w_gemm_in_the_padded_k_order(C, cout):
    """Unpacking ``w_packed`` by the kernel's byte offsets gives
    ``w_gemm``'s values in the per-tap padded K order (each tap's C
    channels padded with zeros to a multiple of 32, zero steps up to a
    multiple of ``kStepAlign``, zero rows past n_pad)."""
    layer = _layer(C, cout, 3, seed=C + cout)
    nt = ic.wgmma_n_tile(cout)
    assert nt == min(b for b in (32, 64, 128, 256) if b >= min(cout, 256))
    got = unpack(layer.w_packed, C, (3, 3), cout, nt)
    planes = -(-C // STEP)
    want = np.zeros_like(got)
    w = layer.w_gemm.numpy()
    view = want[:w.shape[0], :9 * planes * STEP].reshape(w.shape[0], 9, -1)
    view[:, :, :C] = w[:, :9 * C].reshape(w.shape[0], 9, C)
    np.testing.assert_array_equal(got, want)
    assert not got[w.shape[0]:].any() and not got[:, 9 * planes * STEP:].any()


def _valid_taps(m, H, W, kh, kw):
    """``valid_taps`` of the source: bit i·kw + j where tap (i, j) of
    output pixel m lies inside the image."""
    r = m % (H * W)
    oh, ow = r // W, r % W
    bits = 0
    for i in range(kh):
        for j in range(kw):
            if 0 <= oh + i - kh // 2 < H and 0 <= ow + j - kw // 2 < W:
                bits |= 1 << (i * kw + j)
    return bits


def walk(xq, shape, kernel, layer, plan):
    """The kernel's addressing in Python, block by block: the quantised
    activation ``xq`` ((M, C) int8, pixel rows) into each block's
    extended tiles (positions: the pixels, or at NT <= 64 the pixels of
    each image padded with zero rows and columns; the first tile's rows,
    then for each next tile the other tile: the halo copied over, the
    prefetched rows after it), each tile's A rows of every K step read
    back at the shifted rows (with the padding mask where A comes from
    registers), each step's B from the packed weight.  Returns, by pixel,
    the (M, K) patches it read (K in (tap, c_pad32) order) and the int64
    product."""
    B, C, H, W = shape
    kh, kw = kernel
    M = xq.shape[0]
    bm, nt, tpb = plan.block_m, plan.block_n, plan.tiles_per_block
    pack_n = ic.wgmma_n_tile(layer.out_channels)
    ss = nt <= 64
    ph, pw = (kh // 2, kw // 2) if ss else (0, 0)
    hp, wp = H + 2 * ph, W + 2 * pw
    Mp, halo = ic.wgmma_positions(shape, kernel, nt)
    assert Mp == B * hp * wp
    R = bm + 2 * halo
    planes = -(-C // STEP)
    ksteps, steps = kh * kw * planes, ic.wgmma_k_steps(C, kernel)
    n_tiles = -(-Mp // bm)
    chunks = -(-layer.out_channels // nt)
    wp_bytes = layer.w_packed.numpy()
    xpad = np.zeros((M, planes * STEP), np.int8)
    xpad[:, :C] = xq

    def pixel_of(P):
        n, r = np.divmod(P, hp * wp)
        y, x = r // wp - ph, r % wp - pw
        ok = (P >= 0) & (P < Mp) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
        return np.where(ok, (n * H + y) * W + x, -1)

    def at(e, ch):                      # q_offset of the source
        return ((ch >> 5) * 2 + ((ch >> 4) & 1)) * R * 16 + e * 16 + (ch & 15)

    def store(tile, P0, lo, hi):
        e = np.arange(lo, hi)[:, None]
        ch = np.arange(planes * STEP)[None, :]
        q = pixel_of(P0 + e)
        vals = np.where(q >= 0, xpad[np.maximum(q, 0)[:, 0]], 0)
        tile[at(e, ch)] = vals

    pos_patches = np.zeros((n_tiles * bm, ksteps * STEP), np.int8)
    pos_acc = np.zeros((n_tiles * bm, chunks * nt), np.int64)
    for blk in range(-(-n_tiles // tpb)):
        tiles = np.zeros((2, planes * 2 * R * 16), np.int8)
        t0, cur = blk * tpb, 0
        store(tiles[0], t0 * bm - halo, 0, R)
        for t in range(t0, min(t0 + tpb, n_tiles)):
            m0 = t * bm
            r = np.arange(bm)
            if ss:
                valid = np.full(bm, -1)
            else:
                valid = np.array([_valid_taps(m0 + i, H, W, kh, kw)
                                  for i in r])
            for s in range(ksteps):
                tap, cb = divmod(s, planes)
                ti, tj = divmod(tap, kw)
                row = r + ti * wp + tj
                a = tiles[cur][at(row[:, None], cb * STEP
                                  + np.arange(STEP)[None, :])]
                a[(valid >> tap & 1) == 0] = 0
                pos_patches[m0:m0 + bm, s * STEP:(s + 1) * STEP] = a
                for nc in range(chunks):
                    start = ((nc * nt // pack_n) * steps * pack_n
                             + nc * nt % pack_n) * STEP + s * pack_n * STEP
                    b = wp_bytes[start + _b_offset(np.arange(nt)[:, None],
                                                   np.arange(STEP)[None, :])]
                    pos_acc[m0:m0 + bm, nc * nt:(nc + 1) * nt] += (
                        a.astype(np.int64) @ b.astype(np.int64).T)
            if t + 1 < min(t0 + tpb, n_tiles):
                nxt = tiles[cur ^ 1]
                for h in range(planes * 2):          # copy_halo
                    nxt[h * R * 16:(h * R + R - bm) * 16] = tiles[cur][
                        (h * R + bm) * 16:(h * R + R) * 16]
                store(nxt, m0 + bm - halo, R - bm, R)
            cur ^= 1
    q = pixel_of(np.arange(n_tiles * bm))
    patches = np.zeros((M, ksteps * STEP), np.int8)
    acc = np.zeros((M, chunks * nt), np.int64)
    patches[q[q >= 0]] = pos_patches[q >= 0]
    acc[q[q >= 0]] = pos_acc[q >= 0]
    assert np.array_equal(np.sort(q[q >= 0]), np.arange(M))
    return patches, acc[:, :layer.out_channels]


# (batch, C, H, W, kernel, cout, sms, blocks walk tiles): small SM
# counts make blocks walk
WALK_CASES = [
    (4, 26, 24, 16, 3, 26, 1, True),    # halo 19 (padded positions): wraps
                                        # image rows and images
    (3, 64, 24, 16, 3, 64, 1, True),
    (2, 26, 7, 9, 3, 40, 1, False),     # one tile, an M tail
    (3, 64, 24, 16, 1, 256, 1, True),   # 1x1, NT = 256 (A from registers)
    (2, 64, 11, 13, 1, 26, 132, False),  # 1x1, one tile a block, a tail
    (7, 26, 16, 14, 3, 26, 1, True),    # the last tile with a tail
    (2, 64, 5, 3, 3, 256, 132, False),  # NT halved (two chunks of 128),
                                        # A from registers, padding masks
    (3, 104, 9, 7, 3, 104, 1, False),   # NT 128, C % 32 != 0
    (5, 32, 24, 16, 3, 32, 1, True),    # blocks of 256 rows (two m64 tiles
                                        # a warpgroup) that walk
]


@pytest.mark.parametrize("case", WALK_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_walk_of_the_addressing_rebuilds_the_patches(case):
    """The walk of the kernel's addressing reads, for every output pixel
    and K step, exactly ``quant_im2col_reference``'s patch columns
    (padded per tap to 32 channels), and its product is the exact integer
    product of the patches and ``w_gemm``."""
    B, C, H, W, k, cout, sms, walks = case
    layer = _layer(C, cout, k, seed=sum(case))
    g = torch.Generator().manual_seed(B * C)
    x = (torch.randn(B, C, H, W, generator=g) * 1.5).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    plan = ic.wgmma_plan(x.shape, cout, (k, k), sms)
    t = ic.fused_tiling(x.shape, cout, (k, k), (1, 1), (k // 2, k // 2),
                        ic._loads(x), x.dtype, sms)
    if ic.wgmma_routes(C, cout, (k, k), H, W):
        assert t.route == "wgmma" and (t.block_m, t.block_n, t.ring,
                                       t.tiles_per_block) == plan[1:5]
    else:                       # 1x1: PR 6's route unless forced
        assert k == 1 and t.route != "wgmma"
    assert plan.block_m == (256 if case[-2:] == (1, True) and C == 32
                            else plan.block_m)
    assert (plan.tiles_per_block > 1) == walks
    want = ic.quant_im2col_reference(x, layer.inv_s_a, (k, k), (1, 1),
                                     (k // 2, k // 2), layer.k_pad)
    M = B * H * W
    xq = ic.quant_im2col_reference(x, layer.inv_s_a, (1, 1), (1, 1), (0, 0),
                                   ic.k_tile_pad(C))[:M, :C].numpy()
    patches, acc = walk(xq, x.shape, (k, k), layer, plan)
    planes = -(-C // STEP)
    got = patches.reshape(M, k * k, planes * STEP)
    np.testing.assert_array_equal(got[:, :, :C].reshape(M, -1),
                                  want[:M, :k * k * C].numpy())
    assert not got[:, :, C:].any()
    exact = ic.int8_gemm_reference(want, layer.w_gemm)[:M, :cout]
    np.testing.assert_array_equal(acc, exact.numpy().astype(np.int64))
