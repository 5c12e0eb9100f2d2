// The port's int8 (w8a8) conv on Hopper's warpgroup MMA: one kernel for
// every stride-1 "same" conv with an odd kernel (1x1 included) of a dense
// channels-last bf16 activation, any channel count.  Like
// int8_conv_fused_kernel (csrc/int8_conv.cu) it computes the JAX
// package's PTQ serving conv (udp_pose_tpu/models/quantize.py,
// _quantized_conv :188-218) in one launch and replaces no Pallas kernel;
// ops/int8_conv.fused_tiling routes such convs here ("wgmma") where it
// measured faster than the older kernel, which keeps stride-2 convs,
// other layouts, float32 activations, the C = 3 stems and the 1x1 convs.
//
// Exact: the same quantise (rint half to even through the 1.5 * 2^23 add,
// clamped to +-127) and epilogue (__int2float_rn, __fmul_rn by scale,
// __fadd_rn of bias, __float2bfloat16_rn) as the older kernels, and
// integer sums, which are exact in any order.
//
// Bound on this card: bytes on the wide maps (the activation read once
// and the output written once), the tensor cores' int8 rate on the deep,
// small maps.  Its design:
//   * A block of 64, 128 or 256 rows (one or two warpgroups, each one or,
//     at NT <= 64, two m64 tiles sharing each weight stage) covers
//     NT output channels (up to 256: every Cout of the nets but the
//     widest, which are cut in chunks over blockIdx.y), so each
//     activation is loaded and quantised once for every tap and column.
//   * The block's extended tile (its rows and a halo of kh / 2 * Wp +
//     kw / 2 rows on either side: in linear order the rows of tap (i, j)
//     are the block's shifted by i * Wp + j) is loaded, all channels,
//     quantised, and kept in shared memory as int8 planes of 32 channels
//     zero-padded from C (each plane two halves of 16-byte rows: the MMA
//     descriptor's layout, and conflict-free for ldmatrix).  Loads are 16
//     bytes where C % 8 == 0, 4 where C is even, 2 otherwise; rows
//     outside the batch and padded channels are zeros, never loads.
//   * A at NT >= 128 comes from registers: each warp's fragment of a tap
//     is one ldmatrix at the shifted rows, and a row whose tap lies in
//     the padding (which the linear order wraps to the neighbouring image
//     row or image) has its fragment zeroed, as in
//     int8_conv_shift_kernel.  At NT <= 64 building those fragments cost
//     more than the MMAs, so A comes by descriptor from the tile itself:
//     there the tile's rows are the positions of each image padded with
//     kh / 2 rows and kw / 2 columns of zeros (Wp = W + kw - 1), where no
//     tap wraps, and the MMAs of the border positions are computed and
//     not stored (7% more rows at 64x48).
//   * B is the weight packed once by ops/int8_conv.pack_wgmma_weight:
//     per (N chunk, K step of 32 bytes) an NT x 32-byte run in the
//     canonical K-major no-swizzle layout (8 x 16-byte core matrices), K
//     in (kh, kw, c_pad32) order.  Thread 0 copies stages of several K
//     steps with cp.async.bulk into a ring of shared memory (every stage
//     once where the ring holds them all), completion and release by
//     mbarriers; the warpgroups issue wgmma.mma_async m64nNk32 s8 per
//     step, one commit group a stage, the next stage's A loaded while it
//     runs.  No branch on the thread between MMAs in flight: ptxas would
//     serialise them (C7518).
//   * Where a map has many tiles, a block walks consecutive tiles with
//     two extended tiles in shared memory: the next tile's new rows are
//     loaded into registers before this tile's MMAs and quantised into
//     the other tile after its epilogue, beside the halo copied over, so
//     that each pixel is loaded and quantised once, halo included, and
//     the weight is loaded once a block.
//   * The epilogue in registers, staged per warp through shared memory so
//     that each output row is written with 16-byte stores.
// The launcher int8_conv_wgmma_launch takes ops/int8_conv.FusedArgs, the
// same struct as int8_conv_fused_launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_STEP = 32;        // bytes of K an MMA step
constexpr int kStepAlign = 4;     // K steps of the packed weight: a multiple
constexpr int kMaxRing = 8;       // weight stages in shared memory
constexpr int kStageBytes = 2304; // epilogue staging a warp
constexpr int kPrefetchWords = 16;  // next tile's rows a thread, in flight,
                                    // for each m64 tile of a warpgroup
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block (227 KB)

// Blocks an SM holds at once, which bounds the registers a thread: at NT
// >= 128 the accumulators and A fragments take most of them; at NT <= 64
// (A from shared memory) more blocks hide each other's latencies (three
// at NT 32 and two at NT 64 measured fastest at 128 rows on an H100, two
// at 256 rows)
template <int NT, int WGS, int MT>
struct BlocksPerSm {
  static constexpr int value = NT >= 128  ? 1
                               : WGS == 1 ? 4
                               : MT == 2  ? 2
                               : NT == 32 ? 3
                                          : 2;
};

// K steps a weight stage (one commit group) holds
template <int NT>
struct StageSteps {
  static constexpr int value = NT >= 256 ? 2 : 4;
};

struct WgParams {
  const __nv_bfloat16* x;
  const int8_t* wp;
  const float* scale;
  const float* bias;
  __nv_bfloat16* out;
  int C, CB, H, W, kh, kw;
  // The positions the tiles cover: the pixels themselves (A from
  // registers: pad 0), or, where A comes from shared memory, the pixels
  // of each image padded by ph rows and pw columns of zeros on every side
  // (the MMAs of those border positions are computed and not stored).
  int pad_h, pad_w;
  int Hp, Wp;      // H + 2 pad_h, W + 2 pad_w
  unsigned wp_mul, wp_shr, hw_mul, hw_shr;  // division by Wp and Hp * Wp
  int halo;        // kh / 2 * Wp + kw / 2: the extended tile's rows a side
  int Mp;          // batch * Hp * Wp positions
  int N;           // cout
  int ksteps;      // kh * kw * CB: the MMA steps of one tile and chunk
  int ksteps_pad;  // the packed weight's steps a chunk (zeros past ksteps)
  int pack_n;      // the packed weight's chunk width (NT or 2 NT)
  int ring;        // weight stages in shared memory
  int resident;    // ring holds every stage: loaded once a block
  int tpb;         // consecutive M tiles a block
  int n_tiles;     // ceil(Mp / BM)
  int rows;        // BM + 2 halo: the rows of an extended tile
  int vec;         // channels a load: 8, 2 or 1
  int cpr_log;     // log2 of the chunks a row (a power of two where
                   // blocks walk tiles), else -1
  int q_off, stage_off, sb_off, bar_off;
  float inv;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// until the phase of parity `parity` has completed (the loop inside one
// asm block: no branch of the compiler's between in-flight MMAs)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// arrive on `bar` where `pred`
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// `bytes` (a multiple of 16) global -> shared, completing on `bar`, where
// `pred`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar,
                                          bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n}\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "r"(static_cast<int>(pred))
      : "memory");
}

// the expected bytes of `bar`'s phase (and an arrival), where `pred`
__device__ __forceinline__ void mbar_expect_tx_if(uint64_t* bar,
                                                  unsigned bytes, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(pred))
      : "memory");
}

// ------------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across the point
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int S>
__device__ __forceinline__ void fence_regs(unsigned (&r)[S][4]) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

// The descriptor of an NT x 32-byte K-major B tile at shared address
// `addr` in the no-swizzle layout: core matrices of 8 rows x 16 bytes,
// 128 bytes each; the two 16-byte halves of K 128 bytes apart (leading
// byte offset), 8-row groups 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// The descriptor of a 64 x 32-byte K-major A tile at shared address
// `addr` in the no-swizzle layout: 64 rows of 16 bytes (8-row core
// matrices 128 bytes apart), the second 16 bytes of K `half` bytes on.
__device__ __forceinline__ uint64_t a_desc(unsigned addr, unsigned half) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(half >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// d (m64 x NT s32, the warpgroup's accumulators) += a (m64 x k32 s8, the
// warp's rows 16w..16w+15 in registers, the m16n8k32 A fragment) * B
// (NT x k32 s8 at descriptor desc)
template <int NT>
struct Wgmma;

#define WG_D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])

template <>
struct Wgmma<32> {
  // the same with A (m64 x k32 s8) at descriptor desc_a
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t desc_a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12)
        : "l"(desc_a), "l"(desc), "r"(1));
  }
  __device__ __forceinline__ static void mma(int (&d)[16], const unsigned (&a)[4],
                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // the same with A (m64 x k32 s8) at descriptor desc_a
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t desc_a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
          WG_D4(24), WG_D4(28)
        : "l"(desc_a), "l"(desc), "r"(1));
  }
  __device__ __forceinline__ static void mma(int (&d)[32], const unsigned (&a)[4],
                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
          WG_D4(24), WG_D4(28)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], const unsigned (&a)[4],
                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
          WG_D4(24), WG_D4(28), WG_D4(32), WG_D4(36), WG_D4(40),
          WG_D4(44), WG_D4(48), WG_D4(52), WG_D4(56), WG_D4(60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], const unsigned (&a)[4],
                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p;\n}\n"
        : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
          WG_D4(24), WG_D4(28), WG_D4(32), WG_D4(36), WG_D4(40),
          WG_D4(44), WG_D4(48), WG_D4(52), WG_D4(56), WG_D4(60),
          WG_D4(64), WG_D4(68), WG_D4(72), WG_D4(76), WG_D4(80),
          WG_D4(84), WG_D4(88), WG_D4(92), WG_D4(96), WG_D4(100),
          WG_D4(104), WG_D4(108), WG_D4(112), WG_D4(116), WG_D4(120),
          WG_D4(124)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};


#undef WG_D4

// ---------------------------------------------------------------- quantise
__device__ __forceinline__ unsigned quant_byte(float v, float inv) {
  const float q = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(q, 12582912.0f)) & 0xffu;
}

__device__ __forceinline__ float bf_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// V channels of one pixel: WORDS 32-bit words loaded, V int8 stored
template <int V>
struct Chunk;
template <>
struct Chunk<8> {
  static constexpr int WORDS = 4;
  __device__ static void load(const __nv_bfloat16* p, unsigned* w) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  __device__ static void store(unsigned char* dst, const unsigned* w,
                               float inv) {
    unsigned b[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b[2 * e] = quant_byte(bf_lo(w[e]), inv);
      b[2 * e + 1] = quant_byte(bf_hi(w[e]), inv);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(
        b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
        b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
  }
};
template <>
struct Chunk<2> {
  static constexpr int WORDS = 1;
  __device__ static void load(const __nv_bfloat16* p, unsigned* w) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
  __device__ static void store(unsigned char* dst, const unsigned* w,
                               float inv) {
    *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(
        quant_byte(bf_lo(w[0]), inv) | quant_byte(bf_hi(w[0]), inv) << 8);
  }
};
template <>
struct Chunk<1> {
  static constexpr int WORDS = 1;
  __device__ static void load(const __nv_bfloat16* p, unsigned* w) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void store(unsigned char* dst, const unsigned* w,
                               float inv) {
    *dst = static_cast<unsigned char>(quant_byte(bf_lo(w[0]), inv));
  }
};

// n / d for 0 <= n < 2^31 by a multiply: mul and shr from magic_of(d)
__device__ __forceinline__ int fast_div(int n, unsigned mul, unsigned shr,
                                        int d) {
  return d == 1 ? n : static_cast<int>(__umulhi(n, mul) >> shr);
}

// The pixel at position P (-1: a border position, or outside the
// batch).
__device__ __forceinline__ int pixel_of(const WgParams& p, int P) {
  if (P < 0 || P >= p.Mp) return -1;
  if (p.pad_h == 0 && p.pad_w == 0) return P;
  const int hw = p.Hp * p.Wp;
  const int n = fast_div(P, p.hw_mul, p.hw_shr, hw);
  const int r = P - n * hw;
  const int yp = fast_div(r, p.wp_mul, p.wp_shr, p.Wp);
  const int y = yp - p.pad_h;
  const int x = r - yp * p.Wp - p.pad_w;
  if (static_cast<unsigned>(y) >= static_cast<unsigned>(p.H) ||
      static_cast<unsigned>(x) >= static_cast<unsigned>(p.W))
    return -1;
  return (n * p.H + y) * p.W + x;
}

// An extended tile in shared memory: for each plane of 32 channels its
// two 16-byte halves, each `rows` rows of 16 bytes (the layout of the
// MMA's A descriptor, and 8 consecutive rows of a half are 128
// consecutive bytes for ldmatrix).  Byte of (row e, channel ch):
__device__ __forceinline__ int q_offset(const WgParams& p, int e, int ch) {
  return ((ch >> 5) * 2 + ((ch >> 4) & 1)) * p.rows * 16 + e * 16 +
         (ch & 15);
}

// Rows [lo, hi) of the extended tile whose row 0 is position P0, all
// channels, quantised into the tile `qa`, by the CT threads with U loads
// in flight a thread.  Border positions, rows outside the batch and
// channels past C are zeros.
template <int V, int CT>
__device__ __forceinline__ void load_rows(const WgParams& p,
                                          unsigned char* qa, int P0,
                                          int lo, int hi, int tid) {
  using CK = Chunk<V>;
  constexpr int U = V == 8 ? 8 : 16;
  const int cpr = p.CB * K_STEP / V;  // chunks a row
  const int items = (hi - lo) * cpr;
  for (int first = tid; first < items; first += CT * U) {
    unsigned raw[U][CK::WORDS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int item = first + u * CT;
#pragma unroll
      for (int k = 0; k < CK::WORDS; ++k) raw[u][k] = 0u;
      const int e = lo + item / cpr;
      const int ch = (item % cpr) * V;
      const int q = pixel_of(p, P0 + e);
      if (item < items && q >= 0 && ch < p.C)
        CK::load(p.x + static_cast<long long>(q) * p.C + ch, raw[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int item = first + u * CT;
      if (item < items)
        CK::store(qa + q_offset(p, lo + item / cpr, (item % cpr) * V),
                  raw[u], p.inv);
    }
  }
}

// The next tile's new rows, [rows - BM, rows) of its extended tile, in
// flight in registers across this tile's MMAs (at most PF words a
// thread: the launcher checks), then quantised into the other tile.
template <int V, int CT, int BM, int PF>
struct Prefetch {
  using CK = Chunk<V>;
  static constexpr int ITEMS = PF / CK::WORDS;
  __device__ static void load(const WgParams& p, int P0, int tid,
                              unsigned (&w)[PF]) {
    const int items = BM << p.cpr_log;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int item = tid + u * CT;
#pragma unroll
      for (int k = 0; k < CK::WORDS; ++k) w[u * CK::WORDS + k] = 0u;
      const int e = p.rows - BM + (item >> p.cpr_log);
      const int ch = (item & ((1 << p.cpr_log) - 1)) * V;
      const int q = pixel_of(p, P0 + e);
      if (item < items && q >= 0 && ch < p.C)
        CK::load(p.x + static_cast<long long>(q) * p.C + ch,
                 &w[u * CK::WORDS]);
    }
  }
  __device__ static void store(const WgParams& p, unsigned char* qa,
                               int tid, const unsigned (&w)[PF]) {
    const int items = BM << p.cpr_log;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int item = tid + u * CT;
      if (item < items)
        CK::store(qa + q_offset(p, p.rows - BM + (item >> p.cpr_log),
                                (item & ((1 << p.cpr_log) - 1)) * V),
                  &w[u * CK::WORDS], p.inv);
    }
  }
};

// The next tile's first 2 halo rows are this tile's last: rows [BM, rows)
// of tile `from` into rows [0, rows - BM) of tile `to`, every half.
template <int CT, int BM>
__device__ __forceinline__ void copy_halo(const WgParams& p,
                                          const unsigned char* from,
                                          unsigned char* to, int tid) {
  for (int h = 0; h < p.CB * 2; ++h)
    for (int e = tid; e < p.rows - BM; e += CT)
      *reinterpret_cast<uint4*>(to + (h * p.rows + e) * 16) =
          *reinterpret_cast<const uint4*>(from +
                                          (h * p.rows + BM + e) * 16);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  union {
    __nv_bfloat16 h[2];
    unsigned u;
  } pack;
  pack.h[0] = __float2bfloat16_rn(a);
  pack.h[1] = __float2bfloat16_rn(b);
  *reinterpret_cast<unsigned*>(dst) = pack.u;
}

// The warp's 16 rows (positions from row_base) of the accumulators' NT
// columns
// (from n0) -> cast(float(acc) * scale + bias) (the block's NT scales and
// biases in shared memory, zeros past N), through the warp's staging
// tile, 64 columns at a time, 16 bytes a store (a scalar tail where N is
// not a multiple of 8).
template <int NT>
__device__ __forceinline__ void epilogue(const int (&acc)[NT / 2],
                                         __nv_bfloat16* stage,
                                         const float* s_scale,
                                         const float* s_bias,
                                         const WgParams& p, int row_base,
                                         int n0, int lane) {
  constexpr int CW = NT < 64 ? NT : 64;
  constexpr int LDS = CW + 8;  // staging row in elements
  constexpr int VPR = CW / 8;  // 16-byte vectors a row
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bool vec = p.N % 8 == 0;
#pragma unroll
  for (int c0 = 0; c0 < NT; c0 += CW) {
    if (n0 + c0 < p.N) {
#pragma unroll
      for (int jj = 0; jj < CW / 8; ++jj) {
        const int j = c0 / 8 + jj;
        const float2 sc = *reinterpret_cast<const float2*>(
            s_scale + 8 * j + 2 * t4);
        const float2 bi = *reinterpret_cast<const float2*>(
            s_bias + 8 * j + 2 * t4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2] = {
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sc.x),
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sc.y)};
          if (p.bias) {
            v[0] = __fadd_rn(v[0], bi.x);
            v[1] = __fadd_rn(v[1], bi.y);
          }
          store2(stage + (g + 8 * h) * LDS + 8 * jj + 2 * t4, v[0], v[1]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = lane; q < 16 * VPR; q += 32) {
        const int r = q / VPR;
        const int cv = q - r * VPR;
        const int m = pixel_of(p, row_base + r);
        const int col = n0 + c0 + cv * 8;
        if (m >= 0 && col < p.N) {
          const __nv_bfloat16* src = stage + r * LDS + cv * 8;
          __nv_bfloat16* dst = p.out + static_cast<long long>(m) * p.N + col;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < 8 && col + e < p.N; ++e) dst[e] = src[e];
          }
        }
      }
      __syncwarp();
    }
  }
}

// The taps (bit i * kw + j) whose input pixel of output pixel m lies
// inside the image.
__device__ __forceinline__ unsigned valid_taps(const WgParams& p, int m) {
  const int r = m % (p.H * p.W);
  const int oh = r / p.W;
  const int ow = r - oh * p.W;
  // the taps i (j) in [lo, hi] that keep the input row (column) inside
  auto span = [](int pos, int pad, int k, int size) {
    const int lo = max(pad - pos, 0);
    const int hi = min(k - 1, size - 1 - pos + pad);
    return lo > hi ? 0u : ((2u << hi) - 1u) & ~((1u << lo) - 1u);
  };
  const unsigned rows = span(oh, p.kh / 2, p.kh, p.H);
  const unsigned cols = span(ow, p.kw / 2, p.kw, p.W);
  unsigned bits = 0;
  for (int i = 0; i < p.kh; ++i)
    bits |= (0u - (rows >> i & 1u)) & (cols << (i * p.kw));
  return bits;
}

// The weight stages of a block: stage i of the block's sequence (K steps
// (i % stages) * SPS.. of its N chunk, tile after tile unless resident)
// into ring slot i % ring, completing on full[slot]; issued by thread 0.
template <int NT>
struct WeightRing {
  static constexpr int SPS = StageSteps<NT>::value;
  static constexpr int STAGE = SPS * NT * K_STEP;  // bytes
  unsigned char* ring;
  const int8_t* w;  // step 0 of the block's chunk in the packed weight
  uint64_t* full;
  uint64_t* empty;
  int stages, total, slots, pack_n;

  // by thread 0 (the other threads run the same code, predicated off)
  __device__ __forceinline__ void issue(int i, bool leader) {
    const int slot = i % slots;
    const int st = i % stages;
    mbar_expect_tx_if(&full[slot], STAGE, leader);
#pragma unroll
    for (int k = 0; k < SPS; ++k)
      bulk_copy(ring + slot * STAGE + k * NT * K_STEP,
                w + static_cast<long long>(st * SPS + k) * pack_n * K_STEP,
                NT * K_STEP, &full[slot], leader);
  }

  // stage i's MMAs are done in this warp: once every warp's are, thread 0
  // refills the slot with stage i + slots (every thread waits: no branch
  // on the thread between MMAs in flight)
  __device__ __forceinline__ void release(int i, int tid) {
    const int slot = i % slots;
    mbar_arrive_if(&empty[slot], (tid & 31) == 0);
    if (i + slots < total) {
      mbar_wait(&empty[slot], (i / slots) & 1);
      issue(i + slots, tid == 0);
    }
  }
};

// Where K step s of a tile reads its A rows: plane cb, rows shifted by
// ti * Wp + tj, tap bit ti * kw + tj, for s = (ti * kw + tj) * CB + cb,
// walked step by step.
struct StepIter {
  int plane;  // byte offset of plane cb in the tile
  int shift;  // ti * W + tj
  int tap;
  int cb, tj, s;
  // to step s + 1, or stay on the last step (the padded steps' weights
  // are zeros: their A may be any step's)
  __device__ __forceinline__ void advance(const WgParams& p) {
    if (++s >= p.ksteps) return;
    plane += 2 * p.rows * 16;
    if (++cb == p.CB) {
      cb = 0;
      plane = 0;
      ++tap;
      ++shift;
      if (++tj == p.kw) {
        tj = 0;
        shift += p.Wp - p.kw;
      }
    }
  }
};

// The MMAs of one tile and N chunk, SPS K steps a stage, one commit
// group a stage while the previous stage's may still run
// (wgmma.wait_group 1).  A: at NT <= 64 by descriptor from the tile in
// shared memory (SS: the tile is in padded positions, so a tap's rows
// need no mask); otherwise from registers (ldmatrix at each step's
// shifted rows, a row whose tap lies in the padding zeroed), a stage's
// fragments in one of two register sets.  `prev` is the block's index of
// the stage whose MMAs may still run, released once they are done (-1:
// none, or the weight is resident and never released).
template <int NT, int MT>
struct Mma {
  static constexpr int SPS = StageSteps<NT>::value;
  static constexpr bool SS = NT <= 64;
  static_assert(SS || MT == 1, "two m64 tiles a warpgroup: A by descriptor");
  int acc[MT][NT / 2];
  unsigned a[2][SPS][4];

  // qa: the tile's shared address; row0: the warp's first row of the
  // tile, wrow its warpgroup's (MT m64 tiles from there, sharing each B
  // stage).  Every instruction from the first commit of a tile to its
  // last wait runs in every thread (no branch on the thread, and none
  // around a register that an MMA in flight may read), else ptxas
  // serialises the MMAs.
  __device__ __forceinline__ void stage(int cur, const WgParams& p,
                                        unsigned qa, int row0, int wrow,
                                        int lane, unsigned v0, unsigned v1,
                                        StepIter& it, int slot,
                                        unsigned parity, int i,
                                        unsigned ring_base,
                                        WeightRing<NT>& wr, int& prev,
                                        int tid) {
    const unsigned b0 = ring_base + slot * WeightRing<NT>::STAGE;
    if constexpr (SS) {
      uint64_t da[SPS];
#pragma unroll
      for (int k = 0; k < SPS; ++k) {
        da[k] = a_desc(qa + it.plane + (wrow + it.shift) * 16, p.rows * 16);
        it.advance(p);
      }
      mbar_wait(&wr.full[slot], parity);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < SPS; ++k)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)  // 64 rows on: 1024 bytes, >> 4
          Wgmma<NT>::mma(acc[mt], da[k] + mt * 64,
                         b_desc(b0 + k * NT * K_STEP));
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    } else {
#pragma unroll
      for (int k = 0; k < SPS; ++k) {
        unsigned (&f)[4] = a[cur][k];
        ldmatrix_x4(f, qa + it.plane + (lane >> 4) * p.rows * 16 +
                           (row0 + it.shift + (lane & 15)) * 16);
        const unsigned k0 = 0u - ((v0 >> it.tap) & 1u);
        const unsigned k1 = 0u - ((v1 >> it.tap) & 1u);
        f[0] &= k0;
        f[2] &= k0;
        f[1] &= k1;
        f[3] &= k1;
        it.advance(p);
      }
      mbar_wait(&wr.full[slot], parity);
      fence_regs(acc[0]);
      fence_regs(a[cur]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < SPS; ++k)
        Wgmma<NT>::mma(acc[0], a[cur][k], b_desc(b0 + k * NT * K_STEP));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc[0]);
      fence_regs(a[cur ^ 1]);
    }
    if (prev >= 0) wr.release(prev, tid);
    prev = p.resident ? -1 : i;
  }
};

template <int NT, int WGS, int MT>
__global__ void __launch_bounds__(WGS * 128, BlocksPerSm<NT, WGS, MT>::value)
    int8_conv_wgmma_kernel(const WgParams p) {
  constexpr int CT = WGS * 128;
  constexpr int BM = WGS * 64 * MT;
  constexpr int PF = kPrefetchWords * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t_begin = blockIdx.x * p.tpb;
  const int t_end = min(t_begin + p.tpb, p.n_tiles);
  const int nc = blockIdx.y;  // this block's N chunk
  WeightRing<NT> wr;
  wr.ring = smem;
  // chunk nc's columns of the packed chunk that holds them: step s's NT x
  // 32 bytes are one run there
  wr.w = p.wp + (static_cast<long long>(nc * NT / p.pack_n) * p.ksteps_pad *
                     p.pack_n +
                 nc * NT % p.pack_n) *
                    K_STEP;
  wr.full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  wr.empty = wr.full + kMaxRing;
  wr.stages = p.ksteps_pad / StageSteps<NT>::value;  // a tile
  wr.total = p.resident ? wr.stages : wr.stages * (t_end - t_begin);
  wr.slots = p.ring;
  wr.pack_n = p.pack_n;
  float* s_scale = reinterpret_cast<float*>(smem + p.sb_off);
  float* s_bias = s_scale + NT;
  for (int c = tid; c < NT; c += CT) {
    const int col = nc * NT + c;
    s_scale[c] = col < p.N ? p.scale[col] : 0.0f;
    s_bias[c] = col < p.N && p.bias ? p.bias[col] : 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(&wr.full[s], 1);
      mbar_init(&wr.empty[s], CT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(p.ring, wr.total); ++i) wr.issue(i, true);
  }
  __syncthreads();

  // the first tile's extended tile, while the weight lands; a block that
  // walks tiles keeps two, this tile's and the next's
  const int tile_bytes = p.CB * 2 * p.rows * 16;
  unsigned char* tiles = smem + p.q_off;
  if (p.vec == 8)
    load_rows<8, CT>(p, tiles, t_begin * BM - p.halo, 0, p.rows, tid);
  else if (p.vec == 2)
    load_rows<2, CT>(p, tiles, t_begin * BM - p.halo, 0, p.rows, tid);
  else
    load_rows<1, CT>(p, tiles, t_begin * BM - p.halo, 0, p.rows, tid);
  const int wrow = (warp >> 2) * 64 * MT;   // the warpgroup's rows
  const int row0 = wrow + (warp & 3) * 16;  // the warp's rows, first tile
  const unsigned ring_base = smem_u32(smem);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(
      smem + p.stage_off + warp * kStageBytes);
  Mma<NT, MT> mma;
  int i = 0, prev = -1, cur = 0;
  int slot = 0;          // ring slot and phase of stage i (streamed)
  unsigned phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int m0 = t * BM;
    const bool more = t + 1 < t_end;
    unsigned char* qa = tiles + cur * tile_bytes;
    unsigned pf[PF];
    if (more) {
      const int P0 = m0 + BM - p.halo;
      if (p.vec == 8)
        Prefetch<8, CT, BM, PF>::load(p, P0, tid, pf);
      else if (p.vec == 2)
        Prefetch<2, CT, BM, PF>::load(p, P0, tid, pf);
      else
        Prefetch<1, CT, BM, PF>::load(p, P0, tid, pf);
    }
    // every row of this tile is in place; every warp is past the
    // previous tile's MMAs, whose tile the next one's rows overwrite
    __syncthreads();
    unsigned v0 = ~0u, v1 = ~0u;
    if constexpr (!Mma<NT, MT>::SS) {
      v0 = valid_taps(p, m0 + row0 + (lane >> 2));
      v1 = valid_taps(p, m0 + row0 + (lane >> 2) + 8);
    }
    StepIter it = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int k = 0; k < NT / 2; ++k) mma.acc[mt][k] = 0;
    const unsigned qa_u32 = smem_u32(qa);
    // two stages a turn, one register set each (the second turn's branch
    // is on a value of the block's, not the thread's)
    for (int st = 0; st < wr.stages; st += 2) {
      int sl = p.resident ? st : slot;
      unsigned ph = p.resident ? 0u : phase;
      mma.stage(0, p, qa_u32, row0, wrow, lane, v0, v1, it, sl, ph, i,
                ring_base, wr, prev, tid);
      ++i;
      if (++slot == p.ring) {
        slot = 0;
        phase ^= 1u;
      }
      if (st + 1 == wr.stages) break;
      sl = p.resident ? st + 1 : slot;
      ph = p.resident ? 0u : phase;
      mma.stage(1, p, qa_u32, row0, wrow, lane, v0, v1, it, sl, ph, i,
                ring_base, wr, prev, tid);
      ++i;
      if (++slot == p.ring) {
        slot = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(mma.acc[mt]);
    fence_regs(mma.a[0]);
    fence_regs(mma.a[1]);
    if (prev >= 0) wr.release(prev, tid);
    prev = -1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      epilogue<NT>(mma.acc[mt], stage, s_scale, s_bias, p,
                   m0 + row0 + mt * 64, nc * NT, lane);
    if (more) {
      unsigned char* next = tiles + (cur ^ 1) * tile_bytes;
      copy_halo<CT, BM>(p, qa, next, tid);
      if (p.vec == 8)
        Prefetch<8, CT, BM, PF>::store(p, next, tid, pf);
      else if (p.vec == 2)
        Prefetch<2, CT, BM, PF>::store(p, next, tid, pf);
      else
        Prefetch<1, CT, BM, PF>::store(p, next, tid, pf);
    }
    cur ^= 1;
  }
}

// The kernel's tilings, indexed by FusedArgs.tile on this route: (BM, NT);
// one warpgroup a 64 rows up to 128, and two warpgroups of two m64 tiles
// each at 256 (NT <= 64 only).  ops/int8_conv.py reads this table (not
// built).
struct WgTiling {
  int bm, bn;
};
constexpr WgTiling kWgTilings[] = {
    {64, 32},  {128, 32},  {256, 32},  {64, 64},  {128, 64},
    {256, 64}, {64, 128},  {128, 128}, {64, 256}, {128, 256},
};
constexpr int kNumWgTilings = sizeof(kWgTilings) / sizeof(kWgTilings[0]);

// mul, shr with n / d == umulhi(n, mul) >> shr for 0 <= n < 2^31 and
// d > 1: mul = ceil(2^(31 + l) / d) < 2^32 and shr = l - 1, l = ceil(log2 d)
void magic_of(int d, unsigned& mul, unsigned& shr) {
  if (d <= 1) {
    mul = 0;
    shr = 0;
    return;
  }
  int log2d = 31 - __builtin_clz(static_cast<unsigned>(d));
  log2d += (d & (d - 1)) != 0;
  const unsigned long long p2 = 1ULL << (31 + log2d);
  mul = static_cast<unsigned>((p2 + d - 1) / d);
  shr = static_cast<unsigned>(log2d - 1);
}

template <int I = 0>
int launch_wgmma(int tile, const WgParams& p, int smem, cudaStream_t s) {
  if constexpr (I == kNumWgTilings) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (tile != I) return launch_wgmma<I + 1>(tile, p, smem, s);
    constexpr WgTiling t = kWgTilings[I];
    constexpr int WGS = t.bm >= 128 ? 2 : 1;
    constexpr int MT = t.bm / 64 / WGS;
    // above 48 KB of dynamic shared memory only by the attribute: set
    // once a device
    static unsigned configured = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
    if (!(configured >> dev & 1u)) {
      err = cudaFuncSetAttribute(int8_conv_wgmma_kernel<t.bn, WGS, MT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured |= 1u << dev;
    }
    // a block walks tiles only where its prefetch fits its registers
    const int cpr = p.CB * K_STEP / p.vec;
    const int words = p.vec == 8 ? 4 : 1;
    if (p.tpb > 1 && ((t.bm * cpr + WGS * 128 - 1) / (WGS * 128) * words >
                          kPrefetchWords * MT ||
                      !p.resident || p.N > t.bn))
      return static_cast<int>(cudaErrorInvalidValue);
    if (p.pack_n != t.bn && p.pack_n != 2 * t.bn)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((p.n_tiles + p.tpb - 1) / p.tpb),
                    static_cast<unsigned>((p.N + t.bn - 1) / t.bn));
    int8_conv_wgmma_kernel<t.bn, WGS, MT><<<grid, WGS * 128, smem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// The arguments of a fused launch other than the activation and output
// pointers and the stream, packed by the wrapper once per layer and input
// layout (ops/int8_conv.FusedArgs mirrors it field for field; the same
// struct as csrc/int8_conv.cu's).
struct FusedArgs {
  long long sN, sC, sH, sW;  // the activation's element strides
  const void* w;             // (n_pad, k_pad) int8 weight
  const void* scale;         // float32, cout of them
  const void* bias;          // float32, cout of them, or null
  int dtype;                 // 0 float32, 1 bfloat16
  int batch, C, H, W, kh, kw, sh, sw, ph, pw, Ho, Wo;
  int n_pad, k_pad, cout;
  float inv;                 // 1 / s_a as a float32
  int tile, route;
  const void* w_packed;      // the weight as pack_wgmma_weight lays it out
  int pack_n;                // its chunk width
  int ring;                  // weight stages in shared memory
  int tiles_per_block;       // consecutive M tiles a block walks
};

// The int8 conv of one layer on this route: a dense channels-last bf16
// (batch, C, H, W) activation x (16-byte aligned), a stride-1 conv with an
// odd kh x kw kernel of at most 32 taps and ph = kh / 2, pw = kw / 2, the
// weight packed by pack_wgmma_weight at chunk width pack_n (NT or 2 NT of
// tiling `tile` of kWgTilings), ring stages of the weight in shared
// memory, tiles_per_block consecutive M tiles a block (more than one only
// where the prefetch of a tile's rows fits kPrefetchWords, the ring holds
// every stage and cout fits one chunk)
// -> the (batch*H*W, cout) bf16 output.  Shared memory: ring stages of
// StageSteps K steps of NT x 32 bytes, the extended tile (two where a
// block walks tiles) of ceil(C / 32) planes of BM + 2 * halo 32-byte rows
// (halo = ph * Wp + pw, Wp = W + 2 pw where NT <= 64, else W),
// kStageBytes a warp, the chunk's NT scales and biases, the barriers; at
// most kMaxSmem.  Returns the cudaError_t of the launch.
extern "C" int int8_conv_wgmma_launch(const void* x, void* out,
                                      const FusedArgs* a, void* stream) {
  if (a->tile < 0 || a->tile >= kNumWgTilings)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgTiling t = kWgTilings[a->tile];
  const int C = a->C, H = a->H, W = a->W, kh = a->kh, kw = a->kw;
  const long long M = static_cast<long long>(a->batch) * H * W;
  const bool dense = a->sC == 1 && (W == 1 || a->sW == C) &&
                     (H == 1 || a->sH == static_cast<long long>(W) * C) &&
                     (a->batch == 1 ||
                      a->sN == static_cast<long long>(H) * W * C);
  if (a->dtype != 1 || !dense || a->sh != 1 || a->sw != 1 || kh % 2 != 1 ||
      kw % 2 != 1 || a->ph != kh / 2 || a->pw != kw / 2 || kh * kw > 32 ||
      a->Ho != H || a->Wo != W || M < 1 || M > 0x7fffffffLL - 256 ||
      a->cout < 1 || C < 1 || a->w_packed == nullptr || a->ring < 1 ||
      a->ring > kMaxRing || a->tiles_per_block < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WgParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wp = static_cast<const int8_t*>(a->w_packed);
  p.scale = static_cast<const float*>(a->scale);
  p.bias = static_cast<const float*>(a->bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.C = C;
  p.CB = (C + K_STEP - 1) / K_STEP;
  p.H = H;
  p.W = W;
  p.kh = kh;
  p.kw = kw;
  const bool ss = t.bn <= 64;  // Mma<NT, MT>::SS
  p.pad_h = ss ? a->ph : 0;
  p.pad_w = ss ? a->pw : 0;
  p.Hp = H + 2 * p.pad_h;
  p.Wp = W + 2 * p.pad_w;
  magic_of(p.Wp, p.wp_mul, p.wp_shr);
  magic_of(p.Hp * p.Wp, p.hw_mul, p.hw_shr);
  p.halo = a->ph * p.Wp + a->pw;
  const long long Mp = static_cast<long long>(a->batch) * p.Hp * p.Wp;
  if (Mp > 0x7fffffffLL - 1024) return static_cast<int>(cudaErrorInvalidValue);
  p.Mp = static_cast<int>(Mp);
  p.N = a->cout;
  p.ksteps = kh * kw * p.CB;
  p.ksteps_pad = (p.ksteps + kStepAlign - 1) / kStepAlign * kStepAlign;
  p.pack_n = a->pack_n;
  p.ring = a->ring;
  const int sps = t.bn >= 256 ? 2 : 4;  // StageSteps
  p.resident = p.ring * sps >= p.ksteps_pad;
  p.tpb = a->tiles_per_block;
  p.n_tiles = static_cast<int>((Mp + t.bm - 1) / t.bm);
  p.rows = t.bm + 2 * p.halo;
  p.vec = C % 8 == 0 ? 8 : C % 2 == 0 ? 2 : 1;
  p.inv = a->inv;
  if (!p.resident && p.ring < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long ring_bytes =
      static_cast<long long>(p.ring) * sps * t.bn * K_STEP;
  const long long q_bytes = static_cast<long long>(p.tpb > 1 ? 2 : 1) *
                            p.rows * p.CB * K_STEP;
  const int warps = t.bm >= 128 ? 8 : 4;
  const long long smem = ring_bytes + q_bytes + warps * kStageBytes +
                         2 * t.bn * 4 + 2 * kMaxRing * 8;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int cpr = p.CB * K_STEP / p.vec;
  p.cpr_log = (cpr & (cpr - 1)) ? -1 : __builtin_ctz(cpr);
  if (p.tpb > 1 && p.cpr_log < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.q_off = static_cast<int>(ring_bytes);
  p.stage_off = static_cast<int>(ring_bytes + q_bytes);
  p.sb_off = p.stage_off + warps * kStageBytes;
  p.bar_off = p.sb_off + 2 * t.bn * 4;
  return launch_wgmma(a->tile, p, static_cast<int>(smem),
                      static_cast<cudaStream_t>(stream));
}
