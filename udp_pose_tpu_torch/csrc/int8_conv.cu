// The port's int8 (w8a8) convolution, the JAX package's PTQ serving conv
// (udp_pose_tpu/models/quantize.py, _quantized_conv :188-218): XLA's
// int8 conv with the activation quantise before it and the dequant
// epilogue after it fused.  It replaces no Pallas kernel.
//
//   int8_conv_fused_kernel,  the whole conv in one launch (the serving
//   int8_conv_shift_kernel   path since slice 6): an implicit GEMM over
//                            M = N*Ho*Wo output pixels x Cout that
//                            quantises the activation as it loads it and
//                            applies the epilogue in registers (the
//                            launcher int8_conv_fused_launch picks one);
//   quant_im2col_kernel      activation quantise (:203-204 there),
//                            x_i8 = clip(rint(x * inv_s_a), -127, 127),
//                            written as the (M, K_pad) patch matrix of the
//                            integer GEMM, taps in (kh, kw, cin) order;
//   dequant_epilogue_kernel  the dequant epilogue (:214-218 there),
//                            out = cast(float(acc) * scale[c] + bias[c]).
//
// The last two, with torch._int_mm (cuBLASLt) between them, are the
// three-step path of slice 5.  No serving path runs it any more; the card
// checks hold the fused kernel against it bit for bit and time the two.
//
// Rounding is the JAX package's to the bit: rintf rounds half to even
// (jnp.round), every multiply and add is an explicit __fmul_rn/__fadd_rn
// so that nvcc contracts nothing into an FMA, float(acc) rounds to
// nearest, and the cast to bf16 rounds to nearest even.  Integer sums are
// exact in any order (|acc| <= 127^2 * K < 2^31 for every K the nets
// have), so the fused kernel equals the three steps at every shape.
//
// Bound on this card: bytes.  The three steps move the activation, the
// (M, K_pad) int8 patches twice, the int32 accumulators twice and the
// output: ~127 GB for a w32 fold forward (B=256).  The fused kernel keeps
// patches and accumulators on chip, so the least it moves is the
// activation once, the weight and the output: ~20.8 GB, against 3.9 T
// int8 operations that the tensor cores do in ~2 ms.  What it spends
// instead is issue slots: every int8 element it quantises costs ~6
// instructions (load, multiply, clamp, round, pack) and a 3x3 conv would
// quantise each activation 9 times.  Its design:
//   * Two ways to fill the int8 A tile (shared memory, 32-byte rows whose
//     16-byte halves are XOR-swizzled so that ldmatrix reads without bank
//     conflicts), both quantising on load in registers:
//       - the shift kernel, for 3x3 (odd kh x kw) stride-1 "same" convs
//         of a dense channels-last bf16 activation with C % 32 == 0, most
//         of HRNet: in linear pixel order every tap's rows are one
//         extended tile's rows shifted by i * W + j, so each pixel of the
//         block and its halo is quantised once for all taps, and a row
//         whose tap falls in the padding is zeroed in registers;
//       - the gather kernel, for the rest: each K tile of 32 gathers its
//         taps, 16-byte cp.async loads of 8 channels where the channel
//         stride is 1 and C % 8 == 0 (a chunk never crosses a tap), an
//         element-by-element gather otherwise (the C = 3 stems, NCHW
//         input).
//     Padding, M tails and K tails are zeros, never loads.  The raw
//     activation tiles go through a ring of cp.async stages while the
//     MMAs of earlier tiles run.
//   * B (the (N_pad, K_pad) int8 weight, K_pad a multiple of the K tile):
//     cp.async into a ring of stages, rows past N_pad zero-filled.
//   * mma.sync m16n8k32 s8 x s8 -> s32 (operands by ldmatrix), int32
//     accumulators in registers.
//   * The epilogue in registers (scale, bias, cast), staged through shared
//     memory so that each row of the (M, Cout) NHWC output is written with
//     16-byte stores (a scalar tail where Cout is not a multiple of 16
//     bytes).  No int32 matrix and no patch matrix reach device memory.
//   * Tilings of 32, 64 or 128 output channels by Cout, of 64 to 256 rows
//     (ops/int8_conv.fused_tiling).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t quantize(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(q));
}

// One thread writes 8 consecutive bytes of a patch row (K_pad % 8 == 0).
// Rows >= M and columns >= K are zeros: the GEMM's padding.
template <typename T>
__global__ void quant_im2col_kernel(
    const T* __restrict__ x, long long sN, long long sC, long long sH,
    long long sW, int C, int H, int W, int kw, int sh, int sw, int ph,
    int pw, int Ho, int Wo, int K, int k_pad, long long M, long long rows,
    float inv, int8_t* __restrict__ out) {
  const int groups = k_pad / 8;
  const long long total = rows * groups;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += step) {
    const long long row = t / groups;
    const int k0 = static_cast<int>(t - row * groups) * 8;
    union {
      int8_t b[8];
      uint2 v;
    } pack;
    pack.v = make_uint2(0u, 0u);
    if (row < M && k0 < K) {
      const long long hw = static_cast<long long>(Ho) * Wo;
      const long long n = row / hw;
      const int r = static_cast<int>(row - n * hw);
      const int oh = r / Wo;
      const int ow = r - oh * Wo;
      const T* xn = x + n * sN;
      const int tap = k0 / C;
      int c = k0 - tap * C;
      int i = tap / kw;
      int j = tap - i * kw;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (k0 + e < K) {
          const int y = oh * sh - ph + i;
          const int xx = ow * sw - pw + j;
          if (y >= 0 && y < H && xx >= 0 && xx < W) {
            pack.b[e] = quantize(
                to_float(xn[c * sC + y * sH + xx * sW]), inv);
          }
        }
        if (++c == C) {
          c = 0;
          if (++j == kw) {
            j = 0;
            ++i;
          }
        }
      }
    }
    reinterpret_cast<uint2*>(out)[t] = pack.v;
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const float* v);
template <>
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  union {
    __nv_bfloat16 h[4];
    uint2 u;
  } pack;
#pragma unroll
  for (int e = 0; e < 4; ++e) pack.h[e] = __float2bfloat16_rn(v[e]);
  *reinterpret_cast<uint2*>(dst) = pack.u;
}

__device__ __forceinline__ float dequant(int a, float s, const float* bias,
                                         int c) {
  const float y = __fmul_rn(__int2float_rn(a), s);
  return bias ? __fadd_rn(y, bias[c]) : y;
}

// (rows, cols) outputs from the (>= rows, ld) int32 accumulators.  With
// vec (cols % 4 == 0 and ld % 4 == 0) a thread does 4 neighbouring
// columns with one 16-byte load; otherwise one output a thread.
template <typename T>
__global__ void dequant_epilogue_kernel(
    const int* __restrict__ acc, long long rows, int cols, int ld,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int vec, T* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    const int groups = cols / 4;
    const long long total = rows * groups;
    for (long long t = first; t < total; t += step) {
      const long long row = t / groups;
      const int c0 = static_cast<int>(t - row * groups) * 4;
      const int4 a = *reinterpret_cast<const int4*>(acc + row * ld + c0);
      const int av[4] = {a.x, a.y, a.z, a.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = dequant(av[e], scale[c0 + e], bias, c0 + e);
      store4(out + row * cols + c0, v);
    }
  } else {
    const long long total = rows * cols;
    for (long long t = first; t < total; t += step) {
      const long long row = t / cols;
      const int c = static_cast<int>(t - row * cols);
      from_float(dequant(acc[row * ld + c], scale[c], bias, c), out + t);
    }
  }
}

int blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  const long long cap = 132LL * 64;  // grid-stride beyond 64 blocks an SM
  if (b > cap) b = cap;
  return static_cast<int>(b < 1 ? 1 : b);
}

// ------------------------------------------------------------ fused conv

constexpr int K_TILE = 32;  // bytes of K a tile: one m16n8k32 step

struct FusedParams {
  const void* x;
  long long sN, sC, sH, sW;
  int C, H, W, kh, kw, sh, sw, ph, pw, Wo, K, k_pad;
  int HoWo, M;  // M < 2^31 (the launcher checks)
  const int8_t* w;
  int n_pad, N;
  int taps;  // kh * kw where K tiles go channel block by channel block
             // (C % 32 == 0), else 0: K tiles in weight order
  const float* scale;
  const float* bias;
  float inv;
  void* out;
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Byte offset of 16-byte half `chunk` of `row` in a tile of 32-byte rows.
// Rows 4-7 of every 8 swap their halves, so that the 8 rows one ldmatrix
// phase reads lie in 8 different groups of 4 banks.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * K_TILE + ((chunk ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, bypassing L1; `bytes` < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 channels of T as 16-byte words, and their float values
template <typename T>
struct Vec8;
template <>
struct Vec8<float> {
  static constexpr int WORDS = 2;
  __device__ static void to_float(const uint4 (&w)[2], float* v) {
    const unsigned u[8] = {w[0].x, w[0].y, w[0].z, w[0].w,
                           w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(u[e]);
  }
};
template <>
struct Vec8<__nv_bfloat16> {
  static constexpr int WORDS = 1;
  __device__ static void to_float(const uint4 (&w)[1], float* v) {
    const unsigned u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // little-endian: the low half first
      v[2 * e] = __uint_as_float(u[e] << 16);
      v[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a,
                                       float b) {
  union {
    __nv_bfloat16 h[2];
    unsigned u;
  } pack;
  pack.h[0] = __float2bfloat16_rn(a);
  pack.h[1] = __float2bfloat16_rn(b);
  *reinterpret_cast<unsigned*>(dst) = pack.u;
}

// Eight activations -> eight int8, as quantize() does each: clamping to
// +-127 first and rounding after gives the same integer (rint is monotone
// and +-127 are integers; NaN clamps to -127 either way), and adding
// 1.5 * 2^23 rounds a float of magnitude <= 127 to the nearest integer,
// ties to even, leaving it in the low byte of the sum's bits.  All at the
// full float rate, where rintf and the float-to-int conversion are not.
__device__ __forceinline__ uint2 quantize8(const float* v, float inv) {
  unsigned b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float q = fminf(fmaxf(__fmul_rn(v[e], inv), -127.0f), 127.0f);
    b[e] = __float_as_uint(__fadd_rn(q, 12582912.0f));
  }
  return make_uint2(
      __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                  __byte_perm(b[2], b[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(b[4], b[5], 0x0040),
                  __byte_perm(b[6], b[7], 0x0040), 0x5410));
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's MMAs of one K tile: A rows a_row0 + [0, WM) of the int8 A
// tile sa, B rows wn0 + [0, WN) of sb (both 32-byte rows, swizzled).
// keep[mi][h] ANDs the A fragment of rows g (h = 0) and g + 8 (h = 1) of
// m16 tile mi: all ones, or zero for a row whose tap lies in the padding.
template <int MI, int NJ>
__device__ __forceinline__ void mma_tile(int (&acc)[MI][NJ][4],
                                         const unsigned char* sa,
                                         int a_row0, const unsigned char* sb,
                                         int wn0, int lane,
                                         const unsigned (&keep)[MI][2]) {
  unsigned a[MI][4], b[NJ][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    ldmatrix_x4(a[mi], smem_addr(sa + swz(a_row0 + mi * 16 + (lane & 15),
                                          lane >> 4)));
    a[mi][0] &= keep[mi][0];
    a[mi][2] &= keep[mi][0];
    a[mi][1] &= keep[mi][1];
    a[mi][3] &= keep[mi][1];
  }
#pragma unroll
  for (int nj = 0; nj < NJ; nj += 2) {
    unsigned r[4];
    ldmatrix_x4(r, smem_addr(sb + swz(wn0 + nj * 8 + (lane & 7) +
                                          ((lane >> 4) << 3),
                                      (lane >> 3) & 1)));
    b[nj][0] = r[0];
    b[nj][1] = r[1];
    b[nj + 1][0] = r[2];
    b[nj + 1][1] = r[3];
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
      mma_s8(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
}

// The epilogue in registers: accumulator (row g [+8], cols 2t, 2t+1) of
// each m16n8 tile -> cast(float(acc) * scale + bias), staged in shared
// memory (smem, free once every warp is past the last MMA), then the
// block's rows of the (M, N) output, 16 bytes a thread (a scalar tail
// where N is not a multiple of 16 bytes).  The scale and bias of the
// thread's columns are loaded first, all at once.
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__device__ __forceinline__ void epilogue(
    const int (&acc)[BM / WARPS_M / 16][BN / WARPS_N / 8][4],
    unsigned char* smem, const FusedParams& p, int m0, int n0) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MI = WM / 16;
  constexpr int NJ = WN / 8;
  constexpr int LDO = BN + 8;  // staging row in elements (+16 / +32 bytes)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp % WARPS_M) * WM;
  const int wn0 = (warp / WARPS_M) * WN;
  T* so = reinterpret_cast<T*>(smem);
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float sc[NJ][2], bi[NJ][2];
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + wn0 + nj * 8 + 2 * t4 + e;
      sc[nj][e] = gn < p.N ? __ldg(p.scale + gn) : 0.0f;
      bi[nj][e] = gn < p.N && p.bias ? __ldg(p.bias + gn) : 0.0f;
    }
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj) {
    const int col = wn0 + nj * 8 + 2 * t4;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__int2float_rn(acc[mi][nj][2 * h + e]), sc[nj][e]);
          if (p.bias) v[e] = __fadd_rn(v[e], bi[nj][e]);
        }
        store2(so + (wm0 + mi * 16 + g + 8 * h) * LDO + col, v[0], v[1]);
      }
  }
  __syncthreads();

  constexpr int VPC = 16 / static_cast<int>(sizeof(T));
  constexpr int CPR = BN / VPC;
  T* out = static_cast<T*>(p.out);
  const bool vec_out = p.N % VPC == 0;
  for (int q = tid; q < BM * CPR; q += THREADS) {
    const int r = q / CPR;
    const int cc = (q - r * CPR) * VPC;
    const int m = m0 + r;
    const int gn = n0 + cc;
    if (m >= p.M || gn >= p.N) continue;
    const T* src = so + r * LDO + cc;
    T* dst = out + static_cast<long long>(m) * p.N + gn;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < VPC && gn + e < p.N; ++e) dst[e] = src[e];
    }
  }
}

// One (BM, BN) tile of the (M, N) output a block, WARPS_M x WARPS_N warps
// of (BM / WARPS_M, BN / WARPS_N) each.  A thread owns 8 K-elements of
// BM / 32 A rows of every K tile (the same 8 of each row).  K tiles go
// through a ring of STAGES: the activation as loaded (raw, x's dtype) and
// the weight tile; each thread quantises its own raw chunks of a tile into
// one of two int8 A tiles, then one barrier, then the MMAs, while the next
// STAGES - 1 tiles are in flight.  VEC (channels-last, C % 8 == 0): the
// raw chunks are cp.async copies, zero-filled where a tap is padding;
// otherwise they are gathered element by element and stored.
template <typename T, bool VEC, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    int8_conv_fused_kernel(const FusedParams p) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MI = WM / 16;                // m16 tiles a warp
  constexpr int NJ = WN / 8;                 // n8 tiles a warp
  constexpr int ROW_STEP = THREADS / 4;      // 4 threads cover a K tile row
  constexpr int A_ROWS = BM / ROW_STEP;      // A rows a thread owns
  constexpr int WORDS = Vec8<T>::WORDS;      // 16-byte words a raw chunk
  constexpr int STAGES = sizeof(T) == 2 ? 3 : 2;
  constexpr int RAW_ROW = K_TILE * static_cast<int>(sizeof(T));
  constexpr int RAW_BYTES = BM * RAW_ROW;
  constexpr int B_BYTES = BN * K_TILE;
  constexpr int AQ_BYTES = BM * K_TILE;
  constexpr int B_OFF = STAGES * RAW_BYTES;
  constexpr int AQ_OFF = B_OFF + STAGES * B_BYTES;
  constexpr int LDO = BN + 8;  // staging row in elements (+16 / +32 bytes)
  constexpr int SMEM =
      cmax(AQ_OFF + 2 * AQ_BYTES, BM * LDO * static_cast<int>(sizeof(T)));
  static_assert(WM % 16 == 0 && NJ % 2 == 0 && BM % ROW_STEP == 0,
                "unsupported tiling");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
  __shared__ __align__(128) unsigned char smem[SMEM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kc = tid & 3;  // this thread's chunk of each of its A rows
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wm0 = (warp % WARPS_M) * WM;
  const int wn0 = (warp / WARPS_M) * WN;
  const T* __restrict__ x = static_cast<const T*>(p.x);

  // the output pixel of each A row this thread owns: its tap (0, 0) as an
  // element offset and input row and column; past M, a row whose every
  // tap lies in the padding
  long long roff[A_ROWS];
  int riy[A_ROWS], rix[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + (tid >> 2) + i * ROW_STEP;
    roff[i] = 0;
    riy[i] = -(1 << 30);
    rix[i] = 0;
    if (m < p.M) {
      const int n = m / p.HoWo;
      const int r = m - n * p.HoWo;
      const int oh = r / p.Wo;
      riy[i] = oh * p.sh - p.ph;
      rix[i] = (r - oh * p.Wo) * p.sw - p.pw;
      roff[i] = n * p.sN + riy[i] * p.sH + rix[i] * p.sW;
    }
  }

  auto inside = [&](int y, int xx) {
    return static_cast<unsigned>(y) < static_cast<unsigned>(p.H) &&
           static_cast<unsigned>(xx) < static_cast<unsigned>(p.W);
  };
  auto raw_chunk = [&](int stage, int i) {
    return smem + stage * RAW_BYTES + ((tid >> 2) + i * ROW_STEP) * RAW_ROW +
           kc * 8 * static_cast<int>(sizeof(T));
  };

  // where this thread's chunk of the next K tile starts: tap (ti, tj),
  // channel c.  With p.taps the K tiles go tap by tap through the same
  // 32 channels, then to the next 32, so that the taps' reads of a pixel
  // follow one another while it is in L2; otherwise in weight order.
  // Integer sums are exact in any order.
  int ti, tj, c;
  {
    const int tap = p.taps ? 0 : kc * 8 / p.C;
    c = p.taps ? kc * 8 : kc * 8 - tap * p.C;
    ti = tap / p.kw;
    tj = tap - ti * p.kw;
  }
  auto advance = [&]() {
    if (p.taps) {
      if (++tj == p.kw) {
        tj = 0;
        if (++ti == p.kh) {
          ti = 0;
          c += K_TILE;
        }
      }
    } else {
      for (c += K_TILE; c >= p.C; c -= p.C)
        if (++tj == p.kw) {
          tj = 0;
          ++ti;
        }
    }
  };

  // the next K tile of this thread's A rows and of the weight into ring
  // stage `stage`
  auto issue = [&](int stage) {
    const int k0 = (ti * p.kw + tj) * p.C + c;
    const int k_start = k0 - kc * 8;  // the tile's first K column
    if constexpr (VEC) {
      const bool kin = k0 < p.K;
      const long long toff = ti * p.sH + tj * p.sW + c;
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        // one address a row, selected (no branch): x itself where the tap
        // is padding and nothing is read
        const bool in = kin && inside(riy[i] + ti, rix[i] + tj);
        const long long off = roff[i] + toff;
        const T* src = x + (in ? off : 0LL);
        unsigned char* dst = raw_chunk(stage, i);
#pragma unroll
        for (int w = 0; w < WORDS; ++w)
          cp_async16(smem_addr(dst + 16 * w), src + w * (8 / WORDS),
                        in ? 16 : 0);
      }
    } else {
      union {
        T v[8];
        uint4 w[WORDS];
      } chunk[A_ROWS];
      int ei = ti, ej = tj, ec = c;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool kin = k0 + e < p.K;
        const long long toff = ei * p.sH + ej * p.sW + ec * p.sC;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i)
          chunk[i].v[e] = (kin && inside(riy[i] + ei, rix[i] + ej))
                              ? x[roff[i] + toff]
                              : T(0.0f);
        if (++ec == p.C) {
          ec = 0;
          if (++ej == p.kw) {
            ej = 0;
            ++ei;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        uint4* dst = reinterpret_cast<uint4*>(raw_chunk(stage, i));
#pragma unroll
        for (int q = 0; q < WORDS; ++q) dst[q] = chunk[i].w[q];
      }
    }
    advance();
    unsigned char* sb = smem + B_OFF + stage * B_BYTES;
#pragma unroll
    for (int i = 0; i < (2 * BN + THREADS - 1) / THREADS; ++i) {
      const int q = tid + i * THREADS;
      if (q < 2 * BN) {
        const int n = q >> 1;
        const int half = q & 1;
        const int gn = n0 + n;
        const bool in = gn < p.n_pad;
        const int8_t* src =
            p.w + (in ? static_cast<long long>(gn) * p.k_pad +
                            k_start + half * 16
                      : 0);
        cp_async16(smem_addr(sb + swz(n, half)), src, in ? 16 : 0);
      }
    }
  };

  // this thread's raw chunks of a stage -> the int8 A tile
  auto quantise = [&](int stage, unsigned char* sa) {
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      uint4 w[WORDS];
#pragma unroll
      for (int q = 0; q < WORDS; ++q)
        w[q] = reinterpret_cast<const uint4*>(raw_chunk(stage, i))[q];
      float v[8];
      Vec8<T>::to_float(w, v);
      const int row = (tid >> 2) + i * ROW_STEP;
      *reinterpret_cast<uint2*>(sa + swz(row, kc >> 1) + (kc & 1) * 8) =
          quantize8(v, p.inv);
    }
  };

  int acc[MI][NJ][4] = {};
  unsigned keep[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) keep[mi][0] = keep[mi][1] = ~0u;

  // the ring: tile kt is quantised once this thread's copies of it have
  // landed; after the barrier every copy of it has, and stage kt - 1 is
  // free for tile kt + STAGES - 1.  One commit group a tile (empty past
  // the last), so that wait_group STAGES - 2 always means tile kt.
  const int k_tiles = p.k_pad / K_TILE;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt % STAGES;
    unsigned char* sa = smem + AQ_OFF + (kt & 1) * AQ_BYTES;
    cp_async_wait_n<STAGES - 2>();
    quantise(stage, sa);
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < k_tiles) issue(next % STAGES);
    cp_async_commit();
    mma_tile<MI, NJ>(acc, sa, wm0, smem + B_OFF + stage * B_BYTES, wn0, lane,
                     keep);
  }
  cp_async_wait_n<0>();
  __syncthreads();
  epilogue<T, BM, BN, WARPS_M, WARPS_N>(acc, smem, p, m0, n0);
}

// Stride-1 "same" convs (odd kh x kw of 3 to 32 taps, ph = kh / 2, pw = kw / 2)
// of a dense channels-last bf16 activation with C % 32 == 0: most of
// HRNet's convs.  There the input pixel of output pixel m at tap (i, j) is
// m + (i - ph) * W + (j - pw) in the same linear order, so the A rows of
// every tap are the rows of one extended tile shifted by i * W + j.  For
// each block of 32 channels the block loads and quantises that tile once,
// the BM output pixels' inputs and a halo of ph * W + pw pixels on either
// side (the gather kernel quantises each pixel once a tap), and reads each
// tap's A fragments from it at the shifted rows; a row whose tap lies in
// the padding (which the linear order would wrap to the neighbouring
// image row or image) has its fragment zeroed in registers.  The raw tile
// of the next 32 channels and the weight tiles of the next STAGES - 1 taps
// are in flight meanwhile.  Blocks of twice the rows (8 warps) where there
// are enough of them: the halo and each block's fixed costs weigh less.
template <int BM, int BN, int WARPS_M, int WARPS_N, int EXT_MAX>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    int8_conv_shift_kernel(const FusedParams p) {
  using T = __nv_bfloat16;
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MI = WM / 16;
  constexpr int NJ = WN / 8;
  constexpr int ROW_STEP = THREADS / 4;  // 4 threads cover a 32-channel row
  constexpr int EXT_ROWS = EXT_MAX / ROW_STEP;  // extended rows a thread
  constexpr int STAGES = 4;  // weight tiles in the ring
  constexpr int RAW_ROW = K_TILE * static_cast<int>(sizeof(T));
  constexpr int RAW_BYTES = EXT_MAX * RAW_ROW;
  constexpr int QA_OFF = RAW_BYTES;
  constexpr int B_OFF = QA_OFF + EXT_MAX * K_TILE;
  constexpr int B_BYTES = BN * K_TILE;
  constexpr int LDO = BN + 8;
  constexpr int SMEM = cmax(B_OFF + STAGES * B_BYTES,
                            BM * LDO * static_cast<int>(sizeof(T)));
  static_assert(EXT_MAX % ROW_STEP == 0 && EXT_MAX >= BM, "extended tile");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
  __shared__ __align__(128) unsigned char smem[SMEM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kc = tid & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wm0 = (warp % WARPS_M) * WM;
  const int wn0 = (warp / WARPS_M) * WN;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int halo = p.ph * p.W + p.pw;
  const int ext = BM + 2 * halo;  // <= EXT_MAX (the launcher checks)
  const int q0 = m0 - halo;       // input pixel of extended row 0
  const int taps = p.kh * p.kw;
  const int blocks_c = p.C / K_TILE;
  const int steps = blocks_c * taps;

  // the raw extended tile of channel block cb (this thread's chunks)
  auto issue_ext = [&](int cb) {
#pragma unroll
    for (int k = 0; k < EXT_ROWS; ++k) {
      const int e = (tid >> 2) + k * ROW_STEP;
      if (e < ext) {
        const int q = q0 + e;
        const bool in = q >= 0 && q < p.M;
        const long long off =
            static_cast<long long>(q) * p.C + cb * K_TILE + kc * 8;
        cp_async16(
            smem_addr(smem + e * RAW_ROW + kc * 16),
            x + (in ? off : 0LL), in ? 16 : 0);
      }
    }
  };
  auto quantise_ext = [&]() {
#pragma unroll
    for (int k = 0; k < EXT_ROWS; ++k) {
      const int e = (tid >> 2) + k * ROW_STEP;
      if (e < ext) {
        const uint4 (&w)[1] = *reinterpret_cast<const uint4(*)[1]>(
            smem + e * RAW_ROW + kc * 16);
        float v[8];
        Vec8<T>::to_float(w, v);
        *reinterpret_cast<uint2*>(smem + QA_OFF + swz(e, kc >> 1) +
                                  (kc & 1) * 8) = quantize8(v, p.inv);
      }
    }
  };
  // the weight tile of the next step (tap bt of channel block bc)
  int bt = 0, bc = 0;
  auto issue_b = [&](int stage) {
    const int k_start = bt * p.C + bc * K_TILE;
    unsigned char* sb = smem + B_OFF + stage * B_BYTES;
#pragma unroll
    for (int i = 0; i < (2 * BN + THREADS - 1) / THREADS; ++i) {
      const int q = tid + i * THREADS;
      if (q < 2 * BN) {
        const int n = q >> 1;
        const int half = q & 1;
        const int gn = n0 + n;
        const bool in = gn < p.n_pad;
        const int8_t* src =
            p.w + (in ? static_cast<long long>(gn) * p.k_pad + k_start +
                            half * 16
                      : 0);
        cp_async16(smem_addr(sb + swz(n, half)), src, in ? 16 : 0);
      }
    }
    if (++bt == taps) {
      bt = 0;
      ++bc;
    }
  };

  int acc[MI][NJ][4] = {};
  // group 0 holds channel block 0's tile; the tile of block cb + 1 goes
  // with step cb * taps's weight tile, which is complete by step
  // (cb + 1) * taps because STAGES - 1 <= taps
  issue_ext(0);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) issue_b(st);
    cp_async_commit();
  }
  // while the first tiles load: the taps (bit i * kw + j) that lie inside
  // the image for rows g and g + 8 of each of this lane's m16 tiles (rows
  // 8 apart: the pixel walks on by 8 from one to the next).  Rows past M
  // read zeros or other images' pixels; they are never stored.
  unsigned valid[MI][2];
  {
    const int r = (m0 + wm0 + (lane >> 2)) % p.HoWo;
    int oh = r / p.Wo;
    int ow = r - oh * p.Wo;
    // the taps i (j) in [lo, hi] that keep the input row (column) inside
    auto span = [](int pos, int pad, int k, int size) {
      const int lo = max(pad - pos, 0);
      const int hi = min(k - 1, size - 1 - pos + pad);
      return lo > hi ? 0u : ((2u << hi) - 1u) & ~((1u << lo) - 1u);
    };
#pragma unroll
    for (int k = 0; k < 2 * MI; ++k) {
      const unsigned rows = span(oh, p.ph, p.kh, p.H);
      const unsigned cols = span(ow, p.pw, p.kw, p.W);
      unsigned bits = 0;
      for (int i = 0; i < p.kh; ++i)
        bits |= (0u - (rows >> i & 1u)) & (cols << (i * p.kw));
      valid[k >> 1][k & 1] = bits;
      for (ow += 8; ow >= p.Wo; ow -= p.Wo)
        if (++oh == p.H) oh = 0;
    }
  }
  int tap = 0, ti = 0, tj = 0, cb = 0;
  for (int st = 0; st < steps; ++st) {
    cp_async_wait_n<STAGES - 2>();
    if (tap == 0) {
      __syncthreads();  // every warp is past the previous block's MMAs
      quantise_ext();
    }
    __syncthreads();
    // the raw chunks this thread just quantised are free for the next
    // channel block's (one raw tile: each thread reads back only its own)
    if (tap == 0 && cb + 1 < blocks_c) issue_ext(cb + 1);
    if (st + STAGES - 1 < steps) issue_b((st + STAGES - 1) % STAGES);
    cp_async_commit();
    unsigned keep[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) keep[mi][h] = 0u - ((valid[mi][h] >> tap) & 1u);
    mma_tile<MI, NJ>(acc, smem + QA_OFF, wm0 + ti * p.W + tj,
                     smem + B_OFF + (st % STAGES) * B_BYTES, wn0, lane, keep);
    ++tap;
    if (++tj == p.kw) {
      tj = 0;
      ++ti;
    }
    if (tap == taps) {
      tap = ti = 0;
      ++cb;
    }
  }
  cp_async_wait_n<0>();
  __syncthreads();
  epilogue<T, BM, BN, WARPS_M, WARPS_N>(acc, smem, p, m0, n0);
}

// The fused kernel's tilings, indexed by the launcher's `tile`: (BLOCK_M,
// BLOCK_N, warps along M, warps along N).  ops/int8_conv.py reads this
// table and kMaxHalo from this file.  The 4-warp tilings come first and
// every route takes them; the 8-warp ones (a 4-warp tiling's block with
// twice the rows) are the shift kernel's only.  The 32-column tiling has
// none: at 256 x 32 the shift kernel was no faster on w32's convs.  The shift kernel's extended
// tile holds kMaxHalo rows (ph * W + pw) on each side of the block.
struct Tiling {
  int bm, bn, warps_m, warps_n;
};
constexpr Tiling kTilings[] = {
    {128, 32, 4, 1}, {128, 64, 2, 2}, {64, 128, 1, 4},
    {256, 64, 4, 2}, {128, 128, 2, 4},
};
constexpr int kNumTilings = sizeof(kTilings) / sizeof(kTilings[0]);
constexpr int kMaxHalo = 64;

// Launch tiling `tile` (searched from I on) by route: 0 the gather, 1
// 16-byte loads (VEC), 2 the shift kernel (bf16 only).
template <typename T, int I = 0>
int launch_fused(int tile, int route, const FusedParams& p, cudaStream_t s) {
  if constexpr (I == kNumTilings) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (tile != I) return launch_fused<T, I + 1>(tile, route, p, s);
    constexpr Tiling t = kTilings[I];
    constexpr int threads = t.warps_m * t.warps_n * 32;
    const dim3 grid(static_cast<unsigned>((p.M + t.bm - 1LL) / t.bm),
                    static_cast<unsigned>((p.N + t.bn - 1) / t.bn));
    if (route == 2) {
      if constexpr (sizeof(T) != 2) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        if (p.ph * p.W + p.pw > kMaxHalo)
          return static_cast<int>(cudaErrorInvalidValue);
        int8_conv_shift_kernel<t.bm, t.bn, t.warps_m, t.warps_n,
                               t.bm + 2 * kMaxHalo>
            <<<grid, threads, 0, s>>>(p);
      }
    } else if constexpr (threads == 128) {
      if (route == 1)
        int8_conv_fused_kernel<T, true, t.bm, t.bn, t.warps_m, t.warps_n>
            <<<grid, threads, 0, s>>>(p);
      else
        int8_conv_fused_kernel<T, false, t.bm, t.bn, t.warps_m, t.warps_n>
            <<<grid, threads, 0, s>>>(p);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the cudaError_t of the launch.
extern "C" int quant_im2col_launch(
    const void* x, int dtype, long long sN, long long sC, long long sH,
    long long sW, int C, int H, int W, int kh, int kw, int sh, int sw,
    int ph, int pw, int Ho, int Wo, int k_pad, long long M, long long rows,
    float inv, void* out, void* stream) {
  const int threads = 256;
  const long long work = rows * (k_pad / 8);
  const int blocks = blocks_for(work, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = kh * kw * C;
  int8_t* o = static_cast<int8_t*>(out);
  if (dtype == 0) {
    quant_im2col_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), sN, sC, sH, sW, C, H, W, kw, sh, sw,
        ph, pw, Ho, Wo, K, k_pad, M, rows, inv, o);
  } else if (dtype == 1) {
    quant_im2col_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sN, sC, sH, sW, C, H, W, kw,
        sh, sw, ph, pw, Ho, Wo, K, k_pad, M, rows, inv, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out_dtype: 0 float32, 1 bfloat16; bias may be null.
extern "C" int dequant_epilogue_launch(
    const void* acc, long long rows, int cols, int ld, const void* scale,
    const void* bias, int out_dtype, void* out, void* stream) {
  const int threads = 256;
  const int vec = (cols % 4 == 0 && ld % 4 == 0) ? 1 : 0;
  const long long work = vec ? rows * (cols / 4) : rows * cols;
  const int blocks = blocks_for(work, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(acc);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (out_dtype == 0) {
    dequant_epilogue_kernel<float><<<blocks, threads, 0, s>>>(
        a, rows, cols, ld, sc, b, vec, static_cast<float*>(out));
  } else if (out_dtype == 1) {
    dequant_epilogue_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        a, rows, cols, ld, sc, b, vec, static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The arguments of a fused launch other than the activation and output
// pointers and the stream, packed by the wrapper once per layer and input
// layout (ops/int8_conv.FusedArgs mirrors it field for field; the same
// struct as csrc/int8_conv_sm90.cu's, whose fields past `route` this
// launcher does not read).
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

// The whole int8 conv of one layer: the (batch, C, H, W) activation x
// (dtype 0 float32, 1 bfloat16; element strides sN, sC, sH, sW), the
// prepared (n_pad, k_pad) int8 weight, K in (kh, kw, cin) order and k_pad
// a multiple of 32, float32 scale and bias (bias may be null) of length
// cout -> the (batch*Ho*Wo, cout) output of x's dtype.  tile: the index of
// kTilings.  route 0: the scalar gather; 1: 16-byte
// activation loads (channel stride 1, C % 8 == 0, the other strides
// multiples of 8 elements, x 16-byte aligned); 2: the shift kernel (as 1,
// and bf16, dense channels-last, C % 32 == 0, stride 1, odd kh x kw of at
// most 32 taps, at least 3, with ph = kh / 2 and pw = kw / 2).  Returns
// the cudaError_t of the launch.
extern "C" int int8_conv_fused_launch(const void* x, void* out,
                                      const FusedArgs* a, void* stream) {
  FusedParams p;
  p.x = x;
  p.sN = a->sN;
  p.sC = a->sC;
  p.sH = a->sH;
  p.sW = a->sW;
  p.C = a->C;
  p.H = a->H;
  p.W = a->W;
  p.kh = a->kh;
  p.kw = a->kw;
  p.sh = a->sh;
  p.sw = a->sw;
  p.ph = a->ph;
  p.pw = a->pw;
  p.Wo = a->Wo;
  p.K = a->kh * a->kw * a->C;
  p.k_pad = a->k_pad;
  p.taps = (a->C % K_TILE == 0 && a->kh * a->kw > 1) ? a->kh * a->kw : 0;
  const long long M = static_cast<long long>(a->Ho) * a->Wo * a->batch;
  p.HoWo = a->Ho * a->Wo;
  p.M = static_cast<int>(M);
  p.w = static_cast<const int8_t*>(a->w);
  p.n_pad = a->n_pad;
  p.N = a->cout;
  p.scale = static_cast<const float*>(a->scale);
  p.bias = static_cast<const float*>(a->bias);
  p.inv = a->inv;
  p.out = out;
  const int C = a->C, W = a->W, kh = a->kh, kw = a->kw, route = a->route;
  const bool shift_ok =
      a->dtype == 1 && C % K_TILE == 0 && a->sh == 1 && a->sw == 1 &&
      kh % 2 == 1 && kw % 2 == 1 && a->ph == kh / 2 && a->pw == kw / 2 &&
      kh * kw <= 32 && kh * kw >= 3 && a->sW == C &&
      a->sH == static_cast<long long>(W) * C &&
      (a->batch == 1 || a->sN == static_cast<long long>(a->H) * W * C);
  if (M < 1 || M > 0x7fffffffLL || a->cout < 1 || a->n_pad < a->cout ||
      a->k_pad % K_TILE != 0 || a->k_pad < p.K || route < 0 || route > 2 ||
      (route >= 1 && (a->sC != 1 || C % 8 != 0)) || (route == 2 && !shift_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return launch_fused<float>(a->tile, route, p, s);
  if (a->dtype == 1) return launch_fused<__nv_bfloat16>(a->tile, route, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
