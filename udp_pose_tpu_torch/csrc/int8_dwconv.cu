// The port's int8 (w8a8) depthwise convolution: the JAX package's PTQ
// serving conv with feature_group_count = C (udp_pose_tpu/models/
// quantize.py, _quantized_conv :188-218, the grouped call :206-213),
// which XLA lowers to a grouped int8 conv with the activation quantise
// before it and the dequant epilogue after it.  It replaces no Pallas
// kernel: the JAX package has none for convolutions.
//
//   q    = clip(rint(float(x) * inv_s_a), -127, 127)     (zero padding)
//   acc  = sum_{i,j} q[n, c, ho*s - p + i, wo*s - p + j] * w_i8[c, i, j]
//   out  = cast(float(acc) * scale[c] + bias[c])
//
// with scale[c] = f32(s_a) * s_w[c], as int8_conv.cu's dequant.  Rounding
// is the JAX package's to the bit: rintf rounds half to even, every
// multiply and add of the epilogue is an explicit __fmul_rn/__fadd_rn so
// that nvcc contracts nothing into an FMA, the cast to bf16 rounds to
// nearest even.  The integer sum is exact (|acc| <= 127^2 * 81 < 2^31).
//
// Bound on this card: bytes.  A depthwise conv does k^2 multiply-adds a
// value it reads (18 to 162 int8 operations for every 2 to 4 bytes),
// nowhere near the ~590 operations a byte at which the int8 rate would
// bound it; the least it moves is the activation once, the output once
// and the weights.  What it spends instead is issue slots, conversion
// instructions (16 a clock on an SM against 128 FP32 operations) and,
// where the layout is not channels-last with 16-byte rows, sectors
// fetched for few useful bytes.
//
// int8_dwconv_launch is what the port runs.  A block computes an 8 x 8
// output tile of CB = 8, 16 or 32 channels of one image: it stages the
// tile's input with its halo, quantised, as int8 planes in shared memory
// (one a channel, an odd number of words a plane so that a warp's
// channels read distinct banks), and a thread computes one channel's 8
// neighbouring outputs of a row: each tap row's words in registers, each
// pixel's window of 4 taps one funnel shift and one __dp4a (int8 x int8
// summed into int32), then the epilogue in registers and one
// channels-last output write.  The wrapper (ops/int8_dwconv.py, _plan)
// picks the load route from the layout and the base address's alignment:
//   * channels-last (channel stride 1): the widest of 16, 8, 4 or 2 bytes
//     that the channel count, the pixel, row and image strides and the
//     base allow, so a load holds 8, 4, 2 or 1 of a pixel's channels;
//   * a channel stride of 2 (ShuffleNet's even/odd channel-split views):
//     the parent's contiguous words from `offset` elements before the
//     view, every other value kept;
//   * NCHW (W stride 1): along the rows of each channel plane from the
//     aligned column at or before the tile's first.
// The launcher checks the route against the layout and returns
// cudaErrorInvalidValue for anything it cannot take.  The weights come
// packed at prepare time (four taps of a row a word) and are copied in
// 16-byte loads; the quantise and the sums' cast to float take no
// conversion instructions.  A strip walk down the rows with a ring of
// quantised rows and cp.async staging was measured beside this tile and
// lost on every route, summed over the mobile nets' sites (PERF.md).
// int8_dwconv_tiled_launch is the previous design, kept on no path as the
// yardstick: the same tile with loads of 16 bytes where C % 8 == 0 on a
// channels-last 16-byte aligned view and one value a thread otherwise,
// the weights repacked by every block, and the quantise and cast by
// conversion instructions.
// No int8 activation and no int32 accumulator reaches device memory.

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

__device__ __forceinline__ int quantize(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return __float2int_rn(q);
}

// The launch's quantise and int-to-float without conversion
// instructions, which issue at 16 a clock on an SM against 128 FP32
// operations: clamping to +-127 before rounding gives the same integer as
// rounding first (the bounds are integers; NaN clamps to -127 either
// way), and adding 1.5 * 2^23 rounds to the nearest integer, ties to
// even, leaving it in the low byte of the sum's bits.
__device__ __forceinline__ uint32_t quantize_bits(float v, float inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(c, 12582912.0f));
}
// float(acc), exact for |acc| < 2^22 (|acc| <= 127^2 * 81 < 2^21)
__device__ __forceinline__ float acc_to_float(int acc) {
  return __fsub_rn(__int_as_float(acc + 0x4B400000), 12582912.0f);
}

// Each pixel's window of 4 taps of one tap row: a funnel shift of the
// row's words and a dp4a against the row's packed weight word.
template <int K, int S, int PX, int WORDS>
__device__ __forceinline__ void dp4a_row(const int (&r)[WORDS],
                                         const int* wrow, int (&acc)[PX]) {
  constexpr int kTapWords = (K + 3) / 4;
#pragma unroll
  for (int px = 0; px < PX; ++px) {
#pragma unroll
    for (int m = 0; m < kTapWords; ++m) {
      const int b = px * S + 4 * m;            // first tap's byte
      const int lo = r[b / 4];
      const int win = (b % 4 == 0)
          ? lo
          : static_cast<int>(__funnelshift_r(
                static_cast<uint32_t>(lo),
                static_cast<uint32_t>(r[b / 4 + 1]), 8 * (b % 4)));
      acc[px] = __dp4a(win, wrow[m], acc[px]);
    }
  }
}

// the wrapper's route codes (ops/int8_dwconv.ROUTES)
enum Route { kChannelsLast = 0, kChannelSplit = 1, kPlanar = 2 };

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// ------------------------------------------------------------ the 8 x 8 tile
constexpr int kTile = 8;            // output rows and columns of a block
constexpr int kMaxCB = 32;          // channels a block

// 8 channels of one pixel: one 16-byte load of bf16, two of float32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

struct TileParams {
  const void* x;
  void* out;
  const int8_t* w;       // (k*k, C): tap-major, channels contiguous
  const uint4* wp;       // LEAN: the packed weight words
  const float* scale;    // C
  const float* bias;     // C, or null
  long long sN, sC, sH, sW;
  int C, H, W, pad, Ho, Wo;
  int tiles_w, tiles_hw; // output tiles a row, an image
  int cb, cb_shift;      // channels a block: 8, 16 or 32; its log2
  int route, lb, vals_shift, off;  // kLoadRoute: route, bytes a load, log2
                                   // of the view's values a load, offset
  float inv;
};

// How a tile kernel stages its input.  The launch: kLoadVec16 (8
// channels of a pixel a 16-byte load, channels-last with C % 8 == 0) and
// kLoadRoute (the route's load of `lb` bytes: channels-last or split,
// the view's `vals` channels of a pixel; NCHW, `vals` columns of a
// channel's row), both with the weights packed at prepare time and the
// quantise and cast without conversion instructions.  The previous design:
// kLoadVec (as kLoadVec16) and kLoadOne (one value a thread).
enum TileLoad { kLoadVec16 = 0, kLoadRoute = 1, kLoadVec = 2, kLoadOne = 3 };

// `lb` bytes at p (aligned to lb) into w, zeros past them.
__device__ __forceinline__ void load_words(const void* p, int lb,
                                           uint32_t (&w)[4]) {
  switch (lb) {
    case 16: {
      const uint4 v = __ldg(static_cast<const uint4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      break;
    }
    case 8: {
      const uint2 v = __ldg(static_cast<const uint2*>(p));
      w[0] = v.x; w[1] = v.y;
      break;
    }
    case 4:
      w[0] = __ldg(static_cast<const unsigned int*>(p));
      break;
    default:
      w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
}

// Element e of the loaded words as float: selects, not an indexed array,
// so that w stays in registers for a runtime e.
__device__ __forceinline__ uint32_t word_at(const uint32_t (&w)[4], int i) {
  const uint32_t lo = (i & 1) ? w[1] : w[0];
  const uint32_t hi = (i & 1) ? w[3] : w[2];
  return (i & 2) ? hi : lo;
}
template <typename T>
__device__ __forceinline__ float element_at(const uint32_t (&w)[4], int e);
template <>
__device__ __forceinline__ float element_at<float>(const uint32_t (&w)[4],
                                                   int e) {
  return __uint_as_float(word_at(w, e));
}
template <>
__device__ __forceinline__ float element_at<__nv_bfloat16>(
    const uint32_t (&w)[4], int e) {
  const uint32_t v = word_at(w, e >> 1);
  return (e & 1) ? bf16_hi(v) : bf16_lo(v);
}

// The staged tile of one channel: rows of kPitch bytes (a multiple of 4,
// with a word to spare past the last column that a tap window reads),
// an odd number of words a plane so that the channels of a warp read
// distinct banks.
template <int K, int S>
struct Tile {
  static constexpr int kIn = (kTile - 1) * S + K;       // rows and columns
  static constexpr int kWords = (kIn + 3) / 4 + 1;      // words a row
  static constexpr int kPitch = 4 * kWords;
  static constexpr int kPlane = ((kIn * kWords) | 1) * 4;  // bytes
  static constexpr int kTapWords = (K + 3) / 4;         // weight words a row
  // dynamic shared memory of a block of cb channels: the tile's planes,
  // then the packed weights
  static constexpr int bytes(int cb) {
    return cb * kPlane + cb * K * kTapWords * 4;
  }
};

template <typename T, int K, int S, int LOAD>
__global__ void __launch_bounds__(kTile * kMaxCB)
    int8_dwconv_tile_kernel(const TileParams p) {
  constexpr bool LEAN = LOAD == kLoadVec16 || LOAD == kLoadRoute;
  constexpr bool VEC = LOAD == kLoadVec16 || LOAD == kLoadVec;
  using Tl = Tile<K, S>;
  extern __shared__ __align__(16) int8_t smem_tile[];
  const int CB = p.cb;
  int8_t* q_s = smem_tile;
  int* w_s = reinterpret_cast<int*>(smem_tile + CB * Tl::kPlane);
  const int threads = kTile * CB;              // CB channels x 8 rows
  const int tid = threadIdx.x;
  const int c_base = blockIdx.y * CB;
  const int n = blockIdx.x / p.tiles_hw;
  const int t = blockIdx.x - n * p.tiles_hw;
  const int ho0 = (t / p.tiles_w) * kTile;
  const int wo0 = (t % p.tiles_w) * kTile;
  const int y0 = ho0 * S - p.pad;
  const int x0 = wo0 * S - p.pad;

  // each channel's weight rows packed 4 taps a word, zeros past k
  if constexpr (LEAN) {
    const uint4* src = p.wp + c_base * K * Tl::kTapWords / 4;
    for (int i = tid; i < CB * K * Tl::kTapWords / 4; i += threads) {
      reinterpret_cast<uint4*>(w_s)[i] = __ldg(src + i);
    }
  }
  for (int i = tid; !LEAN && i < CB * K * Tl::kTapWords; i += threads) {
    const int cl = i / (K * Tl::kTapWords);
    const int r = i - cl * (K * Tl::kTapWords);
    const int row = r / Tl::kTapWords;
    const int j0 = 4 * (r - row * Tl::kTapWords);
    const int c = c_base + cl;
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c < p.C && j0 + e < K) {
        word |= (static_cast<uint32_t>(
                     p.w[static_cast<long long>(row * K + j0 + e) * p.C + c])
                 & 0xffu) << (8 * e);
      }
    }
    w_s[i] = static_cast<int>(word);
  }

  // the quantised input tile with its halo, one plane a channel; zeros in
  // the padding, past the image and past C
  const T* xn = static_cast<const T*>(p.x) + n * p.sN;
  constexpr int kIn = Tl::kIn;
  if constexpr (VEC) {
    const int groups = CB / 8;
    const int g_shift = p.cb_shift - 3;
#pragma unroll 2
    for (int i = tid; i < kIn * kIn * groups; i += threads) {
      const int pix = i >> g_shift;
      const int g = i & (groups - 1);
      const int iy = pix / kIn;
      const int ix = pix - iy * kIn;
      const int y = y0 + iy;
      const int xx = x0 + ix;
      const int c = c_base + g * 8;
      int8_t* dst = q_s + (g * 8) * Tl::kPlane + iy * Tl::kPitch + ix;
      if (y >= 0 && y < p.H && xx >= 0 && xx < p.W && c < p.C) {
        float v[8];
        load8(xn + c * p.sC + y * p.sH + xx * p.sW, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dst[e * Tl::kPlane] = static_cast<int8_t>(
              LEAN ? static_cast<int>(quantize_bits(v[e], p.inv))
                   : quantize(v[e], p.inv));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e * Tl::kPlane] = 0;
      }
    }
  } else if constexpr (LOAD == kLoadRoute) {
    const int vals = 1 << p.vals_shift;
    if (p.route == kPlanar) {
      // NCHW: loads of `vals` neighbouring columns of a channel's row from
      // the aligned column at or before x0 (W % vals == 0: a load is all
      // in the row or all out); each column of the tile in one load
      const int xa = x0 - (x0 & (vals - 1));
      const int per_row = (x0 + kIn - xa + vals - 1) >> p.vals_shift;
      for (int i = tid; i < CB * kIn * per_row; i += threads) {
        const int rest = i / per_row;
        const int gx = xa + ((i - rest * per_row) << p.vals_shift);
        const int cl = rest / kIn;
        const int iy = rest - cl * kIn;
        const int y = y0 + iy;
        const int c = c_base + cl;
        const bool in = y >= 0 && y < p.H && gx >= 0 && gx < p.W && c < p.C;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (in) load_words(xn + c * p.sC + y * p.sH + gx, p.lb, w);
        int8_t* dst = q_s + cl * Tl::kPlane + iy * Tl::kPitch;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int ix = gx + e - x0;
          if (e < vals && ix >= 0 && ix < kIn) {
            dst[ix] = in ? static_cast<int8_t>(static_cast<int>(
                               quantize_bits(element_at<T>(w, e), p.inv)))
                         : int8_t{0};
          }
        }
      }
    } else {
      // channels-last and split: the view's `vals` channels of a pixel a
      // load, from `off` elements before the first (split: every other
      // element of the parent's words, from `off`)
      const int cs = p.route == kChannelSplit ? 2 : 1;
      const int groups = CB >> p.vals_shift;       // loads a pixel
      const int g_shift = p.cb_shift - p.vals_shift;
      for (int i = tid; i < kIn * kIn * groups; i += threads) {
        const int pix = i >> g_shift;
        const int gc = (i & (groups - 1)) << p.vals_shift;
        const int iy = pix / kIn;
        const int ix = pix - iy * kIn;
        const int y = y0 + iy;
        const int xx = x0 + ix;
        const int c = c_base + gc;
        const bool in = y >= 0 && y < p.H && xx >= 0 && xx < p.W && c < p.C;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (in) {
          load_words(xn + c * p.sC + y * p.sH + xx * p.sW - p.off, p.lb, w);
        }
        int8_t* dst = q_s + gc * Tl::kPlane + iy * Tl::kPitch + ix;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < vals) {
            dst[j * Tl::kPlane] =
                in ? static_cast<int8_t>(static_cast<int>(quantize_bits(
                         element_at<T>(w, j * cs + p.off), p.inv)))
                   : int8_t{0};
          }
        }
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kIn * kIn * CB; i += threads) {
      const int pix = i >> p.cb_shift;
      const int cl = i & (CB - 1);
      const int iy = pix / kIn;
      const int ix = pix - iy * kIn;
      const int y = y0 + iy;
      const int xx = x0 + ix;
      const int c = c_base + cl;
      int q = 0;
      if (y >= 0 && y < p.H && xx >= 0 && xx < p.W && c < p.C) {
        q = quantize(to_float(__ldg(xn + c * p.sC + y * p.sH + xx * p.sW)),
                     p.inv);
      }
      q_s[cl * Tl::kPlane + iy * Tl::kPitch + ix] = static_cast<int8_t>(q);
    }
  }
  __syncthreads();

  // a thread: one channel, one output row of 8 pixels; per tap row the
  // staged row in registers, each pixel's window of 4 taps a dp4a
  const int cl = tid & (CB - 1);               // neighbours: channels
  const int py = tid >> p.cb_shift;
  const int c = c_base + cl;
  const int ho = ho0 + py;
  if (c >= p.C || ho >= p.Ho) return;
  int wreg[K * Tl::kTapWords];
#pragma unroll
  for (int i = 0; i < K * Tl::kTapWords; ++i) {
    wreg[i] = w_s[cl * K * Tl::kTapWords + i];
  }
  int acc[kTile];
#pragma unroll
  for (int e = 0; e < kTile; ++e) acc[e] = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int* row = reinterpret_cast<const int*>(
        q_s + cl * Tl::kPlane + (py * S + i) * Tl::kPitch);
    int r[Tl::kWords];
#pragma unroll
    for (int m = 0; m < Tl::kWords; ++m) r[m] = row[m];
    dp4a_row<K, S, kTile, Tl::kWords>(r, wreg + i * Tl::kTapWords, acc);
  }

  const float sc = p.scale[c];
  const float bi = p.bias != nullptr ? p.bias[c] : 0.0f;
  T* dst = static_cast<T*>(p.out) +
           ((static_cast<long long>(n) * p.Ho + ho) * p.Wo + wo0) * p.C + c;
#pragma unroll
  for (int px = 0; px < kTile; ++px) {
    if (wo0 + px < p.Wo) {
      float v = __fmul_rn(
          LEAN ? acc_to_float(acc[px]) : static_cast<float>(acc[px]), sc);
      if (p.bias != nullptr) v = __fadd_rn(v, bi);
      from_float(v, dst + static_cast<long long>(px) * p.C);
    }
  }
}

// ------------------------------------------------------------ launching
template <typename T, int K, int S, int LOAD>
int launch_tile(const TileParams& p, dim3 grid, int threads,
                cudaStream_t s) {
  int8_dwconv_tile_kernel<T, K, S, LOAD>
      <<<grid, threads, Tile<K, S>::bytes(p.cb), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation a dtype, kernel size and stride: `l.run<T, K, S>()`.
template <typename T, int S, typename L>
int by_k(const L& l, int k) {
  switch (k) {
    case 3: return l.template run<T, 3, S>();
    case 5: return l.template run<T, 5, S>();
    case 7: return l.template run<T, 7, S>();
    case 9: return l.template run<T, 9, S>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename L>
int by_stride(const L& l, int k, int stride) {
  if (stride == 1) return by_k<T, 1>(l, k);
  if (stride == 2) return by_k<T, 2>(l, k);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename L>
int dispatch(const L& l, int dtype, int k, int stride) {
  if (dtype == 0) return by_stride<float>(l, k, stride);
  if (dtype == 1) return by_stride<__nv_bfloat16>(l, k, stride);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct TileLaunch {
  const TileParams& p;
  int load;              // TileLoad
  dim3 grid;
  int threads;
  cudaStream_t stream;
  template <typename T, int K, int S>
  int run() const {
    switch (load) {
      case kLoadVec16:
        return launch_tile<T, K, S, kLoadVec16>(p, grid, threads, stream);
      case kLoadRoute:
        return launch_tile<T, K, S, kLoadRoute>(p, grid, threads, stream);
      case kLoadVec:
        return launch_tile<T, K, S, kLoadVec>(p, grid, threads, stream);
      default:
        return launch_tile<T, K, S, kLoadOne>(p, grid, threads, stream);
    }
  }
};

// The tile's grid and channel block for `cb` channels a block.
dim3 tile_grid(TileParams& p, int batch, int cb) {
  p.cb = cb;
  p.cb_shift = cb == 32 ? 5 : cb == 16 ? 4 : 3;
  p.tiles_w = (p.Wo + kTile - 1) / kTile;
  p.tiles_hw = p.tiles_w * ((p.Ho + kTile - 1) / kTile);
  return dim3(static_cast<unsigned>(static_cast<long long>(batch) *
                                    p.tiles_hw),
              static_cast<unsigned>((p.C + cb - 1) / cb));
}

bool strides_divide(long long step, long long sN, long long sH, long long sW,
                    int N, int H, int W, int elt) {
  return (N == 1 || sN * elt % step == 0) && (H == 1 || sH * elt % step == 0)
         && (W == 1 || sW * elt % step == 0);
}

}  // namespace

// The launch arguments other than the activation and output pointers and
// the stream, packed by the wrapper once per layer and input layout
// (ops/int8_dwconv.DwArgs mirrors it field for field).
struct DwArgs {
  long long sN, sC, sH, sW;  // the activation's element strides
  const void* w;             // packed words (C up to 32s, k, taps/4)
  const void* scale;         // float32, C of them
  const void* bias;          // float32, C of them, or null
  int dtype;                 // 0 float32, 1 bfloat16 (input and output)
  int batch, C, H, W, k, stride, pad, Ho, Wo;
  int route;                 // 0 channels-last, 1 channel stride 2, 2 NCHW
  int load_bytes;            // 2, 4, 8 or 16 bytes a load
  int offset;                // route 1: elements the loads start before
  int cb;                    // channels a block: 8, 16 or 32
  float inv;                 // float32(1 / s_a)
};

namespace {

// The view's values a load of the route `a` names, or 0 where the route
// does not fit the layout: every load lies in the view (or, on the split
// route, in the parent's words the wrapper checked) and is aligned to its
// width.
int route_values(const void* x, const DwArgs* a) {
  const int elt = a->dtype == 0 ? 4 : 2;
  const int lb = a->load_bytes;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  if ((lb != 2 && lb != 4 && lb != 8 && lb != 16) || lb < elt) return 0;
  if (a->route == kChannelsLast) {
    const int vals = lb / elt;
    const bool ok = a->offset == 0 && (a->C == 1 || a->sC == 1) &&
                    a->C % vals == 0 && base % lb == 0 &&
                    strides_divide(lb, a->sN, a->sH, a->sW, a->batch, a->H,
                                   a->W, elt);
    return ok ? vals : 0;
  }
  if (a->route == kChannelSplit) {
    const int vals = lb / (2 * elt);
    const bool ok = vals >= 1 && a->sC == 2 &&
                    (a->offset == 0 || a->offset == 1) && a->C % vals == 0 &&
                    (base - a->offset * elt) % lb == 0 &&
                    strides_divide(lb, a->sN, a->sH, a->sW, a->batch, a->H,
                                   a->W, elt);
    return ok ? vals : 0;
  }
  if (a->route == kPlanar) {
    const int vals = lb / elt;
    const bool ok = a->offset == 0 && (a->W == 1 || a->sW == 1) &&
                    a->W % vals == 0 && base % lb == 0 &&
                    strides_divide(lb, a->sN, a->sH, a->sC, a->batch, a->H,
                                   a->C, elt);
    return ok ? vals : 0;
  }
  return 0;
}

// The fields both launchers fill the same way.
TileParams tile_params(const void* x, void* out, const DwArgs* a) {
  TileParams p;
  p.x = x;
  p.out = out;
  p.w = nullptr;
  p.wp = nullptr;
  p.scale = static_cast<const float*>(a->scale);
  p.bias = static_cast<const float*>(a->bias);
  p.sN = a->sN;
  p.sC = a->sC;
  p.sH = a->sH;
  p.sW = a->sW;
  p.C = a->C;
  p.H = a->H;
  p.W = a->W;
  p.pad = a->pad;
  p.Ho = a->Ho;
  p.Wo = a->Wo;
  p.route = a->route;
  p.lb = a->load_bytes;
  p.off = a->offset;
  p.vals_shift = 0;
  p.inv = a->inv;
  return p;
}

}  // namespace

// The port's depthwise conv, one launch a conv: the 8 x 8 tile with the
// load route of the wrapper's plan (16-byte loads of 8 channels where the
// route is channels-last with C % 8 == 0) and the packed weights.
// Returns a cudaError_t value.
extern "C" int int8_dwconv_launch(const void* x, void* out,
                                  const DwArgs* a, void* stream) {
  if (a->batch <= 0 || a->C <= 0 || a->Ho <= 0 || a->Wo <= 0) return 0;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int vals = route_values(x, a);
  if (vals == 0 || (a->dtype != 0 && a->dtype != 1) ||
      (a->cb != 8 && a->cb != 16 && a->cb != 32) ||
      reinterpret_cast<uintptr_t>(a->w) % 16 != 0) {
    return bad;
  }
  TileParams p = tile_params(x, out, a);
  p.wp = static_cast<const uint4*>(a->w);
  while ((1 << p.vals_shift) < vals) ++p.vals_shift;
  const bool vec16 = a->route == kChannelsLast && a->load_bytes == 16 &&
                     a->C % 8 == 0;
  const dim3 grid = tile_grid(p, a->batch, a->cb);
  if (static_cast<long long>(a->batch) * p.tiles_hw > 0x7fffffffLL) {
    return bad;
  }
  return dispatch(TileLaunch{p, vec16 ? kLoadVec16 : kLoadRoute, grid,
                             kTile * p.cb, static_cast<cudaStream_t>(stream)},
                  a->dtype, a->k, a->stride);
}

// The previous design, on no path: the yardstick the launch is timed
// against.  Takes the same arguments (it reads the strides, the shape and
// the epilogue's vectors, not the route, the channel block or the
// packing) and the (k*k, C) int8 weight.  Returns a cudaError_t value.
extern "C" int int8_dwconv_tiled_launch(const void* x, void* out,
                                        const DwArgs* a, const void* w_taps,
                                        void* stream) {
  TileParams p = tile_params(x, out, a);
  p.w = static_cast<const int8_t*>(w_taps);
  if (a->batch <= 0 || p.C <= 0 || p.Ho <= 0 || p.Wo <= 0) return 0;
  if ((a->stride != 1 && a->stride != 2) ||
      (a->dtype != 0 && a->dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the 16-byte route where 8 channels of a tap are one aligned chunk
  const int elt = a->dtype == 0 ? 4 : 2;
  const bool vec = p.C % 8 == 0 && p.sC == 1 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   strides_divide(8 * elt, p.sN, p.sH, p.sW, a->batch, p.H,
                                  p.W, elt);
  // channels a block: of 32, 16 and 8, the first whose blocks pad C by at
  // most a quarter (8 pads C = 18 to 24 where 32 would pad it to 32)
  int cb = 8;
  for (int c = kMaxCB; c > 8; c /= 2) {
    if (4 * ((p.C + c - 1) / c * c) <= 5 * p.C) {
      cb = c;
      break;
    }
  }
  const dim3 grid = tile_grid(p, a->batch, cb);
  if (static_cast<long long>(a->batch) * p.tiles_hw > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(TileLaunch{p, vec ? kLoadVec : kLoadOne, grid,
                             kTile * p.cb, static_cast<cudaStream_t>(stream)},
                  a->dtype, a->k, a->stride);
}
