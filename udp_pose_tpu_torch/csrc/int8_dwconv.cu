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
// and k^2 * C weight bytes.  What it spends instead is issue slots: an
// exact quantise is ~6 instructions a value, and a multiply-add of int8
// values held one a register is another 2-3.  The design keeps both to
// what the data needs:
//   * a block owns one image's 8 x 8 output tile and CB = 8, 16 or 32
//     channels (the launcher picks the one that pads C least), with
//     8 * CB threads;
//   * it stages the input tile with its halo, ((8-1)*s + k)^2 pixels,
//     quantised once, as int8 in shared memory, one plane a channel (rows
//     padded to whole words, an odd number of words a plane so that a
//     warp's channels read distinct banks), zeros in the padding, past
//     the image and past C; the weights of its channels packed four taps
//     of a row to a word, zeros past k.  Loads are 8 channels of a pixel
//     (one 16-byte load of bf16, two of float32) where the channel stride
//     is 1, C % 8 == 0 and the view is 16-byte aligned, else one channel
//     a thread with neighbouring threads on neighbouring channels (C =
//     18, 36, 58 ..., the even/odd channel-split views, NCHW input);
//   * a thread then computes one channel's row of 8 output pixels: its
//     weights sit in registers, each tap row of the tile is read once into
//     registers, and each pixel's window of 4 taps is one funnel shift
//     and one __dp4a (int8 x int8, summed into int32): 3 to 27 dp4a a
//     pixel for k = 3 to 9;
//   * the epilogue in registers writes the (N, Ho, Wo, C) channels-last
//     output once, neighbouring threads on neighbouring channels.
// No int8 activation and no int32 accumulator reaches device memory.
// The kernel's first design (one thread a pixel and 8 channels, every tap
// loaded and quantised again from L1) and its second (the tile staged
// with channels innermost, one multiply-add a value) took 17.42 and 15.94
// ms against a 2.55 ms bound over the mobile nets' 74 depthwise sites of
// a fold forward (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;            // output rows and columns of a block
constexpr int kMaxCB = 32;          // channels a block

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

struct DwParams {
  const void* x;
  void* out;
  const int8_t* w;       // (k*k, C): tap-major, channels contiguous
  const float* scale;    // C
  const float* bias;     // C, or null
  long long sN, sC, sH, sW;
  int C, H, W, pad, Ho, Wo;
  int tiles_w, tiles_hw; // output tiles a row, an image
  int cb, cb_shift;      // channels a block: 8, 16 or 32; its log2
  float inv;
};

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

// VEC: the 16-byte load route (8 channels of a pixel a load).
template <typename T, int K, int S, bool VEC>
__global__ void __launch_bounds__(kTile * kMaxCB)
    int8_dwconv_kernel(const DwParams p) {
  using Tl = Tile<K, S>;
  extern __shared__ __align__(16) int8_t smem[];
  const int CB = p.cb;
  int8_t* q_s = smem;
  int* w_s = reinterpret_cast<int*>(smem + CB * Tl::kPlane);
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
  for (int i = tid; i < CB * K * Tl::kTapWords; i += threads) {
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
          dst[e * Tl::kPlane] = static_cast<int8_t>(quantize(v[e], p.inv));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e * Tl::kPlane] = 0;
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
#pragma unroll
    for (int px = 0; px < kTile; ++px) {
#pragma unroll
      for (int m = 0; m < Tl::kTapWords; ++m) {
        const int b = px * S + 4 * m;          // first tap's byte
        const int lo = r[b / 4];
        const int win = (b % 4 == 0)
            ? lo
            : static_cast<int>(__funnelshift_r(
                  static_cast<uint32_t>(lo),
                  static_cast<uint32_t>(r[b / 4 + 1]), 8 * (b % 4)));
        acc[px] = __dp4a(win, wreg[i * Tl::kTapWords + m], acc[px]);
      }
    }
  }

  const float sc = p.scale[c];
  const float bi = p.bias != nullptr ? p.bias[c] : 0.0f;
  T* dst = static_cast<T*>(p.out) +
           ((static_cast<long long>(n) * p.Ho + ho) * p.Wo + wo0) * p.C + c;
#pragma unroll
  for (int px = 0; px < kTile; ++px) {
    if (wo0 + px < p.Wo) {
      float v = __fmul_rn(static_cast<float>(acc[px]), sc);
      if (p.bias != nullptr) v = __fadd_rn(v, bi);
      from_float(v, dst + static_cast<long long>(px) * p.C);
    }
  }
}

template <typename T, int K, int S, bool VEC>
void launch(const DwParams& p, dim3 grid, int threads, cudaStream_t s) {
  int8_dwconv_kernel<T, K, S, VEC>
      <<<grid, threads, Tile<K, S>::bytes(p.cb), s>>>(p);
}

template <typename T, int S, bool VEC>
int launch_k(const DwParams& p, int k, dim3 grid, int threads,
             cudaStream_t s) {
  switch (k) {
    case 3: launch<T, 3, S, VEC>(p, grid, threads, s); break;
    case 5: launch<T, 5, S, VEC>(p, grid, threads, s); break;
    case 7: launch<T, 7, S, VEC>(p, grid, threads, s); break;
    case 9: launch<T, 9, S, VEC>(p, grid, threads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_s(const DwParams& p, int k, int stride, dim3 grid, int threads,
             cudaStream_t s) {
  return stride == 1 ? launch_k<T, 1, VEC>(p, k, grid, threads, s)
                     : launch_k<T, 2, VEC>(p, k, grid, threads, s);
}

}  // namespace

// The launch arguments other than the activation and output pointers and
// the stream, packed by the wrapper once per layer and input layout
// (ops/int8_dwconv.DwArgs mirrors it field for field).
struct DwArgs {
  long long sN, sC, sH, sW;  // the activation's element strides
  const void* w;             // (k*k, C) int8 weight
  const void* scale;         // float32, C of them
  const void* bias;          // float32, C of them, or null
  int dtype;                 // 0 float32, 1 bfloat16 (input and output)
  int batch, C, H, W, k, stride, pad, Ho, Wo;
  int vec;                   // 1: the 16-byte load route, 0: one channel
  float inv;                 // float32(1 / s_a)
};

extern "C" int int8_dwconv_launch(const void* x, void* out,
                                  const DwArgs* a, void* stream) {
  DwParams p;
  p.x = x;
  p.out = out;
  p.w = static_cast<const int8_t*>(a->w);
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
  p.inv = a->inv;
  if (a->batch <= 0 || p.C <= 0 || p.Ho <= 0 || p.Wo <= 0) return 0;
  if (a->stride < 1 || a->stride > 2 || (a->vec && p.C % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // channels a block: of 32, 16 and 8, the first whose blocks pad C by at
  // most a quarter (8 pads C = 18 to 24 where 32 would pad it to 32)
  p.cb = 8;
  for (int cb = kMaxCB; cb > 8; cb /= 2) {
    if (4 * ((p.C + cb - 1) / cb * cb) <= 5 * p.C) {
      p.cb = cb;
      break;
    }
  }
  p.cb_shift = p.cb == 32 ? 5 : p.cb == 16 ? 4 : 3;
  p.tiles_w = (p.Wo + kTile - 1) / kTile;
  p.tiles_hw = p.tiles_w * ((p.Ho + kTile - 1) / kTile);
  const long long gx = static_cast<long long>(a->batch) * p.tiles_hw;
  if (gx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx),
                  static_cast<unsigned>((p.C + p.cb - 1) / p.cb));
  const int threads = kTile * p.cb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = a->k, st = a->stride;
  if (a->dtype == 0) {
    return a->vec ? launch_s<float, true>(p, k, st, grid, threads, s)
                  : launch_s<float, false>(p, k, st, grid, threads, s);
  }
  if (a->dtype == 1) {
    return a->vec
               ? launch_s<__nv_bfloat16, true>(p, k, st, grid, threads, s)
               : launch_s<__nv_bfloat16, false>(p, k, st, grid, threads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
