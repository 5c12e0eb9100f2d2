// Peak-find + offset decode of the UDP offset decode, for Hopper.
//
// Replaces the TPU kernel udp_pose_tpu/ops/pallas/decode_kernels.py
// (_make_kernel / fused_peak_offset, pallas_call at :83).  It follows the
// default XLA decode (udp_pose_tpu/ops/decode.py:95-112), not that file's
// wrapper: when a map's peak is <= 0 the peak is masked to (0, 0) and the
// offsets are read at flat index 0.  Two modes, two launchers:
//
// (a) peak_offset_launch: the Pallas function's counterpart.  Blurred
//     maps in, rows of H*W floats, all three contiguous; per map n:
//       idx    = lowest flat index attaining the row max (ties -> lowest)
//       maxval = hm[n, idx]
//       if maxval > 0: out = [idx % W, idx / W, maxval, ox[n, idx], oy[n, idx]]
//       else:          out = [0,       0,       maxval, ox[n, 0],   oy[n, 0]]
//     Bound by bytes: the N*H*W heatmap is read once (26.7 MB at the
//     serving shape N = 128*17, 64x48; ~8 us at 3.35 TB/s).  Design: a
//     warp per map, four maps per block, 16-byte loads eight deep per
//     lane, so that ~64 KB per SM are in flight; a (value, index) pair
//     per lane, a warp-shuffle reduce, lane 0 reads the two offsets.
//
// (b) udp_decode_launch: the whole decode of
//     ops/decode.udp_offset_decode in one launch.  The raw (B, 3J, H, W)
//     net output in, with any element strides (NCHW or channels-last,
//     no copy); a block of 256 threads per G maps:
//       1. stage each map's heatmap channel 3j in shared memory with its
//          REFLECT_101 halo columns;
//       2. the 15-tap W pass (16-byte windows) into a second buffer with
//          its halo rows;
//       3. the 15-tap H pass down the columns, each output ranked as it
//          is made, and the block's (value, index) reduce, masked as in
//          (a);
//       4. a warp per map: the 7x7 blur of kpd*off_x and kpd*off_y at the
//          peak pixel only (49 reads each), not over the whole maps.
//     Out: (B, J, 5) as in (a).  With channels-last input every pixel's
//     interleaved channels span all of their 32-byte sectors, so the
//     whole tensor is read: bound by bytes (80.2 MB at B = 128, 51 x 64
//     x 48, ~24 us).  NCHW input reads only the heatmap channels (26.7
//     MB, ~8 us), and the ~44 separate float32 multiplies and adds per
//     pixel of the two folded passes set the bound instead: ~9 us at
//     the card's rate for operations that are not FMAs (half its 67
//     TFLOP/s).  The index arithmetic around the sums costs about as
//     much as the sums, so the serving map size (64x48) is compiled
//     with a constant shape.  With channels-last input each thread's
//     4-byte load lies 204 bytes from its neighbour's, so a warp's load
//     touches 32 128-byte lines; two maps per block (G = 2), their
//     channels read by neighbouring threads, halve that.

// Arithmetic order.  Each blur pass sums, for output c,
//   k[r]*x[c] + sum_{t=1..r} k[r-t]*(x[c-t] + x[c+t])      (t upward)
// with every product and sum rounded on its own (__fmul_rn / __fadd_rn:
// nvcc contracts none of them into an FMA), the W pass first.  The plain
// version (ops/blur.separable_blur_reference) sums in the same order, so
// the kernel and it agree bit for bit, NaN rows, ties and constant maps
// included.
//
// NaN: a NaN ranks above every number, and among NaNs the lowest index
// wins (torch.argmax order), so a row holding a NaN gets maxval = NaN;
// NaN > 0 is false, so it takes the masked branch.  idx / W is integer
// division, equal to the plain version's floor(float(idx) / W) for
// every H*W < 2^24 (the wrappers check).  Launches on the caller's
// stream, allocates nothing, does not synchronise.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------ shared (value, index)
// Does (v, i) rank above (bv, bi)?  NaN above numbers; ties to lower index.
__device__ __forceinline__ bool ranks_above(float v, int i, float bv, int bi) {
  const bool v_nan = isnan(v);
  const bool b_nan = isnan(bv);
  if (v_nan || b_nan) return v_nan && (!b_nan || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void consider(float v, int i, float& bv, int& bi) {
  if (ranks_above(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// consider() for a scan whose indices rise: i > bi always, so a tie or a
// second NaN keeps (bv, bi).
__device__ __forceinline__ void scan(float v, int i, float& bv, int& bi) {
  if (v > bv || (isnan(v) && !isnan(bv))) {
    bv = v;
    bi = i;
  }
}

// After it, every lane of the warp holds the warp's best (value, index).
__device__ __forceinline__ void warp_reduce(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    consider(__shfl_xor_sync(kFull, bv, off), __shfl_xor_sync(kFull, bi, off),
             bv, bi);
  }
}

__device__ __forceinline__ void write_packed(float* o, int at, int w, float bv,
                                             float ox, float oy) {
  o[0] = static_cast<float>(at % w);
  o[1] = static_cast<float>(at / w);
  o[2] = bv;
  o[3] = ox;
  o[4] = oy;
}

// ------------------------------------------------------- (a) peak only
constexpr int kPeakWarps = 4;
constexpr int kPeakDepth = 8;  // 16-byte loads in flight per lane

__global__ void __launch_bounds__(kPeakWarps * 32)
peak_offset_kernel(const float* __restrict__ hm, const float* __restrict__ ox,
                   const float* __restrict__ oy, float* __restrict__ out,
                   int n, int hw, int w) {
  const int lane = threadIdx.x & 31;
  const int map = blockIdx.x * kPeakWarps + (threadIdx.x >> 5);
  if (map >= n) return;  // whole warps only
  const size_t base = static_cast<size_t>(map) * hw;
  const float* row = hm + base;

  float bv = -INFINITY;
  int bi = INT_MAX;
  if ((hw & 3) == 0 && (reinterpret_cast<uintptr_t>(hm) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = hw >> 2;
    for (int j0 = lane; j0 < n4; j0 += 32 * kPeakDepth) {
      float4 v[kPeakDepth];
#pragma unroll
      for (int u = 0; u < kPeakDepth; ++u) {
        const int j = j0 + 32 * u;
        if (j < n4) v[u] = __ldg(row4 + j);
      }
#pragma unroll
      for (int u = 0; u < kPeakDepth; ++u) {
        const int j = j0 + 32 * u;
        if (j < n4) {
          scan(v[u].x, 4 * j, bv, bi);
          scan(v[u].y, 4 * j + 1, bv, bi);
          scan(v[u].z, 4 * j + 2, bv, bi);
          scan(v[u].w, 4 * j + 3, bv, bi);
        }
      }
    }
  } else {
    for (int i = lane; i < hw; i += 32) scan(__ldg(row + i), i, bv, bi);
  }
  warp_reduce(bv, bi);
  if (lane != 0) return;

  const int at = bv > 0.f ? bi : 0;  // false for NaN
  write_packed(out + static_cast<size_t>(map) * 5, at, w, bv, ox[base + at],
               oy[base + at]);
}

// -------------------------------------------------- (b) fused decode
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 7;       // radius of the 15-tap heatmap blur
constexpr int kR7 = 3;      // radius of the 7-tap offset blur
constexpr int kPad = 8;     // halo before a staged row: interior 16-B aligned
constexpr int kDepth = 12;  // loads in flight per thread while staging

struct Taps {
  float k15[kR + 1];  // k15[t] = the 15-tap kernel t away from its centre
  float k7[kR7 + 1];
};

struct Net {
  const float* p;
  long long sb, sc, sh, sw;  // element strides
  int J, H, W;

  __device__ const float* channel(int map, int c) const {
    const int b = map / J;
    return p + b * sb + (3LL * (map - b * J) + c) * sc;
  }
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// A staged heatmap row holds pixel x at kPad + x and its REFLECT_101
// images in the halo on both sides, padded so that the 16-byte windows
// x0 - 8 .. x0 + 11 of the W pass stay inside.  The W pass's output
// keeps image row y at row y + kR, with the halo rows above and below.
__host__ __device__ constexpr int staged_pitch(int w) { return round4(w) + 16; }
__host__ __device__ constexpr int mid_rows(int h) { return round4(h) + 2 * kR; }

// g staged heatmaps, then the W pass's output.
__host__ __device__ constexpr size_t fused_smem_bytes(int g, int h, int w) {
  return (static_cast<size_t>(g) * h * staged_pitch(w) +
          static_cast<size_t>(mid_rows(h)) * w) * sizeof(float);
}

// REFLECT_101 for any i; n >= 2.  One fold, the common case, first.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (i < 0 && i > -n) return -i;
  if (i >= n && i < 2 * n - 1) return 2 * (n - 1) - i;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// The folded sum centred on w[c] (see the header for the order).
template <int R>
__device__ __forceinline__ float folded(const float* w, int c, const float* k) {
  float acc = __fmul_rn(k[0], w[c]);
#pragma unroll
  for (int t = 1; t <= R; ++t)
    acc = __fadd_rn(acc, __fmul_rn(k[t], __fadd_rn(w[c - t], w[c + t])));
  return acc;
}

// Put pixel x of a staged row (r at its kPad) and its images in the halo.
// W >= kR + 1, so one fold reaches across the halo.
__device__ __forceinline__ void put_row(float* r, int x, int w, float v) {
  r[x] = v;
  if (x >= 1 && x <= kR) r[-x] = v;
  if (x >= w - 1 - kR && x <= w - 2) r[2 * (w - 1) - x] = v;
}

// Stage the heatmaps of maps map0 .. map0 + g_n - 1 (g_n <= G).  With
// channels innermost (sc == 1, channels-last) and G > 1, neighbouring
// threads read the G maps' channels of one pixel, which share 128-byte
// lines; otherwise a map at a time, 16-byte loads where rows allow.
template <int G>
__device__ __forceinline__ void stage(const Net& net, int H, int W, int map0,
                                      int g_n, float* s_in) {
  const int hw = H * W;
  const int P = staged_pitch(W);
  if (G > 1 && net.sc == 1) {
    const int g = threadIdx.x % G;
    if (g >= g_n) return;
    const float* chan = net.channel(map0 + g, 0);
    float* dst = s_in + g * H * P + kPad;
    constexpr int kStep = kThreads / G;
    for (int i0 = threadIdx.x / G; i0 < hw; i0 += kStep * kDepth) {
      float v[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int i = i0 + u * kStep;
        if (i < hw) {
          const int y = i / W;
          v[u] = __ldg(chan + y * net.sh + (i - y * W) * net.sw);
        }
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int i = i0 + u * kStep;
        if (i < hw) {
          const int y = i / W;
          put_row(dst + y * P, i - y * W, W, v[u]);
        }
      }
    }
    return;
  }
  for (int g = 0; g < g_n; ++g) {
    const float* chan = net.channel(map0 + g, 0);
    float* dst = s_in + g * H * P + kPad;
    if (net.sw == 1 && (W & 3) == 0 && (net.sh & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(chan) & 15) == 0) {
      const int wq = W / 4;
      for (int q0 = threadIdx.x; q0 < hw / 4; q0 += kThreads * 4) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * kThreads;
          if (q < hw / 4) {
            const int y = q / wq;
            v[u] = __ldg(reinterpret_cast<const float4*>(
                chan + y * net.sh + 4 * (q - y * wq)));
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * kThreads;
          if (q < hw / 4) {
            const int y = q / wq;
            const int x = 4 * (q - y * wq);
            float* r = dst + y * P;
            *reinterpret_cast<float4*>(r + x) = v[u];
            if (x <= kR || x + 3 >= W - 1 - kR) {
              put_row(r, x, W, v[u].x);
              put_row(r, x + 1, W, v[u].y);
              put_row(r, x + 2, W, v[u].z);
              put_row(r, x + 3, W, v[u].w);
            }
          }
        }
      }
    } else {
      for (int i0 = threadIdx.x; i0 < hw; i0 += kThreads * kDepth) {
        float v[kDepth];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int i = i0 + u * kThreads;
          if (i < hw) {
            const int y = i / W;
            v[u] = __ldg(chan + y * net.sh + (i - y * W) * net.sw);
          }
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int i = i0 + u * kThreads;
          if (i < hw) {
            const int y = i / W;
            put_row(dst + y * P, i - y * W, W, v[u]);
          }
        }
      }
    }
  }
}

// A block per G maps (G = 2 when channels are innermost, else 1).  kH,
// kW > 0 fix the map size at compile time (the serving 64x48 heatmaps),
// which turns the index arithmetic of the passes into constants; 0
// takes it from net.  Per map: the W pass row by row, the H
// pass down the columns, each output ranked as it is made, and the
// block's peak; then a warp per map reads the offsets at its peak.
template <int G, int kH, int kW>
// 5 blocks a SM (at most 48 registers a thread).
__global__ void __launch_bounds__(kThreads, 5)
udp_decode_kernel(Net net, int n_maps, float kpd, Taps taps,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ int s_at[G];
  __shared__ float s_bv[G];
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  const int H = kH > 0 ? kH : net.H;
  const int W = kW > 0 ? kW : net.W;
  const int P = staged_pitch(W);
  float* s_in = reinterpret_cast<float*>(smem4);
  float* s_mid = s_in + G * H * P;
  const int map0 = blockIdx.x * G;
  const int g_n = n_maps - map0 < G ? n_maps - map0 : G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  stage<G>(net, H, W, map0, g_n, s_in);
  __syncthreads();

  const int gw = round4(W) / 4;
  const int gh = round4(H) / 4;
  const bool vec_rows = (W & 3) == 0;
  for (int g = 0; g < g_n; ++g) {
    // W pass: four outputs x0 .. x0 + 3 of row y from the window of
    // staged columns x0 - 8 .. x0 + 11
    const float* src = s_in + g * H * P;
    for (int q = tid; q < H * gw; q += kThreads) {
      const int y = q / gw;
      const int x0 = 4 * (q - y * gw);
      const float4* r4 = reinterpret_cast<const float4*>(src + y * P + x0);
      float win[20];
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const float4 v = r4[u];
        win[4 * u] = v.x;
        win[4 * u + 1] = v.y;
        win[4 * u + 2] = v.z;
        win[4 * u + 3] = v.w;
      }
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = folded<kR>(win, kPad + e, taps.k15);
      // image row y lands at mid row y + kR and at its REFLECT_101 images
      const int r1 = y >= 1 && y <= kR ? kR - y : -1;
      const int r2 = y >= H - 1 - kR && y <= H - 2 ? kR + 2 * (H - 1) - y : -1;
      if (vec_rows) {
        const float4 o4 = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(s_mid + (y + kR) * W + x0) = o4;
        if (r1 >= 0) *reinterpret_cast<float4*>(s_mid + r1 * W + x0) = o4;
        if (r2 >= 0) *reinterpret_cast<float4*>(s_mid + r2 * W + x0) = o4;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x0 + e >= W) break;
          s_mid[(y + kR) * W + x0 + e] = o[e];
          if (r1 >= 0) s_mid[r1 * W + x0 + e] = o[e];
          if (r2 >= 0) s_mid[r2 * W + x0 + e] = o[e];
        }
      }
    }
    __syncthreads();

    // H pass: four outputs y0 .. y0 + 3 of column x from mid rows y0 ..
    // y0 + 17, ranked as made
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int q = tid; q < gh * W; q += kThreads) {
      const int y0 = 4 * (q / W);
      const int x = q - (y0 / 4) * W;
      const float* c = s_mid + y0 * W + x;
      float win[18];
#pragma unroll
      for (int u = 0; u < 18; ++u) win[u] = c[u * W];
      // the item's best first (its rows rise), then one full comparison
      float iv = folded<kR>(win, kR, taps.k15);
      int ie = 0;
#pragma unroll
      for (int e = 1; e < 4; ++e)
        if (y0 + e < H) scan(folded<kR>(win, kR + e, taps.k15), e, iv, ie);
      consider(iv, (y0 + ie) * W + x, bv, bi);
    }
    warp_reduce(bv, bi);
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();  // also frees s_mid for the next map's W pass
    if (warp == 0) {
      bv = lane < kWarps ? s_val[lane] : -INFINITY;
      bi = lane < kWarps ? s_idx[lane] : INT_MAX;
      warp_reduce(bv, bi);
      if (lane == 0) {
        s_at[g] = bv > 0.f ? bi : 0;  // false for NaN
        s_bv[g] = bv;
      }
    }
  }
  __syncthreads();

  // a warp per map: the 7x7 blur of kpd * offsets at the peak only: lane
  // 8s + d (d < 7) makes the W pass of row py + d - 3 of map s (0: off_x,
  // 1: off_y)
  if (warp >= g_n) return;
  const int at = s_at[warp];
  const int py = at / W;
  const int px = at - py * W;
  const int d = lane & 7;
  float m = 0.f;
  if (lane < 16 && d < 7) {
    const float* off = net.channel(map0 + warp, 1 + (lane >> 3)) +
                       reflect101(py + d - kR7, H) * net.sh;
    float v[2 * kR7 + 1];
#pragma unroll
    for (int e = 0; e <= 2 * kR7; ++e)
      v[e] = __fmul_rn(__ldg(off + reflect101(px + e - kR7, W) * net.sw), kpd);
    m = folded<kR7>(v, kR7, taps.k7);
  }
  float col[2 * kR7 + 1];
#pragma unroll
  for (int e = 0; e <= 2 * kR7; ++e)
    col[e] = __shfl_sync(kFull, m, (lane & 8) + e);
  const float blurred = folded<kR7>(col, kR7, taps.k7);  // at lanes 0, 8
  const float bx = __shfl_sync(kFull, blurred, 0);
  const float by = __shfl_sync(kFull, blurred, 8);
  if (lane == 0)
    write_packed(out + static_cast<size_t>(map0 + warp) * 5, at, W,
                 s_bv[warp], bx, by);
}

template <int G, int kH, int kW>
int launch_decode(const Net& net, int n_maps, float kpd, const Taps& taps,
                  float* out, cudaStream_t stream) {
  const size_t smem = fused_smem_bytes(G, net.H, net.W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        udp_decode_kernel<G, kH, kW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  udp_decode_kernel<G, kH, kW><<<(n_maps + G - 1) / G, kThreads, smem,
                                 stream>>>(net, n_maps, kpd, taps, out);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_decode(const Net& net, int n_maps, float kpd, const Taps& taps,
                  float* out, cudaStream_t stream) {
  if (net.H == 64 && net.W == 48)
    return launch_decode<G, 64, 48>(net, n_maps, kpd, taps, out, stream);
  return launch_decode<G, 0, 0>(net, n_maps, kpd, taps, out, stream);
}

}  // namespace

// hm, ox, oy: (n, hw) contiguous float32 device pointers; out: (n, 5).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int peak_offset_launch(const void* hm, const void* ox,
                                  const void* oy, void* out, int n, int hw,
                                  int w, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kPeakWarps - 1) / kPeakWarps;
  peak_offset_kernel<<<blocks, kPeakWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<float*>(out), n, hw, w);
  return static_cast<int>(cudaGetLastError());
}

// net: (b, 3j, h, w) float32 with element strides sb, sc, sh, sw; k15
// (8 floats) and k7 (4 floats): host arrays of the folded taps; out:
// (b, j, 5) contiguous.  h, w >= 8.  Returns the cudaError_t (0 on success).
extern "C" int udp_decode_launch(const void* net, long long sb, long long sc,
                                 long long sh, long long sw, int b, int j,
                                 int h, int w, float kpd, const float* k15,
                                 const float* k7, void* out, void* stream) {
  if (b == 0 || j == 0) return static_cast<int>(cudaSuccess);
  if (h <= kR || w <= kR) return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int t = 0; t <= kR; ++t) taps.k15[t] = k15[t];
  for (int t = 0; t <= kR7; ++t) taps.k7[t] = k7[t];
  const Net view{static_cast<const float*>(net), sb, sc, sh, sw, j, h, w};
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sc == 1 ? launch_decode<2>(view, b * j, kpd, taps, o, s)
                 : launch_decode<1>(view, b * j, kpd, taps, o, s);
}
