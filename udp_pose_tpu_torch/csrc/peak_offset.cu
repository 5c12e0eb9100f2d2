// Fused peak-find + offset gather for the UDP offset decode, for Hopper.
//
// Replaces the TPU kernel udp_pose_tpu/ops/pallas/decode_kernels.py
// (_make_kernel / fused_peak_offset, pallas_call at :83).  It follows the
// default XLA decode (udp_pose_tpu/ops/decode.py:95-112), not that file's
// wrapper: when a map's peak is <= 0 the peak is masked to (0, 0) and the
// offsets are read at flat index 0.
//
// Per map n of N (rows of H*W floats, all three inputs contiguous):
//   idx     = lowest flat index attaining the row max (ties -> lowest)
//   maxval  = hm[n, idx]
//   if maxval > 0:  out = [idx % W, idx / W, maxval, ox[n, idx], oy[n, idx]]
//   else:           out = [0,       0,       maxval, ox[n, 0],   oy[n, 0]]
// NaN: a NaN ranks above every number, and among NaNs the lowest index
// wins (torch.argmax / numpy.argmax order), so a row holding a NaN gets
// maxval = NaN; NaN > 0 is false, so it takes the masked branch.  The
// plain version (ops/peak_offset.fused_peak_offset_reference) gives the
// same five values.  idx / W is integer division, equal to the reference's
// floor(float(idx) / W) for every H*W < 2^24 (the wrapper checks).
//
// Bound: the kernel must read the N*H*W heatmap once (26.7 MB at the
// serving shape N = 128*17, 64x48) plus 2 offsets and 5 outputs per map,
// so it is bound by device-memory bytes (~8 us at 3.35 TB/s).  Design:
// one block per map; coalesced strided loads with a (value, index) pair
// per thread; a warp-shuffle reduce, then one across the block's warps
// through shared memory; thread 0 reads the two offsets directly.  The
// TPU kernel's one-hot select-reduce over the offset maps, its padding of
// N to groups of 8 and its 128-lane output were layout constraints of the
// TPU and are gone: the offset maps are touched at two addresses per map.
// Launches on the caller's stream, allocates nothing, does not synchronise.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Does (v, i) rank above (bv, bi)?  NaN above numbers; ties to lower index.
__device__ __forceinline__ bool ranks_above(float v, int i, float bv, int bi) {
  const bool v_nan = isnan(v);
  const bool b_nan = isnan(bv);
  if (v_nan || b_nan) return v_nan && (!b_nan || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_reduce(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (ranks_above(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
peak_offset_kernel(const float* __restrict__ hm, const float* __restrict__ ox,
                   const float* __restrict__ oy, float* __restrict__ out,
                   int hw, int w) {
  const size_t base = static_cast<size_t>(blockIdx.x) * hw;
  const float* row = hm + base;

  // (-inf, INT_MAX) loses to every real element, -inf included.
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const float v = row[i];
    if (ranks_above(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  warp_reduce(bv, bi);

  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;
  bv = lane < kWarps ? s_val[lane] : -INFINITY;
  bi = lane < kWarps ? s_idx[lane] : INT_MAX;
  warp_reduce(bv, bi);
  if (lane != 0) return;

  const bool peak = bv > 0.f;  // false for NaN
  const int at = peak ? bi : 0;
  float* o = out + static_cast<size_t>(blockIdx.x) * 5;
  o[0] = peak ? static_cast<float>(bi % w) : 0.f;
  o[1] = peak ? static_cast<float>(bi / w) : 0.f;
  o[2] = bv;
  o[3] = ox[base + at];
  o[4] = oy[base + at];
}

}  // namespace

// hm, ox, oy: (n, hw) contiguous float32 device pointers; out: (n, 5).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int peak_offset_launch(const void* hm, const void* ox,
                                  const void* oy, void* out, int n, int hw,
                                  int w, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  peak_offset_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<float*>(out), hw, w);
  return static_cast<int>(cudaGetLastError());
}
