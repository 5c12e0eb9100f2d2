// The two elementwise halves of the port's int8 (w8a8) convolution, the
// work XLA fuses around the int8 conv of the JAX package's PTQ serving
// mode (udp_pose_tpu/models/quantize.py, _quantized_conv):
//
//   quant_im2col_kernel      activation quantise (:203-204 there),
//                            x_i8 = clip(rint(x * inv_s_a), -127, 127),
//                            written as the (M, K_pad) patch matrix of the
//                            integer GEMM, taps in (kh, kw, cin) order;
//   dequant_epilogue_kernel  the dequant epilogue (:214-218 there),
//                            out = cast(float(acc) * scale[c] + bias[c]).
//
// Between them the int32 GEMM is torch._int_mm (cuBLASLt), as the JAX
// package leaves the conv itself to XLA.  They replace no Pallas kernel.
//
// Rounding is the JAX package's to the bit: rintf rounds half to even
// (jnp.round), every multiply and add is an explicit __fmul_rn/__fadd_rn
// so that nvcc contracts nothing into an FMA, float(acc) rounds to
// nearest, and the cast to bf16 rounds to nearest even.
//
// Bound on this card: bytes.  The im2col reads the activation once per tap
// (kh*kw times; the L2 catches most re-reads) and writes M*K_pad bytes; the
// epilogue reads 4 bytes and writes 2 or 4 an output.  Both are plain
// grid-stride loops with 8-byte stores (im2col) and 16-byte loads
// (epilogue): simple first.  The fast form is one implicit-GEMM kernel
// that quantises on load and applies the epilogue in registers, so that
// neither the patch matrix nor the int32 accumulators reach device memory.

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
