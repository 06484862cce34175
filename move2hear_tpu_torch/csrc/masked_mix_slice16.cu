// Fused masked-mix + log1p + 16-way frequency slice, written for sm_90a.
//
// Replaces the TPU kernel move2hear_tpu/ops/pallas_kernels.py:
// _masked_mix_slice16_kernel (launched by _masked_mix_slice16_call), which
// computed log1p(relu(expm1(mix) * mask)) per (batch, channel) block and left
// the final (B, C, k, F/k, T) -> (B, F/k, T, C*k) permutation to XLA.
//
// Inputs mix and mask are float32 (B, F, T, C), C-contiguous; the output is
// float32 (B, C*K, F/K, T), the NCHW layout the next Conv2d reads, with
// channel = c*K + chunk and chunk = f / (F/K). The permutation lives in the
// store index, so the whole op is one pass over memory.
//
// Bound: bytes. Each element does two loads and one store of 4 bytes and a
// few transcendentals, below the card's compute-to-bandwidth ratio. At the
// eval path's size (0.5 M elements, 6 MB) a launch is short enough that its
// instruction count and ramp-up count as much as its bytes, so the design
// spends few instructions per byte:
// - a 3-D grid, blockIdx.z the batch b and blockIdx.y the frequency chunk,
//   threadIdx.y (with blockIdx.x) the row f' within the chunk: every index
//   comes from the grid, with no divide;
// - one (b, f) input row is T*C contiguous floats (64 = 256 bytes on the
//   path, C = 2). A thread takes one float4 of it from each input, the 2
//   channels of 2 time steps, splits the channels in registers and writes
//   one float2 of 2 time steps into each of the 2 output rows
//   (b, c*K + chunk, f', :), each T contiguous floats;
// - expm1f and log1pf stay the accurate library functions, not the __expf
//   intrinsics, so the result stays within float32 rounding of the plain
//   version.
// The launcher takes that float4 kernel when C is 2, T is even and both
// inputs start on a 16-byte boundary; otherwise (a view with a storage
// offset, an odd T, another C) the scalar kernel, one thread per (b, f, t)
// and the same arithmetic.
//
// The bfloat16-mask variant (masked_mix_slice16_bf16_launch) is the same two
// kernels for a float32 mix and a bfloat16 mask, the pair the separators
// hand on under TPU.COMPUTE_DTYPE bfloat16; it writes float32, as the TPU
// kernel does for that pair (its output takes the mixture's dtype). A
// thread's 4 mask elements are one 8-byte load, widened to float32 in
// registers (a 16-bit shift, exact), so an element moves 10 bytes, not 12;
// the arithmetic after the load is the float32 kernel's. The vector kernel
// needs the mask on an 8-byte boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float masked_log1p(float x, float m) {
  return log1pf(fmaxf(expm1f(x) * m, 0.0f));
}

// Element v of a row as float32, and 4-element group v as a float4.
__device__ __forceinline__ float load1(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float4 load4(const float* p, int v) {
  return reinterpret_cast<const float4*>(p)[v];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int v) {
  // little-endian: element 2j in the low half of word j
  const uint2 w = reinterpret_cast<const uint2*>(p)[v];
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// C = 2 and every row of both inputs on a 16-byte (float mask) or 8-byte
// (bfloat16 mask) boundary: thread x of a row loads group x of 4 elements,
// time steps 2x and 2x + 1.
template <typename MaskT>
__global__ void __launch_bounds__(kThreads) masked_mix_slice16_c2_kernel(
    const float* __restrict__ mix, const MaskT* __restrict__ mask,
    float* __restrict__ out, int F, int T, int K, int fk) {
  const int fp = blockIdx.x * blockDim.y + threadIdx.y;
  if (fp >= fk) return;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int row = (b * F + chunk * fk + fp) * T * 2;
  const float4* mx = reinterpret_cast<const float4*>(mix + row);
  const MaskT* mk = mask + row;
  float* o = out + ((b * 2 * K + chunk) * fk + fp) * T;  // channel c = 0
  const int c_stride = K * fk * T;  // output channel chunk to K + chunk
  for (int v = threadIdx.x; v < T / 2; v += blockDim.x) {
    const float4 a = mx[v], e = load4(mk, v);  // (t c0, t c1, t+1 c0, t+1 c1)
    const int t = 2 * v;
    *reinterpret_cast<float2*>(o + t) =
        make_float2(masked_log1p(a.x, e.x), masked_log1p(a.z, e.z));
    *reinterpret_cast<float2*>(o + c_stride + t) =
        make_float2(masked_log1p(a.y, e.y), masked_log1p(a.w, e.w));
  }
}

// Any C and T, any element-aligned pointers: one thread per (b, f, t).
template <typename MaskT>
__global__ void __launch_bounds__(kThreads) masked_mix_slice16_scalar_kernel(
    const float* __restrict__ mix, const MaskT* __restrict__ mask,
    float* __restrict__ out, int F, int T, int C, int K, int fk) {
  const int fp = blockIdx.x * blockDim.y + threadIdx.y;
  if (fp >= fk) return;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int row = (b * F + chunk * fk + fp) * T * C;
  float* o = out + ((b * C * K + chunk) * fk + fp) * T;
  const int c_stride = K * fk * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    for (int c = 0; c < C; ++c) {
      o[c * c_stride + t] = masked_log1p(mix[row + t * C + c], load1(mask, row + t * C + c));
    }
  }
}

bool is_aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; }

template <typename MaskT>
int launch(const void* mix, const void* mask, void* out, int B, int F, int T, int C,
           int K, void* stream) {
  if (B == 0 || F == 0 || T == 0 || C == 0) return 0;
  const int fk = F / K;
  cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)mix;
  const MaskT* m = (const MaskT*)mask;
  float* y = (float*)out;
  const bool c2 = C == 2 && T % 2 == 0 && is_aligned(mix, 16) &&
                  is_aligned(mask, 4 * sizeof(MaskT)) && is_aligned(out, 16);
  // threadIdx.x walks a row (float4s or time steps), threadIdx.y the rows f'
  const int row_threads = c2 ? T / 2 : T;
  const int tx = row_threads < 32 ? row_threads : 32;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid((fk + ty - 1) / ty, K, B);
  if (c2) {
    masked_mix_slice16_c2_kernel<MaskT><<<grid, block, 0, s>>>(a, m, y, F, T, K, fk);
  } else {
    masked_mix_slice16_scalar_kernel<MaskT><<<grid, block, 0, s>>>(a, m, y, F, T, C, K, fk);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper (ops/kernels.py) has checked that F is a multiple of K,
// B <= 65535 and that B * F * T * C fits in a 32-bit int.
extern "C" int masked_mix_slice16_launch(const void* mix, const void* mask,
                                         void* out, int B, int F, int T,
                                         int C, int K, void* stream) {
  return launch<float>(mix, mask, out, B, F, T, C, K, stream);
}

// A float32 mix with a bfloat16 mask, the same checks.
extern "C" int masked_mix_slice16_bf16_launch(const void* mix, const void* mask,
                                              void* out, int B, int F, int T,
                                              int C, int K, void* stream) {
  return launch<__nv_bfloat16>(mix, mask, out, B, F, T, C, K, stream);
}
