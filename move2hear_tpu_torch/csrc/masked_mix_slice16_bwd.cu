// Backward of the fused masked-mix + log1p + 16-way frequency slice, written
// for sm_90a.
//
// Replaces move2hear_tpu/ops/pallas_kernels.py:_masked_mix_slice16_bwd, the
// analytic custom-VJP backward of _masked_mix_slice16_kernel (in the JAX
// package it is jnp code that XLA fuses, not a Pallas kernel). With
// u = expm1(mix) * mask and the forward y = log1p(max(u, 0)):
//   du    = g / (1 + u) where u > 0, else 0
//   dmix  = du * exp(mix) * mask
//   dmask = du * expm1(mix)
// where g is the cotangent of y taken back through the slice permutation.
//
// mix, mask, dmix and dmask are float32 (B, F, T, C), C-contiguous; g is the
// float32 NCHW cotangent (B, C*K, F/K, T), channel c*K + chunk, row f' of
// chunk = f / (F/K). The de-slice is the load index of g, so the op is one
// pass over memory.
//
// Bound: bytes. Each element reads mix, mask and g and writes dmix and dmask,
// 20 bytes, against about ten float operations, far below the card's
// compute-to-bandwidth ratio. One kernel serves every shape: a 3-D grid,
// blockIdx.z the batch, blockIdx.y the chunk, threadIdx.y with blockIdx.x the
// row f' in the chunk, so indices come from the grid with no divide; one
// thread per (b, f, t) walks the C channels. Round-to-nearest intrinsics keep
// the compiler from contracting 1 + expm1(x) * m into one fma, so the result
// is the plain version's arithmetic up to the library's expf/expm1f. The
// training path never runs this backward (its inputs are stored tensors), so
// it is kept simple; vector loads wait for a path that launches it.
//
// The bfloat16-mask variant (masked_mix_slice16_bwd_bf16_launch) takes the
// forward's other pair, a float32 mix with a bfloat16 mask, widens each mask
// element to float32 on load and writes dmask in float32, as the JAX custom
// VJP computes it; autograd casts it to the mask's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// (dmix, dmask) of one element from its input x, mask m and cotangent gd.
__device__ __forceinline__ float2 masked_log1p_bwd(float x, float m, float gd) {
  const float e = expm1f(x);
  const float u = __fmul_rn(e, m);
  const float du = u > 0.0f ? __fdiv_rn(gd, __fadd_rn(1.0f, u)) : 0.0f;
  return make_float2(__fmul_rn(__fmul_rn(du, expf(x)), m), __fmul_rn(du, e));
}

__device__ __forceinline__ float load1(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// One thread per (b, f, t), all C channels; any element-aligned pointers.
template <typename MaskT>
__global__ void __launch_bounds__(kThreads) masked_mix_slice16_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ mix,
    const MaskT* __restrict__ mask, float* __restrict__ dmix,
    float* __restrict__ dmask, int F, int T, int C, int K, int fk) {
  const int fp = blockIdx.x * blockDim.y + threadIdx.y;
  if (fp >= fk) return;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int row = (b * F + chunk * fk + fp) * T * C;
  const float* gr = g + ((b * C * K + chunk) * fk + fp) * T;
  const int c_stride = K * fk * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    for (int c = 0; c < C; ++c) {
      const int i = row + t * C + c;
      const float2 r = masked_log1p_bwd(mix[i], load1(mask, i), gr[c * c_stride + t]);
      dmix[i] = r.x;
      dmask[i] = r.y;
    }
  }
}

template <typename MaskT>
int launch(const void* g, const void* mix, const void* mask, void* dmix, void* dmask,
           int B, int F, int T, int C, int K, void* stream) {
  if (B == 0 || F == 0 || T == 0 || C == 0) return 0;
  const int fk = F / K;
  cudaStream_t s = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  const float* a = (const float*)mix;
  const MaskT* m = (const MaskT*)mask;
  float* dx = (float*)dmix;
  float* dm = (float*)dmask;
  // threadIdx.x walks the time steps of a row, threadIdx.y the rows f'
  const int tx = T < 32 ? T : 32;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid((fk + ty - 1) / ty, K, B);
  masked_mix_slice16_bwd_kernel<MaskT><<<grid, block, 0, s>>>(gg, a, m, dx, dm, F, T, C, K, fk);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper (ops/kernels.py) has checked the shapes, that F is a multiple
// of K, B <= 65535 and that B * F * T * C fits in a 32-bit int.
extern "C" int masked_mix_slice16_bwd_launch(const void* g, const void* mix,
                                             const void* mask, void* dmix,
                                             void* dmask, int B, int F, int T,
                                             int C, int K, void* stream) {
  return launch<float>(g, mix, mask, dmix, dmask, B, F, T, C, K, stream);
}

// A float32 mix with a bfloat16 mask; dmask is float32. The same checks.
extern "C" int masked_mix_slice16_bwd_bf16_launch(const void* g, const void* mix,
                                                  const void* mask, void* dmix,
                                                  void* dmask, int B, int F, int T,
                                                  int C, int K, void* stream) {
  return launch<__nv_bfloat16>(g, mix, mask, dmix, dmask, B, F, T, C, K, stream);
}
