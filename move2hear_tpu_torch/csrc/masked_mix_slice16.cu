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
// few transcendentals, far below the card's compute-to-bandwidth ratio. The
// design keeps one thread per (b, f, t) position: its C channel values are
// adjacent in memory (one 8-byte run for C = 2, contiguous across the warp),
// and its C stores land in C rows of the output where neighbouring threads
// (neighbouring t) write neighbouring addresses, so loads and stores both
// coalesce. No shared memory, no atomics.

#include <cuda_runtime.h>

__global__ void masked_mix_slice16_kernel(
    const float* __restrict__ mix, const float* __restrict__ mask,
    float* __restrict__ out, int B, int F, int T, int C, int K) {
  const long long n = (long long)B * F * T;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int t = (int)(idx % T);
  const long long bf = idx / T;
  const int f = (int)(bf % F);
  const int b = (int)(bf / F);
  const int fk = F / K;
  const int chunk = f / fk;
  const int fp = f - chunk * fk;
  const float* mx = mix + idx * C;
  const float* mk = mask + idx * C;
  for (int c = 0; c < C; ++c) {
    const float u = expm1f(mx[c]) * mk[c];
    const float y = log1pf(fmaxf(u, 0.0f));
    const long long ch = (long long)b * C * K + (long long)c * K + chunk;
    out[(ch * fk + fp) * T + t] = y;
  }
}

extern "C" int masked_mix_slice16_launch(const void* mix, const void* mask,
                                         void* out, int B, int F, int T,
                                         int C, int K, void* stream) {
  const long long n = (long long)B * F * T;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  masked_mix_slice16_kernel<<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)mix, (const float*)mask, (float*)out, B, F, T, C, K);
  return (int)cudaGetLastError();
}
