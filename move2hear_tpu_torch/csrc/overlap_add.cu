// ISTFT overlap-add with the inverse squared-window envelope, for sm_90a.
//
// Replaces the TPU kernel move2hear_tpu/ops/pallas_kernels.py: _ola_kernel
// (launched by _ola_call), which accumulated Hann-windowed frames into a
// VMEM-resident output row with a sequential loop over frames.
//
// frames: float32 (B, n_frames, n_fft), C-contiguous irfft frames.
// win: float32 (n_fft,) analysis window; inv_env: float32 (out_len,) inverse
// of the summed squared window (1 where the envelope vanishes).
// out: float32 (B, out_len), out_len = n_fft + hop * (n_frames - 1).
//
// Bound: bytes (each frame sample is read once, each output written once; a
// handful of flops per sample). A TPU grid step could carry the running sum
// in VMEM; Hopper blocks run in no order, so the design inverts the loop:
// one thread per OUTPUT sample gathers the frames that cover it (at most
// ceil(n_fft / hop), two at n_fft 1023 and hop 512), in ascending frame
// order. That needs no atomics, so the result is deterministic and the sum
// order matches the TPU kernel's. The products and sums use the _rn
// intrinsics so the compiler does not contract them into FMAs, which keeps
// the arithmetic identical to the plain PyTorch version.

#include <cuda_runtime.h>

__global__ void overlap_add_kernel(const float* __restrict__ frames,
                                   const float* __restrict__ win,
                                   const float* __restrict__ inv_env,
                                   float* __restrict__ out, int B,
                                   int n_frames, int n_fft, int hop,
                                   int out_len) {
  const long long n = (long long)B * out_len;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int s = (int)(idx % out_len);
  const int b = (int)(idx / out_len);
  int i_hi = s / hop;
  if (i_hi > n_frames - 1) i_hi = n_frames - 1;
  // first frame whose span [i*hop, i*hop + n_fft) still covers s
  const int i_lo = (s - n_fft + 1 <= 0) ? 0 : (s - n_fft + hop) / hop;
  const float* fb = frames + (long long)b * n_frames * n_fft;
  float acc = 0.0f;
  for (int i = i_lo; i <= i_hi; ++i) {
    const int j = s - i * hop;
    acc = __fadd_rn(acc, __fmul_rn(fb[(long long)i * n_fft + j], win[j]));
  }
  out[idx] = __fmul_rn(acc, inv_env[s]);
}

extern "C" int overlap_add_launch(const void* frames, const void* win,
                                  const void* inv_env, void* out, int B,
                                  int n_frames, int n_fft, int hop,
                                  int out_len, void* stream) {
  const long long n = (long long)B * out_len;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  overlap_add_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)win, (const float*)inv_env,
      (float*)out, B, n_frames, n_fft, hop, out_len);
  return (int)cudaGetLastError();
}
