// ISTFT overlap-add with the inverse squared-window envelope, for sm_90a.
//
// Replaces the TPU kernel move2hear_tpu/ops/pallas_kernels.py: _ola_kernel
// (launched by _ola_call), which accumulated Hann-windowed frames into a
// VMEM-resident output row with a sequential loop over frames.
//
// frames: float32 (B, n_frames, n_fft), C-contiguous irfft frames.
// win: float32 (n_fft,) analysis window; inv_env: float32 (out_len,) inverse
// of the summed squared window (1 where the envelope vanishes), with
// out_len = n_fft + hop * (n_frames - 1).
// out: float32 (B, length), samples [start, start + length) of the full
// overlap-add. The ISTFT asks for the samples it keeps (start n_fft / 2,
// length 16000), so the centring trim costs no extra pass.
//
// Bound: bytes. Each frame sample is read once and each output sample
// written once, with two float operations per frame sample and one per
// output sample. At the eval path's sizes (0.3 to 1.3 M output samples) a
// launch is short enough that its issue cost and its dependent round trips
// to memory count as much as its bytes, so the design spends few
// instructions per byte and makes one round trip:
// - a 2-D grid, blockIdx.y the signal row, blockIdx.x a tile of 512 output
//   samples: a thread finds its row and samples with no divide;
// - each thread computes 4 consecutive output samples s0..s0+3 in 32-bit
//   indexing, starting at a 16-byte boundary of the output row, so they
//   leave in one float4 store. Where a row does not start on one (length not
//   a multiple of 4), the first and last thread of the row compute all 4
//   lanes but store only their in-range samples;
// - one divide by hop gives the frame q that starts at or before s0. When
//   at most 2 frames cover a sample (ceil(n_fft / hop) = 2 on the path)
//   and hop >= 4, the frames q-1 .. q+1 are the only ones that can cover
//   the 4 samples, so the thread issues all their frame and window loads
//   (24, each lane's predicated on its frame covering it) before it adds
//   any of them: one round trip, not one per frame. Other n_fft and hop
//   take the general kernel, which walks the covering frames 4 at a time.
// The TPU kernel's running sum in VMEM does not carry over: blocks run in no
// order. Each output sample gathers its frames in ascending frame order, so
// the sum order is the TPU kernel's, no atomics are needed and the result
// is deterministic. A lane that a frame does not cover adds 0 * 0 = +0,
// which leaves the running sum as it is (it starts at +0 and so is never
// -0). The products and sums use the _rn intrinsics so the compiler does
// not contract them into FMAs: the result is bitwise equal to the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 output samples a thread, 512 a block
constexpr int kCover = 2;  // frames covering a sample in the fast kernel
constexpr int kGeneralPass = 4;  // frames the general kernel loads at once

struct Lanes {
  float* orow;  // the output row
  int k0;       // output index of lane 0 (negative in a row's head)
  int s0;       // signal sample of lane 0
  bool whole;   // all 4 lanes in the row
};

// The 4 lanes of this thread, or false when they lie past the row's end.
__device__ __forceinline__ bool lanes_of(float* out, int start, int length,
                                         Lanes* l) {
  l->orow = out + blockIdx.y * length;
  // floats between the row's start and the 16-byte boundary at or below it
  const int head = (int)((reinterpret_cast<uintptr_t>(l->orow) >> 2) & 3);
  l->k0 = 4 * (blockIdx.x * kThreads + threadIdx.x) - head;
  l->s0 = start + l->k0;
  l->whole = l->k0 >= 0 && l->k0 + 3 < length;
  return l->k0 < length;
}

// inv_env at each lane's sample, clamped into the row for lanes outside it
__device__ __forceinline__ void load_env(const float* __restrict__ inv_env,
                                         const Lanes& l, int start, int length,
                                         float e[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int s = min(max(l.s0 + u, start), start + length - 1);
    e[u] = inv_env[s];
  }
}

__device__ __forceinline__ void store(const Lanes& l, int length,
                                      const float acc[4], const float e[4]) {
  float r[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) r[u] = __fmul_rn(acc[u], e[u]);
  if (l.whole) {
    *reinterpret_cast<float4*>(l.orow + l.k0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = l.k0 + u;
      if (k >= 0 && k < length) l.orow[k] = r[u];
    }
  }
}

// At most kCover frames cover a sample, and hop >= 4.
__global__ void __launch_bounds__(kThreads) overlap_add_kernel(
    const float* __restrict__ frames, const float* __restrict__ win,
    const float* __restrict__ inv_env, float* __restrict__ out, int n_frames,
    int n_fft, int hop, int start, int length) {
  Lanes l;
  if (!lanes_of(out, start, length, &l)) return;
  float e[4];
  load_env(inv_env, l, start, length, e);
  const int q = (l.s0 + hop) / hop - 1;  // floor(s0 / hop); s0 >= -3 > -hop
  const float* fb = frames + blockIdx.y * n_frames * n_fft;
  float v[kCover + 1][4], w[kCover + 1][4];
#pragma unroll
  for (int d = 0; d <= kCover; ++d) {
    const int i = q - kCover + 1 + d;
    const int j0 = l.s0 - i * hop;
    const bool frame_ok = (unsigned)i < (unsigned)n_frames;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = frame_ok && (unsigned)(j0 + u) < (unsigned)n_fft;
      v[d][u] = ok ? fb[i * n_fft + j0 + u] : 0.0f;
      w[d][u] = ok ? win[j0 + u] : 0.0f;
    }
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d <= kCover; ++d) {
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(v[d][u], w[d][u]));
  }
  store(l, length, acc, e);
}

// Any n_fft and hop: walks the frames that can cover the 4 lanes.
__global__ void __launch_bounds__(kThreads) overlap_add_general_kernel(
    const float* __restrict__ frames, const float* __restrict__ win,
    const float* __restrict__ inv_env, float* __restrict__ out, int n_frames,
    int n_fft, int hop, int max_cover, int start, int length) {
  Lanes l;
  if (!lanes_of(out, start, length, &l)) return;
  float e[4];
  load_env(inv_env, l, start, length, e);
  const int s_first = max(l.s0, 0);
  const int q = s_first / hop;
  const int i_lo = max(q - max_cover + 1, 0);
  int i_hi = q;
  while ((i_hi + 1) * hop <= l.s0 + 3) ++i_hi;
  i_hi = min(i_hi, n_frames - 1);
  const float* fb = frames + blockIdx.y * n_frames * n_fft;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i0 = i_lo; i0 <= i_hi; i0 += kGeneralPass) {
    float v[kGeneralPass][4], w[kGeneralPass][4];
#pragma unroll
    for (int d = 0; d < kGeneralPass; ++d) {
      const int i = i0 + d;
      const int j0 = l.s0 - i * hop;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = i <= i_hi && (unsigned)(j0 + u) < (unsigned)n_fft;
        v[d][u] = ok ? fb[i * n_fft + j0 + u] : 0.0f;
        w[d][u] = ok ? win[j0 + u] : 0.0f;
      }
    }
#pragma unroll
    for (int d = 0; d < kGeneralPass; ++d) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(v[d][u], w[d][u]));
    }
  }
  store(l, length, acc, e);
}

}  // namespace

// The wrapper (ops/kernels.py) has checked that 0 <= start, start + length
// <= out_len, B <= 65535 and that B * n_frames * n_fft and B * length fit in
// a 32-bit int.
extern "C" int overlap_add_launch(const void* frames, const void* win,
                                  const void* inv_env, void* out, int B,
                                  int n_frames, int n_fft, int hop, int start,
                                  int length, void* stream) {
  if (B == 0 || length == 0) return 0;
  // threads a row needs: ceil((length + head) / 4) for a head of up to 3
  const int row_threads = (length + 6) / 4;
  const dim3 grid((row_threads + kThreads - 1) / kThreads, B);
  const int max_cover = (n_fft + hop - 1) / hop;
  cudaStream_t s = (cudaStream_t)stream;
  const float* f = (const float*)frames;
  const float* w = (const float*)win;
  const float* e = (const float*)inv_env;
  float* o = (float*)out;
  if (max_cover <= kCover && hop >= 4) {
    overlap_add_kernel<<<grid, kThreads, 0, s>>>(f, w, e, o, n_frames, n_fft, hop,
                                                    start, length);
  } else {
    overlap_add_general_kernel<<<grid, kThreads, 0, s>>>(
        f, w, e, o, n_frames, n_fft, hop, max_cover, start, length);
  }
  return (int)cudaGetLastError();
}
