// Ideal ADC quantize + reconstruct for Hopper (sm_90a), elementwise.
//
// Replaces the Pallas TPU kernel `_adc_quant_kernel`
// (src/repro/kernels/cim_matmul.py): codes = clip(floor(v / vdd * 2^B), 0,
// 2^B - 1), out = (codes + 0.5) * (vdd / 2^B), over a float32 tensor.
//
// What bounds it on this card: one float32 read and one float32 write per
// element (8 bytes) against a few operations, so the bound is the bytes at
// the memory rate. What the design does: a streaming pass. Each thread moves
// 16-byte float4s, UNROLL of them in flight (all loads issued before the
// first store), with streaming cache hints (__ldcs / __stcs: the data is
// touched once). The grid is sized to the blocks the H100's 132 SMs hold at
// once, not to the element count, and strides over the rest. Any contiguous length and
// start work: the elements before v's first 16-byte boundary (the head, 0..3
// of them) and the 0..3 after the last whole float4 (the tail) are done one
// by one; the wrapper gives `out` the same alignment as `v` modulo 16 bytes,
// so one index serves both. The arithmetic is the plain version's: the
// divide is __fdiv_rn (never a reciprocal multiply, never --use_fast_math)
// and the multiplies and the add are __fmul_rn / __fadd_rn, so nvcc cannot
// contract them: the result equals the plain version bit for bit. `scale` is
// vdd / 2^B rounded once to float32 on the host, as the JAX package rounds
// the Python float vdd / n. The clamp is written with comparisons so that a
// NaN passes through as torch.clamp passes it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;           // float4s in flight per thread
constexpr int BLOCKS_PER_SM = 8;    // 2048 resident threads per SM
constexpr int SMS = 132;            // the H100's SMs

__device__ __forceinline__ float quantize(float v, float vdd, float n_codes, float scale) {
  float c = floorf(__fmul_rn(__fdiv_rn(v, vdd), n_codes));
  c = c < 0.f ? 0.f : (c > n_codes - 1.f ? n_codes - 1.f : c);
  return __fmul_rn(__fadd_rn(c, 0.5f), scale);
}

__global__ void __launch_bounds__(THREADS)
adc_quant_kernel(const float* __restrict__ v, float* __restrict__ out, long long n, int head,
                 float vdd, float n_codes, float scale) {
  const long long nvec = (n - head) / 4;
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  float4* o4 = reinterpret_cast<float4*>(out + head);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS * UNROLL;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS * UNROLL + threadIdx.x; base < nvec;
       base += stride) {
    float4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * THREADS < nvec) r[u] = __ldcs(v4 + base + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS < nvec) {
        float4 q;
        q.x = quantize(r[u].x, vdd, n_codes, scale);
        q.y = quantize(r[u].y, vdd, n_codes, scale);
        q.z = quantize(r[u].z, vdd, n_codes, scale);
        q.w = quantize(r[u].w, vdd, n_codes, scale);
        __stcs(o4 + base + u * THREADS, q);
      }
    }
  }
  if (blockIdx.x == 0) {  // the head and the tail, at most 3 elements each
    const long long tail = head + nvec * 4;
    if (threadIdx.x < head) out[threadIdx.x] = quantize(v[threadIdx.x], vdd, n_codes, scale);
    else if (threadIdx.x >= 4 && tail + threadIdx.x - 4 < n)
      out[tail + threadIdx.x - 4] = quantize(v[tail + threadIdx.x - 4], vdd, n_codes, scale);
  }
}

}  // namespace

// v and out: n contiguous float32 values, with the same address modulo 16
// bytes. Returns the launch's CUDA error, or 0.
extern "C" int adc_quant(const void* v, void* out, long long n, int bits, float vdd, float scale,
                         void* stream) {
  const uintptr_t pv = reinterpret_cast<uintptr_t>(v), po = reinterpret_cast<uintptr_t>(out);
  if (n < 1 || pv % 4 || (pv - po) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long to_edge = static_cast<long long>((16 - pv % 16) % 16 / 4);
  const int head = static_cast<int>(to_edge < n ? to_edge : n);
  const long long nvec = (n - head) / 4;
  const long long want = (nvec + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const long long cap = static_cast<long long>(SMS) * BLOCKS_PER_SM;
  const unsigned grid = static_cast<unsigned>(want < 1 ? 1 : (want < cap ? want : cap));
  adc_quant_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(out), n, head, vdd,
      static_cast<float>(1 << bits), scale);
  return static_cast<int>(cudaGetLastError());
}
