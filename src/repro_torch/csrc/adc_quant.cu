// Ideal ADC quantize + reconstruct for Hopper (sm_90a), elementwise.
//
// Replaces the Pallas TPU kernel `_adc_quant_kernel`
// (src/repro/kernels/cim_matmul.py): codes = clip(floor(v / vdd * 2^B), 0,
// 2^B - 1), out = (codes + 0.5) * (vdd / 2^B), over a float32 tensor.
//
// What bounds it on this card: one float32 read and one float32 write per
// element (8 bytes) against a few operations, so the bound is the bytes at
// the memory rate. What the design does: one thread per element in a
// grid-stride loop, neighbouring threads on neighbouring addresses. The divide
// is __fdiv_rn (never a reciprocal multiply, never --use_fast_math) and the
// multiplies and the add are __fmul_rn / __fadd_rn, so nvcc cannot contract
// them: the result equals the plain version bit for bit. `scale` is vdd / 2^B
// rounded once to float32 on the host, as the JAX package rounds the Python
// float vdd / n. The clamp is written with comparisons so that a NaN passes
// through as torch.clamp passes it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
adc_quant_kernel(const float* __restrict__ v, float* __restrict__ out,
                 long long n, float vdd, float n_codes, float scale) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    float c = floorf(__fmul_rn(__fdiv_rn(v[i], vdd), n_codes));
    c = c < 0.f ? 0.f : (c > n_codes - 1.f ? n_codes - 1.f : c);
    out[i] = __fmul_rn(__fadd_rn(c, 0.5f), scale);
  }
}

}  // namespace

// v and out: n contiguous float32 values. Returns the launch's CUDA error, or 0.
extern "C" int adc_quant(const void* v, void* out, long long n, int bits,
                         float vdd, float scale, void* stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);
  adc_quant_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(out), n, vdd,
      (float)(1 << bits), scale);
  return static_cast<int>(cudaGetLastError());
}
