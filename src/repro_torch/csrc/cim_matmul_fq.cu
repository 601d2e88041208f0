// CiM fake-quant matmul for Hopper (sm_90a): y = sum_t q(x[:, t] . w[t, :]).
//
// Replaces the Pallas TPU kernel `_cim_matmul_kernel_fakequant`
// (src/repro/kernels/cim_matmul.py). The reduction dimension is cut into
// CiM-array tiles of `rows` word lines. Each tile's partial dot is an exact
// integer, quantized as round_half_even(p / step) * step and summed over the
// tiles in tile order in float32.
//
// What bounds it on this card: at the serving shapes (M = 1024 prefill rows,
// K <= 1536, N <= 1536) the int8 operands and the float32 output move a few
// MB, and the int8 tensor-core work is under a microsecond; the output write
// dominates that bound. This simple kernel is instead bound by its
// instruction issue: one __dp4a per 4 products and one IEEE divide per
// (output, tile). The design keeps the arithmetic exact first: operands are
// staged as int8 in shared memory, partial dots are int32 (__dp4a), the
// divide is __fdiv_rn (never a reciprocal, never --use_fast_math), and
// __fmul_rn / __fadd_rn stop the compiler from contracting the rounding
// steps into an FMA. No wgmma or TMA yet.
//
// Layout (prepared by repro_torch.kernels.cim_matmul.cim_matmul_fq):
//   x  (M, kw) int32 words, each word 4 int8 values along K;
//   wt (N, kw) int32 words, W transposed so K is contiguous for both;
//   out (M, N) float32.
// Every CiM tile spans `tile_words` words (the wrapper zero-pads a tile of
// `rows` int8 values to a multiple of 4). M and N edges are masked here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;         // output rows per block
constexpr int BN = 64;         // output columns per block
constexpr int KC = 32;         // int32 words of K staged per step
constexpr int THREADS = 256;   // 16 x 16 threads, each 4 x 4 outputs
constexpr int TM = 4;
constexpr int TN = 4;

__global__ void __launch_bounds__(THREADS)
cim_fq_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ wt,
              float* __restrict__ out, int M, int N, int kw, int tile_words,
              float step) {
  // K-major staging, padded by one word so the transposing stores do not
  // collide on a bank.
  __shared__ int32_t xs[KC][BM + 1];
  __shared__ int32_t ws[KC][BN + 1];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int32_t part[TM][TN];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      part[i][j] = 0;
      acc[i][j] = 0.f;
    }

  int word_in_tile = 0;
  for (int k0 = 0; k0 < kw; k0 += KC) {
    for (int i = threadIdx.x; i < BM * KC; i += THREADS) {
      const int r = i / KC;
      const int c = i % KC;
      const int gk = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      xs[c][r] = (gm < M && gk < kw) ? x[(size_t)gm * kw + gk] : 0;
      ws[c][r] = (gn < N && gk < kw) ? wt[(size_t)gn * kw + gk] : 0;
    }
    __syncthreads();

    const int kc = min(KC, kw - k0);
    for (int c = 0; c < kc; ++c) {
      int32_t a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = __dp4a(a[i], b[j], part[i][j]);

      if (++word_in_tile == tile_words) {  // end of one CiM array's tile
        word_in_tile = 0;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (m0 + ty + 16 * i >= M) continue;  // rows past M: never stored
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const float q = rintf(__fdiv_rn((float)part[i][j], step));
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(q, step));
            part[i][j] = 0;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gm = m0 + ty + 16 * i;
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
}

}  // namespace

extern "C" int cim_matmul_fq(const void* x, const void* wt, void* out, int M,
                             int N, int kw, int tile_words, float step,
                             void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cim_fq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(wt),
      static_cast<float*>(out), M, N, kw, tile_words, step);
  return static_cast<int>(cudaGetLastError());
}
