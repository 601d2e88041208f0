// Bit-plane CiM matmul for Hopper (sm_90a), with an ideal ADC per plane pair.
//
// Replaces the Pallas TPU kernel `_cim_matmul_kernel_bitplane`
// (src/repro/kernels/cim_matmul.py). The reduction dimension is cut into
// CiM-array tiles of `rows` word lines. For every tile and every pair of an
// activation bit plane a and a weight bit plane b, the plane dot d (the number
// of rows where both bits are 1) is the analog MAV d / rows, digitized by an
// ideal B-bit ADC, codes = clip(floor(mav * 2^B), 0, 2^B - 1), reconstructed
// as counts = codes / 2^B * rows, and accumulated with the signed plane
// weight (+-2^a)(+-2^b) in float32.
//
// What bounds it on this card: at the serving shapes the operands (uint8)
// and the float32 output move a few MB; the plane products, counted as int8
// tensor-core work (2 A W M K N operations), take tens of microseconds at the
// int8 peak, so the bound is the operations. This simple kernel is bound by
// its instruction issue instead: one __popc per plane pair and 32 rows, one
// shared-memory table lookup and one multiply-add per plane pair and tile.
//
// What the design does. Planes are 0/1, so a tile's plane dot is exact as
// __popc(xa & wb) over bit-packed planes: a pack pass turns each operand's
// two's-complement patterns into one 32-bit word per (row or column, tile,
// plane, 32 rows) (`wpt` = ceil(rows / 32) words a tile). The digitization
// depends on the integer dot only, so each block first tabulates
// counts(d) for d = 0..rows with IEEE operations that nvcc cannot contract
// (__fdiv_rn, __fmul_rn, floorf), never --use_fast_math; the main loop then
// adds __fmul_rn(weight, table[d]) with __fadd_rn. Bit-exactness against the
// plain version (which sums pair-major): every term is counts * 2^(a+b) with
// counts a multiple of the dyadic granule of rows / 2^B, so for rows a power
// of two (or any rows with rows / 2^B dyadic) every partial sum is exact,
// whatever the order, while it stays below 2^24 granules in magnitude. No
// tensor cores, no TMA yet.
//
// Layout (prepared by repro_torch.kernels.cim_matmul.cim_matmul_bp):
//   x  (M, K) uint8, w (K, N) uint8: two's-complement bit patterns, plane p
//   is bit p; K is a multiple of rows (the wrapper zero-pads it);
//   xw (M, T, A, wpt) and ww (N, T, W, wpt) uint32 scratch for the packed
//   planes; out (M, N) float32. M and N edges are masked here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;         // output rows per block
constexpr int BN = 64;         // output columns per block
constexpr int THREADS = 256;   // 16 x 16 threads, each 4 x 4 outputs
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int MAX_BITS = 8;
constexpr int PACK_THREADS = 256;

// One thread per (operand row i, tile t, word w), i fastest: gathers the
// 32 (or fewer, at a tile's end) patterns of its word and writes one word per
// plane. Element (i, k) of the operand is src[i * si + k * sk].
__global__ void __launch_bounds__(PACK_THREADS)
pack_planes_kernel(const uint8_t* __restrict__ src, uint32_t* __restrict__ out,
                   int R, int T, int rows, int wpt, int bits, long long si,
                   long long sk) {
  const long long idx = (long long)blockIdx.x * PACK_THREADS + threadIdx.x;
  if (idx >= (long long)R * T * wpt) return;
  const int i = (int)(idx % R);
  const long long rest = idx / R;
  const int w = (int)(rest % wpt);
  const int t = (int)(rest / wpt);
  uint32_t words[MAX_BITS];
#pragma unroll
  for (int p = 0; p < MAX_BITS; ++p) words[p] = 0u;
  const int j_end = min(32, rows - 32 * w);
  const long long k0 = (long long)t * rows + 32 * w;
  for (int j = 0; j < j_end; ++j) {
    const uint32_t b = src[i * si + (k0 + j) * sk];
#pragma unroll
    for (int p = 0; p < MAX_BITS; ++p) words[p] |= ((b >> p) & 1u) << j;
  }
  uint32_t* o = out + ((long long)i * T + t) * bits * wpt + w;
#pragma unroll
  for (int p = 0; p < MAX_BITS; ++p)
    if (p < bits) o[p * wpt] = words[p];
}

__global__ void __launch_bounds__(THREADS)
cim_bp_kernel(const uint32_t* __restrict__ xw, const uint32_t* __restrict__ ww,
              float* __restrict__ out, int M, int N, int T, int wpt, int rows,
              int A, int W, int a_signed, int w_signed, float n_codes) {
  // Rows of the staged tile are padded by one word so that neighbouring
  // threads' reads fall on different banks.
  const int xn = A * wpt, xstride = xn + 1;
  const int wn = W * wpt, wstride = wn + 1;
  extern __shared__ uint32_t smem[];
  uint32_t* xs = smem;                 // [BM][xstride]
  uint32_t* ws = xs + BM * xstride;    // [BN][wstride]
  float* table = reinterpret_cast<float*>(ws + BN * wstride);  // [rows + 1]

  for (int d = threadIdx.x; d <= rows; d += THREADS) {
    const float mav = __fdiv_rn((float)d, (float)rows);
    float c = floorf(__fmul_rn(mav, n_codes));
    c = c < 0.f ? 0.f : (c > n_codes - 1.f ? n_codes - 1.f : c);
    table[d] = __fmul_rn(__fdiv_rn(c, n_codes), (float)rows);  // floor reconstruction
  }

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the table is ready; the previous tile's reads are done
    for (int i = threadIdx.x; i < BM * xn; i += THREADS) {
      const int r = i / xn, c = i % xn, gm = m0 + r;
      xs[r * xstride + c] = gm < M ? xw[((size_t)gm * T + t) * xn + c] : 0u;
    }
    for (int i = threadIdx.x; i < BN * wn; i += THREADS) {
      const int r = i / wn, c = i % wn, gn = n0 + r;
      ws[r * wstride + c] = gn < N ? ww[((size_t)gn * T + t) * wn + c] : 0u;
    }
    __syncthreads();

    for (int a = 0; a < A; ++a) {
      for (int b = 0; b < W; ++b) {
        float s = ldexpf(1.f, a + b);  // exact power of two
        if ((a_signed && a == A - 1) != (w_signed && b == W - 1)) s = -s;
        int dot[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) dot[i][j] = 0;
        for (int w = 0; w < wpt; ++w) {
          uint32_t xa[TM], wb[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) xa[i] = xs[(ty + 16 * i) * xstride + a * wpt + w];
#pragma unroll
          for (int j = 0; j < TN; ++j) wb[j] = ws[(tx + 16 * j) * wstride + b * wpt + w];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) dot[i][j] += __popc(xa[i] & wb[j]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(s, table[dot[i][j]]));
      }
    }
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

int pack(const uint8_t* src, uint32_t* out, int R, int T, int rows, int wpt,
         int bits, long long si, long long sk, cudaStream_t stream) {
  const long long n = (long long)R * T * wpt;
  const unsigned blocks = (unsigned)((n + PACK_THREADS - 1) / PACK_THREADS);
  pack_planes_kernel<<<blocks, PACK_THREADS, 0, stream>>>(src, out, R, T, rows,
                                                          wpt, bits, si, sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) and w (K, N) uint8 patterns, K = T * rows; xw, ww scratch of
// M * T * A * wpt and N * T * W * wpt words; out (M, N) float32. A, W <= 8,
// rows <= 1024. Returns the first CUDA error of the three launches, or 0.
extern "C" int cim_matmul_bp(const void* x, const void* w, void* xw, void* ww,
                             void* out, int M, int N, int K, int rows, int A,
                             int W, int a_signed, int w_signed, int adc_bits,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = K / rows;
  const int wpt = (rows + 31) / 32;
  int err = pack(static_cast<const uint8_t*>(x), static_cast<uint32_t*>(xw), M,
                 T, rows, wpt, A, K, 1, s);
  if (err) return err;
  err = pack(static_cast<const uint8_t*>(w), static_cast<uint32_t*>(ww), N, T,
             rows, wpt, W, 1, N, s);
  if (err) return err;
  const size_t smem = sizeof(uint32_t) * ((size_t)BM * (A * wpt + 1) +
                                          (size_t)BN * (W * wpt + 1) + rows + 1);
  err = static_cast<int>(cudaFuncSetAttribute(
      cim_bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  if (err) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cim_bp_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const uint32_t*>(xw), static_cast<const uint32_t*>(ww),
      static_cast<float*>(out), M, N, T, wpt, rows, A, W, a_signed, w_signed,
      (float)(1 << adc_bits));
  return static_cast<int>(cudaGetLastError());
}
