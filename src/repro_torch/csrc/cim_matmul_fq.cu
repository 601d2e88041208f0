// CiM fake-quant matmul for Hopper (sm_90a): y = step * sum_t q(x[:, t] . w[t, :]).
//
// Replaces the Pallas TPU kernel `_cim_matmul_kernel_fakequant`
// (src/repro/kernels/cim_matmul.py). The reduction dimension is cut into
// CiM-array tiles of `rows` word lines. Each tile's partial dot p is an exact
// integer, quantized as q = round_half_even(fl32(p / step)); the output is
// the sum over the tiles of q * step.
//
// What bounds it on this card: at the serving shapes (M 1024 prefill rows or
// M 4 at decode, K <= 1536, N <= 1536) the int8 operands and the float32
// output move a few MB and the int8 tensor-core work is under a microsecond.
// What is left is one quantization per (output, tile): M*N*K/rows of them,
// 226 M for one prefill layer's seven linears. The bound counts one fp32
// multiply-add each. This kernel spends about ten instructions on each, one
// shared-memory load of the threshold table among them; those conversions
// take well under half of a prefill call, and staging the operands through
// shared memory (cp.async, a barrier per chunk) most of the rest. At decode
// a call is latency: the launch and a short walk over a few tiles.
//
// What the design does:
// * Tile dots on the int8 tensor cores: mma.sync m16n8k16 s8 x s8 -> s32.
//   Its depth of 16 is one CiM tile at rows 16 (the wrapper zero-pads a tile
//   to a multiple of 16 rows; zero products add nothing), so the s32
//   accumulator holds one tile's exact partial dot after rows/16 MMAs.
//   (int8 wgmma has a depth of 32 and would mix two tiles.)
// * No divide: q(p) is a monotone step function of the integer p. The
//   wrapper tabulates, on the CPU with the true float32 divide, the least p
//   of every step (`thr`). Here q is estimated from p * (1/step), within one
//   step of the truth, and corrected by comparing p with the two
//   neighbouring thresholds: exact for every p (see `quantize`). The
//   accumulator starts at the bits of 1.5 * 2^23, so it reads as the float
//   1.5 * 2^23 + p with no conversion, and the rest runs on the float pipes,
//   which issue twice the integer pipes' rate.
// * Exact accumulation: each output sums its tiles' q (integers, exact in
//   float32 below 2^24) and writes __fmul_rn(sum_q, step) once. This equals
//   the plain version's float32 sum of q_t * step wherever that sum is
//   exact, i.e. while sum_t |q_t| * step fits float32's 24-bit significand
//   (|sum q| < 768 at the default step 10922.5 = 21845 / 2; random inputs
//   reach ~20, all-saturated operands 24 a tile). Exact sums make any split
//   of K order-free.
// * Split-K at small M (decode, M <= 64): the tiles of one output block are
//   spread over the CTAs of a thread-block cluster (up to 8). Each CTA sums
//   its own tiles' q; CTA rank 0 adds the others' exact partials through
//   distributed shared memory and writes the output: one launch,
//   deterministic. At M > 64, 32 x 32 output blocks fill the 132 SMs at
//   every (K, N) of a layer (M 1024, N 192 gives 192 blocks).
// * Operands staged with cp.async in 64-byte K chunks, four in flight.
// * W is taken as it lies, (K, N) with N contiguous; the kernel reads each
//   B fragment's four K-neighbours from shared memory byte by byte, so the
//   wrapper makes no transposed copy of the weight.
//
// Layout (prepared by repro_torch.kernels.cim_matmul.cim_matmul_fq):
//   x   (M, Kp) int8, Kp = T * tile_steps * 16 (tiles zero-padded to 16s);
//   w   (Kp, ldw) int8, ldw = N rounded up to 16 (zero columns);
//   thr (2Q + 4,) int32: thr[i] = least p with q(p) >= i - Q - 1, with
//       INT_MIN / INT_MAX sentinels at both ends (the kernel keeps them in
//       shared memory as floats, in pairs (thr[i], thr[i + 1]));
//   out (M, N) float32.

#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;  // four warps, each a 16 x 16 output tile
constexpr int KC = 64;        // int8 of K per staged chunk: four m16n8k16 steps
constexpr int STAGES = 4;     // chunks in flight: cp.async runs three chunks ahead
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_STEPS = 8192;  // largest |q| of a tile the threshold table holds
constexpr int MAGIC_I = 0x4B400000;   // bit pattern of 1.5 * 2^23
constexpr float MAGIC_F = 12582912.f;  // 1.5 * 2^23

template <int WARPS_M>
struct Tile {
  static constexpr int BM = 16 * WARPS_M;         // output rows per CTA
  static constexpr int BN = 16 * (4 / WARPS_M);   // output columns per CTA
  static constexpr int SA = KC + 16;              // bytes per staged x row (bank spread)
  static constexpr int SB = BN + 16;              // bytes per staged w row
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: no bytes read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void mma_s8_init(int (&d)[4], unsigned a0, unsigned a1, unsigned b, int init) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(init));
}

// q(p) = round_half_even(fl32(p / step)) as a float, all on the float pipes
// (Hopper issues half as many integer as float instructions). `acc` is the
// tile's s32 accumulator, which started at `init`: narrow tiles (|p| < 2^22)
// start at the bits of 1.5 * 2^23, so `acc` read as a float is 1.5 * 2^23 + p
// exactly; WIDE tiles start at 0 and convert. The estimate r = fma(f, 1/step,
// c) lies in [2^23, 2^24), where floats are the integers, so r - 1.5 * 2^23 =
// rint(p / step + d) with |d| <= 1/2 (c = fl32(1.5 * 2^23 * (1 - 1/step)),
// narrow; c = 1.5 * 2^23, WIDE): within one step of q. thr2[r's bits - base]
// holds the least f of that step and of the next (as 1.5 * 2^23 + p, narrow,
// or p, WIDE: exact, with -inf / +inf at the ends), and two comparisons
// correct the estimate: exact for every p, with no divide.
template <bool WIDE>
__device__ __forceinline__ float quantize(int acc, const float2* thr2, float inv, float c, int base) {
  const float f = WIDE ? __int2float_rn(acc) : __int_as_float(acc);
  const float r = __fmaf_rn(f, inv, c);
  const float2 t = thr2[__float_as_int(r) - base];
  float q = __fsub_rn(r, MAGIC_F);
  q = f < t.x ? __fsub_rn(q, 1.f) : q;
  return f >= t.y ? __fadd_rn(q, 1.f) : q;
}

template <int WARPS_M, bool WIDE>
__global__ void __launch_bounds__(THREADS)
cim_fq_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const int* __restrict__ thr_g, float* __restrict__ out, int M, int N,
              int ldw, int T, int tile_steps, int n_thr, float inv, float c, float step, int cs) {
  using C = Tile<WARPS_M>;
  constexpr int BM = C::BM, BN = C::BN, SA = C::SA, SB = C::SB;
  __shared__ __align__(16) int8_t As[STAGES][BM][SA];
  __shared__ __align__(16) int8_t Bs[STAGES][KC][SB];
  __shared__ float red[BM * BN];  // this CTA's sums of q, read by cluster rank 0
  extern __shared__ float2 thr2[];  // (least f of step j, of step j + 1), j = i - Q - 1

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / (4 / WARPS_M), wn = warp % (4 / WARPS_M);
  const int rank = blockIdx.x % cs;
  const int n0 = (blockIdx.x / cs) * BN;
  const int m0 = blockIdx.y * BM;
  const int base = MAGIC_I - (n_thr - 2) / 2;  // r's bits less the table offset Q + 1
  const int init = WIDE ? 0 : MAGIC_I;

  // this CTA's share of the tiles, as a range of K
  const int t_begin = static_cast<int>(static_cast<long long>(T) * rank / cs);
  const int t_end = static_cast<int>(static_cast<long long>(T) * (rank + 1) / cs);
  const int k_begin = t_begin * tile_steps * 16;
  const int k_end = t_end * tile_steps * 16;
  const int kp = T * tile_steps * 16;
  const int n_steps = (k_end - k_begin) / 16;
  const int n_chunks = (n_steps + KC / 16 - 1) / (KC / 16);

  auto load_chunk = [&](int buf, int k0) {
    for (int i = tid; i < BM * (KC / 16); i += THREADS) {
      const int r = i / (KC / 16), c = (i % (KC / 16)) * 16;
      const bool ok = m0 + r < M && k0 + c < k_end;
      cp_async16(&As[buf][r][c], ok ? x + static_cast<size_t>(m0 + r) * kp + k0 + c : x, ok);
    }
    for (int i = tid; i < KC * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const bool ok = k0 + r < k_end && n0 + c < ldw;
      cp_async16(&Bs[buf][r][c], ok ? w + static_cast<size_t>(k0 + r) * ldw + n0 + c : w, ok);
    }
  };

  int part[2][4];
  float qsum[2][4];  // integer-valued: exact below 2^24
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) qsum[nt][i] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks) load_chunk(st, k_begin + st * KC);
    cp_async_commit();  // one group per chunk, empty past the end: the wait counts stay uniform
  }
  auto as_f = [](int t) {  // a threshold as the kernel's f: exact (|p| <= 2^24)
    return t == INT_MIN ? -INFINITY : t == INT_MAX ? INFINITY
                        : __fadd_rn(__int2float_rn(t), WIDE ? 0.f : MAGIC_F);
  };
  // the table, while the first chunks are in flight (the loop's barrier orders it)
  for (int i = tid; i + 1 < n_thr; i += THREADS) thr2[i] = make_float2(as_f(thr_g[i]), as_f(thr_g[i + 1]));

  int step_in_tile = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<STAGES - 2>();  // chunk ch has landed
    __syncthreads();              // ... for every thread, and chunk ch - 1 is no longer read
    if (ch + STAGES - 1 < n_chunks) load_chunk((ch + STAGES - 1) % STAGES, k_begin + (ch + STAGES - 1) * KC);
    cp_async_commit();
    const int buf = ch % STAGES;
    const int steps = min(KC / 16, n_steps - ch * (KC / 16));
#pragma unroll
    for (int s = 0; s < KC / 16; ++s) {  // one m16n8k16 step: 16 rows of K
      if (s >= steps) break;
      const int8_t* ap = &As[buf][wm * 16 + g][s * 16 + tig * 4];
      const unsigned a0 = *reinterpret_cast<const unsigned*>(ap);
      const unsigned a1 = *reinterpret_cast<const unsigned*>(ap + 8 * SA);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // B fragment: w[k + tig*4 .. +3][n + g], four K-neighbours of one column
        const uint8_t* bp = reinterpret_cast<const uint8_t*>(&Bs[buf][s * 16 + tig * 4][wn * 16 + nt * 8 + g]);
        const unsigned b = static_cast<unsigned>(bp[0]) | (static_cast<unsigned>(bp[SB]) << 8) |
                           (static_cast<unsigned>(bp[2 * SB]) << 16) | (static_cast<unsigned>(bp[3 * SB]) << 24);
        if (step_in_tile == 0) mma_s8_init(part[nt], a0, a1, b, init);
        else mma_s8(part[nt], a0, a1, b);
      }
      if (++step_in_tile == tile_steps) {  // one CiM tile complete: quantize its dots
        step_in_tile = 0;                  // (rows past M too: they are zero and never stored)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qsum[nt][i] = __fadd_rn(qsum[nt][i], quantize<WIDE>(part[nt][i], thr2, inv, c, base));
      }
    }
  }

  // accumulator element i of n-tile nt: row g + 8 * (i / 2), column tig * 2 + i % 2
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(wm * 16 + g + 8 * (i / 2)) * BN + wn * 16 + nt * 8 + tig * 2 + i % 2] = qsum[nt][i];
    cluster.sync();
    if (rank == 0) {
      for (int other = 1; other < cs; ++other) {
        const float* rem = cluster.map_shared_rank(red, other);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qsum[nt][i] = __fadd_rn(qsum[nt][i], rem[(wm * 16 + g + 8 * (i / 2)) * BN + wn * 16 + nt * 8 + tig * 2 + i % 2]);
      }
    }
    cluster.sync();  // the other CTAs keep their shared memory until rank 0 has read it
    if (rank != 0) return;
  }

#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + wm * 16 + g + 8 * (i / 2);
      const int gn = n0 + wn * 16 + nt * 8 + tig * 2 + i % 2;
      if (gm < M && gn < N) out[static_cast<size_t>(gm) * N + gn] = __fmul_rn(qsum[nt][i], step);
    }
}

template <int WARPS_M, bool WIDE>
int launch(const int8_t* x, const int8_t* w, const int* thr, float* out, int M, int N,
           int ldw, int T, int tile_steps, int n_thr, float inv, float c, float step, int cs,
           cudaStream_t stream) {
  using C = Tile<WARPS_M>;
  const dim3 grid(cs * ((N + C::BN - 1) / C::BN), (M + C::BM - 1) / C::BM);
  const size_t smem = static_cast<size_t>(n_thr - 1) * sizeof(float2);
  auto kernel = cim_fq_kernel<WARPS_M, WIDE>;
  // the largest table is above the 48 KB a launch gets unasked: ask once per kernel
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (2 * MAX_STEPS + 3) * static_cast<int>(sizeof(float2)));
  if (set != cudaSuccess) return static_cast<int>(set);
  if (cs == 1) {
    kernel<<<grid, THREADS, smem, stream>>>(x, w, thr, out, M, N, ldw, T, tile_steps, n_thr, inv, c, step, cs);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, w, thr, out, M, N, ldw, T, tile_steps,
                                             n_thr, inv, c, step, cs);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// cs: CTAs per cluster that split the tiles (1..8; 1 = no split). wide: the
// tile dots may reach 2^22 in magnitude (rows > 255).
extern "C" int cim_matmul_fq(const void* x, const void* w, const void* thr, void* out, int M,
                             int N, int ldw, int T, int tile_steps, int n_thr, float inv,
                             float step, int wide, int cs, void* stream) {
  if (cs < 1 || cs > MAX_CLUSTER || n_thr < 4 || n_thr > 2 * MAX_STEPS + 4 || ldw % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* tp = static_cast<const int*>(thr);
  auto* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the estimate's addend (see quantize); the host's double rounds once to float
  const float c = wide ? MAGIC_F : static_cast<float>(static_cast<double>(MAGIC_F) * (1.0 - static_cast<double>(inv)));
  if (M <= 16)
    return wide ? launch<1, true>(xp, wp, tp, op, M, N, ldw, T, tile_steps, n_thr, inv, c, step, cs, s)
                : launch<1, false>(xp, wp, tp, op, M, N, ldw, T, tile_steps, n_thr, inv, c, step, cs, s);
  return wide ? launch<2, true>(xp, wp, tp, op, M, N, ldw, T, tile_steps, n_thr, inv, c, step, cs, s)
              : launch<2, false>(xp, wp, tp, op, M, N, ldw, T, tile_steps, n_thr, inv, c, step, cs, s);
}
