// Bit-plane CiM matmul for Hopper (sm_90a), with an ideal ADC per plane pair.
//
// Replaces the Pallas TPU kernel `_cim_matmul_kernel_bitplane`
// (src/repro/kernels/cim_matmul.py). The reduction dimension is cut into
// CiM-array tiles of `rows` word lines. For every tile and every pair of an
// activation bit plane a and a weight bit plane b, the plane dot d (the number
// of rows where both bits are 1) is the analog MAV d / rows, digitized by an
// ideal B-bit ADC, codes = clip(floor(mav * 2^B), 0, 2^B - 1), reconstructed
// as counts = codes / 2^B * rows, and accumulated with the signed plane
// weight (+-2^a)(+-2^b).
//
// What bounds it on this card. The function: wherever rows is a power of two
// 2^r and B >= r (the ops defaults, rows 128 with an 8-bit ADC, and the chip
// geometry, rows 16 with a 5-bit ADC), a pair's count is its plane dot except
// when the dot is rows, which reads rows - rows / 2^B; so the function is the
// integer matmul less (rows / 2^B) FX FW per tile (FX, FW: the signed values
// of the AND of a tile's patterns), one int8 product per (m, k, n) and one
// small correction per (m, tile, n). That work is far below the bytes moved
// (uint8 in, float32 out): bytes bound the function, about 0.009 ms for one
// M 1024 layer. The algorithm this kernel runs digitizes every plane pair as
// the TPU kernel does: A W plane dots per (m, k, n) on the int8 tensor cores
// and A W M N K / rows conversions on the fp32 pipes, whose larger term (the
// plane dots at rows 128, the conversions at rows 16) is 26 (ops defaults)
// and 12 (chip geometry) times the function's bound. This kernel is bound
// by its instruction issue, below even that: per plane pair and tile it
// spends one mma.sync per 16 or 32 rows, and per conversion three fp32
// instructions.
//
// What the design does:
// * No pack pass and no scratch: the uint8 pattern tiles of x (M, K) and
//   w (K, N) are staged with cp.async in a two-stage ring, whole CiM tiles per
//   stage (several tiles at rows < 128). W is taken as it lies; each stage's
//   W tile is transposed once in shared memory (4 x 4 byte blocks by
//   __byte_perm), so that a B fragment is one 32- or 64-bit load.
// * Plane dots on the int8 tensor cores: mma.sync m16n8k32 u8 x u8 -> s32
//   where a tile is a multiple of 32 rows (FAST epilogue), else m16n8k16.
//   Plane p of four pattern bytes is taken in place, P & (0x01010101 << p),
//   bytes 0 or 2^p, one instruction, on both sides: the accumulator holds
//   2^(a+b) d. With k-steps of 32 a thread's x and w fragments are 8
//   consecutive bytes each (the same permutation of k on both sides, so the
//   dot is unchanged). A tile is padded to a multiple of 16 rows with zero
//   rows (the wrapper pads when rows % 16 != 0): no k-step mixes two tiles and
//   d is unchanged, while the digitization uses the real `rows`. Each warp
//   owns 32 x 8 outputs (two m16 fragments, one where the second lies past
//   M) and walks, per tile, one activation plane a at a time with all W weight
//   planes in flight (W x 2 accumulator fragments; W is a template parameter,
//   so the plane loops unroll and the mma.sync instructions run unguarded),
//   re-reading the tile's fragments from shared memory for each a.
// * Exact, order-free sums. Every term is an integer number of granules
//   rows / 2^B: the kernel sums the integer codes times +-2^(a+b) exactly
//   and converts once at the end, out = fl32(I * rows) * 2^-B. This equals
//   the plain version (which sums in float32, tiles first, then pairs) bit for
//   bit wherever the plain version's float32 arithmetic is exact, as before;
//   and a split of the tiles over CTAs adds in any order.
//   - FAST epilogue (rows = 2^r, B >= r, A + W + B <= 24, tiles * 2^(A+W+B)
//     < 2^31: the ops defaults and the chip geometry): the code is
//     c = min(d 2^(B-r), 2^B - 1) and a tile's sum of +-c 2^(a+b) stays an
//     integer below 2^24, so it runs on the fp32 pipes (twice the integer
//     pipes' rate): the accumulator starts at the bits of 1.5 * 2^23, so it
//     reads as the float 1.5 * 2^23 + 2^(a+b) d with no conversion (at most
//     2^24, since A + W + r <= 24); one FMA makes c, one min clamps it, one
//     FMA adds +-c 2^(a+b) to the tile's float sum, and each tile's sum goes
//     once into an int32 total.
//   - INT epilogue (everything else): the plain version's own code, with
//     the IEEE divide (__fdiv_rn), c = min(floor(fl32(d / rows) 2^B),
//     2^B - 1); then one 64-bit multiply-add of c by +-2^(a+b) into an int64
//     total.
// * Split-K over a thread-block cluster at M <= 64 (decode), where the output
//   blocks alone would leave most SMs idle: up to 8 CTAs share an output
//   block's tiles; rank 0 adds the others' totals through distributed shared
//   memory and writes the output. One launch per call, deterministic.
// * Two CTAs of 8 warps per SM (at most 128 registers a thread);
//   cudaFuncSetAttribute (shared memory above 48 KB) once per kernel and
//   process.
//
// Layout (prepared by repro_torch.kernels.cim_matmul.cim_matmul_bp):
//   x (M, T * tile16) uint8, w (T * tile16, ldw) uint8: two's-complement bit
//   patterns, plane p is bit p; tile16 = rows rounded up to 16 (zero rows),
//   ldw = N rounded up to 16 (zero columns); out (M, N) float32.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int WARPS_N = 4;
constexpr int BM = 64;         // output rows per CTA (a warp: 32, two m16 fragments)
constexpr int BN = 32;         // output columns per CTA (a warp: 8, one n8 fragment)
constexpr int STAGE_K = 128;   // K bytes a stage aims at (whole tiles)
constexpr int MAX_BITS = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use
constexpr int MAGIC_I = 0x4B400000;   // bit pattern of 1.5 * 2^23
constexpr float MAGIC_F = 12582912.f;  // 1.5 * 2^23

struct Params {
  const uint8_t* x;
  const uint8_t* w;
  float* out;
  int M, N, ldw, T, rows, tile16, tps, xs, ws;  // tps: tiles per stage; xs, ws: bytes per staged x, w row
  int A, a_signed, w_signed, B, cs;
  float q;  // FAST: 2^(B - r)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: no bytes read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void mma_u8(int (&c)[4], unsigned a0, unsigned a1, unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void mma_u8_init(int (&d)[4], unsigned a0, unsigned a1, unsigned b, int init) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(init));
}

__device__ __forceinline__ void mma_u8_k32(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_u8_k32_init(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2], int init) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(init));
}

// One k-step of every (b, mt) accumulator: KS 16 (m16n8k16, a fragment of
// two x words and one w word) or KS 32 (m16n8k32, four x words and two w
// words). af: plane a of x; bw: w's raw pattern words. FIRST: the tile's
// first k-step, which starts the accumulators at `init`.
template <int KS, int W, int MT, bool FIRST>
__device__ __forceinline__ void mma_step(int (&d)[W][MT][4], const unsigned (&af)[MT][KS / 8],
                                         const unsigned (&bw)[KS / 16], int init) {
#pragma unroll
  for (int b = 0; b < W; ++b) {
    unsigned bf[KS / 16];
#pragma unroll
    for (int j = 0; j < KS / 16; ++j) bf[j] = bw[j] & (0x01010101u << b);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (KS == 16 && FIRST) mma_u8_init(d[b][mt], af[mt][0], af[mt][1], bf[0], init);
      else if constexpr (KS == 16) mma_u8(d[b][mt], af[mt][0], af[mt][1], bf[0]);
      else if constexpr (FIRST) mma_u8_k32_init(d[b][mt], af[mt], bf, init);
      else mma_u8_k32(d[b][mt], af[mt], bf);
    }
  }
}

__device__ __forceinline__ float pow2f(int e) { return __int_as_float((127 + e) << 23); }  // |e| <= 126

// The INT epilogue's code of a plane dot d (0 <= d <= rows): the plain
// version's formula, IEEE divide included.
__device__ __forceinline__ int int_code(int d, const Params& p) {
  const float c = floorf(__fmul_rn(__fdiv_rn(static_cast<float>(d), static_cast<float>(p.rows)),
                                   static_cast<float>(1 << p.B)));
  return min(static_cast<int>(c), (1 << p.B) - 1);
}

// One CiM tile of one warp's outputs: for every activation plane a, the plane
// dots of a with all W weight planes on the tensor cores, then their codes
// times +-2^(a+b) into the totals. MT: the warp's m16 fragments that hold
// rows below M (1 or 2). KS: the k-step, 16 or 32 (tiles of a multiple of 32
// rows). xrow, wcol: the thread's fragment row of the staged x and column of
// the transposed w at the tile's start. With KS 32 a thread reads 8
// consecutive bytes (one 64-bit load) for the k-positions 4 tig..4 tig + 3
// and 16 + 4 tig..16 + 4 tig + 3 of the instruction: the same permutation of
// k for x and w, so the dot is unchanged.
template <bool FAST, int W, int MT, int KS, typename Acc>
__device__ __forceinline__ void tile_sums(const Params& p, const uint8_t* xrow, const uint8_t* wcol, int XS, int tig,
                                          Acc (&tot)[2][4]) {
  const int steps = p.tile16 / KS;
  const float n_max = static_cast<float>((1 << p.B) - 1);
  float ysum[MT][4];  // FAST: the tile's sum of +-c 2^(a+b), an integer below 2^24
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) ysum[mt][i] = 0.f;
  xrow += KS / 4 * tig;
  wcol += KS / 4 * tig;
  for (int a = 0; a < p.A; ++a) {
    int d[W][MT][4];  // 2^(a+b) times the plane dot of (a, b), per fragment
    // plane a of x (bytes 0 or 2^a) and w's raw pattern words, for k-step ks
    auto load = [&](int ks, unsigned (&af)[MT][KS / 8], unsigned (&bw)[KS / 16]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint8_t* x0 = xrow + mt * 16 * XS + ks * KS;
        if constexpr (KS == 16) {
          af[mt][0] = *reinterpret_cast<const unsigned*>(x0);
          af[mt][1] = *reinterpret_cast<const unsigned*>(x0 + 8 * XS);
        } else {  // registers a0, a1, a2, a3: rows g, g + 8; k-halves 0, 1
          const uint2 r0 = *reinterpret_cast<const uint2*>(x0), r8 = *reinterpret_cast<const uint2*>(x0 + 8 * XS);
          af[mt][0] = r0.x, af[mt][1] = r8.x, af[mt][2] = r0.y, af[mt][3] = r8.y;
        }
#pragma unroll
        for (int j = 0; j < KS / 8; ++j) af[mt][j] &= 0x01010101u << a;
      }
      if constexpr (KS == 16) {
        bw[0] = *reinterpret_cast<const unsigned*>(wcol + ks * KS);
      } else {
        const uint2 r = *reinterpret_cast<const uint2*>(wcol + ks * KS);
        bw[0] = r.x, bw[1] = r.y;
      }
    };
    {  // the tile's first k-step starts the accumulators
      unsigned af[MT][KS / 8], bw[KS / 16];
      load(0, af, bw);
      mma_step<KS, W, MT, true>(d, af, bw, FAST ? MAGIC_I : 0);
    }
    for (int ks = 1; ks < steps; ++ks) {
      unsigned af[MT][KS / 8], bw[KS / 16];
      load(ks, af, bw);
      mma_step<KS, W, MT, false>(d, af, bw, 0);
    }
    const bool neg_a = p.a_signed && a == p.A - 1;
#pragma unroll
    for (int b = 0; b < W; ++b) {
      const bool neg = neg_a != (p.w_signed && b == W - 1);
      if (FAST) {
        // f = 1.5 * 2^23 + 2^(a+b) d exactly (below 2^24: A + W + r <= 24);
        // f * 2^(B-r-a-b) - 1.5 * 2^23 * 2^(B-r-a-b) = d 2^(B-r), exactly
        const float qab = __fmul_rn(p.q, pow2f(-a - b)), mqab = -__fmul_rn(MAGIC_F, qab);
        const float s = neg ? -pow2f(a + b) : pow2f(a + b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float c = fminf(__fmaf_rn(__int_as_float(d[b][mt][i]), qab, mqab), n_max);
            ysum[mt][i] = __fmaf_rn(c, s, ysum[mt][i]);
          }
      } else {
        const long long s = neg ? -(1ll << (a + b)) : (1ll << (a + b));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) tot[mt][i] += static_cast<long long>(int_code(d[b][mt][i] >> (a + b), p)) * s;
      }
    }
  }
  if (FAST) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[mt][i] += __float2int_rn(ysum[mt][i]);
  }
}

template <bool FAST, int W, int KS>
__global__ void __launch_bounds__(THREADS, 2)  // two CTAs per SM: at most 128 registers
cim_bp_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int sk = p.tps * p.tile16;       // K bytes of a stage
  const int XS = p.xs;                   // bytes per staged x row and per transposed w column
  const int WS = p.ws;
  uint8_t* xs = smem;                    // [2][BM][XS]
  uint8_t* ws = xs + 2 * BM * XS;        // [2][sk][WS]
  uint8_t* wt = ws + 2 * sk * WS;        // [BN][XS]: the current stage's w, transposed

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int rank = blockIdx.x % p.cs;
  const int n0 = (blockIdx.x / p.cs) * BN;
  const int m0 = blockIdx.y * BM;
  const int kp = p.T * p.tile16;

  // this CTA's share of the tiles
  const int t_begin = static_cast<int>(static_cast<long long>(p.T) * rank / p.cs);
  const int t_end = static_cast<int>(static_cast<long long>(p.T) * (rank + 1) / p.cs);
  const int k_end = t_end * p.tile16;
  const int n_stages = (t_end - t_begin + p.tps - 1) / p.tps;

  auto load_stage = [&](int buf, int st) {
    const int k0 = (t_begin + st * p.tps) * p.tile16;
    uint8_t* xb = xs + buf * BM * XS;
    for (int i = tid; i < BM * (sk / 16); i += THREADS) {
      const int r = i / (sk / 16), c = (i % (sk / 16)) * 16;
      const bool ok = m0 + r < p.M && k0 + c < k_end;
      cp_async16(xb + r * XS + c, ok ? p.x + static_cast<size_t>(m0 + r) * kp + k0 + c : p.x, ok);
    }
    uint8_t* wb = ws + buf * sk * WS;
    for (int i = tid; i < sk * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const bool ok = k0 + r < k_end && n0 + c < p.ldw;
      cp_async16(wb + r * WS + c, ok ? p.w + static_cast<size_t>(k0 + r) * p.ldw + n0 + c : p.w, ok);
    }
  };

  // w[k][n] -> wt[n][k], a 4 x 4 byte block per thread and pass
  auto transpose = [&](int buf) {
    const uint8_t* wb = ws + buf * sk * WS;
    for (int i = tid; i < (sk / 4) * (BN / 4); i += THREADS) {
      const int nq = i % (BN / 4), kq = i / (BN / 4);
      const uint8_t* src = wb + 4 * kq * WS + 4 * nq;
      const unsigned r0 = *reinterpret_cast<const unsigned*>(src);
      const unsigned r1 = *reinterpret_cast<const unsigned*>(src + WS);
      const unsigned r2 = *reinterpret_cast<const unsigned*>(src + 2 * WS);
      const unsigned r3 = *reinterpret_cast<const unsigned*>(src + 3 * WS);
      const unsigned t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
      const unsigned t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
      uint8_t* dst = wt + 4 * nq * XS + 4 * kq;
      *reinterpret_cast<unsigned*>(dst) = __byte_perm(t0, t2, 0x5410);
      *reinterpret_cast<unsigned*>(dst + XS) = __byte_perm(t0, t2, 0x7632);
      *reinterpret_cast<unsigned*>(dst + 2 * XS) = __byte_perm(t1, t3, 0x5410);
      *reinterpret_cast<unsigned*>(dst + 3 * XS) = __byte_perm(t1, t3, 0x7632);
    }
  };

  // warps whose rows or columns lie wholly past M or N compute nothing
  const bool active = m0 + wm * 32 < p.M && n0 + wn * 8 < p.N;

  // the totals of the codes times +-2^(a+b): int32 on the FAST path (the
  // wrapper takes it only while tiles * 2^(A+W+B) < 2^31), else int64
  using Acc = std::conditional_t<FAST, int, long long>;
  Acc tot[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[mt][i] = 0;

  if (n_stages > 0) load_stage(0, 0);
  cp_async_commit();
  for (int st = 0; st < n_stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_stages) load_stage(buf ^ 1, st + 1);
    cp_async_commit();  // one group per stage, empty past the end: the wait count stays 1
    cp_async_wait<1>();
    __syncthreads();    // stage st has landed for every thread
    transpose(buf);
    __syncthreads();
    const int tiles_here = min(p.tps, t_end - (t_begin + st * p.tps));
    if (active) {
      const uint8_t* xrow = xs + buf * BM * XS + (wm * 32 + g) * XS;
      const uint8_t* wcol = wt + (wn * 8 + g) * XS;
      // a warp whose second m16 fragment lies past M runs the one-fragment variant
      for (int tt = 0; tt < tiles_here; ++tt) {
        if (m0 + wm * 32 + 16 < p.M) tile_sums<FAST, W, 2, KS, Acc>(p, xrow, wcol + tt * p.tile16, XS, tig, tot);
        else tile_sums<FAST, W, 1, KS, Acc>(p, xrow, wcol + tt * p.tile16, XS, tig, tot);
        xrow += p.tile16;
      }
    }
    __syncthreads();  // this stage's buffers and wt are no longer read
  }

  // accumulator element i of fragment mt: row 16 mt + g + 8 (i / 2), column tig * 2 + i % 2
  long long total[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) total[mt][i] = tot[mt][i];
  if (p.cs > 1) {
    cp_async_wait<0>();
    __syncthreads();
    long long* red = reinterpret_cast<long long*>(smem);  // [BM][BN], over the drained ring
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(wm * 32 + mt * 16 + g + 8 * (i / 2)) * BN + wn * 8 + tig * 2 + i % 2] = total[mt][i];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int other = 1; other < p.cs; ++other) {
        const long long* rem = cluster.map_shared_rank(red, other);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            total[mt][i] += rem[(wm * 32 + mt * 16 + g + 8 * (i / 2)) * BN + wn * 8 + tig * 2 + i % 2];
      }
    }
    cluster.sync();  // the other CTAs keep their shared memory until rank 0 has read it
    if (rank != 0) return;
  }

  const float inv_codes = pow2f(-p.B);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + wm * 32 + mt * 16 + g + 8 * (i / 2);
      const int gn = n0 + wn * 8 + tig * 2 + i % 2;
      if (gm < p.M && gn < p.N)
        p.out[static_cast<size_t>(gm) * p.N + gn] = __fmul_rn(__ll2float_rn(total[mt][i] * p.rows), inv_codes);
    }
}

template <bool FAST, int W, int KS>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  const dim3 grid(p.cs * ((p.N + BN - 1) / BN), (p.M + BM - 1) / BM);
  auto kernel = cim_bp_kernel<FAST, W, KS>;
  // the largest stage ring is above the 48 KB a launch gets unasked: ask once per kernel
  static const cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (p.cs == 1) {
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The INT epilogue (an edge path) keeps k-steps of 16.
template <int W>
int dispatch(const Params& p, bool fast, bool k32, size_t smem, cudaStream_t s) {
  if (!fast) return launch<false, W, 16>(p, smem, s);
  return k32 ? launch<true, W, 32>(p, smem, s) : launch<true, W, 16>(p, smem, s);
}

}  // namespace

// x (M, T * tile16) and w (T * tile16, ldw) uint8 patterns; out (M, N)
// float32. A, W <= 8 planes, rows <= 1024 (tile16 = rows rounded up to 16),
// adc_bits <= 24. fast: the FAST epilogue (q = 2^(adc_bits - log2 rows)),
// else the INT epilogue. cs: CTAs per
// cluster that split the tiles (1..8). Returns the launch's CUDA error, or 0.
extern "C" int cim_matmul_bp(const void* x, const void* w, void* out, int M, int N, int ldw, int T,
                             int rows, int tile16, int A, int W, int a_signed, int w_signed,
                             int adc_bits, int fast, float q, int cs, void* stream) {
  if (A < 1 || A > MAX_BITS || W < 1 || W > MAX_BITS || rows < 1 || rows > 1024 || tile16 % 16 ||
      tile16 < rows || tile16 > 1024 || adc_bits < 1 || adc_bits > 24 || cs < 1 || cs > MAX_CLUSTER ||
      cs > T || ldw % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const uint8_t*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.out = static_cast<float*>(out);
  p.M = M, p.N = N, p.ldw = ldw, p.T = T, p.rows = rows, p.tile16 = tile16;
  p.tps = tile16 >= STAGE_K ? 1 : STAGE_K / tile16;
  p.A = A, p.a_signed = a_signed, p.w_signed = w_signed, p.B = adc_bits, p.cs = cs;
  p.q = q;
  const int sk = p.tps * tile16;
  // x rows and transposed w columns padded so that a warp's fragment loads
  // (32-bit with k-steps of 16, 64-bit with k-steps of 32) spread over the
  // banks; w rows padded by 16 bytes for the transpose's reads, except at
  // tiles near 1024 rows, where the ring only fits unpadded
  const bool k32 = fast && tile16 % 32 == 0;
  p.xs = sk + (k32 ? 32 : 16);
  auto ring = [&](int ws) { return static_cast<size_t>(2 * BM * p.xs + 2 * sk * ws + BN * p.xs); };
  p.ws = ring(BN + 16) <= SMEM_MAX ? BN + 16 : BN;
  const size_t smem = ring(p.ws);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the weight planes are a template parameter: the plane loops unroll with no
  // guard, so the mma.sync instructions sit in straight-line code
  switch (W) {
    case 1: return dispatch<1>(p, fast, k32, smem, s);
    case 2: return dispatch<2>(p, fast, k32, smem, s);
    case 3: return dispatch<3>(p, fast, k32, smem, s);
    case 4: return dispatch<4>(p, fast, k32, smem, s);
    case 5: return dispatch<5>(p, fast, k32, smem, s);
    case 6: return dispatch<6>(p, fast, k32, smem, s);
    case 7: return dispatch<7>(p, fast, k32, smem, s);
    default: return dispatch<8>(p, fast, k32, smem, s);
  }
}
