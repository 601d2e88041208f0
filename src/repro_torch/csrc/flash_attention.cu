// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py): online softmax over KV tiles with
// absolute query positions, KV head h / (H / KV), KV tiles past the block's
// largest visible position skipped, q.k^T and p.v in float32, fp32 running
// max / sum / accumulator, output in q's dtype.
//
// Two kernels, chosen by the dtype of k/v before the launch:
//
// * bf16 k/v (every serve path): `flash_tc_kernel`, on the bf16 tensor cores
//   at float32 accuracy. What bounds it on this card: at the serving prefill
//   shape (B 4, H 9, KV 3, S 256, hd 64, q float32) the inputs and output are
//   ~4 MB and the causal work ~0.3 GFLOP; float32 accuracy takes six bf16
//   passes of it (below), still about a microsecond at the bf16 rate, so the
//   bound is the bytes, 1.6 microseconds. A call of this size is set by
//   latency instead: the launch, the prologue that loads and splits q, and
//   one block's serial walk over its KV tiles. Taking the MMAs or the exps
//   out of the kernel saves little of its time. What the design does:
//   - Exact bf16 splits. A bf16 k or v is one bf16 piece. A float32 q is the
//     exact sum of three: hi = q with its low 16 bits cleared, mid = the same
//     of q - hi, lo = q - hi - mid (each difference exact, each piece 8
//     significant bits). So S = q.k^T is three bf16 MMAs into one float32
//     accumulator, and P (float32 after the exp) is split the same way for
//     the three P.V MMAs. A bf16 q is one piece (QP = 1), with the scale
//     applied to S instead. Exact for |x| >= 2^-110, below which the lo
//     piece would be a bf16 subnormal; such a q or p adds nothing that a
//     1e-5 tolerance sees.
//   - mma.sync.m16n8k16 bf16 with float32 accumulation. Each warp owns 16
//     query rows; its S accumulator fragments are reused in registers as the
//     A fragments of P.V (no trip through shared memory). K is the B operand
//     of q.k^T read with ldmatrix, V the B operand of P.V read with
//     ldmatrix.trans. (wgmma would need 64-row warpgroup tiles and matrix
//     descriptors over swizzled shared memory; with a few KV tiles a block
//     the call is latency-bound, and mma.sync lets the P fragments stay in
//     the registers where the softmax leaves them.)
//   - K/V tiles of 64 keys stay bf16 in shared memory, double-buffered with
//     cp.async (the next round's tiles load while this round's are used);
//     rows padded by 16 bytes so ldmatrix's eight rows fall on distinct
//     banks.
//   - Grid: one block of 4 warps per (batch, head, 32 queries): 288 blocks
//     at the serve shape, three resident on each SM. Two warps own the 32
//     query rows; the block's other two take every other KV tile for the
//     same rows, and the two partial softmaxes (max, sum, accumulator) are
//     merged through shared memory at the end. The split halves the serial
//     walk of the last query block (4 tiles at S 256) and doubles the warps
//     that hide each other's MMA and load latency. Grouping the G = 3 query
//     heads of a KV head in one block would read each K/V tile once instead
//     of three times, but leaves a third of the blocks; K/V (0.8 MB at the
//     serve shape) stay in the 50 MB L2 either way.
//
// * float32 k/v (only the JAX package's test shapes use it): `flash_fp32_kernel`,
//   the CUDA-core kernel: one block per (batch, head, 64 queries), 32-key
//   float32 tiles in shared memory, four threads per query row, scores as
//   fp32 FMAs summed with two warp shuffles.
//
// Layout: q (B, H, Sq, HD), k/v (B, KV, Sk, HD), out (B, H, Sq, HD), all
// contiguous; q/out float or bf16, k/v float or bf16 (as in the TPU kernel,
// q may be float32 beside bf16 k/v: the serving model scales q in float32);
// q_pos (Sq,) int32. HD is 32, 64 or 128 (the wrapper zero-pads other head
// dims up to the next of these).

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// two neighbouring elements in one access (8 or 4 bytes): a warp's accesses
// of a fragment row then fill whole 32-byte sectors
__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16 k/v: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 32;       // query rows per block: 16 per warp, two warps
constexpr int TC_BK = 64;       // keys per KV tile
constexpr int TC_GROUPS = 2;    // warp pairs per block, each over every other KV tile
constexpr int TC_THREADS = 64 * TC_GROUPS;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: no bytes read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 pieces of two floats as packed pairs (x0 in the low half):
// piece[0] + piece[1] + piece[2] == x exactly (P == 3), or piece[0] == x
// for values already bf16 (P == 1). Truncation, never rounding: no piece can
// overflow, and each difference is exact.
template <int P>
__device__ __forceinline__ void split_pack(float x0, float x1, unsigned (&piece)[P]) {
  constexpr unsigned HI = 0xffff0000u;
  unsigned u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    piece[i] = (u1 & HI) | (u0 >> 16);
    x0 = __fsub_rn(x0, __uint_as_float(u0 & HI));
    x1 = __fsub_rn(x1, __uint_as_float(u1 & HI));
    u0 = __float_as_uint(x0);
    u1 = __float_as_uint(x1);
  }
}

// QP: bf16 pieces of q (3 for float32 q, 1 for bf16 q). P is always split in
// three: it is float32 after the exp, as in the TPU kernel.
template <typename TQ, int HD, int QP>
__global__ void __launch_bounds__(TC_THREADS, HD <= 64 ? 3 : 1)
flash_tc_kernel(const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ q_pos,
                TQ* __restrict__ out, int H, int KV, int Sq, int Sk, float sm_scale, int causal) {
  constexpr int SROW = HD + 8;     // bf16 per shared row: 16 bytes of padding
  constexpr int KSTEPS = HD / 16;  // m16n8k16 steps over the head dim
  constexpr int DT = HD / 8;       // n8 tiles of the output
  constexpr int NT = TC_BK / 8;    // n8 tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE = TC_BK * SROW;  // bf16 of one staged K or V tile
  // [2 stages][TC_GROUPS][TC_BK][SROW] each
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + 2 * TC_GROUPS * TILE;
  __shared__ int max_pos;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int grp = warp / 2, wq = warp % 2;  // KV group; query warp within the group
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int row0 = blockIdx.x * TC_BQ + wq * 16 + g;  // this thread's two query rows
  const int row1 = row0 + 8;
  const bool live0 = row0 < Sq, live1 = row1 < Sq;
  const int pos0 = live0 ? q_pos[row0] : INT_MIN;
  const int pos1 = live1 ? q_pos[row1] : INT_MIN;

  // q's elements for the A fragments, loaded first so that their latency
  // overlaps the block's reduction and the first K/V loads: element (row, d)
  // with r = 0: row0, d = kk*16 + tig*2 (+1); r = 1: row1; r = 2, 3: d + 8.
  float2 qraw[KSTEPS][4];
  {
    const TQ* q0p = q + ((static_cast<size_t>(b) * H + h) * Sq + (live0 ? row0 : 0)) * HD;
    const TQ* q1p = q + ((static_cast<size_t>(b) * H + h) * Sq + (live1 ? row1 : 0)) * HD;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool live = (r & 1) ? live1 : live0;
        const int d = kk * 16 + (r >> 1) * 8 + tig * 2;
        qraw[kk][r] = live ? load_pair(((r & 1) ? q1p : q0p) + d) : make_float2(0.f, 0.f);
      }
  }

  if (tid == 0) max_pos = INT_MIN;
  __syncthreads();
  int mp = max(pos0, pos1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mp = max(mp, __shfl_xor_sync(0xffffffffu, mp, o));
  if (lane == 0) atomicMax(&max_pos, mp);
  __syncthreads();
  int n_tiles = (Sk + TC_BK - 1) / TC_BK;
  if (causal) n_tiles = max_pos < 0 ? 0 : min(n_tiles, max_pos / TC_BK + 1);

  const size_t kv_off = (static_cast<size_t>(b) * KV + kvh) * Sk * HD;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;
  // stage `buf` of round `it`: KV tile TC_GROUPS * it + j for group j
  auto load_round = [&](int buf, int it) {
    constexpr int PER_ROW = HD / 8;  // 16-byte pieces per key
    for (int i = tid; i < TC_GROUPS * TC_BK * PER_ROW; i += TC_THREADS) {
      const int j = i / (TC_BK * PER_ROW), r = (i / PER_ROW) % TC_BK, c = (i % PER_ROW) * 8;
      const int key = (TC_GROUPS * it + j) * TC_BK + r;
      const bool ok = key < Sk && TC_GROUPS * it + j < n_tiles;
      const size_t src = static_cast<size_t>(key) * HD + c;
      const int dst = (buf * TC_GROUPS + j) * TILE + r * SROW + c;
      cp_async16(ks + dst, ok ? kb + src : kb, ok);
      cp_async16(vs + dst, ok ? vb + src : vb, ok);
    }
  };
  const int n_rounds = (n_tiles + TC_GROUPS - 1) / TC_GROUPS;
  if (n_rounds > 0) {
    load_round(0, 0);
    cp_async_commit();
  }

  // q's A fragments, scaled (float32 q) and split into bf16 pieces
  unsigned qa[KSTEPS][QP][4];
  {
    const float scale = QP == 1 ? 1.f : sm_scale;  // a bf16 q stays exact: S is scaled instead
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        unsigned piece[QP];
        split_pack<QP>(qraw[kk][r].x * scale, qraw[kk][r].y * scale, piece);
#pragma unroll
        for (int p = 0; p < QP; ++p) qa[kk][p][r] = piece[p];
      }
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sums

  for (int it = 0; it < n_rounds; ++it) {
    if (it + 1 < n_rounds) {
      load_round((it + 1) & 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t = TC_GROUPS * it + grp;  // this group's KV tile
    if (t >= n_tiles) {                   // past the last tile: nothing to add
      __syncthreads();
      continue;
    }
    const __nv_bfloat16* kt = ks + ((it & 1) * TC_GROUPS + grp) * TILE;
    const __nv_bfloat16* vt = vs + ((it & 1) * TC_GROUPS + grp) * TILE;
    const int k0 = t * TC_BK;

    // S = q.k^T: accumulator element i of key tile nt is row (i < 2 ? row0 :
    // row1), key k0 + nt*8 + tig*2 + (i & 1). Smallest pieces first.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bk[4];  // b0, b1 of key tiles 2np and 2np + 1
        ldmatrix_x4(bk, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * SROW + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int p = QP - 1; p >= 0; --p) {
          mma_bf16(s[2 * np], qa[kk][p], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa[kk][p], bk[2], bk[3]);
        }
      }

    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + tig * 2 + (i & 1);
        const bool ok = key < Sk && (!causal || key <= (i < 2 ? pos0 : pos1));
        const float x = QP == 1 ? s[nt][i] * sm_scale : s[nt][i];
        s[nt][i] = ok ? x : NEG;
        if (i < 2) mx0 = fmaxf(mx0, s[nt][i]);
        else mx1 = fmaxf(mx1, s[nt][i]);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {  // the four threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + tig * 2 + (i & 1);
        const bool ok = key < Sk && (!causal || key <= (i < 2 ? pos0 : pos1));
        s[nt][i] = ok ? expf(s[nt][i] - (i < 2 ? mn0 : mn1)) : 0.f;
        if (i < 2) ps0 += s[nt][i];
        else ps1 += s[nt][i];
      }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += P.V: the score fragments of key tiles 2kk, 2kk + 1 are the A
    // fragment of keys kk*16 .. +15.
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      unsigned pa[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        unsigned piece[3];
        split_pack<3>(s[2 * kk + (r >> 1)][(r & 1) * 2], s[2 * kk + (r >> 1)][(r & 1) * 2 + 1], piece);
#pragma unroll
        for (int p = 0; p < 3; ++p) pa[p][r] = piece[p];
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        unsigned bv[4];  // b0, b1 of head-dim tiles 2dp and 2dp + 1
        ldmatrix_x4_trans(bv, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * SROW + dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int p = 2; p >= 0; --p) {
          mma_bf16(acc[2 * dp], pa[p], bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], pa[p], bv[2], bv[3]);
        }
      }
    }
    m0 = mn0;
    m1 = mn1;
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // Merge the groups' partial softmaxes: group j > 0 leaves (m, l, acc) in
  // shared memory (the K/V stages are free now); group 0 rescales both to the
  // larger max, adds, and writes the output.
  constexpr int PART = 4 + 4 * DT;  // floats a thread leaves
  float* parts = reinterpret_cast<float*>(smem_raw);  // [TC_GROUPS - 1][64 threads][PART]
  const int me = wq * 32 + lane;
  if (grp > 0) {
    float* part = parts + ((grp - 1) * 64 + me) * PART;
    part[0] = m0;
    part[1] = m1;
    part[2] = l0;
    part[3] = l1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[4 + dt * 4 + i] = acc[dt][i];
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int j = 1; j < TC_GROUPS; ++j) {
    const float* o = parts + ((j - 1) * 64 + me) * PART;
    const float mx0 = fmaxf(m0, o[0]), mx1 = fmaxf(m1, o[1]);
    const float a0 = expf(m0 - mx0), b0 = expf(o[0] - mx0);
    const float a1 = expf(m1 - mx1), b1 = expf(o[1] - mx1);
    l0 = l0 * a0 + o[2] * b0;
    l1 = l1 * a1 + o[3] * b1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] = acc[dt][0] * a0 + o[4 + dt * 4 + 0] * b0;
      acc[dt][1] = acc[dt][1] * a0 + o[4 + dt * 4 + 1] * b0;
      acc[dt][2] = acc[dt][2] * a1 + o[4 + dt * 4 + 2] * b1;
      acc[dt][3] = acc[dt][3] * a1 + o[4 + dt * 4 + 3] * b1;
    }
    m0 = mx0;
    m1 = mx1;
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  TQ* o0 = out + ((static_cast<size_t>(b) * H + h) * Sq + row0) * HD;
  TQ* o1 = out + ((static_cast<size_t>(b) * H + h) * Sq + row1) * HD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (live0) store_pair(o0 + d, acc[dt][0] / d0, acc[dt][1] / d0);
    if (live1) store_pair(o1 + d, acc[dt][2] / d1, acc[dt][3] / d1);
  }
}

template <typename TQ, int HD, int QP>
int launch_tc(const TQ* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const int32_t* q_pos,
              TQ* out, int B, int H, int KV, int Sq, int Sk, float sm_scale, int causal,
              cudaStream_t stream) {
  constexpr int smem = 2 * 2 * TC_GROUPS * TC_BK * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  auto kernel = flash_tc_kernel<TQ, HD, QP>;
  if (smem > 48 * 1024) {  // above 48 KB only when asked for, once per kernel
    static const cudaError_t set =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, B * H);
  kernel<<<grid, TC_THREADS, smem, stream>>>(q, k, v, q_pos, out, H, KV, Sq, Sk, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32 k/v: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per KV tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;

template <typename TQ, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fp32_kernel(const TQ* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int32_t* __restrict__ q_pos,
                  TQ* __restrict__ out, int H, int KV, int Sq, int Sk,
                  float sm_scale, int causal) {
  constexpr int DPT = HD / TPR;  // head dims per thread: d = t + TPR * i
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  __shared__ int max_pos;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int row = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int qi = blockIdx.x * BQ + row;
  const bool live = qi < Sq;
  const int my_pos = live ? q_pos[qi] : INT_MIN;

  if (threadIdx.x == 0) max_pos = INT_MIN;
  __syncthreads();
  if (t == 0 && live) atomicMax(&max_pos, my_pos);
  __syncthreads();

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = max_pos < 0 ? 0 : min(n_tiles, max_pos / BK + 1);

  float qr[DPT], acc[DPT];
  const TQ* qrow = q + (((size_t)b * H + h) * Sq + (live ? qi : 0)) * HD;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = live ? to_f(qrow[t + TPR * i]) * sm_scale : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG, l = 0.f;

  const size_t kv_off = ((size_t)b * KV + kvh) * Sk * HD;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD;
      const int d = idx % HD;
      const bool in = k0 + j < Sk;
      ks[j][d] = in ? kb[(size_t)(k0 + j) * HD + d] : 0.f;
      vs[j][d] = in ? vb[(size_t)(k0 + j) * HD + d] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tile_max = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) p = fmaf(qr[i], ks[j][t + TPR * i], p);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int kj = k0 + j;
      const bool ok = kj < Sk && (!causal || kj <= my_pos);
      s[j] = ok ? p : NEG;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kj = k0 + j;
      const bool ok = kj < Sk && (!causal || kj <= my_pos);
      s[j] = ok ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j)
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(s[j], vs[j][t + TPR * i], acc[i]);
    m = m_new;
  }

  if (live) {
    TQ* orow = out + (((size_t)b * H + h) * Sq + qi) * HD;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[t + TPR * i] = from_f<TQ>(acc[i] / denom);
  }
}

template <typename TQ, int HD>
int launch_fp32(const TQ* q, const float* k, const float* v, const int32_t* q_pos, TQ* out,
                int B, int H, int KV, int Sq, int Sk, float sm_scale, int causal,
                cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fp32_kernel<TQ, HD><<<grid, THREADS, 0, stream>>>(q, k, v, q_pos, out, H, KV, Sq, Sk, sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* q_pos, void* out, int B,
              int H, int KV, int Sq, int Sk, int kv_dtype, float sm_scale, int causal,
              cudaStream_t s) {
  const TQ* qt = static_cast<const TQ*>(q);
  const int32_t* pt = static_cast<const int32_t*>(q_pos);
  TQ* ot = static_cast<TQ*>(out);
  constexpr int QP = sizeof(TQ) == 4 ? 3 : 1;  // bf16 pieces of q
  if (kv_dtype == 1)
    return launch_tc<TQ, HD, QP>(qt, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
                                 pt, ot, B, H, KV, Sq, Sk, sm_scale, causal, s);
  if (kv_dtype == 0)
    return launch_fp32<TQ, HD>(qt, static_cast<const float*>(k), static_cast<const float*>(v), pt, ot, B, H, KV,
                               Sq, Sk, sm_scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ>
int launch_q(const void* q, const void* k, const void* v, const void* q_pos, void* out, int B,
             int H, int KV, int Sq, int Sk, int hd, int kv_dtype, float sm_scale, int causal,
             cudaStream_t s) {
  switch (hd) {
    case 32: return launch_hd<TQ, 32>(q, k, v, q_pos, out, B, H, KV, Sq, Sk, kv_dtype, sm_scale, causal, s);
    case 64: return launch_hd<TQ, 64>(q, k, v, q_pos, out, B, H, KV, Sq, Sk, kv_dtype, sm_scale, causal, s);
    case 128: return launch_hd<TQ, 128>(q, k, v, q_pos, out, B, H, KV, Sq, Sk, kv_dtype, sm_scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16. The output has q's dtype. bf16 k/v
// run the tensor-core kernel, float32 k/v the CUDA-core one.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* q_pos, void* out, int B, int H,
                                   int KV, int Sq, int Sk, int hd, int q_dtype,
                                   int kv_dtype, float sm_scale, int causal,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(q, k, v, q_pos, out, B, H, KV, Sq, Sk, hd, kv_dtype, sm_scale, causal, s);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(q, k, v, q_pos, out, B, H, KV, Sq, Sk, hd, kv_dtype, sm_scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
