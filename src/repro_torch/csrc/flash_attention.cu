// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py): online softmax over KV tiles with
// absolute query positions, KV head h / (H / KV), KV tiles past the tile's
// largest visible position skipped, fp32 running max / sum / accumulator,
// output in q's dtype.
//
// What bounds it on this card: at the serving prefill shape (B 4, H 9, KV 3,
// S 256, hd 64, bf16) the inputs and output are ~3 MB and the causal work is
// ~0.3 GFLOP, so the bound is the bytes, about a microsecond. This simple
// kernel is bound by its fp32 FMA issue instead: no tensor cores, no wgmma,
// no TMA yet. What the design does: the TPU kernel keeps K/V resident in
// VMEM for a (batch, head); here one block owns (batch, head, 64 queries)
// and streams 32-key K/V tiles through shared memory (converted to fp32 once
// per tile), so shared memory stays under 32 KB at head_dim 128. Four
// threads share one query row, each holding a quarter of q and of the
// accumulator in registers; a score is their partial dots summed with two
// warp shuffles. The block loops only up to the last KV tile that its
// largest query position can see.
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

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per KV tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, const int32_t* __restrict__ q_pos,
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
  const TKV* kb = k + kv_off;
  const TKV* vb = v + kv_off;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * HD; idx += THREADS) {
      const int j = idx / HD;
      const int d = idx % HD;
      const bool in = k0 + j < Sk;
      ks[j][d] = in ? to_f(kb[(size_t)(k0 + j) * HD + d]) : 0.f;
      vs[j][d] = in ? to_f(vb[(size_t)(k0 + j) * HD + d]) : 0.f;
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

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           void* out, int B, int H, int KV, int Sq, int Sk, int hd,
           float sm_scale, int causal, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(k);
  const TKV* vt = static_cast<const TKV*>(v);
  const int32_t* pt = static_cast<const int32_t*>(q_pos);
  TQ* ot = static_cast<TQ*>(out);
  switch (hd) {
    case 32:
      flash_fwd_kernel<TQ, TKV, 32><<<grid, THREADS, 0, stream>>>(qt, kt, vt, pt, ot, H, KV, Sq, Sk, sm_scale, causal);
      break;
    case 64:
      flash_fwd_kernel<TQ, TKV, 64><<<grid, THREADS, 0, stream>>>(qt, kt, vt, pt, ot, H, KV, Sq, Sk, sm_scale, causal);
      break;
    case 128:
      flash_fwd_kernel<TQ, TKV, 128><<<grid, THREADS, 0, stream>>>(qt, kt, vt, pt, ot, H, KV, Sq, Sk, sm_scale, causal);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_q(const void* q, const void* k, const void* v, const void* q_pos,
             void* out, int B, int H, int KV, int Sq, int Sk, int hd,
             int kv_dtype, float sm_scale, int causal, cudaStream_t s) {
  if (kv_dtype == 0)
    return launch<TQ, float>(q, k, v, q_pos, out, B, H, KV, Sq, Sk, hd, sm_scale, causal, s);
  if (kv_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q, k, v, q_pos, out, B, H, KV, Sq, Sk, hd, sm_scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16. The output has q's dtype.
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
