// Flash attention for few queries (L <= 8) on Hopper (sm_90a): one launch,
// the keys split over the blocks of a thread block cluster, the partial
// softmax states merged through distributed shared memory. fp32, plain C
// entry point.
//
// Replaces, for L <= 8, the Pallas TPU kernel
// nvblox_mindmap_tpu/ops/flash_attention.py:43 (_flash_kernel, called from
// flash_attention). Same function: pre-scaled q (B,H,L,D) against k, v
// (B,H,S,D), an optional (B,S) inclusion mask (nonzero = valid key), a
// streaming softmax whose running max starts at -1e9, p multiplied by the
// mask, and a safe divide by l > 0 ? l : 1, so a row with no valid key comes
// out as exact zeros. Any head dim D: a score sums q.k over D in chunks of
// at most 128 (the chunk of a thread's K row sits in registers), and each
// block writes one chunk of at most 128 output columns, the one blockIdx.z
// names (its V rows go straight to shared memory). So D > 128 is one launch
// of ceil(D / 128) times the blocks, each recomputing the scores for its own
// columns: ceil(D / 128) times the q.k work, with every block's registers and
// shared memory at the D = 128 budget. D <= 128 takes instances compiled
// without the chunk loop. q, k, v and o come with their own
// batch, head and sequence strides; only the last dim is unit-stride.
//
// What bounds it on this card. The model's few-query calls are the
// encoder's gripper cross-attention (L = 3, or 6 for two grippers) and the
// denoiser's cross-attention (L = 1 or 2) over S = 2048 keys at head dim 15:
// ~0.5 MB of K and V per batch element and 4*L*S*D ~ 0.1 MFLOP per head.
// The bound is the bytes, well under a microsecond at 3.35 TB/s. What such a
// call really pays is latency: a grid tiled over the queries has only B*H
// blocks (8 on 132 SMs at B = 1), each walking all S keys in series.
//
// Design. One cluster of C <= 8 blocks (the portable cluster size) per
// (b, h); its blocks split the keys, about 256 per block at S = 2048 and
// fewer blocks for short S, so B = 1 runs 64 blocks instead of 8. In a block
// each of the 256 threads owns one key of a 256-key chunk: it reads the
// key's K row into registers and its V row into shared memory (16-byte loads
// where the layout allows), and scores the key against all L queries, which
// sit in shared memory. The block reduces each query's max with warp
// shuffles, writes p = exp(s - m) * valid to shared memory, and each warp
// sums p * V over the chunk for a few (query, d) outputs; a column of ones
// beside V gives l the same way. A longer key range loops over chunks with
// the usual rescaling. Then the blocks of the cluster merge their partial
// (m, l, acc) through distributed shared memory: m = max m_i,
// l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m). A split whose keys
// are all masked carries m_i = -1e9, l_i = 0, acc_i = 0 and adds exactly 0.
// No second launch, no atomics, no global scratch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // one key of a chunk per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 8;        // queries a call may have
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kKeysPerBlock = 256;
constexpr float kNegInf = -1e9f;  // the Pallas kernel's NEG_INF

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;
  float* o;
  int H, L, S, D;
  int64_t q_sb, q_sh, q_sl;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_sl;
  int vec;  // K and V rows may be read as float4
};

// Row d < D of src into dst, zeros beyond D.
template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int D,
                                         bool vec, float (&dst)[DP]) {
  if (vec) {
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < D) x = *reinterpret_cast<const float4*>(src + d);
      dst[d] = x.x;
      dst[d + 1] = x.y;
      dst[d + 2] = x.z;
      dst[d + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DP; ++d) dst[d] = d < D ? src[d] : 0.f;
  }
}

// Row d < D of src into shared dst, zeros beyond D.
template <int DP>
__device__ __forceinline__ void store_row(const float* __restrict__ src, int D,
                                          bool vec, float* dst) {
  if (vec) {
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d < D) x = *reinterpret_cast<const float4*>(src + d);
      dst[d] = x.x;
      dst[d + 1] = x.y;
      dst[d + 2] = x.z;
      dst[d + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DP; ++d) dst[d] = d < D ? src[d] : 0.f;
  }
}

// DP is the width of a chunk of the head dim: D rounded up to 16, 32, 64 or
// 128 for D <= 128, else 128.
template <int DP>
constexpr int smem_floats() {
  return kThreads * (DP + 1)    // v_s: the key chunk's V rows, column Dv = 1
         + kMaxL * kThreads     // p_s
         + kMaxL * DP           // q_s: one chunk of the head dim
         + kWarps * kMaxL       // red_s
         + kMaxL                // m_s
         + kMaxL * (DP + 1);    // acc_s, column Dv = l
}

// q's columns [d0, d0 + Dc) of every query into q_s, zeros elsewhere.
template <int DP>
__device__ __forceinline__ void load_q(const float* __restrict__ q_bh,
                                       int64_t q_sl, int L, int d0, int Dc,
                                       float* q_s) {
  for (int i = threadIdx.x; i < kMaxL * DP; i += kThreads) {
    const int l = i / DP, d = i % DP;
    q_s[i] = (l < L && d < Dc) ? q_bh[l * q_sl + d0 + d] : 0.f;
  }
}

// kChunked: D > 128, so the scores walk the head dim's chunks and blockIdx.z
// picks the output columns. Only the DP = 128 kernel has the chunked
// instance; the others compile to one chunk of all of D.
template <int DP, bool kChunked>
__global__ void __launch_bounds__(kThreads)
flash_split_kernel(const Params p) {
  extern __shared__ float smem[];
  float* v_s = smem;
  float* p_s = v_s + kThreads * (DP + 1);
  float* q_s = p_s + kMaxL * kThreads;
  float* red_s = q_s + kMaxL * DP;
  float* m_s = red_s + kWarps * kMaxL;
  float* acc_s = m_s + kMaxL;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int L = p.L, S = p.S, D = p.D;
  const bool vec = p.vec != 0;
  // The head dim's chunks for the scores, and this block's output columns
  // [col0, col0 + Dv).
  const int n_chunks = kChunked ? (D + DP - 1) / DP : 1;
  const int col0 = kChunked ? blockIdx.z * DP : 0;
  const int Dv = kChunked ? min(DP, D - col0) : D;

  const float* q_bh = p.q + b * p.q_sb + h * p.q_sh;
  const float* k_bh = p.k + b * p.k_sb + h * p.k_sh;
  const float* v_bh = p.v + b * p.v_sb + h * p.v_sh;
  float* o_bh = p.o + b * p.o_sb + h * p.o_sh;
  const uint8_t* mask_b = p.mask == nullptr ? nullptr : p.mask + (int64_t)b * S;

  if (!kChunked) load_q<DP>(q_bh, p.q_sl, L, 0, D, q_s);
  for (int i = tid; i < kMaxL * (DP + 1); i += kThreads) acc_s[i] = 0.f;
  __syncthreads();

  // This block's keys: [s_begin, s_end).
  const int per_block = (S + n_blocks - 1) / n_blocks;
  const int s_begin = min(S, rank * per_block);
  const int s_end = min(S, s_begin + per_block);

  // The running max of each query; every thread holds the same values.
  float m_run[kMaxL];
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) m_run[l] = kNegInf;

  for (int c0 = s_begin; c0 < s_end; c0 += kThreads) {
    const int s = c0 + tid;
    const bool in = s < s_end;
    const bool valid = in && (mask_b == nullptr || mask_b[s] != 0);
    // The V row first, so that its loads and the K row's go out together.
    float* v_row = v_s + tid * (DP + 1);
    if (in) {
      store_row<DP>(v_bh + s * p.v_ss + col0, Dv, vec, v_row);
    } else {
#pragma unroll
      for (int d = 0; d < DP; ++d) v_row[d] = 0.f;
    }
    v_row[Dv] = 1.f;  // p * 1 summed over the keys is l

    float dot[kMaxL];
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) dot[l] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int d0 = c * DP;
      if (kChunked) {  // q_s holds chunk c of the queries
        __syncthreads();
        load_q<DP>(q_bh, p.q_sl, L, d0, min(DP, D - d0), q_s);
        __syncthreads();
      }
      float kr[DP];
      if (in) {
        load_row<DP>(k_bh + s * p.k_ss + d0, kChunked ? min(DP, D - d0) : D, vec,
                     kr);
      } else {
#pragma unroll
        for (int d = 0; d < DP; ++d) kr[d] = 0.f;
      }
#pragma unroll
      for (int l = 0; l < kMaxL; ++l)
        if (l < L) {
#pragma unroll
          for (int d = 0; d < DP; ++d)
            dot[l] = fmaf(q_s[l * DP + d], kr[d], dot[l]);
        }
    }

    float sc[kMaxL];
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      sc[l] = kNegInf;
      if (l < L) {
        if (valid) sc[l] = dot[l];
        float x = sc[l];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
        if (lane == 0) red_s[warp * kMaxL + l] = x;
      }
    }
    __syncthreads();

    float alpha[kMaxL];
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      alpha[l] = 1.f;
      if (l < L) {
        float chunk_max = red_s[l];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          chunk_max = fmaxf(chunk_max, red_s[w * kMaxL + l]);
        const float m_new = fmaxf(m_run[l], chunk_max);
        alpha[l] = expf(m_run[l] - m_new);
        m_run[l] = m_new;
        // The mask factor keeps masked keys at exactly 0, even where every
        // score of the row is kNegInf (there exp(sc - m_new) = 1).
        p_s[l * kThreads + tid] = expf(sc[l] - m_new) * (valid ? 1.f : 0.f);
      }
    }
    __syncthreads();

    // acc[l][d] (d < Dv) and l[l] (d == Dv): sum over the key chunk of
    // p * [V | 1].
    const int n_keys = min(kThreads, s_end - c0);
    for (int o = warp; o < L * (Dv + 1); o += kWarps) {
      const int l = o / (Dv + 1);
      const int d = o % (Dv + 1);
      float sum = 0.f;
      for (int j = lane; j < n_keys; j += 32)
        sum = fmaf(p_s[l * kThreads + j], v_s[j * (DP + 1) + d], sum);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        float a = 1.f;
#pragma unroll
        for (int ll = 0; ll < kMaxL; ++ll)
          if (ll == l) a = alpha[ll];
        acc_s[l * (DP + 1) + d] = acc_s[l * (DP + 1) + d] * a + sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int l = 0; l < kMaxL; ++l)
    if (tid == l) m_s[l] = m_run[l];
  cluster.sync();  // every block's (m, l, acc) is visible to the cluster

  for (int o = rank + n_blocks * tid; o < L * Dv; o += n_blocks * kThreads) {
    const int l = o / Dv;
    const int d = o % Dv;
    float m = kNegInf;
    for (int r = 0; r < n_blocks; ++r)
      m = fmaxf(m, *cluster.map_shared_rank(m_s + l, r));
    float l_sum = 0.f;
    float acc = 0.f;
    for (int r = 0; r < n_blocks; ++r) {
      const float* acc_r = cluster.map_shared_rank(acc_s, r) + l * (DP + 1);
      const float scale = expf(*cluster.map_shared_rank(m_s + l, r) - m);
      l_sum = fmaf(acc_r[Dv], scale, l_sum);
      acc = fmaf(acc_r[d], scale, acc);
    }
    o_bh[l * p.o_sl + col0 + d] = acc / (l_sum > 0.f ? l_sum : 1.f);
  }
  cluster.sync();  // no block leaves while another still reads its memory
}

template <int DP, bool kChunked = false>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_split_kernel<DP, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  int blocks = (p.S + kKeysPerBlock - 1) / kKeysPerBlock;
  blocks = blocks < 1 ? 1 : (blocks > kMaxCluster ? kMaxCluster : blocks);

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, B * p.H, kChunked ? (p.D + DP - 1) / DP : 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_split_kernel<DP, kChunked>, p);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns the launch's CUDA error (0 = success). mask may be null (every key
// valid), else a contiguous (B, S) uint8. Strides are in elements.
extern "C" int flash_attention_split_fwd(
    const float* q, const float* k, const float* v, const uint8_t* mask,
    float* o, int B, int H, int L, int S, int D, int64_t q_sb, int64_t q_sh,
    int64_t q_sl, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_sl,
    void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || L > kMaxL || S < 0 || D <= 0 ||
      (int64_t)B * H > 65535 || (D + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && aligned16(k) && aligned16(v) &&
                   (k_sb | k_sh | k_ss | v_sb | v_sh | v_ss) % 4 == 0;
  const Params p{q,    k,    v,    mask, o,    H,    L,    S,    D,
                 q_sb, q_sh, q_sl, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_sl, vec ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 16)
    err = launch<16>(p, B, st);
  else if (D <= 32)
    err = launch<32>(p, B, st);
  else if (D <= 64)
    err = launch<64>(p, B, st);
  else if (D <= 128)
    err = launch<128>(p, B, st);
  else
    err = launch<128, true>(p, B, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
