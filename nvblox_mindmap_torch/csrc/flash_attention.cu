// Forward flash attention for Hopper (sm_90a), fp32, plain C entry point.
//
// Replaces the Pallas TPU kernel nvblox_mindmap_tpu/ops/flash_attention.py
// (_flash_kernel, called from flash_attention). Same function: pre-scaled
// q (B,H,L,D) against k, v (B,H,S,D), an optional (B,S) inclusion mask
// (nonzero = valid key), streaming softmax with a running max, a running
// denominator and an fp32 accumulator. p is multiplied by the mask, so masked
// keys contribute exactly 0, and a row with no valid key writes exact zeros
// (safe divide by l > 0 ? l : 1).
//
// What bounds it on this card. The model's head dims are 9 and 15 (padded to
// 16 here) and its attention calls are either L <= 6 queries against S = 2048
// keys, or L = S ~ 410. Per (query, key) pair the kernel does 2*D FMAs and
// reads nothing from device memory, so with the K/V tile staged in shared
// memory it is bound by fp32 FMA issue (67 TFLOP/s peak outside the tensor
// cores), not by bytes: the inputs are at most a few MB. At L <= 6 most of a
// 64-row query tile idles and only B*H blocks run, so those calls are bound
// by latency and occupancy instead; split-S across blocks and a wgmma design
// are later work.
//
// Design. One thread block per (64-query tile, b*h). The grid's sequential
// TPU axis over key blocks becomes a loop inside the block over 64-key tiles
// of K and V staged in shared memory (zero-padded to the template head dim
// DP). Four adjacent threads own one query row; each keeps its own online
// softmax state over every fourth key of a tile, in registers, and the four
// states are merged with warp shuffles at the end. No state crosses blocks,
// so the blocks run in any order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;                 // query rows per block
constexpr int kBlockN = 64;                 // keys per shared-memory tile
constexpr int kSplit = 4;                   // threads per query row
constexpr int kThreads = kBlockM * kSplit;  // 256
constexpr int kKeysPerThread = kBlockN / kSplit;
constexpr float kNegInf = -1e9f;            // the Pallas kernel's NEG_INF

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ mask,
                 float* __restrict__ o, int H, int L, int S, int D) {
  // +1 column: the four key rows a warp reads at once fall in distinct banks.
  __shared__ float k_tile[kBlockN][DP + 1];
  __shared__ float v_tile[kBlockN][DP + 1];
  __shared__ float valid_tile[kBlockN];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int row = tid / kSplit;
  const int part = tid % kSplit;
  const int qi = blockIdx.x * kBlockM + row;
  const bool row_in = qi < L;

  const float* q_bh = q + (size_t)bh * L * D;
  const float* k_bh = k + (size_t)bh * S * D;
  const float* v_bh = v + (size_t)bh * S * D;
  const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * S;

  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = (row_in && d < D) ? q_bh[(size_t)qi * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int s0 = 0; s0 < S; s0 += kBlockN) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < kBlockN * DP; i += kThreads) {
      const int r = i / DP;
      const int c = i % DP;
      const int s = s0 + r;
      const bool in = s < S && c < D;
      k_tile[r][c] = in ? k_bh[(size_t)s * D + c] : 0.f;
      v_tile[r][c] = in ? v_bh[(size_t)s * D + c] : 0.f;
    }
    if (tid < kBlockN) {
      const int s = s0 + tid;
      valid_tile[tid] =
          (s < S && (mask_b == nullptr || mask_b[s] != 0)) ? 1.f : 0.f;
    }
    __syncthreads();

    float sc[kKeysPerThread];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int n = j * kSplit + part;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) dot = fmaf(qr[d], k_tile[n][d], dot);
      sc[j] = valid_tile[n] != 0.f ? dot : kNegInf;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int n = j * kSplit + part;
      // The mask factor keeps masked keys at exactly 0, even in a row whose
      // every score is kNegInf (there exp(sc - m_new) = 1).
      const float p = expf(sc[j] - m_new) * valid_tile[n];
      l += p;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, v_tile[n][d], acc[d]);
    }
    m = m_new;
  }

  // Merge the kSplit partial states of a row; its threads are adjacent lanes.
  float m_row = m;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));
  const float scale = expf(m - m_row);
  l *= scale;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    acc[d] *= scale;
#pragma unroll
    for (int off = 1; off < kSplit; off <<= 1)
      acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  const float safe_l = l > 0.f ? l : 1.f;
  if (row_in) {
    float* o_row = o + (size_t)bh * L * D + (size_t)qi * D;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D && d % kSplit == part) o_row[d] = acc[d] / safe_l;
  }
}

template <int DP>
void launch(const float* q, const float* k, const float* v,
            const uint8_t* mask, float* o, int B, int H, int L, int S, int D,
            cudaStream_t stream) {
  const dim3 grid((L + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<DP><<<grid, kThreads, 0, stream>>>(q, k, v, mask, o, H, L,
                                                      S, D);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success). mask may be
// null (every key valid). All tensors are contiguous fp32 (mask: uint8).
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, const uint8_t* mask,
                                   float* o, int B, int H, int L, int S, int D,
                                   void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || S < 0 || D <= 0 || D > 64 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    launch<16>(q, k, v, mask, o, B, H, L, S, D, st);
  else if (D <= 32)
    launch<32>(q, k, v, mask, o, B, H, L, S, D, st);
  else
    launch<64>(q, k, v, mask, o, B, H, L, S, D, st);
  return (int)cudaGetLastError();
}
