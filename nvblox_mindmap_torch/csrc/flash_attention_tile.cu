// Flash attention for many queries (L > 8) on Hopper (sm_90a): 32-query
// tiles on the tensor cores, mma.sync m16n8k8 in 3xTF32. fp32 in and out,
// plain C entry point.
//
// Replaces, for L > 8, the Pallas TPU kernel
// nvblox_mindmap_tpu/ops/flash_attention.py:43 (_flash_kernel, called from
// flash_attention). Same function: pre-scaled q (B,H,L,D) against k, v
// (B,H,S,D), an optional (B,S) inclusion mask (nonzero = valid key), a
// streaming softmax whose running max starts at -1e9, p multiplied by the
// mask, and a safe divide by l > 0 ? l : 1, so a row with no valid key comes
// out as exact zeros. Any head dim D: a score sums q.k over D in chunks of
// at most 128, and each block writes one chunk of at most 128 output columns,
// the one blockIdx.z names (at 128 one pair of warps: two pairs' K and V
// stages would not fit in shared memory). q, k, v and o come with their own
// batch, head and sequence strides; only the last dim is unit-stride.
//
// What bounds it on this card. The model's many-query calls are its
// self-attention stacks over L = S ~ 410 tokens (129 or 130 in the committed
// fixtures) at head dim 15: 4*L*S*D ~ 10 MFLOP per head, ~80 MFLOP per call
// at B = 1, and under a megabyte of inputs. That is work for the tensor
// cores, whose TF32 rate bounds the call below a microsecond even with three
// products per multiply; what a call really pays is latency, so the grid has
// to reach every SM and every scheduler. Done as fp32 FMA from shared memory
// (the first version), one shared-memory read per FMA set the pace, and
// 64-row query tiles left 56 blocks for 132 SMs.
//
// Design. Each warp owns 16 query rows and a block covers 32 rows with a
// pair of warps, so B = 1, L = 410 runs 13 x 8 = 104 blocks. Where that grid
// gives the SMs fewer than two blocks each (and S > 64), a block has a
// second pair of warps: pair 0 takes the even 64-key tiles, pair 1 the odd
// ones, so all four schedulers of an SM have a warp to issue from even at
// B = 1, and the two partial softmax states of a row are merged in shared
// memory at the end. Larger grids keep one pair, where smaller blocks fit
// more of them on an SM. The keys of a step (a 64-key tile per pair) are
// double-buffered in shared memory with cp.async: step i+1 loads while step
// i is computed. Q.K^T and P.V run on mma.sync.m16n8k8 TF32 with the 3xTF32
// split: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and a*b ~
// a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, which keeps fp32 accuracy where plain
// TF32 (about three decimal digits) would not. The online softmax stays in
// fp32 registers on the accumulator fragments.
//
// P goes from the accumulator fragment of Q.K^T to the A fragment of P.V
// without moving: in an m16n8k8 C fragment lane (g = lane/4, t = lane%4)
// holds keys 2t and 2t+1 of an 8-key group, while an A fragment gives it
// columns t and t+4. A sum over keys does not depend on their order, so the
// P.V step numbers its 8 keys (0, 2, 4, 6, 1, 3, 5, 7): column t is key 2t,
// column t+4 is key 2t+1, and the B fragment reads V's rows 2t and 2t+1 to
// match. Shared rows are padded by 4 floats so that the K and V fragment
// reads are free of bank conflicts. Not wgmma: it needs 64-row tiles, which
// bring back the 56-block grid, and at ~80 MFLOP per call filling the SMs
// matters more than the tensor cores' peak rate.
//
// Head dims above 128. The pipeline walks phases, one per (key step, chunk of
// the head dim): a phase loads its chunk of the step's K rows (and, in the
// step's last phase, the V rows of the block's output columns) while the
// previous phase adds its chunk of Q.K^T to the scores; the step's last phase
// then runs the softmax and P.V. Q's fragments of a chunk are read again from
// global memory (L1 / L2) in each phase. Every block recomputes the scores
// for its own columns: ceil(D / 128) times the Q.K^T work, at the D = 128
// budget of registers and shared memory. D <= 128 takes instances compiled
// without the chunks (a step is one phase), so the scores of one step are not
// kept live across the loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpRows = 16;  // query rows per warp (the mma's M)
constexpr int kRowWarps = 2;   // warps across the rows of a block
constexpr int kBlockM = kWarpRows * kRowWarps;  // query rows per block
constexpr int kTileN = 64;     // keys a warp takes per step
constexpr float kNegInf = -1e9f;  // the Pallas kernel's NEG_INF
static_assert(kTileN == 32 * kRowWarps,
              "each thread of a pair loads one key row of its tile");

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
  int vec;  // K and V rows may be copied 16 bytes at a time
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32, the two small products first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// Copy 4 (or 16) bytes to shared memory asynchronously; zeros when !in.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DP>
__host__ __device__ constexpr int row_stride() {
  return DP + 4;  // fragment reads fall in 32 distinct banks
}

// PAIRS pairs of warps: 32 * kRowWarps * PAIRS threads; a step takes
// kTileN * PAIRS keys.
template <int DP, int PAIRS>
constexpr int smem_floats() {
  return 4 * kTileN * PAIRS * row_stride<DP>()  // K and V, two stages each
         + 2 * kTileN * PAIRS;                  // valid flags, two stages
}

// kChunked: D > 128, so a key step walks the head dim's chunks and
// blockIdx.z picks the output columns. Only the DP = 128 kernel has the
// chunked instance; the others compile to one phase per step.
template <int DP, int PAIRS, bool kChunked>
__global__ void __launch_bounds__(32 * kRowWarps * PAIRS)
flash_tile_kernel(const Params p) {
  constexpr int kThreads = 32 * kRowWarps * PAIRS;
  constexpr int kStepN = kTileN * PAIRS;
  constexpr int KD = DP / 8;  // 8-wide steps over the head dim
  constexpr int kStride = row_stride<DP>();
  constexpr int kStage = kStepN * kStride;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [2][kStepN][kStride]
  float* v_s = k_s + 2 * kStage;     // [2][kStepN][kStride]
  float* valid_s = v_s + 2 * kStage; // [2][kStepN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_warp = warp % kRowWarps;
  const int pair = warp / kRowWarps;  // this warp's tile of each step
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int L = p.L, S = p.S, D = p.D;
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

  // This lane's rows of the warp's 16 (the fragments' g and g + 8).
  const int r0 = blockIdx.x * kBlockM + row_warp * kWarpRows + g;
  const int r1 = r0 + 8;

  // Q's columns [d0, d0 + DP) as A fragments, split: a0 (g, t), a1 (g+8, t),
  // a2 (g, t+4), a3 (g+8, t+4) of each 16 x 8 block.
  uint32_t qa_hi[KD][4], qa_lo[KD][4];
  auto load_q = [&](int d0) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c0 = d0 + kd * 8 + t;
      const int c1 = c0 + 4;
      const float x[4] = {
          (r0 < L && c0 < D) ? q_bh[r0 * p.q_sl + c0] : 0.f,
          (r1 < L && c0 < D) ? q_bh[r1 * p.q_sl + c0] : 0.f,
          (r0 < L && c1 < D) ? q_bh[r0 * p.q_sl + c1] : 0.f,
          (r1 < L && c1 < D) ? q_bh[r1 * p.q_sl + c1] : 0.f,
      };
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], qa_hi[kd][i], qa_lo[kd][i]);
    }
  };
  load_q(0);

  // Columns past the data of every K and V row stay zero: no copy writes
  // them. With several chunks a K row's columns past D are zero-filled by
  // the tail chunk's copy instead.
  for (int row = tid; row < 2 * kStepN; row += kThreads) {
    for (int d = kChunked ? DP : D; d < DP; ++d) k_s[row * kStride + d] = 0.f;
    for (int d = Dv; d < DP; ++d) v_s[row * kStride + d] = 0.f;
  }

  // Phase (step, chunk) copies one key row's chunk of K per thread, and in
  // the step's last phase its V row of the block's columns; rows past S are
  // zero-filled (the source address is clamped to row 0, a copy of zero
  // bytes reads nothing).
  const int k_cols = kChunked ? DP : D;
  auto load_phase = [&](int phase, int stage) {
    const int step = phase / n_chunks;
    const int d0 = (phase % n_chunks) * DP;
    const int s = step * kStepN + tid;
    const bool in = s < S;
    const int64_t sc = in ? s : 0;
    const float* k_row = k_bh + sc * p.k_ss;
    float* k_dst = k_s + stage * kStage + tid * kStride;
    const int width = d0 + k_cols <= D ? k_cols : D - d0;  // copied from K
    if (p.vec) {
      for (int d = 0; d < k_cols; d += 4) {
        const bool ok = in && d < width;
        cp_async16(k_dst + d, ok ? k_row + d0 + d : k_row, ok);
      }
    } else {
      for (int d = 0; d < k_cols; ++d) {
        const bool ok = in && d < width;
        cp_async4(k_dst + d, ok ? k_row + d0 + d : k_row, ok);
      }
    }
    if (phase % n_chunks == n_chunks - 1) {
      const float* v_row = v_bh + sc * p.v_ss + col0;
      float* v_dst = v_s + stage * kStage + tid * kStride;
      if (p.vec) {
        for (int d = 0; d < Dv; d += 4) cp_async16(v_dst + d, v_row + d, in);
      } else {
        for (int d = 0; d < Dv; ++d) cp_async4(v_dst + d, v_row + d, in);
      }
    }
    cp_async_commit();
  };
  auto key_valid = [&](int phase) {
    const int s = (phase / n_chunks) * kStepN + tid;
    return (s < S && (mask_b == nullptr || mask_b[s] != 0)) ? 1.f : 0.f;
  };

  float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;          // this lane's part of their sums
  float o_acc[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[kd][i] = 0.f;

  const int n_phases = (S + kStepN - 1) / kStepN * n_chunks;
  if (n_phases > 0) {
    load_phase(0, 0);
    valid_s[tid] = key_valid(0);
  }
  // S = Q K^T for this warp's 16 rows x 64 keys: 8 accumulators of 16 x 8,
  // summed over the step's phases.
  float s_acc[kTileN / 8][4];
  for (int it = 0; it < n_phases; ++it) {
    const int stage = it & 1;
    const int chunk = it % n_chunks;
    const bool more = it + 1 < n_phases;
    float next_valid = 0.f;
    if (more) {
      load_phase(it + 1, stage ^ 1);
      next_valid = key_valid(it + 1);  // stored after this phase's compute
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* kt = k_s + stage * kStage + pair * kTileN * kStride;
    const float* vt = v_s + stage * kStage + pair * kTileN * kStride;
    const float* vl = valid_s + stage * kStepN + pair * kTileN;

    if (kChunked) load_q(chunk * DP);
#pragma unroll
    for (int n = 0; n < kTileN / 8; ++n) {
      if (chunk == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s_acc[n][i] = 0.f;
      }
      const float* k_row = kt + (n * 8 + g) * kStride;  // b: (k = t, n = g)
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(k_row[kd * 8 + t], b_hi[0], b_lo[0]);
        split_tf32(k_row[kd * 8 + t + 4], b_hi[1], b_lo[1]);
        mma_3xtf32(s_acc[n], qa_hi[kd], qa_lo[kd], b_hi, b_lo);
      }
    }
    if (chunk == n_chunks - 1) {
      // Mask, then the online softmax on the fragments: c0, c1 are row r0 at
      // keys 8n + 2t, 8n + 2t + 1; c2, c3 are row r1 at the same keys.
      float valid[kTileN / 8][2];
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < kTileN / 8; ++n) {
        valid[n][0] = vl[n * 8 + 2 * t];
        valid[n][1] = vl[n * 8 + 2 * t + 1];
        if (valid[n][0] == 0.f) s_acc[n][0] = s_acc[n][2] = kNegInf;
        if (valid[n][1] == 0.f) s_acc[n][1] = s_acc[n][3] = kNegInf;
        mx0 = fmaxf(mx0, fmaxf(s_acc[n][0], s_acc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s_acc[n][2], s_acc[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the row's 4 lanes
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float alpha0 = expf(m0 - mn0);
      const float alpha1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        o_acc[kd][0] *= alpha0;
        o_acc[kd][1] *= alpha0;
        o_acc[kd][2] *= alpha1;
        o_acc[kd][3] *= alpha1;
      }
#pragma unroll
      for (int n = 0; n < kTileN / 8; ++n) {
        // The mask factor keeps masked keys at exactly 0, even where every
        // score of the row is kNegInf (there exp(s - m) = 1).
        s_acc[n][0] = expf(s_acc[n][0] - mn0) * valid[n][0];
        s_acc[n][1] = expf(s_acc[n][1] - mn0) * valid[n][1];
        s_acc[n][2] = expf(s_acc[n][2] - mn1) * valid[n][0];
        s_acc[n][3] = expf(s_acc[n][3] - mn1) * valid[n][1];
        l0 += s_acc[n][0] + s_acc[n][1];
        l1 += s_acc[n][2] + s_acc[n][3];
      }

      // O += P V, 8 keys per step in the order (0, 2, 4, 6, 1, 3, 5, 7): the
      // C fragment of P is the A fragment as it stands.
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        uint32_t a_hi[4], a_lo[4];
        split_tf32(s_acc[j][0], a_hi[0], a_lo[0]);  // (g, col t = key 2t)
        split_tf32(s_acc[j][2], a_hi[1], a_lo[1]);  // (g + 8, key 2t)
        split_tf32(s_acc[j][1], a_hi[2], a_lo[2]);  // (g, col t+4 = key 2t+1)
        split_tf32(s_acc[j][3], a_hi[3], a_lo[3]);  // (g + 8, key 2t+1)
        const float* v0 = vt + (j * 8 + 2 * t) * kStride;  // b0: k = t
        const float* v1 = v0 + kStride;                    // b1: k = t + 4
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t b_hi[2], b_lo[2];
          split_tf32(v0[kd * 8 + g], b_hi[0], b_lo[0]);
          split_tf32(v1[kd * 8 + g], b_hi[1], b_lo[1]);
          mma_3xtf32(o_acc[kd], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }  // the step's last phase

    if (more) valid_s[(stage ^ 1) * kStepN + tid] = next_valid;
    __syncthreads();  // this stage is free for the load two steps on
  }

  // Merge the pairs: pair 1 leaves its state in shared memory (the tiles are
  // done with), lane by lane; pair 0 reads the same fragment positions. With
  // one pair the other state is empty: m = -1e9, l = 0, o = 0.
  constexpr int kState = 4 + 4 * KD;  // m0, m1, l0, l1, o
  float other[kState];
#pragma unroll
  for (int i = 0; i < kState; ++i) other[i] = i < 2 ? kNegInf : 0.f;
  if constexpr (PAIRS == 2) {
    float* state = smem + (row_warp * 32 + lane) * kState;
    __syncthreads();  // with S = 0 the loop's barriers never ran
    if (pair == 1) {
      state[0] = m0;
      state[1] = m1;
      state[2] = l0;
      state[3] = l1;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          state[4 + kd * 4 + i] = o_acc[kd][i];
    }
    __syncthreads();
    if (pair == 1) return;
#pragma unroll
    for (int i = 0; i < kState; ++i) other[i] = state[i];
  }
  const float m0_all = fmaxf(m0, other[0]);
  const float m1_all = fmaxf(m1, other[1]);
  const float sa0 = expf(m0 - m0_all), sb0 = expf(other[0] - m0_all);
  const float sa1 = expf(m1 - m1_all), sb1 = expf(other[1] - m1_all);
  l0 = l0 * sa0 + other[2] * sb0;
  l1 = l1 * sa1 + other[3] * sb1;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float safe_l0 = l0 > 0.f ? l0 : 1.f;
  const float safe_l1 = l1 > 0.f ? l1 : 1.f;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const float* ob = other + 4 + kd * 4;
    const float o[4] = {
        o_acc[kd][0] * sa0 + ob[0] * sb0,
        o_acc[kd][1] * sa0 + ob[1] * sb0,
        o_acc[kd][2] * sa1 + ob[2] * sb1,
        o_acc[kd][3] * sa1 + ob[3] * sb1,
    };
    const int c = kd * 8 + 2 * t;  // o[0]/o[2] at column c, o[1]/o[3] at c + 1
    float* o0 = o_bh + r0 * p.o_sl + col0;
    float* o1 = o_bh + r1 * p.o_sl + col0;
    if (r0 < L) {
      if (c < Dv) o0[c] = o[0] / safe_l0;
      if (c + 1 < Dv) o0[c + 1] = o[1] / safe_l0;
    }
    if (r1 < L) {
      if (c < Dv) o1[c] = o[2] / safe_l1;
      if (c + 1 < Dv) o1[c + 1] = o[3] / safe_l1;
    }
  }
}

template <int DP, int PAIRS, bool kChunked>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DP, PAIRS>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tile_kernel<DP, PAIRS, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  flash_tile_kernel<DP, PAIRS, kChunked>
      <<<grid, 32 * kRowWarps * PAIRS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, bool kChunked = false>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.L + kBlockM - 1) / kBlockM, B * p.H,
                  kChunked ? (p.D + DP - 1) / DP : 1);
  // A second pair of warps where the SMs would get fewer than two blocks
  // each and there is a second tile of keys for it.
  if constexpr (DP <= 64) {
    if ((int64_t)grid.x * grid.y < 2 * sms && p.S > kTileN)
      return launch<DP, 2, false>(p, grid, stream);
  }
  return launch<DP, 1, kChunked>(p, grid, stream);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns the launch's CUDA error (0 = success). mask may be null (every key
// valid), else a contiguous (B, S) uint8. Strides are in elements.
extern "C" int flash_attention_tile_fwd(
    const float* q, const float* k, const float* v, const uint8_t* mask,
    float* o, int B, int H, int L, int S, int D, int64_t q_sb, int64_t q_sh,
    int64_t q_sl, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_sl,
    void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || S < 0 || D <= 0 ||
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
  return (int)err;
}
