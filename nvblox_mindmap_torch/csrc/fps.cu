// Feature-space farthest point sampling on Hopper (sm_90a): all K - 1
// serial picks of every row in one launch, each row's points kept on chip
// across the picks. fp32, plain C entry point.
//
// Replaces no TPU kernel: the JAX package's FPS (nvblox_mindmap_tpu/ops/
// fps.py, farthest_point_sampling) is a lax.scan that XLA compiles. It was
// added because the port's eager loop measured 38% of a B = 32 train step's
// device time (~79 ms) and a quarter of a goal's device-idle time (PERF.md):
// each pick ran ~7 launches over the whole (B, N, C) tensor, two of them
// writing (B, N, C) temporaries, to produce one index per row.
//
// Function: the eager loop of ops/fps.py, bit for bit. Pick 0 is start; pick
// i + 1 is the first index of the largest running distance after pick i
// folded in: dist(n) = min(dist(n), sum_c (p[n][c] - p[pick][c])^2), starting
// at +inf. torch.minimum lets NaN through and torch.argmax ranks NaN above
// every number, then larger, then the lower index; rank_key does the same.
// Exact ties do occur (the encoder zeroes invalid tokens), so the distances
// have to be the eager loop's to the bit, and the picks then are too. The
// difference and the square each round on their own (__fsub_rn, __fmul_rn:
// two ATen kernels, no FMA between them), and the sum over c follows ATen's
// CUDA reduction of a contiguous last dim (ATen/native/cuda/Reduce.cuh,
// ReduceOp with vt0 = 4): LANES lanes (the wrapper computes ATen's block
// width, at most 32) each sum elements l, l + LANES, ... into four
// accumulators in turn (thread_reduce_impl), or for C >= 128 float4 vectors
// l, l + LANES, ... into one accumulator per component after an unaligned
// head and before a tail (input_vectorized_thread_reduce_impl); a lane
// combines its accumulators ((a0 + a1) + a2) + a3, and the lanes fold by
// shfl_down at offsets LANES / 2, ..., 1 (block_x_reduce). Here one thread
// evaluates that whole tree for its point: lane_tree spells out the shuffle
// tree over compile-time lanes. Below C = 128 a lane holds at most four
// elements, so the tree is straight-line code (slot_sum).
//
// What bounds it on this card. A pick is 3 * N * C flops per row (sub, mul,
// add) over data that does not change, then an argmax over N that the next
// pick waits for: K - 1 dependent steps. At the benchmark's training shape
// (B = 32, N = 3072, C = 120, K = 614) that is 21.7 GFLOP, 0.32 ms at the
// 67 TFLOP/s fp32 peak; the bytes, read once, are 0.014 ms at 3.35 TB/s.
// What a pick really costs is its latency: the reads of the points from
// shared memory, then the argmax across the row's blocks, a cluster barrier
// that the next pick waits for (~2 us a pick even at C = 8).
//
// Design. One thread block cluster per row, all B rows in one launch: up
// to 8 blocks (one per 128 points), or up to 16 where 8 cannot hold the row
// (above 8 a cluster is non-portable, which the H100 allows); clusters
// beyond what the card holds at once (14 of 8 blocks of ~190 KB on the
// H100) run in later waves; the wrapper picks the shape (ops/fps.py). The
// row's N points are cut into one contiguous slice per block, and a block
// keeps its slice in shared memory for all K picks, transposed to
// [c][point] (an odd row stride: the transposing stores and the per-point
// loads are free of bank conflicts), beside each point's running distance.
// Where a slice does not fit (N * C above ~16 x 227 KB), its last points are
// read from global memory (L2) at every pick instead. A thread owns points
// tid, tid + blockDim.x, ... of its block. Each pick: (1) each thread folds
// the previous pick into its points and keeps its best (key, index); (2)
// redux.sync over the warp, then over the warps, gives every thread the
// block's best; (3) the block stores that candidate, its (key, index) and
// its coordinates (in the order the sum reads them, for float4 loads), into
// every block of the cluster (distributed shared memory, double-buffered by
// pick parity); (4) one cluster barrier, after which every block takes the
// winner from its own shared memory, with no remote load on the chain.
// Only the K indices (and the final running distances, where the caller
// asks for them) leave the chip.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;  // 8 is portable; the H100 takes 16 once a kernel opts in
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* points;  // (B, N, C), contiguous
  int64_t* out;         // (B, K) picks
  float* dist;          // (B, N) running distances after the last fold, or null
  int N, C, K, start;
  int per_block;  // points of a row per block: block r holds [r, r + 1) * per_block
  int resident;   // the first `resident` of them live in shared memory
  int stride;     // shared-memory row stride of one coordinate (odd, >= resident)
};

// A running distance's rank as torch.argmax ranks it: distances are >= +0
// or NaN, so their bits (plus one: key 0 ranks below every distance) order
// them, and every NaN ranks above all numbers and ties with the other NaNs.
__device__ __forceinline__ unsigned rank_key(float v) {
  return isnan(v) ? 0xffffffffu : __float_as_uint(v) + 1u;
}

// A candidate pick: the largest key wins, then the lowest index.
struct Best {
  unsigned key, idx;
};

__device__ __forceinline__ Best nothing() { return Best{0u, 0xffffffffu}; }

// The best of a warp's candidates, in every lane.
__device__ __forceinline__ Best warp_best(Best b) {
  const unsigned top = __reduce_max_sync(kFull, b.key);
  return Best{top, __reduce_min_sync(kFull, b.key == top ? b.idx : 0xffffffffu)};
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// (p - s)^2, the two rounded apart as two eager kernels round them.
__device__ __forceinline__ float square(float p, float s) {
  const float d = __fsub_rn(p, s);
  return __fmul_rn(d, d);
}

// Lane l's part of ATen's sum read as float4 (input_vectorized_thread_
// reduce_impl): the row starts `shift` elements past a 16-byte boundary;
// lanes shift..3 take the head's elements, then vectors l, l + LANES, ...
// of the aligned rest go one component per accumulator, and lane l takes
// element l of the last, partial vector.
template <int LANES, typename X>
__device__ __forceinline__ float lane_sum_vec(int l, int C, int shift, X x) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int base = 0;
  if (shift > 0) {
    if (l >= shift && l < 4) a0 = add(a0, x(l - shift));
    base = 4 - shift;
  }
  const int end = C - base;
  for (int v = 4 * l; v + 3 < end; v += 4 * LANES) {
    a0 = add(a0, x(base + v));
    a1 = add(a1, x(base + v + 1));
    a2 = add(a2, x(base + v + 2));
    a3 = add(a3, x(base + v + 3));
  }
  const int tail = end - end % 4 + l;
  if (tail < end) a0 = add(a0, x(base + tail));
  return add(add(add(a0, a1), a2), a3);
}

// block_x_reduce's shuffle tree: lane l ends with the sum of lanes
// l, l + S, l + 2S, ... (S = 1 gives lane 0's, the result); each level adds
// the lane S above.
template <int LANES, int S, typename Leaf>
__device__ __forceinline__ float lane_tree(int l, Leaf leaf) {
  if constexpr (S >= LANES) {
    return leaf(l);
  } else {
    const float lo = lane_tree<LANES, 2 * S>(l, leaf);
    return add(lo, lane_tree<LANES, 2 * S>(l + S, leaf));
  }
}

// sum_c x(c) in ATen's order where every lane holds at most four elements
// (C <= 4 * LANES: ATen reads scalars), one per accumulator: lane l's sum
// is ((x(l) + x(l + L)) + x(l + 2L)) + x(l + 3L), an absent element adding
// nothing, as ATen's untouched accumulator adds an exact 0. sel4[l] holds
// the pick's coordinates l, l + L, l + 2L, l + 3L; pt(c) reads the point's.
// Straight-line code: every load can be in flight at once.
template <int LANES, typename P>
__device__ __forceinline__ float slot_sum(int C, const float4* sel4, P pt) {
  return lane_tree<LANES, 1>(0, [&](int l) {
    const float4 s = sel4[l];
    const float x0 = square(pt(l), s.x);
    const float x1 = l + LANES < C ? square(pt(l + LANES), s.y) : 0.f;
    const float x2 = l + 2 * LANES < C ? square(pt(l + 2 * LANES), s.z) : 0.f;
    const float x3 = l + 3 * LANES < C ? square(pt(l + 3 * LANES), s.w) : 0.f;
    return add(add(add(x0, x1), x2), x3);
  });
}

// The length of a pick's vector in shared memory: the coordinates in
// slot_sum's order (4 * LANES, zero-padded), or in their own order for
// ATen's float4 reads.
__host__ __device__ constexpr int sel_floats(int lanes, bool vec, int C) {
  return vec ? (C + 3) / 4 * 4 : 4 * lanes;
}

// Coordinate c of vector slot t (slot_sum's order, or the identity).
template <int LANES, bool VEC>
__device__ __forceinline__ int slot_coord(int t) {
  return VEC ? t : t / 4 + (t % 4) * LANES;
}

// VEC: ATen reads float4 (C >= 128); else C <= 4 * LANES.
template <int LANES, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1) fps_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_blocks = (int)cluster.num_blocks();
  const int N = p.N, C = p.C;
  const int n_sel = sel_floats(LANES, VEC, C);
  // cand_s[parity][r] holds block r's best point of a pick, its coordinates
  // in slot order, and slot_s[parity][r] its (key, index): block r stores
  // both into every block of the cluster.
  float* cand_s = reinterpret_cast<float*>(smem4);            // [2][n_blocks][n_sel]
  float* pts_s = cand_s + 2 * n_blocks * n_sel;               // [C][stride]
  float* dist_s = pts_s + (size_t)C * p.stride;               // [per_block]
  Best* warp_s = reinterpret_cast<Best*>(dist_s + p.per_block);  // [kMaxWarps]
  Best* slot_s = warp_s + kMaxWarps;                          // [2][n_blocks]

  const int b = blockIdx.x / n_blocks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int first = rank * p.per_block;
  const int count = max(0, min(p.per_block, N - first));
  const int resident = min(count, p.resident);
  const float* row = p.points + (int64_t)b * N * C;

  const float* slice = row + (int64_t)first * C;
  for (int e = tid; e < resident * C; e += blockDim.x) {
    const int j = e / C;
    pts_s[(e - j * C) * p.stride + j] = slice[e];
  }
  for (int j = tid; j < count; j += blockDim.x) dist_s[j] = INFINITY;
  // Pick 0's vector, where pick 1 reads it: cand_s[0][0].
  for (int t = tid; t < n_sel; t += blockDim.x) {
    const int c = slot_coord<LANES, VEC>(t);
    cand_s[t] = c < C ? row[(int64_t)p.start * C + c] : 0.f;
  }
  if (rank == 0 && tid == 0) p.out[(int64_t)b * p.K] = p.start;
  cluster.sync();  // every block's memory is in place before any block writes to it

  const float* sel = cand_s;
  for (int i = 1; i < p.K; ++i) {
    // (1) fold the previous pick into this thread's points
    Best best = nothing();
    for (int j = tid; j < count; j += blockDim.x) {
      const int n = first + j;
      float d;
      if constexpr (VEC) {
        // The row's offset in ATen's (B, N, C) temporary, in elements mod 4.
        const int shift = (int)((((int64_t)b * N + n) * C) & 3);
        auto sum = [&](auto pt) {
          return lane_tree<LANES, 1>(0, [&](int l) {
            return lane_sum_vec<LANES>(l, C, shift, [&](int c) { return square(pt(c), sel[c]); });
          });
        };
        if (j < resident) {
          const float* q = pts_s + j;
          d = sum([&](int c) { return q[(size_t)c * p.stride]; });
        } else {
          const float* q = row + (int64_t)n * C;
          d = sum([&](int c) { return __ldg(q + c); });
        }
      } else {
        const float4* sel4 = reinterpret_cast<const float4*>(sel);
        if (j < resident) {
          const float* q = pts_s + j;
          d = slot_sum<LANES>(C, sel4, [&](int c) { return q[c * p.stride]; });
        } else {
          const float* q = row + (int64_t)n * C;
          d = slot_sum<LANES>(C, sel4, [&](int c) { return __ldg(q + c); });
        }
      }
      float m = dist_s[j];
      if (d < m || isnan(d)) m = d;  // torch.minimum
      dist_s[j] = m;
      const unsigned key = rank_key(m);
      if (key > best.key) best = Best{key, (unsigned)n};  // n rises: ties keep the first
    }

    // (2) the block's best, in every thread
    best = warp_best(best);
    if (lane == 0) warp_s[warp] = best;
    __syncthreads();
    best = warp_best(lane < n_warps ? warp_s[lane] : nothing());

    // (3) store it, vector and all, into every block of the cluster. The
    // halves alternate: a block stores into half i & 1 again at pick i + 2,
    // after every block has passed the barrier of pick i + 1 and so has
    // done reading that half.
    const int par = i & 1;
    const int jb = (int)best.idx - first;
    for (int t = tid; t < n_sel; t += blockDim.x) {
      const int c = slot_coord<LANES, VEC>(t);
      const float v = c >= C ? 0.f
                      : jb < resident ? pts_s[(size_t)c * p.stride + jb]
                                      : row[(int64_t)best.idx * C + c];
      for (int r = 0; r < n_blocks; ++r)
        cluster.map_shared_rank(cand_s, r)[(par * n_blocks + rank) * n_sel + t] = v;
    }
    if (tid < n_blocks) *cluster.map_shared_rank(slot_s + par * n_blocks + rank, tid) = best;
    cluster.sync();

    // (4) the cluster's best, from this block's own memory
    best = warp_best(lane < n_blocks ? slot_s[par * n_blocks + lane] : nothing());
    sel = cand_s + (par * n_blocks + (int)best.idx / p.per_block) * n_sel;
    if (rank == 0 && tid == 0) p.out[(int64_t)b * p.K + i] = best.idx;
  }

  if (p.dist != nullptr)
    for (int j = tid; j < count; j += blockDim.x) p.dist[(int64_t)b * N + first + j] = dist_s[j];
}

template <int LANES, bool VEC = false>
cudaError_t launch(const Params& p, int B, int cluster, int threads, int smem,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<LANES, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fps_kernel<LANES, VEC>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fps_kernel<LANES, VEC>, p);
}

}  // namespace

// Returns the launch's CUDA error (0 = success). points (B, N, C) fp32 and
// out (B, K) int64 and dist (B, N) fp32 (null: not stored) are contiguous;
// lanes, vec and the launch shape come from the wrapper (ops/fps.py:
// launch_params).
extern "C" int farthest_point_sampling_fwd(
    const float* points, int64_t* out, float* dist, int B, int N, int C, int K,
    int start, int lanes, int vec, int cluster, int threads, int per_block,
    int resident, int stride, int smem, void* stream) {
  const size_t need =
      sizeof(float) * ((size_t)2 * cluster * sel_floats(lanes, vec, C) + (size_t)C * stride +
                       per_block) +
      sizeof(Best) * (kMaxWarps + 2 * cluster);
  if (B <= 0 || N <= 0 || C <= 0 || K <= 0 || K > N || start < 0 || start >= N ||
      cluster < 1 || cluster > kMaxCluster || (int64_t)B * cluster > INT_MAX ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (int64_t)per_block * cluster < N || (int64_t)per_block * (cluster - 1) >= N || resident < 0 || resident > per_block ||
      stride < resident || smem > kMaxSmem || need > (size_t)smem ||
      (K > 1 && (vec ? lanes != 32 : C > 4 * lanes)))
    return (int)cudaErrorInvalidValue;
  const Params p{points, out, dist, N, C, K, start, per_block, resident, stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (lanes) {
    case 1: err = launch<1>(p, B, cluster, threads, smem, st); break;
    case 2: err = launch<2>(p, B, cluster, threads, smem, st); break;
    case 4: err = launch<4>(p, B, cluster, threads, smem, st); break;
    case 8: err = launch<8>(p, B, cluster, threads, smem, st); break;
    case 16: err = launch<16>(p, B, cluster, threads, smem, st); break;
    case 32:
      err = vec ? launch<32, true>(p, B, cluster, threads, smem, st)
                : launch<32>(p, B, cluster, threads, smem, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
