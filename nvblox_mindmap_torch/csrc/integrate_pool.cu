// The weighted-average update of a block-paged pool from one image, on Hopper
// (sm_90a): one launch over the pool's pages, one thread block a page. fp16
// pool, fp32 weights, an fp16, bf16 or fp32 image; plain C entry point.
//
// Replaces no TPU kernel: the JAX package's update (nvblox_mindmap_tpu/
// mapping/voxel_grid.py, _integrate_pool) is XLA ops over the whole pool. It
// was added because the port's eager version (mapping/voxel_grid.py,
// _integrate_pool_reference) ran ~75 ops over all P pages x 512 voxels x C
// channels, live or free, observed or not, with fp32 temporaries of P * 512 * C
// floats (1.6 GB at 1024 pages and C = 768): 13 ms a camera frame on the H100,
// about a third of a closed-loop step (PERF.md).
//
// Function: the eager version, bit for bit. A voxel of a live page is measured
// (ok) where its centre projects into the image, its depth lies in (min_z,
// max_z), the mask (if any) is set at its nearest pixel, and its TSDF is near
// the surface (|tsdf| < near_tsdf) and observed (weight > 0). Then w_meas = ok
// ? the measurement weight : 0, w_new = w_old + w_meas, and where w_new > 0 the
// pool row becomes fp16((f32(row) * w_old + f32(pixel row) * w_meas) / w_new),
// read at the nearest pixel (clamped into the image); elsewhere it is kept.
//
// Roundings. Each eager op is an ATen kernel of its own, so each rounds on its
// own; nvcc's -O3 would contract a * b + c into an FMA, so every step here is
// an explicit __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn:
// - the voxel centre: origin + (float(coord) + 0.5) * voxel, with origin and
//   voxel rounded to fp32 once (torch.tensor(..., float32); a Python float
//   times an fp32 tensor computes at fp32), in that order;
// - _project: d = p - t; p_c[k] = (d0 * R[0][k] + d1 * R[1][k]) + d2 * R[2][k];
//   z = p_c[2], or 1e-6f where |z| < 1e-6f; u = (K00 * p_c0) / z + K02 (a
//   tensor divisor: ATen divides, it does not multiply by a reciprocal);
// - torch.round is rintf (half to even); the clamp into [0, W - 1] comes before
//   the cast and lets NaN through, as ATen's clamp does (both casts give 0);
// - every comparison takes its Python constant rounded to fp32, as ATen casts
//   a scalar to the tensor's type: the wrapper rounds them once;
// - the average: f32(row) * w_old, plus f32(pixel) * w_meas, over w_new, then
//   __float2half_rn (ATen's float -> half rounds to nearest even).
//
// Which rows are written. A free page (page_to_block < 0) exits at once: its
// weights are zero (allocate_pages zeroes them when it frees the page) and stay
// zero, so the eager update keeps its rows and weights. On a live page every
// voxel's weight is written, and every voxel with w_new > 0 has its row
// rewritten by the formula above, measured or not: with w_meas = 0 the formula
// gives back the old value, except where that is -0 or the pixel is not finite,
// and computing it keeps even those cases equal.
//
// What bounds it on this card: bytes. Each rewritten row reads its pool row and
// one image row and writes the pool row (1.5 KB each at C = 768 in fp16); each
// live voxel reads its TSDF, weight and pool weight and writes the pool weight.
// The eager version moved all P * 512 rows and their fp32 temporaries whatever
// the map held. Design: (1) the threads of a page's block take its voxels,
// project and test them, write their weights, and list the rows to rewrite
// (slot, pixel, weights) in shared memory; (2) the block moves the listed rows:
// from C = 64 on (a multiple of 8, rows 16-byte aligned) a group of 8, 16 or 32
// lanes a row, 8 channels a lane per 16-byte load (two for an fp32 image);
// narrower rows a thread each. The wrapper picks the group (ops/integrate_pool.py:
// launch_params).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 512;  // voxels of a page: block_size^3

struct Params {
  __half* pool;              // (P, slots, C)
  float* pool_weight;        // (P, slots)
  const int* page_to_block;  // (P,) flat block index, -1 = free
  const float* tsdf;         // (X, Y, Z)
  const float* weight;       // (X, Y, Z)
  const void* image;         // (H, W, C)
  const float* T;            // (4, 4) camera to world
  const float* K;            // (3, 3)
  const uint8_t* mask;       // (H, W) bool, or null
  int C, H, W, Y, Z, BY, BZ, blocks, b, slots;
  float origin[3], voxel, near_tsdf, min_z, max_z, w_meas;
};

// A row to rewrite.
struct Entry {
  int slot, pix;
  float w_old, w_meas;
};

__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// ATen's clamp(x, lo, hi): NaN passes.
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ __half average(__half old, float value, float w_old, float w_meas,
                                          float w_new) {
  const float acc = __fadd_rn(__fmul_rn(__half2float(old), w_old), __fmul_rn(value, w_meas));
  return __float2half_rn(__fdiv_rn(acc, w_new));
}

// Eight channels of an image row, from one 16-byte load (two for fp32).
__device__ __forceinline__ void load8(const __half* src, float out[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __half* h = reinterpret_cast<const __half*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __half2float(h[j]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float out[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void load8(const float* src, float out[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// LANES lanes a listed row, 8 channels a lane per load; LANES = 1: a thread
// a row, a channel at a time.
template <typename Img, int LANES>
__global__ void __launch_bounds__(kThreads) integrate_pool_kernel(const Params p) {
  const int page = blockIdx.x;
  const int block = p.page_to_block[page];
  // A free page is kept; a block index off the grid (no state the mapper
  // makes holds one) is treated as free instead of read out of bounds.
  if (block < 0 || block >= p.blocks) return;

  __shared__ Entry list[kMaxSlots];
  __shared__ int listed;
  if (threadIdx.x == 0) listed = 0;
  __syncthreads();

  const float* T = p.T;
  const float t[3] = {T[3], T[7], T[11]};
  const float fx = p.K[0], cx = p.K[2], fy = p.K[4], cy = p.K[5];
  const float right = (float)(p.W - 1), bottom = (float)(p.H - 1);
  const int b = p.b;
  const int base[3] = {block / (p.BY * p.BZ) * b, block / p.BZ % p.BY * b, block % p.BZ * b};
  const size_t page_row = (size_t)page * p.slots;

  for (int s = threadIdx.x; s < p.slots; s += kThreads) {
    const int coord[3] = {base[0] + s / (b * b), base[1] + s / b % b, base[2] + s % b};
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float centre =
          __fadd_rn(p.origin[k], __fmul_rn(__fadd_rn((float)coord[k], 0.5f), p.voxel));
      d[k] = __fsub_rn(centre, t[k]);
    }
    float pc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      pc[k] = __fadd_rn(__fadd_rn(__fmul_rn(d[0], T[k]), __fmul_rn(d[1], T[4 + k])),
                        __fmul_rn(d[2], T[8 + k]));
    const float z = pc[2];
    const float safe_z = fabsf(z) < 1e-6f ? 1e-6f : z;
    const float u = __fadd_rn(__fdiv_rn(__fmul_rn(fx, pc[0]), safe_z), cx);
    const float v = __fadd_rn(__fdiv_rn(__fmul_rn(fy, pc[1]), safe_z), cy);
    const int pix = (int)clamp(rintf(v), 0.f, bottom) * p.W + (int)clamp(rintf(u), 0.f, right);

    const size_t vox = ((size_t)coord[0] * p.Y + coord[1]) * p.Z + coord[2];
    bool ok = u >= 0.f && u <= right && v >= 0.f && v <= bottom && z > p.min_z && z < p.max_z &&
              fabsf(p.tsdf[vox]) < p.near_tsdf && p.weight[vox] > 0.f;
    if (ok && p.mask != nullptr) ok = p.mask[pix] != 0;

    const float w_old = p.pool_weight[page_row + s];
    const float w_meas = ok ? p.w_meas : 0.f;
    const float w_new = __fadd_rn(w_old, w_meas);
    p.pool_weight[page_row + s] = w_new;
    if (w_new > 0.f) list[atomicAdd(&listed, 1)] = Entry{s, pix, w_old, w_meas};
  }
  __syncthreads();

  const int n = listed;
  const Img* image = static_cast<const Img*>(p.image);
  if (LANES == 1) {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const Entry en = list[e];
      const float w_new = __fadd_rn(en.w_old, en.w_meas);
      __half* row = p.pool + (page_row + en.slot) * p.C;
      const Img* px = image + (size_t)en.pix * p.C;
      for (int c = 0; c < p.C; ++c)
        row[c] = average(row[c], to_float(px[c]), en.w_old, en.w_meas, w_new);
    }
  } else {
    const int group = threadIdx.x / LANES, lane = threadIdx.x % LANES;
    const int chunks = p.C / 8;
    for (int e = group; e < n; e += kThreads / LANES) {
      const Entry en = list[e];
      const float w_new = __fadd_rn(en.w_old, en.w_meas);
      __half* row = p.pool + (page_row + en.slot) * p.C;
      const Img* px = image + (size_t)en.pix * p.C;
      for (int c = lane; c < chunks; c += LANES) {
        uint4 raw = *reinterpret_cast<const uint4*>(row + 8 * c);
        __half* h = reinterpret_cast<__half*>(&raw);
        float value[8];
        load8(px + 8 * c, value);
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = average(h[j], value[j], en.w_old, en.w_meas, w_new);
        *reinterpret_cast<uint4*>(row + 8 * c) = raw;
      }
    }
  }
}

template <typename Img>
cudaError_t launch(const Params& p, int pages, int lanes, cudaStream_t stream) {
  switch (lanes) {
    case 1: integrate_pool_kernel<Img, 1><<<pages, kThreads, 0, stream>>>(p); break;
    case 8: integrate_pool_kernel<Img, 8><<<pages, kThreads, 0, stream>>>(p); break;
    case 16: integrate_pool_kernel<Img, 16><<<pages, kThreads, 0, stream>>>(p); break;
    case 32: integrate_pool_kernel<Img, 32><<<pages, kThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's CUDA error (0 = success). Every array is contiguous:
// pool (P, slots, C) fp16 and pool_weight (P, slots) fp32, updated in place;
// page_to_block (P,) int32; tsdf and weight (X, Y, Z) fp32; image (H, W, C) of
// image_kind 0 fp16, 1 bf16, 2 fp32; T (4, 4) and K (3, 3) fp32 on the card;
// mask (H, W) bool or null. slots = b^3; the constants are fp32 already; lanes
// comes from the wrapper (ops/integrate_pool.py: launch_params).
extern "C" int integrate_pool_fwd(
    void* pool, float* pool_weight, const int* page_to_block, const float* tsdf,
    const float* weight, const void* image, const float* T, const float* K, const void* mask,
    int P, int slots, int C, int H, int W, int X, int Y, int Z, int b, int image_kind,
    int lanes, float origin_x, float origin_y, float origin_z, float voxel, float near_tsdf,
    float min_z, float max_z, float w_meas, void* stream) {
  if (P < 0 || b < 1 || slots != b * b * b || slots > kMaxSlots || C < 1 || H < 1 || W < 1 ||
      X < b || Y < b || Z < b || X % b != 0 || Y % b != 0 || Z % b != 0 ||
      (int64_t)H * W > INT_MAX || (int64_t)(X / b) * (Y / b) * (Z / b) > INT_MAX ||
      (lanes != 1 && lanes != 8 && lanes != 16 && lanes != 32) || (lanes > 1 && C % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const Params p{static_cast<__half*>(pool), pool_weight, page_to_block, tsdf, weight, image,
                 T, K, static_cast<const uint8_t*>(mask), C, H, W, Y, Z, Y / b, Z / b,
                 (X / b) * (Y / b) * (Z / b), b, slots,
                 {origin_x, origin_y, origin_z}, voxel, near_tsdf, min_z, max_z, w_meas};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (image_kind) {
    case 0: return (int)launch<__half>(p, P, lanes, st);
    case 1: return (int)launch<__nv_bfloat16>(p, P, lanes, st);
    case 2: return (int)launch<float>(p, P, lanes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
