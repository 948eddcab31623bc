// Visibility pass of the tiled rasterizer (phase B) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_visibility_kernel` in
// megapose6d_tpu/ops/rasterizer_tiled.py. Phase A (torch) packs, per image,
// one row of 32 floats per face: 3 edge planes, the 1/z plane and 6
// attribute/z planes (rgb, object normal), each as (a, b, c) with
// value = a*u + b*v + c; and, per screen tile, the list of face chunks whose
// faces overlap the tile, sorted front to back. For each pixel this kernel
// walks those chunks, takes each chunk's nearest covering face (largest 1/z;
// on equal 1/z the largest face id), replaces the pixel's z-buffer only on
// a strictly larger 1/z, and then evaluates the winner's 6 attribute planes.
//
// What bounds it: bytes. Every pixel writes 32 bytes (1/z, face id and 6
// attributes), covered or not; at the coarse sweep's shape (576 images of
// 240x320, 1536 faces) that is 1.42 GB of the 1.56 GB moved, 0.47 ms at
// 3.35 TB/s, against ~0.35 ms for the plane evaluations at the f32 rate
// outside the tensor cores (4 planes of 2 multiplies and 2 adds per
// (pixel, face) of the active chunks).
//
// The simple design: one block per (image, 16x32 tile), one thread per
// pixel, and each thread writes its outputs once, coalesced along a row.
// The block stages each active chunk's coefficients (chunk x 32 floats) in
// shared memory; every thread then reads the same row at the same time
// (a broadcast). A thread keeps its own 1/z, face id and 6 attributes in
// registers: on a win it evaluates the winner's attribute planes from the
// staged row directly, which is the per-thread gather that the TPU kernel
// avoided with a masked max over the chunk. While staging, each plane's
// constant is rebased (c + a*col0 + b*row0) to the origin of the 32x128
// cell of the TPU kernel's tiling that holds the block, so f32 evaluation
// stays accurate and each pixel sees exactly the arithmetic of the TPU
// kernel. Every multiply and add is rounded separately
// (__fmul_rn/__fadd_rn: no fused multiply-add), so the kernel also
// reproduces the plain torch version bit for bit. Any face count and any
// batch run in one launch; nothing is segmented. Writing only covered
// pixels would lower the bound; that waits for a faster design.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCoefW = 32;
constexpr int kNAttr = 6;
constexpr int kNPlanes = 10;  // 3 edges, 1/z, 6 attributes
constexpr int kTileH = 16;  // one block per tile, one thread per pixel
constexpr int kTileW = 32;
constexpr int kRebaseH = 32;  // the TPU kernel's tile: planes are rebased
constexpr int kRebaseW = 128;  // to the origin of the cell holding a pixel
static_assert(kRebaseH % kTileH == 0 && kRebaseW % kTileW == 0,
              "a block must lie in one rebasing cell");

// a*u + b*v + c of plane k of a staged (rebased) row, at local (u, v).
__device__ __forceinline__ float plane(const float* row, int k, float pu,
                                       float pv) {
  return __fadd_rn(__fadd_rn(__fmul_rn(row[3 * k], pu),
                             __fmul_rn(row[3 * k + 1], pv)),
                   row[3 * k + 2]);
}

__global__ void visibility_kernel(const float* __restrict__ coefs,
                                  const int* __restrict__ chunk_ids,
                                  const int* __restrict__ n_active,
                                  float* __restrict__ invz_out,
                                  int* __restrict__ fid_out,
                                  float* __restrict__ attr_out, int F, int T,
                                  int n_chunks, int H, int W, int n_tw,
                                  int chunk) {
  extern __shared__ float s_coef[];  // [chunk, kCoefW]
  const int b = blockIdx.x / T;
  const int t = blockIdx.x % T;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int n_threads = kTileH * kTileW;
  const int row0 = (t / n_tw) * kTileH;  // the block's pixel origin
  const int col0 = (t % n_tw) * kTileW;
  const int reb_row0 = row0 / kRebaseH * kRebaseH;  // its 32x128 cell
  const int reb_col0 = col0 / kRebaseW * kRebaseW;
  const float frow0 = static_cast<float>(reb_row0);
  const float fcol0 = static_cast<float>(reb_col0);
  const float pu = static_cast<float>(col0 - reb_col0 + threadIdx.x);
  const float pv = static_cast<float>(row0 - reb_row0 + threadIdx.y);

  float best = -CUDART_INF_F;
  int best_fid = -1;
  float attr[kNAttr] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  const long long bt = static_cast<long long>(b) * T + t;
  const int na = n_active[bt];
  const int* ids = chunk_ids + bt * n_chunks;
  const float* img_coefs = coefs + static_cast<long long>(b) * F * kCoefW;
  const int chunk_floats = chunk * kCoefW;

  for (int i = 0; i < na; ++i) {
    const int ci = ids[i];
    const float* src = img_coefs + static_cast<long long>(ci) * chunk_floats;
    __syncthreads();  // the previous chunk is no longer read
    for (int k = tid; k < chunk_floats; k += n_threads) s_coef[k] = src[k];
    __syncthreads();
    for (int k = tid; k < chunk * kNPlanes; k += n_threads) {
      float* p = s_coef + (k / kNPlanes) * kCoefW + 3 * (k % kNPlanes);
      p[2] = __fadd_rn(__fadd_rn(p[2], __fmul_rn(p[0], fcol0)),
                       __fmul_rn(p[1], frow0));
    }
    __syncthreads();

    float c_best = -CUDART_INF_F;
    int c_j = 0;
    bool nan_seen = false;
    for (int j = 0; j < chunk; ++j) {
      const float* row = s_coef + j * kCoefW;
      const float e0 = plane(row, 0, pu, pv);
      const float e1 = plane(row, 1, pu, pv);
      const float e2 = plane(row, 2, pu, pv);
      const float iz = plane(row, 3, pu, pv);
      const bool inside = (e0 >= 0.f) && (e1 >= 0.f) && (e2 >= 0.f);
      const float cand = inside ? iz : -CUDART_INF_F;
      if (cand != cand) nan_seen = true;  // a NaN max voids the chunk
      if (cand >= c_best) {  // ascending j: ties go to the largest id
        c_best = cand;
        c_j = j;
      }
    }
    if (!nan_seen && c_best > best) {  // strict: earlier chunks win ties
      best = c_best;
      best_fid = ci * chunk + c_j;
      const float* row = s_coef + c_j * kCoefW;
#pragma unroll
      for (int k = 0; k < kNAttr; ++k)
        attr[k] = plane(row, 4 + k, pu, pv);
    }
  }

  const int y = row0 + threadIdx.y;
  const int x = col0 + threadIdx.x;
  if (y < H && x < W) {
    const long long p = (static_cast<long long>(b) * H + y) * W + x;
    invz_out[p] = best;
    fid_out[p] = best_fid;
#pragma unroll
    for (int k = 0; k < kNAttr; ++k) attr_out[p * kNAttr + k] = attr[k];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// coefs [B, F, 32] f32, chunk_ids [B, T, n_chunks] i32, n_active [B, T] i32,
// T the row-major 16x32 tiles of H x W;
// outputs invz [B, H, W] f32, fid [B, H, W] i32, attr [B, H, W, 6] f32.
extern "C" int visibility_launch(const float* coefs, const int* chunk_ids,
                                 const int* n_active, float* invz, int* fid,
                                 float* attr, int B, int F, int T,
                                 int n_chunks, int H, int W, int chunk,
                                 void* stream) {
  const int n_tw = (W + kTileW - 1) / kTileW;
  const long long n_blocks = static_cast<long long>(B) * T;
  if (n_blocks <= 0 || n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(chunk) * kCoefW * sizeof(float);
  visibility_kernel<<<static_cast<unsigned>(n_blocks), dim3(kTileW, kTileH),
                      smem, static_cast<cudaStream_t>(stream)>>>(
      coefs, chunk_ids, n_active, invz, fid, attr, F, T, n_chunks, H, W, n_tw,
      chunk);
  return static_cast<int>(cudaGetLastError());
}
