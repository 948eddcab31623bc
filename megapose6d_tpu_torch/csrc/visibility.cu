// Visibility pass of the tiled rasterizer (phase B) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_visibility_kernel` in
// megapose6d_tpu/ops/rasterizer_tiled.py. Phase A (torch) packs, per image,
// one row of 32 floats per face: 3 edge planes, the 1/z plane and 6
// attribute/z planes (rgb, object normal), each as (a, b, c) with
// value = a*u + b*v + c; and, per 16x32 screen tile, the list of face chunks
// (16 faces each) whose faces overlap the tile, sorted front to back. For
// each pixel this kernel walks those chunks, takes each chunk's nearest
// covering face (largest 1/z; on equal 1/z the largest face id), replaces
// the pixel's z-buffer only on a strictly larger 1/z, and then evaluates the
// winner's 6 attribute planes.
//
// The arithmetic is fixed: each plane constant is rebased (c + a*col0 +
// b*row0) to the origin of the 32x128 cell of the TPU kernel's tiling that
// holds the pixel, and every multiply and add is rounded separately
// (__fmul_rn/__fadd_rn: no fused multiply-add), so the kernel reproduces the
// plain torch version `visibility_plain` bit for bit.
//
// The first design (one block of 512 threads per tile, one pixel per thread,
// every face of every active chunk at every pixel) ran at 2.16-2.19 ms at
// the coarse sweep's shape (576 images of 240x320, 1536 faces, 181,347
// active (tile, chunk) pairs) on an H100 80GB HBM3 at 700 W. Its SASS shows
// what held it: not shared-memory loads (its face loop, unrolled by 2, read
// a face's 12 test coefficients with 3 broadcast 16-byte loads: 4.6e7
// warp-faces x 3 = 1.4e8 loads, ~0.6 ms at one per SM and cycle) but
// instruction throughput: 30 instructions per face-pixel over 1.49e9
// face-pixels, 1.4e9 warp instructions, ~1.5 ms at 4 per SM and cycle over
// 132 SMs at ~1.75 GHz. Separately rounded multiplies and adds run one per
// FP32 lane and cycle, half the FMA rate the 67 TFLOP/s peak counts.
//
// This design cuts the face-pixels and the instructions per face-pixel.
// One block of 4 warps per 16x32 tile; warp w owns pixel rows 4w..4w+3 and
// each thread one column of 4 pixels.
// - Per chunk (16 faces, a compile-time constant), the block restages the
//   faces' rebased planes into a 16-byte-aligned shared layout: per face,
//   the a's, b's and c's of the 3 edge planes and the 1/z plane as three
//   float4. A thread reads a face's test planes with 3 broadcast vector
//   loads, forms a*u once for its column, and uses both for its 4 pixels.
//   The next chunk's coefficients are fetched into registers while the
//   current one is evaluated (a register double buffer; cp.async or TMA
//   would add nothing at 2 KB a chunk).
// - Each warp culls, with 3 ballots, the faces that provably cover none of
//   its 4x32 pixels (see `cull_mask`), and loops in ascending face order
//   over the rest only. The loop is warp-uniform. At the coarse shape it
//   leaves 28% of the (face, warp) pairs of the active chunks.
// - A pixel's winning attributes go to shared memory, where its warp's 4
//   rows lie as they lie in the output. 1/z and face ids are stored a row
//   of 32 pixels per warp store; the attributes of a whole tile of an image
//   of even width leave as 6 16-byte stores a lane (elsewhere row by row,
//   8 bytes a lane, masked at the ragged edge of the image). Tiles with no
//   active chunk store the background constants only.
// What bounds it: bytes, by the roofline. Every pixel writes 32 bytes (1/z,
// face id and 6 attributes), covered or not: at the coarse shape 1.42 GB of
// the 1.48 GB it must move, 0.441 ms at 3.35 TB/s; the same tables with no
// active chunk, which only store, take 0.48 ms. The face evaluations that
// the cull leaves (105 instructions a warp for a face at 4 pixels) and the
// chunk loop's latency come on top. Tensor cores do not fit: the product has
// depth 3, and TF32 would change the bits. Writing only covered pixels, or
// fusing phase C, would lower the bound; that waits for a later design.
//
// Small launches (a few images: the refiner, the rescore, VSD, the depth
// refiners, the scene generator) are bound by neither: one block walks its
// tile's whole chain of chunks alone, ~1.1-1.5 us a chunk, so the longest
// tile (40-89 chunks at those shapes) sets the time while most SMs idle.
// There the launch gives each tile a cluster of S blocks (S = 2..16, a
// launch attribute the host picks from the launch's shape), and a tile
// whose chain holds n >= S active chunks splits it: block s walks the
// chunks [s*n/S, (s+1)*n/S) and keeps, per pixel, only the best 1/z and
// its face id. A shorter chain, an empty tile's too, block 0 walks alone
// and the others leave at once: a cluster's blocks wait for each other,
// so a block with nothing to walk would only hold its place. Block 0 of the
// cluster then reads the other blocks' partials from their shared memory
// (distributed shared memory, no global scratch, no second launch), folds
// them in block order with the walk's own rule (a strictly larger 1/z
// replaces, so an earlier chunk keeps a tie), and evaluates the winner's 6
// attribute planes once per pixel from the face's coefficients, rebased as
// the staged planes are: the bits are those of the walk through all the
// chunks. S = 1 is the kernel above. The next chunk's index is loaded one
// chunk ahead of its coefficients, so the loop does not wait on the
// dependent pair of loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCoefW = 32;
constexpr int kNAttr = 6;
constexpr int kNTest = 4;  // 3 edge planes and the 1/z plane
constexpr int kNPlanes = kNTest + kNAttr;
constexpr int kChunk = 16;  // faces per chunk: the only chunk size taken
constexpr int kTileH = 16;  // one block per 16x32 tile
constexpr int kTileW = 32;
constexpr int kRows = 4;  // pixel rows per thread (one column of 4)
constexpr int kWarps = kTileH / kRows;
constexpr int kThreads = 32 * kWarps;
constexpr int kRebaseH = 32;  // the TPU kernel's tile: planes are rebased
constexpr int kRebaseW = 128;  // to the origin of the cell holding a pixel
constexpr int kMaxSplit = 16;  // blocks a tile's chain splits over, at most
constexpr int kPortableSplit = 8;  // larger clusters are non-portable
static_assert(kRebaseH % kTileH == 0 && kRebaseW % kTileW == 0,
              "a block must lie in one rebasing cell");
static_assert(kTileW == 32 && 2 * kChunk == 32,
              "a warp spans a tile row; the cull's ballot holds two "
              "footprint rows of a chunk");
static_assert(2 * kTileH * kTileW <= kTileH * kTileW * kNAttr,
              "a block's partials fit in its attribute staging");

// One chunk's planes, rebased. Plane e of the test planes (e0, e1, e2, 1/z)
// of face j is (a[j][e], b[j][e], c[j][e]); attribute plane k is
// attr[j][k] = (a, b, c, unused).
struct Staged {
  float4 a[kChunk];
  float4 b[kChunk];
  float4 c[kChunk];
  float4 attr[kChunk][kNAttr];
};

__device__ __forceinline__ float lane_of(const float4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// (a*u + b*v) + c with a*u given, rounded as the plain version rounds it.
__device__ __forceinline__ float plane_au(float au, float b, float c,
                                          float v) {
  return __fadd_rn(__fadd_rn(au, __fmul_rn(b, v)), c);
}

// c rebased to the cell origin (col0, row0): (c + a*col0) + b*row0.
__device__ __forceinline__ float rebase(float a, float b, float c,
                                        float col0, float row0) {
  return __fadd_rn(__fadd_rn(c, __fmul_rn(a, col0)), __fmul_rn(b, row0));
}

// Bit j set: face j of the staged chunk covers no pixel of the warp's
// footprint, columns [u_lo, u_hi] x rows [v_lo, v_hi] (rebased local
// coordinates), so skipping it changes no output.
//
// Lane l tests face l % 16 at the footprint's top (l < 16) or bottom row;
// a face is skipped when one of its edge planes, computed exactly as the
// inside test computes it, is below 0 at all 4 corner pixel centres. Why
// that is sound, with no margin: rounding to nearest is monotone, so
// fl(a*u) is monotone in u (a's sign is fixed), fl(b*v) in v, and their
// rounded sum plus c in each, infinities included. At a pixel whose value
// is a number, that value is then at most the value at the corner that
// the signs of a and b pick: an infinity that made the corner NaN would
// make the pixel -inf or NaN too, and inf*0 (a = +-inf at u = 0) happens
// at a corner column as well. So a face below 0 at the 4 corners fails the
// inside test (e >= 0) at every pixel of the warp, and its candidate would
// have been -inf, which neither wins nor ties a finite 1/z nor sets a
// chunk's NaN flag. A corner that computes NaN is not below 0, so a face
// with a NaN edge is kept; the neutral row of invalid faces (edge 0
// constant -1e30, a = b = 0) is always skipped. A bounding-box test would
// not do: a pixel centre lying exactly on an edge is inside.
__device__ __forceinline__ unsigned cull_mask(const Staged& s, int lane,
                                              float u_lo, float u_hi,
                                              float v_lo, float v_hi) {
  const int j = lane & (kChunk - 1);
  const float v_row = lane < kChunk ? v_lo : v_hi;
  const float4 A = s.a[j], B = s.b[j], C = s.c[j];
  unsigned skip = 0;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float a = lane_of(A, e), b = lane_of(B, e), c = lane_of(C, e);
    const float bv = __fmul_rn(b, v_row);
    const float left = __fadd_rn(__fadd_rn(__fmul_rn(a, u_lo), bv), c);
    const float right = __fadd_rn(__fadd_rn(__fmul_rn(a, u_hi), bv), c);
    const unsigned m = __ballot_sync(0xffffffffu, left < 0.f && right < 0.f);
    skip |= m & (m >> kChunk);  // both rows of corners of face j
  }
  return ~skip & ((1u << kChunk) - 1);
}

// kSplit = false: one block per (image, tile), launched plainly. kSplit =
// true: a cluster of `split` blocks per (image, tile), block s of the
// cluster (blockIdx.x % split) walking the s-th part of the tile's chain
// when the chain has `split` chunks or more; a shorter chain (an empty
// tile's too) block 0 walks alone, and the others leave at once (no block
// of such a cluster reads another's shared memory or waits at a cluster
// barrier). It stages the test planes only and evaluates the winners'
// attribute planes once, after the walk.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    visibility_kernel(const float* __restrict__ coefs,
                      const int* __restrict__ chunk_ids,
                      const int* __restrict__ n_active,
                      float* __restrict__ invz_out, int* __restrict__ fid_out,
                      float* __restrict__ attr_out, int F, int T,
                      int n_chunks, int H, int W, int n_tw, int split) {
  constexpr int kStaged = kSplit ? kNTest : kNPlanes;  // planes of a face
  constexpr int kItems = kChunk * kStaged;  // planes staged per chunk
  constexpr int kItemsPerThread = (kItems + kThreads - 1) / kThreads;
  __shared__ Staged s;
  // The winners' attributes of the warp's pixels, row by row as they lie
  // in the output: pixel (r, lane) at s_attr[warp][r][6 * lane + k]. A split
  // block first keeps its partials here (see below).
  __shared__ __align__(16) float s_attr[kWarps][kRows][kTileW * kNAttr];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = kSplit ? static_cast<int>(blockIdx.x % split) : 0;
  const int tile = kSplit ? static_cast<int>(blockIdx.x / split) : blockIdx.x;
  const int img = tile / T;
  const int t = tile % T;
  const int row0 = (t / n_tw) * kTileH;  // the block's pixel origin
  const int col0 = (t % n_tw) * kTileW;
  const int reb_row0 = row0 / kRebaseH * kRebaseH;  // its 32x128 cell
  const int reb_col0 = col0 / kRebaseW * kRebaseW;
  const float frow0 = static_cast<float>(reb_row0);
  const float fcol0 = static_cast<float>(reb_col0);
  // The warp's footprint in local coordinates; the thread's column pu.
  const int u0 = col0 - reb_col0;
  const int v0 = row0 - reb_row0 + warp * kRows;
  const float u_lo = static_cast<float>(u0);
  const float u_hi = static_cast<float>(u0 + kTileW - 1);
  const float v_lo = static_cast<float>(v0);
  const float v_hi = static_cast<float>(v0 + kRows - 1);
  const float pu = static_cast<float>(u0 + lane);
  float pv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) pv[r] = static_cast<float>(v0 + r);

  // This block's part [lo, hi) of the tile's active chunks. Chunk indices
  // are loaded one chunk ahead of the chunk whose planes are fetched.
  const long long bt = static_cast<long long>(img) * T + t;
  const int* ids = chunk_ids + bt * n_chunks;
  const int na = n_active[bt];
  const bool parts = kSplit && na >= split;
  if (kSplit && !parts && rank != 0) return;
  const int lo = parts ? rank * na / split : 0;
  const int hi = parts ? (rank + 1) * na / split : na;

  float best[kRows];
  int best_fid[kRows];
  float2* my_attr[kRows];  // this thread's 6 attributes of row r
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = -CUDART_INF_F;
    best_fid[r] = -1;
    my_attr[r] = reinterpret_cast<float2*>(&s_attr[warp][r][lane * kNAttr]);
    if constexpr (!kSplit) {
#pragma unroll
      for (int k = 0; k < kNAttr / 2; ++k)
        my_attr[r][k] = make_float2(0.f, 0.f);
    }
  }
  int ci_next = lo < hi ? __ldg(ids + lo) : 0;
  int ci_after = lo + 1 < hi ? __ldg(ids + lo + 1) : 0;
  const float* img_coefs = coefs + static_cast<long long>(img) * F * kCoefW;

  // Item k of a chunk is plane k % kStaged of face k / kStaged; a thread
  // fetches the (a, b, c) of its items of the next chunk ahead of time.
  float pre[kItemsPerThread][3];
  auto fetch = [&](int ci) {
    const float* src = img_coefs + static_cast<long long>(ci) * kChunk * kCoefW;
#pragma unroll
    for (int m = 0; m < kItemsPerThread; ++m) {
      const int k = threadIdx.x + m * kThreads;
      if (k < kItems) {
        const float* q = src + (k / kStaged) * kCoefW + 3 * (k % kStaged);
        pre[m][0] = __ldg(q);
        pre[m][1] = __ldg(q + 1);
        pre[m][2] = __ldg(q + 2);
      }
    }
  };
  if (lo < hi) fetch(ci_next);

  for (int i = lo; i < hi; ++i) {
    const int ci = ci_next;
    ci_next = ci_after;
    if (i + 2 < hi) ci_after = __ldg(ids + i + 2);
    __syncthreads();  // the previous chunk is no longer read
#pragma unroll
    for (int m = 0; m < kItemsPerThread; ++m) {
      const int k = threadIdx.x + m * kThreads;
      if (k < kItems) {
        const int j = k / kStaged, p = k % kStaged;
        const float a = pre[m][0], b = pre[m][1];
        const float c = rebase(a, b, pre[m][2], fcol0, frow0);
        if (p < kNTest) {
          reinterpret_cast<float*>(&s.a[j])[p] = a;
          reinterpret_cast<float*>(&s.b[j])[p] = b;
          reinterpret_cast<float*>(&s.c[j])[p] = c;
        } else {
          s.attr[j][p - kNTest] = make_float4(a, b, c, 0.f);
        }
      }
    }
    __syncthreads();
    if (i + 1 < hi) fetch(ci_next);

    float c_best[kRows];
    int c_j[kRows];
    bool c_nan[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      c_best[r] = -CUDART_INF_F;
      c_j[r] = 0;
      c_nan[r] = false;
    }
    // Ascending j with >=: on equal 1/z the largest face id wins. A
    // skipped face would only have offered -inf.
    for (unsigned live = cull_mask(s, lane, u_lo, u_hi, v_lo, v_hi); live;
         live &= live - 1) {
      const int j = __ffs(live) - 1;
      const float4 A = s.a[j], B = s.b[j], C = s.c[j];
      const float au0 = __fmul_rn(A.x, pu), au1 = __fmul_rn(A.y, pu);
      const float au2 = __fmul_rn(A.z, pu), auz = __fmul_rn(A.w, pu);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float e0 = plane_au(au0, B.x, C.x, pv[r]);
        const float e1 = plane_au(au1, B.y, C.y, pv[r]);
        const float e2 = plane_au(au2, B.z, C.z, pv[r]);
        const float iz = plane_au(auz, B.w, C.w, pv[r]);
        const bool inside = (e0 >= 0.f) && (e1 >= 0.f) && (e2 >= 0.f);
        const float cand = inside ? iz : -CUDART_INF_F;
        c_nan[r] |= cand != cand;  // a NaN max voids the chunk
        if (cand >= c_best[r]) {
          c_best[r] = cand;
          c_j[r] = j;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!c_nan[r] && c_best[r] > best[r]) {  // strict: earlier chunks win
        best[r] = c_best[r];
        best_fid[r] = ci * kChunk + c_j[r];
        if constexpr (!kSplit) {
          float v[kNAttr];
#pragma unroll
          for (int k = 0; k < kNAttr; ++k) {
            const float4 P = s.attr[c_j[r]][k];
            v[k] = plane_au(__fmul_rn(P.x, pu), P.y, P.z, pv[r]);
          }
#pragma unroll
          for (int k = 0; k < kNAttr / 2; ++k)
            my_attr[r][k] = make_float2(v[2 * k], v[2 * k + 1]);
        }
      }
    }
  }

  if (parts) {
    // Partials of pixel p = row * 32 + column at s_pbest[p], s_pfid[p]. The
    // attribute staging is free until block 0 evaluates the winners, and
    // block 0 reads only the other blocks' partials.
    const cg::cluster_group cluster = cg::this_cluster();
    float* s_pbest = &s_attr[0][0][0];
    int* s_pfid = reinterpret_cast<int*>(s_pbest + kTileH * kTileW);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = (warp * kRows + r) * kTileW + lane;
      s_pbest[p] = best[r];
      s_pfid[p] = best_fid[r];
    }
    cluster.sync();  // every part's partials are written
    if (rank == 0) {
      // In block order, so that an earlier part keeps a tie.
      for (int q = 1; q < split; ++q) {
        const float* qb = cluster.map_shared_rank(s_pbest, q);
        const int* qf = cluster.map_shared_rank(s_pfid, q);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int p = (warp * kRows + r) * kTileW + lane;
          const float b = qb[p];
          if (b > best[r]) {
            best[r] = b;
            best_fid[r] = qf[p];
          }
        }
      }
    }
    cluster.sync();  // no block leaves while block 0 reads its partials
    if (rank != 0) return;
  }
  if constexpr (kSplit) {
    // The winner's 6 attribute planes, from its row of coefficients.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float v[kNAttr];
      if (best_fid[r] >= 0) {
        const float* q = img_coefs + static_cast<long long>(best_fid[r]) * kCoefW + 3 * kNTest;
#pragma unroll
        for (int k = 0; k < kNAttr; ++k) {
          const float a = __ldg(q + 3 * k), b = __ldg(q + 3 * k + 1);
          const float c = rebase(a, b, __ldg(q + 3 * k + 2), fcol0, frow0);
          v[k] = plane_au(__fmul_rn(a, pu), b, c, pv[r]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kNAttr; ++k) v[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kNAttr / 2; ++k)
        my_attr[r][k] = make_float2(v[2 * k], v[2 * k + 1]);
    }
  }

  // Stores. 1/z and face ids a row of 32 pixels per warp store. A row's
  // attributes are contiguous in [B, H, W, 6]: in a whole tile of an image
  // of even width every row starts 16-byte aligned, and a warp's 4 rows
  // leave as 6 float4 stores a lane; elsewhere row by row, 8 bytes a lane,
  // masked at the ragged edge of the image.
  __syncwarp();
  const int y0 = row0 + warp * kRows;
  const int n_px = min(kTileW, W - col0);
  const long long p0 = (static_cast<long long>(img) * H + y0) * W + col0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (y0 + r < H && lane < n_px) {
      invz_out[p0 + r * W + lane] = best[r];
      fid_out[p0 + r * W + lane] = best_fid[r];
    }
  }
  constexpr int kRowVec = kTileW * kNAttr / 4;  // float4 in a tile row
  const bool whole = n_px == kTileW && y0 + kRows <= H && (W & 1) == 0 &&
                     (reinterpret_cast<uintptr_t>(attr_out) & 15) == 0;
  if (whole) {
#pragma unroll
    for (int m = 0; m < kRows * kRowVec / 32; ++m) {
      const int k = lane + 32 * m, r = k / kRowVec, q = k % kRowVec;
      reinterpret_cast<float4*>(attr_out + (p0 + r * W) * kNAttr)[q] =
          reinterpret_cast<const float4*>(s_attr[warp][r])[q];
    }
  } else {
    for (int r = 0; r < kRows && y0 + r < H; ++r) {
      float2* dst = reinterpret_cast<float2*>(attr_out + (p0 + r * W) * kNAttr);
      for (int q = lane; q < n_px * kNAttr / 2; q += 32)
        dst[q] = reinterpret_cast<const float2*>(s_attr[warp][r])[q];
    }
  }
}

}  // namespace

// Launches on `stream` of CUDA device `device`; returns cudaGetLastError()
// (0 on success). coefs [B, F, 32] f32, chunk_ids [B, T, n_chunks] i32,
// n_active [B, T] i32, T the row-major 16x32 tiles of H x W, F = 16 *
// n_chunks; outputs invz [B, H, W] f32, fid [B, H, W] i32, attr [B, H, W,
// 6] f32. `split` (1..16) blocks walk each tile's chain; 1 is the plain
// launch of one block per tile.
extern "C" int visibility_launch(const float* coefs, const int* chunk_ids,
                                 const int* n_active, float* invz, int* fid,
                                 float* attr, int B, int F, int T,
                                 int n_chunks, int H, int W, int split,
                                 int device, void* stream) {
  const int n_tw = (W + kTileW - 1) / kTileW;
  const long long n_blocks = static_cast<long long>(B) * T * split;
  if (F != n_chunks * kChunk || split < 1 || split > kMaxSplit ||
      n_blocks <= 0 || n_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int current = device;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 1) {
    visibility_kernel<false><<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
        coefs, chunk_ids, n_active, invz, fid, attr, F, T, n_chunks, H, W,
        n_tw, 1);
  } else {
    if (split > kPortableSplit)
      cudaFuncSetAttribute(visibility_kernel<true>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n_blocks));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = s;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = split;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, visibility_kernel<true>, coefs, chunk_ids,
                       n_active, invz, fid, attr, F, T, n_chunks, H, W, n_tw,
                       split);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}
