// Per-keypoint patch gather over all pyramid levels of one image.
//
// Replaces: tpuslam/ops/patch_pallas.py, `_superpatches_tpu` (kernel body
// `_sup_kernel`) with its XLA epilogue in `_extract_patches_tpu`, reached
// through `extract_patches(img, yx, size)`, which tpuslam's ORB extractor
// calls once per level.
//
// What it computes: for the K keypoints of all levels, in level order,
// the exact [size, size] window at the top-left corner yx[k] = (row, col)
// of its level's padded, blurred image, written as out [K, size, size]
// f32: the concatenation of the per-level gathers. Keypoint k belongs to
// level l where start[l] <= k < start[l + 1].
//
// What bounds it on this card: bytes. One image moves ~5.6 MB out (1024 x
// 37 x 37 x 4 B) and reads what its windows cover of the levels, ~2 us at
// 3.35 TB/s; before this design the 8 launches per image, each behind a
// Python wrapper, cost far more than that.
//
// Design: one launch per image (ops/orb.py gathers every level's patches
// after its per-level loop). The levels travel as a by-value parameter
// block (base pointers, heights, widths, prefix offsets), so no table is
// copied to the device. One thread block per keypoint finds its level by
// an unrolled compare against the prefix offsets (no dynamic indexing of
// the parameter block, so no stack frame). The block is a 2-D layout of
// size columns x R = THREADS / size rows: thread (x, y) copies column x
// of rows y, y + R, ...; neighbouring threads read neighbouring pixels of
// a row and write neighbouring output words, and no div/mod is needed.
// size 37 (ORB's descriptor patch) is a compile-time constant, so the row
// loop is unrolled; other sizes up to MAX_SIZE take the same code with a
// runtime size. The TPU kernel's (8, 128)-aligned superpatch DMA and its
// one-hot/shift epilogue existed only for Mosaic's tiling; none of it is
// carried over. A read outside the level writes 0, so a keypoint that
// breaks the 0 <= yx <= (H, W) - size contract cannot read out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_SIZE = 40;
constexpr int THREADS = 256;  // about this many threads per block

}  // namespace

// The levels of one image, passed by value (ctypes.Structure on the host).
struct PatchLevels {
  const float* img[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
  int start[MAX_LEVELS + 1];  // prefix offsets of the per-level counts
  int n_levels;
};

namespace {

template <int S>  // S > 0: the patch size at compile time; 0: `size`
__global__ void patch_gather_kernel(PatchLevels lv, const int32_t* __restrict__ yx,
                                    int size_arg, float* __restrict__ out) {
  const int size = S > 0 ? S : size_arg;
  const int k = blockIdx.x;
  const float* img = lv.img[0];
  int H = lv.H[0], W = lv.W[0];
#pragma unroll
  for (int l = 1; l < MAX_LEVELS; ++l) {
    if (l < lv.n_levels && k >= lv.start[l]) {
      img = lv.img[l];
      H = lv.H[l];
      W = lv.W[l];
    }
  }
  const int y0 = yx[2 * k];
  const int x0 = yx[2 * k + 1];
  const int x = x0 + threadIdx.x;
  const bool col_in = x >= 0 && x < W;
  float* dst = out + (size_t)k * size * size + threadIdx.x;
  if constexpr (S > 0) {
#pragma unroll
    for (int r = threadIdx.y; r < S; r += THREADS / S) {
      const int y = y0 + r;
      dst[r * S] = (col_in && y >= 0 && y < H) ? img[(size_t)y * W + x] : 0.0f;
    }
  } else {
    for (int r = threadIdx.y; r < size; r += blockDim.y) {
      const int y = y0 + r;
      dst[r * size] = (col_in && y >= 0 && y < H) ? img[(size_t)y * W + x] : 0.0f;
    }
  }
}

}  // namespace

extern "C" int patch_gather_levels(PatchLevels levels, const int32_t* yx, int size,
                                   float* out, void* stream) {
  if (levels.n_levels < 1 || levels.n_levels > MAX_LEVELS || size < 1 || size > MAX_SIZE)
    return (int)cudaErrorInvalidValue;
  const int K = levels.start[levels.n_levels];
  if (K > 0) {
    const dim3 block(size, THREADS / size);
    if (size == 37) {
      patch_gather_kernel<37><<<K, block, 0, (cudaStream_t)stream>>>(levels, yx, size, out);
    } else {
      patch_gather_kernel<0><<<K, block, 0, (cudaStream_t)stream>>>(levels, yx, size, out);
    }
  }
  return (int)cudaGetLastError();
}
