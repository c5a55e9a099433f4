// Batched per-keypoint patch gather.
//
// Replaces: tpuslam/ops/patch_pallas.py, `_superpatches_tpu` (kernel body
// `_sup_kernel`) with its XLA epilogue in `_extract_patches_tpu`, reached
// through `extract_patches(img, yx, size)`.
//
// What it computes: for K top-left corners yx[k] = (row, col), the exact
// [size, size] window of a padded, blurred pyramid level img [H, W] f32,
// written as out [K, size, size] f32.
//
// What bounds it on this card: nothing in the arithmetic. A frame moves a
// few MB (1024 features x 37 x 37 x 4 B in and out per image), so it is
// launch-bound: 16 launches per frame (2 images x 8 levels).
//
// Design: one thread block per keypoint; its threads walk the window in
// row-major order, so neighbouring threads read neighbouring pixels of a
// row and write neighbouring output words. The TPU kernel's (8, 128)-aligned
// superpatch DMA and its one-hot/shift epilogue existed only to satisfy
// Mosaic's tiling; none of it is carried over. Reads that fall outside img
// write 0 instead, so a keypoint that breaks the 0 <= yx <= (H, W) - size
// contract cannot read out of bounds. Later work: one launch over all
// levels and both images, with the IC moments and the bf16 cast fused in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void patch_gather_kernel(const float* __restrict__ img, int H, int W,
                                    const int32_t* __restrict__ yx, int size,
                                    float* __restrict__ out) {
  const int k = blockIdx.x;
  const int y0 = yx[2 * k];
  const int x0 = yx[2 * k + 1];
  const int n = size * size;
  float* dst = out + (size_t)k * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = y0 + i / size;
    const int x = x0 + i % size;
    const bool inside = (y >= 0) & (y < H) & (x >= 0) & (x < W);
    dst[i] = inside ? img[(size_t)y * W + x] : 0.0f;
  }
}

}  // namespace

extern "C" int patch_gather(const float* img, int H, int W, const int32_t* yx,
                            int K, int size, float* out, void* stream) {
  if (K > 0) {
    patch_gather_kernel<<<K, 128, 0, (cudaStream_t)stream>>>(img, H, W, yx,
                                                             size, out);
  }
  return (int)cudaGetLastError();
}
