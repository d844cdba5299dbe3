// The last launch of both fused block tail backwards (mlp_cln_bwd.cu,
// mlp_cln_general.cu): a reduce of the per-64-row-tile fp32 partials
// part (M / 64, 3, C) = (db2 | dscale | dshift) into
//
//   out = db2 (C) | dscale (B, C) | dshift (B, C)
//
// db2 over all tiles, dscale and dshift over the tiles of each image (a tile
// lies in one image: L % 64 == 0), each output a thread, in tile order. No
// atomics, so two calls give the same bits.

#pragma once

#include <cuda_runtime.h>

namespace mlp_cln_reduce {

__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int tiles, int C, int B, int tiles_per_image) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (i < C) {
    for (int t = 0; t < tiles; ++t) s += part[(long long)t * 3 * C + i];
    out[i] = s;
    return;
  }
  const long long j = i - C, per = (long long)B * C;
  if (j >= 2 * per) return;
  const int which = 1 + (int)(j / per);  // 1: dscale, 2: dshift
  const int b = (int)((j % per) / C), c = (int)(j % C);
  for (int t = b * tiles_per_image; t < (b + 1) * tiles_per_image; ++t)
    s += part[((long long)t * 3 + which) * C + c];
  out[i] = s;
}

// The reduce for M rows of images of L rows each.
inline cudaError_t reduce(const float* part, float* out, int M, int C, int L, cudaStream_t st) {
  const int batch = M / L;
  const long long n = (long long)C * (1 + 2 * batch);
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, out, M / 64, C, batch,
                                                              L / 64);
  return cudaGetLastError();
}

}  // namespace mlp_cln_reduce
