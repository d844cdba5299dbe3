// The fused block MLP of one tile of 64 token-major rows, for Hopper
// (sm_90a): the main loop shared by the MLP forward (mlp.cu), the fused
// block tail's forward (mlp_cln.cu) and its backward prologue
// (mlp_cln_bwd.cu), which each add their own epilogue.
//
//   sum = bf16(gelu(x . W1^T + b1)) . W2^T      (fp32 accumulation, no b2)
//
// on token-major (M, C) bf16 rows, with the PyTorch Linear weights as they
// are: W1 (F, C), W2 (C, F) bf16, b1 (F,) fp32. The GELU is exact: erff.
//
// Bound on this card. Per row the MLP reads and writes C bf16 values (4C
// bytes) and does 4*C*F = 16*C^2 FLOPs: 4C FLOPs per byte (the weights,
// 4*C*F bytes, are counted once per call), 384 at C = 96 and more above, over
// the H100's ~295 FLOP/B ridge. So it is bound by tensor-core operations,
// and only if the hidden state stays on chip: written out and read back in
// bf16, as the unfused path does, the (M, F) hidden state would add 16C
// bytes per row and make it bytes bound. Here it never leaves shared memory,
// and the F loop keeps the output sum in registers.
//
// Design. A CTA of 8 warps takes 64 rows (the last tile ragged, zero-filled
// on load). It stages its x tile in shared memory once, then walks F in steps
// of 64: it stages the 64 W1 rows and the 64-column W2 slab of the step,
// computes u = x W1^T (WMMA, bf16 in, fp32 accumulate; warp (r, c) takes rows
// 16r.. and hidden columns 32c..), adds b1 and applies the GELU into a 64 x 64
// bf16 tile g, and accumulates g W2^T into the output. The output
// accumulator, 64 x C fp32, stays in registers across the F loop: warp (r, c)
// holds rows 16r.. and output columns c*C/2.. (C/32 fragments). At the end it
// is staged in shared memory, over the weight tiles, for the epilogue; the x
// tile stays where it is. Tensor cores through WMMA only; wgmma/TMA and
// pipelined loads are later work.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace mlp_fwd_tile {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 64;  // rows per CTA
constexpr int FT = 64;  // hidden columns per step

template <int C>
struct Plan {
  static constexpr size_t x_off = 0;                              // MT x C bf16
  static constexpr size_t w1_off = x_off + size_t(MT) * C * 2;    // FT x C bf16
  static constexpr size_t w2_off = w1_off + size_t(FT) * C * 2;   // C x FT bf16
  static constexpr size_t u_off = w2_off + size_t(C) * FT * 2;    // MT x FT f32
  static constexpr size_t g_off = u_off + size_t(MT) * FT * 4;    // MT x FT bf16
  static constexpr size_t bytes = g_off + size_t(MT) * FT * 2;
  // The MT x C fp32 sum is staged over the two weight tiles.
  static constexpr size_t o_off = w1_off;
  static_assert(size_t(MT) * C * 4 <= size_t(FT) * C * 4, "epilogue staging");
};

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752440f));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum above for rows m0.. into shared memory at Plan<C>::o_off (MT x C
// fp32, row-major), with the x tile at Plan<C>::x_off. Ends with a block
// barrier.
template <int C>
__device__ void tile_sum(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         unsigned char* smem, long long m0, int M, int F) {
  using P = Plan<C>;
  constexpr int NC = C / 32;  // output fragments per warp (C/2 columns)
  bf16* sx = reinterpret_cast<bf16*>(smem + P::x_off);
  bf16* sw1 = reinterpret_cast<bf16*>(smem + P::w1_off);
  bf16* sw2 = reinterpret_cast<bf16*>(smem + P::w2_off);
  float* su = reinterpret_cast<float*>(smem + P::u_off);
  bf16* sg = reinterpret_cast<bf16*>(smem + P::g_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp >> 1, wc = warp & 1;

  // x tile, 16-byte vectors; rows past M are zeros.
  for (int i = tid; i < MT * C / 8; i += THREADS) {
    const int r = i / (C / 8), v = i % (C / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (m0 + r) * C + v * 8);
    *reinterpret_cast<uint4*>(sx + r * C + v * 8) = val;
  }

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fu;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int f0 = 0; f0 < F; f0 += FT) {
    __syncthreads();  // the previous step is done with sw1, sw2 and sg
    for (int i = tid; i < FT * C / 8; i += THREADS)  // W1 rows f0.., contiguous
      *reinterpret_cast<uint4*>(sw1 + i * 8) =
          *reinterpret_cast<const uint4*>(w1 + (long long)f0 * C + i * 8);
    for (int i = tid; i < C * FT / 8; i += THREADS) {  // W2[:, f0:f0+FT]
      const int c = i / (FT / 8), v = i % (FT / 8);
      *reinterpret_cast<uint4*>(sw2 + c * FT + v * 8) =
          *reinterpret_cast<const uint4*>(w2 + (long long)c * F + f0 + v * 8);
    }
    __syncthreads();

    // u = x W1^T for rows 16*wr.., hidden columns 32*wc.. of the step.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(fu, 0.f);
#pragma unroll 4
      for (int k = 0; k < C / 16; ++k) {
        wmma::load_matrix_sync(fa, sx + wr * 16 * C + k * 16, C);
        wmma::load_matrix_sync(fb, sw1 + (wc * 32 + j * 16) * C + k * 16, C);
        wmma::mma_sync(fu, fa, fb, fu);
      }
      wmma::store_matrix_sync(su + wr * 16 * FT + wc * 32 + j * 16, fu, FT,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * 32; e += 32) {
      const int r = wr * 16 + e / 32, col = wc * 32 + e % 32;
      sg[r * FT + col] = __float2bfloat16(gelu_erf(su[r * FT + col] + b1[f0 + col]));
    }
    __syncthreads();  // g rows of strip wr come from both column halves

    // acc += g W2^T for rows 16*wr.., output columns wc*C/2...
#pragma unroll
    for (int k = 0; k < FT / 16; ++k) {
      wmma::load_matrix_sync(fa, sg + wr * 16 * FT + k * 16, FT);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        wmma::load_matrix_sync(fb, sw2 + (wc * (C / 2) + i * 16) * FT + k * 16, FT);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
  }
  __syncthreads();  // every warp is done with the weight tiles

  float* so = reinterpret_cast<float*>(smem + P::o_off);
#pragma unroll
  for (int i = 0; i < NC; ++i)
    wmma::store_matrix_sync(so + wr * 16 * C + wc * (C / 2) + i * 16, acc[i], C,
                            wmma::mem_row_major);
  __syncthreads();
}

}  // namespace mlp_fwd_tile
