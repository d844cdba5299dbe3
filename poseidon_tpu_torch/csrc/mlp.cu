// Fused block MLP forward for Hopper (sm_90a), plain C interface.
//
//   out = bf16( bf16(gelu(x . W1^T + b1)) . W2^T + b2 ),  fp32 accumulation
//
// on token-major (M, C) bf16 rows, with the PyTorch Linear weights as they
// are: W1 (F, C), W2 (C, F) bf16, b1 (F,), b2 (C,) fp32. Replaces the TPU
// kernels poseidon_tpu/ops/mlp.py::_fwd_kernel_dm (D-major, ScOT-B stages
// 0-1) and ::_fwd_kernel (token-major row tiles, ScOT-L stages 0-1): one
// token-major kernel serves both, since the D-major layout only served the
// TPU's lanes. The GELU is exact: erff. (The TPU kernel used the
// Abramowitz-Stegun erf, |err| <= 1.5e-7, because Mosaic has no erf.) The
// Python wrapper and the plain PyTorch version with the same rounding points
// are in ops/mlp.py.
//
// Bound on this card. Per row the kernel reads and writes C bf16 values (4C
// bytes) and does 4*C*F = 16*C^2 FLOPs: 4C FLOPs per byte (the weights,
// 4*C*F bytes, are counted once per call), 384 at C = 96 and more above, over
// the H100's ~295 FLOP/B ridge. So the kernel is bound by tensor-core
// operations, and only if the hidden state stays on chip: written out and
// read back in bf16, as the unfused path does, the (M, F) hidden state would
// add 16C bytes per row and make it bytes bound. Here it never leaves shared
// memory, and the F loop keeps the output sum in registers.
//
// Design. A CTA of 8 warps takes 64 rows (the last tile ragged, zero-filled
// on load and masked on store). It stages its x tile in shared memory once,
// then walks F in steps of 64: it stages the 64 W1 rows and the 64-column W2
// slab of the step, computes u = x W1^T (WMMA, bf16 in, fp32 accumulate; warp
// (r, c) takes rows 16r.. and hidden columns 32c..), adds b1 and applies the
// GELU into a 64 x 64 bf16 tile g, and accumulates g W2^T into the output.
// The output accumulator, 64 x C fp32, stays in registers across the F loop:
// warp (r, c) holds rows 16r.. and output columns c*C/2.. (C/32 fragments).
// At the end it goes through shared memory to add b2 and round. Tensor cores
// through WMMA only; wgmma/TMA and pipelined loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

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
  // The epilogue stages the MT x C fp32 output over the two weight tiles.
  static_assert(size_t(MT) * C * 4 <= size_t(FT) * C * 4, "epilogue staging");
};

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752440f));
}

template <int C>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, int M, int F) {
  using P = Plan<C>;
  constexpr int NC = C / 32;  // output fragments per warp (C/2 columns)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem + P::x_off);
  bf16* sw1 = reinterpret_cast<bf16*>(smem + P::w1_off);
  bf16* sw2 = reinterpret_cast<bf16*>(smem + P::w2_off);
  float* su = reinterpret_cast<float*>(smem + P::u_off);
  bf16* sg = reinterpret_cast<bf16*>(smem + P::g_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp >> 1, wc = warp & 1;
  const long long m0 = (long long)blockIdx.x * MT;

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

  float* so = reinterpret_cast<float*>(smem + P::w1_off);
#pragma unroll
  for (int i = 0; i < NC; ++i)
    wmma::store_matrix_sync(so + wr * 16 * C + wc * (C / 2) + i * 16, acc[i], C,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < MT * C; i += THREADS) {
    const int r = i / C, c = i % C;
    if (m0 + r < M) out[(m0 + r) * C + c] = __float2bfloat16(so[i] + b2[c]);
  }
}

template <int C>
cudaError_t launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                   const float* b2, bf16* out, int M, int F, cudaStream_t stream) {
  using P = Plan<C>;
  auto kernel = mlp_fwd_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + MT - 1) / MT);
  kernel<<<grid, THREADS, P::bytes, stream>>>(x, w1, b1, w2, b2, out, M, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int M, int C, int F, void* stream) {
  if (M <= 0 || F <= 0 || F % FT) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const float* b2p = static_cast<const float*>(b2);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return (int)launch<96>(xp, w1p, b1p, w2p, b2p, op, M, F, st);
    case 192: return (int)launch<192>(xp, w1p, b1p, w2p, b2p, op, M, F, st);
    case 384: return (int)launch<384>(xp, w1p, b1p, w2p, b2p, op, M, F, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
