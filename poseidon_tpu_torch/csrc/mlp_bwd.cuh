// Fused block MLP backward for Hopper (sm_90a): the kernels and their
// launch, shared by the MLP backward (mlp_bwd.cu) and the fused block tail's
// backward (mlp_cln_bwd.cu).
//
//   u = x . W1^T + b1;  du = (dy . W2) * gelu'(u);  g = bf16(gelu(u))
//   dx = bf16( bf16(du) . W1 [+ resid] );  dW1 = bf16(du)^T . x;  db1 = sum du
//   dW2 = dy^T . g;  db2 = sum dy              (fp32 accumulation and sums)
//
// on token-major (M, C) bf16 rows, with the PyTorch Linear weights as they
// are: W1 (F, C), W2 (C, F) bf16, b1 (F,) fp32; dW1 (F, C), dW2 (C, F), db1,
// db2 fp32, summed over all M rows. resid, an optional (M, C) bf16 operand,
// is added to the fp32 dx sum before its one rounding: the fused block tail's
// residual path (mlp_cln_bwd.cu). Replaces the TPU kernels
// poseidon_tpu/ops/mlp.py::_bwd_kernel_dm (D-major, ScOT-B stages 0-1),
// ::_bwd_kernel_fused and ::_bwd_kernel_emit (token-major row tiles; the
// emit variant hands du and g to XLA for the dW products, which this kernel
// does itself): one kernel computes the function of all three. The GELU and
// its derivative are exact: erff. The wrapper and the plain PyTorch version
// with the same rounding points are in ops/mlp.py.
//
// Bound on this card. Per row the kernel reads 2C bf16 values and writes C,
// and does 10*C*F FLOPs (u, dh, dx, dW1, dW2; recomputing u included), 40C
// FLOPs per byte: far over the H100's ~295 FLOP/B ridge at every C. So it is
// bound by tensor-core operations as long as the (M, F) hidden state and its
// gradient stay on chip, which they do here: the plain version writes and
// reads u, dh, du and g in device memory (16F bytes per row and more).
//
// Design. Blocks run in no order, and dx sums over F while dW sums over
// rows, so one launch holds two kinds of CTA (8 warps each), which both
// recompute u and dh:
//  - a dx CTA takes 64 rows (the last tile ragged, zero-filled on load,
//    masked on store) and walks F in steps of FT (64; 32 at C = 384 to fit
//    shared memory). Per step it stages the FT rows of W1 and the FT columns
//    of W2, computes u and dh by WMMA, du and bf16(du) by elements, and adds
//    bf16(du) W1 to the 64 x C fp32 dx sum held in registers (as the forward
//    holds its output).
//  - a dW CTA takes one step of F and one of R splits of the row tiles. It
//    stages its W1 and W2 slices once and walks its row tiles: u, dh, du, g,
//    then dW1 += bf16(du)^T x and dW2 += dy^T g by WMMA, with the FT x C and
//    C x FT sums in registers, db1 and db2 by columns. Zero-filled rows add
//    nothing: x = dy = 0 gives du = 0 and dy^T g = 0, as the TPU kernel's
//    zero padding does. It writes its slice of one fp32 partial per split.
// A reduce kernel then sums the R partials in a fixed order: no atomics, so
// two calls give the same bits. Tensor cores through WMMA only; wgmma/TMA
// and pipelined loads are later work.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace mlp_bwd_tile {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MT = 64;  // rows per tile

template <int C, int FT>
struct Plan {
  static constexpr size_t x_off = 0;                               // MT x C bf16
  static constexpr size_t dy_off = x_off + size_t(MT) * C * 2;     // MT x C bf16
  static constexpr size_t w1_off = dy_off + size_t(MT) * C * 2;    // FT x C bf16
  static constexpr size_t w2_off = w1_off + size_t(FT) * C * 2;    // C x FT bf16
  static constexpr size_t u_off = w2_off + size_t(C) * FT * 2;     // MT x FT f32
  static constexpr size_t dh_off = u_off + size_t(MT) * FT * 4;    // MT x FT f32 (dh, then du)
  static constexpr size_t du_off = dh_off + size_t(MT) * FT * 4;   // MT x FT bf16
  static constexpr size_t g_off = du_off + size_t(MT) * FT * 2;    // MT x FT bf16
  static constexpr size_t bytes = g_off + size_t(MT) * FT * 2;
  // The dx epilogue stages the MT x C fp32 sum over the x and dy tiles.
  static_assert(size_t(MT) * C * 4 == w1_off, "epilogue staging");
  // Each warp holds NF fragments of the dW1 step and NF of the dW2 step.
  static constexpr int NF = FT * C / (256 * WARPS);
  static_assert(NF * 256 * WARPS == FT * C, "dW fragments per warp");
};

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752440f));
}

__device__ __forceinline__ float dgelu_erf(float u) {
  return 0.5f * (1.0f + erff(u * 0.70710678118654752440f)) +
         u * expf(-0.5f * u * u) * 0.39894228040143267794f;
}

// Rows m0.. of x and dy into shared memory; rows past M are zeros.
template <int C>
__device__ void stage_rows(const bf16* x, const bf16* dy, bf16* sx, bf16* sdy, long long m0, int M) {
  for (int i = threadIdx.x; i < MT * C / 8; i += THREADS) {
    const int r = i / (C / 8), v = i % (C / 8);
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (m0 + r < M) {
      a = *reinterpret_cast<const uint4*>(x + (m0 + r) * C + v * 8);
      b = *reinterpret_cast<const uint4*>(dy + (m0 + r) * C + v * 8);
    }
    *reinterpret_cast<uint4*>(sx + r * C + v * 8) = a;
    *reinterpret_cast<uint4*>(sdy + r * C + v * 8) = b;
  }
}

// W1 rows f0.. (contiguous) and W2 columns f0.. of one step.
template <int C, int FT>
__device__ void stage_weights(const bf16* w1, const bf16* w2, bf16* sw1, bf16* sw2, int f0, int F) {
  for (int i = threadIdx.x; i < FT * C / 8; i += THREADS)
    *reinterpret_cast<uint4*>(sw1 + i * 8) =
        *reinterpret_cast<const uint4*>(w1 + (long long)f0 * C + i * 8);
  for (int i = threadIdx.x; i < C * FT / 8; i += THREADS) {
    const int c = i / (FT / 8), v = i % (FT / 8);
    *reinterpret_cast<uint4*>(sw2 + c * FT + v * 8) =
        *reinterpret_cast<const uint4*>(w2 + (long long)c * F + f0 + v * 8);
  }
}

// u = x W1^T + b1 and du = (dy W2) gelu'(u) for the staged tile and step:
// du (fp32) over the dh buffer, bf16(du) and bf16(gelu(u)) into their tiles.
// Warp (wr, wc) takes rows 16 wr.. and hidden columns wc FT/2... Ends with a
// block barrier.
template <int C, int FT>
__device__ void recompute(const Plan<C, FT>&, unsigned char* smem, const float* b1, int f0) {
  using P = Plan<C, FT>;
  const bf16* sx = reinterpret_cast<const bf16*>(smem + P::x_off);
  const bf16* sdy = reinterpret_cast<const bf16*>(smem + P::dy_off);
  const bf16* sw1 = reinterpret_cast<const bf16*>(smem + P::w1_off);
  const bf16* sw2 = reinterpret_cast<const bf16*>(smem + P::w2_off);
  float* su = reinterpret_cast<float*>(smem + P::u_off);
  float* sdh = reinterpret_cast<float*>(smem + P::dh_off);
  bf16* sdu = reinterpret_cast<bf16*>(smem + P::du_off);
  bf16* sg = reinterpret_cast<bf16*>(smem + P::g_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp >> 1, wc = warp & 1;
  constexpr int HALF = FT / 2;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fbc;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fbr;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fu, fd;
#pragma unroll
  for (int j = 0; j < HALF / 16; ++j) {
    const int col = wc * HALF + j * 16;
    wmma::fill_fragment(fu, 0.f);
    wmma::fill_fragment(fd, 0.f);
#pragma unroll 4
    for (int k = 0; k < C / 16; ++k) {
      wmma::load_matrix_sync(fa, sx + wr * 16 * C + k * 16, C);
      wmma::load_matrix_sync(fbc, sw1 + col * C + k * 16, C);
      wmma::mma_sync(fu, fa, fbc, fu);
      wmma::load_matrix_sync(fa, sdy + wr * 16 * C + k * 16, C);
      wmma::load_matrix_sync(fbr, sw2 + k * 16 * FT + col, FT);
      wmma::mma_sync(fd, fa, fbr, fd);
    }
    wmma::store_matrix_sync(su + wr * 16 * FT + col, fu, FT, wmma::mem_row_major);
    wmma::store_matrix_sync(sdh + wr * 16 * FT + col, fd, FT, wmma::mem_row_major);
  }
  __syncwarp();
  for (int e = lane; e < 16 * HALF; e += 32) {
    const int r = wr * 16 + e / HALF, col = wc * HALF + e % HALF;
    const float u = su[r * FT + col] + b1[f0 + col];
    const float du = sdh[r * FT + col] * dgelu_erf(u);
    sdh[r * FT + col] = du;
    sdu[r * FT + col] = __float2bfloat16(du);
    sg[r * FT + col] = __float2bfloat16(gelu_erf(u));
  }
  __syncthreads();  // du / g rows of strip wr come from both column halves
}

template <int C, int FT>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ dy, const bf16* __restrict__ resid,
               bf16* __restrict__ dx, float* __restrict__ part, int M, int F, int R) {
  using P = Plan<C, FT>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem + P::x_off);
  bf16* sdy = reinterpret_cast<bf16*>(smem + P::dy_off);
  bf16* sw1 = reinterpret_cast<bf16*>(smem + P::w1_off);
  bf16* sw2 = reinterpret_cast<bf16*>(smem + P::w2_off);
  const float* sdh = reinterpret_cast<const float*>(smem + P::dh_off);
  const bf16* sdu = reinterpret_cast<const bf16*>(smem + P::du_off);
  const bf16* sg = reinterpret_cast<const bf16*>(smem + P::g_off);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp >> 1, wc = warp & 1;
  const int tiles = (M + MT - 1) / MT;
  const P plan{};

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fac;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fbr;

  if ((int)blockIdx.x < tiles) {
    // dx CTA: 64 rows, the dx sum over F in registers.
    constexpr int NC = C / 32;  // fragments per warp (C/2 output columns)
    const long long m0 = (long long)blockIdx.x * MT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) wmma::fill_fragment(acc[i], 0.f);
    stage_rows<C>(x, dy, sx, sdy, m0, M);
    for (int f0 = 0; f0 < F; f0 += FT) {
      __syncthreads();  // the previous step is done with the weight and du tiles
      stage_weights<C, FT>(w1, w2, sw1, sw2, f0, F);
      __syncthreads();
      recompute<C, FT>(plan, smem, b1, f0);
#pragma unroll
      for (int k = 0; k < FT / 16; ++k) {
        wmma::load_matrix_sync(fa, sdu + wr * 16 * FT + k * 16, FT);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          wmma::load_matrix_sync(fbr, sw1 + k * 16 * C + wc * (C / 2) + i * 16, C);
          wmma::mma_sync(acc[i], fa, fbr, acc[i]);
        }
      }
    }
    __syncthreads();  // every warp is done with the x and dy tiles
    float* so = reinterpret_cast<float*>(smem + P::x_off);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      wmma::store_matrix_sync(so + wr * 16 * C + wc * (C / 2) + i * 16, acc[i], C,
                              wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < MT * C; i += THREADS) {
      const int r = i / C;
      if (m0 + r < M)
        dx[m0 * C + i] = __float2bfloat16(
            resid == nullptr ? so[i] : so[i] + __bfloat162float(resid[m0 * C + i]));
    }
    return;
  }

  // dW CTA: one step of F, one split of the row tiles.
  const int nfc = F / FT;
  const int b = (int)blockIdx.x - tiles;
  const int fc = b % nfc, r = b / nfc;
  const int f0 = fc * FT;
  const int t0 = (int)((long long)r * tiles / R), t1 = (int)((long long)(r + 1) * tiles / R);
  constexpr int NF = P::NF;
  constexpr int C16 = C / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> a1[NF], a2[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    wmma::fill_fragment(a1[i], 0.f);
    wmma::fill_fragment(a2[i], 0.f);
  }
  float db1 = 0.f;               // column tid of the step (tid < FT)
  float db2[(C + THREADS - 1) / THREADS];  // columns tid, tid + THREADS, ... (step 0)
#pragma unroll
  for (int i = 0; i < (C + THREADS - 1) / THREADS; ++i) db2[i] = 0.f;
  stage_weights<C, FT>(w1, w2, sw1, sw2, f0, F);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous tile is done with the row and du tiles
    stage_rows<C>(x, dy, sx, sdy, (long long)t * MT, M);
    __syncthreads();
    recompute<C, FT>(plan, smem, b1, f0);
    if (tid < FT)
      for (int m = 0; m < MT; ++m) db1 += sdh[m * FT + tid];
    if (fc == 0) {
#pragma unroll
      for (int i = 0; i < (C + THREADS - 1) / THREADS; ++i) {
        const int c = tid + i * THREADS;
        if (c < C)
          for (int m = 0; m < MT; ++m) db2[i] += __bfloat162float(sdy[m * C + c]);
      }
    }
    // dW1 (FT x C) += bf16(du)^T x;  dW2 (C x FT) += dy^T g. Fragment
    // warp * NF + i of each is tile (i1 / C16, i1 % C16) of dW1 and tile
    // (i1 / (FT/16), i1 % (FT/16)) of dW2.
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int i1 = warp * NF + i;
      const int fi = i1 / C16, ci = i1 % C16;
      const int cj = i1 / (FT / 16), fj = i1 % (FT / 16);
#pragma unroll
      for (int k = 0; k < MT / 16; ++k) {
        wmma::load_matrix_sync(fac, sdu + k * 16 * FT + fi * 16, FT);
        wmma::load_matrix_sync(fbr, sx + k * 16 * C + ci * 16, C);
        wmma::mma_sync(a1[i], fac, fbr, a1[i]);
        wmma::load_matrix_sync(fac, sdy + k * 16 * C + cj * 16, C);
        wmma::load_matrix_sync(fbr, sg + k * 16 * FT + fj * 16, FT);
        wmma::mma_sync(a2[i], fac, fbr, a2[i]);
      }
    }
  }
  // This CTA's slice of split r's partial: dW1 (F, C) | dW2 (C, F) | db1 | db2.
  const long long n_out = 2LL * F * C + F + C;
  float* dst = part + (long long)r * n_out;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int i1 = warp * NF + i;
    const int fi = i1 / C16, ci = i1 % C16;
    const int cj = i1 / (FT / 16), fj = i1 % (FT / 16);
    wmma::store_matrix_sync(dst + (long long)(f0 + fi * 16) * C + ci * 16, a1[i], C,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(dst + (long long)F * C + (long long)cj * 16 * F + f0 + fj * 16,
                            a2[i], F, wmma::mem_row_major);
  }
  if (tid < FT) dst[2LL * F * C + f0 + tid] = db1;
  if (fc == 0) {
#pragma unroll
    for (int i = 0; i < (C + THREADS - 1) / THREADS; ++i) {
      const int c = tid + i * THREADS;
      if (c < C) dst[2LL * F * C + F + c] = db2[i];
    }
  }
}

__global__ void mlp_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      long long n_out, int R) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += part[r * n_out + i];
  out[i] = s;
}

template <int C, int FT>
cudaError_t launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                   const bf16* dy, const bf16* resid, bf16* dx, float* grads, float* part,
                   int M, int F, int R, cudaStream_t stream) {
  using P = Plan<C, FT>;
  if (F % FT) return cudaErrorInvalidValue;
  auto kernel = mlp_bwd_kernel<C, FT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (M + MT - 1) / MT;
  kernel<<<tiles + (F / FT) * R, THREADS, P::bytes, stream>>>(x, w1, b1, w2, dy, resid, dx, part,
                                                              M, F, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_out = 2LL * F * C + F + C;
  mlp_bwd_reduce_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(part, grads, n_out, R);
  return cudaGetLastError();
}

// The backward for width C: F walked in steps of 64, or of 32 at C = 384 to
// fit shared memory. grads gets dW1 (F, C) | dW2 (C, F) | db1 | db2 and part
// holds the R row splits' partials.
inline cudaError_t run(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                       const bf16* dy, const bf16* resid, bf16* dx, float* grads, float* part,
                       int M, int C, int F, int R, cudaStream_t st) {
  if (M <= 0 || F <= 0 || R <= 0 || R > (M + MT - 1) / MT) return cudaErrorInvalidValue;
  switch (C) {
    case 96: return launch<96, 64>(x, w1, b1, w2, dy, resid, dx, grads, part, M, F, R, st);
    case 192: return launch<192, 64>(x, w1, b1, w2, dy, resid, dx, grads, part, M, F, R, st);
    case 384: return launch<384, 32>(x, w1, b1, w2, dy, resid, dx, grads, part, M, F, R, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mlp_bwd_tile
