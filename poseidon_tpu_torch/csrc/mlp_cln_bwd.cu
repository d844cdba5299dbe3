// Fused block tail backward for Hopper (sm_90a), plain C interface: the
// backward of mlp_cln.cu's MLP + conditional LayerNorm + residual.
//
//   o, mu, r as the forward;  yhat = (o - mu) r;  dyh = dy * scale[b]
//   do      = r (dyh - mean_C dyh - yhat mean_C(dyh yhat))                 (fp32)
//   dscale[b] = sum over the image's rows of dy yhat;  dshift[b] = sum of dy (fp32 dy)
//   db2     = sum of do (fp32);  dW2, dW1, db1 and dx_mlp from bf16(do) as the
//             MLP backward's dy;  dx = bf16(dy + dx_mlp), rounded once
//
// Replaces the TPU kernel poseidon_tpu/ops/mlp.py::_bwd_kernel_dm_cln
// (pallas_call in _call_bwd_dm_cln), with its rounding points. The Python
// wrapper and the plain PyTorch version are in ops/mlp.py.
//
// Bound on this card. Per row the backward reads x and dy and writes dx (6C
// bytes) and does 12*C*F FLOPs (o recomputed, then u, dh, dx, dW1, dW2):
// bound by tensor-core operations, as the MLP backward is.
//
// Design. The LayerNorm's backward needs all C outputs of a row, and those
// need every step of F, while the MLP backward's dW CTAs see one step of F
// and cannot get them. So three launches, in stream order:
//  1. a prologue, per 64-row tile: the forward's main loop (mlp_tile.cuh)
//     recomputes o in registers; then, as the forward's epilogue, the row
//     statistics, yhat and do, with quad shuffles. It writes bf16(do)
//     (M, C) and one fp32 partial per tile of db2, dscale and dshift: column
//     sums over the 64 rows, by shuffles across each warp's 16 rows and then
//     over the four warps in a fixed order (a tile lies in one image: the
//     wrapper checks L % 64 == 0).
//  2. the MLP backward of mlp_bwd.cuh with dy := bf16(do) and the residual dy
//     added to its fp32 dx sum before the rounding. It also sums bf16(do) for
//     its db2, which the wrapper leaves unused: db2 is the fp32 sum of do.
//  3. a reduce of the prologue's partials in a fixed order
//     (mlp_cln_reduce.cuh): db2 over all tiles, dscale and dshift over the
//     tiles of each image.
// No atomics, so two calls give the same bits. The LayerNorm's backward stays
// out of the MLP backward's dx CTAs, whose registers hold the dx sum.

#include "mlp_tile.cuh"
#include "mlp_bwd.cuh"
#include "mlp_cln_reduce.cuh"

using namespace mlp_fwd_tile;

namespace {

template <int C, bool RES>
__global__ void __launch_bounds__(RES ? Resident<C>::THREADS : Plan<C>::THREADS, 1)
mlp_cln_bwd_prologue_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                            const float* __restrict__ b1, const bf16* __restrict__ w2,
                            const float* __restrict__ b2, const float* __restrict__ scale,
                            const bf16* __restrict__ dy, bf16* __restrict__ dob,
                            float* __restrict__ part, int M, int F, int L, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int n0 = RES ? 0 : (threadIdx.x / 128) * Plan<C>::NW;
  // M % 64 == 0: every row exists.
  run_rows<C, RES>(x, w1, b1, w2, smem, M, F,
                   [&](auto& acc, long long m0, unsigned char* xt, float* red, auto sync,
                       int rt, int rn) {
    constexpr int N = sizeof(acc) / sizeof(float);
    float* cred = red + 512;  // after two row-sum exchanges: 4 warps x 3 x C
    float mu[2], rs[2];
    row_stats<C>(acc, b2, eps, red, n0, mu, rs);
    const float* sc = scale + (m0 / L) * C;

    // yhat in place of o; the row means of dyh = dy scale and of dyh yhat.
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const int j = (i % 4) / 2, col = n0 + acc_col(lane, i);
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          dy + (m0 + acc_row(warp, lane, i)) * C + col));
      acc[i] = (acc[i] - mu[j]) * rs[j];
      acc[i + 1] = (acc[i + 1] - mu[j]) * rs[j];
      const float h0 = d.x * __ldg(sc + col), h1 = d.y * __ldg(sc + col + 1);
      m1[j] += h0 + h1;
      m2[j] += h0 * acc[i] + h1 * acc[i + 1];
    }
    row_sums<C>(m1, m2, red + 256);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m1[j] /= C;
      m2[j] /= C;
    }
    sync();  // the tile's products are done with its x: bf16(do) is staged there

    // do, rounded and staged over the x tile (then stored in 16-byte rows),
    // and the tile's column sums of do, dy yhat and dy: per block of four
    // accumulator values (columns col, col + 1 of rows r and r + 8), summed
    // over the warp's 16 rows by shuffles.
#pragma unroll
    for (int b = 0; b < N / 4; ++b) {
      const int col = n0 + acc_col(lane, 4 * b);
      const float s0 = __ldg(sc + col), s1 = __ldg(sc + col + 1);
      float pd[2] = {0.f, 0.f}, ps[2] = {0.f, 0.f}, ph[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = 4 * b + 2 * j;
        const long long at = (m0 + acc_row(warp, lane, i)) * C + col;
        const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dy + at));
        const float d0 = rs[j] * (d.x * s0 - m1[j] - acc[i] * m2[j]);
        const float d1 = rs[j] * (d.y * s1 - m1[j] - acc[i + 1] * m2[j]);
        *reinterpret_cast<uint32_t*>(
            xt + tile_off<Atom<C>::AK>(acc_row(warp, lane, i), col, 64)) = pack2(d0, d1);
        pd[0] += d0;
        pd[1] += d1;
        ps[0] += d.x * acc[i];
        ps[1] += d.y * acc[i + 1];
        ph[0] += d.x;
        ph[1] += d.y;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pd[e] = column_sum(pd[e]);
        ps[e] = column_sum(ps[e]);
        ph[e] = column_sum(ph[e]);
      }
      if (lane < 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cred[(warp * 3 + 0) * C + col + e] = pd[e];
          cred[(warp * 3 + 1) * C + col + e] = ps[e];
          cred[(warp * 3 + 2) * C + col + e] = ph[e];
        }
      }
    }
    sync();
    // The tile's partial (db2 | dscale | dshift): the four warps' sums in order.
    for (int j = rt; j < 3 * C; j += rn) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) s += cred[w * 3 * C + j];
      part[(m0 / 64) * 3 * C + j] = s;
    }
    store_tile<C>(xt, dob, m0, M, rt, rn);
  });
}

template <int C>
cudaError_t prologue(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                     const float* b2, const float* scale, const bf16* dy, bf16* dob, float* part,
                     int M, int F, int L, float eps, cudaStream_t stream) {
  return launch_rows<C>(mlp_cln_bwd_prologue_kernel<C, Resident<C>::ok>,
                        mlp_cln_bwd_prologue_kernel<C, false>, M, F, stream, x, w1, b1, w2, b2,
                        scale, dy, dob, part, M, F, L, eps);
}

}  // namespace

// grads (2FC + F + C) and part (R, 2FC + F + C) as mlp_bwd.cu's; cpart
// (M / 64, 3, C) the prologue's partials; cout = db2 | dscale | dshift.
extern "C" int mlp_cln_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* scale, const void* dy, void* dob,
                           void* dx, void* grads, void* part, void* cpart, void* cout,
                           int M, int C, int F, int L, int R, float eps, void* stream) {
  if (M <= 0 || F <= 0 || F % 64 || L <= 0 || L % 64 || M % L) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const float* b2p = static_cast<const float*>(b2);
  const float* sp = static_cast<const float*>(scale);
  const bf16* dyp = static_cast<const bf16*>(dy);
  bf16* dobp = static_cast<bf16*>(dob);
  float* cp = static_cast<float*>(cpart);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 48: err = prologue<48>(xp, w1p, b1p, w2p, b2p, sp, dyp, dobp, cp, M, F, L, eps, st); break;
    case 96: err = prologue<96>(xp, w1p, b1p, w2p, b2p, sp, dyp, dobp, cp, M, F, L, eps, st); break;
    case 192: err = prologue<192>(xp, w1p, b1p, w2p, b2p, sp, dyp, dobp, cp, M, F, L, eps, st); break;
    case 384: err = prologue<384>(xp, w1p, b1p, w2p, b2p, sp, dyp, dobp, cp, M, F, L, eps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  err = mlp_bwd_tile::run(xp, w1p, b1p, w2p, dobp, dyp, static_cast<bf16*>(dx),
                          static_cast<float*>(grads), static_cast<float*>(part), M, C, F, R, st);
  if (err != cudaSuccess) return (int)err;
  return (int)mlp_cln_reduce::reduce(cp, static_cast<float*>(cout), M, C, L, st);
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// the prologue that width c launches at F = 4c (the middle launch is
// mlp_bwd_info's kernel).
extern "C" int mlp_cln_bwd_info(int c, int* out) {
  return (int)dispatch(c, [&](auto w) {
    constexpr int CC = decltype(w)::C;
    return rows_info<CC>(mlp_cln_bwd_prologue_kernel<CC, Resident<CC>::ok>, out);
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
