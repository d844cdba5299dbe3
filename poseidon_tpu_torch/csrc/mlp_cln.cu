// Fused block tail forward for Hopper (sm_90a), plain C interface: the block
// MLP, the lead-time conditional LayerNorm and the residual add of a Swin
// block in one kernel.
//
//   o   = bf16( bf16(gelu(x . W1^T + b1)) . W2^T + b2 )          (fp32 accumulate)
//   mu  = mean_C o;  var = max(mean_C o^2 - mu^2, 0);  r = rsqrt(var + eps)
//   out = bf16( x + bf16(scale[b] * (o - mu) * r + shift[b]) )
//
// on a token-major (B, L, C) bf16 stream x, row m of image b = m / L, with the
// per-image fp32 scale and shift (B, C) (a drop-path keep mask already folded
// in by the caller). Replaces the TPU kernel
// poseidon_tpu/ops/mlp.py::_fwd_kernel_dm_cln (pallas_call in
// _call_fwd_dm_cln), with its rounding points; the variance is E[o^2] - mu^2
// clamped at 0, as there. The Python wrapper and the plain PyTorch version
// are in ops/mlp.py.
//
// Bound on this card: as the MLP's (mlp_tile.cuh), 4*C*F FLOPs and 4C bytes
// a row, bound by tensor-core operations. The norm and the residual add cost
// no extra device-memory bytes: they read the output sum in registers and
// the x tile in shared memory, where the unfused path writes the MLP output,
// the norm's output and the residual to device memory and reads them back.
//
// Design. The MLP main loop of mlp_tile.cuh leaves the 64 x C fp32 sum in
// wgmma's accumulator registers, where a row's C values lie in one quad of
// lanes (at C = 384, in one quad of each of the two warpgroups). So the
// epilogue takes the row statistics in registers: quad shuffles, and at
// C = 384 one exchange of the two warpgroups' row sums through shared
// memory, added in a fixed order. x is read from the tile the main loop
// staged, and the output written over it and stored in 16-byte rows. A
// 64-row tile lies in one image (the wrapper checks
// L % 64 == 0), so the tile reads one row of scale and shift.

#include "mlp_tile.cuh"

using namespace mlp_fwd_tile;

namespace {

template <int C, bool RES>
__global__ void __launch_bounds__(RES ? Resident<C>::THREADS : Plan<C>::THREADS, 1)
mlp_cln_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ scale,
                   const float* __restrict__ shift, bf16* __restrict__ out,
                   int M, int F, int L, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int n0 = RES ? 0 : (threadIdx.x / 128) * Plan<C>::NW;
  run_rows<C, RES>(x, w1, b1, w2, smem, M, F,
                   [&](auto& acc, long long m0, unsigned char* xt, float* red, auto sync,
                       int rt, int rn) {
    constexpr int N = sizeof(acc) / sizeof(float);
    float mu[2], rs[2];
    row_stats<C>(acc, b2, eps, red, n0, mu, rs);
    const long long img = m0 / L;
    const float* sc = scale + img * C;
    const float* sh = shift + img * C;
    sync();  // the tile's products are done with its x
    // out = x + y in place of x in the staged tile (each value read and
    // written by one thread), then out in 16-byte rows.
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const int j = (i % 4) / 2, col = n0 + acc_col(lane, i);
      uint32_t* at =
          reinterpret_cast<uint32_t*>(xt + tile_off<Atom<C>::AK>(acc_row(warp, lane, i), col, 64));
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
      const float y0 = round_bf16(__ldg(sc + col) * ((acc[i] - mu[j]) * rs[j]) + __ldg(sh + col));
      const float y1 =
          round_bf16(__ldg(sc + col + 1) * ((acc[i + 1] - mu[j]) * rs[j]) + __ldg(sh + col + 1));
      *at = pack2(xv.x + y0, xv.y + y1);
    }
    sync();
    store_tile<C>(xt, out, m0, M, rt, rn);
  });
}

}  // namespace

extern "C" int mlp_cln_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* scale, const void* shift, void* out,
                           int M, int C, int F, int L, float eps, void* stream) {
  if (M <= 0 || F <= 0 || F % 64 || L <= 0 || L % 64 || M % L) return (int)cudaErrorInvalidValue;
  return (int)dispatch(C, [&](auto w) {
    constexpr int CC = decltype(w)::C;
    return launch_rows<CC>(mlp_cln_fwd_kernel<CC, Resident<CC>::ok>,
                           mlp_cln_fwd_kernel<CC, false>, M, F, static_cast<cudaStream_t>(stream),
                           static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                           static_cast<const float*>(b1), static_cast<const bf16*>(w2),
                           static_cast<const float*>(b2), static_cast<const float*>(scale),
                           static_cast<const float*>(shift), static_cast<bf16*>(out), M, F, L,
                           eps);
  });
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// the kernel that width c launches at F = 4c.
extern "C" int mlp_cln_fwd_info(int c, int* out) {
  return (int)dispatch(c, [&](auto w) {
    constexpr int CC = decltype(w)::C;
    return rows_info<CC>(mlp_cln_fwd_kernel<CC, Resident<CC>::ok>, out);
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
