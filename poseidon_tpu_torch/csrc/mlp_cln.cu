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
// no extra bytes: they read the output sum and the x tile where the MLP left
// them in shared memory, which is what the unfused path, with the MLP output,
// the norm's output and the residual each written to device memory and read
// back, pays for.
//
// Design. The MLP main loop of mlp_tile.cuh leaves the 64 x C fp32 sum and the
// x tile in shared memory. The channel mean and variance of a row need all C
// outputs, which the WMMA accumulators spread over two warps in an opaque
// layout, so the epilogue reads the staged sum by rows: each warp takes every
// eighth row, each lane C/32 of its columns, and reduces over the row with
// shuffles. A 64-row tile lies in one image (the wrapper checks L % 64 == 0),
// so the tile reads one row of scale and shift.

#include "mlp_tile.cuh"

using namespace mlp_fwd_tile;

namespace {

template <int C>
__global__ void __launch_bounds__(THREADS)
mlp_cln_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ scale,
                   const float* __restrict__ shift, bf16* __restrict__ out,
                   int M, int F, int L, float eps) {
  constexpr int V = C / 32;  // columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * MT;
  tile_sum<C>(x, w1, b1, w2, smem, m0, M, F);
  const float* so = reinterpret_cast<const float*>(smem + Plan<C>::o_off);
  const bf16* sx = reinterpret_cast<const bf16*>(smem + Plan<C>::x_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long img = m0 / L;
  const float* sc = scale + img * C;
  const float* sh = shift + img * C;
  for (int r = warp; r < MT; r += WARPS) {
    if (m0 + r >= M) break;
    float o[V];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      o[i] = round_bf16(so[r * C + c] + b2[c]);
      s1 += o[i];
      s2 += o[i] * o[i];
    }
    const float mu = warp_sum(s1) / C;
    const float var = fmaxf(warp_sum(s2) / C - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
    bf16* orow = out + (m0 + r) * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      const float y = round_bf16(sc[c] * ((o[i] - mu) * rs) + sh[c]);
      orow[c] = __float2bfloat16(__bfloat162float(sx[r * C + c]) + y);
    }
  }
}

template <int C>
cudaError_t launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                   const float* b2, const float* scale, const float* shift, bf16* out,
                   int M, int F, int L, float eps, cudaStream_t stream) {
  using P = Plan<C>;
  auto kernel = mlp_cln_fwd_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(M / MT), THREADS, P::bytes, stream>>>(x, w1, b1, w2, b2, scale, shift,
                                                            out, M, F, L, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mlp_cln_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* scale, const void* shift, void* out,
                           int M, int C, int F, int L, float eps, void* stream) {
  if (M <= 0 || F <= 0 || F % FT || L <= 0 || L % MT || M % L) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const float* b2p = static_cast<const float*>(b2);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return (int)launch<96>(xp, w1p, b1p, w2p, b2p, sp, hp, op, M, F, L, eps, st);
    case 192: return (int)launch<192>(xp, w1p, b1p, w2p, b2p, sp, hp, op, M, F, L, eps, st);
    case 384: return (int)launch<384>(xp, w1p, b1p, w2p, b2p, sp, hp, op, M, F, L, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
