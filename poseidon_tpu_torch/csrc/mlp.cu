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
// The bound and the design of the main loop are in mlp_tile.cuh. The
// epilogue adds b2 to the staged fp32 sum and rounds.

#include "mlp_tile.cuh"

using namespace mlp_fwd_tile;

namespace {

template <int C>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, int M, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * MT;
  tile_sum<C>(x, w1, b1, w2, smem, m0, M, F);
  const float* so = reinterpret_cast<const float*>(smem + Plan<C>::o_off);
  for (int i = threadIdx.x; i < MT * C; i += THREADS) {
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
