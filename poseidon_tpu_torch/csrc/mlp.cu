// Fused block MLP forward for Hopper (sm_90a), plain C interface.
//
//   out = bf16( bf16(gelu(x . W1^T + b1)) . W2^T + b2 ),  fp32 accumulation
//
// on token-major (M, C) bf16 rows, with the PyTorch Linear weights as they
// are: W1 (F, C), W2 (C, F) bf16, b1 (F,), b2 (C,) fp32. Replaces the TPU
// kernels poseidon_tpu/ops/mlp.py::_fwd_kernel_dm (D-major, ScOT-T/S/B
// stages 0-1) and ::_fwd_kernel (token-major row tiles, ScOT-L stages 0-1):
// one token-major kernel serves both, since the D-major layout only served
// the TPU's lanes. The Python wrapper and the plain PyTorch version with the
// same rounding points are in ops/mlp.py.
//
// The bound and the design of the main loop are in mlp_tile.cuh. The
// epilogue adds b2 to the sum in registers, rounds, stages the bf16 tile
// over the x tile in shared memory and stores it in 16-byte rows.

#include "mlp_tile.cuh"

using namespace mlp_fwd_tile;

namespace {

template <int C, bool RES>
__global__ void __launch_bounds__(RES ? Resident<C>::THREADS : Plan<C>::THREADS, 1)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, int M, int F) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int n0 = RES ? 0 : (threadIdx.x / 128) * Plan<C>::NW;
  run_rows<C, RES>(x, w1, b1, w2, smem, M, F,
                   [&](auto& acc, long long m0, unsigned char* xt, float*, auto sync, int rt,
                       int rn) {
    constexpr int N = sizeof(acc) / sizeof(float);
    sync();  // the tile's products are done with its x
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const int col = n0 + acc_col(lane, i);
      *reinterpret_cast<uint32_t*>(xt + tile_off<Atom<C>::AK>(acc_row(warp, lane, i), col, 64)) =
          pack2(acc[i] + __ldg(b2 + col), acc[i + 1] + __ldg(b2 + col + 1));
    }
    sync();
    store_tile<C>(xt, out, m0, M, rt, rn);
  });
}

}  // namespace

extern "C" int mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int M, int C, int F, void* stream) {
  if (M <= 0 || F <= 0 || F % 64) return (int)cudaErrorInvalidValue;
  return (int)dispatch(C, [&](auto w) {
    constexpr int CC = decltype(w)::C;
    return launch_rows<CC>(mlp_fwd_kernel<CC, Resident<CC>::ok>, mlp_fwd_kernel<CC, false>, M, F,
                           static_cast<cudaStream_t>(stream), static_cast<const bf16*>(x),
                           static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                           static_cast<const bf16*>(w2), static_cast<const float*>(b2),
                           static_cast<bf16*>(out), M, F);
  });
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// the kernel that width c launches at F = 4c.
extern "C" int mlp_fwd_info(int c, int* out) {
  return (int)dispatch(c, [&](auto w) {
    constexpr int CC = decltype(w)::C;
    return rows_info<CC>(mlp_fwd_kernel<CC, Resident<CC>::ok>, out);
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
