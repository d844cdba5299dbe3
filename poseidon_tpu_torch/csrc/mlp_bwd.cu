// Fused block MLP backward for Hopper (sm_90a), plain C interface: the
// kernels of mlp_bwd.cuh (where their function, bound and design are set
// out) with no residual operand. The wrapper and the plain PyTorch version
// with the same rounding points are in ops/mlp.py.

#include "mlp_bwd.cuh"

extern "C" int mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* dy, void* dx, void* grads, void* part, int M, int C, int F,
                       int R, void* stream) {
  using mlp_bwd_tile::bf16;
  return (int)mlp_bwd_tile::run(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(dy), nullptr,
      static_cast<bf16*>(dx), static_cast<float*>(grads), static_cast<float*>(part), M, C, F, R,
      static_cast<cudaStream_t>(stream));
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// the instantiation of width c.
extern "C" int mlp_bwd_info(int c, int* out) { return (int)mlp_bwd_tile::info(c, out); }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
