// Fused block MLP, forward and backward, for the calls the bf16 Hopper
// kernels (mlp.cu, mlp_bwd.cu) do not take: fp32 operands, and any width
// C <= 1024 with any hidden width F <= 4096 in bf16 or fp32. sm_90a, plain
// C interface.
//
//   u = x . W1^T + b1;  g = cast(gelu(u));  out = cast(g . W2^T + b2)
//
// on token-major (M, C) rows, with the PyTorch Linear weights as they are:
// W1 (F, C), W2 (C, F) in the operands' type, b1 (F,), b2 (C,) fp32; cast()
// rounds to the operand type and is the identity for fp32. GELU is exact,
// by erff (within 2 ulp), as the plain version's torch.erf. Replaces, for
// those calls, the TPU kernels of poseidon_tpu/ops/mlp.py: _fwd_kernel_dm
// (pallas_call in _call_fwd_dm) and _fwd_kernel (_call_fwd) in the forward
// entry; _bwd_kernel_dm (_call_bwd_dm), _bwd_kernel_fused and
// _bwd_kernel_emit (_call_bwd) in the backward one, whose outputs are
//   du = (dy . W2) gelu'(u);  dx = cast(cast(du) . W1);  dW1 = cast(du)^T . x
//   db1 = sum du;  dW2 = dy^T . g;  db2 = sum dy                  (fp32)
// The wrapper and the plain versions with the same rounding points
// (mlp_plain, mlp_bwd_plain) are in ops/mlp.py.
//
// The main loops, their plans and the backward's launches are in
// mlp_general.cuh (the design notes are there), which mlp_cln_general.cu
// shares; this file gives the forward its epilogue (StoreEpi: cast(sum +
// b2), or the F splits' partials summed with b2 by a second launch) and the
// entry points.

#include "mlp_general.cuh"

using namespace wgm;
using namespace mlp_gen;

namespace {

// The forward's plan (scratch bytes, or with `run` the launches).
template <typename T>
cudaError_t forward(const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* out, void* scratch, int M, int C, int F,
                    cudaStream_t st, bool run, long long* bytes) {
  const Geo g = geometry(C, F);
  return with_nw(g.NW, [&](auto nwc) {
    constexpr int NW = decltype(nwc)::value;
    RowPlan p;
    cudaError_t err = plan_fwd<T, NW, StoreEpi>(M, C, F, p);
    if (err != cudaSuccess) return err;
    const Scratch s = layout<T>(false, g, M, C, F, p, 0);
    if (bytes != nullptr) *bytes = s.total;
    if (!run) return cudaSuccess;
    const FwdArgs<T> a = fwd_args<T>(x, b2, out, scratch, s, p, C);
    if ((err = launch_fwd<T, NW>(a, StoreEpi{}, w1, w2, b1, C, F, g, p, st)) != cudaSuccess)
      return err;
    if (p.Z > 1) {
      const long long n = (long long)M * C;
      mlp_general_sum_splits<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
          a.part, p.Z, n, C, a.b2, nullptr, a.out);
      err = cudaGetLastError();
    }
    return err;
  });
}

}  // namespace

// Scratch bytes of a call: the forward (bwd == 0) or the backward with R
// row splits of its weight products.
extern "C" int mlp_general_scratch(int bwd, int M, int C, int F, int R, int fp32,
                                   long long* bytes) {
  if (!valid(M, C, F) || (bwd && R < 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bwd)
    err = fp32 ? backward<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, M, C, F, R, nullptr, false, bytes)
               : backward<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, M, C, F, R, nullptr, false, bytes);
  else
    err = fp32 ? forward<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M,
                                C, F, nullptr, false, bytes)
               : forward<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M,
                               C, F, nullptr, false, bytes);
  return (int)err;
}

// x (M, C), w1 (F, C), w2 (C, F), out (M, C) in bf16 (fp32 == 0) or fp32;
// b1 (F,), b2 (C,) fp32; scratch of mlp_general_scratch(0, ...) bytes.
extern "C" int mlp_general_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, void* scratch, int M, int C, int F,
                               int fp32, void* stream) {
  if (!valid(M, C, F)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fp32 ? forward<float>(x, w1, b1, w2, b2, out, scratch, M, C, F, s, true, nullptr)
                    : forward<bf16>(x, w1, b1, w2, b2, out, scratch, M, C, F, s, true, nullptr));
}

// The backward for the output cotangent dy (M, C): dx (M, C) in the
// operands' type and grads = [dW1 (F, C) | dW2 (C, F) | db1 (F) | db2 (C)]
// fp32; scratch of mlp_general_scratch(1, ..., R, ...) bytes; R row splits
// of the weight products (at most M / 16).
extern "C" int mlp_general_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* dy, void* dx, void* grads, void* scratch, int M, int C,
                               int F, int R, int fp32, void* stream) {
  if (!valid(M, C, F) || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fp32 ? backward<float>(x, w1, b1, w2, dy, dx, grads, scratch, M, C, F, R, s, true,
                                      nullptr)
                    : backward<bf16>(x, w1, b1, w2, dy, dx, grads, scratch, M, C, F, R, s, true,
                                     nullptr));
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// kernel 0-2 (forward, rows, weights) for fp32 or bf16 operands and the
// output width nw (one of NW_CLASSES), the shared memory of its plan at C =
// nw, F = 4 nw, M = 32768; kernel 6, the rows kernel whose two warpgroups
// split a step (nw = 192 only), at C = 192; kernels 3-5 (prep, sum of
// splits, reduce) take no shared memory and ignore nw.
extern "C" int mlp_general_info(int kernel, int fp32, int nw, int* out) {
  if (kernel < 0 || kernel > 6 || (kernel == 6 && nw != NWMAX)) return (int)cudaErrorInvalidValue;
  auto attrs = [&](const void* fn, int smem) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fn);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = smem;
    return err;
  };
  auto one = [&](auto t) {
    using T = decltype(t);
    if (kernel == 3) return attrs(reinterpret_cast<const void*>(mlp_general_prep<T>), 0);
    if (kernel == 4) return attrs(reinterpret_cast<const void*>(mlp_general_sum_splits<T>), 0);
    if (kernel == 5) return attrs(reinterpret_cast<const void*>(mlp_general_reduce), 0);
    return with_nw(nw, [&](auto nwc) {
      constexpr int NW = decltype(nwc)::value;
      constexpr int FTF = ft_fwd<T, NW>(), FTR = ft_rows<T, NW>();
      if (kernel == 2) {
        DwPlan q;
        const cudaError_t err = plan_dw<T>(NW, 32768, 1, q);
        if (err != cudaSuccess) return err;
        return attrs(reinterpret_cast<const void*>(mlp_general_dw_kernel<T, NW>), (int)q.smem);
      }
      RowPlan p;
      if (kernel == 0) {
        const void* fn =
            reinterpret_cast<const void*>(mlp_general_fwd_kernel<T, NW, FTF, StoreEpi>);
        const cudaError_t err =
            plan_rows<T>(fn, 1, NW, FTF, pieces<T, NW, FTF>(), 32768, NW, 4 * NW, p);
        return err != cudaSuccess ? err : attrs(fn, (int)p.smem);
      }
      const void* fn = reinterpret_cast<const void*>(mlp_general_rows_kernel<T, NW, FTR, 1>);
      const void* split = nullptr;
      if constexpr (can_split<NW>())
        split = reinterpret_cast<const void*>(mlp_general_rows_kernel<T, NW, FTR, 2>);
      const cudaError_t err =
          plan_rows<T>(fn, 2, NW, FTR, pieces<T, NW, FTR>(), 32768, NW, 4 * NW, p, split);
      return err != cudaSuccess ? err : attrs(kernel == 6 ? split : fn, (int)p.smem);
    });
  };
  return (int)(fp32 ? one(0.f) : one(bf16()));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
