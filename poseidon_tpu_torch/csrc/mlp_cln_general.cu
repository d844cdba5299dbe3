// Fused block tail, forward and backward, for the calls the bf16 Hopper
// tail kernels (mlp_cln.cu, mlp_cln_bwd.cu) do not take: fp32 operands, and
// any width C <= 1024 with any hidden width F <= 4096 in bf16 or fp32.
// sm_90a, plain C interface.
//
//   o   = cast(cast(gelu(x . W1^T + b1)) . W2^T + b2)              (fp32 accumulate)
//   mu  = mean_C o;  var = max(mean_C o^2 - mu^2, 0);  r = rsqrt(var + eps)
//   out = cast(x + cast(scale[b] * (o - mu) r + shift[b]))
//
// on a token-major (B, L, C) stream x, row m of image b = m / L, with the
// per-image fp32 scale and shift (B, C) (a drop-path keep mask already folded
// in by the caller); cast() rounds to the operand type and is the identity
// for fp32. The backward, for the output cotangent dy:
//
//   yhat = (o - mu) r;  dyh = dy * scale[b]
//   do   = r (dyh - mean_C dyh - yhat mean_C(dyh yhat))                 (fp32)
//   dscale[b] = sum over the image's rows of dy yhat;  dshift[b] = sum of dy
//   db2 = sum of do (fp32);  dW1, db1, dW2 and dx_mlp from cast(do) as the
//   MLP backward's dy;  dx = cast(dy + dx_mlp), rounded once
//
// Replaces, for those calls, the TPU kernels
// poseidon_tpu/ops/mlp.py::_fwd_kernel_dm_cln (pallas_call in
// _call_fwd_dm_cln) and ::_bwd_kernel_dm_cln (_call_bwd_dm_cln), with their
// rounding points. The wrapper and the plain versions (mlp_cln_plain,
// mlp_cln_bwd_plain) are in ops/mlp.py.
//
// Bound on this card: as the general MLP's (mlp_general.cuh), 4 M C F
// FLOPs forward and 12 M C F backward (o recomputed), on the tensor cores
// (fp32 as three tf32 products a product).
//
// Design: the general MLP's machinery (mlp_general.cuh) with the norm as its
// epilogue. The norm's row statistics need all C outputs of a row.
//  - Forward. Where one column block of the forward kernel holds whole rows
//    and F is not split across CTAs (C <= 192 and enough row tiles to fill
//    the card: ScOT-B stage 0, ScOT-T stages 0-1), the epilogue (ClnEpi)
//    takes the norm in registers: a row's values lie in one quad of lanes,
//    so quad shuffles give its sums, and x is read and out written there.
//    Otherwise (C > 192, or F split) the forward kernel writes its fp32
//    sums, one partial per F split, and a row kernel sums the partials in
//    order, adds b2, rounds, and takes the norm and the residual, a warp a
//    row (mlp_cln_general_fwd_rows).
//  - Backward, three stages in stream order, no atomics (two calls give the
//    same bits):
//    1. the forward kernel recomputes o's fp32 partials, and a row kernel
//       (mlp_cln_general_bwd_rows, a warp a row, 64 rows a CTA) takes the
//       statistics, yhat and do, writes cast(do) (M, C) and one fp32
//       partial per 64-row tile of db2, dscale and dshift (a tile lies in
//       one image: the wrapper checks L % 64 == 0);
//    2. the general MLP backward with dy := cast(do), the residual dy added
//       to its fp32 dx sum before the one rounding (in its rows kernel, or
//       under an F split in its sum of the splits); its own db2, the sum of
//       cast(do), is left unused: db2 is the fp32 sum of do;
//    3. a reduce of the tiles' partials in a fixed order
//       (mlp_cln_reduce.cuh): db2 over all tiles, dscale and dshift over
//       the tiles of each image.
// The partials of o cost 8 M C bytes (written and read once) beside the
// MLP's 4 M C F FLOPs: a few percent at the ScOT widths.

#include "mlp_cln_reduce.cuh"
#include "mlp_general.cuh"

using namespace wgm;
using namespace mlp_gen;

namespace {

// The forward kernel's epilogue for the tail. inreg: the grid's one column
// block holds whole rows and F is not split, and the norm and the residual
// are taken here; else the fp32 sum (one partial per F split) goes to the
// partials for a row kernel.
struct ClnEpi {
  const float* scale;  // (B, C)
  const float* shift;  // (B, C)
  int L;
  float eps;
  int inreg;

  template <typename T, int NW>
  __device__ __forceinline__ void store(const FwdArgs<T>& a, float* y, long long m0, int cb,
                                        int z) const {
    const Walk& w = a.w;
    if (!inreg) {
      store_acc<float, NW>(y, a.part + (long long)z * w.M * w.C, nullptr, w.M, w.C, m0, cb * NW);
      return;
    }
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, C = w.C;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const int c = acc_col(lane, i);
      const float o = c < C ? cast<T>(y[i] + __ldg(a.b2 + c)) : 0.f;
      y[i] = o;
      s1[(i % 4) / 2] += o;
      s2[(i % 4) / 2] += o * o;
    }
    float mu[2], rs[2];
    long long img[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s1[j] = mlp_fwd_tile::quad_sum(s1[j]);
      s2[j] = mlp_fwd_tile::quad_sum(s2[j]);
      mu[j] = s1[j] / C;
      rs[j] = rsqrtf(fmaxf(s2[j] / C - mu[j] * mu[j], 0.f) + eps);
      img[j] = (m0 + acc_row(warp, lane, 2 * j)) / L;
    }
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const int j = (i % 4) / 2, c = acc_col(lane, i);
      const long long m = m0 + acc_row(warp, lane, i);
      if (m >= w.M || c >= C) continue;
      const float v = cast<T>(__ldg(scale + img[j] * C + c) * ((y[i] - mu[j]) * rs[j]) +
                              __ldg(shift + img[j] * C + c));
      a.out[m * C + c] = from_f<T>(to_f(a.x[m * C + c]) + v);
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// Row m's o at the lane's columns c = lane + 32 k (zeros past C): the Z
// partials summed in order, plus b2, rounded; and the row's mean and
// rsqrt(var + eps). Every lane ends with the same statistics (a butterfly
// adds the same two values in either order).
template <typename T, int K>
__device__ __forceinline__ void row_o(const float* __restrict__ part, int Z, long long n,
                                      const float* __restrict__ b2, long long m, int C, float eps,
                                      float (&o)[K], float& mu, float& rs) {
  const int lane = threadIdx.x % 32;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    o[k] = 0.f;
    if (c < C) {
      float v = 0.f;
      for (int z = 0; z < Z; ++z) v += part[z * n + m * C + c];
      o[k] = cast<T>(v + __ldg(b2 + c));
      s1 += o[k];
      s2 += o[k] * o[k];
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  mu = s1 / C;
  rs = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + eps);
}

// The forward's norm and residual from the partials of o, a warp a row.
template <typename T, int K>
__global__ void __launch_bounds__(256) mlp_cln_general_fwd_rows(
    const float* __restrict__ part, int Z, const float* __restrict__ b2, const T* __restrict__ x,
    const float* __restrict__ scale, const float* __restrict__ shift, T* __restrict__ out, int M,
    int C, int L, float eps) {
  const long long m = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (m >= M) return;
  const int lane = threadIdx.x % 32;
  float o[K], mu, rs;
  row_o<T, K>(part, Z, (long long)M * C, b2, m, C, eps, o, mu, rs);
  const float* sc = scale + (m / L) * C;
  const float* sh = shift + (m / L) * C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      const float v = cast<T>(__ldg(sc + c) * ((o[k] - mu) * rs) + __ldg(sh + c));
      out[m * C + c] = from_f<T>(to_f(x[m * C + c]) + v);
    }
  }
}

// The backward's norm stage, 64 rows a CTA (M % 64 == 0), a warp 8 of them:
// cast(do) (M, C), and the tile's column sums of do, dy yhat and dy
// (cpart, (M / 64, 3, C)): each warp's in shared memory, a lane its own
// columns, then the eight warps' in order.
template <typename T, int K>
__global__ void __launch_bounds__(256) mlp_cln_general_bwd_rows(
    const float* __restrict__ part, int Z, const float* __restrict__ b2,
    const float* __restrict__ scale, const T* __restrict__ dy, T* __restrict__ dob,
    float* __restrict__ cpart, int M, int C, int L, float eps) {
  extern __shared__ float red[];  // 8 warps x (do | dy yhat | dy) x C
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mine = red + warp * 3 * C;
  for (int j = lane; j < 3 * C; j += 32) mine[j] = 0.f;
  __syncwarp();
  const long long n = (long long)M * C;
  for (int r = 0; r < 8; ++r) {
    const long long m = (long long)blockIdx.x * 64 + warp * 8 + r;
    float o[K], d[K], mu, rs;
    row_o<T, K>(part, Z, n, b2, m, C, eps, o, mu, rs);
    const float* sc = scale + (m / L) * C;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + 32 * k;
      d[k] = 0.f;
      if (c < C) {
        o[k] = (o[k] - mu) * rs;  // yhat
        d[k] = to_f(dy[m * C + c]);
        const float h = d[k] * __ldg(sc + c);
        m1 += h;
        m2 += h * o[k];
      }
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + 32 * k;
      if (c < C) {
        const float dv = rs * (d[k] * __ldg(sc + c) - m1 - o[k] * m2);
        dob[m * C + c] = from_f<T>(dv);
        mine[c] += dv;
        mine[C + c] += d[k] * o[k];
        mine[2 * C + c] += d[k];
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * C; j += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * 3 * C + j];
    cpart[(long long)blockIdx.x * 3 * C + j] = s;
  }
}

// The row kernels' values a lane holds: K x 32 >= C.
template <class Fn>
cudaError_t with_k(int C, Fn f) {
  if (C <= 128) return f(std::integral_constant<int, 4>{});
  if (C <= 256) return f(std::integral_constant<int, 8>{});
  if (C <= 512) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 32>{});
}

// Shared memory of the backward's row kernel.
inline int bwd_rows_smem(int C) { return 8 * 3 * C * 4; }

// The forward's plan (scratch bytes, or with `run` the launches).
template <typename T>
cudaError_t tail_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* scale, const void* shift, void* out,
                     void* scratch, int M, int C, int F, int L, float eps, cudaStream_t st,
                     bool run, long long* bytes) {
  const Geo g = geometry(C, F);
  return with_nw(g.NW, [&](auto nwc) {
    constexpr int NW = decltype(nwc)::value;
    RowPlan p;
    cudaError_t err = plan_fwd<T, NW, ClnEpi>(M, C, F, p);
    if (err != cudaSuccess) return err;
    const bool inreg = g.blocks == 1 && p.Z == 1;
    const Scratch s = layout<T>(false, g, M, C, F, p, 0, !inreg);
    if (bytes != nullptr) *bytes = s.total;
    if (!run) return cudaSuccess;
    const FwdArgs<T> a = fwd_args<T>(x, b2, out, scratch, s, p, C);
    const ClnEpi e{static_cast<const float*>(scale), static_cast<const float*>(shift), L, eps,
                   inreg ? 1 : 0};
    if ((err = launch_fwd<T, NW>(a, e, w1, w2, b1, C, F, g, p, st)) != cudaSuccess || inreg)
      return err;
    return with_k(C, [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      mlp_cln_general_fwd_rows<T, K><<<(unsigned)cdiv(M, 8), 256, 0, st>>>(
          a.part, p.Z, a.b2, a.x, e.scale, e.shift, a.out, M, C, L, eps);
      return cudaGetLastError();
    });
  });
}

// The backward's plan (scratch bytes, or with `run` the launches).
template <typename T>
cudaError_t tail_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* scale, const void* dy, void* dx, void* grads,
                     void* cout, void* scratch, int M, int C, int F, int L, int R, float eps,
                     cudaStream_t st, bool run, long long* bytes) {
  const Geo g = geometry(C, F);
  return with_nw(g.NW, [&](auto nwc) {
    constexpr int NW = decltype(nwc)::value;
    RowPlan p;
    cudaError_t err = plan_fwd<T, NW, ClnEpi>(M, C, F, p);
    if (err != cudaSuccess) return err;
    // The forward's weight copies and partials of o | cast(do) | the tiles'
    // partials | the MLP backward's scratch.
    const Scratch s = layout<T>(false, g, M, C, F, p, 0, true);
    long long at = s.total;
    const long long odob = carve(at, (long long)M * C * Fmt<T>::EB);
    const long long ocpart = carve(at, (long long)(M / 64) * 3 * C * 4);
    long long mlp_bytes = 0;
    if ((err = mlp_gen::backward<T>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, M, C, F, R, st, false, &mlp_bytes)) !=
        cudaSuccess)
      return err;
    if (bytes != nullptr) *bytes = at + mlp_bytes;
    if (!run) return cudaSuccess;
    unsigned char* sc = static_cast<unsigned char*>(scratch);
    T* dob = reinterpret_cast<T*>(sc + odob);
    float* cpart = reinterpret_cast<float*>(sc + ocpart);
    const FwdArgs<T> a = fwd_args<T>(x, b2, nullptr, scratch, s, p, C);
    const ClnEpi e{static_cast<const float*>(scale), nullptr, L, eps, 0};
    if ((err = launch_fwd<T, NW>(a, e, w1, w2, b1, C, F, g, p, st)) != cudaSuccess) return err;
    err = with_k(C, [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      auto kernel = mlp_cln_general_bwd_rows<T, K>;
      const cudaError_t e2 = prepare_launch(reinterpret_cast<const void*>(kernel),
                                            bwd_rows_smem(C), 256, nullptr);
      if (e2 != cudaSuccess) return e2;
      kernel<<<(unsigned)(M / 64), 256, bwd_rows_smem(C), st>>>(
          a.part, p.Z, a.b2, e.scale, static_cast<const T*>(dy), dob, cpart, M, C, L, eps);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
    if ((err = mlp_gen::backward<T>(x, w1, b1, w2, dob, dx, grads, sc + at, M, C, F, R, st, true,
                                    nullptr, dy)) != cudaSuccess)
      return err;
    return mlp_cln_reduce::reduce(cpart, static_cast<float*>(cout), M, C, L, st);
  });
}

bool valid_tail(int M, int C, int F, int L) {
  return valid(M, C, F) && L > 0 && L % 64 == 0 && M % L == 0;
}

}  // namespace

// Scratch bytes of a call: the forward (bwd == 0) or the backward with R
// row splits of its weight products.
extern "C" int mlp_cln_general_scratch(int bwd, int M, int C, int F, int L, int R, int fp32,
                                       long long* bytes) {
  if (!valid_tail(M, C, F, L) || (bwd && R < 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bwd)
    err = fp32 ? tail_bwd<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, M, C, F, L, R, 0.f, nullptr,
                                 false, bytes)
               : tail_bwd<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, M, C, F, L, R, 0.f, nullptr,
                                false, bytes);
  else
    err = fp32 ? tail_fwd<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, M, C, F, L, 0.f, nullptr, false, bytes)
               : tail_fwd<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, M, C, F, L, 0.f, nullptr, false, bytes);
  return (int)err;
}

// x (M, C) = (B, L, C), w1 (F, C), w2 (C, F), out (M, C) in bf16 (fp32 ==
// 0) or fp32; b1 (F,), b2 (C,), scale and shift (B, C) fp32; L % 64 == 0;
// scratch of mlp_cln_general_scratch(0, ...) bytes.
extern "C" int mlp_cln_general_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* scale, const void* shift,
                                   void* out, void* scratch, int M, int C, int F, int L, float eps,
                                   int fp32, void* stream) {
  if (!valid_tail(M, C, F, L)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fp32 ? tail_fwd<float>(x, w1, b1, w2, b2, scale, shift, out, scratch, M, C, F, L,
                                      eps, s, true, nullptr)
                    : tail_fwd<bf16>(x, w1, b1, w2, b2, scale, shift, out, scratch, M, C, F, L,
                                     eps, s, true, nullptr));
}

// The backward for the output cotangent dy (M, C): dx (M, C) in the
// operands' type; grads = [dW1 (F, C) | dW2 (C, F) | db1 (F) | the sum of
// cast(do), unused] and cout = [db2 (C) | dscale (B, C) | dshift (B, C)]
// fp32; scratch of mlp_cln_general_scratch(1, ..., R, ...) bytes; R row
// splits of the weight products.
extern "C" int mlp_cln_general_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* scale, const void* dy, void* dx,
                                   void* grads, void* cout, void* scratch, int M, int C, int F,
                                   int L, int R, float eps, int fp32, void* stream) {
  if (!valid_tail(M, C, F, L) || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fp32 ? tail_bwd<float>(x, w1, b1, w2, b2, scale, dy, dx, grads, cout, scratch, M,
                                      C, F, L, R, eps, s, true, nullptr)
                    : tail_bwd<bf16>(x, w1, b1, w2, b2, scale, dy, dx, grads, cout, scratch, M, C,
                                     F, L, R, eps, s, true, nullptr));
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// kernel 0, the forward kernel under the tail's epilogue, at output width
// nw (one of mlp_general.cuh's NW_CLASSES; the plan at C = nw, F = 4 nw, M
// = 32768); 1 and 2, the forward's and the backward's row kernels at C =
// nw; 3, the reduce (no shared memory; nw ignored).
extern "C" int mlp_cln_general_info(int kernel, int fp32, int nw, int* out) {
  if (kernel < 0 || kernel > 3) return (int)cudaErrorInvalidValue;
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
    if (kernel == 3) return attrs(reinterpret_cast<const void*>(mlp_cln_reduce::reduce_kernel), 0);
    if (kernel == 0)
      return with_nw(nw, [&](auto nwc) {
        constexpr int NW = decltype(nwc)::value, FT = ft_fwd<T, NW>();
        RowPlan p;
        const cudaError_t err = plan_fwd<T, NW, ClnEpi>(32768, NW, 4 * NW, p);
        return err != cudaSuccess
                   ? err
                   : attrs(reinterpret_cast<const void*>(mlp_general_fwd_kernel<T, NW, FT, ClnEpi>),
                           (int)p.smem);
      });
    if (nw < 1 || nw > MAX_C) return cudaErrorInvalidValue;
    return with_k(nw, [&](auto kc) {
      constexpr int K = decltype(kc)::value;
      return kernel == 1
                 ? attrs(reinterpret_cast<const void*>(mlp_cln_general_fwd_rows<T, K>), 0)
                 : attrs(reinterpret_cast<const void*>(mlp_cln_general_bwd_rows<T, K>),
                         bwd_rows_smem(nw));
    });
  };
  return (int)(fp32 ? one(0.f) : one(bf16()));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
