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
// Bound on this card: 4 M C F FLOPs forward and, counting the recompute of
// o that the TPU kernel also makes, 12 M C F backward, on the tensor cores
// (fp32 as three tf32 products a product; the operands' bytes are far below
// the ridge at the ScOT widths).
//
// Design. The plan of a call is ops/mlp.py::tail_plan's, passed in as 8
// ints (plan[0]: the path).
//  - C <= 384, the row-tile path (mlp_cln_rows.cuh, where the design notes
//    are): a prologue lays out every weight slab the walks read as the byte
//    image of its shared-memory tile (tail_prep); one kernel takes 64 whole
//    rows a CTA (128 in the backward at C <= 96 where such tiles fill the
//    card), computes u, g and o, the norm and (forward) the residual, and
//    (backward) do, then dh, du and dx in a second walk, with
//    cast(du)^T, g^T, x^T and cast(do)^T for the weight products and the
//    per-warp partials of db1, db2, dscale and dshift; the general MLP's
//    weight kernel takes dW1 and dW2; one reduce sums the weight partials
//    and every per-warp sum in a fixed order (tail_reduce). No fp32
//    partials of o, no row kernel: 2 launches forward, 4 backward. u is
//    computed once a row forward and once more in the backward unless 64
//    rows of it fit in shared memory: 12 or 14 M C F FLOPs of products
//    backward, where the general MLP's loops made 14 at C <= 192 and 20 at
//    C = 384 (two column blocks, u and dh recomputed per block).
//  - Otherwise the general MLP's machinery (mlp_general.cuh) with the norm
//    as its epilogue: at C > 384; the forward at C <= 192 where 128-row
//    tiles fill the card without splitting F (128 rows a CTA, half the
//    weight bytes a row: the row-tile forward's 64 measured 2-32% slower
//    there, PERF.md); and the backward at fp32 C in (272, 384) off a
//    multiple of 16, where no row-tile layout fits. The norm's row
//    statistics need all C outputs of a row: where one column block holds
//    whole rows and F is not split the epilogue (ClnEpi) takes the norm in
//    registers (a row's values lie in one quad of lanes); otherwise the
//    forward kernel writes its fp32 sums, one partial per F split, and a
//    row kernel sums them in order, adds b2, rounds, and takes the norm and
//    the residual, a warp a row (mlp_cln_general_fwd_rows). Its backward
//    recomputes o's partials, takes do in a row kernel
//    (mlp_cln_general_bwd_rows), runs the general MLP backward with dy :=
//    cast(do) and the residual added before dx's one rounding, and reduces
//    the tiles' partials (mlp_cln_reduce.cuh).
// No atomics on either path: two calls give the same bits.
//
// What holds them back (times against the bound in PERF.md): the ring's
// items are small beside the products they feed (fp32 3xTF32 takes 8 bytes
// a weight value, and a 64-row CTA copies every slab from L2), each item's
// products end in a wait before its slot is released, and the A operands
// are split into tf32 parts at every fragment load.

#include "mlp_cln_reduce.cuh"
#include "mlp_cln_rows.cuh"
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

// ---------------------------------------------------------------------------
// The row-tile path (mlp_cln_rows.cuh): C <= 384, whole rows a CTA
// ---------------------------------------------------------------------------

// Scratch of the row-tile path: the item images, b1p and, for the backward,
// cast(du)^T, g^T, x^T, cast(do)^T, the per-warp partials of db1 and of
// (do | dy yhat | dy), and the weight kernel's partials.
struct RowsScratch {
  long long kind[4], b1p, dut, gt, xt, dot, db1p, cpart, partw, total;
};

template <typename T>
RowsScratch rows_scratch(const cln_rows::Layout& l, int M, int C, int F, int CPd, int R) {
  constexpr int EB = Fmt<T>::EB, PARTS = Fmt<T>::PARTS;
  RowsScratch s{};
  const long long ck = (long long)l.nsteps * l.nk * l.cstride;
  const long long pk = (long long)l.nsteps * l.np * l.pbytes;
  s.kind[0] = 0;
  s.kind[1] = ck;
  s.kind[2] = ck + pk;
  s.kind[3] = 2 * ck + pk;
  long long at = l.bwd ? 2 * (ck + pk) : ck + pk;
  at = (at + 255) / 256 * 256;
  s.b1p = carve(at, (long long)l.FP * 4);
  if (l.bwd) {
    s.dut = carve(at, (long long)l.FP * M * EB);
    s.gt = carve(at, (long long)l.FP * M * EB);
    s.xt = carve(at, (long long)PARTS * CPd * M * EB);
    s.dot = carve(at, (long long)PARTS * CPd * M * EB);
    s.db1p = carve(at, (long long)(M / 16) * l.FP * 4);
    s.cpart = carve(at, (long long)(M / 16) * 3 * C * 4);
    s.partw = carve(at, (long long)R * 2 * F * C * 4);
  }
  s.total = at;
  return s;
}

// The prologue of the row-tile path: the item images and b1p.
template <typename T>
cudaError_t launch_tail_prep(const void* w1, const void* w2, const void* b1, unsigned char* sc,
                             const RowsScratch& s, const cln_rows::Layout& l, int C, int F,
                             cudaStream_t st) {
  const long long n = (l.bwd ? 2 : 1) * ((long long)l.nsteps * l.nk * l.FS * l.KC +
                                         (long long)l.nsteps * l.np * l.CPo * l.kp) +
                      l.FP;
  const long long blocks = (n + 255) / 256;
  cln_rows::tail_prep<T><<<(unsigned)(blocks < 2368 ? blocks : 2368), 256, 0, st>>>(
      static_cast<const T*>(w1), static_cast<const T*>(w2), static_cast<const float*>(b1), sc,
      reinterpret_cast<float*>(sc + s.b1p), C, F, l);
  return cudaGetLastError();
}

// The row-tile kernel's launch: M / 64 CTAs, or (the backward at NH <= 96)
// M / 128 with two row tiles a CTA.
template <typename T, bool BWD>
cudaError_t launch_rows(const cln_rows::Args<T>& a, cudaStream_t st) {
  return with_nw(a.l.NH, [&](auto nhc) {
    constexpr int NH = decltype(nhc)::value;
    auto go = [&](auto kernel) {
      cudaError_t err = prepare_launch(reinterpret_cast<const void*>(kernel), (int)a.l.smem,
                                       cln_rows::THREADS, nullptr);
      if (err != cudaSuccess) return err;
      kernel<<<(unsigned)(a.M / (64 * a.l.RW)), cln_rows::THREADS, a.l.smem, st>>>(a);
      return cudaGetLastError();
    };
    if constexpr (BWD && NH <= 96) {
      if (a.l.RW == 2) return go(cln_rows::tail_rows_kernel<T, NH, true, true>);
    }
    if (a.l.RW != 1) return cudaErrorInvalidValue;
    return go(cln_rows::tail_rows_kernel<T, NH, BWD, false>);
  });
}

template <typename T>
cln_rows::Args<T> rows_args(const void* x, const void* b2, const void* scale, unsigned char* sc,
                            const RowsScratch& s, const cln_rows::Layout& l, int M, int C, int L,
                            float eps) {
  cln_rows::Args<T> a{};
  a.x = static_cast<const T*>(x);
  a.img = sc;
  for (int k = 0; k < 4; ++k) a.kind[k] = s.kind[k];
  a.b1p = reinterpret_cast<const float*>(sc + s.b1p);
  a.b2 = static_cast<const float*>(b2);
  a.scale = static_cast<const float*>(scale);
  a.M = M;
  a.C = C;
  a.L = L;
  a.amode = load_mode<T>(x, C);
  a.eps = eps;
  a.l = l;
  return a;
}

// The row-tile forward (scratch bytes, or with `run` its two launches).
template <typename T>
cudaError_t rows_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* scale, const void* shift, void* out,
                     void* scratch, int M, int C, int F, int L, float eps, const int* plan,
                     cudaStream_t st, bool run, long long* bytes) {
  cln_rows::Layout l;
  if (!cln_rows::make_layout<T>(C, F, plan, false, l) || M % (64 * l.RW))
    return cudaErrorInvalidValue;
  const RowsScratch s = rows_scratch<T>(l, M, C, F, 0, 0);
  if (bytes != nullptr) *bytes = s.total;
  if (!run) return cudaSuccess;
  if (!l.xres && reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorInvalidValue;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaError_t err = launch_tail_prep<T>(w1, w2, b1, sc, s, l, C, F, st);
  if (err != cudaSuccess) return err;
  cln_rows::Args<T> a = rows_args<T>(x, b2, scale, sc, s, l, M, C, L, eps);
  a.shift = static_cast<const float*>(shift);
  a.out = static_cast<T*>(out);
  return launch_rows<T, false>(a, st);
}

// The row-tile backward (scratch bytes, or with `run` its four launches:
// prologue, rows, weights, reduce).
template <typename T>
cudaError_t rows_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* scale, const void* dy, void* dx, void* grads,
                     void* cout, void* scratch, int M, int C, int F, int L, int R, float eps,
                     const int* plan, cudaStream_t st, bool run, long long* bytes) {
  cln_rows::Layout l;
  if (!cln_rows::make_layout<T>(C, F, plan, true, l) || M % (64 * l.RW))
    return cudaErrorInvalidValue;
  const Geo g = geometry(C, F);
  return with_nw(g.NW, [&](auto nwc) {
    constexpr int NW = decltype(nwc)::value;
    DwPlan q;
    cudaError_t err = plan_dw<T>(NW, M, R, q);
    if (err != cudaSuccess) return err;
    const RowsScratch s = rows_scratch<T>(l, M, C, F, g.CPo, q.R);
    if (bytes != nullptr) *bytes = s.total;
    if (!run) return cudaSuccess;
    if (!l.xres && reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorInvalidValue;
    unsigned char* sc = static_cast<unsigned char*>(scratch);
    if ((err = launch_tail_prep<T>(w1, w2, b1, sc, s, l, C, F, st)) != cudaSuccess) return err;
    cln_rows::Args<T> a = rows_args<T>(x, b2, scale, sc, s, l, M, C, L, eps);
    a.dy = static_cast<const T*>(dy);
    a.out = static_cast<T*>(dx);
    a.dut = reinterpret_cast<T*>(sc + s.dut);
    a.gt = reinterpret_cast<T*>(sc + s.gt);
    a.xt = reinterpret_cast<T*>(sc + s.xt);
    a.dot = reinterpret_cast<T*>(sc + s.dot);
    a.db1p = reinterpret_cast<float*>(sc + s.db1p);
    a.cpart = reinterpret_cast<float*>(sc + s.cpart);
    a.CPd = g.CPo;
    if ((err = launch_rows<T, true>(a, st)) != cudaSuccess) return err;
    DwArgs<T> d;
    d.dut = a.dut;
    d.gt = a.gt;
    d.xt = a.xt;
    d.dyt = a.dot;
    d.part = reinterpret_cast<float*>(sc + s.partw);
    d.F = F;
    d.C = C;
    d.CPo = g.CPo;
    d.Mp = M;
    d.MK = q.MK;
    d.chunks = q.chunks;
    d.NS = q.NS;
    d.SA = q.SA;
    d.abytes = q.abytes;
    d.slot = q.slot;
    auto dw = mlp_general_dw_kernel<T, NW>;
    if ((err = prepare_launch(reinterpret_cast<const void*>(dw), (int)q.smem, 256, nullptr)) !=
        cudaSuccess)
      return err;
    dw<<<dim3(g.FP / 64, g.blocks, q.R), 256, q.smem, st>>>(d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int B = M / L;
    const long long threads =
        ((2LL * F * C + 31) / 32 + F + C) * 32 + 2LL * B * C;
    cln_rows::tail_reduce<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        d.part, q.R, a.db1p, a.cpart, M / 16, F, l.FP, C, B, L / 16,
        static_cast<float*>(grads), static_cast<float*>(cout));
    return cudaGetLastError();
  });
}

// The plan's path: 1, the row-tile kernel; 0, the general MLP's loops.
template <typename T>
cudaError_t tail_forward(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                const void* scale, const void* shift, void* out, void* scratch, int M, int C,
                int F, int L, float eps, const int* plan, cudaStream_t st, bool run,
                long long* bytes) {
  if (plan[0] == 1)
    return rows_fwd<T>(x, w1, b1, w2, b2, scale, shift, out, scratch, M, C, F, L, eps, plan, st,
                       run, bytes);
  return tail_fwd<T>(x, w1, b1, w2, b2, scale, shift, out, scratch, M, C, F, L, eps, st, run,
                     bytes);
}

template <typename T>
cudaError_t tail_backward(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                const void* scale, const void* dy, void* dx, void* grads, void* cout,
                void* scratch, int M, int C, int F, int L, int R, float eps, const int* plan,
                cudaStream_t st, bool run, long long* bytes) {
  if (plan[0] == 1)
    return rows_bwd<T>(x, w1, b1, w2, b2, scale, dy, dx, grads, cout, scratch, M, C, F, L, R,
                       eps, plan, st, run, bytes);
  return tail_bwd<T>(x, w1, b1, w2, b2, scale, dy, dx, grads, cout, scratch, M, C, F, L, R, eps,
                     st, run, bytes);
}

bool valid_tail(int M, int C, int F, int L) {
  return valid(M, C, F) && L > 0 && L % 64 == 0 && M % L == 0;
}

}  // namespace

// Scratch bytes of a call: the forward (bwd == 0) or the backward with R
// row splits of its weight products, under plan (ops/mlp.py::tail_plan).
extern "C" int mlp_cln_general_scratch(int bwd, int M, int C, int F, int L, int R, int fp32,
                                       const int* plan, long long* bytes) {
  if (!valid_tail(M, C, F, L) || (bwd && R < 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bwd)
    err = fp32 ? tail_backward<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, M, C, F, L, R, 0.f, plan,
                              nullptr, false, bytes)
               : tail_backward<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, M, C, F, L, R, 0.f, plan,
                             nullptr, false, bytes);
  else
    err = fp32 ? tail_forward<float>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, M, C, F, L, 0.f, plan, nullptr, false, bytes)
               : tail_forward<bf16>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, M, C, F, L, 0.f, plan, nullptr, false, bytes);
  return (int)err;
}

// x (M, C) = (B, L, C), w1 (F, C), w2 (C, F), out (M, C) in bf16 (fp32 ==
// 0) or fp32; b1 (F,), b2 (C,), scale and shift (B, C) fp32; L % 64 == 0;
// scratch of mlp_cln_general_scratch(0, ...) bytes; plan as
// ops/mlp.py::tail_plan gives it.
extern "C" int mlp_cln_general_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* scale, const void* shift,
                                   void* out, void* scratch, int M, int C, int F, int L, float eps,
                                   int fp32, const int* plan, void* stream) {
  if (!valid_tail(M, C, F, L)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fp32 ? tail_forward<float>(x, w1, b1, w2, b2, scale, shift, out, scratch, M, C, F, L, eps,
                                   plan, s, true, nullptr)
                    : tail_forward<bf16>(x, w1, b1, w2, b2, scale, shift, out, scratch, M, C, F, L, eps,
                                  plan, s, true, nullptr));
}

// The backward for the output cotangent dy (M, C): dx (M, C) in the
// operands' type; grads = [dW1 (F, C) | dW2 (C, F) | db1 (F) | C floats the
// general MLP's path writes and the row-tile path leaves] and cout = [db2
// (C) | dscale (B, C) | dshift (B, C)] fp32; scratch of
// mlp_cln_general_scratch(1, ..., R, ...) bytes; R row splits of the weight
// products.
extern "C" int mlp_cln_general_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* scale, const void* dy, void* dx,
                                   void* grads, void* cout, void* scratch, int M, int C, int F,
                                   int L, int R, float eps, int fp32, const int* plan,
                                   void* stream) {
  if (!valid_tail(M, C, F, L) || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fp32 ? tail_backward<float>(x, w1, b1, w2, b2, scale, dy, dx, grads, cout, scratch, M, C,
                                   F, L, R, eps, plan, s, true, nullptr)
                    : tail_backward<bf16>(x, w1, b1, w2, b2, scale, dy, dx, grads, cout, scratch, M, C,
                                  F, L, R, eps, plan, s, true, nullptr));
}

// Dynamic shared-memory bytes of the row-tile kernel under plan (plan[0] ==
// 1, 8 ints), forward (bwd == 0) or backward: what ops/mlp.py::tail_plan
// expects.
extern "C" int mlp_cln_general_layout(int bwd, int C, int F, int fp32, const int* plan,
                                      long long* bytes) {
  if (plan[0] != 1 || C < 1 || C > MAX_C || F < 1 || F > MAX_F) return (int)cudaErrorInvalidValue;
  cln_rows::Layout l;
  const bool ok = fp32 ? cln_rows::make_layout<float>(C, F, plan, bwd != 0, l)
                       : cln_rows::make_layout<bf16>(C, F, plan, bwd != 0, l);
  if (!ok) return (int)cudaErrorInvalidValue;
  *bytes = l.smem;
  return 0;
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// kernel 0, the forward kernel under the tail's epilogue, at output width
// nw (one of mlp_general.cuh's NW_CLASSES; the plan at C = nw, F = 4 nw, M
// = 32768); 1 and 2, the forward's and the backward's row kernels at C =
// nw; 3, the reduce (no shared memory; nw ignored); the row-tile path's 4
// and 5, its kernel forward and backward at NH = nw (shared memory: 0, it is
// the plan's, mlp_cln_general_layout), 8 the backward with two row tiles a
// CTA (nw <= 96), 6 its prologue and 7 its reduce.
extern "C" int mlp_cln_general_info(int kernel, int fp32, int nw, int* out) {
  if (kernel < 0 || kernel > 8) return (int)cudaErrorInvalidValue;
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
    if (kernel == 6) return attrs(reinterpret_cast<const void*>(cln_rows::tail_prep<T>), 0);
    if (kernel == 7) return attrs(reinterpret_cast<const void*>(cln_rows::tail_reduce), 0);
    if (kernel >= 4 && kernel != 6 && kernel != 7)
      return with_nw(nw, [&](auto nhc) -> cudaError_t {
        constexpr int NH = decltype(nhc)::value;
        using cln_rows::tail_rows_kernel;
        if (kernel == 4) return attrs(reinterpret_cast<const void*>(tail_rows_kernel<T, NH, false, false>), 0);
        if (kernel == 5) return attrs(reinterpret_cast<const void*>(tail_rows_kernel<T, NH, true, false>), 0);
        if constexpr (NH <= 96)
          return attrs(reinterpret_cast<const void*>(tail_rows_kernel<T, NH, true, true>), 0);
        return cudaErrorInvalidValue;
      });
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
