// Fused block MLP backward for Hopper (sm_90a): the kernels and their
// launch, shared by the MLP backward (mlp_bwd.cu) and the fused block tail's
// backward (mlp_cln_bwd.cu).
//
//   u = x . W1^T + b1;  du = (dy . W2) * gelu'(u);  g = bf16(gelu(u))
//   dx = bf16( bf16(du) . W1 [+ resid] );  dW1 = bf16(du)^T . x;  db1 = sum du
//   dW2 = dy^T . g;  db2 = sum dy              (fp32 accumulation and sums)
//
// on token-major (M, C) bf16 rows, C in {48, 96, 192, 384}, with the
// PyTorch Linear weights as they are: W1 (F, C), W2 (C, F) bf16, b1 (F,)
// fp32; dW1 (F, C), dW2 (C, F), db1, db2 fp32, summed over all M rows.
// resid, an optional (M, C) bf16 operand, is added to the fp32 dx sum before
// its one rounding: the fused block tail's residual path (mlp_cln_bwd.cu).
// Replaces the TPU kernels poseidon_tpu/ops/mlp.py::_bwd_kernel_dm (D-major,
// ScOT-T/S/B stages 0-1), ::_bwd_kernel_fused and ::_bwd_kernel_emit
// (token-major row tiles; the emit variant hands du and g to XLA for the dW
// products, which this kernel does itself): one kernel computes the function
// of all three. The GELU and its derivative share one erf and one
// exponential (mlp_tile.cuh). The wrapper and the plain PyTorch version with
// the same rounding points are in ops/mlp.py.
//
// Bound on this card. Per row the kernel reads 2C bf16 values and writes C,
// and does 10*C*F FLOPs (u, dh, dx, dW1, dW2; recomputing u included), 40C
// FLOPs per byte: over the H100's ~295 FLOP/B ridge at every C. So the
// tensor cores bound it as long as the (M, F) hidden state and its gradient
// stay on chip, which they do here. The GELU and its derivative (about 25
// fp32 lane operations per hidden value and row) are a second floor, above
// the tensor one at C = 48; this kernel computes them twice (see below),
// which puts its own ALU work above the tensor bound at C <= 96.
//
// Design. Blocks run in no order, and dx sums over F while dW sums over
// rows, so one launch holds two kinds of CTA (two warpgroups each), which
// both recompute u and dh; all five products are wgmma:
//  - a dW CTA (the first blocks of the grid, so that the longer CTAs start
//    first) takes one 64-wide step of F, one chunk of CC output columns (C,
//    or 192 at C = 384) and one of R splits of the rows, and holds its W1
//    and W2 slabs in shared memory. It walks row groups of RT rows (128; 64
//    at C = 384), staged by cp.async (double-buffered where they fit). Per
//    group each warpgroup computes u = x W1^T and dh = dy W2 for its part
//    (its own 64 rows, or at C = 384 half of the hidden step), then du,
//    bf16(du) and g in registers, which it stores transposed (hidden index
//    by rows) into shared memory. Then warpgroup 0 adds bf16(du)^T x to the
//    dW1 slab and warpgroup 1 adds g^T dy to the dW2^T slab (F on wgmma's M,
//    the rows the reduction index), each in registers (CC/2 a thread). db1
//    (the fp32 du) and db2 (dy) are summed by columns. Zero-filled rows add
//    nothing: x = dy = 0 gives du = 0 and dy^T g = 0. It writes its part of
//    one fp32 partial per split.
//  - a dx CTA takes 128 rows (one 64-row tile a warpgroup; at C = 384 64
//    rows, the two warpgroups splitting the dx columns) and walks F in steps
//    of FT (64; 32 at C >= 192) through the forward's ring of weight slabs
//    (mlp_tile.cuh). Per step: u and dh by wgmma, du in registers, and
//    dx += bf16(du) W1 with du as the register A operand, so neither du nor
//    g touches shared memory; the dx sum stays in registers.
// Operands read transposed (W2 in dh, W1 in dx, x and dy in dW) use
// wgmma's transpose bits on the tiles as they are staged (desc_mn in
// wgmma.cuh): a slab or row tile lands once, by cp.async, and serves every
// product. A reduce kernel then sums the R partials in a fixed order: no
// atomics, so two calls give the same bits.

#pragma once

#include "mlp_tile.cuh"

// MLP_BWD_VARIANT selects a diagnostic build that leaves out part of the
// work, to show where the time goes (ops/mlp_bwd_variants.py times them;
// its results are wrong by design): 1, the dW CTAs take du = g = 0 instead
// of recomputing u, dh and the GELU, which is the work a design computing
// them once per (row tile, F step) would not repeat; 2, the dx CTAs alone;
// 3, the dW CTAs alone. 0, the kernel itself, unless the flag is given.
#ifndef MLP_BWD_VARIANT
#define MLP_BWD_VARIANT 0
#endif

namespace mlp_bwd_tile {

using namespace mlp_fwd_tile;

constexpr int THREADS = 256;

template <int C>
struct Plan {
  static constexpr int AK = Atom<C>::AK;
  // dx CTAs
  static constexpr int FT = C >= 192 ? 32 : 64;
  static constexpr int XWGS = C == 384 ? 2 : 1;  // warpgroups per row tile
  static constexpr int XNW = C / XWGS;            // dx columns per warpgroup
  static constexpr int XROWS = 64 * 2 / XWGS;     // rows per dx CTA
  static constexpr int NS = C == 384 ? 2 : 3;
  static constexpr uint32_t xx_off = 0;                              // XROWS x C bf16
  static constexpr uint32_t xdy_off = XROWS * C * 2;                 // XROWS x C bf16
  static constexpr uint32_t xring_off = align1k(2 * XROWS * C * 2);
  static constexpr uint32_t dx_bytes = xring_off + NS * Ring<C, FT>::STAGE;
  // dW CTAs
  static constexpr int CC = C == 384 ? 192 : C;  // dW columns per CTA
  static constexpr int RT = C == 384 ? 64 : 128;  // rows per group
  static constexpr int UN = RT == 128 ? 64 : 32;  // hidden columns of u a warpgroup computes
  static constexpr int NB = C <= 96 ? 2 : 1;      // row-group buffers
  static constexpr uint32_t ROWBUF = 2 * RT * C * 2;  // x and dy of a group
  static constexpr uint32_t w_off = 0;                              // W1 | W2 slabs, 64 wide
  static constexpr uint32_t rows_off = align1k(Ring<C, 64>::STAGE);
  static constexpr uint32_t dut_off = rows_off + NB * ROWBUF;       // 64 x RT bf16
  static constexpr uint32_t gt_off = dut_off + 64 * RT * 2;         // 64 x RT bf16
  static constexpr uint32_t dw_bytes = gt_off + 64 * RT * 2;
  static constexpr uint32_t bytes = dx_bytes > dw_bytes ? dx_bytes : dw_bytes;
  static_assert(ROWBUF % 1024 == 0 && (64 * RT * 2) % 1024 == 0, "tiles on 1024-byte boundaries");
  static_assert(8 * 64 * 4 <= 2 * 64 * RT * 2, "db1 scratch");
  static_assert((THREADS / (CC / 8)) * CC * 4 <= ROWBUF, "db2 scratch");
  static_assert(bytes <= 232448, "shared memory");
};

// The dx CTA: rows m0..m0+XROWS.
template <int C>
__device__ __forceinline__ void dx_cta(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                       const float* __restrict__ b1, const bf16* __restrict__ w2,
                                       const bf16* __restrict__ dy, const bf16* __restrict__ resid,
                                       bf16* __restrict__ dx, unsigned char* smem, long long m0,
                                       int M, int F) {
  using P = Plan<C>;
  constexpr int FT = P::FT, NS = P::NS, AK = P::AK, XR = P::XROWS;
  constexpr uint32_t STAGE = Ring<C, FT>::STAGE, W1 = Ring<C, FT>::W1;
  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = P::XWGS == 1 ? 64 * wgi : 0;      // the warpgroup's rows in the tile
  const int n0 = P::XWGS == 1 ? 0 : wgi * P::XNW;  // and dx columns
  const uint32_t ax = smem_addr(smem + P::xx_off), ady = smem_addr(smem + P::xdy_off);
  const uint32_t ring = smem_addr(smem + P::xring_off);
  const int steps = F / FT;

  load_rows<C, XR>(x, ax, m0, M, tid, THREADS);
  load_rows<C, XR>(dy, ady, m0, M, tid, THREADS);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) load_slab<C, FT>(w1, w2, ring + s * STAGE, s * FT, F, tid, THREADS);
    cp_async_commit();
  }
  float acc[P::XNW / 2];
#pragma unroll
  for (int i = 0; i < P::XNW / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NS - 2>();
    fence_async_smem();
    __syncthreads();  // step s's slabs landed; every warpgroup is done with step s-1's
    if (s + NS - 1 < steps)
      load_slab<C, FT>(w1, w2, ring + ((s + NS - 1) % NS) * STAGE, (s + NS - 1) * FT, F, tid,
                       THREADS);
    cp_async_commit();
    const uint32_t st = ring + (s % NS) * STAGE;
    const int f0 = s * FT;

    // u = x W1^T (B: the W1 slab, K-major); dh = dy W2 (B: the W2 slab, C
    // rows by FT, read N-major).
    float u[FT / 2], dh[FT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      Mma<FT>::ss(u, desc<AK>(ax, r0, 16 * kk, XR), desc<AK>(st, 0, 16 * kk, FT), kk > 0);
      Mma<FT>::template ss<0, 1>(dh, desc<AK>(ady, r0, 16 * kk, XR),
                                 desc_mn<FT>(st + W1, 16 * kk, 0, C), kk > 0);
    }
    wgmma_commit();
    float bias[FT / 4];
#pragma unroll
    for (int j = 0; j < FT / 4; ++j) bias[j] = __ldg(b1 + f0 + acc_col(lane, 4 * (j / 2) + j % 2));
    wgmma_wait<0>();
    fence_regs<FT / 2>(u);
    fence_regs<FT / 2>(dh);

    uint32_t a[FT / 16][4];
#pragma unroll
    for (int i = 0; i < FT / 2; ++i) {
      float g;
      dh[i] *= gelu_grad(u[i] + bias[(i / 4) * 2 + i % 2], g);
    }
#pragma unroll
    for (int kk = 0; kk < FT / 16; ++kk) a_frag(dh, kk, a[kk]);
    // dx += bf16(du) W1 (B: the W1 slab, FT rows by C, read N-major).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FT / 16; ++kk)
      Mma<P::XNW>::template rs<1>(acc, a[kk], desc_mn<AK>(st, 16 * kk, n0, FT), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<P::XNW / 2>(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < P::XNW / 2; i += 2) {
    const long long row = m0 + r0 + acc_row(warp, lane, i);
    if (row >= M) continue;
    const long long at = row * C + n0 + acc_col(lane, i);
    float v0 = acc[i], v1 = acc[i + 1];
    if (resid != nullptr) {
      const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + at));
      v0 += r.x;
      v1 += r.y;
    }
    *reinterpret_cast<uint32_t*>(dx + at) = pack2(v0, v1);
  }
}

// The dW CTA: F step fc (64 wide), column chunk cc, split r of the row
// groups; writes its part of split r's partial dW1 (F, C) | dW2 (C, F) |
// db1 (F) | db2 (C).
template <int C>
__device__ __forceinline__ void dw_cta(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                       const float* __restrict__ b1, const bf16* __restrict__ w2,
                                       const bf16* __restrict__ dy, float* __restrict__ dst,
                                       unsigned char* smem, int fc, int cc, int g0, int g1, int M,
                                       int F) {
  using P = Plan<C>;
  constexpr int AK = P::AK, RT = P::RT, UN = P::UN, CC = P::CC, NB = P::NB;
  constexpr uint32_t W1 = Ring<C, 64>::W1;
  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int f0 = fc * 64, c0 = cc * CC;
  // The warpgroup's part of u and dh: its own 64 rows, or half the step.
  const int ur0 = RT == 128 ? 64 * wgi : 0, uf0 = RT == 128 ? 0 : 32 * wgi;
  const uint32_t aw = smem_addr(smem + P::w_off), arows = smem_addr(smem + P::rows_off);
  const uint32_t adut = smem_addr(smem + P::dut_off), agt = smem_addr(smem + P::gt_off);
  unsigned char* sdut = smem + P::dut_off;
  unsigned char* sgt = smem + P::gt_off;
  const bool sum_db2 = fc == 0, sum_db1 = cc == 0;

  // The W2 slab in atoms of UN, so that each warpgroup's half starts an atom.
  load_slab<C, 64, UN>(w1, w2, aw, f0, F, tid, THREADS);
  if (g0 < g1) {
    load_rows<C, RT>(x, arows, (long long)g0 * RT, M, tid, THREADS);
    load_rows<C, RT>(dy, arows + RT * C * 2, (long long)g0 * RT, M, tid, THREADS);
  }
  cp_async_commit();

  float acc[CC / 2];
#pragma unroll
  for (int i = 0; i < CC / 2; ++i) acc[i] = 0.f;
  float db1[UN / 4];
#pragma unroll
  for (int j = 0; j < UN / 4; ++j) db1[j] = 0.f;
  float bias[UN / 4];
#pragma unroll
  for (int j = 0; j < UN / 4; ++j)
    bias[j] = __ldg(b1 + f0 + uf0 + acc_col(lane, 4 * (j / 2) + j % 2));
  // db2: thread (dph, dv) sums columns c0 + 8 dv.. over rows dph, dph + PH, ...
  constexpr int VG = CC / 8, PH = THREADS / VG;
  const int dv = tid % VG, dph = tid / VG;
  float db2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) db2[e] = 0.f;

  for (int g = g0; g < g1; ++g) {
    const int buf = NB == 2 ? (g - g0) % 2 : 0;
    if (NB == 2) {
      if (g + 1 < g1) {
        const uint32_t nb = arows + ((g + 1 - g0) % 2) * P::ROWBUF;
        load_rows<C, RT>(x, nb, (long long)(g + 1) * RT, M, tid, THREADS);
        load_rows<C, RT>(dy, nb + RT * C * 2, (long long)(g + 1) * RT, M, tid, THREADS);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();  // the group's rows (and the slabs) landed
    const uint32_t ax = arows + buf * P::ROWBUF, ady = ax + RT * C * 2;

    float u[UN / 2], dh[UN / 2];
    wgmma_fence();
#if MLP_BWD_VARIANT == 1
#pragma unroll
    for (int i = 0; i < UN / 2; ++i) u[i] = dh[i] = 0.f;
#else
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      Mma<UN>::ss(u, desc<AK>(ax, ur0, 16 * kk, RT), desc<AK>(aw, uf0, 16 * kk, 64), kk > 0);
      Mma<UN>::template ss<0, 1>(dh, desc<AK>(ady, ur0, 16 * kk, RT),
                                 desc_mn<UN>(aw + W1, 16 * kk, uf0, C), kk > 0);
    }
#endif
    wgmma_commit();
    if (sum_db2 && dph < PH) {  // db2 from the staged dy rows while the products run
      const unsigned char* sdy = smem + P::rows_off + buf * P::ROWBUF + RT * C * 2;
      for (int r = dph; r < RT; r += PH) {
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(sdy + tile_off<AK>(r, c0 + 8 * dv, RT)), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) db2[e] += v[e];
      }
    }
    wgmma_wait<0>();
    fence_regs<UN / 2>(u);
    fence_regs<UN / 2>(dh);

    // du (fp32 for db1), then bf16(du) and g stored hidden-major: row f of
    // the transposed tiles, the group's rows contiguous (K-major for dW).
#pragma unroll
    for (int i = 0; i < UN / 2; ++i) {
#if MLP_BWD_VARIANT == 1
      const float gv = 0.f, du = 0.f;
#else
      float gv;
      const float du = dh[i] * gelu_grad(u[i] + bias[(i / 4) * 2 + i % 2], gv);
#endif
      db1[(i / 4) * 2 + i % 2] += du;
      const int f = uf0 + acc_col(lane, i), r = ur0 + acc_row(warp, lane, i);
      const uint32_t o = tile_off<64>(f, r, 64);
      *reinterpret_cast<bf16*>(sdut + o) = __float2bfloat16(du);
      *reinterpret_cast<bf16*>(sgt + o) = __float2bfloat16(gv);
    }
    fence_async_smem();
    __syncthreads();  // both warpgroups' du and g are staged

    // Warpgroup 0: dW1 += bf16(du)^T x; warpgroup 1: dW2^T += g^T dy (B: the
    // row tiles' chunk columns, read N-major).
    const uint32_t aa = wgi == 0 ? adut : agt, ab = wgi == 0 ? ax : ady;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RT / 16; ++kk)
      Mma<CC>::template ss<0, 1>(acc, desc<64>(aa, 0, 16 * kk, 64),
                                 desc_mn<AK>(ab, 16 * kk, c0, RT), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<CC / 2>(acc);
    __syncthreads();  // the products are done with the transposed tiles and the rows
    if (NB == 1 && g + 1 < g1) {
      load_rows<C, RT>(x, arows, (long long)(g + 1) * RT, M, tid, THREADS);
      load_rows<C, RT>(dy, arows + RT * C * 2, (long long)(g + 1) * RT, M, tid, THREADS);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // dW1 rows f0.., columns c0.. (float pairs); dW2 = (dW2^T)^T.
#pragma unroll
  for (int i = 0; i < CC / 2; i += 2) {
    const int f = f0 + acc_row(warp, lane, i), c = c0 + acc_col(lane, i);
    if (wgi == 0) {
      *reinterpret_cast<float2*>(dst + (long long)f * C + c) = make_float2(acc[i], acc[i + 1]);
    } else {
      dst[(long long)F * C + (long long)c * F + f] = acc[i];
      dst[(long long)F * C + (long long)(c + 1) * F + f] = acc[i + 1];
    }
  }
  // db2 and db1: partials through shared memory (over the row buffers and
  // the transposed tiles), summed in a fixed order.
  float* dred = reinterpret_cast<float*>(smem + P::rows_off);  // PH x CC fp32
  float* bred = reinterpret_cast<float*>(sdut);                // 8 x 64 fp32
  if (sum_db2 && dph < PH) {
#pragma unroll
    for (int e = 0; e < 8; ++e) dred[dph * CC + 8 * dv + e] = db2[e];
  }
  if (sum_db1) {
    // The thread's columns summed over its rows, then over the 8 lanes of a
    // column; warps and warpgroups below.
#pragma unroll
    for (int j = 0; j < UN / 4; ++j) {
      const float s = column_sum(db1[j]);
      if (lane < 4) bred[(wgi * 4 + warp) * 64 + uf0 + acc_col(lane, 4 * (j / 2) + j % 2)] = s;
    }
  }
  __syncthreads();
  if (sum_db2 && tid < CC) {
    float s = 0.f;
    for (int p = 0; p < PH; ++p) s += dred[p * CC + tid];
    dst[2LL * F * C + F + c0 + tid] = s;
  }
  if (sum_db1 && tid < 64) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w)
      if (RT == 128 || w / 4 == tid / 32) s += bred[w * 64 + tid];
    dst[2LL * F * C + f0 + tid] = s;
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const bf16* __restrict__ dy, const bf16* __restrict__ resid,
               bf16* __restrict__ dx, float* __restrict__ part, int M, int F, int R) {
  using P = Plan<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int nfc = F / 64, ncc = C / P::CC;
  const int groups = (M + P::RT - 1) / P::RT;
  const int n_dw = nfc * ncc * R;
  const int b = (int)blockIdx.x;
  if ((MLP_BWD_VARIANT == 2 && b < n_dw) || (MLP_BWD_VARIANT == 3 && b >= n_dw)) return;
  if (b >= n_dw) {
    dx_cta<C>(x, w1, b1, w2, dy, resid, dx, smem, (long long)(b - n_dw) * P::XROWS, M, F);
    return;
  }
  const int fc = b % nfc, cc = (b / nfc) % ncc, r = b / (nfc * ncc);
  const int g0 = (int)((long long)r * groups / R), g1 = (int)((long long)(r + 1) * groups / R);
  const long long n_out = 2LL * F * C + F + C;
  dw_cta<C>(x, w1, b1, w2, dy, part + (long long)r * n_out, smem, fc, cc, g0, g1, M, F);
}

__global__ void mlp_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      long long n_out, int R) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += part[r * n_out + i];
  out[i] = s;
}

template <int C>
cudaError_t launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                   const bf16* dy, const bf16* resid, bf16* dx, float* grads, float* part,
                   int M, int F, int R, cudaStream_t stream) {
  using P = Plan<C>;
  if (R > (M + P::RT - 1) / P::RT) return cudaErrorInvalidValue;
  auto kernel = mlp_bwd_kernel<C>;
  cudaError_t err =
      prepare_launch(reinterpret_cast<const void*>(kernel), (int)P::bytes, THREADS, nullptr);
  if (err != cudaSuccess) return err;
  const int n_dw = (F / 64) * (C / P::CC) * R;
  const int n_dx = (M + P::XROWS - 1) / P::XROWS;
  kernel<<<n_dw + n_dx, THREADS, P::bytes, stream>>>(x, w1, b1, w2, dy, resid, dx, part, M, F,
                                                      R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_out = 2LL * F * C + F + C;
  mlp_bwd_reduce_kernel<<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(part, grads, n_out, R);
  return cudaGetLastError();
}

// The backward for width C. grads gets dW1 (F, C) | dW2 (C, F) | db1 | db2
// and part holds the R row splits' partials (R at most the row groups:
// ceil(M / 128), ceil(M / 64) at C = 384).
inline cudaError_t run(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                       const bf16* dy, const bf16* resid, bf16* dx, float* grads, float* part,
                       int M, int C, int F, int R, cudaStream_t st) {
  if (M <= 0 || F <= 0 || F % 64 || R <= 0) return cudaErrorInvalidValue;
  return dispatch(C, [&](auto w) {
    return launch<decltype(w)::C>(x, w1, b1, w2, dy, resid, dx, grads, part, M, F, R, st);
  });
}

// Registers, spill bytes and dynamic shared-memory bytes of width c.
inline cudaError_t info(int c, int* out) {
  return dispatch(c, [&](auto w) {
    constexpr int C = decltype(w)::C;
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, mlp_bwd_kernel<C>);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)Plan<C>::bytes;
    return err;
  });
}

}  // namespace mlp_bwd_tile
