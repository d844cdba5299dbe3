// The fused block MLP of one tile of 64 token-major rows, for Hopper
// (sm_90a): the main loop shared by the MLP forward (mlp.cu), the fused
// block tail's forward (mlp_cln.cu) and its backward prologue
// (mlp_cln_bwd.cu), which each add their own epilogue, and the weight-slab
// ring that the MLP backward (mlp_bwd.cuh) uses too.
//
//   sum = bf16(gelu(x . W1^T + b1)) . W2^T      (fp32 accumulation, no b2)
//
// on token-major (M, C) bf16 rows, C in {48, 96, 192, 384}, with the
// PyTorch Linear weights as they are: W1 (F, C), W2 (C, F) bf16, b1 (F,)
// fp32. The GELU is the erf GELU with the TPU kernel's erf
// (poseidon_tpu/ops/mlp.py::_erf, Abramowitz-Stegun 7.1.26, |err| <=
// 1.5e-7): one reciprocal and one exponential on the SFU and about 12 fp32
// operations a value, where erff takes about twice the instructions.
//
// Bound on this card. Per row the MLP reads and writes C bf16 values (4C
// bytes) and does 4*C*F = 16*C^2 FLOPs: over the H100's ~295 FLOP/B ridge
// for C >= 96, so the tensor cores bound it (4.9 us at ScOT-B stage 0), as
// long as the (M, F) hidden state stays on chip. The GELU is a second
// floor: about 20 fp32 lane operations per hidden value and row against the
// products' 4C FLOPs, so at C <= 96 the SMs' fp32 lanes (128 a clock) take
// longer than the tensor cores (about 7.5 us at ScOT-B stage 0).
//
// Design. A warpgroup takes a 64-row tile: its x tile staged once by
// cp.async, swizzled K-major, then F walked in steps of 64 hidden columns:
//  - u = x W1^T by wgmma m64n64k16 (A: the x tile, B: the step's W1 rows,
//    both K-major in shared memory), in registers;
//  - b1 and the GELU on the accumulator in registers, repacked as bf16
//    pairs: the register A operand of the second product, so g never
//    touches shared memory;
//  - sum += g W2[:, f0:f0+64]^T by wgmma m64nCk16 with A from registers and
//    B the step's W2 columns (C rows, F contiguous: K-major).
// The sum stays in registers (wgmma's accumulator layout, C/2 values a
// thread) and the epilogues read it there: a row's C values lie in one quad
// of lanes. Two plans feed the weights:
//  - resident (C <= 96, where W1 and W2 fit: 147 KB at C = 96): persistent
//    CTAs of 2 (4 at C = 48) warpgroups load both weights once and each
//    warpgroup walks its own row tiles, the next tile's x prefetched into a
//    second buffer, with no block barrier; each warpgroup issues step s+1's
//    first product before step s's second and runs step s+1's GELU while
//    that second product is in flight;
//  - streamed (C >= 192, or an F too large to hold): one tile a CTA of two
//    warpgroups; the weights pass through a ring of NS = 3 slab stages that
//    cp.async fills two steps ahead. At C = 192 the warpgroups split each
//    step's hidden columns (32 each) and add their partial sums through
//    shared memory at the end; at C = 384 (m64n384 would need 192
//    accumulator registers a thread) they split the output columns, 192
//    each, and both compute the step's hidden values (steps of 32).
// Either way a warpgroup ends with C / WGS output columns of its rows.

#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "wgmma.cuh"

namespace mlp_fwd_tile {

using namespace wgm;

// Atom of a C-wide K-major row: 128, 64 or 32 bytes.
template <int C>
struct Atom {
  static constexpr int AK = C % 64 == 0 ? 64 : C % 32 == 0 ? 32 : 16;
};

// The weight-slab ring: stage s holds W1 rows f0..f0+FT (FT x C, atoms of
// AK along C) and W2 columns f0..f0+FT (C x FT, atoms of AK2 along FT).
template <int C, int FT>
struct Ring {
  static constexpr int AK = Atom<C>::AK;
  static constexpr uint32_t W1 = FT * C * 2;
  static constexpr uint32_t STAGE = 2 * W1;
  static_assert(W1 % 1024 == 0, "slabs on 1024-byte boundaries");
};

// cp.async of the step's W1 and W2 slabs into `stage` by `n` threads.
template <int C, int FT, int AK2 = FT>
__device__ __forceinline__ void load_slab(const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                                          uint32_t stage, int f0, int F, int tid, int n) {
  using R = Ring<C, FT>;
  for (int i = tid; i < FT * C / 8; i += n) {
    const int r = i / (C / 8), v = i % (C / 8);
    cp_async16(stage + tile_off<R::AK>(r, 8 * v, FT), w1 + (long long)(f0 + r) * C + 8 * v, true);
  }
  for (int i = tid; i < C * FT / 8; i += n) {
    const int c = i / (FT / 8), v = i % (FT / 8);
    cp_async16(stage + R::W1 + tile_off<AK2>(c, 8 * v, C), w2 + (long long)c * F + f0 + 8 * v,
               true);
  }
}

// cp.async of rows m0..m0+ROWS of a (M, C) array into a swizzled K-major
// tile of ROWS rows; rows past M are zeros.
template <int C, int ROWS>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ a, uint32_t tile, long long m0,
                                          int M, int tid, int n) {
  for (int i = tid; i < ROWS * C / 8; i += n) {
    const int r = i / (C / 8), v = i % (C / 8);
    const bool valid = m0 + r < M;
    cp_async16(tile + tile_off<Atom<C>::AK>(r, 8 * v, ROWS),
               a + (valid ? (m0 + r) * C + 8 * v : 0), valid);
  }
}

// 2^x and 1/x by the SFU, without the range fix-ups that __expf and
// __fdividef add (their arguments here are <= 0 and >= 1).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// erf(u / sqrt 2) by poseidon_tpu/ops/mlp.py::_erf (Abramowitz-Stegun
// 7.1.26, with the 1/sqrt 2 folded into its constants), and e = exp(-u^2 / 2)
// beside it: about 12 fp32 operations and 2 SFU operations.
__device__ __forceinline__ float erf_scaled(float u, float& e) {
  const float t = rcp_approx(fmaf(0.3275911f * 0.70710678118654752f, fabsf(u), 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f), 0.254829592f);
  e = ex2_approx(u * u * (-0.5f * 1.44269504088896341f));
  return copysignf(1.0f - poly * e, u);
}

__device__ __forceinline__ float gelu(float u) {
  float e;
  const float h = 0.5f * u;
  return fmaf(h, erf_scaled(u, e), h);
}

// gelu(u) and its derivative, from one erf and one exponential.
__device__ __forceinline__ float gelu_grad(float u, float& g) {
  float e;
  const float p = fmaf(0.5f, erf_scaled(u, e), 0.5f);
  g = u * p;
  return fmaf(u * e, 0.39894228040143267794f, p);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the 8 lanes of a warp that share lane % 4 (one column, 8 rows).
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

template <int C>
struct Plan {
  static constexpr int AK = Atom<C>::AK;
  static constexpr int FT = C == 384 ? 32 : 64;   // hidden columns per step
  static constexpr int WGS = C >= 192 ? 2 : 1;    // warpgroups
  // At C = 192 the two warpgroups split each step's hidden columns (32
  // each) and exchange their partial sums at the end; at C = 384 they split
  // the output columns. Either way each ends with C / WGS output columns.
  static constexpr bool KSPLIT = C == 192;
  static constexpr int UN = KSPLIT ? FT / 2 : FT;  // hidden columns a warpgroup computes
  static constexpr int NW = C / WGS;              // output columns per warpgroup
  static constexpr int ACC = KSPLIT ? C / 2 : NW / 2;  // accumulator registers in the loop
  static constexpr int THREADS = 128 * WGS;
  static constexpr int NS = 3;                    // ring stages
  static constexpr uint32_t x_off = 0;            // 64 x C bf16, K-major
  static constexpr uint32_t ring_off = align1k(x_off + 64 * C * 2);
  static constexpr uint32_t bytes = ring_off + NS * Ring<C, FT>::STAGE;
  // Epilogue scratch over the ring, after the loop: two row-sum exchanges
  // (2 KB) and 4 warps x 3 x C fp32 (the tail backward's column partials).
  static constexpr uint32_t red_off = ring_off;
  static_assert(2048 + 4 * 3 * C * 4 <= NS * Ring<C, FT>::STAGE, "epilogue scratch");
  static_assert(!KSPLIT || 64 * C * 4 <= NS * Ring<C, FT>::STAGE, "partial-sum exchange");
};

// The sum above for rows m0..m0+64, in the accumulator registers `acc` of
// each warpgroup: output columns NW * warpgroup .., in acc[0, NW / 2).
// Ends with a block barrier, after which the ring's shared memory is free.
template <int C>
__device__ __forceinline__ void tile_sum(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const bf16* __restrict__ w2, unsigned char* smem,
                                         long long m0, int M, int F,
                                         float (&acc)[Plan<C>::ACC]) {
  using P = Plan<C>;
  constexpr int FT = P::FT, NS = P::NS, AK = P::AK, UN = P::UN;
  constexpr int N = P::KSPLIT ? C : P::NW;  // output columns of the warpgroup's products
  constexpr uint32_t STAGE = Ring<C, FT>::STAGE, W1 = Ring<C, FT>::W1;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int n0 = P::KSPLIT ? 0 : wg * P::NW;  // the warpgroup's output columns
  const int h0 = P::KSPLIT ? wg * UN : 0;     // and hidden columns of a step
  const uint32_t ax = smem_addr(smem + P::x_off), ring = smem_addr(smem + P::ring_off);
  const int steps = F / FT;

  load_rows<C, 64>(x, ax, m0, M, tid, P::THREADS);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < steps) load_slab<C, FT>(w1, w2, ring + s * STAGE, s * FT, F, tid, P::THREADS);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < P::ACC; ++i) acc[i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NS - 2>();
    fence_async_smem();
    __syncthreads();  // step s's slabs landed; every warpgroup is done with step s-1's
    if (s + NS - 1 < steps)
      load_slab<C, FT>(w1, w2, ring + ((s + NS - 1) % NS) * STAGE, (s + NS - 1) * FT, F, tid,
                       P::THREADS);
    cp_async_commit();
    const uint32_t st = ring + (s % NS) * STAGE;
    const int f0 = s * FT + h0;

    float u[UN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      Mma<UN>::ss(u, desc<AK>(ax, 0, 16 * kk, 64), desc<AK>(st, h0, 16 * kk, FT), kk > 0);
    wgmma_commit();
    float bias[UN / 4];  // b1 of this thread's columns, read while the products run
#pragma unroll
    for (int j = 0; j < UN / 4; ++j) bias[j] = __ldg(b1 + f0 + acc_col(lane, 4 * (j / 2) + j % 2));
    wgmma_wait<0>();
    fence_regs<UN / 2>(u);

    uint32_t a[UN / 16][4];
#pragma unroll
    for (int i = 0; i < UN / 2; ++i) u[i] = gelu(u[i] + bias[(i / 4) * 2 + i % 2]);
#pragma unroll
    for (int kk = 0; kk < UN / 16; ++kk) a_frag(u, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < UN / 16; ++kk)
      Mma<N>::rs(acc, a[kk], desc<FT>(st + W1, n0, h0 + 16 * kk, C), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<P::ACC>(acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (P::KSPLIT) {
    // Each warpgroup hands the other its partial of the other's half of the
    // columns (accumulator values [NW/2, NW) are columns NW.., the same
    // (row, column) in the same thread of both warpgroups), and keeps
    // its own half, the two partials added in a fixed order.
    constexpr int H = P::NW / 2;
    float* xch = reinterpret_cast<float*>(smem + P::ring_off);  // 2 x H x 128 fp32
    const int wt = tid % 128;
#pragma unroll
    for (int j = 0; j < H; ++j) xch[(wg * H + j) * 128 + wt] = wg == 0 ? acc[H + j] : acc[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float other = xch[((1 - wg) * H + j) * 128 + wt];
      const float mine = wg == 0 ? acc[j] : acc[H + j];
      acc[j] = wg == 0 ? mine + other : other + mine;
    }
    __syncthreads();
  }
}

// The resident plan (C <= 96, where all of W1 and W2 fit beside the row
// tiles: 147 KB at C = 96, F = 384): a persistent CTA loads both weights
// once and its warpgroups each walk their own 64-row tiles, the next tile's
// x prefetched by cp.async into a second buffer. No block barrier after the
// weights land: one warpgroup's GELU runs beside another's products.
template <int C>
struct Resident {
  static constexpr bool ok = C <= 96;
  static constexpr int WGS = C == 48 ? 4 : 2;  // warpgroups, each its own row tiles
  static constexpr int THREADS = 128 * WGS;
  static constexpr uint32_t XT = 64 * C * 2;  // one x tile
  static constexpr uint32_t SCRATCH = align1k(2048 + 4 * 3 * C * 4);
  static constexpr uint32_t PER_WG = 2 * XT + SCRATCH;
  static __host__ __device__ uint32_t weights(int F) { return align1k(4u * F * C); }
  static __host__ __device__ uint32_t bytes(int F) { return weights(F) + WGS * PER_WG; }
};

// Runs the MLP main loop over every 64-row tile of x and calls
//   epi(acc, m0, xt, scratch, sync, rt, rn)
// for each: acc the warpgroup's sum registers for rows m0.., xt the tile's
// x in shared memory (64 x C bf16, swizzled K-major: tile_off<AK>), which
// the epilogue may overwrite with its output (after a sync()) and copy out
// in 16-byte rows, scratch fp32 shared memory (2 KB + 4 x 3 x C fp32),
// sync() the barrier of the rn threads that share the tile, rt this
// thread's index among them.
// RES: the resident plan (a grid of persistent CTAs); else one tile a CTA,
// by tile_sum.
template <int C, bool RES, class Epi>
__device__ __forceinline__ void run_rows(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const bf16* __restrict__ w2, unsigned char* smem, int M,
                                         int F, Epi&& epi) {
  const int tid = threadIdx.x;
  if constexpr (!RES) {
    using P = Plan<C>;
    float acc[P::ACC];
    const long long m0 = (long long)blockIdx.x * 64;
    tile_sum<C>(x, w1, b1, w2, smem, m0, M, F, acc);
    epi(*reinterpret_cast<float(*)[P::NW / 2]>(acc), m0, smem + P::x_off,
        reinterpret_cast<float*>(smem + P::red_off), [] { __syncthreads(); }, tid, P::THREADS);
  } else {
    using R = Resident<C>;
    constexpr int AK = Atom<C>::AK;
    const int wg = tid / 128, wt = tid % 128, lane = tid % 32;
    const uint32_t aw1 = smem_addr(smem), aw2 = aw1 + (uint32_t)F * C * 2;
    unsigned char* mine = smem + R::weights(F) + wg * R::PER_WG;
    const uint32_t ax0 = smem_addr(mine);
    float* scratch = reinterpret_cast<float*>(mine + 2 * R::XT);
    const int tiles = (M + 63) / 64, stride = gridDim.x * R::WGS;
    int t = blockIdx.x * R::WGS + wg;

    // W1 (F rows, atoms of AK along C) and W2 (C rows, atoms of 64 along F).
    for (int i = tid; i < F * C / 8; i += R::THREADS) {
      const int r = i / (C / 8), v = i % (C / 8);
      cp_async16(aw1 + tile_off<AK>(r, 8 * v, F), w1 + (long long)r * C + 8 * v, true);
    }
    for (int i = tid; i < C * F / 8; i += R::THREADS) {
      const int c = i / (F / 8), v = i % (F / 8);
      cp_async16(aw2 + tile_off<64>(c, 8 * v, C), w2 + (long long)c * F + 8 * v, true);
    }
    if (t < tiles) load_rows<C, 64>(x, ax0, (long long)t * 64, M, wt, 128);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // the weights landed

    for (int k = 0; t < tiles; t += stride, ++k) {
      if (k > 0) {
        cp_async_wait<0>();
        fence_async_smem();
        bar_sync(1 + wg, 128);  // tile t landed; the warpgroup is done with tile k-1
      }
      const uint32_t ax = ax0 + (k % 2) * R::XT;
      if (t + stride < tiles)
        load_rows<C, 64>(x, ax0 + ((k + 1) % 2) * R::XT, (long long)(t + stride) * 64, M, wt,
                         128);
      cp_async_commit();

      // Software-pipelined over the hidden steps: step s+1's first product
      // is issued before step s's second, and step s+1's GELU runs while
      // the second product of step s is in flight (g double-buffered).
      float acc[C / 2], u[32];
      uint32_t a[2][4][4];
#pragma unroll
      for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
      auto first = [&](int f0) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
          Mma<64>::ss(u, desc<AK>(ax, 0, 16 * kk, 64), desc<AK>(aw1, f0, 16 * kk, F), kk > 0);
        wgmma_commit();
      };
      // g: the A registers of the second product two steps back, retired by
      // the wait (waits for every group but the last second product).
      auto hidden = [&](int f0, uint32_t (&g)[4][4], bool first_step) {
        float bias[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) bias[j] = __ldg(b1 + f0 + acc_col(lane, 4 * (j / 2) + j % 2));
        if (first_step)
          wgmma_wait<0>();
        else
          wgmma_wait<1>();
        fence_regs<32>(u);
        keep_regs<16>(&g[0][0]);
#pragma unroll
        for (int i = 0; i < 32; ++i) u[i] = gelu(u[i] + bias[(i / 4) * 2 + i % 2]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_frag(u, kk, g[kk]);
      };
      first(0);
      hidden(0, a[0], true);
      const int steps = F / 64;
      auto step = [&](int s, uint32_t (&g)[4][4], uint32_t (&next)[4][4]) {
        const int f0 = 64 * s;
        if (s + 1 < steps) first(f0 + 64);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<C>::rs(acc, g[kk], desc<64>(aw2, 0, f0 + 16 * kk, C), 1);
        wgmma_commit();
        if (s + 1 < steps) hidden(f0 + 64, next, false);
      };
      for (int s = 0; s < steps; s += 2) {  // two steps a turn: a[] indexed statically
        step(s, a[0], a[1]);
        if (s + 1 < steps) step(s + 1, a[1], a[0]);
      }
      wgmma_wait<0>();
      fence_regs<C / 2>(acc);
      keep_regs<32>(&a[0][0][0]);
      epi(acc, (long long)t * 64, mine + (k % 2) * R::XT, scratch,
          [wg] { bar_sync(1 + wg, 128); }, wt, 128);
    }
    cp_async_wait<0>();
  }
}

// Sets kernel fn's dynamic shared memory for launches of `bytes` and gives
// the CTAs of `threads` threads that the card holds at once. Both are fixed
// for one (kernel, device, bytes), so each is set or queried once and kept:
// the attribute and occupancy calls cost host time on every launch of a
// path that the host already bounds. The attribute only ever rises, so a
// launch of fewer bytes than an earlier one stays within it.
inline cudaError_t prepare_launch(const void* fn, int bytes, int threads, int* slots) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> known;  // -> CTAs on the card
  static std::map<std::tuple<const void*, int>, int> attr;        // -> bytes set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(std::make_tuple(fn, dev, bytes));
  if (it == known.end()) {
    int& set = attr[std::make_tuple(fn, dev)];
    if (bytes > set) {
      if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
          cudaSuccess)
        return err;
      set = bytes;
    }
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, bytes)) !=
        cudaSuccess)
      return err;
    it = known.emplace(std::make_tuple(fn, dev, bytes), sms * (per_sm > 0 ? per_sm : 1)).first;
  }
  if (slots != nullptr) *slots = it->second;
  return cudaSuccess;
}

// Launches the resident kernel kres where the weights fit (C <= 96 and
// 4 F C bytes with the row tiles within the 227 KB a block may use), as
// persistent CTAs, and else kstream, one 64-row tile a CTA.
template <int C, class KR, class KS, class... A>
cudaError_t launch_rows(KR kres, KS kstream, int M, int F, cudaStream_t st, A... args) {
  const unsigned tiles = (unsigned)((M + 63) / 64);
  cudaError_t err;
  if constexpr (Resident<C>::ok) {
    using R = Resident<C>;
    const int bytes = (int)R::bytes(F);
    if (bytes <= 232448) {
      int slots = 0;
      if ((err = prepare_launch(reinterpret_cast<const void*>(kres), bytes, R::THREADS, &slots)) !=
          cudaSuccess)
        return err;
      const unsigned want = (tiles + R::WGS - 1) / R::WGS;
      kres<<<want < (unsigned)slots ? want : (unsigned)slots, R::THREADS, bytes, st>>>(args...);
      return cudaGetLastError();
    }
  }
  using P = Plan<C>;
  if ((err = prepare_launch(reinterpret_cast<const void*>(kstream), (int)P::bytes, P::THREADS,
                            nullptr)) != cudaSuccess)
    return err;
  kstream<<<tiles, P::THREADS, P::bytes, st>>>(args...);
  return cudaGetLastError();
}

// Registers, spill bytes and dynamic shared memory (at F = 4C) of the
// kernel that width C launches there.
template <int C, class K>
cudaError_t rows_info(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  if constexpr (Resident<C>::ok)
    out[2] = (int)Resident<C>::bytes(4 * C);
  else
    out[2] = (int)Plan<C>::bytes;
  return err;
}

// Calls f(Width<C>{}) for the instantiation of width c.
template <int C_>
struct Width {
  static constexpr int C = C_;
};

template <class Fn>
cudaError_t dispatch(int c, Fn f) {
  switch (c) {
    case 48: return f(Width<48>{});
    case 96: return f(Width<96>{});
    case 192: return f(Width<192>{});
    case 384: return f(Width<384>{});
    default: return cudaErrorInvalidValue;
  }
}

// Copies a 64 x C bf16 tile staged in xt (swizzled as the x tile) to rows
// m0.. of out, 16 bytes a thread, rows past M left out.
template <int C>
__device__ __forceinline__ void store_tile(const unsigned char* xt, bf16* __restrict__ out,
                                           long long m0, int M, int rt, int rn) {
  for (int j = rt; j < 64 * C / 8; j += rn) {
    const int r = j / (C / 8), v = j % (C / 8);
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(out + (m0 + r) * C + 8 * v) =
          *reinterpret_cast<const uint4*>(xt + tile_off<Atom<C>::AK>(r, 8 * v, 64));
  }
}

// Epilogue helpers of the fused block tail (mlp_cln.cu, mlp_cln_bwd.cu).

// Row sums s[j] (rows acc_row(warp, lane, 2j), j = 0, 1) of this thread's
// quad, completed over the C columns: at C = 384 through `red` (2 x 64 x 2
// fp32), the two warpgroups' halves added in a fixed order. Every thread of
// the block calls it.
template <int C>
__device__ __forceinline__ void row_sums(float (&a)[2], float (&b)[2], float* red) {
  const int tid = threadIdx.x, wgi = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a[j] = quad_sum(a[j]);
    b[j] = quad_sum(b[j]);
  }
  if constexpr (Plan<C>::WGS == 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = acc_row(warp, lane, 2 * j);
      if (lane % 4 == 0) {
        red[(wgi * 64 + r) * 2] = a[j];
        red[(wgi * 64 + r) * 2 + 1] = b[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = acc_row(warp, lane, 2 * j);
      a[j] = red[r * 2] + red[(64 + r) * 2];
      b[j] = red[r * 2 + 1] + red[(64 + r) * 2 + 1];
    }
  }
}

// o = bf16(sum + b2) over the accumulator (output columns n0..), and each
// row's r = rsqrt(var + eps) and mean.
template <int C>
__device__ __forceinline__ void row_stats(float (&acc)[Plan<C>::NW / 2], const float* b2,
                                          float eps, float* red, int n0, float (&mu)[2],
                                          float (&rs)[2]) {
  const int lane = threadIdx.x % 32;
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < Plan<C>::NW / 2; ++i) {
    const float o = round_bf16(acc[i] + __ldg(b2 + n0 + acc_col(lane, i)));
    acc[i] = o;
    s1[(i % 4) / 2] += o;
    s2[(i % 4) / 2] += o * o;
  }
  row_sums<C>(s1, s2, red);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mu[j] = s1[j] / C;
    rs[j] = rsqrtf(fmaxf(s2[j] / C - mu[j] * mu[j], 0.f) + eps);
  }
}

}  // namespace mlp_fwd_tile
