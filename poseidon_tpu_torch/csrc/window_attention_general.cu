// Window cosine attention, forward and backward, for the calls the bf16
// Hopper kernels (window_attention.cu, window_attention_bwd.cu) do not
// take: fp32 operands, and any window of 1-1024 tokens (up to 32x32) with
// any head width of 1-128, in bf16 or fp32. sm_90a, plain C interface.
//
// Replaces, for those calls, the TPU kernels of
// poseidon_tpu/ops/window_attention.py: _fwd_kernel_qkv (pallas_call in
// _core_fwd_qkv) and _fwd_kernel (_core_fwd) in the forward entry,
// _bwd_kernel_qkv (_core_bwd_qkv) and _bwd_kernel (_core_bwd) in the backward
// one. The TPU kernels run in their operands' dtype, fp32 included. The
// function and its rounding points are those of the plain versions in
// ops/window_attention.py (attention_plain, attention_bwd_plain), where
// cast() rounds to the operand type and is the identity for fp32:
//   q  = cast(q + cast(qb))                                  (packed entries)
//   qn = q / max(|q|, 1e-12);  qs = cast(scale[h] qn);  kn = cast(k / max(|k|, 1e-12))
//   S  = qs . kn^T + bm[n mod nW, h];  e = exp(S - max S);  den = sum e
//   O  = cast(cast(e) . v / den)
//   dv = cast(e)^T . cast(do / den);  dp = do . v^T;  ds = e ((dp - sum(dp e) / den) / den)
//   dqs = cast(ds) . kn;  dkn = cast(ds)^T . qs;  dq, dk through the normalisation
//   dscale[h] = sum dqs . qn;  dbm = sum over the windows of a slot of ds;  dqb = sum cast(dq)
//
// Every product runs on the tensor cores through wgmma (wgmma.cuh): bf16
// operands as m64nNk16 with fp32 accumulation; fp32 operands as three
// m64nNk8 tf32 products of the error-compensated split x = hi + lo (hi =
// tf32(x), lo = tf32(x - hi); a.b = hi.hi + hi.lo + lo.hi, "3xTF32"),
// accumulated in fp32, whose error is near fp32 round-off: one-pass TF32
// (10 mantissa bits) would miss the fp32 accuracy of the JAX kernels. The
// split is made once, when a tile is staged into shared memory, and in
// registers for the accumulator-fed A operands (P, dS).
//
// Bound on this card. Per (window, head) pair the forward reads 3 T D
// operands, writes T D and does 4 T^2 D FLOPs; the backward reads 4 T D,
// writes 3 T D and does 10 T^2 D. bf16: T / 2 FLOPs a byte, far under the
// ridge (295), so bytes bound it. fp32: the tensor cores issue 3 x the
// FLOPs at the dense TF32 rate (495 TFLOP/s), 148 FLOPs a byte at the ridge,
// against T / 4 FLOPs a byte: bytes bound it at every window here too.
// What the design avoids is the plain version's N H T^2 fp32 tensors in
// device memory and the FMA lanes.
//
// Layout. The head width is padded in shared memory to DP, the next of 16,
// 32, 64 and 128; the tail columns are zero-filled when a tile is staged
// (zero columns change neither a norm nor a dot product), and no padded
// copy is made in device memory. Keys and queries go in blocks of 64 (the
// M of wgmma), masked past T. Each CTA is one warpgroup on one 64-row
// block of one pair. Tiles are staged from device memory (L2 hits after the
// first CTA of a pair) by warps, normalised and rounded as the plain
// version rounds, into the swizzled K-major layout of wgmma.cuh; with
// 32-bit operands wgmma reads shared-memory operands K-major only, so the B
// operands of P.V, dS.Kn, e^T.(dO/den) and dS^T.Qs are staged transposed
// (V^T, Kn^T, (dO/den)^T, Qs^T), with the reduction index permuted by
// tf32_pos for the register-A layout. Each block is staged, synchronised and
// multiplied in turn, so a CTA waits on L2 at every block: the kernels are
// bound by that latency, and what hides it is more CTAs an SM. Hence three
// CTAs an SM in the launch bounds where the registers allow it without
// spills (the two-pass forward at DP <= 64, the dq kernel at DP = 64;
// bounds that forced spills elsewhere ran faster but are not taken), and
// the staging's loads all in flight before any is used.
//
// Forward (one kernel; a CTA per (pair, 64-query strip)). For T <= 64, and
// in bf16 for T <= 256, the strip's S (64 x 256 at most) stays in
// registers: S for every key block, the exact row max, e, its sum, then O
// += cast(e) V per key block. Otherwise two passes over the key blocks: the
// max first, then S again, e, its sum and P.V (fp32 at 64 < T <= 256 too:
// see by_blocks). Both keep the plain version's rounding point cast(exp(S -
// max S)) against the exact row max (an online softmax would round e
// against a running max). Every S comes from the same wgmma sequence, so
// it has the same bits in each pass and each kernel.
//
// Backward (three or four launches, no atomics, two calls give the same
// bits):
//  (1) dq: a CTA per (pair, query strip). One walk over the key blocks
//      takes S and dP on the tensor cores and the row statistics (max,
//      den, delta = sum(dp e) / den) online; they are written once for (2)
//      and (3). A second walk recomputes S and dP, forms ds in registers
//      and accumulates dQs = cast(ds) Kn; then the normalisation's backward,
//      dq, and one (dqb | dscale) partial per CTA.
//  (2) dk, dv: S^T = Kn Qs^T and dP^T = V dO^T per (key block, query
//      strip), e and ds from the stored statistics, dV += cast(e)^T-as-A .
//      (dO/den)^T, dKn += cast(ds) . Qs^T. At T <= 64 a CTA per (window
//      group, bias slot, head) walks its group's windows in order, adds ds
//      to a 64 x 64 dbm sum in shared memory, and writes one partial per
//      group: dbm costs no second S. Past T = 64 a CTA per (pair, key
//      block), and
//  (3) dbm: a CTA per (window group, bias slot, head, query strip, key
//      block) walks its group's windows in order, S, dP, ds in registers,
//      and writes one partial.
//      The groups (ops/window_attention.py::general_bwd_plan) fill the 132
//      SMs at every stage.
//  (4) the dbm partials summed over groups and the dqb / dscale partials
//      over the CTAs of (1), each in a fixed order.

#include "wgmma.cuh"

#include <type_traits>

using namespace wgm;

namespace {

constexpr int MAX_T = 1024;
constexpr int MAX_D = 128;
constexpr float EPS = 1e-12f;  // torch F.normalize clamp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
// Round to the operand type and back.
template <typename T> __device__ __forceinline__ float cast(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}
// Sum and max over the quad of lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

template <typename T> struct Fmt;
template <> struct Fmt<bf16> {
  static constexpr int EB = 2, KS = 16, PARTS = 1;  // bytes, k of a wgmma step, tiles (hi, lo)
};
template <> struct Fmt<float> {
  static constexpr int EB = 4, KS = 8, PARTS = 2;
};

// A shared-memory operand tile of ROWS rows and KX elements along k (the
// reduction index) in the format of wgmma.cuh; fp32 as its hi part then
// its lo part.
template <typename T, int ROWS, int KX>
struct Tile {
  static constexpr int EB = Fmt<T>::EB;
  static constexpr int AK = (KX * EB < 128 ? KX * EB : 128) / 2;  // atom, bf16 units
  static constexpr uint32_t PART = align1k(ROWS * KX * EB);
  static constexpr uint32_t BYTES = PART * Fmt<T>::PARTS;
  static __device__ __forceinline__ uint32_t off(int row, int k) {
    return tile_off<AK>(row, k * EB / 2, ROWS);
  }
  static __device__ __forceinline__ uint64_t dsc(uint32_t base, int row0, int k0) {
    return desc<AK>(base, row0, k0 * EB / 2, ROWS);
  }
  // Stores x (already rounded to T) at (row, k).
  static __device__ __forceinline__ void put(unsigned char* base, int row, int k, float x) {
    const uint32_t o = off(row, k);
    if constexpr (std::is_same<T, float>::value) {
      uint32_t hi, lo;
      split_tf32(x, hi, lo);
      *reinterpret_cast<uint32_t*>(base + o) = hi;
      *reinterpret_cast<uint32_t*>(base + PART + o) = lo;
    } else {
      *reinterpret_cast<bf16*>(base + o) = __float2bfloat16(x);
    }
  }
};

// Position along k of token r of a transposed tile: tf32_pos for fp32
// (the register-A layout of wgmma.cuh), r for bf16.
template <typename T>
__device__ __forceinline__ int kpos(int r) {
  return std::is_same<T, float>::value ? tf32_pos(r) : r;
}

// acc (+)= A B^T over KX: A rows [a0, a0 + 64) of an (AR x KX) tile at a,
// B rows [b0, b0 + N) of a (BR x KX) tile at b, both K-major. The caller
// fences, commits and waits.
template <typename T, int N, int KX, int AR, int BR>
__device__ __forceinline__ void mma_ss(float* acc, uint32_t a, int a0, uint32_t b, int b0,
                                       int accumulate) {
  using TA = Tile<T, AR, KX>;
  using TB = Tile<T, BR, KX>;
  constexpr int KS = Fmt<T>::KS;
#pragma unroll
  for (int kk = 0; kk < KX / KS; ++kk) {
    if constexpr (std::is_same<T, float>::value) {
      MmaTf32<N>::ss(acc, TA::dsc(a + TA::PART, a0, KS * kk), TB::dsc(b, b0, KS * kk),
                     accumulate || kk > 0);
      MmaTf32<N>::ss(acc, TA::dsc(a, a0, KS * kk), TB::dsc(b + TB::PART, b0, KS * kk), 1);
      MmaTf32<N>::ss(acc, TA::dsc(a, a0, KS * kk), TB::dsc(b, b0, KS * kk), 1);
    } else {
      Mma<N>::ss(acc, TA::dsc(a, a0, KS * kk), TB::dsc(b, b0, KS * kk), accumulate || kk > 0);
    }
  }
}

// acc (+)= cast(src) B^T, src an m64n64 accumulator (64 tokens along k) as
// the register A operand, B the (N x 64) transposed tile at b. Waits for
// its products and fences acc.
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float* acc, const float* src, uint32_t b, int accumulate) {
  using TB = Tile<T, N, 64>;
  constexpr int KS = Fmt<T>::KS;
  if constexpr (std::is_same<T, float>::value) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int kk = 0; kk < 64 / KS; ++kk) {
      tf32_frag(src, kk, hi[kk % 2], lo[kk % 2]);
      wgmma_fence();
      MmaTf32<N>::rs(acc, lo[kk % 2], TB::dsc(b, 0, KS * kk), accumulate || kk > 0);
      MmaTf32<N>::rs(acc, hi[kk % 2], TB::dsc(b + TB::PART, 0, KS * kk), 1);
      MmaTf32<N>::rs(acc, hi[kk % 2], TB::dsc(b, 0, KS * kk), 1);
      wgmma_commit();
      wgmma_wait<1>();
      keep_regs<4>(hi[(kk + 1) % 2]);
      keep_regs<4>(lo[(kk + 1) % 2]);
    }
    wgmma_wait_all();
    keep_regs<4>(hi[1]);
    keep_regs<4>(lo[1]);
  } else {
    uint32_t a[2][4];
#pragma unroll
    for (int kk = 0; kk < 64 / KS; ++kk) {
      a_frag(src, kk, a[kk % 2]);
      wgmma_fence();
      Mma<N>::rs(acc, a[kk % 2], TB::dsc(b, 0, KS * kk), accumulate || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      keep_regs<4>(a[(kk + 1) % 2]);
    }
    wgmma_wait_all();
    keep_regs<4>(a[1]);
  }
  fence_regs<N / 2>(acc);
}

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  long long ld;        // row stride of q, k, v (and of dq, dk, dv)
  const float* qb;     // (C,) q-bias, or null
  const float* bm;     // (nW, H, T, T)
  const float* scale;  // (H,)
  int n, t, heads, d, nw;
  int blocks;          // 64-token blocks of a window
};

// How a staged row is made from the token row x of one head.
enum Mode { PLAIN = 0, NORM = 1, DIV = 2 };

// Stages token rows [t0, t0 + 64) of window n, head h of the token-major
// base (row n T + t, row stride ld, column h D + j) into a K-major (64 x DP)
// tile at `rows` and/or a transposed (DP x 64) tile at `cols` (either may
// be null). Zero past T and past d. NORM: with qb, x = cast(x + cast(qb));
// then cast(x / max(|x|, 1e-12) * mult). DIV: cast(x / den[r]), den in
// shared memory by local row.
//
// Where every row starts on 16 bytes and d is a multiple of 16 bytes (D =
// 24 or 32 and the like: the models' widths), LPR lanes take a row, 16
// bytes a lane, and each thread has up to four rows' loads in flight
// before it uses any (the loads are L2 hits; issued one at a time their
// latency is the kernel's time). Other widths go one element a lane, warp
// w taking rows w, w + 4, ..., R rows at a time.
template <typename T, int DP, Mode M>
__device__ __forceinline__ void stage(const T* base, long long ld, const Args<T>& a, long long n,
                                      int h, int t0, const float* qb, float mult,
                                      const float* den, unsigned char* rows,
                                      unsigned char* cols) {
  using RT = Tile<T, 64, DP>;
  using CT = Tile<T, DP, 64>;
  // t0 through an empty asm statement: the row offsets derived from it are
  // then computed at each call, not hoisted out of the caller's loop over
  // windows and held in registers across it (the dbm kernel spilled so).
  asm volatile("" : "+r"(t0));
  constexpr int V = 16 / Fmt<T>::EB;  // elements in 16 bytes
  constexpr int LPR = DP / V;         // lanes a row
  constexpr int NB = 64 * LPR / 128;  // 16-byte chunks a thread
  constexpr int B = NB < 4 ? NB : 4;  // ... in flight at once
  const T* src = base + (long long)n * a.t * ld + (long long)h * a.d;
  const bool vec = ((uintptr_t)src % 16 == 0) && ld % V == 0 && a.d % V == 0 &&
                   (M != NORM || qb == nullptr || (uintptr_t)(qb + h * a.d) % 16 == 0);
  if (vec) {
    const int part = threadIdx.x % LPR, j0 = part * V;
    const bool col_ok = j0 < a.d;
    float qbv[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      qbv[e] = M == NORM && qb != nullptr && col_ok ? cast<T>(qb[h * a.d + j0 + e]) : 0.f;
    for (int c0 = 0; c0 < NB; c0 += B) {
      uint4 raw[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int r = (threadIdx.x + 128 * (c0 + b)) / LPR, t = t0 + r;
        raw[b] = make_uint4(0u, 0u, 0u, 0u);
        if (t < a.t && col_ok) raw[b] = *reinterpret_cast<const uint4*>(src + (long long)t * ld + j0);
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int r = (threadIdx.x + 128 * (c0 + b)) / LPR;
        const bool ok = t0 + r < a.t && col_ok;
        float x[V];
        if constexpr (std::is_same<T, float>::value) {
          x[0] = __uint_as_float(raw[b].x);
          x[1] = __uint_as_float(raw[b].y);
          x[2] = __uint_as_float(raw[b].z);
          x[3] = __uint_as_float(raw[b].w);
        } else {
          unpack8(raw[b], x);
        }
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (M == NORM && qb != nullptr && ok) x[e] = cast<T>(x[e] + qbv[e]);
          ss += x[e] * x[e];
        }
        if (M == NORM) {
          const float nrm = fmaxf(sqrtf(group_sum<LPR>(ss)), EPS);
#pragma unroll
          for (int e = 0; e < V; ++e) x[e] = cast<T>(x[e] / nrm * mult);
        } else if (M == DIV) {
#pragma unroll
          for (int e = 0; e < V; ++e) x[e] = cast<T>(x[e] / den[r]);
        }
        if (rows != nullptr) {
          const uint32_t o = RT::off(r, j0);
          if constexpr (std::is_same<T, float>::value) {
            uint4 hi, lo;
            split_tf32(x[0], hi.x, lo.x);
            split_tf32(x[1], hi.y, lo.y);
            split_tf32(x[2], hi.z, lo.z);
            split_tf32(x[3], hi.w, lo.w);
            *reinterpret_cast<uint4*>(rows + o) = hi;
            *reinterpret_cast<uint4*>(rows + RT::PART + o) = lo;
          } else {
            *reinterpret_cast<uint4*>(rows + o) = pack8(x);
          }
        }
        if (cols != nullptr) {
#pragma unroll
          for (int e = 0; e < V; ++e) CT::put(cols, j0 + e, kpos<T>(r), x[e]);
        }
      }
    }
    return;
  }
  constexpr int NV = (DP + 31) / 32;
  constexpr int R = 16 / NV;  // rows a warp loads at once: 16 values a lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float qbv[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int j = lane + 32 * c;
    qbv[c] = M == NORM && qb != nullptr && j < a.d ? cast<T>(qb[h * a.d + j]) : 0.f;
  }
  for (int r0 = warp; r0 < 64; r0 += 4 * R) {
    float x[R][NV];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = t0 + r0 + 4 * i;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int j = lane + 32 * c;
        x[i][c] = t < a.t && j < a.d ? to_f(src[(long long)t * ld + j]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0 + 4 * i;
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        if (M == NORM && qb != nullptr && t0 + r < a.t && lane + 32 * c < a.d)
          x[i][c] = cast<T>(x[i][c] + qbv[c]);
        ss += x[i][c] * x[i][c];
      }
      if (M == NORM) {
        const float nrm = fmaxf(sqrtf(warp_sum(ss)), EPS);
#pragma unroll
        for (int c = 0; c < NV; ++c) x[i][c] = cast<T>(x[i][c] / nrm * mult);
      } else if (M == DIV) {
#pragma unroll
        for (int c = 0; c < NV; ++c) x[i][c] = cast<T>(x[i][c] / den[r]);
      }
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int j = lane + 32 * c;
        if (j < DP) {
          if (rows != nullptr) RT::put(rows, r, j, x[i][c]);
          if (cols != nullptr) CT::put(cols, j, kpos<T>(r), x[i][c]);
        }
      }
    }
  }
}

// S of an m64n64 block, query rows [q0, q0 + 64) by key columns [k0, k0 +
// 64) (trans: keys by rows, queries by columns), initialised from bm:
// -inf at keys past T, 0 at queries past T.
// The base is taken through an empty asm statement so that the compiler
// does not hoist the 32 element addresses out of the caller's loop over
// blocks or windows and hold them in 64 registers across it.
__device__ __forceinline__ void init_bias(float* S, const float* bmh, int T, int q0, int k0,
                                          bool trans) {
  asm volatile("" : "+l"(bmh));
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = acc_row(warp, lane, i), c = acc_col(lane, i);
    const int q = trans ? q0 + c : q0 + r, key = trans ? k0 + r : k0 + c;
    S[i] = key >= T ? -INFINITY : q < T ? __ldg(bmh + (long long)q * T + key) : 0.f;
  }
}

__device__ __forceinline__ const float* bias_of(const float* bm, int nw, int heads, int t,
                                                long long n, int h) {
  return bm + ((long long)(n % nw) * heads + h) * t * t;
}

// One synchronised staging step into shared memory: every thread is past
// the wgmmas that read the slot before it is written, and the writes are
// visible to the async proxy after it.
#define STAGE(...)         \
  do {                     \
    __syncthreads();       \
    __VA_ARGS__;           \
    fence_async_smem();    \
    __syncthreads();       \
  } while (0)

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Shared memory of the forward: Qs (64 x DP), one slot for a key block
// (Kn, 64 x DP, or V^T, DP x 64), and, where S stays in registers and the
// tiles keep two CTAs an SM (VRES), every key block's V^T, staged beside
// its Kn in the first walk so that the second walk stages nothing.
template <typename T, int DP, int NBR>
struct FwdPlan {
  static constexpr uint32_t TILE = Tile<T, 64, DP>::BYTES;
  static constexpr bool VRES = NBR > 0 && (2 + NBR) * TILE <= 116736;
  static constexpr uint32_t qs_off = 0, x_off = TILE, vt_off = 2 * TILE;
  static constexpr uint32_t bytes = (VRES ? 2 + NBR : 2) * TILE;
};

// A CTA per (pair, 64-query strip). NBR > 0: T <= 64 NBR, the strip's S in
// registers; NBR == 0: two passes over the key blocks.
template <typename T, int DP, int NBR>
__global__ void __launch_bounds__(128, NBR == 0 && DP <= 64 ? 3 : 1)
attn_general_fwd(Args<T> a, T* __restrict__ out, long long ldo) {
  using P = FwdPlan<T, DP, NBR>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sq = smem + P::qs_off;
  unsigned char* sx = smem + P::x_off;
  const uint32_t aq = smem_addr(sq), ax = smem_addr(sx);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long pair = blockIdx.x / a.blocks;
  const int q0 = 64 * (int)(blockIdx.x % a.blocks);
  const long long n = pair / a.heads;
  const int h = (int)(pair % a.heads);
  const float* bmh = bias_of(a.bm, a.nw, a.heads, a.t, n, h);
  const int nblk = a.blocks;
  // The V^T slot of key block kb.
  auto vt = [&](int kb) { return P::VRES ? smem + P::vt_off + kb * P::TILE : sx; };

  stage<T, DP, NORM>(a.q, a.ld, a, n, h, q0, a.qb, a.scale[h], nullptr, sq, nullptr);
  // S of key block kb into S (32 values); with VRES, V^T staged with Kn.
  auto scores = [&](int kb, float* S) {
    if (P::VRES) {
      STAGE(stage<T, DP, NORM>(a.k, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, sx, nullptr);
            stage<T, DP, PLAIN>(a.v, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, nullptr,
                                vt(kb)));
    } else {
      STAGE(stage<T, DP, NORM>(a.k, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, sx, nullptr));
    }
    init_bias(S, bmh, a.t, q0, 64 * kb, false);
    wgmma_fence();
    mma_ss<T, 64, DP, 64, 64>(S, aq, 0, ax, 0, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(S);
  };
  auto stage_vt = [&](int kb) {
    if (!P::VRES)
      STAGE(stage<T, DP, PLAIN>(a.v, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, nullptr, sx));
  };

  float m[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
  float O[DP / 2];
  if constexpr (NBR > 0) {
    float S[32 * NBR];
#pragma unroll
    for (int kb = 0; kb < NBR; ++kb) {
      if (kb < nblk) {
        scores(kb, S + 32 * kb);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) S[32 * kb + i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 32 * NBR; ++i) m[(i % 4) / 2] = fmaxf(m[(i % 4) / 2], S[i]);
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
#pragma unroll
    for (int i = 0; i < 32 * NBR; ++i) {
      S[i] = __expf(S[i] - m[(i % 4) / 2]);
      den[(i % 4) / 2] += S[i];
    }
#pragma unroll
    for (int kb = 0; kb < NBR; ++kb) {
      if (kb < nblk) {
        stage_vt(kb);
        mma_rs<T, DP>(O, S + 32 * kb, smem_addr(vt(kb)), kb > 0);
      }
    }
  } else {
    float S[32];
    for (int kb = 0; kb < nblk; ++kb) {
      scores(kb, S);
#pragma unroll
      for (int i = 0; i < 32; ++i) m[(i % 4) / 2] = fmaxf(m[(i % 4) / 2], S[i]);
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    for (int kb = 0; kb < nblk; ++kb) {
      scores(kb, S);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        S[i] = __expf(S[i] - m[(i % 4) / 2]);
        den[(i % 4) / 2] += S[i];
      }
      stage_vt(kb);
      mma_rs<T, DP>(O, S, ax, kb > 0);
    }
  }
  den[0] = quad_sum(den[0]);
  den[1] = quad_sum(den[1]);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int row = q0 + acc_row(warp, lane, i), col = acc_col(lane, i);
    if (row < a.t && col < a.d)
      out[((long long)n * a.t + row) * ldo + (long long)h * a.d + col] =
          from_f<T>(O[i] / den[(i % 4) / 2]);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Shared memory of the dq, dk/dv and dbm kernels: three operand tiles (64 x
// DP or DP x 64, one size) and the per-row arrays.
template <typename T, int DP>
struct BwdPlan {
  static constexpr uint32_t TILE = Tile<T, 64, DP>::BYTES;
  static constexpr uint32_t t0_off = 0, t1_off = TILE, t2_off = 2 * TILE;
  static constexpr uint32_t st_off = 3 * TILE;        // 3 x 64 f32: max, den, delta
  static constexpr uint32_t red_off = st_off + 3 * 64 * 4;  // 4 warps x (DP + 1) f32
  static constexpr uint32_t bytes = red_off + 4 * (DP + 1) * 4;
  static_assert(bytes <= 232448, "one CTA's shared memory");
};

// The row statistics of queries [q0, q0 + 64) into shared memory (queries
// past T: max 0, den 1, delta 0).
__device__ __forceinline__ void load_stats(float* st, const float* sth, int T, int q0) {
  for (int i = threadIdx.x; i < 64; i += 128) {
    const int q = q0 + i;
    const bool ok = q < T;
    st[i] = ok ? sth[(long long)q * 3] : 0.f;
    st[64 + i] = ok ? sth[(long long)q * 3 + 1] : 1.f;
    st[128 + i] = ok ? sth[(long long)q * 3 + 2] : 0.f;
  }
}

// (1) dq, the row statistics (N, H, T, 3) and per CTA part[0..d) = sum over
// its rows of cast(dq), part[d] = sum of dqs . qn. A CTA per (pair, strip);
// tiles: Qs, dO, and slots for Kn, V and Kn^T of a key block: two where
// four tiles keep three CTAs an SM (fp32 at DP <= 32, bf16 at DP <= 64: Kn
// and V staged at once, Kn^T in the first slot after them), else one, in
// turn. (Three slots, staging a block at once, cost a CTA an SM and ran
// slower.)
template <typename T, int DP>
struct DqPlan {
  static constexpr uint32_t TILE = BwdPlan<T, DP>::TILE;
  static constexpr uint32_t y_off = align1k(BwdPlan<T, DP>::bytes);  // the second slot
  static constexpr bool TWO = y_off + TILE <= 232448 / 3;
  static constexpr uint32_t bytes = TWO ? y_off + TILE : BwdPlan<T, DP>::bytes;
};

template <typename T, int DP>
__global__ void __launch_bounds__(128, DP == 64 ? 3 : 1)
attn_general_dq(Args<T> a, const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
        float* __restrict__ part) {
  using P = BwdPlan<T, DP>;
  using Q = DqPlan<T, DP>;
  constexpr bool TWO = Q::TWO;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sq = smem + P::t0_off;
  unsigned char* sdo = smem + P::t1_off;
  unsigned char* sx = smem + P::t2_off;             // Kn, then Kn^T
  unsigned char* sy = TWO ? smem + Q::y_off : sx;   // V
  float* red = reinterpret_cast<float*>(smem + P::red_off);
  const uint32_t aq = smem_addr(sq), ado = smem_addr(sdo), ax = smem_addr(sx),
                 ay = smem_addr(sy);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long pair = blockIdx.x / a.blocks;
  const int q0 = 64 * (int)(blockIdx.x % a.blocks);
  const long long n = pair / a.heads;
  const int h = (int)(pair % a.heads);
  const float* bmh = bias_of(a.bm, a.nw, a.heads, a.t, n, h);
  const long long c_all = (long long)a.heads * a.d;
  const float sc = a.scale[h];

  stage<T, DP, NORM>(a.q, a.ld, a, n, h, q0, a.qb, sc, nullptr, sq, nullptr);
  stage<T, DP, PLAIN>(dout, c_all, a, n, h, q0, nullptr, 1.f, nullptr, sdo, nullptr);
  // S and dP of key block kb.
  auto scores = [&](int kb, float* S, float* Pd) {
    if constexpr (TWO) {
      STAGE(stage<T, DP, NORM>(a.k, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, sx, nullptr);
            stage<T, DP, PLAIN>(a.v, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, sy, nullptr));
    } else {
      STAGE(stage<T, DP, NORM>(a.k, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, sx, nullptr));
    }
    init_bias(S, bmh, a.t, q0, 64 * kb, false);
    wgmma_fence();
    mma_ss<T, 64, DP, 64, 64>(S, aq, 0, ax, 0, 1);
    if constexpr (!TWO) {
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(S);
      STAGE(stage<T, DP, PLAIN>(a.v, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, sx, nullptr));
      wgmma_fence();
    }
    mma_ss<T, 64, DP, 64, 64>(Pd, ado, 0, ay, 0, 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(S);
    fence_regs<32>(Pd);
  };

  // Walk 1: max, den and sum(dp e) online (the max is exact at the end;
  // den and the sum rescaled as it rises).
  float m[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f}, sdp[2] = {0.f, 0.f};
  float S[32], Pd[32];
  for (int kb = 0; kb < a.blocks; ++kb) {
    scores(kb, S, Pd);
    float bmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) bmax[(i % 4) / 2] = fmaxf(bmax[(i % 4) / 2], S[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float mn = fmaxf(m[j], quad_max(bmax[j]));
      const float f = __expf(m[j] - mn);
      den[j] *= f;
      sdp[j] *= f;
      m[j] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = __expf(S[i] - m[(i % 4) / 2]);
      den[(i % 4) / 2] += e;
      sdp[(i % 4) / 2] += Pd[i] * e;
    }
  }
  float delta[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    den[j] = quad_sum(den[j]);
    delta[j] = quad_sum(sdp[j]) / den[j];
    const int row = q0 + acc_row(warp, lane, 2 * j);
    if (row < a.t && lane % 4 == 0) {
      float* st = stats + (((long long)n * a.heads + h) * a.t + row) * 3;
      st[0] = m[j];
      st[1] = den[j];
      st[2] = delta[j];
    }
  }

  // Walk 2: ds, and dQs += cast(ds) Kn.
  float dqs[DP / 2];
  for (int kb = 0; kb < a.blocks; ++kb) {
    scores(kb, S, Pd);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i % 4) / 2;
      const bool ok = q0 + acc_row(warp, lane, i) < a.t;
      Pd[i] = ok ? __expf(S[i] - m[j]) * ((Pd[i] - delta[j]) / den[j]) : 0.f;
    }
    STAGE(stage<T, DP, NORM>(a.k, a.ld, a, n, h, 64 * kb, nullptr, 1.f, nullptr, nullptr, sx));
    mma_rs<T, DP>(dqs, Pd, ax, kb > 0);
  }

  // The normalisation's backward: q again from device memory, dq out, and
  // the CTA's (dqb | dscale) partial summed in a fixed order.
  float colsum[DP / 4];
  float dsc = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + acc_row(warp, lane, 2 * j);
    float qf[DP / 4], ssq = 0.f;
#pragma unroll
    for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = 8 * b + 2 * (lane % 4) + u;
        float x = 0.f;
        if (row < a.t && col < a.d) {
          x = to_f(a.q[((long long)n * a.t + row) * a.ld + (long long)h * a.d + col]);
          if (a.qb != nullptr) x = cast<T>(x + cast<T>(a.qb[h * a.d + col]));
        }
        qf[2 * b + u] = x;
        ssq += x * x;
      }
    }
    const float nrm = fmaxf(sqrtf(quad_sum(ssq)), EPS);
    float dsr = 0.f, dot = 0.f;
#pragma unroll
    for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 4 * b + 2 * j + u;
        qf[2 * b + u] = qf[2 * b + u] / nrm;
        dsr += dqs[i] * qf[2 * b + u];
        dot += (dqs[i] * sc) * qf[2 * b + u];
      }
    }
    dsr = quad_sum(dsr);
    dot = quad_sum(dot);
    const bool ok = row < a.t;
    if (ok && lane % 4 == 0) dsc += dsr;
#pragma unroll
    for (int b = 0; b < DP / 8; ++b) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 4 * b + 2 * j + u, col = 8 * b + 2 * (lane % 4) + u;
        const float v = cast<T>((dqs[i] * sc - qf[2 * b + u] * dot) / nrm);
        if (ok && col < a.d)
          dq[((long long)n * a.t + row) * a.ld + (long long)h * a.d + col] = from_f<T>(v);
        if (j == 0) colsum[2 * b + u] = ok ? v : 0.f;
        else colsum[2 * b + u] += ok ? v : 0.f;
      }
    }
  }
  // Over the 8 row groups of the warp (lanes of one lane % 4), then the warps.
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    float v = colsum[c];
    v += __shfl_xor_sync(FULL, v, 4);
    v += __shfl_xor_sync(FULL, v, 8);
    v += __shfl_xor_sync(FULL, v, 16);
    if (lane < 4) red[warp * (DP + 1) + 8 * (c / 2) + 2 * lane + c % 2] = v;
  }
  dsc = warp_sum(dsc);
  if (lane == 0) red[warp * (DP + 1) + DP] = dsc;
  __syncthreads();
  float* pc = part + (long long)blockIdx.x * (a.d + 1);
  for (int c = threadIdx.x; c <= a.d; c += 128) {
    const int col = c < a.d ? c : DP;
    pc[c] = ((red[col] + red[(DP + 1) + col]) + red[2 * (DP + 1) + col]) + red[3 * (DP + 1) + col];
  }
}

// (2) dk and dv. Tiles: Kn and V (the A operands of S^T and dP^T), and one
// slot for Qs, dO, (dO/den)^T and Qs^T in turn. Without FOLD a CTA per
// (pair, key block) walks the query strips. With FOLD (T <= 64: one key
// block, one query strip) a CTA per (group, bias slot, head) walks the
// windows of its group in order and adds ds to a 64 x 64 fp32 dbm sum in
// shared memory; at the end it writes the group's dbm partial, and the
// dbm kernel (3) is not launched. (Folded at T = 256, the 64 keys x 256
// queries sum took the shared memory of a second CTA an SM and ran slower
// than the dbm kernel.)
template <typename T, int DP>
struct FoldPlan {
  static constexpr uint32_t dbm_off = BwdPlan<T, DP>::bytes;  // T x 64 f32 after the tiles
  static constexpr uint32_t bytes = dbm_off + 64 * 64 * 4;
  // Element (query q, key kl) of the sum, 64 keys a row; the keys XORed by
  // the query's bits 1-2 so that a warp's accumulator columns hit 32 banks.
  static __device__ __forceinline__ int at(int q, int kl) { return q * 64 + (kl ^ ((q & 6) << 2)); }
};

template <typename T, int DP, bool FOLD>
__global__ void __launch_bounds__(128)
attn_general_dkdv(Args<T> a, const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                  const float* __restrict__ stats, float* __restrict__ part_bm, int groups) {
  using P = BwdPlan<T, DP>;
  using FP = FoldPlan<T, DP>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sk = smem + P::t0_off;
  unsigned char* sv = smem + P::t1_off;
  unsigned char* sx = smem + P::t2_off;
  float* st = reinterpret_cast<float*>(smem + P::st_off);
  float* sdbm = reinterpret_cast<float*>(smem + FP::dbm_off);
  const uint32_t ak = smem_addr(sk), av = smem_addr(sv), ax = smem_addr(sx);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = 64 * (int)(blockIdx.x % a.blocks);
  long long b = blockIdx.x / a.blocks;
  int h, slot = 0, grp = 0;
  long long j0, j1;  // windows slot + nW j (FOLD), or the pair's window
  if (FOLD) {
    h = (int)(b % a.heads);
    b /= a.heads;
    slot = (int)(b % a.nw);
    grp = (int)(b / a.nw);
    const long long per_slot = a.n / a.nw;
    j0 = grp * per_slot / groups;
    j1 = (grp + 1) * per_slot / groups;
    for (int i = threadIdx.x; i < 64 * a.t; i += 128) sdbm[i] = 0.f;
  } else {
    h = (int)(b % a.heads);
    j0 = b / a.heads;
    j1 = j0 + 1;
  }
  const long long c_all = (long long)a.heads * a.d;
  const float sc = a.scale[h];

  for (long long j = j0; j < j1; ++j) {
    const long long n = FOLD ? slot + (long long)a.nw * j : j;
    const float* bmh = bias_of(a.bm, a.nw, a.heads, a.t, n, h);
    const float* sth = stats + ((long long)n * a.heads + h) * a.t * 3;
    STAGE(stage<T, DP, NORM>(a.k, a.ld, a, n, h, k0, nullptr, 1.f, nullptr, sk, nullptr);
          stage<T, DP, PLAIN>(a.v, a.ld, a, n, h, k0, nullptr, 1.f, nullptr, sv, nullptr));
    float dK[DP / 2], dV[DP / 2];
    for (int s = 0; s < a.blocks; ++s) {
      const int q0 = 64 * s;
      float S[32], Pd[32];
      STAGE(load_stats(st, sth, a.t, q0);
            stage<T, DP, NORM>(a.q, a.ld, a, n, h, q0, a.qb, sc, nullptr, sx, nullptr));
      init_bias(S, bmh, a.t, q0, k0, true);
      wgmma_fence();
      mma_ss<T, 64, DP, 64, 64>(S, ak, 0, ax, 0, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(S);
      STAGE(stage<T, DP, PLAIN>(dout, c_all, a, n, h, q0, nullptr, 1.f, nullptr, sx, nullptr));
      wgmma_fence();
      mma_ss<T, 64, DP, 64, 64>(Pd, av, 0, ax, 0, 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(Pd);
      // e and ds in place of S and dP; rows are keys, columns queries.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int ql = acc_col(lane, i);
        const bool ok = q0 + ql < a.t;
        const float e = ok ? __expf(S[i] - st[ql]) : 0.f;
        Pd[i] = ok ? e * ((Pd[i] - st[128 + ql]) / st[64 + ql]) : 0.f;
        S[i] = e;
        if (FOLD && ok) sdbm[FP::at(q0 + ql, acc_row(warp, lane, i))] += Pd[i];
      }
      STAGE(stage<T, DP, DIV>(dout, c_all, a, n, h, q0, nullptr, 1.f, st + 64, nullptr, sx));
      mma_rs<T, DP>(dV, S, ax, s > 0);
      STAGE(stage<T, DP, NORM>(a.q, a.ld, a, n, h, q0, a.qb, sc, nullptr, nullptr, sx));
      mma_rs<T, DP>(dK, Pd, ax, s > 0);
    }

    // dv, and dk through the normalisation (k again from device memory).
#pragma unroll
    for (int jr = 0; jr < 2; ++jr) {
      const int key = k0 + acc_row(warp, lane, 2 * jr);
      const bool ok = key < a.t;
      const long long rowoff = ((long long)n * a.t + key) * a.ld + (long long)h * a.d;
      float kf[DP / 4], ssq = 0.f;
#pragma unroll
      for (int bb = 0; bb < DP / 8; ++bb) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 8 * bb + 2 * (lane % 4) + u;
          const float x = ok && col < a.d ? to_f(a.k[rowoff + col]) : 0.f;
          kf[2 * bb + u] = x;
          ssq += x * x;
        }
      }
      const float nrm = fmaxf(sqrtf(quad_sum(ssq)), EPS);
      float dot = 0.f;
#pragma unroll
      for (int bb = 0; bb < DP / 8; ++bb) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          kf[2 * bb + u] = kf[2 * bb + u] / nrm;
          dot += dK[4 * bb + 2 * jr + u] * kf[2 * bb + u];
        }
      }
      dot = quad_sum(dot);
#pragma unroll
      for (int bb = 0; bb < DP / 8; ++bb) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 4 * bb + 2 * jr + u, col = 8 * bb + 2 * (lane % 4) + u;
          if (ok && col < a.d) {
            dv[rowoff + col] = from_f<T>(dV[i]);
            dk[rowoff + col] = from_f<T>((dK[i] - kf[2 * bb + u] * dot) / nrm);
          }
        }
      }
    }
  }
  if (FOLD) {
    __syncthreads();
    float* dst = part_bm + (((long long)grp * a.nw + slot) * a.heads + h) * a.t * a.t;
    for (int i = threadIdx.x; i < 64 * a.t; i += 128) {
      const int kl = i % 64, q = i / 64;
      if (k0 + kl < a.t) dst[(long long)q * a.t + k0 + kl] = sdbm[FP::at(q, kl)];
    }
  }
}

// (3) dbm: a CTA per (group, bias slot, head, query strip, key block) walks
// windows slot + nW j, j in [j0, j1) of its group, in order, and writes its
// (64 x 64) block of the group's partial (G, nW, H, T, T). Tiles: Qs and
// Kn, then dO and V into two more slots where four tiles fit as in the dq
// kernel (S and dP then in one commit), else into the same two after S.
// Two rows' stagings at a time: with four at once the loads of all of them
// were scheduled together and the kernel spilled.
template <typename T, int DP>
__global__ void __launch_bounds__(128)
attn_general_dbm(Args<T> a, const T* __restrict__ dout, const float* __restrict__ stats,
         float* __restrict__ part_bm, int groups) {
  using P = BwdPlan<T, DP>;
  using Q = DqPlan<T, DP>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sa = smem + P::t0_off;                  // Qs (then dO)
  unsigned char* sb = smem + P::t1_off;                  // Kn (then V)
  unsigned char* sc2 = Q::TWO ? smem + P::t2_off : sa;   // dO
  unsigned char* sd = Q::TWO ? smem + Q::y_off : sb;     // V
  float* st = reinterpret_cast<float*>(smem + P::st_off);
  const uint32_t aa = smem_addr(sa), ab = smem_addr(sb), ac = smem_addr(sc2),
                 ad = smem_addr(sd);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  long long b = blockIdx.x;
  const int kb = (int)(b % a.blocks);
  b /= a.blocks;
  const int qs = (int)(b % a.blocks);
  b /= a.blocks;
  const int h = (int)(b % a.heads);
  b /= a.heads;
  const int slot = (int)(b % a.nw), grp = (int)(b / a.nw);
  const int q0 = 64 * qs, k0 = 64 * kb;
  const long long per_slot = a.n / a.nw;
  const long long j0 = grp * per_slot / groups, j1 = (grp + 1) * per_slot / groups;
  const float* bmh = bias_of(a.bm, a.nw, a.heads, a.t, slot, h);
  const long long c_all = (long long)a.heads * a.d;
  const float sc = a.scale[h];

  // The dbm sum of this thread's accumulator elements, in shared memory
  // (element i of thread x at i * 128 + x): in registers it stayed live
  // across the staging and the kernel spilled.
  float* acc = reinterpret_cast<float*>(smem + Q::bytes);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i * 128 + threadIdx.x] = 0.f;
  for (long long j = j0; j < j1; ++j) {
    const long long n = slot + a.nw * j;
    const float* sth = stats + ((long long)n * a.heads + h) * a.t * 3;
    float S[32], Pd[32];
    STAGE(load_stats(st, sth, a.t, q0);
          stage<T, DP, NORM>(a.q, a.ld, a, n, h, q0, a.qb, sc, nullptr, sa, nullptr);
          stage<T, DP, NORM>(a.k, a.ld, a, n, h, k0, nullptr, 1.f, nullptr, sb, nullptr));
    if (Q::TWO)
      STAGE(stage<T, DP, PLAIN>(dout, c_all, a, n, h, q0, nullptr, 1.f, nullptr, sc2, nullptr);
            stage<T, DP, PLAIN>(a.v, a.ld, a, n, h, k0, nullptr, 1.f, nullptr, sd, nullptr));
    init_bias(S, bmh, a.t, q0, k0, false);
    wgmma_fence();
    mma_ss<T, 64, DP, 64, 64>(S, aa, 0, ab, 0, 1);
    if (!Q::TWO) {
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(S);
      STAGE(stage<T, DP, PLAIN>(dout, c_all, a, n, h, q0, nullptr, 1.f, nullptr, sa, nullptr);
            stage<T, DP, PLAIN>(a.v, a.ld, a, n, h, k0, nullptr, 1.f, nullptr, sb, nullptr));
      wgmma_fence();
    }
    mma_ss<T, 64, DP, 64, 64>(Pd, ac, 0, ad, 0, 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(S);
    fence_regs<32>(Pd);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ql = acc_row(warp, lane, i);
      if (q0 + ql < a.t)
        acc[i * 128 + threadIdx.x] +=
            __expf(S[i] - st[ql]) * ((Pd[i] - st[128 + ql]) / st[64 + ql]);
    }
  }
  float* dst = part_bm + (((long long)grp * a.nw + slot) * a.heads + h) * a.t * a.t;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int q = q0 + acc_row(warp, lane, i), key = k0 + acc_col(lane, i);
    if (q < a.t && key < a.t) dst[(long long)q * a.t + key] = acc[i * 128 + threadIdx.x];
  }
}

// (4) Blocks [0, H (d + 1)): dqb (when given) and dscale, one CTA per (head,
// column c <= d) summing the dq kernel's partials of that head in a fixed
// order. The rest: dbm, one thread an element, over the groups in order.
__global__ void __launch_bounds__(128)
attn_general_reduce(const float* __restrict__ part, const float* __restrict__ part_bm,
            float* __restrict__ dqb, float* __restrict__ dscale, float* __restrict__ dbm, int n,
            int heads, int d, int blocks, int groups, long long n_bm) {
  const int nq = heads * (d + 1);
  if ((int)blockIdx.x >= nq) {
    const long long i = (long long)(blockIdx.x - nq) * 128 + threadIdx.x;
    if (i < n_bm) {
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s += part_bm[g * n_bm + i];
      dbm[i] = s;
    }
    return;
  }
  __shared__ float red[128];
  const int c = blockIdx.x % (d + 1), h = blockIdx.x / (d + 1);
  const long long terms = (long long)n * blocks;
  float s = 0.f;
  for (long long i = threadIdx.x; i < terms; i += 128) {
    const long long w = i / blocks, blk = i % blocks;
    s += part[((w * heads + h) * blocks + blk) * (d + 1) + c];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = 64; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (c == d) dscale[h] = red[0];
    else if (dqb != nullptr) dqb[h * d + c] = red[0];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

bool valid(int n, int t, int heads, int d, int nw) {
  return n > 0 && heads > 0 && nw > 0 && n % nw == 0 && t >= 1 && t <= MAX_T && d >= 1 &&
         d <= MAX_D;
}

// Calls f(int constant DP) with the padded head width of d.
template <typename F>
cudaError_t by_width(int d, F f) {
  if (d <= 16) return f(std::integral_constant<int, 16>());
  if (d <= 32) return f(std::integral_constant<int, 32>());
  if (d <= 64) return f(std::integral_constant<int, 64>());
  if (d <= 128) return f(std::integral_constant<int, 128>());
  return cudaErrorInvalidValue;
}

// Calls f(int constant NBR) with the forward's register plan for `blocks`
// 64-key blocks: the strip's S in registers for one block, and for bf16 up
// to 4 blocks; else 0 (two passes). fp32 at 64 < T <= 256 takes two passes:
// with S in registers beside the tf32 fragments its kernel held 220
// registers (two CTAs an SM) and ran slower at ScOT-B stage 0 than the
// two-pass kernel, which holds fewer and runs three CTAs an SM.
template <typename T, typename F>
cudaError_t by_blocks(int blocks, F f) {
  if (blocks <= 1) return f(std::integral_constant<int, 1>());
  if constexpr (std::is_same<T, bf16>::value)
    if (blocks <= 4) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 0>());
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, uint32_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t run_fwd(const Args<T>& a, T* out, long long ldo, cudaStream_t stream) {
  const unsigned grid = (unsigned)((long long)a.n * a.heads * a.blocks);
  return by_width(a.d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    return by_blocks<T>(a.blocks, [&](auto nb) {
      constexpr int NBR = decltype(nb)::value;
      auto k = attn_general_fwd<T, DP, NBR>;
      constexpr uint32_t smem = FwdPlan<T, DP, NBR>::bytes;
      cudaError_t err = allow_smem(k, smem);
      if (err != cudaSuccess) return err;
      k<<<grid, 128, smem, stream>>>(a, out, ldo);
      return cudaGetLastError();
    });
  });
}

template <typename T>
cudaError_t run_bwd(const Args<T>& a, const T* dout, T* dq, T* dk, T* dv, float* dqb, float* dbm,
                    float* dscale, float* stats, float* part, float* part_bm, int groups,
                    cudaStream_t stream) {
  const unsigned grid = (unsigned)((long long)a.n * a.heads * a.blocks);
  cudaError_t err = by_width(a.d, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    constexpr uint32_t smem = BwdPlan<T, DP>::bytes;
    auto kq = attn_general_dq<T, DP>;
    cudaError_t e = allow_smem(kq, DqPlan<T, DP>::bytes);
    if (e != cudaSuccess) return e;
    kq<<<grid, 128, DqPlan<T, DP>::bytes, stream>>>(a, dout, dq, stats, part);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    // dbm folded into the dk/dv kernel at T <= 64: the rule of
    // ops/window_attention.py's general_bwd_plan.
    if (a.blocks == 1) {
      auto kk = attn_general_dkdv<T, DP, true>;
      constexpr uint32_t fsmem = FoldPlan<T, DP>::bytes;
      if ((e = allow_smem(kk, fsmem)) != cudaSuccess) return e;
      kk<<<(unsigned)(groups * a.nw * a.heads), 128, fsmem, stream>>>(a, dout, dk, dv, stats,
                                                                      part_bm, groups);
      return cudaGetLastError();
    }
    auto kk = attn_general_dkdv<T, DP, false>;
    if ((e = allow_smem(kk, smem)) != cudaSuccess) return e;
    kk<<<grid, 128, smem, stream>>>(a, dout, dk, dv, stats, nullptr, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    auto kb = attn_general_dbm<T, DP>;
    constexpr uint32_t bsmem = DqPlan<T, DP>::bytes + 32 * 128 * 4;  // tiles, dbm sum
    if ((e = allow_smem(kb, bsmem)) != cudaSuccess) return e;
    const unsigned gb = (unsigned)((long long)groups * a.nw * a.heads * a.blocks * a.blocks);
    kb<<<gb, 128, bsmem, stream>>>(a, dout, stats, part_bm, groups);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const long long n_bm = (long long)a.nw * a.heads * a.t * a.t;
  const unsigned gr = (unsigned)(a.heads * (a.d + 1) + (n_bm + 127) / 128);
  attn_general_reduce<<<gr, 128, 0, stream>>>(part, part_bm, dqb, dscale, dbm, a.n, a.heads, a.d,
                                      a.blocks, groups, n_bm);
  return cudaGetLastError();
}

template <typename T>
Args<T> args(const void* q, const void* k, const void* v, long long ld, const void* qb,
             const void* bm, const void* scale, int n, int t, int heads, int d, int nw) {
  return {static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ld,
          static_cast<const float*>(qb), static_cast<const float*>(bm),
          static_cast<const float*>(scale), n, t, heads, d, nw, (t + 63) / 64};
}

}  // namespace

// q, k, v: base pointers of the (N, T, H, D) rows with row stride ld (3C
// inside a packed QKV tensor, C for separate tensors); qb may be null; out
// (N, T, C) with row stride ldo. fp32 != 0 for fp32 operands, else bf16.
extern "C" int window_attention_general_fwd(const void* q, const void* k, const void* v,
                                            const void* qb, const void* bm, const void* scale,
                                            void* out, int ld, int ldo, int n_win, int t,
                                            int heads, int d, int nw, int fp32, void* stream) {
  if (!valid(n_win, t, heads, d, nw)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return (int)run_fwd(args<float>(q, k, v, ld, qb, bm, scale, n_win, t, heads, d, nw),
                        static_cast<float*>(out), ldo, s);
  return (int)run_fwd(args<bf16>(q, k, v, ld, qb, bm, scale, n_win, t, heads, d, nw),
                      static_cast<bf16*>(out), ldo, s);
}

// The backward: dout (N, T, C); dq, dk, dv written at the offsets of q, k,
// v (row stride ld); dqb (C,) (may be null), dbm (nW, H, T, T) and dscale
// (H,) fp32; scratch: stats (N, H, T, 3), part (N H ceil(T/64), D + 1) and
// part_bm (groups, nW, H, T, T) fp32; 1 <= groups <= N / nW.
extern "C" int window_attention_general_bwd(const void* q, const void* k, const void* v,
                                            const void* qb, const void* bm, const void* scale,
                                            const void* dout, void* dq, void* dk, void* dv,
                                            void* dqb, void* dbm, void* dscale, void* stats,
                                            void* part, void* part_bm, int ld, int n_win,
                                            int t, int heads, int d, int nw, int groups,
                                            int fp32, void* stream) {
  if (!valid(n_win, t, heads, d, nw) || groups < 1 || groups > n_win / nw)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f[6] = {static_cast<float*>(dqb),   static_cast<float*>(dbm),
                 static_cast<float*>(dscale), static_cast<float*>(stats),
                 static_cast<float*>(part),  static_cast<float*>(part_bm)};
  if (fp32)
    return (int)run_bwd(args<float>(q, k, v, ld, qb, bm, scale, n_win, t, heads, d, nw),
                        static_cast<const float*>(dout), static_cast<float*>(dq),
                        static_cast<float*>(dk), static_cast<float*>(dv), f[0], f[1], f[2], f[3],
                        f[4], f[5], groups, s);
  return (int)run_bwd(args<bf16>(q, k, v, ld, qb, bm, scale, n_win, t, heads, d, nw),
                      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
                      static_cast<bf16*>(dk), static_cast<bf16*>(dv), f[0], f[1], f[2], f[3],
                      f[4], f[5], groups, s);
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// kernel 0-6 (forward with S in registers at T <= 64 / T <= 256, forward
// in two passes, dq, dk/dv, dbm, dk/dv with dbm folded in) for fp32 or bf16
// operands and the padded head width dp in {16, 32, 64, 128}; kernel 1 is
// not built for fp32 (by_blocks).
extern "C" int window_attention_general_info(int kernel, int fp32, int dp, int* out) {
  if (kernel < 0 || kernel > 6 || (dp != 16 && dp != 32 && dp != 64 && dp != 128))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  uint32_t smem = 0;
  const cudaError_t err = by_width(dp, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    auto pick = [&](auto t) {
      using T = decltype(t);
      const void* fns[7] = {(const void*)attn_general_fwd<T, DP, 1>, nullptr,
                            (const void*)attn_general_fwd<T, DP, 0>, (const void*)attn_general_dq<T, DP>,
                            (const void*)attn_general_dkdv<T, DP, false>,
                            (const void*)attn_general_dbm<T, DP>,
                            (const void*)attn_general_dkdv<T, DP, true>};
      if constexpr (std::is_same<T, bf16>::value) fns[1] = (const void*)attn_general_fwd<T, DP, 4>;
      if (fns[kernel] == nullptr) return cudaErrorInvalidValue;
      smem = kernel == 0   ? FwdPlan<T, DP, 1>::bytes
             : kernel == 1 ? FwdPlan<T, DP, 4>::bytes
             : kernel == 2 ? FwdPlan<T, DP, 0>::bytes
             : kernel == 4 ? BwdPlan<T, DP>::bytes
             : kernel == 3 ? DqPlan<T, DP>::bytes
             : kernel == 5 ? DqPlan<T, DP>::bytes + 32 * 128 * 4
                           : FoldPlan<T, DP>::bytes;
      return cudaFuncGetAttributes(&attr, fns[kernel]);
    };
    return fp32 ? pick(0.f) : pick(bf16());
  });
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
