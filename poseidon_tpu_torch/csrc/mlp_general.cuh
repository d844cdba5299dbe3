// The general MLP machinery on Hopper (sm_90a), shared by mlp_general.cu
// (the fused block MLP) and mlp_cln_general.cu (the fused block tail): the
// forward's main loop, the backward's rows and weight kernels, the weight
// prologue, the sum of F splits and the reduce, their plans and scratch
// layout. For bf16 or fp32 operands, any width C <= 1024 and any hidden
// width F <= 4096.
//
// Every product runs on the tensor cores through wgmma (wgmma.cuh): bf16
// operands as m64nNk16, fp32 operands as three m64nNk8 tf32 products of the
// split x = hi + lo (hi = tf32(x), lo = tf32(x - hi); a.b = lo.hi + hi.lo +
// hi.hi, "3xTF32"), accumulated in fp32: near fp32 round-off, where one
// tf32 product (10 mantissa bits) would miss the fp32 accuracy of the JAX
// kernels.
//
// Bound on this card. The forward does 4 M C F FLOPs on (2 M C + 2 C F)
// operands, the backward 10 M C F (u recomputed): with fp32 operands the
// tensor cores issue three tf32 products a product at 495 TFLOP/s, a ridge
// of 148 FLOPs a byte against about F / 2 (forward) and 5 F / 4 (backward)
// at large M, so the tensor cores bound both at every F the models have;
// bf16 as the wgmma kernels (F / 2 over a ridge of 295: bytes at F <= 576).
//
// Operands. wgmma reads B from shared memory, and with 32-bit operands
// K-major only; A may come from registers. So every B operand is a weight
// matrix or a pre-split copy in device memory that a prologue launch (prep)
// writes once per call in the layout wgmma reads: padded with zeros to
// whole tiles (C to a multiple of 16, F to a multiple of 64, the output
// columns to whole warpgroup widths), transposed where the product reduces
// along the weight's rows, split into its hi and lo parts for fp32, and,
// where the A operand is an accumulator repacked in registers (g, du), its
// reduction index permuted by tf32_pos. The ring stages are then whole
// 16-byte cp.async copies with no masking. Every A operand is staged raw (x
// and dy rows, or du and g) in shared memory, row-major with a stride of 4
// words over a multiple of 8 so that the fragment loads of a warp hit 32
// banks, and the register operand of each k step is loaded from there and
// split in registers: half the shared memory of hi and lo tiles, which lets
// 128 rows of x and dy stay resident beside the weight ring.
//
// Forward (mlp_general_fwd_kernel). A CTA holds one or two warpgroups, each
// on its own 64 rows, and one block of NW <= 192 output columns (C > 192:
// several blocks, u recomputed per block). F is walked in steps of FT
// hidden columns through a ring of weight slabs that cp.async fills NS - 1
// items ahead: the step's W1 rows (in chunks of KC columns) and W2 columns
// (in pieces of at most 24 KB). Per step each warpgroup computes u for its
// rows in registers (A: x from shared memory), adds b1 and the GELU there,
// and adds g . W2^T to its output sum with g repacked as the register A
// operand (tf32_frag or a_frag): u is computed once per row and block, and
// g never leaves the registers. Where 64 or 128 rows of x do not fit beside
// the ring (fp32 C > ~450), x is staged in the ring items beside the W1
// chunks. Where the row tiles and blocks leave SMs idle, F is split across
// CTAs (grid z), each writing an fp32 partial that a reduce launch sums in
// order with b2.
//
// Backward (four launches, no atomics: two calls give the same bits):
//  (1) prep: W1 and W2^T for u and dh, W1^T (permuted) for dx;
//  (2) rows (mlp_general_rows_kernel): as the forward, per step u = x W1^T
//      and dh = dy W2 (A: x and dy resident in shared memory), then du and
//      g in registers, dx += cast(du) W1 with du repacked as the register A
//      operand; cast(du) and g are written once, transposed (F, M), for
//      the weight products, with db1's per-tile column sums (from the fp32
//      du); the first column block also writes db2's per-tile sums and x and
//      dy transposed and split, (C, M), the weight products' B operands.
//      One warpgroup a CTA and two CTAs an SM where they fit (the two run
//      unsynchronised); at fp32 C = 192, where x and dy of 64 rows fill
//      half the SM, two warpgroups share the 64 rows and split each step's
//      hidden columns, their partial dx added in order at the end;
//  (3) weights (mlp_general_dw_kernel): per 64 hidden rows, one column
//      block and one of R row splits, warpgroup 0 takes dW1 = cast(du)^T x
//      and warpgroup 1 dW2^T = g^T dy over the split's rows (A: the
//      transposed du and g, B: the transposed x and dy), each an fp32
//      partial;
//  (4) reduce: the R partials of dW1 and dW2 and the per-tile sums of db1
//      and db2, each in a fixed order.
// With F split across CTAs in (2), dx is an fp32 partial per split too,
// summed with the forward's reduce.
//
// What bounds them: the ring. Every item ends in a wait for its products
// and a block barrier, and each CTA copies every weight slab from L2: at
// fp32, 8 bytes a weight value for 6 tensor FLOPs a row, so the rows a CTA
// holds (128, or 64 where x and dy do not fit) set how much work each
// copied byte carries (PERF.md has the times against the bounds).
//
// Hooks. The forward kernel ends in its epilogue's store<T, NW>(args, sum,
// rows, column block, split), with the warpgroup's fp32 output sum still in
// registers: StoreEpi writes cast(sum + b2) (an fp32 partial under an F
// split), the fused tail's epilogue takes the conditional LayerNorm and the
// residual there. The backward adds an optional residual (RowsArgs::res) to
// its fp32 dx sum before the one rounding, in the rows kernel or, under an
// F split, in the sum of the splits.

#pragma once

#include "mlp_tile.cuh"

#include <type_traits>

namespace mlp_gen {

using namespace wgm;
using mlp_fwd_tile::prepare_launch;

constexpr int MAX_C = 1024;
constexpr int MAX_F = 4096;
constexpr int SMEM = 232448;  // shared memory a block may use
constexpr int NWMAX = 192;    // output columns a warpgroup holds
constexpr int KQ = 16;        // C is padded to a multiple of this
constexpr int FQ = 64;        // F is padded to a multiple of this (the dW tiles)
constexpr float INV_SQRT2 = 0.7071067811865476f;
constexpr float INV_SQRT2PI = 0.3989422804014327f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <typename T> __device__ __forceinline__ float cast(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float gelu(float u) { return 0.5f * u * (1.f + erff(u * INV_SQRT2)); }
__device__ __forceinline__ float dgelu(float u) {
  return 0.5f * (1.f + erff(u * INV_SQRT2)) + u * expf(-0.5f * u * u) * INV_SQRT2PI;
}

template <typename T> struct Fmt;
template <> struct Fmt<bf16> {
  static constexpr int EB = 2, KS = 16, PARTS = 1;  // bytes, k of a wgmma step, tiles (hi, lo)
};
template <> struct Fmt<float> {
  static constexpr int EB = 4, KS = 8, PARTS = 2;
};
template <typename T> constexpr bool F32 = std::is_same<T, float>::value;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return cdiv(a, b) * b; }
// One part (hi or lo) of a swizzled K-major tile of `rows` rows by kbytes.
__host__ __device__ inline uint32_t part_bytes(int rows, int kbytes) {
  return align1k((uint32_t)rows * kbytes);
}
// Words (4 bytes) a row of a raw tile of k elements takes: k words and 4
// more, so that the rows r, r + 1, .. of a fragment load start 4 banks
// apart.
template <typename T> __host__ __device__ inline int raw_stride(int k) {
  return k * Fmt<T>::EB / 4 + 4;
}
// tf32_pos inverted: the k whose value sits at position p of its group of 8.
__host__ __device__ inline int tf32_src(int p) {
  return (p & ~7) | ((p & 7) < 4 ? 2 * (p & 7) : 2 * ((p & 7) - 4) + 1);
}

// cp.async of rows [r0, r0 + rows) by elements [k0, k0 + kx) of a
// row-major pre-split array (ld elements a row, part p at src + p *
// pstride) into the tile at dst (Fmt::PARTS parts of part_bytes each). The
// thread's (row, chunk) advances by adds: two divisions a call.
template <typename T>
__device__ __forceinline__ void load_b(uint32_t dst, const T* __restrict__ src, long long pstride,
                                       int ld, int r0, int k0, int rows, int kx, int tid, int n) {
  constexpr int V = 16 / Fmt<T>::EB;
  const int kb = kx * Fmt<T>::EB, ash = atom_log2(atom_bytes(kb)), cpr = kx / V;
  const uint32_t pb = part_bytes(rows, kb);
  int r = tid / cpr, v = tid - r * cpr;
  const int dr = n / cpr, dv = n - dr * cpr;
  for (; r < rows;) {
    const T* s = src + (long long)(r0 + r) * ld + k0 + v * V;
    const uint32_t o = tile_off_rt(r, 16 * v, rows, ash);
#pragma unroll
    for (int p = 0; p < Fmt<T>::PARTS; ++p) cp_async16(dst + p * pb + o, s + p * pstride, true);
    r += dr;
    v += dv;
    if (v >= cpr) {
      v -= cpr;
      ++r;
    }
  }
}

// Rows [m0, m0 + rows) by elements [k0, k0 + kx) of a (M, C) array into a
// raw row-major tile (stride S words) at dst, zeros past M and C. mode 2:
// 16-byte cp.async (rows of a multiple of 16 bytes); 1: 4-byte cp.async;
// 0: loads and stores by the threads (bf16 rows of an odd width).
template <typename T>
__device__ __forceinline__ void load_a(unsigned char* dst, int S, const T* __restrict__ src, int M,
                                       int C, long long m0, int rows, int k0, int kx, int mode,
                                       int tid, int n) {
  constexpr int EB = Fmt<T>::EB;
  const uint32_t d = smem_addr(dst);
  if (mode == 2) {
    constexpr int V = 16 / EB;
    for (int i = tid; i < rows * (kx / V); i += n) {
      const int r = i / (kx / V), c = k0 + (i % (kx / V)) * V;
      const bool ok = m0 + r < M && c < C;
      cp_async16(d + r * S * 4 + (c - k0) * EB, ok ? src + (m0 + r) * C + c : src, ok);
    }
  } else if (mode == 1) {
    constexpr int V = 4 / EB;
    for (int i = tid; i < rows * (kx / V); i += n) {
      const int r = i / (kx / V), c = k0 + (i % (kx / V)) * V;
      const bool ok = m0 + r < M && c < C;
      cp_async4(d + r * S * 4 + (c - k0) * EB, ok ? src + (m0 + r) * C + c : src, ok);
    }
  } else {
    for (int i = tid; i < rows * kx; i += n) {
      const int r = i / kx, c = k0 + i % kx;
      const T v = m0 + r < M && c < C ? src[(m0 + r) * C + c] : from_f<T>(0.f);
      *reinterpret_cast<T*>(dst + r * S * 4 + (c - k0) * EB) = v;
    }
  }
}

// How load_a reads a (M, C) array at p.
template <typename T>
inline int load_mode(const void* p, int C) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((C * Fmt<T>::EB) % 16 == 0 && a % 16 == 0) return 2;
  if ((C * Fmt<T>::EB) % 4 == 0 && a % 4 == 0) return 1;
  return 0;
}

template <int N>
__device__ __forceinline__ void zero(float* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// acc (ACC: +)= A . B^T over kx elements (a multiple of Fmt::KS): A the
// warpgroup's 64 rows from row0 of a raw tile at A (stride S words, from
// word w0), B rows [rb, rb + N) (rb a multiple of 8) of the (R x kx) tile
// at b. Each k step's register operand is loaded (and for fp32 split)
// while the previous step's products run (DEPTH 2: two steps' products in
// flight; 1: each step's retired before the next, one fragment buffer, for
// kernels that would otherwise spill). Waits for its products. ACC is a
// template argument: a run-time scale-d operand makes ptxas serialize the
// kernel's wgmmas.
template <typename T, int N, bool ACC, int DEPTH = 2>
__device__ __forceinline__ void mma_raw(float* acc, const uint32_t* A, int S, int row0, int w0,
                                        uint32_t b, int R, int rb, int kx) {
  constexpr int KS = Fmt<T>::KS;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t* p0 = A + (row0 + 16 * warp + lane / 4) * S + w0 + lane % 4;
  const uint32_t* p1 = p0 + 8 * S;
  const int kb = kx * Fmt<T>::EB, akb = atom_bytes(kb), steps = kx / KS;
  const uint32_t pb = part_bytes(R, kb);
  // The descriptor of k step kk: the step's start address (in 16-byte
  // units) added to the first step's, 32 bytes a step within an atom, a
  // whole atom (R rows) at each atom boundary. Row rb starts rb atom rows
  // into each atom, on the swizzle's period.
  const uint64_t d0 = desc_rt(b + rb * akb, 0, R, akb);
  const int ash = atom_log2(akb), pash = ash - 5;  // 2^pash steps an atom
  auto dstep = [&](int kk) {
    return d0 + (uint64_t)(((((kk >> pash) * R) << ash) + ((kk & ((1 << pash) - 1)) << 5)) >> 4);
  };
  uint32_t v[4] = {p0[0], p1[0], p0[4], p1[4]};
  auto next = [&](int kk) {
    if (kk < steps) {
      v[0] = p0[8 * kk];
      v[1] = p1[8 * kk];
      v[2] = p0[8 * kk + 4];
      v[3] = p1[8 * kk + 4];
    }
  };
  if constexpr (F32<T>) {
    uint32_t h0[4], l0[4], h1[4], l1[4];
    auto step = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4], uint32_t (&ho)[4],
                    uint32_t (&lo)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(v[e]), h[e], l[e]);
      wgmma_fence();
      const uint64_t bh = dstep(kk), bl = bh + (pb >> 4);
      MmaTf32<N>::rs(acc, l, bh, ACC || kk > 0);
      MmaTf32<N>::rs(acc, h, bl, 1);
      MmaTf32<N>::rs(acc, h, bh, 1);
      wgmma_commit();
      next(kk + 1);
      wgmma_wait<DEPTH - 1>();
      keep_regs<4>(ho);
      keep_regs<4>(lo);
    };
    for (int kk = 0; kk < steps; kk += 2) {
      if constexpr (DEPTH == 1) {
        step(kk, h0, l0, h0, l0);
        if (kk + 1 < steps) step(kk + 1, h0, l0, h0, l0);
      } else {
        step(kk, h0, l0, h1, l1);
        if (kk + 1 < steps) step(kk + 1, h1, l1, h0, l0);
      }
    }
    wgmma_wait<0>();
    keep_regs<4>(h0);
    keep_regs<4>(l0);
    keep_regs<4>(h1);
    keep_regs<4>(l1);
  } else {
    // bf16 needs no split: the next step's operand is loaded straight into
    // the buffer the step before last has released (a copy from a staging
    // register may be coalesced with it, which makes ptxas serialize).
    uint32_t a0[4] = {v[0], v[1], v[2], v[3]}, a1[4];
    auto step = [&](int kk, uint32_t (&a)[4], uint32_t (&ao)[4]) {
      wgmma_fence();
      Mma<N>::rs(acc, a, dstep(kk), ACC || kk > 0);
      wgmma_commit();
      wgmma_wait<DEPTH - 1>();
      keep_regs<4>(ao);
      if (kk + 1 < steps) {
        ao[0] = p0[8 * (kk + 1)];
        ao[1] = p1[8 * (kk + 1)];
        ao[2] = p0[8 * (kk + 1) + 4];
        ao[3] = p1[8 * (kk + 1) + 4];
      }
    };
    for (int kk = 0; kk < steps; kk += 2) {
      step(kk, a0, a1);
      if (kk + 1 < steps) step(kk + 1, a1, a0);
    }
    wgmma_wait<0>();
    keep_regs<4>(a0);
    keep_regs<4>(a1);
  }
  fence_regs<N / 2>(acc);
}

// acc += src . B^T over K elements [K0, K0 + KP) of src, an m64nFT
// accumulator (values already rounded to T) as the register A operand, B
// the N rows of the tile at b from byte kb0 along its k (KT elements a
// row), its reduction index permuted by tf32_pos for fp32. Every fragment
// is made before the first product and the products go as one group: a
// fragment written while an earlier group of the same operand is in flight
// makes ptxas serialize the kernel's wgmmas. Waits for its products.
template <typename T, int N, int KP, int K0, int KT>
__device__ __forceinline__ void mma_acc(float* acc, const float* src, uint32_t b, int kb0) {
  constexpr int kb = KT * Fmt<T>::EB, akb = kb % 128 == 0 ? 128 : kb % 64 == 0 ? 64 : 32;
  constexpr uint32_t pb = (N * kb + 1023u) & ~1023u;
  if constexpr (F32<T>) {
    uint32_t hi[KP / 8][4], lo[KP / 8][4];
#pragma unroll
    for (int q = 0; q < KP / 8; ++q) tf32_frag(src, K0 / 8 + q, hi[q], lo[q]);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < KP / 8; ++q) {
      const uint64_t bh = desc_rt(b, kb0 + 32 * q, N, akb), bl = bh + (pb >> 4);
      MmaTf32<N>::rs(acc, lo[q], bh, 1);
      MmaTf32<N>::rs(acc, hi[q], bl, 1);
      MmaTf32<N>::rs(acc, hi[q], bh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs<KP / 2>(&hi[0][0]);
    keep_regs<KP / 2>(&lo[0][0]);
  } else {
    uint32_t a[KP / 16][4];
#pragma unroll
    for (int q = 0; q < KP / 16; ++q) a_frag(src, K0 / 16 + q, a[q]);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < KP / 16; ++q) Mma<N>::rs(acc, a[q], desc_rt(b, kb0 + 32 * q, N, akb), 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep_regs<KP / 4>(&a[0][0]);
  }
  fence_regs<N / 2>(acc);
}

// Pieces of the second product's slab (its reduction index, the step's
// FT hidden columns, cut in NP): each piece a ring item of at most 24 KB
// (at most 48 KB a slab at every instantiation: one or two pieces).
template <typename T, int NW, int FT>
__host__ __device__ constexpr int pieces() {
  return Fmt<T>::PARTS * NW * FT * Fmt<T>::EB <= 24576 ? 1 : 2;
}

// The backward's split of a step's hidden columns over two warpgroups: at
// the widest output block only (the only one where x and dy of 128 rows do
// not fit), so that the other widths carry no code for it.
template <int NW>
__host__ __device__ constexpr bool can_split() {
  return NW == 192;
}

// mma_acc of piece p of NP of a warpgroup's FT hidden columns. With KS
// warpgroups splitting a step's hidden columns, a piece holds the p-th
// piece of each in turn, and warpgroup k takes the k-th.
template <typename T, int N, int FT, int NP, int KS>
__device__ __forceinline__ void mma_piece(float* acc, const float* src, uint32_t b, int p, int k) {
  static_assert(Fmt<T>::PARTS * N * FT * Fmt<T>::EB <= 49152, "one or two pieces");
  constexpr int KP = FT / NP, KT = KS * KP;
  const int kb0 = k * KP * Fmt<T>::EB;
  if (p == 0) mma_acc<T, N, KP, 0, KT>(acc, src, b, kb0);
  if constexpr (NP > 1) {
    if (p == 1) mma_acc<T, N, KP, KP, KT>(acc, src, b, kb0);
  }
}

// Waits until at most n (of a ring of at most four slots: n <= 2) copy
// groups of this thread are pending.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// Stores the warpgroup's m64nNW accumulator to rows m0.. and columns c0..
// of a (M, C) array: cast(acc + bias + res) (bias and res, a (M, C) array
// of the output type, may be null) in the output type U, pairs of columns at
// once where the rows allow.
template <typename U, int NW>
__device__ __forceinline__ void store_acc(const float* acc, U* __restrict__ out, const float* bias,
                                          int M, int C, long long m0, int c0,
                                          const U* __restrict__ res = nullptr) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool pairs = C % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(U)) == 0;
#pragma unroll
  for (int e = 0; e < NW / 2; e += 2) {
    const long long m = m0 + acc_row(warp, lane, e);
    const int c = c0 + acc_col(lane, e);
    if (m >= M || c >= C) continue;
    float v0 = acc[e], v1 = acc[e + 1];
    if (bias != nullptr) {
      v0 += bias[c];
      if (c + 1 < C) v1 += bias[c + 1];
    }
    if (res != nullptr) {
      v0 += to_f(res[m * C + c]);
      if (c + 1 < C) v1 += to_f(res[m * C + c + 1]);
    }
    U* o = out + m * C + c;
    if (pairs) {
      if constexpr (std::is_same<U, float>::value) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(o) = pack2(v0, v1);
      }
    } else {
      o[0] = from_f<U>(v0);
      if (c + 1 < C) o[1] = from_f<U>(v1);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// The walk over F shared by the forward and the backward's rows kernel:
// the CTA's steps [s0, s1) of ks x FT hidden columns (ks warpgroups on the
// same rows splitting a step, or 1), each of nmat x nk items of the first
// product (chunks of KC columns of W1 and, for the backward, of W2^T) and
// NP items of the second (pieces of the W2 or W1^T slab of the CTA's
// output columns), one ring slot each.
struct Walk {
  int M, C, CP, FP, CPo, KC, nk, xres, S, nsteps, spz, NS, ks;
  uint32_t xbytes, xt, slot;  // resident x (and dy), one of them, a slot
};

// Item i of the walk from step s0: t = i % (nmat nk + np); t < nmat nk:
// chunk t % nk of matrix t / nk; else piece t - nmat nk.
struct Item {
  int j, mat, chunk, piece, kx;
};

__device__ __forceinline__ Item item_of(const Walk& w, int nmat, int np, int s0, int i) {
  const int per = nmat * w.nk + np, t = i % per;
  Item it;
  it.j = s0 + i / per;
  it.mat = t < nmat * w.nk ? t / w.nk : -1;
  it.chunk = t % w.nk;
  it.piece = t - nmat * w.nk;
  it.kx = min(w.KC, w.CP - it.chunk * w.KC);
  return it;
}

template <typename T>
struct FwdArgs {
  const T* x;
  const T* w1s;   // (FP, CP) per part
  const T* w2s;   // (CPo, FP) per part, F permuted by tf32_pos for fp32
  const float* b1p;
  const float* b2;
  T* out;
  float* part;    // (Z, M, C) where F is split
  int amode;
  Walk w;
};

template <typename T, int NW, int FT, class Epi>
__global__ void __launch_bounds__(256, 1)
mlp_general_fwd_kernel(const FwdArgs<T> a, const Epi e) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int EB = Fmt<T>::EB, PARTS = Fmt<T>::PARTS, NP = pieces<T, NW, FT>();
  const Walk& w = a.w;
  const int tid = threadIdx.x, nthr = blockDim.x, wg = tid / 128, lane = tid % 32;
  const int BM = nthr / 2;  // 64 rows a warpgroup
  const long long m0 = (long long)blockIdx.x * BM;
  const int cb = blockIdx.y, z = blockIdx.z;
  const int s0 = z * w.spz, s1 = min(w.nsteps, s0 + w.spz);
  const int items = (s1 - s0) * (w.nk + NP);
  const long long pw1 = (long long)w.FP * w.CP, pw2 = (long long)w.CPo * w.FP;
  auto slot = [&](int i) { return smem + w.xbytes + (uint32_t)(i % w.NS) * w.slot; };
  // Where x is not resident, its chunk follows the W1 chunk in the item.
  auto xchunk = [&](int i, int kx) { return slot(i) + PARTS * part_bytes(FT, kx * EB); };

  auto load_item = [&](int i) {
    const Item it = item_of(w, 1, NP, s0, i);
    const uint32_t st = smem_addr(slot(i));
    if (it.mat == 0) {
      load_b<T>(st, a.w1s, pw1, w.CP, it.j * FT, it.chunk * w.KC, FT, it.kx, tid, nthr);
      if (!w.xres)
        load_a<T>(xchunk(i, it.kx), w.S, a.x, w.M, w.C, m0, BM, it.chunk * w.KC, it.kx, a.amode,
                  tid, nthr);
    } else {
      load_b<T>(st, a.w2s, pw2, w.FP, cb * NW, it.j * FT + it.piece * (FT / NP), NW, FT / NP, tid,
                nthr);
    }
  };

  if (w.xres) load_a<T>(smem, w.S, a.x, w.M, w.C, m0, BM, 0, w.CP, a.amode, tid, nthr);
  for (int s = 0; s < w.NS - 1; ++s) {
    if (s < items) load_item(s);
    cp_async_commit();
  }
  // u only ever written by wgmma (the first chunk of a step overwrites it),
  // g beside it.
  float y[NW / 2], u[FT / 2], g[FT / 2];
  zero<NW / 2>(y);

  for (int i = 0; i < items; ++i) {
    cp_async_wait_n(w.NS - 2);
    fence_async_smem();
    __syncthreads();  // item i landed; every warpgroup is done with item i - 1
    if (i + w.NS - 1 < items) load_item(i + w.NS - 1);
    cp_async_commit();
    const Item it = item_of(w, 1, NP, s0, i);
    const uint32_t st = smem_addr(slot(i));
    if (it.mat == 0) {
      const uint32_t* A = reinterpret_cast<const uint32_t*>(w.xres ? smem : xchunk(i, it.kx));
      const int w0 = w.xres ? it.chunk * w.KC * EB / 4 : 0;
      if (it.chunk == 0)
        mma_raw<T, FT, false>(u, A, w.S, 64 * wg, w0, st, FT, 0, it.kx);
      else
        mma_raw<T, FT, true>(u, A, w.S, 64 * wg, w0, st, FT, 0, it.kx);
    } else {
      if (it.piece == 0) {
        // The bias base through an empty asm statement: its per-value
        // offsets are then computed here, not hoisted out of the walk and
        // held in registers across it.
        const float* bp = a.b1p + it.j * FT + 2 * (lane % 4);
        asm volatile("" : "+l"(bp));
#pragma unroll
        for (int e = 0; e < FT / 2; ++e)
          g[e] = cast<T>(gelu(u[e] + __ldg(bp + 8 * (e / 4) + e % 2)));
      }
      mma_piece<T, NW, FT, NP, 1>(y, g, st, it.piece, 0);
    }
  }
  cp_async_wait<0>();
  e.template store<T, NW>(a, y, m0 + 64 * wg, cb, z);
}

// The MLP's epilogue: out = cast(y + b2), or under an F split (grid z) the
// split's fp32 partial of y, summed by mlp_general_sum_splits.
struct StoreEpi {
  template <typename T, int NW>
  __device__ __forceinline__ void store(const FwdArgs<T>& a, const float* y, long long m0, int cb,
                                        int z) const {
    const Walk& w = a.w;
    if (gridDim.z == 1)
      store_acc<T, NW>(y, a.out, a.b2, w.M, w.C, m0, cb * NW);
    else
      store_acc<float, NW>(y, a.part + (long long)z * w.M * w.C, nullptr, w.M, w.C, m0, cb * NW);
  }
};

template <typename T>
struct RowsArgs {
  const T* x;
  const T* dy;
  const T* w1s;   // (FP, CP) per part
  const T* w2ts;  // W2^T, (FP, CP) per part
  const T* w1ts;  // W1^T, (CPo, FP) per part, F permuted by tf32_pos for fp32
  const float* b1p;
  T* dx;
  float* dxpart;  // (Z, M, C) where F is split
  T* dut;         // cast(du)^T, (FP, Mp)
  T* gt;          // g^T, (FP, Mp)
  T* xt;          // x^T, (CPo, Mp) per part
  T* dyt;         // dy^T, (CPo, Mp) per part
  float* db1p;    // (row tiles, FP)
  float* db2p;    // (row tiles, C)
  const T* res;   // (M, C) added to dx before its rounding, or null
  int Mp, amode_x, amode_dy;
  uint32_t red;   // shared offset of the db1 exchange (4 x warpgroups x FT fp32)
  Walk w;
};

// x^T or dy^T (split for fp32) of rows m0.. (cols of them, below Mp) from
// the value of (row r, column c): rows c < CPo of the (CPo, Mp) array.
template <typename T, class Get>
__device__ __forceinline__ void write_t(T* __restrict__ dst, int CPo, int Mp, long long m0,
                                        int cols, Get get) {
  const long long pt = (long long)CPo * Mp;
  for (int i = threadIdx.x; i < CPo * cols; i += blockDim.x) {
    const int c = i / cols, r = i % cols;
    const float v = get(r, c);
    const long long o = (long long)c * Mp + m0 + r;
    if constexpr (F32<T>) {
      uint32_t h, l;
      split_tf32(v, h, l);
      dst[o] = __uint_as_float(h);
      dst[o + pt] = __uint_as_float(l);
    } else {
      dst[o] = from_f<T>(v);
    }
  }
}

template <typename T, int NW, int FT, int KS>
__global__ void __launch_bounds__(256, 1) mlp_general_rows_kernel(const RowsArgs<T> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int EB = Fmt<T>::EB, PARTS = Fmt<T>::PARTS, NP = pieces<T, NW, FT>();
  const Walk& w = a.w;
  const int tid = threadIdx.x, nthr = blockDim.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  // Warpgroup wg: rows 64 wr.., hidden columns FT wk.. of each step.
  constexpr int ks = KS, FTC = FT * KS, KP = FT / NP;
  const int wr = wg / ks, wk = wg % ks;
  const int BM = nthr / 2 / ks;
  const long long m0 = (long long)blockIdx.x * BM;
  const int cb = blockIdx.y, z = blockIdx.z;
  const int s0 = z * w.spz, s1 = min(w.nsteps, s0 + w.spz);
  const int items = (s1 - s0) * (2 * w.nk + NP);
  const long long pw = (long long)w.FP * w.CP, pwt = (long long)w.CPo * w.FP;
  const bool first = cb == 0;
  float* red = reinterpret_cast<float*>(smem + a.red);
  auto slot = [&](int i) { return smem + w.xbytes + (uint32_t)(i % w.NS) * w.slot; };
  // Where x and dy are not resident, the chunk follows the W1 or W2^T chunk.
  auto achunk = [&](int i, int kx) { return slot(i) + PARTS * part_bytes(FTC, kx * EB); };

  auto load_item = [&](int i) {
    const Item it = item_of(w, 2, NP, s0, i);
    const uint32_t st = smem_addr(slot(i));
    if (it.mat >= 0) {  // 0: W1 and x (u); 1: W2^T and dy (dh)
      load_b<T>(st, it.mat ? a.w2ts : a.w1s, pw, w.CP, it.j * FTC, it.chunk * w.KC, FTC, it.kx,
                tid, nthr);
      if (!w.xres)
        load_a<T>(achunk(i, it.kx), w.S, it.mat ? a.dy : a.x, w.M, w.C, m0, BM, it.chunk * w.KC,
                  it.kx, it.mat ? a.amode_dy : a.amode_x, tid, nthr);
    } else {
      load_b<T>(st, a.w1ts, pwt, w.FP, cb * NW, it.j * FTC + it.piece * ks * KP, NW, ks * KP,
                tid, nthr);
    }
  };

  if (w.xres) {
    load_a<T>(smem, w.S, a.x, w.M, w.C, m0, BM, 0, w.CP, a.amode_x, tid, nthr);
    load_a<T>(smem + w.xt, w.S, a.dy, w.M, w.C, m0, BM, 0, w.CP, a.amode_dy, tid, nthr);
  }
  for (int s = 0; s < w.NS - 1; ++s) {
    if (s < items) load_item(s);
    cp_async_commit();
  }
  // u and dh only ever written by wgmma; cast(du) beside them.
  float dx[NW / 2], u[FT / 2], dh[FT / 2], dub[FT / 2];
  zero<NW / 2>(dx);

  for (int i = 0; i < items; ++i) {
    cp_async_wait_n(w.NS - 2);
    fence_async_smem();
    __syncthreads();  // item i landed; every warpgroup is done with item i - 1
    if (i + w.NS - 1 < items) load_item(i + w.NS - 1);
    cp_async_commit();
    const Item it = item_of(w, 2, NP, s0, i);
    const uint32_t st = smem_addr(slot(i));
    if (it.mat >= 0) {
      const uint32_t* A = reinterpret_cast<const uint32_t*>(
          w.xres ? smem + it.mat * w.xt : achunk(i, it.kx));
      const int w0 = w.xres ? it.chunk * w.KC * EB / 4 : 0;
      // Four calls, each on its own accumulator: a pointer chosen at run
      // time would put u and dh in local memory.
      // One step in flight at the widest fp32 block: two spilled there.
      constexpr int D = F32<T> && NW == NWMAX ? 1 : 2;
      if (it.mat == 0 && it.chunk == 0)
        mma_raw<T, FT, false, D>(u, A, w.S, 64 * wr, w0, st, FTC, FT * wk, it.kx);
      else if (it.mat == 0)
        mma_raw<T, FT, true, D>(u, A, w.S, 64 * wr, w0, st, FTC, FT * wk, it.kx);
      else if (it.chunk == 0)
        mma_raw<T, FT, false, D>(dh, A, w.S, 64 * wr, w0, st, FTC, FT * wk, it.kx);
      else
        mma_raw<T, FT, true, D>(dh, A, w.S, 64 * wr, w0, st, FTC, FT * wk, it.kx);
      continue;
    }
    if (it.piece == 0) {
      const int f0 = it.j * FTC + FT * wk;
      // Bases through empty asm statements, as in the forward. cast(du) and
      // g (the first column block's), transposed: row f, the rows m
      // contiguous; g stored as it is made. db1: the two rows of a column
      // this thread holds, then the 8 lanes of the column, then (below) the
      // warps in order, each column as soon as its two values are made.
      const float* bp = a.b1p + f0 + 2 * (lane % 4);
      const long long mr = m0 + 64 * wr + 16 * warp + lane / 4;
      const long long o0 = (long long)(f0 + 2 * (lane % 4)) * a.Mp + mr;
      T* dut = a.dut + o0;
      T* gt = a.gt + o0;
      asm volatile("" : "+l"(bp), "+l"(dut), "+l"(gt));
#pragma unroll
      for (int q = 0; q < FT / 4; ++q) {
        float cs = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // values e and e + 2: rows r and r + 8
          const int e = 4 * (q / 2) + q % 2 + 2 * h;
          const float uu = u[e] + __ldg(bp + 8 * (q / 2) + q % 2);
          const float du = dh[e] * dgelu(uu);
          cs += du;  // rows past M have dy = 0, so du = 0
          dub[e] = cast<T>(du);
          const long long o = (long long)(8 * (q / 2) + q % 2) * a.Mp + 8 * h;
          if (first && mr + 8 * h < a.Mp) {
            dut[o] = from_f<T>(dub[e]);
            gt[o] = from_f<T>(gelu(uu));
          }
        }
        if (first) {
          cs = mlp_fwd_tile::column_sum(cs);
          if (lane < 4) red[(wg * 4 + warp) * FT + 8 * (q / 2) + 2 * lane + q % 2] = cs;
        }
      }
      if (first) {
        __syncthreads();
        if (tid < FTC) {  // the warps of the warpgroups that hold column tid
          const int nw = nthr / 32 / ks, col = tid % FT, r0 = tid / FT * nw;
          float s = 0.f;
          for (int r = 0; r < nw; ++r) s += red[(r0 + r) * FT + col];
          a.db1p[(long long)blockIdx.x * w.FP + it.j * FTC + tid] = s;
        }
      }
    }
    mma_piece<T, NW, FT, NP, KS>(dx, dub, st, it.piece, wk);
  }
  cp_async_wait<0>();
  if constexpr (KS == 2) {
    // The two warpgroups' partial dx of the same rows, added in order
    // through the ring's shared memory (the same (row, column) is the same
    // value index of the same thread in both).
    float* xch = reinterpret_cast<float*>(smem + w.xbytes);
    __syncthreads();
    if (wk == 1) {
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) xch[e * 128 + tid % 128] = dx[e];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) dx[e] += xch[e * 128 + tid % 128];
    }
  }
  if (wk == 0 && gridDim.z == 1)
    store_acc<T, NW>(dx, a.dx, nullptr, w.M, w.C, m0 + 64 * wr, cb * NW, a.res);
  else if (wk == 0)
    store_acc<float, NW>(dx, a.dxpart + (long long)z * w.M * w.C, nullptr, w.M, w.C,
                         m0 + 64 * wr, cb * NW);
  if (first && z == 0) {
    // db2 (the tile's rows of dy summed by column, in order), and x^T and
    // dy^T for the weight products, zeros past M and C: from the resident
    // tiles where they are, else from device memory.
    const int rows = (int)min((long long)BM, w.M - m0);
    const int cols = (int)min((long long)BM, a.Mp - m0);
    if (w.xres) {
      auto at = [&](int t, int r, int c) {
        return c < w.CP ? to_f(*reinterpret_cast<const T*>(smem + t * w.xt + r * w.S * 4 + c * EB))
                        : 0.f;
      };
      for (int c = tid; c < w.C; c += nthr) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += at(1, r, c);
        a.db2p[(long long)blockIdx.x * w.C + c] = s;
      }
      write_t<T>(a.xt, w.CPo, a.Mp, m0, cols, [&](int r, int c) { return at(0, r, c); });
      write_t<T>(a.dyt, w.CPo, a.Mp, m0, cols, [&](int r, int c) { return at(1, r, c); });
    } else {
      auto at = [&](const T* p, int r, int c) {
        return m0 + r < w.M && c < w.C ? to_f(p[(m0 + r) * w.C + c]) : 0.f;
      };
      for (int c = tid; c < w.C; c += nthr) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += at(a.dy, r, c);
        a.db2p[(long long)blockIdx.x * w.C + c] = s;
      }
      write_t<T>(a.xt, w.CPo, a.Mp, m0, cols, [&](int r, int c) { return at(a.x, r, c); });
      write_t<T>(a.dyt, w.CPo, a.Mp, m0, cols, [&](int r, int c) { return at(a.dy, r, c); });
    }
  }
}

template <typename T>
struct DwArgs {
  const T* dut;  // (FP, Mp)
  const T* gt;
  const T* xt;   // (CPo, Mp) per part
  const T* dyt;
  float* part;   // (R, 2 F C): dW1 (F, C) | dW2 (C, F)
  int F, C, CPo, Mp, MK, chunks, NS, SA;
  uint32_t abytes, slot;
};

template <typename T, int NW>
__global__ void __launch_bounds__(256, 1) mlp_general_dw_kernel(const DwArgs<T> a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int EB = Fmt<T>::EB, PARTS = Fmt<T>::PARTS, V = 16 / EB;
  const int tid = threadIdx.x, wg = tid / 128;
  const int f0 = blockIdx.x * 64, cb = blockIdx.y, r = blockIdx.z, R = gridDim.z;
  const int q0 = (int)((long long)r * a.chunks / R), q1 = (int)((long long)(r + 1) * a.chunks / R);
  const int items = q1 - q0;
  const uint32_t base = smem_addr(smem);
  const uint32_t bbytes = PARTS * part_bytes(NW, a.MK * EB);
  const long long pt = (long long)a.CPo * a.Mp;

  auto load_item = [&](int i) {
    const int m = (q0 + i) * a.MK;
    const uint32_t st = base + (uint32_t)(i % a.NS) * a.slot;
    // A: 64 rows of cast(du)^T and of g^T, raw; B: x^T and dy^T chunks.
    for (int k = tid; k < 2 * 64 * (a.MK / V); k += 256) {
      const int which = k / (64 * (a.MK / V)), rv = k % (64 * (a.MK / V));
      const int row = rv / (a.MK / V), v = rv % (a.MK / V);
      const T* src = (which ? a.gt : a.dut) + (long long)(f0 + row) * a.Mp + m + v * V;
      cp_async16(st + which * a.abytes + row * a.SA * 4 + 16 * v, src, true);
    }
    load_b<T>(st + 2 * a.abytes, a.xt, pt, a.Mp, cb * NW, m, NW, a.MK, tid, 256);
    load_b<T>(st + 2 * a.abytes + bbytes, a.dyt, pt, a.Mp, cb * NW, m, NW, a.MK, tid, 256);
  };

  for (int s = 0; s < a.NS - 1; ++s) {
    if (s < items) load_item(s);
    cp_async_commit();
  }
  float acc[NW / 2];
  zero<NW / 2>(acc);
  for (int i = 0; i < items; ++i) {
    cp_async_wait_n(a.NS - 2);
    fence_async_smem();
    __syncthreads();
    if (i + a.NS - 1 < items) load_item(i + a.NS - 1);
    cp_async_commit();
    const uint32_t st = (uint32_t)(i % a.NS) * a.slot;
    // Warpgroup 0: dW1 += cast(du)^T x; warpgroup 1: dW2^T += g^T dy.
    mma_raw<T, NW, true>(acc, reinterpret_cast<const uint32_t*>(smem + st + wg * a.abytes), a.SA,
                         0, 0, base + st + 2 * a.abytes + wg * bbytes, NW, 0, a.MK);
  }
  cp_async_wait<0>();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  float* dst = a.part + (long long)r * 2 * a.F * a.C;
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) {
    const int f = f0 + acc_row(warp, lane, e), c = cb * NW + acc_col(lane, e);
    if (f >= a.F || c >= a.C) continue;
    if (wg == 0)
      dst[(long long)f * a.C + c] = acc[e];
    else
      dst[(long long)a.F * a.C + (long long)c * a.F + f] = acc[e];
  }
}

// The hidden column f whose weights the prologue stores at column pos of
// a slab fed by an accumulator: steps of ftc = ks x FT columns, each cut in
// pieces of ks x kp (one kp of each of the ks warpgroups, in turn), and for
// fp32 each group of 8 permuted by tf32_pos.
template <typename T>
__device__ __forceinline__ int feed_src(int pos, int ftc, int kp, int ks) {
  const int s = pos / ftc, rem = pos % ftc, p = rem / (ks * kp), r2 = rem % (ks * kp);
  const int k = r2 / kp, r = F32<T> ? tf32_src(r2 % kp) : r2 % kp;
  return s * ftc + k * (ftc / ks) + p * kp + r;
}

// The weight operands of a call, padded, split, and for the products fed by
// an accumulator permuted (feed_src): w1s = W1 (FP, CP); forward: wb = W2
// (CPo, FP), permuted; backward: wb = W2^T (FP, CP) and w1ts = W1^T (CPo,
// FP), permuted; b1p = b1 padded. Each array is its hi part then its lo
// part.
template <typename T>
__global__ void mlp_general_prep(const T* __restrict__ w1, const T* __restrict__ w2,
                                 const float* __restrict__ b1, T* w1s, T* wb, T* w1ts,
                                 float* b1p, int C, int F, int CP, int FP, int CPo, int bwd,
                                 int ftc, int kp, int ks) {
  const long long n1 = (long long)FP * CP, n2 = bwd ? n1 : (long long)CPo * FP;
  const long long n3 = bwd ? (long long)CPo * FP : 0, n = n1 + n2 + n3 + FP;
  auto put = [&](T* dst, long long i, long long pstride, float v) {
    if constexpr (F32<T>) {
      uint32_t h, l;
      split_tf32(v, h, l);
      dst[i] = __uint_as_float(h);
      dst[i + pstride] = __uint_as_float(l);
    } else {
      dst[i] = from_f<T>(v);
    }
  };
  auto perm = [&](int f) { return feed_src<T>(f, ftc, kp, ks); };
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < n1) {
      const int f = (int)(i / CP), c = (int)(i % CP);
      put(w1s, i, n1, f < F && c < C ? to_f(w1[(long long)f * C + c]) : 0.f);
    } else if (i < n1 + n2) {
      const long long k = i - n1;
      if (bwd) {
        const int f = (int)(k / CP), c = (int)(k % CP);
        put(wb, k, n2, f < F && c < C ? to_f(w2[(long long)c * F + f]) : 0.f);
      } else {
        const int c = (int)(k / FP), f = perm((int)(k % FP));
        put(wb, k, n2, f < F && c < C ? to_f(w2[(long long)c * F + f]) : 0.f);
      }
    } else if (i < n1 + n2 + n3) {
      const long long k = i - n1 - n2;
      const int c = (int)(k / FP), f = perm((int)(k % FP));
      put(w1ts, k, n3, f < F && c < C ? to_f(w1[(long long)f * C + c]) : 0.f);
    } else {
      const int f = (int)(i - n1 - n2 - n3);
      b1p[f] = f < F ? b1[f] : 0.f;
    }
  }
}

// out[i] = cast(sum over z < Z of part[z][i] (+ bias[i % C]) (+ res[i])),
// in order.
template <typename T>
__global__ void mlp_general_sum_splits(const float* __restrict__ part, int Z, long long n, int C,
                                       const float* __restrict__ bias, const T* __restrict__ res,
                                       T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < Z; ++z) s += part[z * n + i];
  if (bias != nullptr) s += bias[i % C];
  if (res != nullptr) s += to_f(res[i]);
  out[i] = from_f<T>(s);
}

// grads = [dW1 (F, C) | dW2 (C, F) | db1 (F) | db2 (C)]: the R weight
// partials summed in order, a thread an output; then the per-tile sums of
// db1 (stride FP) and db2 (one a row tile: hundreds), a warp an output, its
// lanes each summing every 32nd tile in order and then added by a fixed
// shuffle tree. Two calls give the same bits.
__global__ void mlp_general_reduce(const float* __restrict__ part, int R,
                                   const float* __restrict__ db1p, const float* __restrict__ db2p,
                                   int RT, int F, int FP, int C, float* __restrict__ grads) {
  const long long nw = 2LL * F * C, wwarps = (nw + 31) / 32;
  const long long gw = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw < wwarps) {
    const long long i = gw * 32 + lane;
    if (i >= nw) return;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += part[r * nw + i];
    grads[i] = s;
    return;
  }
  const long long o = gw - wwarps;
  if (o >= F + C) return;
  const float* src = o < F ? db1p + o : db2p + (o - F);
  const int stride = o < F ? FP : C;
  float s = 0.f;
  for (int t = lane; t < RT; t += 32) s += src[(long long)t * stride];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) grads[nw + o] = s;
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

// Output columns of a warpgroup: the first of these at or above C / blocks.
constexpr int NW_CLASSES[] = {32, 48, 64, 96, 128, 192};

struct Geo {
  int NW, blocks, CPo, CP, FP;
};

inline Geo geometry(int C, int F) {
  Geo g;
  g.blocks = cdiv(C, NWMAX);
  const int per = cdiv(C, g.blocks);
  g.NW = NWMAX;
  for (int n : NW_CLASSES)
    if (per <= n) {
      g.NW = n;
      break;
    }
  g.CPo = g.NW * g.blocks;
  g.CP = round_up(C, KQ);
  g.FP = round_up(F, FQ);
  return g;
}

// Hidden columns a step: fp32 holds its output sum beside u and the
// fragments, so wide NW take narrower steps; the backward holds u, dh and
// cast(du) beside dx, and takes 32 (64 spilled at NW = 64 in bf16).
template <typename T, int NW> constexpr int ft_fwd() { return F32<T> && NW > 96 ? 32 : 64; }
template <typename T, int NW> constexpr int ft_rows() { return 32; }

struct RowPlan {
  Walk w;
  int RW, Z, RT, threads;
  uint32_t smem, red;
  dim3 grid;
};

// The walk of the forward (nmat = 1: x) or of the rows kernel (nmat = 2: x
// and dy), kernel fn with NP pieces of its second product, in the first of
// these plans that fits (x resident beside two ring slots, or its chunks in
// the items):
//  - the backward's first choice: one warpgroup a CTA and two CTAs an SM,
//    in half the SM's shared memory. The two run unsynchronised, so one's
//    GELU, du and g writes overlap the other's products (the warpgroups of
//    one CTA pass each item together); measured 5% faster at ScOT-B stage
//    0, where the forward, whose weight copies per row bound it, ran
//    faster with 128 rows a CTA;
//  - two warpgroups on 128 rows;
//  - the backward: two warpgroups on 64 rows, each taking half of a step's
//    hidden columns (where x and dy of 128 rows do not fit: fp32 C = 192),
//    their partial dx added at the end;
//  - one warpgroup on 64 rows; then the same with x in the items.
// Then the widest chunk of C that fits (each item ends in a wait for its
// products), up to four slots, and the F split that fills the card.
template <typename T>
cudaError_t plan_rows(const void* fn, int nmat, int NW, int FT, int NP, int M, int C, int F,
                      RowPlan& p, const void* fn_split = nullptr) {
  constexpr int EB = Fmt<T>::EB, PARTS = Fmt<T>::PARTS;
  const Geo g = geometry(C, F);
  const int red = nmat == 2 ? 2 * 4 * FT * 4 : 0;
  const int KQ2 = 128 / EB, KCMAX = F32<T> ? 192 : 384;
  // (row warpgroups, hidden splits, x resident, shared memory): half an SM
  // (228 KB, 1 KB of it reserved for each CTA), else a block's most.
  constexpr int PLANS[6][4] = {{1, 1, 1, 115712}, {2, 1, 1, SMEM}, {1, 2, 1, SMEM},
                               {1, 1, 1, SMEM},   {2, 1, 0, SMEM}, {1, 1, 0, SMEM}};
  bool found = false;
  for (int pass = 0; pass < 6 && !found; ++pass) {
    const int RW = PLANS[pass][0], ks = PLANS[pass][1], xres = PLANS[pass][2];
    const int budget = PLANS[pass][3] - red, FTC = FT * ks;
    if ((nmat == 1 && pass == 0) || (ks > 1 && !fn_split)) continue;  // forward: 128 rows first
    if (g.FP % FTC) continue;
    int kcs[64], nkc = 0;
    if (g.CP <= KCMAX) kcs[nkc++] = g.CP;
    for (int k = (g.CP < KCMAX ? g.CP : KCMAX) / KQ2 * KQ2; k >= KQ2 && nkc < 64; k -= KQ2)
      if (k != g.CP) kcs[nkc++] = k;
    if (nkc == 0) kcs[nkc++] = g.CP;
    for (int q = 0; q < nkc && !found; ++q) {
      const int KC = kcs[q];
      const int S = raw_stride<T>(xres ? g.CP : KC);
      const uint32_t xt = align1k((uint32_t)(64 * RW) * S * 4);
      const uint32_t xbytes = xres ? nmat * xt : 0;
      const uint32_t i1 = PARTS * part_bytes(FTC, KC * EB) + (xres ? 0 : xt);
      const uint32_t i2 = PARTS * part_bytes(NW, ks * (FT / NP) * EB);
      const uint32_t slot = align1k(i1 > i2 ? i1 : i2);
      if (xbytes + 2 * slot > (uint32_t)budget) continue;
      const int ns = (int)((budget - xbytes) / slot) < 4 ? (int)((budget - xbytes) / slot) : 4;
      if (ks > 1 && (uint32_t)ns * slot < (uint32_t)NW * 256) continue;  // the dx exchange
      found = true;
      Walk& w = p.w;
      w.M = M;
      w.C = C;
      w.CP = g.CP;
      w.FP = g.FP;
      w.CPo = g.CPo;
      w.KC = KC;
      w.nk = cdiv(g.CP, KC);
      w.xres = xres;
      w.S = S;
      w.nsteps = g.FP / FTC;
      w.NS = ns;
      w.ks = ks;
      w.xbytes = xbytes;
      w.xt = xt;
      w.slot = slot;
      p.RW = RW;
      p.threads = 128 * RW * ks;
      p.red = xbytes + w.NS * slot;
      p.smem = p.red + red;
    }
  }
  if (!found) return cudaErrorInvalidValue;
  int slots = 0;
  cudaError_t err = prepare_launch(p.w.ks > 1 ? fn_split : fn, (int)p.smem, p.threads, &slots);
  if (err != cudaSuccess) return err;
  p.RT = cdiv(M, 64 * p.RW);
  const long long tiles = (long long)p.RT * g.blocks;
  const int n = p.w.nsteps;
  p.Z = 1;
  p.w.spz = n;
  int sms = 0, dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (tiles < sms && n > 1) {
    // Split F so that every SM has a CTA: of the splits that do, the one
    // with the least time in a model of waves of steps plus the partial
    // sums' traffic. A step's time at 40% of the card's rate for the
    // operand type, per SM; the partials read and written once each at
    // 3.35 TB/s.
    const double rate = (F32<T> ? 495e12 / 3 : 989e12) * 0.4 / sms;
    const double step_s = 2.0 * 64 * p.RW * FT * p.w.ks * (g.CP * nmat + NW) / rate;
    const double part_s = 8.0 * M * C / 3.35e12;
    double best = -1;
    for (int z = cdiv(sms, (int)tiles); z <= n; ++z) {
      const int spz = cdiv(n, z), zr = cdiv(n, spz);
      const double t = (double)((tiles * zr + slots - 1) / slots) * (spz + 1) * step_s +
                       zr * part_s;
      if (best < 0 || t < best) {
        best = t;
        p.Z = zr;
        p.w.spz = spz;
      }
    }
  }
  p.grid = dim3((unsigned)p.RT, (unsigned)g.blocks, (unsigned)p.Z);
  return cudaSuccess;
}

struct DwPlan {
  int MK, NS, SA, chunks, R;
  uint32_t abytes, slot, smem;
};

template <typename T>
cudaError_t plan_dw(int NW, int M, int R, DwPlan& p) {
  constexpr int EB = Fmt<T>::EB, PARTS = Fmt<T>::PARTS;
  const int Mp = round_up(M, 64);
  for (int MK = 128 / EB; MK >= 64 / EB; MK /= 2) {
    const int SA = raw_stride<T>(MK);
    const uint32_t abytes = align1k(64u * SA * 4);
    const uint32_t slot = align1k(2 * abytes + 2 * PARTS * part_bytes(NW, MK * EB));
    const int ns = (int)(SMEM / slot);
    if (ns >= 3 || (MK == 64 / EB && ns >= 2)) {
      p.MK = MK;
      p.NS = ns < 4 ? ns : 4;
      p.SA = SA;
      p.abytes = abytes;
      p.slot = slot;
      p.smem = p.NS * slot;
      p.chunks = Mp / MK;
      p.R = R < p.chunks ? R : p.chunks;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

// Byte offsets in the scratch buffer.
struct Scratch {
  long long w1s, wb, w1ts, b1p, part, dut, gt, xt, dyt, db1p, db2p, partw, total;
};

inline long long carve(long long& at, long long bytes) {
  const long long o = at;
  at += (bytes + 255) / 256 * 256;
  return o;
}

// With `parts`, the forward's (Z, M, C) fp32 partials even where Z = 1.
template <typename T>
Scratch layout(bool bwd, const Geo& g, int M, int C, int F, const RowPlan& rp, int R,
               bool parts = false) {
  constexpr int EB = Fmt<T>::EB, PARTS = Fmt<T>::PARTS;
  const long long Mp = round_up(M, 64);
  Scratch s{};
  long long at = 0;
  s.w1s = carve(at, (long long)PARTS * g.FP * g.CP * EB);
  s.wb = carve(at, (long long)PARTS * (bwd ? (long long)g.FP * g.CP : (long long)g.CPo * g.FP) * EB);
  s.w1ts = bwd ? carve(at, (long long)PARTS * g.CPo * g.FP * EB) : 0;
  s.b1p = carve(at, (long long)g.FP * 4);
  s.part = rp.Z > 1 || parts ? carve(at, (long long)rp.Z * M * C * 4) : 0;
  if (bwd) {
    s.dut = carve(at, (long long)g.FP * Mp * EB);
    s.gt = carve(at, (long long)g.FP * Mp * EB);
    s.xt = carve(at, (long long)PARTS * g.CPo * Mp * EB);
    s.dyt = carve(at, (long long)PARTS * g.CPo * Mp * EB);
    s.db1p = carve(at, (long long)rp.RT * g.FP * 4);
    s.db2p = carve(at, (long long)rp.RT * C * 4);
    s.partw = carve(at, (long long)R * 2 * F * C * 4);
  }
  s.total = at;
  return s;
}

template <class Fn>
cudaError_t with_nw(int nw, Fn f) {
  switch (nw) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    default: return cudaErrorInvalidValue;
  }
}

inline bool valid(int M, int C, int F) {
  return M > 0 && C >= 1 && C <= MAX_C && F >= 1 && F <= MAX_F;
}

// The prologue for the walk w, its second product in np pieces of each of
// its warpgroups' FT hidden columns.
template <typename T>
cudaError_t launch_prep(const T* w1, const T* w2, const float* b1, T* w1s, T* wb, T* w1ts,
                        float* b1p, int C, int F, const Geo& g, int bwd, const Walk& w, int FT,
                        int np, cudaStream_t st) {
  const long long n = (long long)g.FP * g.CP * (bwd ? 2 : 1) + (long long)g.CPo * g.FP + g.FP;
  const long long blocks = (n + 255) / 256;
  mlp_general_prep<T><<<(unsigned)(blocks < 1184 ? blocks : 1184), 256, 0, st>>>(
      w1, w2, b1, w1s, wb, w1ts, b1p, C, F, g.CP, g.FP, g.CPo, bwd, FT * w.ks, FT / np, w.ks);
  return cudaGetLastError();
}

// The forward's walk for (M, C, F) at output width NW under epilogue Epi.
template <typename T, int NW, class Epi>
cudaError_t plan_fwd(int M, int C, int F, RowPlan& p) {
  constexpr int FT = ft_fwd<T, NW>();
  return plan_rows<T>(reinterpret_cast<const void*>(mlp_general_fwd_kernel<T, NW, FT, Epi>), 1,
                      NW, FT, pieces<T, NW, FT>(), M, C, F, p);
}

// The forward kernel's arguments: x, b2 and out as given, the weight copies
// and partials in the scratch buffer sc of layout s.
template <typename T>
FwdArgs<T> fwd_args(const void* x, const void* b2, void* out, void* scratch, const Scratch& s,
                    const RowPlan& p, int C) {
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  FwdArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.w1s = reinterpret_cast<const T*>(sc + s.w1s);
  a.w2s = reinterpret_cast<const T*>(sc + s.wb);
  a.b1p = reinterpret_cast<const float*>(sc + s.b1p);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<T*>(out);
  a.part = reinterpret_cast<float*>(sc + s.part);
  a.amode = load_mode<T>(x, C);
  a.w = p.w;
  return a;
}

// The forward's prologue (its weight copies) and main kernel, in stream
// order.
template <typename T, int NW, class Epi>
cudaError_t launch_fwd(const FwdArgs<T>& a, const Epi& e, const void* w1, const void* w2,
                       const void* b1, int C, int F, const Geo& g, const RowPlan& p,
                       cudaStream_t st) {
  constexpr int FT = ft_fwd<T, NW>();
  cudaError_t err = launch_prep<T>(
      static_cast<const T*>(w1), static_cast<const T*>(w2), static_cast<const float*>(b1),
      const_cast<T*>(a.w1s), const_cast<T*>(a.w2s), nullptr, const_cast<float*>(a.b1p), C, F, g,
      0, p.w, FT, pieces<T, NW, FT>(), st);
  if (err != cudaSuccess) return err;
  mlp_general_fwd_kernel<T, NW, FT, Epi><<<p.grid, p.threads, p.smem, st>>>(a, e);
  return cudaGetLastError();
}

// The backward's plan (scratch bytes, or with `run` the launches); res, an
// (M, C) array of the operand type or null, is added to dx before its
// rounding.
template <typename T>
cudaError_t backward(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* dy, void* dx, void* grads, void* scratch, int M, int C, int F,
                     int R, cudaStream_t st, bool run, long long* bytes,
                     const void* res = nullptr) {
  const Geo g = geometry(C, F);
  return with_nw(g.NW, [&](auto nwc) {
    constexpr int NW = decltype(nwc)::value, FT = ft_rows<T, NW>();
    auto rows = mlp_general_rows_kernel<T, NW, FT, 1>;
    auto dw = mlp_general_dw_kernel<T, NW>;
    const void* split = nullptr;
    if constexpr (can_split<NW>())
      split = reinterpret_cast<const void*>(mlp_general_rows_kernel<T, NW, FT, 2>);
    RowPlan p;
    cudaError_t err = plan_rows<T>(reinterpret_cast<const void*>(rows), 2, NW, FT,
                                   pieces<T, NW, FT>(), M, C, F, p, split);
    if (err != cudaSuccess) return err;
    DwPlan q;
    if ((err = plan_dw<T>(NW, M, R, q)) != cudaSuccess) return err;
    const Scratch s = layout<T>(true, g, M, C, F, p, q.R);
    if (bytes != nullptr) *bytes = s.total;
    if (!run) return cudaSuccess;
    unsigned char* sc = static_cast<unsigned char*>(scratch);
    auto at = [&](long long o) { return reinterpret_cast<T*>(sc + o); };
    const int Mp = round_up(M, 64);
    RowsArgs<T> a;
    a.x = static_cast<const T*>(x);
    a.dy = static_cast<const T*>(dy);
    a.w1s = at(s.w1s);
    a.w2ts = at(s.wb);
    a.w1ts = at(s.w1ts);
    a.b1p = reinterpret_cast<const float*>(sc + s.b1p);
    a.dx = static_cast<T*>(dx);
    a.dxpart = reinterpret_cast<float*>(sc + s.part);
    a.dut = at(s.dut);
    a.gt = at(s.gt);
    a.xt = at(s.xt);
    a.dyt = at(s.dyt);
    a.db1p = reinterpret_cast<float*>(sc + s.db1p);
    a.db2p = reinterpret_cast<float*>(sc + s.db2p);
    a.res = static_cast<const T*>(res);
    a.Mp = Mp;
    a.amode_x = load_mode<T>(x, C);
    a.amode_dy = load_mode<T>(dy, C);
    a.red = p.red;
    a.w = p.w;
    if ((err = launch_prep<T>(static_cast<const T*>(w1), static_cast<const T*>(w2),
                              static_cast<const float*>(b1), at(s.w1s), at(s.wb), at(s.w1ts),
                              const_cast<float*>(a.b1p), C, F, g, 1, p.w, FT, pieces<T, NW, FT>(),
                              st)) != cudaSuccess)
      return err;
    if constexpr (can_split<NW>()) {
      if (p.w.ks == 2)
        mlp_general_rows_kernel<T, NW, FT, 2><<<p.grid, p.threads, p.smem, st>>>(a);
      else
        rows<<<p.grid, p.threads, p.smem, st>>>(a);
    } else {
      rows<<<p.grid, p.threads, p.smem, st>>>(a);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (p.Z > 1) {
      const long long n = (long long)M * C;
      mlp_general_sum_splits<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
          a.dxpart, p.Z, n, C, nullptr, a.res, a.dx);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    DwArgs<T> d;
    d.dut = a.dut;
    d.gt = a.gt;
    d.xt = a.xt;
    d.dyt = a.dyt;
    d.part = reinterpret_cast<float*>(sc + s.partw);
    d.F = F;
    d.C = C;
    d.CPo = g.CPo;
    d.Mp = Mp;
    d.MK = q.MK;
    d.chunks = q.chunks;
    d.NS = q.NS;
    d.SA = q.SA;
    d.abytes = q.abytes;
    d.slot = q.slot;
    if ((err = prepare_launch(reinterpret_cast<const void*>(dw), (int)q.smem, 256, nullptr)) !=
        cudaSuccess)
      return err;
    dw<<<dim3(g.FP / 64, g.blocks, q.R), 256, q.smem, st>>>(d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long warps = (2LL * F * C + 31) / 32 + F + C;
    mlp_general_reduce<<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(
        d.part, q.R, a.db1p, a.db2p, p.RT, F, g.FP, C, static_cast<float*>(grads));
    return cudaGetLastError();
  });
}

}  // namespace mlp_gen
