// The general fused tail's row-tile kernel (mlp_cln_general.cu) at C <= 384:
// whole rows a CTA, u computed once a row (and once more in the backward
// where 64 rows of u do not fit in shared memory), o never leaving the
// chip. The same kernel is the forward (one walk over F) and the backward's
// rows launch (two walks). sm_90a.
//
// A CTA: two consumer warpgroups and a producer warp (of a warpgroup that
// gives its registers to the consumers: setmaxnreg, 24 / 240).
//  - Split (one 64-row tile a CTA, C > 192 or 64-row tiles to fill the card):
//    both warpgroups on the same 64 rows. Walk 1, per step of FS = 2 FT
//    hidden columns: warpgroup k computes u for the step's hidden columns
//    [k FT, (k + 1) FT) over all of C (A: x, resident in shared memory, or
//    its chunks in the ring items), adds b1 and the GELU in registers and
//    writes g = cast(gelu(u)) raw into a shared-memory tile (two, used in
//    turn); after the pair's named barrier each warpgroup multiplies the
//    whole step's g by its own NH output columns (o = g W2^T, columns
//    [k NH, (k + 1) NH), NH <= 192), A read from the g tile and split at
//    the fragment load for fp32. The norm's row sums of the two halves are
//    exchanged through shared memory and added in one order.
//  - Two row tiles a CTA (the backward only, at C <= 96 with enough 128-row
//    tiles to fill the card: ScOT-B/T stage 0): each warpgroup on its own 64
//    rows, all NH >= C output columns and all FS = FT hidden columns of a
//    step: half the weight bytes a row, and no pair barrier (a warp's
//    products read the rows of the g tile that it wrote).
//  - Epilogue, in registers: o = cast(sum + b2) and its row statistics;
//    the forward writes cast(x + cast(scale (o - mu) r + shift)). The
//    backward takes yhat, dyh = dy scale[b] and its two row means, do,
//    writes cast(do) raw into a resident tile (walk 2's A operand) and the
//    fp32 column sums of do, dy yhat and dy of each warp's 16 rows.
//  - Walk 2 (backward), per step: dh = cast(do) W2 for the warpgroup's
//    hidden columns, u again (or, where 64 rows of u fit beside the ring,
//    read back from shared memory, where walk 1 left each thread's own
//    values), du = dh gelu'(u); cast(du) into the g tile, cast(du)^T and
//    g^T to device memory for the weight kernel, db1's sums of each warp's
//    16 rows; then dx += cast(du) W1 for the warpgroup's output columns. dx
//    = cast(dx + dy), rounded once; then x^T and cast(do)^T (split for
//    fp32) for the weight kernel.
//  - The ring: NS slots, each with a "full" and an "empty" mbarrier. The
//    producer waits for a slot's "empty", posts the bytes on its "full" and
//    copies the item with one cp.async.bulk (TMA): the prologue (tail_prep)
//    writes every item as the byte image of its swizzled tile, hi and lo
//    parts for fp32, so no copy is masked or rearranged. A streamed x chunk
//    goes beside its W1 chunk, a bulk copy a row. The consumers wait on
//    "full" and each warp arrives on "empty" once its products on the slot
//    are done: no block-wide barrier in the walks, one pair barrier a step.
//    (With any ninth warp a quarter of the SM holds three warps, and every
//    thread at most 168 registers unless setmaxnreg moves them; thread 0
//    refilling the slots itself, at 256 threads, measured 20-40% slower:
//    PERF.md.)
//
// Items in order, the same for producer and consumers: walk 1, per step, nk
// W1 chunks (FS rows by KC columns of C) then np W2 pieces (CPo rows by kp
// hidden columns); walk 2, per step, nk W2^T chunks, nk W1 chunks again
// unless u is kept, then np W1^T pieces.
//
// Registers. The epilogues' loops address each (M, C) array through one
// pointer a group of values, made after the group before (after): without
// it the loads of a whole row's operands went out at once, and their
// addresses, common to several loops, were held across the second walk, and
// spilled.

#pragma once

#include "mlp_general.cuh"

namespace cln_rows {

using namespace wgm;
using namespace mlp_gen;

constexpr int THREADS = 384;  // two consumer warpgroups and a producer warpgroup
// Registers a thread: the producer warpgroup gives its own up (one warp of
// it issues the copies, the others end) so that the consumers hold 240
// each (384 threads start at 168: 65536 over 3 warps in each quarter of the
// SM; one producer warp beside 8 consumer warps would hold the consumers
// to 168 too). 24 + 2 x 240 leaves 1024 of the SM's 65536 free: asking for
// all of them (32 + 2 x 240) hung the consumers' setmaxnreg.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int FT = 32;  // hidden columns of a step a warpgroup computes u for
constexpr int RED = 2048;     // the row-sum exchange: 2 rounds x 2 warpgroups x 64 rows x 2
constexpr int BARS = 64;      // the ring's mbarriers (NS <= 4)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on the mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The layout of one call, from its plan (ops/mlp.py::tail_plan: NH, KC, kp,
// x resident, u kept, NS); every offset in bytes.
struct Layout {
  int NH, FS, CP, CPo, FP, KC, nk, kp, np, xres, ukeep, NS, RW, bwd, nsteps;
  int Sx, Sd, Sg;      // raw strides in words: x (CP resident, or KC a chunk), cast(do), g / du
  uint32_t xtile, dotile, g0, gbytes, ubuf, red, ring, slot, bars, smem;
  uint32_t cstride;    // bytes between chunk images (FS x KC), the last chunk's smaller
  uint32_t pbytes;     // bytes of a piece image (CPo x kp)
  uint32_t xoff;       // offset of the x chunk in a W1 item
};

template <typename T>
__host__ __device__ inline uint32_t chunk_bytes(int rows, int kx) {
  return Fmt<T>::PARTS * part_bytes(rows, kx * Fmt<T>::EB);
}

// plan = [path, NH, KC, kp, xres, ukeep, NS, RW] (path 1: this kernel; RW
// row tiles a CTA: 1, the warpgroups splitting the rows' work, or, for the
// backward, 2, each on its own rows, NH >= C). False where the plan does
// not fit the call or the card.
template <typename T>
inline bool make_layout(int C, int F, const int* plan, bool bwd, Layout& l) {
  constexpr int EB = Fmt<T>::EB, KS = Fmt<T>::KS;
  l.NH = plan[1];
  l.KC = plan[2];
  l.kp = plan[3];
  l.xres = plan[4];
  l.ukeep = bwd ? plan[5] : 0;
  l.NS = plan[6];
  l.RW = plan[7];
  l.bwd = bwd;
  bool cls = false;
  for (int n : NW_CLASSES) cls = cls || n == l.NH;  // a warpgroup's output widths
  l.FS = (l.RW == 2 ? 1 : 2) * FT;
  l.CP = round_up(C, KQ);
  l.CPo = l.RW == 2 ? l.NH : 2 * l.NH;
  l.FP = round_up(F, FQ);
  if (l.RW < 1 || l.RW > 2 || (l.RW == 2 && (!bwd || l.NH > 96 || !l.xres))) return false;
  if (!cls || l.CPo < C || l.FP % l.FS || l.KC < KQ || l.KC % KQ || l.KC > l.CP ||
      l.kp < KS || l.kp % KS || l.FS % l.kp || l.NS < 2 || l.NS > 4)
    return false;
  // A streamed x chunk goes a row at a time by bulk copies: whole 16-byte rows.
  if (!l.xres && (l.CP != C || (C * EB) % 16 || (l.KC * EB) % 16)) return false;
  l.nk = cdiv(l.CP, l.KC);
  l.np = l.FS / l.kp;
  l.nsteps = l.FP / l.FS;
  l.Sx = raw_stride<T>(l.xres ? l.CP : l.KC);
  l.Sd = raw_stride<T>(l.CP);
  l.Sg = raw_stride<T>(l.FS);
  uint32_t at = 0;
  l.xtile = at;
  at += l.xres ? align1k(64u * l.RW * l.Sx * 4) : 0;
  l.dotile = at;
  at += bwd ? align1k(64u * l.RW * l.Sd * 4) : 0;
  l.g0 = at;
  l.gbytes = align1k(64u * l.Sg * 4);
  at += 2 * l.gbytes;
  l.ubuf = at;
  at += l.ukeep ? align1k(64u * l.RW * l.FP * 4) : 0;
  l.red = at;
  at += RED;
  l.ring = at;
  l.cstride = chunk_bytes<T>(l.FS, l.KC);
  l.pbytes = chunk_bytes<T>(l.CPo, l.kp);
  l.xoff = l.cstride;
  const uint32_t item1 = l.cstride + (l.xres ? 0 : align1k(64u * l.Sx * 4));
  l.slot = align1k(item1 > l.pbytes ? item1 : l.pbytes);
  at += l.NS * l.slot;
  l.bars = at;
  l.smem = at + BARS;
  return l.smem <= (uint32_t)SMEM;
}

// p, through an empty asm statement that takes v: loads from it are issued
// only once v is computed. The epilogues' loops pass each group of 8
// values (4 at NH >= 128) a value of the group before: the loads of a whole row's operands
// are then not issued at once (they spilled beside the accumulators), and
// a later loop's loads of dy are not merged with an earlier loop's (which
// held them across the second walk).
template <typename P>
__device__ __forceinline__ P after(P p, float v) {
  asm volatile("" : "+l"(p) : "f"(v));
  return p;
}

template <typename T>
struct Args {
  const T* x;
  const T* dy;               // backward
  const unsigned char* img;  // the item images: W1 chunks | W2 pieces | W2^T chunks | W1^T pieces
  long long kind[4];         // offset of each kind's images in img
  const float* b1p;          // (FP,)
  const float* b2;
  const float* scale;
  const float* shift;        // forward
  T* out;                    // forward: out; backward: dx
  T* dut;                    // cast(du)^T (FP, M)
  T* gt;                     // g^T (FP, M)
  T* xt;                     // x^T (CPd, M) per part
  T* dot;                    // cast(do)^T (CPd, M) per part
  float* db1p;               // (4 M / 64, FP)
  float* cpart;              // (4 M / 64, 3, C): do | dy yhat | dy
  int M, C, L, CPd, amode;
  float eps;
  Layout l;
};

template <typename T, int NH, bool BWD, bool R2>
__global__ void __launch_bounds__(THREADS, 1) tail_rows_kernel(const __grid_constant__ Args<T> a) {
  static_assert(!R2 || (BWD && NH <= 96), "two row tiles a CTA: the backward at NH <= 96");
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int EB = Fmt<T>::EB;
  // One k step's products in flight at the wide output blocks, where two
  // would spill beside their 64 or 96 accumulators.
  constexpr int D = NH >= 128 ? 1 : 2;
  constexpr int RW = R2 ? 2 : 1;             // row tiles a CTA
  constexpr int G = NH >= 128 ? 4 : 8;       // values of a group of the epilogues' loads (after)
  const Layout& l = a.l;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * 64 * RW;
  const uint32_t sbase = smem_addr(smem);
  auto full = [&](int s) { return sbase + l.bars + 8 * s; };
  auto empty = [&](int s) { return sbase + l.bars + 8 * (l.NS + s); };
  if (tid == 0) {
    for (int s = 0; s < l.NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > 8) return;
    // The producer: every item of both walks, in the consumers' order.
    int it = 0;
    auto put = [&](const unsigned char* src, uint32_t bytes, int xq, int kx) {
      const int s = it % l.NS;
      if (it >= l.NS) mbar_wait(empty(s), (uint32_t)((it / l.NS - 1) & 1));
      const uint32_t dst = sbase + l.ring + (uint32_t)s * l.slot;
      if (lane == 0) {
        mbar_expect(full(s), bytes + (xq >= 0 ? 64u * kx * EB : 0u));
        bulk_load(dst, src, bytes, full(s));
      }
      if (!R2 && xq >= 0) {  // x is resident with two row tiles a CTA
        __syncwarp();
        for (int r = lane; r < 64; r += 32)
          bulk_load(dst + l.xoff + (uint32_t)r * l.Sx * 4, a.x + (m0 + r) * a.C + xq * l.KC,
                    kx * EB, full(s));
      }
      ++it;
    };
    auto chunks = [&](int kind, int j, bool with_x) {
      for (int q = 0; q < l.nk; ++q) {
        const int kx = min(l.KC, l.CP - q * l.KC);
        put(a.img + a.kind[kind] + (long long)(j * l.nk + q) * l.cstride,
            chunk_bytes<T>(l.FS, kx), with_x ? q : -1, kx);
      }
    };
    auto pieces = [&](int kind, int j) {
      for (int p = 0; p < l.np; ++p)
        put(a.img + a.kind[kind] + (long long)(j * l.np + p) * l.pbytes, l.pbytes, -1, 0);
    };
    for (int j = 0; j < l.nsteps; ++j) {
      chunks(0, j, !l.xres);
      pieces(1, j);
    }
    if constexpr (BWD) {
      for (int j = 0; j < l.nsteps; ++j) {
        chunks(2, j, false);
        if (!l.ukeep) chunks(0, j, !l.xres);
        pieces(3, j);
      }
    }
    return;
  }

  // The consumers. Split (R2 false): both warpgroups on the CTA's 64 rows,
  // warpgroup wg taking hidden columns [wg FT, (wg + 1) FT) of each step of
  // FS = 2 FT and output columns [wg NH, (wg + 1) NH). R2: each on its own
  // 64 rows, with all of a step's FS = FT hidden columns and all NH output
  // columns.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = tid / 128, wq = warp % 4;
  const int M = a.M, C = a.C;
  const int trow = R2 ? 64 * wg : 0;         // the warpgroup's rows in the x and do tiles
  const long long mw = m0 + trow;            // and in the arrays
  const long long tile = blockIdx.x * RW + (R2 ? wg : 0);  // its 64-row tile
  const int fu0 = R2 ? 0 : wg * FT;          // its hidden columns in a step
  const int c0 = R2 ? 0 : wg * NH;           // its output columns
  int it = 0;
  auto acquire = [&]() {
    const int s = it % l.NS;
    mbar_wait(full(s), (uint32_t)((it / l.NS) & 1));
    return s;
  };
  auto release = [&]() {
    if (lane == 0) mbar_arrive(empty(it % l.NS));
    ++it;
  };
  auto slot_addr = [&](int s) { return sbase + l.ring + (uint32_t)s * l.slot; };
  // The g or du tile of step j: the pair's two in turn, or the warpgroup's
  // own; and the wait before it is read: the pair's barrier, or (R2) none
  // beyond the warp's, whose products read the rows that it wrote.
  auto gtile_of = [&](int j) { return smem + l.g0 + (R2 ? wg : (j & 1)) * l.gbytes; };
  auto tile_whole = [&]() {
    if constexpr (R2)
      __syncwarp();
    else
      bar_sync(1, 256);
  };
  const uint32_t* xs = reinterpret_cast<const uint32_t*>(smem + l.xtile);
  if (l.xres) {
    load_a<T>(smem + l.xtile, l.Sx, a.x, M, C, m0, 64 * RW, 0, l.CP, a.amode, tid, 256);
    cp_async_commit();
    cp_async_wait<0>();
  }
  bar_sync(1, 256);

  // u of the step's hidden columns over all of C, through the nk W1 chunks.
  float u[FT / 2];
  auto walk_u = [&]() {
    for (int q = 0; q < l.nk; ++q) {
      const int s = acquire();
      const int kx = min(l.KC, l.CP - q * l.KC);
      const uint32_t* A =
          l.xres ? xs : reinterpret_cast<const uint32_t*>(smem + l.ring + s * l.slot + l.xoff);
      const int w0 = l.xres ? q * l.KC * EB / 4 : 0;
      if (q == 0)
        mma_raw<T, FT, false, D>(u, A, l.Sx, trow, w0, slot_addr(s), l.FS, fu0, kx);
      else
        mma_raw<T, FT, true, D>(u, A, l.Sx, trow, w0, slot_addr(s), l.FS, fu0, kx);
      release();
    }
  };
  // acc += (the step's g or du tile) . (the np pieces' rows of this
  // warpgroup's output columns)^T.
  auto walk_pieces = [&](float* acc, const uint32_t* gs) {
    for (int p = 0; p < l.np; ++p) {
      const int s = acquire();
      mma_raw<T, NH, true, D>(acc, gs, l.Sg, 0, p * l.kp * EB / 4, slot_addr(s), l.CPo, c0,
                              l.kp);
      release();
    }
  };
  // Stores the values of the thread's accumulator elements e and e + 1
  // (adjacent columns of the warpgroup's FT) into a raw (64, FS) tile.
  auto put_pair = [&](unsigned char* gt, int e, float v0, float v1) {
    const int r = acc_row(wq, lane, e), c = fu0 + acc_col(lane, e);
    unsigned char* p = gt + r * l.Sg * 4 + c * EB;
    if constexpr (F32<T>)
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    else
      *reinterpret_cast<uint32_t*>(p) = pack2(v0, v1);
  };
  float* ubuf = reinterpret_cast<float*>(smem + l.ubuf);

  // Walk 1.
  float y[NH / 2];
  zero<NH / 2>(y);
  for (int j = 0; j < l.nsteps; ++j) {
    walk_u();
    unsigned char* gt = gtile_of(j);
    const float* bp = a.b1p + j * l.FS + fu0 + 2 * (lane % 4);
    asm volatile("" : "+l"(bp));
#pragma unroll
    for (int e = 0; e < FT / 2; e += 2) {
      float g[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float uu = u[e + h] + __ldg(bp + 8 * (e / 4) + h);
        if (BWD && l.ukeep) ubuf[(j * (FT / 2) + e + h) * 256 + tid] = uu;
        g[h] = cast<T>(gelu(uu));
      }
      put_pair(gt, e, g[0], g[1]);
    }
    tile_whole();
    walk_pieces(y, reinterpret_cast<const uint32_t*>(gt));
  }

  // Epilogue: o, and the row statistics of the whole rows.
  float* red = reinterpret_cast<float*>(smem + l.red);  // [round][wg][row][2]
  const long long img = mw / a.L;
  const float* sc = a.scale + img * C;
  // Sums of the pair (p, q) over the row's columns: the quad's, and (split)
  // both warpgroups' added in one order; j: the thread's first (0) or
  // second (1) row.
  auto row_sums = [&](int round, float (&p)[2], float (&q)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      p[j] = mlp_fwd_tile::quad_sum(p[j]);
      q[j] = mlp_fwd_tile::quad_sum(q[j]);
      if (!R2 && lane % 4 == 0) {
        float* dst = red + ((round * 2 + wg) * 64 + acc_row(wq, lane, 2 * j)) * 2;
        dst[0] = p[j];
        dst[1] = q[j];
      }
    }
    if constexpr (!R2) {
      bar_sync(1, 256);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* s0 = red + ((round * 2) * 64 + acc_row(wq, lane, 2 * j)) * 2;
        const float* s1 = s0 + 64 * 2;
        p[j] = s0[0] + s1[0];
        q[j] = s0[1] + s1[1];
      }
    }
  };
  // The epilogues address a (M, C) array through the thread's pointer to
  // its first row and column (at_row) and a column vector through one to
  // its first column (at_col): each value is then a constant offset, which
  // no register holds.
  const int cl = c0 + 2 * (lane % 4);  // the thread's first column
  const long long C8 = 8LL * C;
  auto at_row = [&](auto* p, float v) { return after(p + (mw + acc_row(wq, lane, 0)) * C + cl, v); };
  auto at_col = [&](const float* p, float v) { return after(p + cl, v); };
  auto off = [&](int i) { return ((i % 4) / 2) * C8 + 8 * (i / 4) + i % 2; };  // value i's offset
  auto col = [&](int i) { return cl + 8 * (i / 4) + i % 2; };                   // value i's column
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  const float* b2 = a.b2;
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) {
    if (i % G == 0) b2 = at_col(a.b2, mu[0]);
    const float o = col(i) < C ? cast<T>(y[i] + b2[8 * (i / 4) + i % 2]) : 0.f;
    y[i] = o;
    mu[(i % 4) / 2] += o;
    rs[(i % 4) / 2] += o * o;
  }
  row_sums(0, mu, rs);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mu[j] /= C;
    rs[j] = rsqrtf(fmaxf(rs[j] / C - mu[j] * mu[j], 0.f) + a.eps);
  }

  if constexpr (!BWD) {
    const float *scp = sc, *sh = sc;
    const T* xp = a.x;
    T* op = a.out;
    float last = 0.f;
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) {
      if (i % G == 0) {
        scp = at_col(sc, last);
        sh = at_col(a.shift + img * C, last);
        xp = at_row(a.x, last);
        op = at_row(a.out, last);
      }
      const int j = (i % 4) / 2, k = 8 * (i / 4) + i % 2;
      if (col(i) < C) {
        const float v = cast<T>(scp[k] * ((y[i] - mu[j]) * rs[j]) + sh[k]);
        last = to_f(xp[off(i)]) + v;
        op[off(i)] = from_f<T>(last);
      }
    }
    return;
  } else {
    // yhat, and the means of dyh and dyh yhat.
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    const T* dyp = a.dy;
    const float* scp = sc;
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) {
      if (i % G == 0) {
        dyp = at_row(a.dy, m2[0]);
        scp = at_col(sc, m2[0]);
      }
      const int j = (i % 4) / 2;
      y[i] = (y[i] - mu[j]) * rs[j];
      if (col(i) < C) {
        const float h = to_f(dyp[off(i)]) * scp[8 * (i / 4) + i % 2];
        m1[j] += h;
        m2[j] += h * y[i];
      }
    }
    row_sums(1, m1, m2);
    // do, cast(do) into its tile, and the column sums of do, dy yhat and dy
    // of the warp's 16 rows.
    unsigned char* dtile = smem + l.dotile + trow * l.Sd * 4;
    float* cp = a.cpart + (tile * 4 + wq) * 3 * C;
    float last = 0.f;
#pragma unroll
    for (int i = 0; i < NH / 2; i += 4) {
      if (i % G == 0) {
        dyp = at_row(a.dy, last);
        scp = at_col(sc, last);
      }
      float s[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = i + k, j = k / 2, c = col(e);
        const int r = acc_row(wq, lane, e);
        if (c >= l.CP) continue;
        T* dst = reinterpret_cast<T*>(dtile + r * l.Sd * 4 + c * EB);
        const float yh = y[e];
        float dv = 0.f, d = 0.f;
        if (c < C) {
          d = to_f(dyp[off(e)]);
          dv = rs[j] * (d * scp[8 * (e / 4) + e % 2] - m1[j] / C - yh * (m2[j] / C));
        }
        *dst = from_f<T>(dv);
        s[0][k % 2] += dv;
        s[1][k % 2] += d * yh;
        s[2][k % 2] += d;
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = mlp_fwd_tile::column_sum(s[q][h]);
          const int c = col(i + h);
          if (lane < 4 && c < C) cp[q * C + c] = v;
          last = v;
        }
      }
    }
    bar_sync(1, 256);  // cast(do) is whole

    // x^T and cast(do)^T of the warpgroup's rows, split for fp32, zeros past
    // C: the weight kernel's B operands (here, where the tiles are whole and
    // no accumulator is live).
    const long long pt = (long long)a.CPd * M;
    const int nt = R2 ? 128 : 256;
    for (int i = R2 ? tid % 128 : tid; i < a.CPd * 64; i += nt) {
      const int c = i / 64, r = i % 64;
      float xv = 0.f, dv = 0.f;
      if (c < C) {
        xv = l.xres ? to_f(*reinterpret_cast<const T*>(smem + l.xtile + (trow + r) * l.Sx * 4 +
                                                       c * EB))
                    : to_f(a.x[(mw + r) * C + c]);
        dv = to_f(*reinterpret_cast<const T*>(dtile + r * l.Sd * 4 + c * EB));
      }
      const long long o = (long long)c * M + mw + r;
      if constexpr (F32<T>) {
        uint32_t h, lo;
        split_tf32(xv, h, lo);
        a.xt[o] = __uint_as_float(h);
        a.xt[o + pt] = __uint_as_float(lo);
        split_tf32(dv, h, lo);
        a.dot[o] = __uint_as_float(h);
        a.dot[o + pt] = __uint_as_float(lo);
      } else {
        a.xt[o] = from_f<T>(xv);
        a.dot[o] = from_f<T>(dv);
      }
    }


    // Walk 2.
    float dx[NH / 2], dh[FT / 2];
    zero<NH / 2>(dx);
    const uint32_t* ds = reinterpret_cast<const uint32_t*>(smem + l.dotile);
    for (int j = 0; j < l.nsteps; ++j) {
      for (int q = 0; q < l.nk; ++q) {
        const int s = acquire();
        const int kx = min(l.KC, l.CP - q * l.KC);
        if (q == 0)
          mma_raw<T, FT, false, D>(dh, ds, l.Sd, trow, q * l.KC * EB / 4, slot_addr(s), l.FS,
                                   fu0, kx);
        else
          mma_raw<T, FT, true, D>(dh, ds, l.Sd, trow, q * l.KC * EB / 4, slot_addr(s), l.FS,
                                  fu0, kx);
        release();
      }
      if (!l.ukeep) walk_u();
      unsigned char* dutile = gtile_of(j);
      const int f0 = j * l.FS + fu0 + 2 * (lane % 4);
      const float* bp = a.b1p + f0;
      const long long mr = mw + acc_row(wq, lane, 0);
      // M through an empty asm statement too: the stores' offsets are then
      // made here, not hoisted out of the walk and held across it.
      long long Ms = M;
      asm volatile("" : "+l"(Ms));
      T* dut = a.dut + f0 * Ms + mr;
      T* gt = a.gt + f0 * Ms + mr;
      float* db1 = a.db1p + (tile * 4 + wq) * l.FP + f0;
      asm volatile("" : "+l"(bp), "+l"(dut), "+l"(gt), "+l"(db1));
#pragma unroll
      for (int e = 0; e < FT / 2; e += 4) {
        float cs[2] = {0.f, 0.f}, dub[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ee = e + k;
          const float uu = l.ukeep ? ubuf[(j * (FT / 2) + ee) * 256 + tid]
                                   : u[ee] + __ldg(bp + 8 * (ee / 4) + k % 2);
          const float du = dh[ee] * dgelu(uu);
          cs[k % 2] += du;
          dub[k] = cast<T>(du);
          // Row r (k < 2) or r + 8, column 8 (e / 4) + k % 2 of the thread's.
          const long long o = (8 * (ee / 4) + k % 2) * Ms + 8 * (k / 2);
          dut[o] = from_f<T>(dub[k]);
          gt[o] = from_f<T>(gelu(uu));
        }
        put_pair(dutile, e, dub[0], dub[1]);
        put_pair(dutile, e + 2, dub[2], dub[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = mlp_fwd_tile::column_sum(cs[h]);
          if (lane < 4) db1[8 * (e / 4) + h] = v;
        }
      }
      tile_whole();
      walk_pieces(dx, reinterpret_cast<const uint32_t*>(dutile));
    }
    // dx = cast(dx + dy), rounded once, with the thread's indices made again
    // from a laundered thread index: none of the epilogue's is held across
    // the walk.
    int t = threadIdx.x;
    asm volatile("" : "+r"(t));
    const int ln = t % 32, w4 = (t / 32) % 4, g2 = t / 128;
    const long long row = (long long)blockIdx.x * 64 * RW + (R2 ? 64 * g2 : 0) + 16 * w4 + ln / 4;
    const int c2 = (R2 ? 0 : g2 * NH) + 2 * (ln % 4);
    T* op = a.out;
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) {
      if (i % G == 0) {
        dyp = after(a.dy + row * C + c2, dx[i > 0 ? i - 1 : 0]);
        op = after(a.out + row * C + c2, dx[i > 0 ? i - 1 : 0]);
      }
      const long long o = ((i % 4) / 2) * 8LL * C + 8 * (i / 4) + i % 2;
      if (c2 + 8 * (i / 4) + i % 2 < C) op[o] = from_f<T>(dx[i] + to_f(dyp[o]));
    }
  }
}

// The item images of a call: kinds 0 (W1 chunks) and 1 (W2 pieces) for the
// forward, and 2 (W2^T chunks) and 3 (W1^T pieces) besides for the backward,
// each image the bytes of its swizzled K-major tile (hi part, then lo part
// for fp32), zeros past F and C; and b1p = b1 padded to FP.
template <typename T>
__global__ void tail_prep(const T* __restrict__ w1, const T* __restrict__ w2,
                          const float* __restrict__ b1, unsigned char* img, float* b1p, int C,
                          int F, const Layout l) {
  constexpr int EB = Fmt<T>::EB, PARTS = Fmt<T>::PARTS;
  // Elements of one kind: chunks nsteps x nk x FS x KC, pieces nsteps x np
  // x CPo x kp (the last chunk's k past its width skipped).
  const long long nc = (long long)l.nsteps * l.nk * l.FS * l.KC;
  const long long npc = (long long)l.nsteps * l.np * l.CPo * l.kp;
  const long long kinds = l.bwd ? 4 : 2;
  const long long n = kinds / 2 * (nc + npc) + l.FP;
  const long long ck = (long long)l.nsteps * l.nk * l.cstride;  // bytes of a chunk kind
  const long long pk = (long long)l.nsteps * l.np * l.pbytes;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long k = i;
    if (k >= kinds / 2 * (nc + npc)) {
      const int f = (int)(k - kinds / 2 * (nc + npc));
      b1p[f] = f < F ? b1[f] : 0.f;
      continue;
    }
    const int pair = (int)(k / (nc + npc));  // 0: kinds 0 and 1; 1: kinds 2 and 3
    k %= nc + npc;
    const bool chunk = k < nc;
    int rows, kimg, r, kk, f, c;
    long long base;
    if (chunk) {  // a chunk: rows the step's hidden columns, k along C
      const long long per = (long long)l.FS * l.KC;
      const int ci = (int)(k / per), j = ci / l.nk, q = ci % l.nk;
      const int e = (int)(k % per);
      r = e / l.KC;
      kk = e % l.KC;
      kimg = min(l.KC, l.CP - q * l.KC);
      if (kk >= kimg) continue;
      rows = l.FS;
      f = j * l.FS + r;
      c = q * l.KC + kk;
      base = (pair ? ck + pk : 0) + (long long)ci * l.cstride;
    } else {  // a piece: rows the output columns, k along the step's hidden columns
      k -= nc;
      const long long per = (long long)l.CPo * l.kp;
      const int pi = (int)(k / per), j = pi / l.np, p = pi % l.np;
      const int e = (int)(k % per);
      r = e / l.kp;
      kk = e % l.kp;
      rows = l.CPo;
      kimg = l.kp;
      c = r;
      f = j * l.FS + p * l.kp + kk;
      base = (pair ? ck + pk : 0) + ck + (long long)pi * l.pbytes;
    }
    // W1 for kinds 0 and 3, W2 for 1 and 2.
    const bool from_w1 = chunk == (pair == 0);
    float v = 0.f;
    if (f < F && c < C) v = to_f(from_w1 ? w1[(long long)f * C + c] : w2[(long long)c * F + f]);
    const int kb = kimg * EB;
    const uint32_t off = tile_off_rt(r, kk * EB, rows, atom_log2(atom_bytes(kb)));
    unsigned char* dst = img + base + off;
    if constexpr (PARTS == 2) {
      uint32_t h, lo;
      split_tf32(v, h, lo);
      *reinterpret_cast<float*>(dst) = __uint_as_float(h);
      *reinterpret_cast<float*>(dst + part_bytes(rows, kb)) = __uint_as_float(lo);
    } else {
      *reinterpret_cast<T*>(dst) = from_f<T>(v);
    }
  }
}

// grads = dW1 (F, C) | dW2 (C, F) | db1 (F) and cout = db2 (C) | dscale (B, C)
// | dshift (B, C): the R weight partials summed in order, a thread an
// output; db1 and db2 over every warp's partial (4 a row tile), a warp an
// output, its lanes each summing every 32nd in order and then a fixed
// shuffle tree; dscale and dshift over the partials of each image, a thread
// an output, in order. Two calls give the same bits.
__global__ void tail_reduce(const float* __restrict__ partw, int R, const float* __restrict__ db1p,
                            const float* __restrict__ cpart, int P, int F, int FP, int C, int B,
                            int per_image, float* __restrict__ grads, float* __restrict__ cout) {
  const long long nw = 2LL * F * C, wbase = (nw + 31) / 32;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gw = t / 32;
  const int lane = threadIdx.x % 32;
  if (gw < wbase) {
    if (t >= nw) return;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += partw[r * nw + t];
    grads[t] = s;
    return;
  }
  const long long o = gw - wbase;
  if (o < F + C) {
    const float* src = o < F ? db1p + o : cpart + (o - F);
    const long long stride = o < F ? FP : 3LL * C;
    float s = 0.f;
    for (int p = lane; p < P; p += 32) s += src[p * stride];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) {
      if (o < F)
        grads[nw + o] = s;
      else
        cout[o - F] = s;
    }
    return;
  }
  const long long j = t - (wbase + F + C) * 32, per = (long long)B * C;
  if (j < 0 || j >= 2 * per) return;
  const int which = 1 + (int)(j / per);  // 1: dscale, 2: dshift
  const int b = (int)((j % per) / C), c = (int)(j % C);
  float s = 0.f;
  for (int p = b * per_image; p < (b + 1) * per_image; ++p) s += cpart[((long long)p * 3 + which) * C + c];
  cout[C + j] = s;
}

}  // namespace cln_rows
