// Window cosine attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of poseidon_tpu/ops/window_attention.py:
// _bwd_kernel_qkv (pallas_call in _core_bwd_qkv; entry window_attention_bwd:
// q/k/v packed in one QKV tensor, with the q-bias) and _bwd_kernel
// (pallas_call in _core_bwd; entry fused_window_attention_bwd: separate q, k
// and v, no q-bias). Per (window, head) pair, with the scores recomputed from
// q and k (no probabilities are stored by the forward):
//   S = bf16(scale qn) . bf16(kn)^T + bm[n mod nW, h];  e = exp(S - max S);  den = sum e
//   dv = bf16(e)^T . bf16(do / den)
//   dp = do . v^T;  c = sum(dp e) / den;  ds = e (dp - c) / den        (fp32)
//   dqs = bf16(ds) . bf16(kn);  dkn = bf16(ds)^T . bf16(scale qn)
//   dscale += sum_d dqs qn;  dq, dk through the L2 normalisation; rounded to bf16
//   dbm[n mod nW, h] += ds;  dqb += sum over tokens of bf16(dq)             (fp32)
// The wrapper, its plan (bwd_plan) and the plain PyTorch version with the
// same rounding points are in ops/window_attention.py. Layouts are the
// forward's: q/k/v read from three base pointers with one row stride, do
// read as (N, T, C), dq/dk/dv written as q/k/v were read. T is any window
// size up to 256 (padded to NK = 64, 128 or 256 and masked), D is 16, 32 or
// 64.
//
// Bound on this card. Per pair the kernel reads 4*T*D bf16 and writes 3*T*D,
// and does 10*T*T*D FLOPs in five products (S recomputed once): at T = 256,
// D = 32 about 360 FLOPs per byte, near the H100's ridge, and far below it
// at smaller T; dbm (nW*H*T*T fp32) is written once per call. Beside that
// floor the kernel moves its dbm partials, G x nW x H x T x T fp32 written
// once and read once by the reduce (the plan keeps them within 32 MiB: at
// ScOT-B b32 stage 0 shifted G = 5, 15.7 MB, ~9 us at 3.35 TB/s). The design
// must avoid the plain version's N*H*T*T fp32 tensors in device memory and
// a second recomputation of S; what binds it is the latency of the chain
// of loads, barriers, products and epilogues each window walks through.
//
// Design. A cluster of CS = NK/64 CTAs takes one head and bias slot and
// walks a run of the windows that share them (windows slot + nW j of the
// call, j in the group's range). CTA r owns keys [64r, 64r + 64) and stages
// query strip r.
//  - Packing (T <= 32). P = 64 / T windows share one 64-key tile: windows
//    j..j+P-1 of the walk, so that they share the bias slot and the head.
//    The tile is block-diagonal: S's accumulators start at -inf off the
//    diagonal blocks (as for padded keys), so e = 0 there and ds, dV, dK and
//    dQ pick up nothing across windows. A walk whose window count is not a
//    multiple of P ends in a part-filled tile: its missing windows' rows are
//    zero and their queries masked like padded ones. The dbm sum keeps the
//    whole 64 x 64 tile and folds its P diagonal blocks, in block order, when
//    the walk ends. (Packing heads, as the JAX package's _pick_pack does,
//    would need one bias block per head in the tile and a dbm sum per head;
//    packing the walk's own windows keeps one bias block and one sum.)
//  - Prefetch. The raw q and k rows of the next tile (and its dO rows when
//    CS > 1) go by cp.async into the second of two raw stages, V and (CS = 1)
//    dO straight into the second of two wgmma tiles, while the current tile
//    computes. The raw q (with its rounded bias, written back when staged)
//    and k rows stay for the dq and dk epilogues: no global re-read; at CS
//    > 1 a CTA reads the q rows of another CTA's strip through distributed
//    shared memory. Where two stages do not fit (NK = 64 and 256 at D = 64)
//    there is one, and the next tile's copies start when the current tile
//    is done with it.
//  - Stage: CTA r normalises its keys (Kn) and writes its query strip (Qs,
//    and dO at CS > 1) into every CTA of the cluster; no transposed copies:
//    the products read Kn, Qs and dO/den as MN-major B operands.
//  - Strips, two at once where D <= 32 and T > 64 (one per warpgroup):
//    S^T = bm^T + Kn Qs^T and dP^T = V dO^T land in registers. The walk's
//    starting values of S^T (bias, -inf, 0; the CTA's 64 keys x NK queries,
//    fp32, in each thread's accumulator order) stay in shared memory where
//    they fit (NK <= 128, and NK = 256 at D = 16); else each thread loads
//    its values for its warpgroup's next strip into registers a strip ahead,
//    while the last strip's products run (the bias is the walk's), or at D
//    = 64, where registers are short, at the strip. The
//    strip's column max, then sum(e) and sum(dp e), are reduced over the
//    CTA's four warps through shared memory (one barrier each at CS = 1),
//    then over the cluster through distributed shared memory in rank order.
//  - ds stays in registers: bf16(e)^T and bf16(ds)^T are the register A
//    operands of dV += e^T (do/den) and dKn += ds^T Qs, accumulated over the
//    strips; bf16(ds) goes to shared memory (keys by rows, 4-byte stores) as
//    the MN-major A of the dQs partial ds Kn over the CTA's keys, which at
//    D = 64 runs first, alone (registers). At CS = 1 dq leaves from the
//    registers (quad shuffles for its row sums); at CS > 1 every CTA takes
//    64/CS rows of a strip after the next strip's first cluster barrier, the
//    CS partials summed in rank order through distributed shared memory
//    (vector loads). Divisions by den and by a row's norm there are one
//    correctly rounded reciprocal and products; the staging keeps true
//    division, as the forward kernel, so Kn and Qs round as its do.
//  - ds is added to this thread's (64 keys x NK) dbm sum in shared memory,
//    in its accumulator order: no two threads touch one cell.
// After the walk each CTA writes its keys' slice of one dbm partial per
// group and one dqb | dscale partial; a reduce kernel sums the partials of
// every group in a fixed order. No atomics, so two calls give the same bits.
// Fill: bwd_plan picks G for the fewest rounds (waves of the clusters the
// card holds at once, as its occupancy calculator counts them: 30 clusters
// of four CTAs on an H100, not 33, x the longest walk), two CTAs an SM at
// NK = 64 (shared memory kept under half an SM), one above. Registers: the
// thread's offsets are recomputed each tile, so none stays live across the
// walk; no instantiation spills.

#include "wgmma.cuh"

using namespace wgm;

namespace {

constexpr float EPS = 1e-12f;  // torch F.normalize clamp

// N (2, 4 or 8) consecutive 4-byte words of a peer's shared memory at a
// 4N-byte aligned (or, for 8, 16-byte aligned) cluster address, in vector loads.
template <int N>
__device__ __forceinline__ void ld_cluster_words(uint32_t addr, float* v) {
  if constexpr (N == 2) {
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v[0]), "=f"(v[1]) : "r"(addr) : "memory");
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 4)
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[c]), "=f"(v[c + 1]), "=f"(v[c + 2]), "=f"(v[c + 3])
                   : "r"(addr + 4 * c) : "memory");
  }
}

#ifdef ATTN_BWD_CLOCKS
// Diagnostic builds (ops/attention_bwd_clocks.py): thread 0 of each CTA adds
// the SM clocks of each phase of its walk into CLK_N counters, written out
// at its end.
constexpr int CLK_N = 12, CLK_CTAS = 8192;
__device__ unsigned long long attn_bwd_clk[CLK_CTAS][CLK_N];
#define CLK(k)                                     \
  do {                                             \
    if (threadIdx.x == 0) {                        \
      const long long c_ = clock64();              \
      clk[k] += c_ - clk_last;                     \
      clk_last = c_;                               \
    }                                              \
  } while (0)
#else
#define CLK(k) \
  do {         \
  } while (0)
#endif

// q, k, v (which = 0, 1, 2) of token (n, t) and head h at in[which] +
// (n T + t) ld + h D, and their gradients at the same offsets from din.
struct QKVIo {
  const bf16* in[3];
  bf16* din[3];
  long long ld;
};

constexpr uint32_t SMEM_CTA = 232448;  // one CTA's shared memory
constexpr uint32_t SMEM_SM = 233472;   // one SM's, 1 KB of it reserved per CTA

// CTAs an SM (ops/window_attention.py::H100_BWD_CLUSTERS): two at NK = 64.
template <int NK>
constexpr int min_blocks() { return NK == 64 ? 2 : 1; }
template <int NK>
constexpr uint32_t smem_limit() { return NK == 64 ? SMEM_SM / 2 - 1024 : SMEM_CTA; }

// Shared memory of one CTA with ST stages of prefetched rows and (BI) the
// walk's starting values of S^T resident.
template <int NK, int D, int ST, int BI>
struct Layout {
  static constexpr int CS = NK / 64;            // CTAs per cluster
  static constexpr int WG = (NK >= 128 && D <= 32) ? 2 : 1;  // warpgroups, strips in parallel
  static constexpr int THREADS = 128 * WG;
  static constexpr int MINB = min_blocks<NK>();
  static constexpr int STAGES = ST;
  static constexpr bool BIAS = BI != 0;
  // Without them, the next strip's values a strip ahead in registers where
  // registers allow (D <= 32); at D = 64 they are loaded at the strip.
  static constexpr bool AHEAD = !BIAS && D <= 32;
  static constexpr int RA = CS == 1 ? 2 : 3;    // raw rows a stage: q, k (and dO at CS > 1)
  static constexpr uint32_t RS = 2 * D + 16;    // raw row stride, bytes (no bank conflicts)
  static constexpr uint32_t RAW = RA * 64 * RS;
  static constexpr uint32_t TILE = 64 * D * 2;  // 64 rows, bf16
  static constexpr uint32_t QT = NK * D * 2;    // all query rows, bf16
  // The dq epilogue at CS > 1: each CTA takes RPC of a strip's 64 rows, in
  // ROUNDS of 128 / TPR rows, TPR threads a row, VPT <= 4 values a thread
  // at D = 64 (registers). FIN: a thread's dqb | dscale sums.
  static constexpr int RPC = 64 / CS;
  static constexpr int TPR = D == 64 ? 16 : 128 / RPC > D / 8 ? 128 / RPC : D / 8;
  static constexpr int VPT = D / TPR, ROUNDS = RPC * TPR / 128;
  static constexpr int FIN = CS > 1 ? VPT + 1 : D / 4 + 1;
  static constexpr uint32_t qs_off = 0;                           // Qs, rows NK, atoms of D
  static constexpr uint32_t do_off = qs_off + QT;                 // dO: ST x 64 rows, or NK rows
  static constexpr uint32_t kn_off = do_off + (CS == 1 ? ST * TILE : QT);  // Kn, 64 rows
  static constexpr uint32_t v_off = kn_off + TILE;                // V, ST x 64 rows
  // One of each per warpgroup.
  static constexpr uint32_t dod_off = v_off + ST * TILE;          // dO/den strip, 64 rows
  static constexpr uint32_t ds_off = dod_off + WG * TILE;         // bf16(ds), 64 keys x 64 q
  static constexpr uint32_t dq_off = ds_off + WG * 8192;          // dQs partial, 64 x D f32
  static constexpr uint32_t red_off = dq_off + (CS > 1 ? WG * 64 * D * 4 : 0);  // 3 x 4 warps x 64
  static constexpr uint32_t xch_off = red_off + WG * 3 * 4 * 64 * 4;  // 3 x CS x 64 f32 (CS > 1)
  // The CTA's again (the warpgroups' dk, dv sums at a tile's end use the
  // bf16(ds) tiles' room).
  static constexpr uint32_t dkv_off = ds_off;                     // (WG-1) x 2 x 64 x D f32
  static_assert((WG - 1) * 2 * 64 * D * 4 <= WG * 8192, "dk, dv sums fit the ds tiles");
  static constexpr uint32_t dbm_off = xch_off + (CS > 1 ? WG * 3 * CS * 64 * 4 : 0);  // 64 x NK f32
  static constexpr uint32_t bias_off = dbm_off + 64 * NK * 4;     // 64 x NK f32 (BIAS)
  static constexpr uint32_t raw_off = bias_off + (BI ? 64 * NK * 4 : 0);  // ST x RAW
  static constexpr uint32_t fin_off = raw_off + ST * RAW;         // THREADS x FIN f32
  static constexpr uint32_t bytes = fin_off + THREADS * FIN * 4;
};

// Two stages where they fit, then the resident starting values where they fit.
template <int NK, int D>
struct Pick {
  static constexpr int ST = Layout<NK, D, 2, 0>::bytes <= smem_limit<NK>() ? 2 : 1;
  static constexpr int BI = Layout<NK, D, ST, 1>::bytes <= smem_limit<NK>() ? 1 : 0;
};

template <int NK, int D>
struct Plan : Layout<NK, D, Pick<NK, D>::ST, Pick<NK, D>::BI> {
  static_assert(Layout<NK, D, Pick<NK, D>::ST, Pick<NK, D>::BI>::bytes <= smem_limit<NK>(),
                "shared memory of MINB CTAs an SM");
};

template <int NK, int D>
__global__ void __launch_bounds__(Plan<NK, D>::THREADS, Plan<NK, D>::MINB)
attn_bwd_kernel(QKVIo io, const float* __restrict__ qb, const float* __restrict__ bm,
                const float* __restrict__ scale, const bf16* __restrict__ dout,
                float* __restrict__ part_bm, float* __restrict__ part_q, int n_win, int T,
                int heads, int nw, int groups) {
  using P = Plan<NK, D>;
  constexpr int CS = P::CS, WG = P::WG, ST = P::STAGES;
  constexpr int LPR = D / 8;   // 16-byte chunks per head row
  constexpr int TPR = P::TPR, VPT = P::VPT, FIN = P::FIN;
  constexpr uint32_t RS = P::RS;
  extern __shared__ __align__(1024) unsigned char smem[];
  // The thread's place; recomputed from an opaque copy of tid at each tile
  // (below), so that the compiler keeps no per-thread offsets live across
  // the walk: they cost registers that D = 64 does not have.
  int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  int warp = wt / 32, lane = tid % 32;
  unsigned char* sds = smem + P::ds_off + wg * 8192;
  unsigned char* sdod = smem + P::dod_off + wg * P::TILE;
  float* sdq = reinterpret_cast<float*>(smem + P::dq_off) + wg * 64 * D;
  float* red = reinterpret_cast<float*>(smem + P::red_off) + wg * 3 * 4 * 64;
  float* xch = reinterpret_cast<float*>(smem + P::xch_off) + wg * 3 * CS * 64;
  float* dkv = reinterpret_cast<float*>(smem + P::dkv_off);
  float* sdbm = reinterpret_cast<float*>(smem + P::dbm_off);
  float* sbias = reinterpret_cast<float*>(smem + P::bias_off);
  float* fin = reinterpret_cast<float*>(smem + P::fin_off);
  const uint32_t a_qs = smem_addr(smem + P::qs_off), a_kn = smem_addr(smem + P::kn_off),
                 a_do0 = smem_addr(smem + P::do_off), a_v0 = smem_addr(smem + P::v_off),
                 a_raw0 = smem_addr(smem + P::raw_off), a_dod = smem_addr(sdod),
                 a_ds = smem_addr(sds), a_dq = smem_addr(sdq), a_xch = smem_addr(xch);

  const int rank = CS > 1 ? (int)cluster_rank() : 0;
  const int base = nw * heads;
  const int unit = blockIdx.x / CS;
  const int bh = unit % base, grp = unit / base;
  const int slot = bh / heads, h = bh % heads;
  const int per_slot = n_win / nw;
  const int pack = (NK == 64 && T <= 32) ? 64 / T : 1;  // windows a tile
  const int tiles = (per_slot + pack - 1) / pack;
  const int t0 = (int)((long long)grp * tiles / groups);
  const int t1 = (int)((long long)(grp + 1) * tiles / groups);
  const float sc = scale[h];
  const int C = heads * D;
  const int key0 = 64 * rank;               // this CTA's keys and query strip
  const float* bmh = bm + (long long)bh * T * T;
  const int strips = CS == 1 ? 1 : (T + 63) / 64;  // packed tiles are one strip
  int kl0 = 16 * warp + lane / 4;           // this thread's first key row in the S^T layout
  // Column c of a thread in the S^T layout (values i and i + 2) is query
  // col_of(c) of the strip; lanes 0-3 hold every column of the warp after
  // shuffles over lanes with the same lane % 4.
  auto col_of = [&](int c) { return 8 * (c / 2) + 2 * (lane % 4) + (c % 2); };
  // This thread's slot for value i of strip s in the walk's S^T-shaped sums.
  auto pv = [&](int s, int i) { return (s * 32 + i) * 128 + wt; };
  // The same slot by key row kr (of the CTA's 64) and query qg of the tile.
  auto dbm_at = [&](int kr, int qg) {
    const int qc = qg % 64;
    const int i = 4 * (qc / 8) + 2 * ((kr % 16) / 8) + (qc % 2);
    return sdbm[((qg / 64) * 32 + i) * 128 + 32 * (kr / 16) + 4 * (kr % 8) + (qc % 8) / 2];
  };
  // Token (n T + t) of row g of tile tau: row g % T of window tau P + g / T
  // of the walk; -1 for a padded row or a window past the walk's end.
  auto row_tok = [&](int tau, int g) -> long long {
    if (pack == 1) return g < T ? ((long long)slot + (long long)nw * tau) * T + g : -1;
    const int p = g / T, w = tau * pack + p;
    return p < pack && w < per_slot ? ((long long)slot + (long long)nw * w) * T + (g - p * T) : -1;
  };
  // Starting value of S^T's element i of strip s of this thread: bm where
  // key and query are rows of one window, -inf for a key of another window
  // or a padded key, 0 for a padded query (masked later).
  auto bias_of = [&](int s, int i) -> float {
    const int kg = key0 + kl0 + 8 * ((i % 4) / 2);
    const int qg = 64 * s + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
    if (pack == 1) return kg >= T ? -INFINITY : qg < T ? __ldg(bmh + (long long)qg * T + kg) : 0.f;
    const int pk = kg / T, pq = qg / T;
    if (pq >= pack) return 0.f;
    if (pk != pq) return -INFINITY;
    return __ldg(bmh + (long long)(qg - pq * T) * T + (kg - pk * T));
  };
  // The raw rows of tile tau into stage st: q and k (and dO at CS > 1) into
  // the raw rows, V and (CS = 1) dO straight into their wgmma tiles; zeros
  // for rows without a token.
  auto prefetch = [&](int tau, int st) {
    const uint32_t raw = a_raw0 + st * P::RAW;
    for (int i = tid; i < 4 * 64 * LPR; i += P::THREADS) {
      const int which = i / (64 * LPR), r = (i / LPR) % 64, part = i % LPR;
      const long long tk = row_tok(tau, key0 + r);
      const long long row = tk < 0 ? 0 : tk;
      const bf16* src = which == 0   ? io.in[0] + row * io.ld
                        : which == 1 ? io.in[1] + row * io.ld
                        : which == 2 ? io.in[2] + row * io.ld
                                     : dout + row * C;
      uint32_t dst;
      if (which == 2)
        dst = a_v0 + st * P::TILE + tile_off<D>(r, part * 8, 64);
      else if (which == 3 && CS == 1)
        dst = a_do0 + st * P::TILE + tile_off<D>(r, part * 8, 64);
      else
        dst = raw + (which == 3 ? 2 : which) * 64 * RS + r * RS + part * 16;
      cp_async16(dst, src + (long long)h * D + part * 8, tk >= 0);
    }
    cp_async_commit();
  };

#ifdef ATTN_BWD_CLOCKS
  long long clk[CLK_N] = {}, clk_last = clock64();
#endif
  for (int i = tid; i < 64 * NK; i += P::THREADS) sdbm[i] = 0.f;
  // This thread's eight q-bias values, rounded: the staging's chunks of a
  // thread are all at part tid % LPR (THREADS is a multiple of LPR).
  float qb8[8] = {};
  if (qb != nullptr) {
    load8(qb + h * D + (tid % LPR) * 8, qb8);
#pragma unroll
    for (int e = 0; e < 8; ++e) qb8[e] = round_bf16(qb8[e]);
  }
  for (int e = 0; e < FIN; ++e) fin[tid * FIN + e] = 0.f;
  if constexpr (P::BIAS) {  // bias_of's values, with a division by T per row and column
    for (int s = wg; s < strips; s += WG) {
      int pk[2], tk[2], pq[16], tq[16];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        pk[u] = (key0 + kl0 + 8 * u) / T;
        tk[u] = key0 + kl0 + 8 * u - pk[u] * T;
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        pq[c] = (64 * s + col_of(c)) / T;
        tq[c] = 64 * s + col_of(c) - pq[c] * T;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int u = (i % 4) / 2, c = 2 * (i / 4) + (i % 2);
        sbias[pv(s, i)] = pq[c] >= pack ? 0.f
                          : pk[u] != pq[c] ? -INFINITY
                                           : __ldg(bmh + (long long)tq[c] * T + tk[u]);
      }
    }
  }
  // Without the resident values (D <= 32): this warpgroup's next strip's,
  // loaded a strip ahead (while the last strip's products run).
  float B[P::AHEAD ? 32 : 1];
  if constexpr (P::AHEAD) {
#pragma unroll
    for (int i = 0; i < 32; ++i) B[i] = bias_of(wg, i);
  }
  if (t0 < t1) prefetch(t0, 0);
  // Every CTA of the cluster runs before any writes to a peer.
  if constexpr (CS > 1) cluster_sync();
  CLK(0);  // prologue

  for (int tau = t0; tau < t1; ++tau) {
    asm volatile("" : "+r"(tid));
    wg = tid / 128;
    wt = tid % 128;
    warp = wt / 32;
    lane = tid % 32;
    kl0 = 16 * warp + lane / 4;
    const int cur = ST == 2 ? (tau - t0) & 1 : 0;
    unsigned char* raw = smem + P::raw_off + cur * P::RAW;
    const uint32_t a_raw = a_raw0 + cur * P::RAW;
    const uint32_t a_v = a_v0 + cur * P::TILE;
    const uint32_t do_rel = CS == 1 ? cur * P::TILE : 0;
    const unsigned char* sdo = smem + P::do_off + do_rel;
    const uint32_t a_do = a_do0 + do_rel;
    const int qlim = min(pack, per_slot - tau * pack) * T;  // the tile's queries [0, qlim)
    cp_async_wait_all();
    __syncthreads();  // the tile's rows landed; the last tile is done with dkv
    CLK(1);  // waiting for the tile's rows

    // The dq epilogue of strip sp (of this warpgroup) at CS > 1: the
    // cluster's dQs partials summed in rank order, then dscale, the
    // normalisation's backward, dq out and the dqb sum. Each CTA takes RPC
    // of the rows, 128 / TPR a round (dq_rows: row rr of the strip); q (with
    // its rounded bias) comes from the raw rows of CTA sp, which staged query
    // strip sp.
    auto dq_rows = [&](int sp, int rr) {
      const int part = wt % TPR;
      const long long tk = row_tok(tau, 64 * sp + rr);
      const int col0 = part * VPT;
      // Every load in flight before the first sum: the partials in rank
      // order, and q's VPT bf16 values (VPT / 2 words).
      float pd[CS][VPT], qw[VPT / 2 > 1 ? VPT / 2 : 2], dqs[VPT], qf[VPT];
#pragma unroll
      for (int p = 0; p < CS; ++p)
        ld_cluster_words<VPT>(peer_addr(a_dq + (rr * D + col0) * 4, p), pd[p]);
      if constexpr (VPT == 2)
        qw[0] = ld_cluster_f32(peer_addr(a_raw + rr * RS + col0 * 2, sp));
      else
        ld_cluster_words<VPT / 2>(peer_addr(a_raw + rr * RS + col0 * 2, sp), qw);
#pragma unroll
      for (int e = 0; e < VPT; ++e) {
        dqs[e] = pd[0][e];
#pragma unroll
        for (int p = 1; p < CS; ++p) dqs[e] += pd[p][e];
      }
      float ssq = 0.f;
#pragma unroll
      for (int e = 0; e < VPT; e += 2) {
        const uint32_t w = __float_as_uint(qw[e / 2]);
        const float2 qv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
        qf[e] = qv.x;
        qf[e + 1] = qv.y;
        ssq += qv.x * qv.x + qv.y * qv.y;
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) ssq += __shfl_xor_sync(0xffffffffu, ssq, o);
      const float rn = __frcp_rn(fmaxf(sqrtf(ssq), EPS));
      float dsr = 0.f, dot = 0.f;
#pragma unroll
      for (int e = 0; e < VPT; ++e) {
        qf[e] = qf[e] * rn;  // qn
        dsr += dqs[e] * qf[e];
        dqs[e] = dqs[e] * sc;  // dqn
        dot += dqs[e] * qf[e];
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) {
        dsr += __shfl_xor_sync(0xffffffffu, dsr, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (tk >= 0) {
        float* acc = fin + tid * FIN;
        if (part == 0) acc[VPT] += dsr;
        bf16* dst = io.din[0] + tk * io.ld + (long long)h * D + col0;
#pragma unroll
        for (int e = 0; e < VPT; e += 2) {
          const float o0 = round_bf16((dqs[e] - qf[e] * dot) * rn);
          const float o1 = round_bf16((dqs[e + 1] - qf[e + 1] * dot) * rn);
          acc[e] += o0;
          acc[e + 1] += o1;
          *reinterpret_cast<uint32_t*>(dst + e) = pack2(o0, o1);
        }
      }
    };
    auto dq_epilogue = [&](int sp) {
#pragma unroll 1
      for (int round = 0; round < P::ROUNDS; ++round)
        dq_rows(sp, rank * P::RPC + round * (128 / TPR) + wt / TPR);
    };

    // Stage: own keys (Kn) and, into every CTA of the cluster, own query
    // strip (Qs, and dO at CS > 1); the raw q rows get the rounded q-bias.
    for (int i = tid; i < 64 * LPR; i += P::THREADS) {
      const int r = i / LPR, part = i % LPR;
      const bool valid = row_tok(tau, key0 + r) >= 0;
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(raw + 64 * RS + r * RS + part * 16), f);
      float ssq = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
      float nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f[e] / nrm;
      *reinterpret_cast<uint4*>(smem + P::kn_off + tile_off<D>(r, part * 8, 64)) = pack8(f);

      uint4* qraw = reinterpret_cast<uint4*>(raw + r * RS + part * 16);
      unpack8(*qraw, f);
      if (qb != nullptr && valid) {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = round_bf16(f[e] + qb8[e]);
        *qraw = pack8(f);  // exact: the values are bf16
      }
      ssq = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
      nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = (f[e] / nrm) * sc;
      const uint4 qs = pack8(f);
      const uint32_t o = tile_off<D>(key0 + r, part * 8, NK);
      if constexpr (CS == 1) {
        *reinterpret_cast<uint4*>(smem + P::qs_off + o) = qs;
      } else {
        const uint4 dd = *reinterpret_cast<const uint4*>(raw + 2 * 64 * RS + r * RS + part * 16);
#pragma unroll
        for (int p = 0; p < CS; ++p) {
          st_cluster_v4(peer_addr(a_qs + o, p), qs);
          st_cluster_v4(peer_addr(a_do0 + o, p), dd);
        }
      }
    }
    if constexpr (CS > 1) {
      fence_async_all();
      cluster_sync();
      fence_async_all();
    } else {
      fence_async_smem();
      __syncthreads();
    }
    // Every CTA of the cluster is past the last tile: its stage is free.
    if (ST == 2 && tau + 1 < t1) prefetch(tau + 1, cur ^ 1);
    CLK(2);  // staging

    // The strips, WG at a time (warpgroup wg takes strip s0 + wg). Every
    // thread passes every barrier; a warpgroup without a strip only waits.
    float dK[D / 2], dV[D / 2];
    for (int s0 = 0; s0 < strips; s0 += WG) {
      const int s = s0 + wg, q0 = 64 * s;
      const bool act = s < strips;
      float S[32], Pd[32];
      if (act) {
        // S^T = bm^T + Kn Qs^T and dP^T = V dO^T: 64 keys x 64 queries each,
        // S^T's accumulators starting from the strip's starting values.
        if constexpr (P::BIAS) {
#pragma unroll
          for (int i = 0; i < 32; ++i) S[i] = sbias[pv(s, i)];
        } else if constexpr (P::AHEAD) {
#pragma unroll
          for (int i = 0; i < 32; ++i) S[i] = B[i];
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) S[i] = bias_of(s, i);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Mma<64>::ss(S, desc<D>(a_kn, 0, 16 * kk, 64), desc<D>(a_qs, q0, 16 * kk, NK), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Mma<64>::ss(Pd, desc<D>(a_v, 0, 16 * kk, 64), desc<D>(a_do, q0, 16 * kk, NK), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(S);
        fence_regs<32>(Pd);
        CLK(3);  // S and dP
        // The columns' max over this warp's keys.
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int i = 4 * (c / 2) + (c % 2);
          float v = fmaxf(S[i], S[i + 2]);
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
          if (lane < 4) red[warp * 64 + col_of(c)] = v;
        }
      }
      __syncthreads();
      if constexpr (CS > 1) {
        if (act && wt < 64) {  // ... over the CTA's keys, to every CTA of the cluster
          float v = red[wt];
#pragma unroll
          for (int w = 1; w < 4; ++w) v = fmaxf(v, red[w * 64 + wt]);
#pragma unroll
          for (int p = 0; p < CS; ++p)
            st_cluster_f32(peer_addr(a_xch + (rank * 64 + wt) * 4, p), v);
        }
        cluster_sync();
        // The previous strips' dq, while their partials stay untouched.
        if (s0 > 0 && s - WG < strips) dq_epilogue(s - WG);
      }

      // e, and the columns' sum(e) and sum(dp e) over the cluster's keys.
      float* red_s = red + 4 * 64;
      float* red_d = red + 8 * 64;
      const float* xs = xch + CS * 64;
      const float* xd = xch + 2 * CS * 64;
      // A column's total: the four warps' sums (CS = 1), or the cluster's
      // CTAs' sums in rank order.
      auto total = [&](const float* r4, const float* x, int col) {
        float v;
        if constexpr (CS == 1) {
          v = r4[col];
#pragma unroll
          for (int w = 1; w < 4; ++w) v += r4[w * 64 + col];
        } else {
          v = x[col];
#pragma unroll
          for (int p = 1; p < CS; ++p) v += x[p * 64 + col];
        }
        return v;
      };
      if (act) {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int i = 4 * (c / 2) + (c % 2), col = col_of(c);
          float m;
          if constexpr (CS == 1) {
            m = fmaxf(fmaxf(red[col], red[64 + col]), fmaxf(red[128 + col], red[192 + col]));
          } else {
            m = xch[col];
#pragma unroll
            for (int p = 1; p < CS; ++p) m = fmaxf(m, xch[p * 64 + col]);
          }
          S[i] = __expf(S[i] - m);
          S[i + 2] = __expf(S[i + 2] - m);
          float a = S[i] + S[i + 2], b = Pd[i] * S[i] + Pd[i + 2] * S[i + 2];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, o);
            b += __shfl_xor_sync(0xffffffffu, b, o);
          }
          if (lane < 4) {
            red_s[warp * 64 + col] = a;
            red_d[warp * 64 + col] = b;
          }
        }
      }
      __syncthreads();
      if constexpr (CS > 1) {
        if (act && wt < 64) {
          float a = red_s[wt], b = red_d[wt];
#pragma unroll
          for (int w = 1; w < 4; ++w) {
            a += red_s[w * 64 + wt];
            b += red_d[w * 64 + wt];
          }
#pragma unroll
          for (int p = 0; p < CS; ++p) {
            st_cluster_f32(peer_addr(a_xch + ((CS + rank) * 64 + wt) * 4, p), a);
            st_cluster_f32(peer_addr(a_xch + ((2 * CS + rank) * 64 + wt) * 4, p), b);
          }
        }
        cluster_sync();
      }
      CLK(4);  // the statistics (and at CS > 1 the last strip's dq)

      if (act) {
        // ds = e (dp - c) / den in place of dp, c = sum(dp e) / den; queries
        // without a token (padding, windows past the walk) give nothing.
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int i = 4 * (c / 2) + (c % 2), col = col_of(c);
          const float rden = __frcp_rn(total(red_s, xs, col));
          const float cc = total(red_d, xd, col) * rden;
          const bool qv = q0 + col < qlim;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = i + 2 * u;
            Pd[k] = qv ? S[k] * ((Pd[k] - cc) * rden) : 0.f;
            if (!qv) S[k] = 0.f;
          }
        }
        // dbm sum (this thread's elements, in tile order) and bf16(ds) as
        // dQ's A operand.
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int kl = kl0 + 8 * ((i % 4) / 2);
          const int ql = 8 * (i / 4) + 2 * (lane % 4);
          sdbm[pv(s, i)] += Pd[i];
          sdbm[pv(s, i + 1)] += Pd[i + 1];
          *reinterpret_cast<uint32_t*>(sds + tile_off<64>(kl, ql, 64)) = pack2(Pd[i], Pd[i + 1]);
        }
        // The strip's dO/den, rows as dO's (read MN-major by dV's product).
        for (int i = wt; i < 64 * LPR; i += 128) {
          const int r = i / LPR, part = i % LPR;
          const float rden = __frcp_rn(total(red_s, xs, r));
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(sdo + tile_off<D>(q0 + r, part * 8, NK)), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = f[e] * rden;
          *reinterpret_cast<uint4*>(sdod + tile_off<D>(r, part * 8, 64)) = pack8(f);
        }
        fence_async_smem();
        bar_sync(1 + wg, 128);
        CLK(5);  // ds, dbm, the ds and dO/den tiles

        // This CTA's dQs partial bf16(ds) Kn over its keys, to the cluster's
        // dq epilogue (CS > 1) or out of the registers (CS = 1).
        auto dq_out = [&](float* dq) {
          if constexpr (CS > 1) {
#pragma unroll
            for (int i = 0; i < D / 2; i += 2) {
              const int row = 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
              const int col = 8 * (i / 4) + 2 * (lane % 4);
              *reinterpret_cast<float2*>(sdq + row * D + col) = make_float2(dq[i], dq[i + 1]);
            }
          } else {
            // dq from the registers: rows 16 warp + lane/4 (+8), columns
            // 8b + 2(lane % 4) (+1); a row's sums over its four lanes.
#pragma unroll
            for (int hrow = 0; hrow < 2; ++hrow) {
              const int row = kl0 + 8 * hrow;
              const long long tk = row_tok(tau, row);
              float qf[D / 4], ssq = 0.f;
#pragma unroll
              for (int b = 0; b < D / 8; ++b) {
                const int col = 8 * b + 2 * (lane % 4);
                const float2 qv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(raw + row * RS + col * 2));
                qf[2 * b] = qv.x;
                qf[2 * b + 1] = qv.y;
                ssq += qv.x * qv.x + qv.y * qv.y;
              }
              ssq += __shfl_xor_sync(0xffffffffu, ssq, 1);
              ssq += __shfl_xor_sync(0xffffffffu, ssq, 2);
              const float rn = __frcp_rn(fmaxf(sqrtf(ssq), EPS));
              float dsr = 0.f, dot = 0.f;
#pragma unroll
              for (int b = 0; b < D / 8; ++b) {
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  const int k = 4 * b + 2 * hrow + u;
                  qf[2 * b + u] = qf[2 * b + u] * rn;  // qn
                  dsr += dq[k] * qf[2 * b + u];
                  dq[k] = dq[k] * sc;  // dqn
                  dot += dq[k] * qf[2 * b + u];
                }
              }
              dsr += __shfl_xor_sync(0xffffffffu, dsr, 1);
              dsr += __shfl_xor_sync(0xffffffffu, dsr, 2);
              dot += __shfl_xor_sync(0xffffffffu, dot, 1);
              dot += __shfl_xor_sync(0xffffffffu, dot, 2);
              if (tk >= 0) {
                float* acc = fin + tid * FIN;
                if (lane % 4 == 0) acc[D / 4] += dsr;
                bf16* dst = io.din[0] + tk * io.ld + (long long)h * D;
#pragma unroll
                for (int b = 0; b < D / 8; ++b) {
                  const int col = 8 * b + 2 * (lane % 4), k = 4 * b + 2 * hrow;
                  const float o0 = round_bf16((dq[k] - qf[2 * b] * dot) * rn);
                  const float o1 = round_bf16((dq[k + 1] - qf[2 * b + 1] * dot) * rn);
                  acc[2 * b] += o0;
                  acc[2 * b + 1] += o1;
                  *reinterpret_cast<uint32_t*>(dst + col) = pack2(o0, o1);
                }
              }
            }
          }
        };
        // dV += bf16(e)^T (dO/den), dKn += bf16(ds)^T Qs (register A), and
        // the dQs partial (B operands read MN-major from the tiles as
        // staged). At D = 64 the dQs partial goes first, alone, and leaves
        // before dV and dK run: registers.
        {
          uint32_t ea[4][4], da[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            a_frag(S, kk, ea[kk]);
            a_frag(Pd, kk, da[kk]);
          }
          float dq[D / 2];
          auto dq_product = [&]() {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              Mma<D>::template ss<1, 1>(dq, desc_mn<64>(a_ds, 16 * kk, 0, 64),
                                        desc_mn<D>(a_kn, 16 * kk, 0, 64), kk > 0);
          };
          wgmma_fence();
          if constexpr (D == 64) {
            dq_product();
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<D / 2>(dq);
            dq_out(dq);
            wgmma_fence();
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Mma<D>::template rs<1>(dV, ea[kk], desc_mn<D>(a_dod, 16 * kk, 0, 64),
                                   s0 > 0 || kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Mma<D>::template rs<1>(dK, da[kk], desc_mn<D>(a_qs, q0 + 16 * kk, 0, NK),
                                   s0 > 0 || kk > 0);
          if constexpr (D != 64) dq_product();
          wgmma_commit();
          if constexpr (P::AHEAD) {  // the next strip's (or the next tile's first strip's)
            const int sn = s + WG < strips ? s + WG : wg;
#pragma unroll
            for (int i = 0; i < 32; ++i) B[i] = bias_of(sn, i);
          }
          wgmma_wait_all();
          keep_regs<16>(&ea[0][0]);
          keep_regs<16>(&da[0][0]);
          fence_regs<D / 2>(dV);
          fence_regs<D / 2>(dK);
          CLK(6);  // the products
          if constexpr (D != 64) {
            fence_regs<D / 2>(dq);
            dq_out(dq);
          }
          CLK(7);  // dq out
        }
      }
    }
    if constexpr (CS > 1) {
      cluster_sync();  // the last strips' partials are complete
      const int s_last = (strips - 1) / WG * WG + wg;
      if (s_last < strips) dq_epilogue(s_last);
    }
    CLK(8);  // the tile's last dq (CS > 1)

    // The warpgroups' dk and dv sums added in a fixed order (wg 0 + wg 1).
    if constexpr (WG > 1) {
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          dkv[i * 128 + wt] = dK[i];
          dkv[(D / 2 + i) * 128 + wt] = dV[i];
        }
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          dK[i] += dkv[i * 128 + wt];
          dV[i] += dkv[(D / 2 + i) * 128 + wt];
        }
      }
    }

    // dv and dk of this CTA's keys (dk through the normalisation, k from
    // the raw rows).
    if (wg == 0) {
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int kr = kl0 + 8 * hrow;
        const long long tk = row_tok(tau, key0 + kr);
        float kf[D / 4], ssq = 0.f;
#pragma unroll
        for (int b = 0; b < D / 8; ++b) {
          const int col = 8 * b + 2 * (lane % 4);
          const float2 kv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(raw + 64 * RS + kr * RS + col * 2));
          kf[2 * b] = kv.x;
          kf[2 * b + 1] = kv.y;
          ssq += kv.x * kv.x + kv.y * kv.y;
        }
        ssq += __shfl_xor_sync(0xffffffffu, ssq, 1);
        ssq += __shfl_xor_sync(0xffffffffu, ssq, 2);
        const float rn = __frcp_rn(fmaxf(sqrtf(ssq), EPS));
        float dot = 0.f;
#pragma unroll
        for (int b = 0; b < D / 8; ++b) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            kf[2 * b + u] = kf[2 * b + u] * rn;
            dot += dK[4 * b + 2 * hrow + u] * kf[2 * b + u];
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (tk >= 0) {
          const long long off = tk * io.ld + (long long)h * D;
#pragma unroll
          for (int b = 0; b < D / 8; ++b) {
            const int col = 8 * b + 2 * (lane % 4), i = 4 * b + 2 * hrow;
            *reinterpret_cast<uint32_t*>(io.din[2] + off + col) = pack2(dV[i], dV[i + 1]);
            *reinterpret_cast<uint32_t*>(io.din[1] + off + col) =
                pack2((dK[i] - kf[2 * b] * dot) * rn, (dK[i + 1] - kf[2 * b + 1] * dot) * rn);
          }
        }
      }
    }
    CLK(9);  // dk, dv
    // One stage: the next tile's copies start once the cluster is done with it.
    if constexpr (ST == 1) {
      if (tau + 1 < t1) {
        if constexpr (CS > 1) cluster_sync();
        else __syncthreads();
        prefetch(tau + 1, 0);
      }
    }
    CLK(10);  // the next tile's copies (one stage)
  }

  // No CTA leaves while a peer may still read its dQs partial or q rows.
  // Then this CTA's keys of the group's dbm partial (a packed tile's P
  // diagonal blocks folded in block order), and its dqb | dscale partial:
  // the owner threads' sums in a fixed order.
  if constexpr (CS > 1) cluster_sync();
  else __syncthreads();
  CLK(11);  // the walk's end
  float* dst = part_bm + ((long long)grp * base + bh) * T * T;
  if (pack == 1) {
    for (int i = tid; i < 64 * T; i += P::THREADS) {
      const int kl = i % 64, q = i / 64;
      if (key0 + kl < T) dst[(long long)q * T + key0 + kl] = dbm_at(kl, q);
    }
  } else {
    for (int i = tid; i < T * T; i += P::THREADS) {
      const int tk = i % T, tq = i / T;
      float v = 0.f;
      for (int p = 0; p < pack; ++p) v += dbm_at(p * T + tk, p * T + tq);
      dst[(long long)tq * T + tk] = v;
    }
  }
  float* pq = part_q + ((long long)(grp * CS + rank) * base + bh) * (D + 1);
  for (int i = tid; i <= D; i += P::THREADS) {
    float s = 0.f;
    if constexpr (CS > 1) {
      const int part = i < D ? i / VPT : 0, e = i < D ? i % VPT : VPT;
      for (int th = part; th < P::THREADS; th += TPR) s += fin[th * FIN + e];
    } else {
      // Column i is value 2(i/8) + i%2 of the threads with lane % 4 = (i%8)/2.
      const int e = i < D ? 2 * (i / 8) + i % 2 : D / 4;
      for (int th = i < D ? (i % 8) / 2 : 0; th < P::THREADS; th += 4) s += fin[th * FIN + e];
    }
    pq[i] = s;
  }
#ifdef ATTN_BWD_CLOCKS
  if (threadIdx.x == 0 && blockIdx.x < CLK_CTAS)
    for (int k = 0; k < CLK_N; ++k) attn_bwd_clk[blockIdx.x][k] = clk[k];
#endif
}

// The partials summed in a fixed order: dbm over groups; dqb and dscale
// over groups, cluster ranks and bias slots.
__global__ void attn_bwd_reduce_kernel(const float* __restrict__ part_bm,
                                       const float* __restrict__ part_q,
                                       float* __restrict__ dbm, float* __restrict__ dqb,
                                       float* __restrict__ dscale, int groups, int parts_q,
                                       int nw, int heads, int D, int T) {
  const long long n_bm = (long long)nw * heads * T * T;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_bm) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part_bm[g * n_bm + i];
    dbm[i] = s;
    return;
  }
  i -= n_bm;
  int col;
  if (i < (long long)heads * D) {
    col = (int)(i / D) * (D + 1) + (int)(i % D);
  } else if (i < (long long)heads * (D + 1)) {
    col = (int)(i - (long long)heads * D) * (D + 1) + D;
  } else {
    return;
  }
  float s = 0.f;
  for (int p = 0; p < parts_q; ++p)
    for (int slot = 0; slot < nw; ++slot)
      s += part_q[((long long)p * nw + slot) * heads * (D + 1) + col];
  if (i < (long long)heads * D) dqb[i] = s;
  else dscale[i - (long long)heads * D] = s;
}

template <int NK, int D>
cudaError_t launch(QKVIo io, const float* qb, const float* bm, const float* scale,
                   const bf16* dout, float* dqb, float* dbm, float* dscale, float* part_bm,
                   float* part_q, int n_win, int t, int heads, int nw, int groups,
                   cudaStream_t stream) {
  using P = Plan<NK, D>;
  auto kernel = attn_bwd_kernel<NK, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::bytes);
  if (err != cudaSuccess) return err;
  const int base = nw * heads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * base * P::CS));
  cfg.blockDim = dim3(P::THREADS);
  cfg.dynamicSmemBytes = P::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, io, qb, bm, scale, dout, part_bm, part_q, n_win, t,
                           heads, nw, groups);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)base * t * t + (long long)heads * (D + 1);
  attn_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part_bm, part_q, dbm, dqb, dscale, groups, groups * P::CS, nw, heads, D, t);
  return cudaGetLastError();
}

template <int NK_, int D_>
struct Shape {
  static constexpr int NK = NK_, D = D_;
};

// Calls f(Shape<NK, D>{}) for the instantiation that takes window size t
// and head width d.
template <class F>
cudaError_t dispatch(int t, int d, F f) {
  if (t < 1 || t > 256) return cudaErrorInvalidValue;
#define POSEIDON_CASE(DD)                                 \
  if (d == DD) {                                          \
    if (t <= 64) return f(Shape<64, DD>{});               \
    if (t <= 128) return f(Shape<128, DD>{});             \
    return f(Shape<256, DD>{});                           \
  }
  POSEIDON_CASE(16)
  POSEIDON_CASE(32)
  POSEIDON_CASE(64)
#undef POSEIDON_CASE
  return cudaErrorInvalidValue;
}

cudaError_t run(QKVIo io, const void* qb, const void* bm, const void* scale, const void* dout,
                void* dqb, void* dbm, void* dscale, void* part_bm, void* part_q, int n_win,
                int t, int heads, int d, int nw, int groups, void* stream) {
  if (n_win <= 0 || heads <= 0 || nw <= 0 || n_win % nw || groups <= 0 || t < 1)
    return cudaErrorInvalidValue;
  const int pack = t <= 32 ? 64 / t : 1;  // the kernel's windows a tile
  if (groups > (n_win / nw + pack - 1) / pack) return cudaErrorInvalidValue;
  return dispatch(t, d, [&](auto s) {
    using S = decltype(s);
    return launch<S::NK, S::D>(
        io, static_cast<const float*>(qb), static_cast<const float*>(bm),
        static_cast<const float*>(scale), static_cast<const bf16*>(dout),
        static_cast<float*>(dqb), static_cast<float*>(dbm), static_cast<float*>(dscale),
        static_cast<float*>(part_bm), static_cast<float*>(part_q), n_win, t, heads, nw, groups,
        static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" int window_attention_bwd(const void* qkv, const void* qb, const void* bm,
                                    const void* scale, const void* dout, void* dqkv,
                                    void* dqb, void* dbm, void* dscale, void* part_bm,
                                    void* part_q, int n_win, int t, int heads, int d, int nw,
                                    int groups, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  const long long c = (long long)heads * d;
  QKVIo io{{q, q + c, q + 2 * c}, {dq, dq + c, dq + 2 * c}, 3 * c};
  return (int)run(io, qb, bm, scale, dout, dqb, dbm, dscale, part_bm, part_q, n_win, t, heads,
                  d, nw, groups, stream);
}

// dqb is scratch here: the q-bias gradient of a q-bias that is not there.
extern "C" int fused_window_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* bm, const void* scale, const void* dout,
                                          void* dq, void* dk, void* dv, void* dqb, void* dbm,
                                          void* dscale, void* part_bm, void* part_q, int n_win,
                                          int t, int heads, int d, int nw, int groups,
                                          void* stream) {
  QKVIo io{{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v)},
           {static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv)},
           (long long)heads * d};
  return (int)run(io, nullptr, bm, scale, dout, dqb, dbm, dscale, part_bm, part_q, n_win, t,
                  heads, d, nw, groups, stream);
}

// Registers, local-memory (spill) bytes, dynamic shared-memory bytes, CTAs
// an SM (the occupancy calculator), stages of prefetched rows, whether the
// walk's starting values of S^T stay in shared memory, and the clusters
// resident at once on the card (ops/window_attention.py::bwd_plan's
// rounds), of the instantiation that takes window size t and head width d.
extern "C" int window_attention_bwd_info(int t, int d, int* out) {
  return (int)dispatch(t, d, [&](auto s) {
    using S = decltype(s);
    using P = Plan<S::NK, S::D>;
    auto kernel = attn_bwd_kernel<S::NK, S::D>;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, P::THREADS, P::bytes);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(P::CS * 1024);
    cfg.blockDim = dim3(P::THREADS);
    cfg.dynamicSmemBytes = P::bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P::CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)P::bytes;
    out[3] = blocks;
    out[4] = P::STAGES;
    out[5] = P::BIAS ? 1 : 0;
    out[6] = clusters;
    return err;
  });
}

#ifdef ATTN_BWD_CLOCKS
// The diagnostic build's counters of the first `ctas` CTAs of the last call.
extern "C" int window_attention_bwd_clocks(void* out, int ctas) {
  if (ctas < 0 || ctas > CLK_CTAS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, attn_bwd_clk, sizeof(unsigned long long) * CLK_N * ctas);
}
#endif

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
