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
// The wrapper and the plain PyTorch version with the same rounding points
// are in ops/window_attention.py. Layouts are the forward's: q/k/v read from
// three base pointers with one row stride (out of the QKV GEMM output
// (N, T, 3C), or three (N, T, C) tensors), do read as (N, T, C), and dq/dk/dv
// written the same way as q/k/v were read (into one (N, T, 3C) tensor that
// the QKV GEMM's backward takes as it is, or three (N, T, C) ones).
//
// Bound on this card. Per pair the kernel reads 4*T*D bf16 and writes 3*T*D,
// and does about 8*T*T*D FLOPs in four products (recomputing S adds two): at
// T = 256 some 290 FLOPs per byte, at the H100's ridge, and far below it at
// T = 16 and 64; dbm (nW*H*T*T fp32) is written once per call. What the
// design must avoid is what the plain version pays for: N*H*T*T fp32 score,
// probability and gradient tensors in device memory. Here they stay on chip.
//
// Design. Blocks run in no order, and dk/dv sum over query rows while dq sums
// over keys, so the work is split in two passes that both recompute S:
//  1. the query pass: a CTA of 4 warps takes one strip of 64 query rows (all
//     of them at T < 64) of one head and bias slot, and walks the windows of
//     one window group that share the slot. Each warp owns 16 rows: S into an
//     fp32 strip of shared memory, the row max and sum, dp into a second
//     strip, c, then bf16(ds) written in place over the dp strip, then
//     dqs = bf16(ds) kn by WMMA and the normalisation's backward by rows. It
//     writes dq, the rows' (max, sum, c) for the second pass, and one fp32
//     partial of dqb and dscale per CTA.
//  2. the key pass: a CTA takes a strip of 64 keys of one head and slot and
//     walks the same windows. Each warp owns 16 keys and walks the query rows
//     16 at a time: the tiles S^T and dp^T by WMMA, then e and ds from the
//     rows' statistics, ds added to a (keys x T) fp32 dbm sum in shared
//     memory, and dv += bf16(e)^T bf16(do/den), dkn += bf16(ds)^T qs by WMMA
//     with the sums in registers. It writes dk and dv, and its slice of one
//     fp32 dbm partial per window group.
//  3. a reduce kernel sums the partials of every group in a fixed order:
//     dbm, dqb, dscale. No atomics, so two calls give the same bits.
// At T = 256 the query pass holds 168 KB (D = 32) or 208 KB (D = 64) of
// shared memory and the key pass 135 or 199 KB: one CTA per SM. Tensor cores
// through WMMA only; wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STRIP = 64;         // query rows (pass 1) or keys (pass 2) per CTA
constexpr float EPS = 1e-12f;     // torch F.normalize clamp

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the aligned group of G lanes that share one head row.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a = __bfloat1622float2(p[k]);
    f[2 * k] = a.x;
    f[2 * k + 1] = a.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 raw;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return raw;
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// q, k, v (which = 0, 1, 2) of token (n, t) and head h at in[which] +
// (n T + t) ld + h D, and their gradients at the same offsets from din.
struct QKVIo {
  const bf16* in[3];
  bf16* din[3];
  long long ld;
};

// Where the tensors of one pair are: the (window, head) pair's rows of q/k/v
// and their gradients, and of do (N, T, C).
struct Geo {
  QKVIo io;
  const bf16* dout;
  int T, C, D, h;
  long long n;
  __device__ __forceinline__ long long tok(int t) const { return n * T + t; }
  __device__ __forceinline__ const bf16* qkv_row(int t, int which) const {
    return io.in[which] + tok(t) * io.ld + (long long)h * D;
  }
  __device__ __forceinline__ bf16* dqkv_row(int t, int which) const {
    return io.din[which] + tok(t) * io.ld + (long long)h * D;
  }
  __device__ __forceinline__ const bf16* do_row(int t) const {
    return dout + tok(t) * (long long)C + (long long)h * D;
  }
};

// Keys key0.. (L2-normalised, rounded) and values, nkeys rows. Every row is
// D/8 consecutive lanes; nkeys * D / 8 is a multiple of 32, so whole warps
// take part in each step of the loop and in its shuffles.
template <int D>
__device__ void stage_keys(const Geo& g, bf16* skn, bf16* sv, int key0, int nkeys) {
  constexpr int LPR = D / 8;
  for (int i = threadIdx.x; i < nkeys * LPR; i += THREADS) {
    const int r = i / LPR, part = i % LPR;
    const uint4 kraw = *reinterpret_cast<const uint4*>(g.qkv_row(key0 + r, 1) + part * 8);
    const uint4 vraw = *reinterpret_cast<const uint4*>(g.qkv_row(key0 + r, 2) + part * 8);
    *reinterpret_cast<uint4*>(sv + r * D + part * 8) = vraw;
    float f[8];
    unpack8(kraw, f);
    float ssq = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
    const float nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = f[e] / nrm;
    *reinterpret_cast<uint4*>(skn + r * D + part * 8) = pack8(f);
  }
}

// Query rows row0..: bf16(scale * normalise(bf16(q + bf16(qb)))) (no qb
// where it is null), and the
// output cotangent rows as they are (dod == nullptr) or divided by the row's
// softmax sum and rounded (dod != nullptr, sums from st).
template <int D>
__device__ void stage_queries(const Geo& g, const float* qb, float sc, bf16* sqs, bf16* sdo,
                              bf16* sdod, const float* st, int row0, int nrows) {
  constexpr int LPR = D / 8;
  for (int i = threadIdx.x; i < nrows * LPR; i += THREADS) {
    const int r = i / LPR, part = i % LPR;
    const uint4 qraw = *reinterpret_cast<const uint4*>(g.qkv_row(row0 + r, 0) + part * 8);
    const uint4 draw = *reinterpret_cast<const uint4*>(g.do_row(row0 + r) + part * 8);
    *reinterpret_cast<uint4*>(sdo + r * D + part * 8) = draw;
    float f[8];
    if (sdod != nullptr) {
      unpack8(draw, f);
      const float den = st[(row0 + r) * 3 + 1];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f[e] / den;
      *reinterpret_cast<uint4*>(sdod + r * D + part * 8) = pack8(f);
    }
    unpack8(qraw, f);
    if (qb != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = round_bf16(f[e] + round_bf16(qb[g.h * D + part * 8 + e]));
    }
    float ssq = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
    const float nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (f[e] / nrm) * sc;
    *reinterpret_cast<uint4*>(sqs + r * D + part * 8) = pack8(f);
  }
}

// The backward of x -> x / max(|x|, eps) for one head row, by one warp:
// x (fp32) and the cotangent of the normalised row, dxn, D/32 values a lane.
template <int V>
__device__ __forceinline__ void norm_bwd(const float* x, const float* dxn, float* dx, float* xn_out) {
  float ssq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) ssq += x[i] * x[i];
  const float nrm = fmaxf(sqrtf(warp_sum(ssq)), EPS);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    xn_out[i] = x[i] / nrm;
    dot += dxn[i] * xn_out[i];
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int i = 0; i < V; ++i) dx[i] = (dxn[i] - xn_out[i] * dot) / nrm;
}

// The windows of group g among those with bias slot `slot` (n = slot + nW j).
struct Windows {
  int j0, j1;
  __device__ Windows(int n_win, int nw, int groups, int g) {
    const long long per_slot = n_win / nw;
    j0 = (int)(g * per_slot / groups);
    j1 = (int)((g + 1) * per_slot / groups);
  }
};

// ---------------------------------------------------------------------------
// Pass 1: query rows -> dq, row statistics, dqb/dscale partials.
// ---------------------------------------------------------------------------

template <int T, int D>
struct QPlan {
  static constexpr int R = T < STRIP ? T : STRIP;  // query rows per CTA
  static constexpr int SW = T > D ? T : D;         // width of a warp's fp32 strips
  static constexpr size_t kn_off = 0;                                       // T x D bf16
  static constexpr size_t v_off = kn_off + align128(size_t(T) * D * 2);     // T x D bf16
  static constexpr size_t q_off = v_off + align128(size_t(T) * D * 2);      // R x D bf16
  static constexpr size_t do_off = q_off + align128(size_t(R) * D * 2);     // R x D bf16
  static constexpr size_t a_off = do_off + align128(size_t(R) * D * 2);     // WARPS x 16 x SW f32
  static constexpr size_t b_off = a_off + align128(size_t(WARPS) * 16 * SW * 4);
  static constexpr size_t red_off = b_off + align128(size_t(WARPS) * 16 * SW * 4);
  static constexpr size_t bytes = red_off + align128(size_t(WARPS) * (D + 1) * 4);
};

template <int T, int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_q_kernel(QKVIo io, const float* __restrict__ qb,
                  const float* __restrict__ bm, const float* __restrict__ scale,
                  const bf16* __restrict__ dout, float* __restrict__ stats,
                  float* __restrict__ part_q, int n_win, int heads, int nw, int groups) {
  using P = QPlan<T, D>;
  constexpr int STRIPS = T / P::R;
  constexpr int V = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* skn = reinterpret_cast<bf16*>(smem + P::kn_off);
  bf16* sv = reinterpret_cast<bf16*>(smem + P::v_off);
  bf16* sqs = reinterpret_cast<bf16*>(smem + P::q_off);
  bf16* sdo = reinterpret_cast<bf16*>(smem + P::do_off);
  float* red = reinterpret_cast<float*>(smem + P::red_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int base = nw * heads;
  int u = blockIdx.x;
  const int strip = u % STRIPS;
  u /= STRIPS;
  const int bh = u % base, grp = u / base;
  const int slot = bh / heads, h = bh % heads;
  const Windows win(n_win, nw, groups, grp);
  const float sc = scale[h];
  const int row0 = strip * P::R;
  const bool active = warp * 16 < P::R;
  const int wrow = warp * 16;        // the warp's first row within the strip
  const int t0 = row0 + wrow;        // ... within the window
  float* sa = reinterpret_cast<float*>(smem + P::a_off) + warp * 16 * P::SW;
  float* sb = reinterpret_cast<float*>(smem + P::b_off) + warp * 16 * P::SW;
  bf16* dsb = reinterpret_cast<bf16*>(sb);  // bf16(ds) over the dp strip, ldm T
  const float* bmp = bm + ((long long)bh * T + t0) * T;

  Geo g{io, dout, T, heads * D, D, h, 0};
  float dqb_acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) dqb_acc[i] = 0.f;
  float dscale_acc = 0.f;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fbc;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fbr;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;

  for (int j = win.j0; j < win.j1; ++j) {
    g.n = slot + (long long)nw * j;
    __syncthreads();  // the previous window is done with the staged tiles
    stage_keys<D>(g, skn, sv, 0, T);
    stage_queries<D>(g, qb, sc, sqs, sdo, nullptr, nullptr, row0, P::R);
    __syncthreads();
    if (!active) continue;

    // S = bm + Qs Kn^T -> sa;  dp = dO V^T -> sb  (16 x T fp32 each)
#pragma unroll
    for (int jj = 0; jj < T / 16; ++jj) {
      wmma::load_matrix_sync(acc, bmp + jj * 16, T, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(fa, sqs + wrow * D + kk * 16, D);
        wmma::load_matrix_sync(fbc, skn + jj * 16 * D + kk * 16, D);
        wmma::mma_sync(acc, fa, fbc, acc);
      }
      wmma::store_matrix_sync(sa + jj * 16, acc, P::SW, wmma::mem_row_major);
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(fa, sdo + wrow * D + kk * 16, D);
        wmma::load_matrix_sync(fbc, sv + jj * 16 * D + kk * 16, D);
        wmma::mma_sync(acc, fa, fbc, acc);
      }
      wmma::store_matrix_sync(sb + jj * 16, acc, P::SW, wmma::mem_row_major);
    }
    __syncwarp();

    // Row statistics and ds, by rows; bf16(ds) in place over the dp strip
    // (row r of it only overlaps strip rows <= r, already read).
    constexpr int CPL = (T + 31) / 32;
    for (int r = 0; r < 16; ++r) {
      float e[CPL], dp[CPL];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        e[k] = c < T ? sa[r * P::SW + c] : -INFINITY;
        m = fmaxf(m, e[k]);
      }
      m = warp_max(m);
      float den = 0.f, cs = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        e[k] = c < T ? expf(e[k] - m) : 0.f;
        dp[k] = c < T ? sb[r * P::SW + c] : 0.f;
        den += e[k];
        cs += dp[k] * e[k];
      }
      den = warp_sum(den);
      cs = warp_sum(cs) / den;
      __syncwarp();  // row r is read by every lane before bf16(ds) row r overwrites it
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        if (c < T) dsb[r * T + c] = __float2bfloat16(e[k] * ((dp[k] - cs) / den));
      }
      if (lane == 0) {
        float* st = stats + (((long long)g.n * heads + h) * T + t0 + r) * 3;
        st[0] = m;
        st[1] = den;
        st[2] = cs;
      }
    }
    __syncwarp();

    // dqs = bf16(ds) Kn: 16 x D fp32, staged over the S strip (ldm D).
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> qacc[D / 16];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(qacc[dt], 0.f);
#pragma unroll
    for (int jj = 0; jj < T / 16; ++jj) {
      wmma::load_matrix_sync(fa, dsb + jj * 16, T);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        wmma::load_matrix_sync(fbr, skn + jj * 16 * D + dt * 16, D);
        wmma::mma_sync(qacc[dt], fa, fbr, qacc[dt]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt)
      wmma::store_matrix_sync(sa + dt * 16, qacc[dt], D, wmma::mem_row_major);
    __syncwarp();

    // dscale and dq by rows: qs = scale * qn, then the normalisation.
    for (int r = 0; r < 16; ++r) {
      const bf16* qrow = g.qkv_row(t0 + r, 0);
      float qf[V], dqn[V], dq[V], qn[V];
      float dsr = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int d = lane + 32 * i;
        qf[i] = __bfloat162float(qrow[d]);
        if (qb != nullptr) qf[i] = round_bf16(qf[i] + round_bf16(qb[h * D + d]));
      }
      float ssq = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) ssq += qf[i] * qf[i];
      const float nrm = fmaxf(sqrtf(warp_sum(ssq)), EPS);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float dqs = sa[r * D + lane + 32 * i];
        dsr += dqs * (qf[i] / nrm);
        dqn[i] = dqs * sc;
      }
      dscale_acc += warp_sum(dsr);
      norm_bwd<V>(qf, dqn, dq, qn);
      bf16* out = g.dqkv_row(t0 + r, 0);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const bf16 b = __float2bfloat16(dq[i]);
        out[lane + 32 * i] = b;
        dqb_acc[i] += __bfloat162float(b);
      }
    }
  }

  // One partial per CTA: the warps' sums in a fixed order.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < V; ++i) red[warp * (D + 1) + lane + 32 * i] = dqb_acc[i];
  if (lane == 0) red[warp * (D + 1) + D] = dscale_acc;
  __syncthreads();
  for (int i = tid; i <= D; i += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * (D + 1) + i];
    part_q[(((long long)grp * STRIPS + strip) * base + bh) * (D + 1) + i] = s;
  }
}

// ---------------------------------------------------------------------------
// Pass 2: keys -> dk, dv, dbm partials.
// ---------------------------------------------------------------------------

template <int T, int D>
struct KVPlan {
  static constexpr int K = T < STRIP ? T : STRIP;  // keys per CTA
  static constexpr size_t q_off = 0;                                        // T x D bf16
  static constexpr size_t do_off = q_off + align128(size_t(T) * D * 2);     // T x D bf16
  static constexpr size_t dod_off = do_off + align128(size_t(T) * D * 2);   // T x D bf16
  static constexpr size_t st_off = dod_off + align128(size_t(T) * D * 2);   // T x 3 f32
  static constexpr size_t kn_off = st_off + align128(size_t(T) * 3 * 4);    // K x D bf16
  static constexpr size_t v_off = kn_off + align128(size_t(K) * D * 2);     // K x D bf16
  static constexpr size_t c_off = v_off + align128(size_t(K) * D * 2);      // K x T f32
  static constexpr size_t ws_off = c_off + align128(size_t(K) * T * 4);     // WARPS x 16 x D f32
  static constexpr size_t tb_off = ws_off + align128(size_t(WARPS) * 16 * D * 4);  // WARPS x 2 x 256 bf16
  static constexpr size_t bytes = tb_off + align128(size_t(WARPS) * 2 * 256 * 2);
};

template <int T, int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_kv_kernel(QKVIo io, const float* __restrict__ qb,
                   const float* __restrict__ bm, const float* __restrict__ scale,
                   const bf16* __restrict__ dout, const float* __restrict__ stats,
                   float* __restrict__ part_bm, int n_win, int heads, int nw, int groups) {
  using P = KVPlan<T, D>;
  constexpr int KSTRIPS = T / P::K;
  constexpr int V = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sqs = reinterpret_cast<bf16*>(smem + P::q_off);
  bf16* sdo = reinterpret_cast<bf16*>(smem + P::do_off);
  bf16* sdod = reinterpret_cast<bf16*>(smem + P::dod_off);
  float* sst = reinterpret_cast<float*>(smem + P::st_off);
  bf16* skn = reinterpret_cast<bf16*>(smem + P::kn_off);
  bf16* sv = reinterpret_cast<bf16*>(smem + P::v_off);
  float* call = reinterpret_cast<float*>(smem + P::c_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int base = nw * heads;
  int u = blockIdx.x;
  const int ks = u % KSTRIPS;
  u /= KSTRIPS;
  const int bh = u % base, grp = u / base;
  const int slot = bh / heads, h = bh % heads;
  const Windows win(n_win, nw, groups, grp);
  const float sc = scale[h];
  const int key0 = ks * P::K;
  const int k0 = warp * 16;          // the warp's first key within the strip
  const bool active = k0 < P::K;
  float* cacc = call + k0 * T;       // the warp's 16 keys x T dbm sum
  float* ws = reinterpret_cast<float*>(smem + P::ws_off) + warp * 16 * D;
  float* s1 = ws;                    // S^T tile, 16 x 16
  float* s2 = ws + 256;              // dp^T tile
  bf16* ebt = reinterpret_cast<bf16*>(smem + P::tb_off) + warp * 512;
  bf16* dsbt = ebt + 256;
  const float* bmp = bm + (long long)bh * T * T + key0 + k0;

  Geo g{io, dout, T, heads * D, D, h, 0};
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fbc;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fbr;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[D / 16], dv_acc[D / 16];

  bool first = true;
  for (int j = win.j0; j < win.j1; ++j) {
    g.n = slot + (long long)nw * j;
    __syncthreads();  // the previous window is done with the staged tiles
    const float* gst = stats + ((long long)g.n * heads + h) * T * 3;
    for (int i = tid; i < T * 3; i += THREADS) sst[i] = gst[i];
    stage_keys<D>(g, skn, sv, key0, P::K);
    __syncthreads();  // the row sums are in place for do / den
    stage_queries<D>(g, qb, sc, sqs, sdo, sdod, sst, 0, T);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        wmma::fill_fragment(dk_acc[dt], 0.f);
        wmma::fill_fragment(dv_acc[dt], 0.f);
      }
      for (int qt = 0; qt < T / 16; ++qt) {
        const int t0 = qt * 16;
        // S^T = bm^T + Kn Qs^T and dp^T = V dO^T for 16 keys x 16 queries.
        wmma::load_matrix_sync(acc, bmp + (long long)t0 * T, T, wmma::mem_col_major);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(fa, skn + k0 * D + kk * 16, D);
          wmma::load_matrix_sync(fbc, sqs + t0 * D + kk * 16, D);
          wmma::mma_sync(acc, fa, fbc, acc);
        }
        wmma::store_matrix_sync(s1, acc, 16, wmma::mem_row_major);
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(fa, sv + k0 * D + kk * 16, D);
          wmma::load_matrix_sync(fbc, sdo + t0 * D + kk * 16, D);
          wmma::mma_sync(acc, fa, fbc, acc);
        }
        wmma::store_matrix_sync(s2, acc, 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int e = lane + 32 * q, i = e / 16, t = t0 + e % 16;
          const float p = expf(s1[e] - sst[t * 3]);
          const float ds = p * ((s2[e] - sst[t * 3 + 2]) / sst[t * 3 + 1]);
          float* cp = cacc + i * T + t;
          *cp = first ? ds : *cp + ds;
          ebt[e] = __float2bfloat16(p);
          dsbt[e] = __float2bfloat16(ds);
        }
        __syncwarp();
        // dv += bf16(e)^T bf16(do/den);  dkn += bf16(ds)^T Qs
        wmma::load_matrix_sync(fa, ebt, 16);
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          wmma::load_matrix_sync(fbr, sdod + t0 * D + dt * 16, D);
          wmma::mma_sync(dv_acc[dt], fa, fbr, dv_acc[dt]);
        }
        wmma::load_matrix_sync(fa, dsbt, 16);
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          wmma::load_matrix_sync(fbr, sqs + t0 * D + dt * 16, D);
          wmma::mma_sync(dk_acc[dt], fa, fbr, dk_acc[dt]);
        }
        __syncwarp();  // the tiles are read before the next step overwrites them
      }
      // dv rows out.
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt)
        wmma::store_matrix_sync(ws + dt * 16, dv_acc[dt], D, wmma::mem_row_major);
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        bf16* out = g.dqkv_row(key0 + k0 + r, 2);
#pragma unroll
        for (int i = 0; i < V; ++i) out[lane + 32 * i] = __float2bfloat16(ws[r * D + lane + 32 * i]);
      }
      __syncwarp();
      // dk through the normalisation, by rows.
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt)
        wmma::store_matrix_sync(ws + dt * 16, dk_acc[dt], D, wmma::mem_row_major);
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        const bf16* krow = g.qkv_row(key0 + k0 + r, 1);
        float kf[V], dkn[V], dk[V], kn[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          kf[i] = __bfloat162float(krow[lane + 32 * i]);
          dkn[i] = ws[r * D + lane + 32 * i];
        }
        norm_bwd<V>(kf, dkn, dk, kn);
        bf16* out = g.dqkv_row(key0 + k0 + r, 1);
#pragma unroll
        for (int i = 0; i < V; ++i) out[lane + 32 * i] = __float2bfloat16(dk[i]);
      }
    }
    first = false;
  }

  // This CTA's keys of the group's dbm partial, (T x T) rows by query.
  __syncthreads();
  float* dst = part_bm + ((long long)grp * base + bh) * T * T + key0;
  for (int i = tid; i < P::K * T; i += THREADS) {
    const int kl = i % P::K, t = i / P::K;
    dst[(long long)t * T + kl] = call[kl * T + t];
  }
}

// ---------------------------------------------------------------------------
// Pass 3: the partials summed in a fixed order.
// ---------------------------------------------------------------------------

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

template <int T, int D>
cudaError_t launch(QKVIo io, const float* qb, const float* bm, const float* scale,
                   const bf16* dout, float* dqb, float* dbm, float* dscale, float* stats,
                   float* part_bm, float* part_q, int n_win, int heads, int nw, int groups,
                   cudaStream_t stream) {
  using PQ = QPlan<T, D>;
  using PK = KVPlan<T, D>;
  auto qk = attn_bwd_q_kernel<T, D>;
  auto kvk = attn_bwd_kv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)PQ::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kvk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PK::bytes);
  if (err != cudaSuccess) return err;
  const int base = nw * heads;
  const int strips = T / PQ::R;
  qk<<<groups * base * strips, THREADS, PQ::bytes, stream>>>(
      io, qb, bm, scale, dout, stats, part_q, n_win, heads, nw, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kvk<<<groups * base * (T / PK::K), THREADS, PK::bytes, stream>>>(
      io, qb, bm, scale, dout, stats, part_bm, n_win, heads, nw, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)base * T * T + (long long)heads * (D + 1);
  attn_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part_bm, part_q, dbm, dqb, dscale, groups, groups * strips, nw, heads, D, T);
  return cudaGetLastError();
}

cudaError_t run(QKVIo io, const void* qb, const void* bm, const void* scale, const void* dout,
                void* dqb, void* dbm, void* dscale, void* stats, void* part_bm, void* part_q,
                int n_win, int t, int heads, int d, int nw, int groups, void* stream) {
  if (n_win <= 0 || heads <= 0 || nw <= 0 || n_win % nw || groups <= 0 ||
      groups > n_win / nw)
    return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(qb);
  const float* m = static_cast<const float*>(bm);
  const float* s = static_cast<const float*>(scale);
  const bf16* o = static_cast<const bf16*>(dout);
  float* fb = static_cast<float*>(dqb);
  float* fm = static_cast<float*>(dbm);
  float* fs = static_cast<float*>(dscale);
  float* st = static_cast<float*>(stats);
  float* pb = static_cast<float*>(part_bm);
  float* pq = static_cast<float*>(part_q);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define POSEIDON_CASE(TT, DD)                                                                 \
  if (t == TT && d == DD)                                                                     \
    return launch<TT, DD>(io, b, m, s, o, fb, fm, fs, st, pb, pq, n_win, heads, nw, groups, cs);
  POSEIDON_CASE(16, 32)
  POSEIDON_CASE(64, 32)
  POSEIDON_CASE(256, 32)
  POSEIDON_CASE(16, 64)
  POSEIDON_CASE(64, 64)
  POSEIDON_CASE(256, 64)
#undef POSEIDON_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int window_attention_bwd(const void* qkv, const void* qb, const void* bm,
                                    const void* scale, const void* dout, void* dqkv,
                                    void* dqb, void* dbm, void* dscale, void* stats,
                                    void* part_bm, void* part_q, int n_win, int t, int heads,
                                    int d, int nw, int groups, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  const long long c = (long long)heads * d;
  QKVIo io{{q, q + c, q + 2 * c}, {dq, dq + c, dq + 2 * c}, 3 * c};
  return (int)run(io, qb, bm, scale, dout, dqb, dbm, dscale, stats, part_bm, part_q, n_win, t,
                  heads, d, nw, groups, stream);
}

// dqb is scratch here: the q-bias gradient of a q-bias that is not there.
extern "C" int fused_window_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* bm, const void* scale, const void* dout,
                                          void* dq, void* dk, void* dv, void* dqb, void* dbm,
                                          void* dscale, void* stats, void* part_bm,
                                          void* part_q, int n_win, int t, int heads, int d,
                                          int nw, int groups, void* stream) {
  QKVIo io{{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v)},
           {static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv)},
           (long long)heads * d};
  return (int)run(io, nullptr, bm, scale, dout, dqb, dbm, dscale, stats, part_bm, part_q, n_win,
                  t, heads, d, nw, groups, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
