// Window cosine attention, forward and backward, for the calls the Hopper
// kernels (window_attention.cu, window_attention_bwd.cu) do not take: fp32
// operands, and any window of 1-1024 tokens (up to 32x32) with any head
// width of 1-128, in bf16 or fp32. Plain C interface.
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
// Every product is an fp32 FMA on the CUDA cores: fp32 operands get no TF32.
//
// Bound on this card. Per (window, head) pair the forward reads 3 T D
// operands and writes T D, and does 4 T^2 D FLOPs: with fp32 operands
// T / 4 FLOPs a byte, past the fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20
// FLOPs a byte) from T = 80, so the fp32 lanes bound it at every Swin
// window of 9x9 and up. The backward does 10 T^2 D FLOPs on 4 T D read and
// 3 T D written, and is bound the same way.
//
// Design, simple first. A CTA of four warps takes one (window, head) pair
// and 32 of its rows; each warp owns 8 rows, and the keys are streamed
// through shared memory in strips of 32, one key a lane, so T is bounded by
// nothing but the loop. Scores are dot products of rows held in shared
// memory (fp32, row stride chosen so the lanes' 16-byte reads do not
// collide), P.V and ds.K take the strip's probabilities from the other
// lanes by shuffles. Nothing of size T x T goes to device memory, and no
// softmax is rescaled: the forward walks the keys twice, first for each
// row's exact max, then for e, its sum and P.V, so that cast(e) is rounded
// where the plain version rounds it (an online softmax would round e against
// a running max). Every S is computed by the same dot in the same order, so
// it has the same bits in every pass and every kernel.
//
// The backward is four launches. (1) dq: per (window, head, query block),
// three walks over the keys (max; den and sum(dp e); ds and dqs), then the
// normalisation's backward; it writes dq, each row's (max, den, delta), and
// one partial of dscale and dqb per CTA. (2) dk and dv: per (window, head,
// key block), one walk over the query strips with the stored row
// statistics. (3) dbm: per (bias slot, head, query block, key block), a walk
// over the slot's windows in order, summing ds in registers. (4) the dscale
// and dqb partials summed in a fixed order. No atomics, so two calls give
// the same bits. S is recomputed five times and dp three, about twice the
// FLOPs of the function; that is the price of the simple schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;   // four warps
constexpr int ROWS = 8;        // rows a warp owns
constexpr int BLK = 32;        // rows of a block, keys of a strip
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

// Sum and max over the warp; every lane gets lane 0's result.
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return __shfl_sync(FULL, x, 0);
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return __shfl_sync(FULL, x, 0);
}

struct Geo {
  int n, t, heads, d, nw;
  int dp;      // d rounded up to 4: the width the dots walk (zeros past d)
  int sk;      // row stride in shared memory, floats
  int blocks;  // 32-row blocks of a window
};

// A row stride that is a multiple of 4 floats with an odd number of 16-byte
// chunks: eight lanes reading 16 bytes at the same column of eight rows hit
// all 32 banks.
inline int row_stride(int dp) { return (dp / 4) % 2 ? dp : dp + 4; }

template <typename T>
struct Ops {
  const T* q;
  const T* k;
  const T* v;
  long long ld;        // row stride of q, k, v
  const float* qb;     // (C,) q-bias, or null
  const float* bm;     // (nW, H, T, T)
  const float* scale;  // (H,)
};

// dst[r][j] = x[n, row0 + r, h, j] in fp32 for r < 32, j < dp; zero past T
// and d. With qb, cast(x + cast(qb)) as the packed q.
template <typename T>
__device__ void load_rows(float* dst, const T* base, long long ld, const Geo& g, int n, int h,
                          int row0, const float* qb = nullptr) {
  for (int i = threadIdx.x; i < BLK * g.dp; i += THREADS) {
    const int r = i / g.dp, j = i - r * g.dp, row = row0 + r;
    float x = 0.f;
    if (row < g.t && j < g.d) {
      x = to_f(base[((long long)n * g.t + row) * ld + (long long)h * g.d + j]);
      if (qb) x = cast<T>(x + cast<T>(qb[h * g.d + j]));
    }
    dst[r * g.sk + j] = x;
  }
}

// Warp w normalises rows [8w, 8w + 8) of a loaded block in place:
// cast(mult * x / max(|x|, 1e-12)); the unrounded x / max(|x|, 1e-12) goes
// to `unit` and the clamped norm to `norm` where they are given.
template <typename T>
__device__ void normalize_rows(float* x, const Geo& g, float mult, float* unit, float* norm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    float* row = x + r * g.sk;
    float ss = 0.f;
    for (int j = lane; j < g.d; j += 32) ss = fmaf(row[j], row[j], ss);
    const float c = fmaxf(sqrtf(warp_sum(ss)), EPS);
    for (int j = lane; j < g.d; j += 32) {
      const float u = row[j] / c;
      if (unit) unit[r * g.sk + j] = u;
      row[j] = cast<T>(u * mult);
    }
    if (norm && lane == 0) norm[r] = c;
  }
}

// s[rr] = A[8w + rr] . B[lane] over the padded width.
__device__ __forceinline__ void dots(float (&s)[ROWS], const float* A, const float* B,
                                     const Geo& g) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) s[rr] = 0.f;
  const float* b = B + lane * g.sk;
  const float* a = A + warp * ROWS * g.sk;
  for (int j = 0; j < g.dp; j += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + j);
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(a + rr * g.sk + j);
      s[rr] = fmaf(av.x, bv.x, s[rr]);
      s[rr] = fmaf(av.y, bv.y, s[rr]);
      s[rr] = fmaf(av.z, bv.z, s[rr]);
      s[rr] = fmaf(av.w, bv.w, s[rr]);
    }
  }
}

// (window n, head h, 32-row block) of a one-dimensional grid.
struct Pair {
  int n, h, blk;
};
__device__ __forceinline__ Pair pair_of(const Geo& g) {
  const int b = blockIdx.x;
  return {b / (g.blocks * g.heads), (b / g.blocks) % g.heads, b % g.blocks};
}

__device__ __forceinline__ const float* bias_of(const float* bm, const Geo& g, int n, int h) {
  return bm + ((long long)(n % g.nw) * g.heads + h) * g.t * g.t;
}

// Each query row's max of S + bm over the keys (pass 1 of the forward and
// of the dq kernel); kn is a strip buffer, qs this CTA's query block.
template <typename T>
__device__ void row_max(float (&m)[ROWS], const Ops<T>& o, const Geo& g, int n, int h, int q0,
                        const float* qs, float* kn, const float* bmh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) m[rr] = -INFINITY;
  for (int k0 = 0; k0 < g.t; k0 += BLK) {
    load_rows(kn, o.k, o.ld, g, n, h, k0);
    __syncthreads();
    normalize_rows<T>(kn, g, 1.f, nullptr, nullptr);
    __syncthreads();
    float s[ROWS];
    dots(s, qs, kn, g);
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int row = q0 + warp * ROWS + rr;
      if (key < g.t && row < g.t) m[rr] = fmaxf(m[rr], s[rr] + bmh[(long long)row * g.t + key]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) m[rr] = warp_max(m[rr]);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
attn_general_fwd(Ops<T> o, T* __restrict__ out, long long ldo, Geo g) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* kn = qs + BLK * g.sk;
  float* vs = kn + BLK * g.sk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Pair pr = pair_of(g);
  const int n = pr.n, h = pr.h, q0 = pr.blk * BLK;
  const float* bmh = bias_of(o.bm, g, n, h);

  load_rows(qs, o.q, o.ld, g, n, h, q0, o.qb);
  __syncthreads();
  normalize_rows<T>(qs, g, o.scale[h], nullptr, nullptr);
  float m[ROWS];
  row_max(m, o, g, n, h, q0, qs, kn, bmh);

  int col[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) col[i] = min(lane + 32 * i, g.dp - 1);
  float den[ROWS], acc[ROWS][NV];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    den[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[rr][i] = 0.f;
  }
  for (int k0 = 0; k0 < g.t; k0 += BLK) {
    load_rows(kn, o.k, o.ld, g, n, h, k0);
    load_rows(vs, o.v, o.ld, g, n, h, k0);
    __syncthreads();
    normalize_rows<T>(kn, g, 1.f, nullptr, nullptr);
    __syncthreads();
    float s[ROWS], p[ROWS];
    dots(s, qs, kn, g);
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int row = q0 + warp * ROWS + rr;
      float e = 0.f;
      if (key < g.t && row < g.t) e = expf(s[rr] + bmh[(long long)row * g.t + key] - m[rr]);
      den[rr] += e;
      p[rr] = cast<T>(e);
    }
    const int keys = min(BLK, g.t - k0);
    for (int j = 0; j < keys; ++j) {
      float vj[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) vj[i] = vs[j * g.sk + col[i]];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float pj = __shfl_sync(FULL, p[rr], j);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[rr][i] = fmaf(pj, vj[i], acc[rr][i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const float sum = warp_sum(den[rr]);
    const int row = q0 + warp * ROWS + rr;
    if (row >= g.t) continue;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < g.d)
        out[((long long)n * g.t + row) * ldo + (long long)h * g.d + c] = from_f<T>(acc[rr][i] / sum);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// (1) dq, the row statistics (max, den, delta = sum(dp e) / den), and one
// partial of (dqb | dscale) per CTA: part[cta][0..d) = sum over the block's
// rows of cast(dq), part[cta][d] = sum of dqs . qn.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
attn_general_dq(Ops<T> o, const T* __restrict__ dout, T* __restrict__ dq, long long ldd,
                float* __restrict__ stats, float* __restrict__ part, Geo g) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* qn = qs + BLK * g.sk;
  float* dos = qn + BLK * g.sk;
  float* kn = dos + BLK * g.sk;
  float* vs = kn + BLK * g.sk;
  float* qnorm = vs + BLK * g.sk;  // [32]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Pair pr = pair_of(g);
  const int n = pr.n, h = pr.h, q0 = pr.blk * BLK;
  const float* bmh = bias_of(o.bm, g, n, h);
  const long long c_all = (long long)g.heads * g.d;

  load_rows(qs, o.q, o.ld, g, n, h, q0, o.qb);
  load_rows(dos, dout, c_all, g, n, h, q0);
  __syncthreads();
  normalize_rows<T>(qs, g, o.scale[h], qn, qnorm);
  float m[ROWS];
  row_max(m, o, g, n, h, q0, qs, kn, bmh);

  // Pass 2: den and sum(dp e).
  float den[ROWS], sdp[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) den[rr] = sdp[rr] = 0.f;
  for (int k0 = 0; k0 < g.t; k0 += BLK) {
    load_rows(kn, o.k, o.ld, g, n, h, k0);
    load_rows(vs, o.v, o.ld, g, n, h, k0);
    __syncthreads();
    normalize_rows<T>(kn, g, 1.f, nullptr, nullptr);
    __syncthreads();
    float s[ROWS], dpv[ROWS];
    dots(s, qs, kn, g);
    dots(dpv, dos, vs, g);
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int row = q0 + warp * ROWS + rr;
      if (key < g.t && row < g.t) {
        const float e = expf(s[rr] + bmh[(long long)row * g.t + key] - m[rr]);
        den[rr] += e;
        sdp[rr] = fmaf(dpv[rr], e, sdp[rr]);
      }
    }
    __syncthreads();
  }
  float delta[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    den[rr] = warp_sum(den[rr]);
    delta[rr] = warp_sum(sdp[rr]) / den[rr];
  }

  // Pass 3: ds and dqs = cast(ds) . kn.
  int col[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) col[i] = min(lane + 32 * i, g.dp - 1);
  float dqs[ROWS][NV];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
    for (int i = 0; i < NV; ++i) dqs[rr][i] = 0.f;
  for (int k0 = 0; k0 < g.t; k0 += BLK) {
    load_rows(kn, o.k, o.ld, g, n, h, k0);
    load_rows(vs, o.v, o.ld, g, n, h, k0);
    __syncthreads();
    normalize_rows<T>(kn, g, 1.f, nullptr, nullptr);
    __syncthreads();
    float s[ROWS], dpv[ROWS], dsb[ROWS];
    dots(s, qs, kn, g);
    dots(dpv, dos, vs, g);
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int row = q0 + warp * ROWS + rr;
      float ds = 0.f;
      if (key < g.t && row < g.t) {
        const float e = expf(s[rr] + bmh[(long long)row * g.t + key] - m[rr]);
        ds = e * ((dpv[rr] - delta[rr]) / den[rr]);
      }
      dsb[rr] = cast<T>(ds);
    }
    const int keys = min(BLK, g.t - k0);
    for (int j = 0; j < keys; ++j) {
      float kj[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) kj[i] = kn[j * g.sk + col[i]];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float dj = __shfl_sync(FULL, dsb[rr], j);
#pragma unroll
        for (int i = 0; i < NV; ++i) dqs[rr][i] = fmaf(dj, kj[i], dqs[rr][i]);
      }
    }
    __syncthreads();
  }

  // The normalisation's backward, dq out, the statistics and the partials.
  const float sc = o.scale[h];
  float* red = kn;  // [4][sk] per-warp column sums, then [4] dscale sums
  float colsum[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) colsum[i] = 0.f;
  float dsc = 0.f;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr, row = q0 + r;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < g.d) {
        const float u = qn[r * g.sk + col[i]];
        a = fmaf(dqs[rr][i], u, a);
        b = fmaf(dqs[rr][i] * sc, u, b);
      }
    }
    const float dsrow = warp_sum(a), proj = warp_sum(b);
    if (row >= g.t) continue;
    dsc += dsrow;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < g.d) {
        const float u = qn[r * g.sk + c];
        const T v = from_f<T>((dqs[rr][i] * sc - u * proj) / qnorm[r]);
        dq[((long long)n * g.t + row) * ldd + (long long)h * g.d + c] = v;
        colsum[i] += to_f(v);
      }
    }
    if (lane == 0) {
      float* st = stats + (((long long)n * g.heads + h) * g.t + row) * 3;
      st[0] = m[rr];
      st[1] = den[rr];
      st[2] = delta[rr];
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < g.d) red[warp * g.sk + lane + 32 * i] = colsum[i];
  if (lane == 0) red[4 * g.sk + warp] = dsc;
  __syncthreads();
  float* pc = part + (long long)blockIdx.x * (g.d + 1);
  for (int c = threadIdx.x; c <= g.d; c += THREADS) {
    float s = 0.f;
    for (int w = 0; w < 4; ++w) s += c < g.d ? red[w * g.sk + c] : red[4 * g.sk + w];
    pc[c] = s;
  }
}

// (2) dk and dv: per (window, head, key block), a walk over the query
// strips; warp w owns keys [8w, 8w + 8) of the block, a lane one query of
// the strip.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
attn_general_dkdv(Ops<T> o, const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                  long long ldd, const float* __restrict__ stats, Geo g) {
  extern __shared__ __align__(16) float sm[];
  float* kn = sm;
  float* knf = kn + BLK * g.sk;
  float* vs = knf + BLK * g.sk;
  float* qs = vs + BLK * g.sk;
  float* dos = qs + BLK * g.sk;
  float* dod = dos + BLK * g.sk;
  float* knorm = dod + BLK * g.sk;  // [32]
  float* st = knorm + BLK;          // [32][3]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Pair pr = pair_of(g);
  const int n = pr.n, h = pr.h, k0 = pr.blk * BLK;
  const float* bmh = bias_of(o.bm, g, n, h);
  const long long c_all = (long long)g.heads * g.d;
  const float* sth = stats + ((long long)n * g.heads + h) * g.t * 3;

  load_rows(kn, o.k, o.ld, g, n, h, k0);
  load_rows(vs, o.v, o.ld, g, n, h, k0);
  __syncthreads();
  normalize_rows<T>(kn, g, 1.f, knf, knorm);

  int col[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) col[i] = min(lane + 32 * i, g.dp - 1);
  float dva[ROWS][NV], dka[ROWS][NV];
#pragma unroll
  for (int kr = 0; kr < ROWS; ++kr)
#pragma unroll
    for (int i = 0; i < NV; ++i) dva[kr][i] = dka[kr][i] = 0.f;

  for (int q0 = 0; q0 < g.t; q0 += BLK) {
    load_rows(qs, o.q, o.ld, g, n, h, q0, o.qb);
    load_rows(dos, dout, c_all, g, n, h, q0);
    for (int i = threadIdx.x; i < BLK * 3; i += THREADS) {
      const int r = i / 3, row = q0 + r;
      // Rows past T: den 1 so that dod stays finite (they are masked below).
      st[i] = row < g.t ? sth[(long long)row * 3 + i % 3] : (i % 3 == 1 ? 1.f : 0.f);
    }
    __syncthreads();
    normalize_rows<T>(qs, g, o.scale[h], nullptr, nullptr);
    for (int i = threadIdx.x; i < BLK * g.dp; i += THREADS) {
      const int r = i / g.dp, j = i - r * g.dp;
      dod[r * g.sk + j] = cast<T>(dos[r * g.sk + j] / st[r * 3 + 1]);
    }
    __syncthreads();
    float s[ROWS], dpv[ROWS], pe[ROWS], dsb[ROWS];
    dots(s, kn, qs, g);
    dots(dpv, vs, dos, g);
    const int row = q0 + lane;
    const float mq = st[lane * 3], dq_den = st[lane * 3 + 1], dq_delta = st[lane * 3 + 2];
#pragma unroll
    for (int kr = 0; kr < ROWS; ++kr) {
      const int key = k0 + warp * ROWS + kr;
      float e = 0.f, ds = 0.f;
      if (key < g.t && row < g.t) {
        e = expf(s[kr] + bmh[(long long)row * g.t + key] - mq);
        ds = e * ((dpv[kr] - dq_delta) / dq_den);
      }
      pe[kr] = cast<T>(e);
      dsb[kr] = cast<T>(ds);
    }
    const int rows = min(BLK, g.t - q0);
    for (int j = 0; j < rows; ++j) {
      float dj[NV], qj[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        dj[i] = dod[j * g.sk + col[i]];
        qj[i] = qs[j * g.sk + col[i]];
      }
#pragma unroll
      for (int kr = 0; kr < ROWS; ++kr) {
        const float ej = __shfl_sync(FULL, pe[kr], j), sj = __shfl_sync(FULL, dsb[kr], j);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          dva[kr][i] = fmaf(ej, dj[i], dva[kr][i]);
          dka[kr][i] = fmaf(sj, qj[i], dka[kr][i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int kr = 0; kr < ROWS; ++kr) {
    const int r = warp * ROWS + kr, key = k0 + r;
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < g.d) a = fmaf(dka[kr][i], knf[r * g.sk + col[i]], a);
    const float proj = warp_sum(a);
    if (key >= g.t) continue;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < g.d) {
        const long long off = ((long long)n * g.t + key) * ldd + (long long)h * g.d + c;
        dk[off] = from_f<T>((dka[kr][i] - knf[r * g.sk + c] * proj) / knorm[r]);
        dv[off] = from_f<T>(dva[kr][i]);
      }
    }
  }
}

// (3) dbm: per (bias slot, head, query block, key block), the slot's
// windows walked in order, ds summed in registers; warp w owns query rows
// [8w, 8w + 8) of the block, a lane one key.
template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_general_dbm(Ops<T> o, const T* __restrict__ dout, const float* __restrict__ stats,
                 float* __restrict__ dbm, Geo g) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dos = qs + BLK * g.sk;
  float* kn = dos + BLK * g.sk;
  float* vs = kn + BLK * g.sk;
  float* st = vs + BLK * g.sk;  // [32][3]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int b = blockIdx.x;
  const int kb = b % g.blocks;
  b /= g.blocks;
  const int qblk = b % g.blocks;
  b /= g.blocks;
  const int h = b % g.heads, slot = b / g.heads;
  const int q0 = qblk * BLK, k0 = kb * BLK;
  const long long c_all = (long long)g.heads * g.d;
  const float* bmh = bias_of(o.bm, g, slot, h);

  float acc[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) acc[rr] = 0.f;
  for (int n = slot; n < g.n; n += g.nw) {
    load_rows(qs, o.q, o.ld, g, n, h, q0, o.qb);
    load_rows(dos, dout, c_all, g, n, h, q0);
    load_rows(kn, o.k, o.ld, g, n, h, k0);
    load_rows(vs, o.v, o.ld, g, n, h, k0);
    const float* sth = stats + ((long long)n * g.heads + h) * g.t * 3;
    for (int i = threadIdx.x; i < BLK * 3; i += THREADS) {
      const int row = q0 + i / 3;
      st[i] = row < g.t ? sth[(long long)row * 3 + i % 3] : 1.f;
    }
    __syncthreads();
    normalize_rows<T>(qs, g, o.scale[h], nullptr, nullptr);
    normalize_rows<T>(kn, g, 1.f, nullptr, nullptr);
    __syncthreads();
    float s[ROWS], dpv[ROWS];
    dots(s, qs, kn, g);
    dots(dpv, dos, vs, g);
    const int key = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr, row = q0 + r;
      if (key < g.t && row < g.t) {
        const float e = expf(s[rr] + bmh[(long long)row * g.t + key] - st[r * 3]);
        acc[rr] += e * ((dpv[rr] - st[r * 3 + 2]) / st[r * 3 + 1]);
      }
    }
    __syncthreads();
  }
  const int key = k0 + lane;
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int row = q0 + warp * ROWS + rr;
    if (key < g.t && row < g.t)
      dbm[(((long long)slot * g.heads + h) * g.t + row) * g.t + key] = acc[rr];
  }
}

// (4) dqb (when given) and dscale: one CTA per (head, column c <= d) sums
// the partials of that head's CTAs in a fixed order.
__global__ void __launch_bounds__(THREADS)
attn_general_reduce(const float* __restrict__ part, float* __restrict__ dqb,
                    float* __restrict__ dscale, Geo g) {
  __shared__ float red[THREADS];
  const int c = blockIdx.x % (g.d + 1), h = blockIdx.x / (g.d + 1);
  const int terms = g.n * g.blocks;
  float s = 0.f;
  for (int i = threadIdx.x; i < terms; i += THREADS) {
    const int n = i / g.blocks, blk = i % g.blocks;
    s += part[(((long long)n * g.heads + h) * g.blocks + blk) * (g.d + 1) + c];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (c == g.d) dscale[h] = red[0];
    else if (dqb) dqb[h * g.d + c] = red[0];
  }
}

// Dynamic shared memory of each kernel: 32-row fp32 blocks plus small
// per-row arrays.
enum Kernel { FWD = 0, DQ = 1, DKDV = 2, DBM = 3 };
size_t smem_bytes(int kernel, int sk) {
  const size_t blk = (size_t)BLK * sk * sizeof(float);
  switch (kernel) {
    case FWD: return 3 * blk;
    case DQ: return 5 * blk + BLK * sizeof(float);
    case DKDV: return 6 * blk + 4 * BLK * sizeof(float);
    default: return 4 * blk + 3 * BLK * sizeof(float);
  }
}

Geo make_geo(int n, int t, int heads, int d, int nw) {
  Geo g;
  g.n = n;
  g.t = t;
  g.heads = heads;
  g.d = d;
  g.nw = nw;
  g.dp = (d + 3) / 4 * 4;
  g.sk = row_stride(g.dp);
  g.blocks = (t + BLK - 1) / BLK;
  return g;
}

bool valid(int n, int t, int heads, int d, int nw) {
  return n > 0 && heads > 0 && nw > 0 && n % nw == 0 && t >= 1 && t <= MAX_T && d >= 1 &&
         d <= MAX_D;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Calls f with an int constant NV = ceil(d / 32) in 1..4.
template <typename F>
cudaError_t by_width(int d, F f) {
  switch ((d + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_fwd(Ops<T> o, T* out, long long ldo, Geo g, cudaStream_t stream) {
  return by_width(g.d, [&](auto w) {
    constexpr int NV = decltype(w)::value;
    auto k = attn_general_fwd<T, NV>;
    const size_t smem = smem_bytes(FWD, g.sk);
    cudaError_t err = allow_smem(k, smem);
    if (err != cudaSuccess) return err;
    k<<<g.n * g.heads * g.blocks, THREADS, smem, stream>>>(o, out, ldo, g);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t run_bwd(Ops<T> o, const T* dout, T* dq, T* dk, T* dv, long long ldd, float* dqb,
                    float* dbm, float* dscale, float* stats, float* part, Geo g,
                    cudaStream_t stream) {
  cudaError_t err = by_width(g.d, [&](auto w) {
    constexpr int NV = decltype(w)::value;
    const unsigned grid = g.n * g.heads * g.blocks;
    auto kq = attn_general_dq<T, NV>;
    size_t smem = smem_bytes(DQ, g.sk);
    cudaError_t e = allow_smem(kq, smem);
    if (e != cudaSuccess) return e;
    kq<<<grid, THREADS, smem, stream>>>(o, dout, dq, ldd, stats, part, g);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    auto kk = attn_general_dkdv<T, NV>;
    smem = smem_bytes(DKDV, g.sk);
    if ((e = allow_smem(kk, smem)) != cudaSuccess) return e;
    kk<<<grid, THREADS, smem, stream>>>(o, dout, dk, dv, ldd, stats, g);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  auto kb = attn_general_dbm<T>;
  const size_t smem = smem_bytes(DBM, g.sk);
  if ((err = allow_smem(kb, smem)) != cudaSuccess) return err;
  kb<<<g.nw * g.heads * g.blocks * g.blocks, THREADS, smem, stream>>>(o, dout, stats, dbm, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_general_reduce<<<g.heads * (g.d + 1), THREADS, 0, stream>>>(part, dqb, dscale, g);
  return cudaGetLastError();
}

template <typename T>
Ops<T> ops(const void* q, const void* k, const void* v, long long ld, const void* qb,
           const void* bm, const void* scale) {
  return {static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ld,
          static_cast<const float*>(qb), static_cast<const float*>(bm),
          static_cast<const float*>(scale)};
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
  const Geo g = make_geo(n_win, t, heads, d, nw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32)
    return (int)run_fwd(ops<float>(q, k, v, ld, qb, bm, scale), static_cast<float*>(out), ldo,
                        g, s);
  return (int)run_fwd(ops<bf16>(q, k, v, ld, qb, bm, scale), static_cast<bf16*>(out), ldo, g,
                      s);
}

// The backward: dout (N, T, C); dq, dk, dv written at the offsets of q, k,
// v with row stride ldd; dqb (C,) (may be null), dbm (nW, H, T, T) and
// dscale (H,) fp32; scratch: stats (N, H, T, 3) and part (N H ceil(T/32),
// D + 1) fp32.
extern "C" int window_attention_general_bwd(const void* q, const void* k, const void* v,
                                            const void* qb, const void* bm, const void* scale,
                                            const void* dout, void* dq, void* dk, void* dv,
                                            void* dqb, void* dbm, void* dscale, void* stats,
                                            void* part, int ld, int ldd, int n_win, int t,
                                            int heads, int d, int nw, int fp32, void* stream) {
  if (!valid(n_win, t, heads, d, nw)) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(n_win, t, heads, d, nw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f[5] = {static_cast<float*>(dqb), static_cast<float*>(dbm), static_cast<float*>(dscale),
                 static_cast<float*>(stats), static_cast<float*>(part)};
  if (fp32)
    return (int)run_bwd(ops<float>(q, k, v, ld, qb, bm, scale), static_cast<const float*>(dout),
                        static_cast<float*>(dq), static_cast<float*>(dk),
                        static_cast<float*>(dv), ldd, f[0], f[1], f[2], f[3], f[4], g, s);
  return (int)run_bwd(ops<bf16>(q, k, v, ld, qb, bm, scale), static_cast<const bf16*>(dout),
                      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                      ldd, f[0], f[1], f[2], f[3], f[4], g, s);
}

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes (at
// D = 32 nv) of kernel 0-3 (forward, dq, dk/dv, dbm) for fp32 or bf16
// operands and nv = ceil(D / 32).
extern "C" int window_attention_general_info(int kernel, int fp32, int nv, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = by_width(32 * nv, [&](auto w) {
    constexpr int NV = decltype(w)::value;
    const void* fns[2][4] = {
        {(const void*)attn_general_fwd<bf16, NV>, (const void*)attn_general_dq<bf16, NV>,
         (const void*)attn_general_dkdv<bf16, NV>, (const void*)attn_general_dbm<bf16>},
        {(const void*)attn_general_fwd<float, NV>, (const void*)attn_general_dq<float, NV>,
         (const void*)attn_general_dkdv<float, NV>, (const void*)attn_general_dbm<float>}};
    if (kernel < 0 || kernel > 3) return cudaErrorInvalidValue;
    return cudaFuncGetAttributes(&a, fns[fp32 ? 1 : 0][kernel]);
  });
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem_bytes(kernel, row_stride(32 * nv));
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
