// Window cosine attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces two TPU kernels of poseidon_tpu/ops/window_attention.py:
// _fwd_kernel_qkv (pallas_call in _core_fwd_qkv; entry window_attention_fwd:
// q/k/v packed in one QKV tensor, with the q-projection bias added in the
// kernel) and _fwd_kernel (pallas_call in _core_fwd; entry
// fused_window_attention_fwd: separate q, k and v, no q-bias). Per (window,
// head) pair:
//   q  = bf16(q + bf16(qb))                                   (packed entry only)
//   qn = q / max(|q|, 1e-12);  kn = k / max(|k|, 1e-12)
//   S  = bf16(scale[h] * qn) . bf16(kn)^T  (fp32 accumulate)  + bm[n mod nW, h]
//   e  = exp(S - max S);  O = bf16(e) . v / sum(e)            (fp32 softmax)
// The Python wrapper and the plain PyTorch version with the same rounding
// points are in ops/window_attention.py.
//
// Layouts. The kernel reads q, k and v token-major from three base pointers
// with one row stride: out of the fused QKV GEMM's output qkv (N, T, 3C),
// columns [q | k | v] in (head, d) order, at offsets 0, C, 2C and stride 3C,
// with no split or transpose copies; or from three (N, T, C) tensors at stride
// C (the separate-q/k/v op, whose wrapper brings its four layouts to this
// one). It writes O token-major as (N, T, C), columns in (head, d) order,
// which is the A operand the output-projection GEMM takes as it is. Token-major rows make every q/k/v/O row of one head a contiguous
// run of D bf16 values (64 or 128 bytes): D/8 lanes read it as 16-byte chunks.
//
// Bound on this card. Per pair the kernel reads 3*T*D bf16 and writes T*D,
// and does 4*T*T*D FLOPs in two products: T/2 FLOPs per byte (bm, nW*H*T*T
// fp32, is read once for all images). At T = 256 that is 128, below the
// H100's ~295 FLOP/B ridge, so the kernel is bound by device-memory bytes; at
// T = 16 and 64 even more so. The design keeps everything between the reads
// and the write on chip: the score rows (fp32) and probabilities (bf16) live
// in shared memory and never touch device memory, which is what the plain
// version pays for (an N*H*T*T fp32 score tensor, written and read several
// times).
//
// Design. A CTA of 4 warps takes 64 consecutive query rows of the flattened
// (pair, t) row space. At T = 256 that is a quarter of one pair; at T = 64 one
// pair; at T = 16 four pairs (this replaces the TPU's block-diagonal head
// packing). The CTA stages the keys of its pairs, L2-normalised and rounded to
// bf16, and the raw values in shared memory (max(T, 64) rows), and its 64
// query rows, normalised, scaled and rounded. Every thread first issues all
// of its 16-byte loads (D/8 lanes per head row), then normalises them with
// shuffles inside its lane group, so the loads are in flight together. Each
// warp then owns 16 query rows of one pair: S = bm + Qs Kn^T by WMMA (the
// accumulator starts from the bm rows, bf16 in, fp32 accumulate) into a
// 16 x T fp32 strip; an fp32 softmax by rows with warp shuffles, writing
// P = bf16(e) over the strip in place (row r of P only overlaps strip rows
// <= r, already read); O = P V by WMMA; the 1/sum on the way out. The strip
// and the staged K/V keep a T = 256, D = 32 CTA at 100 KB of shared memory,
// two CTAs per SM. Tensor cores through WMMA only; wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16 * WARPS;  // query rows per CTA
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

// Shared-memory plan of one CTA (byte offsets; every region 32-byte aligned
// for WMMA).
template <int T, int D>
struct Plan {
  static constexpr int KR = T > ROWS ? T : ROWS;  // key/value rows staged
  static constexpr int SW = T > D ? T : D;        // width of a warp's fp32 strip
  static constexpr size_t q_off = 0;                                  // ROWS x D bf16
  static constexpr size_t k_off = q_off + size_t(ROWS) * D * 2;       // KR x D bf16
  static constexpr size_t v_off = k_off + size_t(KR) * D * 2;         // KR x D bf16
  static constexpr size_t s_off = v_off + size_t(KR) * D * 2;         // WARPS x 16 x SW f32
  static constexpr size_t den_off = s_off + size_t(WARPS) * 16 * SW * 4;  // ROWS f32
  static constexpr size_t bytes = den_off + size_t(ROWS) * 4;
};

// q, k and v of token (n, t) and head h at q/k/v + (n T + t) ld + h D.
struct QKV {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long ld;
};

// qb (C,) is added to q where it is not null.
template <int T, int D>
__global__ void __launch_bounds__(THREADS)
window_attention_fwd_kernel(QKV in, const float* __restrict__ qb,
                            const float* __restrict__ bm, const float* __restrict__ scale,
                            bf16* __restrict__ out, int n_win, int heads, int nw) {
  using P = Plan<T, D>;
  constexpr int LPR = D / 8;                        // lanes per head row, 16 B each
  constexpr int KCH = P::KR * LPR / THREADS;        // K (and V) chunks per thread
  constexpr int QCH = ROWS * LPR / THREADS;         // Q chunks per thread
  constexpr int V = D / 32;                         // O values per lane in a row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + P::q_off);
  bf16* sk = reinterpret_cast<bf16*>(smem + P::k_off);
  bf16* sv = reinterpret_cast<bf16*>(smem + P::v_off);
  float* ss = reinterpret_cast<float*>(smem + P::s_off);
  float* sden = reinterpret_cast<float*>(smem + P::den_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = heads * D;
  const long long total_rows = (long long)n_win * heads * T;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const long long pair0 = row0 / T;
  const long long key0 = pair0 * T;

  // Issue every load first: K and V chunks of the staged key rows, Q chunks
  // of the CTA's query rows. Rows past the end are zeros.
  uint4 kraw[KCH], vraw[KCH], qraw[QCH];
#pragma unroll
  for (int it = 0; it < KCH; ++it) {
    const int i = it * THREADS + tid, r = i / LPR, part = i % LPR;
    const long long g = key0 + r;
    kraw[it] = vraw[it] = make_uint4(0u, 0u, 0u, 0u);
    if (g < total_rows) {
      const long long pair = g / T, n = pair / heads;
      const int t = (int)(g % T), h = (int)(pair % heads);
      const long long off = (n * T + t) * in.ld + (long long)h * D + part * 8;
      kraw[it] = *reinterpret_cast<const uint4*>(in.k + off);
      vraw[it] = *reinterpret_cast<const uint4*>(in.v + off);
    }
  }
#pragma unroll
  for (int it = 0; it < QCH; ++it) {
    const int i = it * THREADS + tid, r = i / LPR, part = i % LPR;
    const long long g = row0 + r;
    qraw[it] = make_uint4(0u, 0u, 0u, 0u);
    if (g < total_rows) {
      const long long pair = g / T, n = pair / heads;
      const int t = (int)(g % T), h = (int)(pair % heads);
      qraw[it] = *reinterpret_cast<const uint4*>(
          in.q + (n * T + t) * in.ld + (long long)h * D + part * 8);
    }
  }
  // Keys: L2-normalised, rounded; values as they are.
#pragma unroll
  for (int it = 0; it < KCH; ++it) {
    const int i = it * THREADS + tid, r = i / LPR, part = i % LPR;
    *reinterpret_cast<uint4*>(sv + r * D + part * 8) = vraw[it];
    float f[8];
    unpack8(kraw[it], f);
    float ssq = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
    const float nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = f[e] / nrm;
    *reinterpret_cast<uint4*>(sk + r * D + part * 8) = pack8(f);
  }
  // Queries: + bias (rounded) if any, normalised, scaled by the head's logit
  // scale.
#pragma unroll
  for (int it = 0; it < QCH; ++it) {
    const int i = it * THREADS + tid, r = i / LPR, part = i % LPR;
    const long long g = row0 + r;
    const int h = g < total_rows ? (int)((g / T) % heads) : 0;
    float f[8];
    unpack8(qraw[it], f);
    if (qb != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = round_bf16(f[e] + round_bf16(qb[h * D + part * 8 + e]));
    }
    float ssq = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
    const float nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
    const float sc = scale[h];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = (f[e] / nrm) * sc;
    *reinterpret_cast<uint4*>(sq + r * D + part * 8) = pack8(f);
  }
  __syncthreads();

  const long long wrow0 = row0 + warp * 16;
  if (wrow0 >= total_rows) return;  // T and the row count are multiples of 16
  const long long pair = wrow0 / T;
  const int t0 = (int)(wrow0 % T);
  const int koff = (int)((pair - pair0) * T);  // the pair's first staged key row
  const long long n = pair / heads;
  const int h = (int)(pair % heads);
  float* strip = ss + warp * 16 * P::SW;
  bf16* prob = reinterpret_cast<bf16*>(strip);  // P over the strip, ldm T

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;

  // S = bm + Qs Kn^T: 16 x T, fp32.
  const float* bmp = bm + (((long long)(n % nw) * heads + h) * T + t0) * T;
#pragma unroll
  for (int j = 0; j < T / 16; ++j) {
    wmma::load_matrix_sync(acc, bmp + j * 16, T, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::load_matrix_sync(fa, sq + warp * 16 * D + kk * 16, D);
      wmma::load_matrix_sync(fk, sk + (koff + j * 16) * D + kk * 16, D);
      wmma::mma_sync(acc, fa, fk, acc);
    }
    wmma::store_matrix_sync(strip + j * 16, acc, P::SW, wmma::mem_row_major);
  }
  __syncwarp();

  // fp32 softmax by rows; P = bf16(e) in place, den = sum(e).
  constexpr int CPL = (T + 31) / 32;  // columns per lane
  for (int r = 0; r < 16; ++r) {
    float s[CPL];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      s[k] = c < T ? strip[r * P::SW + c] : -INFINITY;
      m = fmaxf(m, s[k]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      s[k] = c < T ? expf(s[k] - m) : 0.f;
      sum += s[k];
    }
    sum = warp_sum(sum);
    __syncwarp();  // row r is read by every lane before P row r overwrites it
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < T) prob[r * T + c] = __float2bfloat16(s[k]);
    }
    if (lane == 0) sden[warp * 16 + r] = sum;
  }
  __syncwarp();

  // O = P V: 16 x D, fp32, then staged over the strip.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(oacc[dt], 0.f);
#pragma unroll
  for (int j = 0; j < T / 16; ++j) {
    wmma::load_matrix_sync(fa, prob + j * 16, T);
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::load_matrix_sync(fv, sv + (koff + j * 16) * D + dt * 16, D);
      wmma::mma_sync(oacc[dt], fa, fv, oacc[dt]);
    }
  }
  __syncwarp();  // every lane is done reading P before O overwrites it
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt)
    wmma::store_matrix_sync(strip + dt * 16, oacc[dt], P::SW, wmma::mem_row_major);
  __syncwarp();

  for (int r = 0; r < 16; ++r) {
    const float den = sden[warp * 16 + r];
    bf16* orow = out + (n * T + t0 + r) * C + (long long)h * D;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int d = lane + 32 * i;
      orow[d] = __float2bfloat16(strip[r * P::SW + d] / den);
    }
  }
}

template <int T, int D>
cudaError_t launch(QKV in, const float* qb, const float* bm, const float* scale, bf16* out,
                   int n_win, int heads, int nw, cudaStream_t stream) {
  using P = Plan<T, D>;
  auto kernel = window_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)n_win * heads * T;
  const unsigned grid = (unsigned)((rows + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, P::bytes, stream>>>(in, qb, bm, scale, out, n_win, heads, nw);
  return cudaGetLastError();
}

cudaError_t run(QKV in, const float* qb, const float* bm, const float* scale, bf16* out,
                int n_win, int t, int heads, int d, int nw, cudaStream_t st) {
  if (n_win <= 0 || heads <= 0 || nw <= 0 || n_win % nw) return cudaErrorInvalidValue;
#define POSEIDON_CASE(TT, DD) \
  if (t == TT && d == DD) return launch<TT, DD>(in, qb, bm, scale, out, n_win, heads, nw, st);
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

extern "C" int window_attention_fwd(const void* qkv, const void* qb, const void* bm,
                                    const void* scale, void* out, int n_win, int t,
                                    int heads, int d, int nw, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const long long c = (long long)heads * d;
  return (int)run(QKV{q, q + c, q + 2 * c, 3 * c}, static_cast<const float*>(qb),
                  static_cast<const float*>(bm), static_cast<const float*>(scale),
                  static_cast<bf16*>(out), n_win, t, heads, d, nw,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int fused_window_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* bm, const void* scale, void* out,
                                          int n_win, int t, int heads, int d, int nw,
                                          void* stream) {
  return (int)run(QKV{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), (long long)heads * d},
                  nullptr, static_cast<const float*>(bm), static_cast<const float*>(scale),
                  static_cast<bf16*>(out), n_win, t, heads, d, nw,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
