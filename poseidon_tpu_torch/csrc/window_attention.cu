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
// points are in ops/window_attention.py. T is any window size up to 256
// (keys padded to NK = 64, 128 or 256 and masked), D is 16, 32 or 64.
//
// Layouts. q, k and v are read token-major from three base pointers with one
// row stride: out of the fused QKV GEMM's output (N, T, 3C) at offsets 0, C,
// 2C and stride 3C, or from three (N, T, C) tensors at stride C. O is
// written token-major as (N, T, C), the A operand of the output projection.
//
// Bound on this card. Per pair the kernel reads 3*T*D bf16 and writes T*D,
// and does 4*T*T*D FLOPs: T/2 FLOPs per byte, below the H100's ~295 FLOP/B
// ridge, so device-memory bytes bound it (bm, nW*H*T*T fp32, is read once
// for all images in that count). What the design must avoid is the plain
// version's N*H*T*T fp32 score tensors in device memory.
//
// Design. A persistent CTA of one or two warpgroups walks (window, head)
// pairs. For each pair it stages q, k and v once: cp.async copies the raw
// rows into shared memory while the CTA still computes the previous pair,
// then the CTA normalises them into the swizzled K-major tiles that the
// wgmma descriptors read (Qs and Kn by rows, V transposed so that keys are
// the reduction index of P.V). Each warpgroup takes 64-row query strips:
//  - S = bm + Qs Kn^T is one chain of m64n64k16 wgmmas per 64 keys,
//    accumulated in registers (NK/2 fp32 a thread). The accumulators start
//    from the bm rows (keys past T at -inf): the bias loads land in the
//    accumulator registers themselves, all in flight at once;
//  - each row's exact max and sum are taken in registers with quad
//    shuffles; no online rescaling, so the rounding point bf16(exp(S - max
//    S)) and the fp32 sum stay the JAX kernel's (exp by the fast exponential,
//    within about 2 ulp of expf);
//  - P = bf16(e) is repacked in registers as the A operand of O = P V
//    (m64nDk16, register A), 64 keys a commit group, the next group packed
//    while the last one runs; no score or probability touches shared or
//    device memory;
//  - 1/sum is applied in registers, O goes through a small shared staging
//    tile and leaves in 16-byte row stores.
// The bias is read from L2 once per pair (each thread reads the bm values
// of its accumulator elements): 4*T*T bytes a pair, 100 MB a call at
// ScOT-B stage 0, which the bound counts once (1 MB). Registers bound
// occupancy (S of a 64 x 256 strip: at most 246 a thread, no spills);
// shared memory holds one pair's raw and staged tiles (at most 208 KB).

#include "wgmma.cuh"

using namespace wgm;

namespace {

constexpr float EPS = 1e-12f;  // torch F.normalize clamp

// q, k and v of token (n, t) and head h at q/k/v + (n T + t) ld + h D.
struct QKV {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long ld;
};

template <int NK, int D>
struct Plan {
  static constexpr int QW = NK >= 128 ? 2 : 1;  // warpgroups
  static constexpr int THREADS = 128 * QW;
  static constexpr uint32_t TILE = NK * D * 2;  // one NK x D bf16 tile
  static constexpr uint32_t raw_off = 0;                     // q, k, v raw, row-major
  static constexpr uint32_t q_off = align1k(raw_off + 3 * TILE);  // Qs, rows NK, atoms of D
  static constexpr uint32_t k_off = q_off + align1k(TILE);       // Kn, rows NK, atoms of D
  static constexpr uint32_t vt_off = k_off + align1k(TILE);      // V^T, rows D, atoms of 64
  static constexpr uint32_t o_off = vt_off + align1k(TILE);      // QW x 64 x D bf16
  static constexpr uint32_t bytes = o_off + QW * 64 * D * 2;
};

template <int NK, int D>
__device__ __forceinline__ void prefetch(const QKV& in, unsigned char* raw, long long pair,
                                         int T, int heads) {
  using P = Plan<NK, D>;
  constexpr int LPR = D / 8;
  const long long n = pair / heads;
  const int h = (int)(pair % heads);
  const uint32_t base = smem_addr(raw);
  for (int i = threadIdx.x; i < 3 * NK * LPR; i += P::THREADS) {
    const int which = i / (NK * LPR), r = (i / LPR) % NK, part = i % LPR;
    const bf16* src = which == 0 ? in.q : which == 1 ? in.k : in.v;
    const bool valid = r < T;
    const bf16* g = src + (n * T + (valid ? r : 0)) * in.ld + (long long)h * D + part * 8;
    cp_async16(base + which * P::TILE + (uint32_t)(r * D + part * 8) * 2, g, valid);
  }
  cp_async_commit();
}

// qb (C,) is added to q where it is not null.
template <int NK, int D>
__global__ void __launch_bounds__(Plan<NK, D>::THREADS, 1)
window_attention_fwd_kernel(QKV in, const float* __restrict__ qb,
                            const float* __restrict__ bm, const float* __restrict__ scale,
                            bf16* __restrict__ out, long long pairs, int T, int heads, int nw) {
  using P = Plan<NK, D>;
  constexpr int LPR = D / 8;  // lanes per head row, 16 B each
  constexpr int NC = NK / 64; // 64-key chunks of S
  extern __shared__ __align__(1024) unsigned char smem[];
  const bf16* rq = reinterpret_cast<const bf16*>(smem + P::raw_off);
  const bf16* rk = rq + NK * D;
  const bf16* rv = rk + NK * D;
  unsigned char* sq = smem + P::q_off;
  unsigned char* sk = smem + P::k_off;
  unsigned char* svt = smem + P::vt_off;
  const uint32_t aq = smem_addr(sq), ak = smem_addr(sk), avt = smem_addr(svt);

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int C = heads * D;

  long long pair = blockIdx.x;
  if (pair < pairs) prefetch<NK, D>(in, smem + P::raw_off, pair, T, heads);
  for (; pair < pairs; pair += gridDim.x) {
    const long long n = pair / heads;
    const int h = (int)(pair % heads);
    const float sc = scale[h];
    cp_async_wait_all();
    __syncthreads();  // raw tiles landed; the previous pair is done with the staged ones

    // Stage: Qs = bf16(scale normalise(bf16(q + bf16(qb)))), Kn = bf16(normalise(k)), V^T.
    for (int i = tid; i < NK * LPR; i += P::THREADS) {
      const int r = i / LPR, part = i % LPR;
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(rq + r * D + part * 8), f);
      if (qb != nullptr) {
        float qb8[8];
        load8(qb + h * D + part * 8, qb8);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = round_bf16(f[e] + round_bf16(qb8[e]));
      }
      float ssq = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
      float nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = (f[e] / nrm) * sc;
      *reinterpret_cast<uint4*>(sq + tile_off<D>(r, part * 8, NK)) = pack8(f);

      unpack8(*reinterpret_cast<const uint4*>(rk + r * D + part * 8), f);
      ssq = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
      nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f[e] / nrm;
      *reinterpret_cast<uint4*>(sk + tile_off<D>(r, part * 8, NK)) = pack8(f);

      const uint4 vraw = *reinterpret_cast<const uint4*>(rv + r * D + part * 8);
      const bf16* vb = reinterpret_cast<const bf16*>(&vraw);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        *reinterpret_cast<bf16*>(svt + tile_off<64>(part * 8 + e, r, D)) = vb[e];
    }
    fence_async_smem();
    __syncthreads();
    if (pair + gridDim.x < pairs)  // the next pair's rows load while this one computes
      prefetch<NK, D>(in, smem + P::raw_off, pair + gridDim.x, T, heads);

    const float* bmh = bm + ((long long)(n % nw) * heads + h) * T * T;
    bf16* so = reinterpret_cast<bf16*>(smem + P::o_off) + wg * 64 * D;
    for (int s = wg; s < NC; s += P::QW) {
      const int q0 = 64 * s;
      if (q0 >= T) break;
      // S starts from bm (keys past T at -inf, rows past T at 0): the loads
      // land in the accumulator registers themselves, all in flight at once.
      const int r0 = q0 + 16 * warp + lane / 4;
      float S[NK / 2];
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        const int row = r0 + 8 * ((i % 4) / 2);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        S[i] = col >= T ? -INFINITY : row < T ? __ldg(bmh + (long long)row * T + col) : 0.f;
      }
      // S += Qs Kn^T.
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Mma<64>::ss(S + 32 * c, desc<D>(aq, q0, 16 * kk, NK), desc<D>(ak, 64 * c, 16 * kk, NK),
                      1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NK / 2>(S);

      // Row max and sum over the quad.
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) m[(i % 4) / 2] = fmaxf(m[(i % 4) / 2], S[i]);
      float den[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 1));
        m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 2));
      }
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) {
        S[i] = __expf(S[i] - m[(i % 4) / 2]);
        den[(i % 4) / 2] += S[i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        den[j] += __shfl_xor_sync(0xffffffffu, den[j], 1);
        den[j] += __shfl_xor_sync(0xffffffffu, den[j], 2);
      }

      // O = bf16(e) V with P in registers, 64 keys a group: the bf16 P of
      // two chunks, not of the whole strip, is live beside S, and chunk c+1
      // is packed while chunk c's wgmmas run.
      float O[D / 2];
      uint32_t a[2][4][4];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_frag(S, 4 * c + kk, a[c % 2][kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<D>::rs(O, a[c % 2][kk], desc<64>(avt, 0, 64 * c + 16 * kk, D), c > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait_all();
      fence_regs<D / 2>(O);

      // O / sum through the staging tile, out in 16-byte rows.
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int row = 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
        const int col = 8 * (i / 4) + 2 * (lane % 4);
        const float inv = 1.f / den[(i % 4) / 2];
        *reinterpret_cast<uint32_t*>(so + row * D + col) = pack2(O[i] * inv, O[i + 1] * inv);
      }
      bar_sync(1 + wg, 128);
      for (int i = wt; i < 64 * LPR; i += 128) {
        const int r = i / LPR, part = i % LPR;
        if (q0 + r < T)
          *reinterpret_cast<uint4*>(out + (n * T + q0 + r) * C + (long long)h * D + part * 8) =
              *reinterpret_cast<const uint4*>(so + r * D + part * 8);
      }
      bar_sync(1 + wg, 128);
    }
  }
}

template <int NK, int D>
cudaError_t launch(QKV in, const float* qb, const float* bm, const float* scale, bf16* out,
                   int n_win, int t, int heads, int nw, cudaStream_t stream) {
  using P = Plan<NK, D>;
  auto kernel = window_attention_fwd_kernel<NK, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P::THREADS,
                                                           P::bytes)) != cudaSuccess)
    return err;
  const long long pairs = (long long)n_win * heads;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(pairs < slots ? pairs : slots);
  kernel<<<grid, P::THREADS, P::bytes, stream>>>(in, qb, bm, scale, out, pairs, t, heads, nw);
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

cudaError_t run(QKV in, const float* qb, const float* bm, const float* scale, bf16* out,
                int n_win, int t, int heads, int d, int nw, cudaStream_t st) {
  if (n_win <= 0 || heads <= 0 || nw <= 0 || n_win % nw) return cudaErrorInvalidValue;
  return dispatch(t, d, [&](auto s) {
    using S = decltype(s);
    return launch<S::NK, S::D>(in, qb, bm, scale, out, n_win, t, heads, nw, st);
  });
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

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// the instantiation that takes window size t and head width d.
extern "C" int window_attention_fwd_info(int t, int d, int* out) {
  return (int)dispatch(t, d, [&](auto s) {
    using S = decltype(s);
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, window_attention_fwd_kernel<S::NK, S::D>);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)Plan<S::NK, S::D>::bytes;
    return err;
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
