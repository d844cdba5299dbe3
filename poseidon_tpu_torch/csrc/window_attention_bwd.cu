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
// three base pointers with one row stride, do read as (N, T, C), dq/dk/dv
// written as q/k/v were read. T is any window size up to 256 (padded to NK =
// 64, 128 or 256 and masked), D is 16, 32 or 64.
//
// Bound on this card. Per pair the kernel reads 4*T*D bf16 and writes 3*T*D,
// and does 10*T*T*D FLOPs in five products (S recomputed once): at T = 256,
// D = 32 about 360 FLOPs per byte, near the H100's ridge, and far below it
// at smaller T; dbm (nW*H*T*T fp32) is written once per call. What the
// design must avoid is the plain version's N*H*T*T fp32 tensors in device
// memory, and a second recomputation of S.
//
// Design. A cluster of CS = NK/64 CTAs takes one head and bias slot and
// walks the windows of one window group that share them. CTA r owns keys
// [64r, 64r + 64) and stages query strip r. Per window:
//  - every pair's q, k, v and do are read and normalised once: CTA r stages
//    its own keys (Kn, V, Kn^T) and writes its query strip (Qs and do, in the
//    swizzled K-major layout wgmma reads) into every CTA of the cluster
//    through distributed shared memory;
//  - the 64-query strips, two at once where D <= 32 and T > 64 (one per
//    warpgroup): S^T = bm^T + Kn Qs^T and dP^T = V dO^T (m64n64k16, A and B
//    from shared memory, S^T's accumulators starting from the bias) land in
//    registers: S once per (query strip, key strip). The strip's column
//    max, then sum(e) and sum(dp e), are reduced over the CTA's keys with
//    shuffles and shared memory, then over the cluster through distributed
//    shared memory in rank order: no statistics tensor in device memory;
//  - ds stays in registers: bf16(e)^T and bf16(ds)^T are the register A
//    operands of dV += e^T (do/den) and dKn += ds^T Qs, accumulated in
//    registers over the strips (the two warpgroups' sums added in a fixed
//    order at the window's end); bf16(ds) goes to shared memory as the A of
//    this CTA's dQs partial, ds Kn, over its own keys;
//  - after the next strip's first cluster barrier, every CTA takes 64/CS
//    rows of the strip: the CS dQs partials summed in rank order through
//    distributed shared memory, dscale, the normalisation's backward, dq
//    out, and its dqb sum;
//  - ds is added to this CTA's (64 keys x T) dbm sum in shared memory.
// After the walk each CTA writes its keys' slice of one dbm partial per
// window group, and one dqb | dscale partial; a reduce kernel sums the
// partials of every group in a fixed order. No atomics, so two calls give
// the same bits. The groups are few (the wrapper's bwd_groups keeps the dbm
// partials within 8 MiB: at ScOT-B stage 0 G = 10 and 7.9 MB, 15.7 MB of
// traffic written and read), so a cluster walks ~13 windows in series: the
// kernel is bound by that chain's latency (two cluster barriers and a bias
// read from L2 per strip pair, two more barriers per window), not by bytes
// or tensor-core operations.

#include "wgmma.cuh"

using namespace wgm;

namespace {

constexpr float EPS = 1e-12f;  // torch F.normalize clamp

// q, k, v (which = 0, 1, 2) of token (n, t) and head h at in[which] +
// (n T + t) ld + h D, and their gradients at the same offsets from din.
struct QKVIo {
  const bf16* in[3];
  bf16* din[3];
  long long ld;
};

template <int NK, int D>
struct Plan {
  static constexpr int CS = NK / 64;            // CTAs per cluster
  static constexpr int WG = (NK >= 128 && D <= 32) ? 2 : 1;  // warpgroups, strips in parallel
  static constexpr int THREADS = 128 * WG;
  static constexpr int SDB = NK + 8;            // row stride of the dbm sum (floats)
  static constexpr uint32_t QT = NK * D * 2;    // all query rows, bf16
  static constexpr uint32_t ST = 64 * D * 2;    // 64 rows, bf16
  // Shared by the CTA (Qs and dO written by every CTA of the cluster).
  static constexpr uint32_t qs_off = 0;                          // Qs, rows NK, atoms of D
  static constexpr uint32_t do_off = qs_off + align1k(QT);       // dO, rows NK, atoms of D
  static constexpr uint32_t kn_off = do_off + align1k(QT);       // Kn, 64 rows, atoms of D
  static constexpr uint32_t v_off = kn_off + align1k(ST);        // V, 64 rows, atoms of D
  static constexpr uint32_t knt_off = v_off + align1k(ST);       // Kn^T, rows D, atoms of 64
  // One of each per warpgroup.
  static constexpr uint32_t qst_off = knt_off + align1k(ST);     // Qs^T strip, rows D, atoms of 64
  static constexpr uint32_t dodt_off = qst_off + WG * align1k(ST);   // (dO/den)^T strip
  static constexpr uint32_t ds_off = dodt_off + WG * align1k(ST);    // bf16(ds), 64 q x 64 keys
  static constexpr uint32_t dq_off = ds_off + WG * 8192;         // dQs partial, 64 x D f32
  static constexpr uint32_t red_off = dq_off + WG * 64 * D * 4;  // 3 x 4 warps x 64 f32
  static constexpr uint32_t xch_off = red_off + WG * 3 * 4 * 64 * 4;  // 3 x CS x 64 f32
  // The CTA's again (the warpgroups' dk, dv sums at a window's end use the
  // bf16(ds) tiles' room).
  static constexpr uint32_t dkv_off = ds_off;                    // (WG-1) x 2 x 64 x D f32
  static_assert((WG - 1) * 2 * 64 * D * 4 <= WG * 8192, "dk, dv sums fit the ds tiles");
  static constexpr uint32_t dbm_off = xch_off + WG * 3 * CS * 64 * 4;  // 64 x SDB f32
  static constexpr uint32_t fin_off = dbm_off + 64 * SDB * 4;    // THREADS x (VPT + 1) f32
  // The dq epilogue of a strip: each CTA takes RPC of its 64 rows, TPR
  // threads a row, VPT values a thread.
  static constexpr int RPC = 64 / CS, TPR = 128 / RPC, VPT = D / TPR;
  static constexpr uint32_t bytes = fin_off + THREADS * (VPT + 1) * 4;
  static_assert(bytes <= 232448, "one CTA's shared memory");
};

template <int NK, int D>
__global__ void __launch_bounds__(Plan<NK, D>::THREADS, 1)
attn_bwd_kernel(QKVIo io, const float* __restrict__ qb, const float* __restrict__ bm,
                const float* __restrict__ scale, const bf16* __restrict__ dout,
                float* __restrict__ part_bm, float* __restrict__ part_q, int n_win, int T,
                int heads, int nw, int groups) {
  using P = Plan<NK, D>;
  constexpr int CS = P::CS, WG = P::WG;
  constexpr int LPR = D / 8;   // 16-byte chunks per head row
  constexpr int TPR = P::TPR, VPT = P::VPT;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  unsigned char* sqs = smem + P::qs_off;
  unsigned char* sdo = smem + P::do_off;
  unsigned char* skn = smem + P::kn_off;
  unsigned char* sv = smem + P::v_off;
  unsigned char* sknt = smem + P::knt_off;
  unsigned char* sqst = smem + P::qst_off + wg * align1k(P::ST);
  unsigned char* sdodt = smem + P::dodt_off + wg * align1k(P::ST);
  unsigned char* sds = smem + P::ds_off + wg * 8192;
  float* sdq = reinterpret_cast<float*>(smem + P::dq_off) + wg * 64 * D;
  float* red = reinterpret_cast<float*>(smem + P::red_off) + wg * 3 * 4 * 64;
  float* xch = reinterpret_cast<float*>(smem + P::xch_off) + wg * 3 * CS * 64;
  float* dkv = reinterpret_cast<float*>(smem + P::dkv_off);
  float* sdbm = reinterpret_cast<float*>(smem + P::dbm_off);
  float* fin = reinterpret_cast<float*>(smem + P::fin_off);
  const uint32_t a_qs = smem_addr(sqs), a_do = smem_addr(sdo), a_qst = smem_addr(sqst),
                 a_dodt = smem_addr(sdodt), a_kn = smem_addr(skn), a_v = smem_addr(sv),
                 a_knt = smem_addr(sknt), a_ds = smem_addr(sds), a_dq = smem_addr(sdq),
                 a_xch = smem_addr(xch);

  const int rank = CS > 1 ? (int)cluster_rank() : 0;
  const int base = nw * heads;
  const int unit = blockIdx.x / CS;
  const int bh = unit % base, grp = unit / base;
  const int slot = bh / heads, h = bh % heads;
  const long long per_slot = n_win / nw;
  const int j0 = (int)(grp * per_slot / groups), j1 = (int)((grp + 1) * per_slot / groups);
  const float sc = scale[h];
  const int C = heads * D;
  const int key0 = 64 * rank;               // this CTA's keys and query strip
  const float* bmh = bm + (long long)bh * T * T;
  const int strips = (T + 63) / 64;
  const int kl0 = 16 * warp + lane / 4;     // this thread's first key row in the S^T layout
  // Column c of a thread in the S^T layout (values i and i + 2) is query
  // col_of(c) of the strip; lanes 0-3 hold every column of the warp after
  // shuffles over lanes with the same lane % 4.
  auto col_of = [&](int c) { return 8 * (c / 2) + 2 * (lane % 4) + (c % 2); };

  for (int i = tid; i < 64 * P::SDB; i += P::THREADS) sdbm[i] = 0.f;
  // This thread's dqb (VPT values) and dscale sums over its epilogue rows.
  float* acc_q = fin + tid * (VPT + 1);
  for (int e = 0; e <= VPT; ++e) acc_q[e] = 0.f;
  cluster_sync();  // every CTA of the cluster runs before any writes to a peer

  for (int j = j0; j < j1; ++j) {
    const long long n = slot + (long long)nw * j;
    auto tok = [&](int t) { return n * T + t; };
    __syncthreads();  // the last window's epilogue is done with dkv

    // The dq epilogue of strip sp (of this warpgroup): the cluster's dQs
    // partials summed in rank order, then dscale, the normalisation's
    // backward, dq out and the dqb sum. Each CTA takes RPC of the rows.
    auto dq_epilogue = [&](int sp) {
      const int rr = rank * P::RPC + wt / TPR, part = wt % TPR, q = 64 * sp + rr;
      const int col0 = part * VPT;
      float dqs[VPT], qf[VPT];
#pragma unroll
      for (int e = 0; e < VPT; ++e) dqs[e] = 0.f;
#pragma unroll
      for (int p = 0; p < CS; ++p) {
#pragma unroll
        for (int e = 0; e < VPT; ++e)
          dqs[e] += ld_cluster_f32(peer_addr(a_dq + (rr * D + col0 + e) * 4, p));
      }
      float ssq = 0.f;
#pragma unroll
      for (int e = 0; e < VPT; ++e) {
        qf[e] = 0.f;
        if (q < T) {
          qf[e] = __bfloat162float(io.in[0][tok(q) * io.ld + (long long)h * D + col0 + e]);
          if (qb != nullptr) qf[e] = round_bf16(qf[e] + round_bf16(qb[h * D + col0 + e]));
        }
        ssq += qf[e] * qf[e];
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) ssq += __shfl_xor_sync(0xffffffffu, ssq, o);
      const float nrm = fmaxf(sqrtf(ssq), EPS);
      float dsr = 0.f, dot = 0.f;
#pragma unroll
      for (int e = 0; e < VPT; ++e) {
        qf[e] = qf[e] / nrm;  // qn
        dsr += dqs[e] * qf[e];
        dqs[e] = dqs[e] * sc;  // dqn
        dot += dqs[e] * qf[e];
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) {
        dsr += __shfl_xor_sync(0xffffffffu, dsr, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (q < T) {
        if (part == 0) acc_q[VPT] += dsr;
        bf16* dst = io.din[0] + tok(q) * io.ld + (long long)h * D + col0;
#pragma unroll
        for (int e = 0; e < VPT; e += 2) {
          const float o0 = round_bf16((dqs[e] - qf[e] * dot) / nrm);
          const float o1 = round_bf16((dqs[e + 1] - qf[e + 1] * dot) / nrm);
          acc_q[e] += o0;
          acc_q[e + 1] += o1;
          *reinterpret_cast<uint32_t*>(dst + e) = pack2(o0, o1);
        }
      }
    };

    // Stage: own keys (Kn, V, Kn^T) and, into every CTA of the cluster, own
    // query strip (Qs, dO); the raw q strip (with the rounded q-bias) stays.
    for (int i = tid; i < 64 * LPR; i += P::THREADS) {
      const int r = i / LPR, part = i % LPR, t = key0 + r;
      const bool valid = t < T;
      float f[8];
      uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw, qraw = kraw, draw = kraw;
      if (valid) {
        const long long off = tok(t) * io.ld + (long long)h * D + part * 8;
        kraw = *reinterpret_cast<const uint4*>(io.in[1] + off);
        vraw = *reinterpret_cast<const uint4*>(io.in[2] + off);
        qraw = *reinterpret_cast<const uint4*>(io.in[0] + off);
        draw = *reinterpret_cast<const uint4*>(dout + tok(t) * C + (long long)h * D + part * 8);
      }
      *reinterpret_cast<uint4*>(sv + tile_off<D>(r, part * 8, 64)) = vraw;
      unpack8(kraw, f);
      float ssq = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
      float nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = f[e] / nrm;
      const uint4 kn = pack8(f);
      *reinterpret_cast<uint4*>(skn + tile_off<D>(r, part * 8, 64)) = kn;
      const bf16* knb = reinterpret_cast<const bf16*>(&kn);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        *reinterpret_cast<bf16*>(sknt + tile_off<64>(part * 8 + e, r, D)) = knb[e];

      unpack8(qraw, f);
      if (qb != nullptr && valid) {
        float qb8[8];
        load8(qb + h * D + part * 8, qb8);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = round_bf16(f[e] + round_bf16(qb8[e]));
      }
      ssq = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) ssq += f[e] * f[e];
      nrm = fmaxf(sqrtf(group_sum<LPR>(ssq)), EPS);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = (f[e] / nrm) * sc;
      const uint4 qs = pack8(f);
      const uint32_t o = tile_off<D>(t, part * 8, NK);
#pragma unroll
      for (int p = 0; p < CS; ++p) {
        st_cluster_v4(peer_addr(a_qs + o, p), qs);
        st_cluster_v4(peer_addr(a_do + o, p), draw);
      }
    }
    fence_async_all();
    cluster_sync();
    fence_async_all();

    // The strips, WG at a time (warpgroup wg takes strip s0 + wg). Every
    // thread passes every barrier; a warpgroup without a strip only waits.
    float dK[D / 2], dV[D / 2];
    for (int s0 = 0; s0 < strips; s0 += WG) {
      const int s = s0 + wg, q0 = 64 * s;
      const bool act = s < strips;
      float S[32], Pd[32];
      if (act) {
        // S^T = bm^T + Kn Qs^T and dP^T = V dO^T: 64 keys x 64 queries each.
        // S^T starts from bm^T (keys past T at -inf, queries past T at 0):
        // the loads land in the accumulator registers, all in flight at once.
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = key0 + kl0 + 8 * ((i % 4) / 2);
          const int q = q0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          S[i] = key >= T ? -INFINITY : q < T ? __ldg(bmh + (long long)q * T + key) : 0.f;
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
      if (act && wt < 64) {  // ... over the CTA's keys, to every CTA of the cluster
        float v = red[wt];
#pragma unroll
        for (int w = 1; w < 4; ++w) v = fmaxf(v, red[w * 64 + wt]);
#pragma unroll
        for (int p = 0; p < CS; ++p) st_cluster_f32(peer_addr(a_xch + (rank * 64 + wt) * 4, p), v);
      }
      cluster_sync();
      // The previous strips' dq, while their partials stay untouched.
      if (s0 > 0 && s - WG < strips) dq_epilogue(s - WG);

      // e, and the columns' sum(e) and sum(dp e) over the cluster's keys.
      float* red_s = red + 4 * 64;
      float* red_d = red + 8 * 64;
      if (act) {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int i = 4 * (c / 2) + (c % 2), col = col_of(c);
          float m = xch[col];
#pragma unroll
          for (int p = 1; p < CS; ++p) m = fmaxf(m, xch[p * 64 + col]);
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
      const float* xs = xch + CS * 64;
      const float* xd = xch + 2 * CS * 64;

      if (act) {
        // ds = e (dp - c) / den in place of dp, c = sum(dp e) / den;
        // queries past T give nothing.
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int i = 4 * (c / 2) + (c % 2), col = col_of(c);
          float den = xs[col], cc = xd[col];
#pragma unroll
          for (int p = 1; p < CS; ++p) {
            den += xs[p * 64 + col];
            cc += xd[p * 64 + col];
          }
          cc = cc / den;
          const bool qv = q0 + col < T;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = i + 2 * u;
            Pd[k] = qv ? S[k] * ((Pd[k] - cc) / den) : 0.f;
            if (!qv) S[k] = 0.f;
          }
        }
        // dbm sum (this thread's elements, in window order), bf16(ds) as
        // dQ's A operand, and the strip's Qs^T and (dO/den)^T tiles.
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int kl = kl0 + 8 * ((i % 4) / 2);
          const int ql = 8 * (i / 4) + 2 * (lane % 4);
          float2* cell = reinterpret_cast<float2*>(sdbm + kl * P::SDB + q0 + ql);
          float2 acc = *cell;
          acc.x += Pd[i];
          acc.y += Pd[i + 1];
          *cell = acc;
          *reinterpret_cast<bf16*>(sds + tile_off<64>(ql, kl, 64)) = __float2bfloat16(Pd[i]);
          *reinterpret_cast<bf16*>(sds + tile_off<64>(ql + 1, kl, 64)) =
              __float2bfloat16(Pd[i + 1]);
        }
        for (int i = wt; i < 64 * LPR; i += 128) {
          const int r = i / LPR, part = i % LPR;
          float den = xs[r];
#pragma unroll
          for (int p = 1; p < CS; ++p) den += xs[p * 64 + r];
          const uint32_t o = tile_off<D>(q0 + r, part * 8, NK);
          const uint4 qs = *reinterpret_cast<const uint4*>(sqs + o);
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(sdo + o), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = f[e] / den;
          const uint4 dd = pack8(f);
          const bf16* qsb = reinterpret_cast<const bf16*>(&qs);
          const bf16* ddb = reinterpret_cast<const bf16*>(&dd);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const uint32_t ot = tile_off<64>(part * 8 + e, r, D);
            *reinterpret_cast<bf16*>(sqst + ot) = qsb[e];
            *reinterpret_cast<bf16*>(sdodt + ot) = ddb[e];
          }
        }
        fence_async_smem();
        bar_sync(1 + wg, 128);

        // dV += bf16(e)^T (dO/den), dKn += bf16(ds)^T Qs (register A), and
        // this CTA's dQs partial bf16(ds) Kn over its keys.
        float dq[D / 2];
        {
          uint32_t ea[4][4], da[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            a_frag(S, kk, ea[kk]);
            a_frag(Pd, kk, da[kk]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Mma<D>::rs(dV, ea[kk], desc<64>(a_dodt, 0, 16 * kk, D), s0 > 0 || kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Mma<D>::rs(dK, da[kk], desc<64>(a_qst, 0, 16 * kk, D), s0 > 0 || kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Mma<D>::ss(dq, desc<64>(a_ds, 0, 16 * kk, 64), desc<64>(a_knt, 0, 16 * kk, D), kk > 0);
          wgmma_commit();
          wgmma_wait_all();
        }
        fence_regs<D / 2>(dV);
        fence_regs<D / 2>(dK);
        fence_regs<D / 2>(dq);
#pragma unroll
        for (int i = 0; i < D / 2; i += 2) {
          const int row = 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
          const int col = 8 * (i / 4) + 2 * (lane % 4);
          *reinterpret_cast<float2*>(sdq + row * D + col) = make_float2(dq[i], dq[i + 1]);
        }
      }
    }
    cluster_sync();  // the last strips' partials are complete
    {
      const int s_last = (strips - 1) / WG * WG + wg;
      if (s_last < strips) dq_epilogue(s_last);
    }

    // The warpgroups' dk and dv sums added in a fixed order (wg 0 + wg 1).
    if (WG > 1) {
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          dkv[i * 128 + wt] = dK[i];
          dkv[(D / 2 + i) * 128 + wt] = dV[i];
        }
      }
      __syncthreads();
      if (wg == 1) continue;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dK[i] += dkv[i * 128 + wt];
        dV[i] += dkv[(D / 2 + i) * 128 + wt];
      }
    }

    // dv and dk of this CTA's keys (dk through the normalisation).
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int key = key0 + kl0 + 8 * hrow;
      const bool valid = key < T;
      float kf[D / 4], ssq = 0.f;
#pragma unroll
      for (int b = 0; b < D / 8; ++b) {
        const int col = 8 * b + 2 * (lane % 4);
        float2 kv = make_float2(0.f, 0.f);
        if (valid)
          kv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              io.in[1] + tok(key) * io.ld + (long long)h * D + col));
        kf[2 * b] = kv.x;
        kf[2 * b + 1] = kv.y;
        ssq += kv.x * kv.x + kv.y * kv.y;
      }
      ssq += __shfl_xor_sync(0xffffffffu, ssq, 1);
      ssq += __shfl_xor_sync(0xffffffffu, ssq, 2);
      const float nrm = fmaxf(sqrtf(ssq), EPS);
      float dot = 0.f;
#pragma unroll
      for (int b = 0; b < D / 8; ++b) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          kf[2 * b + u] = kf[2 * b + u] / nrm;
          dot += dK[4 * b + 2 * hrow + u] * kf[2 * b + u];
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (valid) {
        const long long off = tok(key) * io.ld + (long long)h * D;
#pragma unroll
        for (int b = 0; b < D / 8; ++b) {
          const int col = 8 * b + 2 * (lane % 4), i = 4 * b + 2 * hrow;
          *reinterpret_cast<uint32_t*>(io.din[2] + off + col) = pack2(dV[i], dV[i + 1]);
          *reinterpret_cast<uint32_t*>(io.din[1] + off + col) =
              pack2((dK[i] - kf[2 * b] * dot) / nrm, (dK[i + 1] - kf[2 * b + 1] * dot) / nrm);
        }
      }
    }
  }

  // No CTA leaves while a peer may still read its dQs partial. Then this
  // CTA's keys of the group's dbm partial, and its dqb | dscale partial:
  // the owner threads' sums in a fixed order.
  cluster_sync();
  float* dst = part_bm + ((long long)grp * base + bh) * T * T;
  for (int i = tid; i < 64 * T; i += P::THREADS) {
    const int kl = i % 64, q = i / 64;
    if (key0 + kl < T) dst[(long long)q * T + key0 + kl] = sdbm[kl * P::SDB + q];
  }
  __syncthreads();
  float* pq = part_q + ((long long)(grp * CS + rank) * base + bh) * (D + 1);
  for (int i = tid; i <= D; i += P::THREADS) {
    const int part = i < D ? i / VPT : 0, e = i < D ? i % VPT : VPT;
    float s = 0.f;
    for (int th = part; th < P::THREADS; th += TPR) s += fin[th * (VPT + 1) + e];
    pq[i] = s;
  }
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
  if (n_win <= 0 || heads <= 0 || nw <= 0 || n_win % nw || groups <= 0 ||
      groups > n_win / nw)
    return cudaErrorInvalidValue;
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

// Registers, local-memory (spill) bytes and dynamic shared-memory bytes of
// the instantiation that takes window size t and head width d.
extern "C" int window_attention_bwd_info(int t, int d, int* out) {
  return (int)dispatch(t, d, [&](auto s) {
    using S = decltype(s);
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, attn_bwd_kernel<S::NK, S::D>);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)Plan<S::NK, S::D>::bytes;
    return err;
  });
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
