// Fused block tail backward for Hopper (sm_90a), plain C interface: the
// backward of mlp_cln.cu's MLP + conditional LayerNorm + residual.
//
//   o, mu, r as the forward;  yhat = (o - mu) r;  dyh = dy * scale[b]
//   do      = r (dyh - mean_C dyh - yhat mean_C(dyh yhat))                 (fp32)
//   dscale[b] = sum over the image's rows of dy yhat;  dshift[b] = sum of dy (fp32 dy)
//   db2     = sum of do (fp32);  dW2, dW1, db1 and dx_mlp from bf16(do) as the
//             MLP backward's dy;  dx = bf16(dy + dx_mlp), rounded once
//
// Replaces the TPU kernel poseidon_tpu/ops/mlp.py::_bwd_kernel_dm_cln
// (pallas_call in _call_bwd_dm_cln), with its rounding points. The Python
// wrapper and the plain PyTorch version are in ops/mlp.py.
//
// Bound on this card. Per row the backward reads x and dy and writes dx (6C
// bytes) and does 12*C*F FLOPs (o recomputed, then u, dh, dx, dW1, dW2):
// bound by tensor-core operations, as the MLP backward is.
//
// Design. The LayerNorm's backward needs all C outputs of a row, and those
// need every step of F, while the MLP backward's dW CTAs see one step of F
// and cannot get them. So three launches, in stream order:
//  1. a prologue, per 64-row tile: the forward's main loop (mlp_tile.cuh)
//     recomputes o into shared memory; then, by rows as the forward's
//     epilogue, the row statistics, yhat and do. It writes bf16(do) (M, C)
//     and one fp32 partial per tile of db2, dscale and dshift (a tile lies in
//     one image: the wrapper checks L % 64 == 0).
//  2. the MLP backward of mlp_bwd.cuh with dy := bf16(do) and the residual dy
//     added to its fp32 dx sum before the rounding. It also sums bf16(do) for
//     its db2, which the wrapper leaves unused: db2 is the fp32 sum of do.
//  3. a reduce of the prologue's partials in a fixed order: db2 over all
//     tiles, dscale and dshift over the tiles of each image.
// No atomics, so two calls give the same bits. The LayerNorm's backward stays
// out of the MLP backward's dx CTAs, which already hold 255 registers.

#include "mlp_tile.cuh"
#include "mlp_bwd.cuh"

using namespace mlp_fwd_tile;

namespace {

template <int C>
__global__ void __launch_bounds__(THREADS)
mlp_cln_bwd_prologue_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                            const float* __restrict__ b1, const bf16* __restrict__ w2,
                            const float* __restrict__ b2, const float* __restrict__ scale,
                            const bf16* __restrict__ dy, bf16* __restrict__ dob,
                            float* __restrict__ part, int M, int F, int L, float eps) {
  constexpr int V = C / 32;  // columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * MT;
  tile_sum<C>(x, w1, b1, w2, smem, m0, M, F);
  float* so = reinterpret_cast<float*>(smem + Plan<C>::o_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* sc = scale + (m0 / L) * C;
  float pdb2[V], pds[V], pdsh[V];  // this lane's columns, summed over the warp's rows
#pragma unroll
  for (int i = 0; i < V; ++i) pdb2[i] = pds[i] = pdsh[i] = 0.f;

  for (int r = warp; r < MT; r += WARPS) {  // M % MT == 0: every row exists
    const long long row = m0 + r;
    float o[V], dyf[V], dyh[V];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      o[i] = round_bf16(so[r * C + c] + b2[c]);
      s1 += o[i];
      s2 += o[i] * o[i];
    }
    const float mu = warp_sum(s1) / C;
    const float var = fmaxf(warp_sum(s2) / C - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      o[i] = (o[i] - mu) * rs;  // yhat
      dyf[i] = __bfloat162float(dy[row * C + c]);
      dyh[i] = dyf[i] * sc[c];
      m1 += dyh[i];
      m2 += dyh[i] * o[i];
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      const float d = rs * (dyh[i] - m1 - o[i] * m2);
      dob[row * C + c] = __float2bfloat16(d);
      pdb2[i] += d;
      pds[i] += dyf[i] * o[i];
      pdsh[i] += dyf[i];
    }
  }
  __syncthreads();  // every warp is done reading the staged sum

  // The tile's partial (db2 | dscale | dshift): the warps' sums in a fixed order.
  float* red = so;  // WARPS x 3 x C fp32, over the staged sum
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    red[(warp * 3 + 0) * C + c] = pdb2[i];
    red[(warp * 3 + 1) * C + c] = pds[i];
    red[(warp * 3 + 2) * C + c] = pdsh[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * C; j += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * 3 * C + j];
    part[(long long)blockIdx.x * 3 * C + j] = s;
  }
}

// out = db2 (C) | dscale (B, C) | dshift (B, C) from the tiles' partials.
__global__ void mlp_cln_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      int tiles, int C, int B, int tiles_per_image) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (i < C) {
    for (int t = 0; t < tiles; ++t) s += part[(long long)t * 3 * C + i];
    out[i] = s;
    return;
  }
  const long long j = i - C, per = (long long)B * C;
  if (j >= 2 * per) return;
  const int which = 1 + (int)(j / per);  // 1: dscale, 2: dshift
  const int b = (int)((j % per) / C), c = (int)(j % C);
  for (int t = b * tiles_per_image; t < (b + 1) * tiles_per_image; ++t)
    s += part[((long long)t * 3 + which) * C + c];
  out[i] = s;
}

template <int C>
cudaError_t prologue(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                     const float* b2, const float* scale, const bf16* dy, bf16* dob, float* part,
                     int M, int F, int L, float eps, cudaStream_t stream) {
  using P = Plan<C>;
  auto kernel = mlp_cln_bwd_prologue_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(M / MT), THREADS, P::bytes, stream>>>(x, w1, b1, w2, b2, scale, dy, dob,
                                                            part, M, F, L, eps);
  return cudaGetLastError();
}

}  // namespace

// grads (2FC + F + C) and part (R, 2FC + F + C) as mlp_bwd.cu's; cpart
// (M / 64, 3, C) the prologue's partials; cout = db2 | dscale | dshift.
extern "C" int mlp_cln_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* scale, const void* dy, void* dob,
                           void* dx, void* grads, void* part, void* cpart, void* cout,
                           int M, int C, int F, int L, int R, float eps, void* stream) {
  if (M <= 0 || F <= 0 || F % FT || L <= 0 || L % MT || M % L) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  const float* b2p = static_cast<const float*>(b2);
  const float* sp = static_cast<const float*>(scale);
  const bf16* dyp = static_cast<const bf16*>(dy);
  bf16* dobp = static_cast<bf16*>(dob);
  float* cp = static_cast<float*>(cpart);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 96: err = prologue<96>(xp, w1p, b1p, w2p, b2p, sp, dyp, dobp, cp, M, F, L, eps, st); break;
    case 192: err = prologue<192>(xp, w1p, b1p, w2p, b2p, sp, dyp, dobp, cp, M, F, L, eps, st); break;
    case 384: err = prologue<384>(xp, w1p, b1p, w2p, b2p, sp, dyp, dobp, cp, M, F, L, eps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  err = mlp_bwd_tile::run(xp, w1p, b1p, w2p, dobp, dyp, static_cast<bf16*>(dx),
                          static_cast<float*>(grads), static_cast<float*>(part), M, C, F, R, st);
  if (err != cudaSuccess) return (int)err;
  const int tiles = M / MT, batch = M / L;
  const long long n = (long long)C * (1 + 2 * batch);
  mlp_cln_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      cp, static_cast<float*>(cout), tiles, C, batch, L / MT);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
