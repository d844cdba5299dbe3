// Conditional LayerNorm for Hopper (sm_90a), plain C interface: one launch
// forward, two backward. Over the last axis (width C) of rows x, with the
// lead time t[b] of the row's image b (rows of one image are contiguous):
//
//   mu = mean_C x,  v = mean_C x^2 - mu^2,  r = rsqrt(max(v, 0) + eps)        (fp32)
//   xhat = (x - mu) r,  scale = t[b] Ws + bs,  shift = t[b] Wb + bb
//   y = cast(scale xhat + shift)                                          (rounded once)
//
// and, with g = dy scale (fp32),
//
//   dx  = cast(r (g - mean_C g - xhat mean_C(g xhat)))   (no last term where v < 0:
//                                                         the clamp passes no gradient)
//   dWs = sum_b t[b] sum_rows(b) dy xhat,  dbs = sum_b sum_rows(b) dy xhat
//   dWb = sum_b t[b] sum_rows(b) dy,       dbb = sum_b sum_rows(b) dy
//
// Ws, bs, Wb, bb are the Linear(1, C) maps of the lead time (fp32). The
// function is models/layers.py::ConditionalLayerNorm's chain and
// poseidon_tpu/models/layers.py::ConditionalLayerNorm; it replaces no TPU
// kernel (XLA fuses the chain into its neighbours there; eager PyTorch runs
// it as ~17 kernels forward and ~20 backward, with fp32 copies of x saved).
// The Python wrapper and the plain PyTorch version are in ops/norm.py.
//
// Bound on this card: bytes. The forward reads x and writes y; the backward
// reads x and dy and writes dx; each also moves 8 bytes a row of statistics
// (mu and r, with r's sign bit flagging a clamped variance). Both do a few
// FLOPs an element.
//
// Design. A row's G lanes (a power of two, at most a warp) each hold NV
// 16-byte vectors of it (8 bf16 or 4 fp32 values) in registers; its sums go
// round the G lanes by xor shuffles, which give every lane the same bits. A
// CTA takes up to TR rows of one image (the wrapper's plan; an image's last
// tile may be short, so any rows an image go), so the scale and shift
// of its columns are computed once a CTA from t[b] and kept in registers
// where a lane holds at most 24 values (else read again a row, from L1). The
// backward reads each row twice, the second time from L1 (its sums first,
// then dx), so that two CTAs fit an SM. Its first launch also sums dy xhat
// and dy over its rows, per column,
// in fp32: across a lane's rows, then the warp's groups by shuffles, then the
// warps in turn in shared memory, and writes the CTA's (2, C) partial. The
// second launch reduces those partials in a fixed order to the four
// parameter gradients, weighting each by its image's t. No atomics, so two
// calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cond_norm {

using bf16 = __nv_bfloat16;

template <typename T>
struct Pack;

template <>
struct Pack<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static void store(bf16* p, const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// out[e] = t w[c + e] + b[c + e] for the N columns from c (N % 4 == 0).
template <int N>
__device__ inline void affine(float t, const float* __restrict__ w, const float* __restrict__ b,
                              int c, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    float wv[4], bv[4];
    Pack<float>::load(w + c + i, wv);
    Pack<float>::load(b + c + i, bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[i + e] = fmaf(t, wv[e], bv[e]);
  }
}

// Sum over the G lanes of a row (G a power of two, aligned in the warp).
__device__ inline float row_sum(float v, int G) {
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A lane's columns: vectors li + j G, j < NV, of the row's C / N.
template <typename T, int NV>
struct Lane {
  static constexpr int N = Pack<T>::N;
  // Scale and shift kept in registers a CTA where a lane holds <= 24 values.
  static constexpr bool KEEP = NV * N <= 24;
};

// The CTA's tile: up to TR rows of one image, from row0; an image's
// ceil(L / TR) tiles, the last one ragged (its groups past ``rows`` still
// take part in the shuffles, on zeros, and store nothing).
struct Tile {
  int image, rows;
  long long row0;
  __device__ Tile(int L, int TR) {
    const int per = (L + TR - 1) / TR, k = blockIdx.x % per;
    image = blockIdx.x / per;
    rows = min(TR, L - k * TR);
    row0 = (long long)image * L + (long long)k * TR;
  }
};

template <typename T, int NV>
__global__ void __launch_bounds__(256)
cond_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ t,
                     const float* __restrict__ ws, const float* __restrict__ bs,
                     const float* __restrict__ wb, const float* __restrict__ bb,
                     T* __restrict__ y, float* __restrict__ mean, float* __restrict__ rstd,
                     int C, int L, int G, int TR, float eps) {
  constexpr int N = Lane<T, NV>::N;
  constexpr bool KEEP = Lane<T, NV>::KEEP;
  const int nvec = C / N, groups = blockDim.x / G;
  const int gi = threadIdx.x / G, li = threadIdx.x % G;
  const Tile tile(L, TR);
  const float tb = t[tile.image];
  const float inv_c = 1.f / (float)C;
  float sc[KEEP ? NV : 1][N], sh[KEEP ? NV : 1][N];
  if constexpr (KEEP) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * G;
      if (v < nvec) {
        affine<N>(tb, ws, bs, v * N, sc[j]);
        affine<N>(tb, wb, bb, v * N, sh[j]);
      }
    }
  }
  for (int r = gi; r < TR; r += groups) {
    const long long row = tile.row0 + r;
    const bool live = r < tile.rows;
    float xv[NV][N];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * G;
      if (v < nvec && live) {
        Pack<T>::load(x + row * C + v * N, xv[j]);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          s += xv[j][e];
          q = fmaf(xv[j][e], xv[j][e], q);
        }
      }
    }
    s = row_sum(s, G);
    q = row_sum(q, G);
    const float mu = s * inv_c;
    const float var = q * inv_c - mu * mu;
    const float rs = rsqrtf(fmaxf(var, 0.f) + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * G;
      if (v < nvec && live) {
        float a[N], b[N], out[N];
        if constexpr (KEEP) {
#pragma unroll
          for (int e = 0; e < N; ++e) {
            a[e] = sc[j][e];
            b[e] = sh[j][e];
          }
        } else {
          affine<N>(tb, ws, bs, v * N, a);
          affine<N>(tb, wb, bb, v * N, b);
        }
#pragma unroll
        for (int e = 0; e < N; ++e) out[e] = fmaf(a[e], (xv[j][e] - mu) * rs, b[e]);
        Pack<T>::store(y + row * C + v * N, out);
      }
    }
    if (li == 0 && live) {
      mean[row] = mu;
      rstd[row] = var < 0.f ? -rs : rs;
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(256, NV == 3 ? 2 : 1)
cond_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ t, const float* __restrict__ ws,
                     const float* __restrict__ bs, const float* __restrict__ mean,
                     const float* __restrict__ rstd, T* __restrict__ dx,
                     float* __restrict__ part, int C, int L, int G, int TR) {
  extern __shared__ float red[];  // 2C: the CTA's column sums of dy xhat | dy
  constexpr int N = Lane<T, NV>::N;
  constexpr bool KEEP = Lane<T, NV>::KEEP;
  const int nvec = C / N, groups = blockDim.x / G;
  const int gi = threadIdx.x / G, li = threadIdx.x % G;
  const Tile tile(L, TR);
  const float tb = t[tile.image];
  const float inv_c = 1.f / (float)C;
  float sc[KEEP ? NV : 1][N];
  float ah[NV][N], ad[NV][N];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = li + j * G;
    if constexpr (KEEP) {
      if (v < nvec) affine<N>(tb, ws, bs, v * N, sc[j]);
    }
#pragma unroll
    for (int e = 0; e < N; ++e) ah[j][e] = ad[j][e] = 0.f;
  }
  // The scale of a lane's j-th vector: kept, or computed again.
  auto scale = [&](int j, int v, float* se) {
    if constexpr (KEEP) {
#pragma unroll
      for (int e = 0; e < N; ++e) se[e] = sc[j][e];
    } else {
      affine<N>(tb, ws, bs, v * N, se);
    }
  };
  for (int r = gi; r < TR; r += groups) {
    const long long row = tile.row0 + r;
    const bool live = r < tile.rows;
    const float mu = live ? mean[row] : 0.f, rs = live ? rstd[row] : 1.f, ra = fabsf(rs);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * G;
      if (v < nvec && live) {
        float xe[N], de[N], se[N];
        Pack<T>::load(x + row * C + v * N, xe);
        Pack<T>::load(dy + row * C + v * N, de);
        scale(j, v, se);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float h = (xe[e] - mu) * ra, g = de[e] * se[e];
          sg += g;
          sgx = fmaf(g, h, sgx);
          ah[j][e] = fmaf(de[e], h, ah[j][e]);
          ad[j][e] += de[e];
        }
      }
    }
    sg = row_sum(sg, G);
    sgx = row_sum(sgx, G);
    const float mg = sg * inv_c, mgx = rs < 0.f ? 0.f : sgx * inv_c;
    // The row again, from L1: registers for two more copies of it would
    // leave one CTA an SM.
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * G;
      if (v < nvec && live) {
        float xe[N], de[N], se[N], out[N];
        Pack<T>::load(x + row * C + v * N, xe);
        Pack<T>::load(dy + row * C + v * N, de);
        scale(j, v, se);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float h = (xe[e] - mu) * ra, g = de[e] * se[e];
          out[e] = ra * (g - mg - h * mgx);
        }
        Pack<T>::store(dx + row * C + v * N, out);
      }
    }
  }
  // Column sums: the warp's groups (lanes li + k G hold the same columns) ...
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        ah[j][e] += __shfl_xor_sync(0xffffffffu, ah[j][e], o);
        ad[j][e] += __shfl_xor_sync(0xffffffffu, ad[j][e], o);
      }
    }
  }
  // ... then the warps, in turn.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    if (warp == w && lane < G) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = li + j * G;
        if (v < nvec) {
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const int c = v * N + e;
            red[c] = w ? red[c] + ah[j][e] : ah[j][e];
            red[C + c] = w ? red[C + c] + ad[j][e] : ad[j][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.x * 2 * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) out[i] = red[i];
}

// grads = dWs | dbs | dWb | dbb (C each) from the (tiles, 2, C) partials,
// tiles_per_image tiles an image. A CTA takes 32 columns of one half
// (blockIdx.y: 0 dy xhat, 1 dy); its 32 warps stride the tiles, then halve.
__global__ void __launch_bounds__(1024)
cond_norm_reduce_kernel(const float* __restrict__ part, const float* __restrict__ t,
                        float* __restrict__ grads, int tiles, int tiles_per_image, int C) {
  __shared__ float sw[32][33], sb[32][33];
  const int cx = threadIdx.x % 32, s = threadIdx.x / 32, k = blockIdx.y;
  const int c = blockIdx.x * 32 + cx;
  float w = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int i = s; i < tiles; i += 32) {
      const float p = part[((long long)i * 2 + k) * C + c];
      w = fmaf(t[i / tiles_per_image], p, w);
      b += p;
    }
  }
  sw[s][cx] = w;
  sb[s][cx] = b;
  __syncthreads();
  for (int h = 16; h > 0; h >>= 1) {
    if (s < h) {
      sw[s][cx] += sw[s + h][cx];
      sb[s][cx] += sb[s + h][cx];
    }
    __syncthreads();
  }
  if (s == 0 && c < C) {
    grads[2 * k * C + c] = sw[0][cx];
    grads[(2 * k + 1) * C + c] = sb[0][cx];
  }
}

// The plan's checks: G a power of two <= 32 lanes a row, a CTA of whole
// warps (at most 256 threads) whose groups take TR / groups rows each, the
// row's vectors within NV a lane.
inline bool valid(int M, int C, int L, int G, int NV, int TR, int threads, int n) {
  if (M <= 0 || C <= 0 || C % n || L <= 0 || M % L || TR <= 0) return false;
  if (G <= 0 || G > 32 || (G & (G - 1)) || threads < 32 || threads > 256 || threads % 32 ||
      threads % G)
    return false;
  // NV 12 only in fp32: bf16 rows of C <= 1536 need at most 6 vectors a lane.
  if (TR % (threads / G) || (NV != 3 && NV != 6 && (NV != 12 || n != 4))) return false;
  return C / n <= NV * G;
}

// CTAs: ceil(L / TR) an image.
inline int tiles(int M, int L, int TR) { return M / L * ((L + TR - 1) / TR); }

template <typename T, int NV>
cudaError_t fwd(const void* x, const void* t, const void* ws, const void* bs, const void* wb,
                const void* bb, void* y, void* mean, void* rstd, int M, int C, int L, int G,
                int TR, int threads, float eps, cudaStream_t st) {
  cond_norm_fwd_kernel<T, NV><<<tiles(M, L, TR), threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(t), static_cast<const float*>(ws),
      static_cast<const float*>(bs), static_cast<const float*>(wb),
      static_cast<const float*>(bb), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), C, L, G, TR, eps);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t bwd(const void* x, const void* dy, const void* t, const void* ws, const void* bs,
                const void* mean, const void* rstd, void* dx, void* part, int M, int C, int L,
                int G, int TR, int threads, cudaStream_t st) {
  cond_norm_bwd_kernel<T, NV><<<tiles(M, L, TR), threads, 2 * C * sizeof(float), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(t),
      static_cast<const float*>(ws), static_cast<const float*>(bs),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(part), C, L, G, TR);
  return cudaGetLastError();
}

// The instantiations: NV 3, 6 and, in fp32 (WIDE), 12.
template <bool WIDE, typename F>
cudaError_t by_nv(int NV, F&& f) {
  switch (NV) {
    case 3: return f(std::integral_constant<int, 3>{});
    case 6: return f(std::integral_constant<int, 6>{});
    default:
      if constexpr (WIDE) return f(std::integral_constant<int, 12>{});
      return cudaErrorInvalidValue;
  }
}

}  // namespace cond_norm

using namespace cond_norm;

// y = cast(scale xhat + shift) and the rows' mu and signed r (fp32, M each).
extern "C" int cond_layer_norm_fwd(const void* x, const void* t, const void* ws, const void* bs,
                                   const void* wb, const void* bb, void* y, void* mean,
                                   void* rstd, int M, int C, int L, int G, int NV, int TR,
                                   int threads, float eps, int fp32, void* stream) {
  if (!valid(M, C, L, G, NV, TR, threads, fp32 ? 4 : 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag, auto nv) {
    using T = decltype(tag);
    return fwd<T, decltype(nv)::value>(x, t, ws, bs, wb, bb, y, mean, rstd, M, C, L, G, TR,
                                       threads, eps, st);
  };
  return (int)(fp32 ? by_nv<true>(NV, [&](auto nv) { return run(float{}, nv); })
                    : by_nv<false>(NV, [&](auto nv) { return run(bf16{}, nv); }));
}

// dx, and grads = dWs | dbs | dWb | dbb through part (tiles, 2, C) fp32.
extern "C" int cond_layer_norm_bwd(const void* x, const void* dy, const void* t, const void* ws,
                                   const void* bs, const void* mean, const void* rstd, void* dx,
                                   void* part, void* grads, int M, int C, int L, int G, int NV,
                                   int TR, int threads, int fp32, void* stream) {
  if (!valid(M, C, L, G, NV, TR, threads, fp32 ? 4 : 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag, auto nv) {
    using T = decltype(tag);
    return bwd<T, decltype(nv)::value>(x, dy, t, ws, bs, mean, rstd, dx, part, M, C, L, G, TR,
                                       threads, st);
  };
  cudaError_t err = fp32 ? by_nv<true>(NV, [&](auto nv) { return run(float{}, nv); })
                         : by_nv<false>(NV, [&](auto nv) { return run(bf16{}, nv); });
  if (err != cudaSuccess) return (int)err;
  cond_norm_reduce_kernel<<<dim3((C + 31) / 32, 2), 1024, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(t), static_cast<float*>(grads),
      tiles(M, L, TR), (L + TR - 1) / TR, C);
  return (int)cudaGetLastError();
}

// Registers, local-memory (spill) bytes and static shared-memory bytes of a
// kernel: 0 forward, 1 backward (by fp32 and NV), 2 the reduce.
extern "C" int cond_layer_norm_info(int kernel, int fp32, int NV, int* out) {
  cudaFuncAttributes a;
  auto get = [&](auto tag, auto nv) {
    using T = decltype(tag);
    constexpr int V = decltype(nv)::value;
    return kernel == 0 ? cudaFuncGetAttributes(&a, cond_norm_fwd_kernel<T, V>)
                       : cudaFuncGetAttributes(&a, cond_norm_bwd_kernel<T, V>);
  };
  cudaError_t err =
      kernel == 2 ? cudaFuncGetAttributes(&a, cond_norm_reduce_kernel)
      : fp32      ? by_nv<true>(NV, [&](auto nv) { return get(float{}, nv); })
                  : by_nv<false>(NV, [&](auto nv) { return get(bf16{}, nv); });
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
