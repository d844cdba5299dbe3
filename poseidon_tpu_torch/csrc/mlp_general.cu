// Fused block MLP, forward and backward, for the calls the Hopper kernels
// (mlp.cu, mlp_bwd.cu) do not take: fp32 operands, and any width C <= 1024
// with any hidden width F <= 4096 in bf16 or fp32. Plain C interface.
//
//   u = x . W1^T + b1;  g = cast(gelu(u));  out = cast(g . W2^T + b2)
//
// on token-major (M, C) rows, with the PyTorch Linear weights as they are:
// W1 (F, C), W2 (C, F) in the operands' type, b1 (F,), b2 (C,) fp32; cast()
// rounds to the operand type and is the identity for fp32. GELU is exact,
// by erff (within 2 ulp), as the plain version's torch.erf. Replaces, for
// those calls, the TPU kernels of poseidon_tpu/ops/mlp.py: _fwd_kernel_dm
// (pallas_call in _call_fwd_dm) and _fwd_kernel (_call_fwd) in the forward
// entry; _bwd_kernel_dm (_call_bwd_dm), _bwd_kernel_fused and
// _bwd_kernel_emit (_call_bwd) in the backward one, whose outputs are
//   du = (dy . W2) gelu'(u);  dx = cast(cast(du) . W1);  dW1 = cast(du)^T . x
//   db1 = sum du;  dW2 = dy^T . g;  db2 = sum dy                  (fp32)
// The wrapper and the plain versions with the same rounding points
// (mlp_plain, mlp_bwd_plain) are in ops/mlp.py. Every product is an fp32
// FMA on the CUDA cores: fp32 operands get no TF32.
//
// Bound on this card. The forward does 4 M C F FLOPs on (2 M C + 2 C F)
// operands: with fp32 operands about F / 2 FLOPs a byte at large M, past the
// fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOPs a byte) for every F the
// model has, so the fp32 lanes bound it; the backward (8 M C F FLOPs) too.
//
// Design, simple first. Every product is one tiled SIMT GEMM: a CTA of 256
// threads owns a 64 x 64 output tile, 4 x 4 values a thread, and walks the
// reduction in 32-deep (64 for the second forward product) fp32 tiles
// staged in shared memory. The forward CTA owns 64 rows and 64 output
// columns: for each 64-wide step of F it computes u for its rows, keeps
// g in shared memory (the hidden state never leaves the chip) and adds
// g . W2^T to its sum; a CTA column of C > 64 recomputes u, the price of
// keeping g on chip at any C. The backward is four launches: (1) per 64
// rows and 64 hidden columns, u and dh = dy . W2 recomputed, cast(du) and g
// written to scratch in the operands' type (they are rounded to it
// anyway), and per-CTA partials of db1 (from the unrounded du) and db2;
// (2) dx = cast(du) . W1; (3) dW1 and dW2 over row splits, each split
// writing one fp32 partial; (4) the partials summed in a fixed order. No
// atomics, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int TILE = 64;     // output tile rows and columns
constexpr int TK = 32;       // reduction depth of a staged tile
constexpr int LDS = 68;      // shared-memory row stride, floats
constexpr int MAX_C = 1024;
constexpr int MAX_F = 4096;
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

// S[k][p] = get(k, p) for k < kk, p < 64. With KFAST the threads walk k
// fastest (for sources contiguous along the reduction), else p.
template <bool KFAST, class Get>
__device__ __forceinline__ void stage(float* S, int kk, Get get) {
  for (int i = threadIdx.x; i < kk * TILE; i += THREADS) {
    int k, p;
    if (KFAST) {
      k = i % kk;
      p = i / kk;
    } else {
      p = i % TILE;
      k = i / TILE;
    }
    S[k * LDS + p] = get(k, p);
  }
}

// acc[i][j] += sum_k A[k][4 ty + i] B[k][4 tx + j], ty = thread / 16,
// tx = thread % 16: the thread's 4 x 4 values of the 64 x 64 tile.
__device__ __forceinline__ void mma(float (&acc)[4][4], const float* A, const float* B, int kk) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k = 0; k < kk; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * LDS + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(B + k * LDS + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[m][f] = sum_c x[m0 + m][c] W1[f0 + f][c]: u of a 64 x 64 tile, b1 not
// yet added. As holds TK rows, Bs at least TK.
template <typename T>
__device__ void hidden_tile(float (&acc)[4][4], const T* x, const T* w1, int M, int C, int F,
                            int m0, int f0, float* As, float* Bs) {
  zero(acc);
  for (int k0 = 0; k0 < C; k0 += TK) {
    stage<true>(As, TK, [&](int k, int p) {
      const int m = m0 + p, c = k0 + k;
      return m < M && c < C ? to_f(x[(long long)m * C + c]) : 0.f;
    });
    stage<true>(Bs, TK, [&](int k, int p) {
      const int f = f0 + p, c = k0 + k;
      return f < F && c < C ? to_f(w1[(long long)f * C + c]) : 0.f;
    });
    __syncthreads();
    mma(acc, As, Bs, TK);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_general_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const float* __restrict__ b2, T* __restrict__ out, int M, int C, int F) {
  __shared__ __align__(16) float As[TK * LDS];
  __shared__ __align__(16) float Bs[TILE * LDS];
  __shared__ __align__(16) float Gs[TILE * LDS];  // g^T of the step: [f][m]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE;
  float y[4][4], u[4][4];
  zero(y);
  for (int f0 = 0; f0 < F; f0 += TILE) {
    hidden_tile(u, x, w1, M, C, F, m0, f0, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + tx * 4 + j;
        Gs[(tx * 4 + j) * LDS + ty * 4 + i] = f < F ? cast<T>(gelu(u[i][j] + b1[f])) : 0.f;
      }
    stage<true>(Bs, TILE, [&](int k, int p) {
      const int c = c0 + p, f = f0 + k;
      return c < C && f < F ? to_f(w2[(long long)c * F + f]) : 0.f;
    });
    __syncthreads();
    mma(y, Gs, Bs, TILE);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (m < M && c < C) out[(long long)m * C + c] = from_f<T>(y[i][j] + b2[c]);
    }
}

// (1) Per 64 rows and 64 hidden columns: cast(du) and g to scratch, and the
// block's partial sums of du (db1) and, in the first column of CTAs, of dy
// (db2): partb[row block] = [db1 (F) | db2 (C)].
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_general_hidden(const T* __restrict__ x, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   const T* __restrict__ dy, T* __restrict__ dub, T* __restrict__ gs,
                   float* __restrict__ partb, int M, int C, int F) {
  __shared__ __align__(16) float As[TK * LDS];
  __shared__ __align__(16) float Bs[TK * LDS];
  __shared__ float red[16 * TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * TILE, f0 = blockIdx.y * TILE;
  float u[4][4], dh[4][4];
  hidden_tile(u, x, w1, M, C, F, m0, f0, As, Bs);
  zero(dh);
  for (int k0 = 0; k0 < C; k0 += TK) {
    stage<true>(As, TK, [&](int k, int p) {
      const int m = m0 + p, c = k0 + k;
      return m < M && c < C ? to_f(dy[(long long)m * C + c]) : 0.f;
    });
    stage<false>(Bs, TK, [&](int k, int p) {
      const int f = f0 + p, c = k0 + k;
      return f < F && c < C ? to_f(w2[(long long)c * F + f]) : 0.f;
    });
    __syncthreads();
    mma(dh, As, Bs, TK);
    __syncthreads();
  }
  float colsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, f = f0 + tx * 4 + j;
      if (m < M && f < F) {
        const float uu = u[i][j] + b1[f];
        const float du = dh[i][j] * dgelu(uu);
        dub[(long long)m * F + f] = from_f<T>(du);
        gs[(long long)m * F + f] = from_f<T>(gelu(uu));
        colsum[j] += du;
      }
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty * TILE + tx * 4 + j] = colsum[j];
  __syncthreads();
  float* pb = partb + (long long)blockIdx.x * (F + C);
  if (threadIdx.x < TILE && f0 + (int)threadIdx.x < F) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red[r * TILE + threadIdx.x];
    pb[f0 + threadIdx.x] = s;
  }
  if (blockIdx.y == 0) {
    for (int c = threadIdx.x; c < C; c += THREADS) {
      float s = 0.f;
      for (int m = m0; m < min(M, m0 + TILE); ++m) s += to_f(dy[(long long)m * C + c]);
      pb[F + c] = s;
    }
  }
}

// (2) dx = cast(cast(du) . W1) over 64 x 64 tiles of (M, C).
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_general_dx(const T* __restrict__ dub, const T* __restrict__ w1, T* __restrict__ dx, int M,
               int C, int F) {
  __shared__ __align__(16) float As[TK * LDS];
  __shared__ __align__(16) float Bs[TK * LDS];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE;
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < F; k0 += TK) {
    stage<true>(As, TK, [&](int k, int p) {
      const int m = m0 + p, f = k0 + k;
      return m < M && f < F ? to_f(dub[(long long)m * F + f]) : 0.f;
    });
    stage<false>(Bs, TK, [&](int k, int p) {
      const int c = c0 + p, f = k0 + k;
      return c < C && f < F ? to_f(w1[(long long)f * C + c]) : 0.f;
    });
    __syncthreads();
    mma(acc, As, Bs, TK);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (m < M && c < C) dx[(long long)m * C + c] = from_f<T>(acc[i][j]);
    }
}

// (3) part[z][p][q] = sum over rows m of split z of A[m][p] B[m][q], for
// A (M, P) and B (M, Q): dW1 = cast(du)^T x and dW2 = dy^T g.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlp_general_dw(const T* __restrict__ A, int P, const T* __restrict__ B, int Q,
               float* __restrict__ part, long long part_stride, int M, int rows_per_split) {
  __shared__ __align__(16) float As[TK * LDS];
  __shared__ __align__(16) float Bs[TK * LDS];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int p0 = blockIdx.x * TILE, q0 = blockIdx.y * TILE;
  const int mb = blockIdx.z * rows_per_split, me = min(M, mb + rows_per_split);
  float acc[4][4];
  zero(acc);
  for (int k0 = mb; k0 < me; k0 += TK) {
    stage<false>(As, TK, [&](int k, int p) {
      const int m = k0 + k, pp = p0 + p;
      return m < me && pp < P ? to_f(A[(long long)m * P + pp]) : 0.f;
    });
    stage<false>(Bs, TK, [&](int k, int p) {
      const int m = k0 + k, qq = q0 + p;
      return m < me && qq < Q ? to_f(B[(long long)m * Q + qq]) : 0.f;
    });
    __syncthreads();
    mma(acc, As, Bs, TK);
    __syncthreads();
  }
  float* out = part + blockIdx.z * part_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + ty * 4 + i, q = q0 + tx * 4 + j;
      if (p < P && q < Q) out[(long long)p * Q + q] = acc[i][j];
    }
}

// (4) out[i] = sum over r < rows of part[r][i], in order.
__global__ void __launch_bounds__(THREADS)
mlp_general_reduce(const float* __restrict__ part, int rows, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[r * n + i];
  out[i] = s;
}

unsigned tiles(int n) { return (unsigned)((n + TILE - 1) / TILE); }

bool valid(int M, int C, int F) { return M > 0 && C >= 1 && C <= MAX_C && F >= 1 && F <= MAX_F; }

template <typename T>
cudaError_t run_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, void* out, int M, int C, int F, cudaStream_t stream) {
  mlp_general_fwd_kernel<T><<<dim3(tiles(M), tiles(C)), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<T*>(out), M, C, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const T* x, const T* w1, const float* b1, const T* w2, const T* dy, T* dx,
                    float* grads, T* dub, T* g, float* partw, float* partb, int M, int C,
                    int F, int R, cudaStream_t stream) {
  mlp_general_hidden<T><<<dim3(tiles(M), tiles(F)), THREADS, 0, stream>>>(
      x, w1, b1, w2, dy, dub, g, partb, M, C, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_general_dx<T><<<dim3(tiles(M), tiles(C)), THREADS, 0, stream>>>(dub, w1, dx, M, C, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int rows = ((M + R - 1) / R + TK - 1) / TK * TK;
  const long long fc = (long long)F * C;
  mlp_general_dw<T><<<dim3(tiles(F), tiles(C), R), THREADS, 0, stream>>>(
      dub, F, x, C, partw, 2 * fc, M, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlp_general_dw<T><<<dim3(tiles(C), tiles(F), R), THREADS, 0, stream>>>(
      dy, C, g, F, partw + fc, 2 * fc, M, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlp_general_reduce<<<(unsigned)((2 * fc + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      partw, R, 2 * fc, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlp_general_reduce<<<(unsigned)((F + C + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      partb, (int)tiles(M), F + C, grads + 2 * fc);
  return cudaGetLastError();
}

}  // namespace

// x (M, C), w1 (F, C), w2 (C, F), out (M, C) in bf16 (fp32 == 0) or fp32;
// b1 (F,), b2 (C,) fp32.
extern "C" int mlp_general_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int M, int C, int F, int fp32,
                               void* stream) {
  if (!valid(M, C, F)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fp32 ? run_fwd<float>(x, w1, b1, w2, b2, out, M, C, F, s)
                    : run_fwd<bf16>(x, w1, b1, w2, b2, out, M, C, F, s));
}

// The backward for the output cotangent dy (M, C): dx (M, C) in the
// operands' type and grads = [dW1 (F, C) | dW2 (C, F) | db1 (F) | db2 (C)]
// fp32. Scratch: dub and g (M, F) in the operands' type, partw (R, 2 F C)
// and partb (ceil(M / 64), F + C) fp32; R row splits of the weight
// gradients.
extern "C" int mlp_general_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* dy, void* dx, void* grads, void* dub, void* g,
                               void* partw, void* partb, int M, int C, int F, int R, int fp32,
                               void* stream) {
  if (!valid(M, C, F) || R < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gr = static_cast<float*>(grads);
  float* pw = static_cast<float*>(partw);
  float* pb = static_cast<float*>(partb);
  const float* bb = static_cast<const float*>(b1);
  if (fp32)
    return (int)run_bwd<float>(static_cast<const float*>(x), static_cast<const float*>(w1), bb,
                               static_cast<const float*>(w2), static_cast<const float*>(dy),
                               static_cast<float*>(dx), gr, static_cast<float*>(dub),
                               static_cast<float*>(g), pw, pb, M, C, F, R, s);
  return (int)run_bwd<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), bb,
                            static_cast<const bf16*>(w2), static_cast<const bf16*>(dy),
                            static_cast<bf16*>(dx), gr, static_cast<bf16*>(dub),
                            static_cast<bf16*>(g), pw, pb, M, C, F, R, s);
}

// Registers, local-memory (spill) bytes and static shared-memory bytes of
// kernel 0-4 (forward, hidden, dx, dW, reduce) for fp32 or bf16 operands.
extern "C" int mlp_general_info(int kernel, int fp32, int* out) {
  const void* fns[2][5] = {
      {(const void*)mlp_general_fwd_kernel<bf16>, (const void*)mlp_general_hidden<bf16>,
       (const void*)mlp_general_dx<bf16>, (const void*)mlp_general_dw<bf16>,
       (const void*)mlp_general_reduce},
      {(const void*)mlp_general_fwd_kernel<float>, (const void*)mlp_general_hidden<float>,
       (const void*)mlp_general_dx<float>, (const void*)mlp_general_dw<float>,
       (const void*)mlp_general_reduce}};
  if (kernel < 0 || kernel > 4) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[fp32 ? 1 : 0][kernel]);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
