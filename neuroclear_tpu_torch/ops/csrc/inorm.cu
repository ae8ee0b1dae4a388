// Instance-norm statistics, the normalise-and-activate map and the norm's
// backward over an (N, R, C) channels-last view, for bf16 or f32 tensors.
//
// pair_sums replaces neuroclear_tpu/ops/pallas_ops.py::_pair_sums in both of
// its forms: b = None, per (n, c) [sum x, sum x^2] in f32 (the forward
// statistics), and b = y, per (n, c) [sum g, sum g*y] (the backward's,
// _inorm_bwd).  In the second form the derivative of the activation that
// followed the norm is applied to g on the fly (g * act'(y)), so the
// activation's backward needs no pass of its own.  affine_map_act replaces
// _affine_map: y = x * scale + shift with per-(n, c) f32 coefficients, then
// the ReLU or LeakyReLU(0.2) of instance_norm_act; for training it also
// writes the pre-activation y, which the backward needs at every voxel.
// bwd_map replaces _bwd_map: dx = rstd * (g * act'(y) - mg - y * mgy).
//
// Bound on the H100: all are pure streaming passes (2-6 flops per element
// against 2-6 bytes moved), so device memory bounds them: at 108^3 x 64
// bf16, 0.05 ms per 160 MB read or written at 3.35 TB/s.  The design reads
// each element once with 16-byte vector loads, one thread per 8 (bf16) or
// 4 (f32) neighbouring channels, so a warp covers whole contiguous rows:
//   * pair_sums splits R over enough blocks to fill the card (the TPU's
//     sequential grid carried one accumulator instead); each block reduces
//     its rows in registers and then across its threads in shared memory,
//     and a second small kernel adds the blocks' partials in a fixed order,
//     so the result does not change from run to run;
//   * the maps are grid-stride passes; they multiply and add with separate
//     roundings (__fmul_rn, __fadd_rn, __fsub_rn) in the order the plain
//     PyTorch versions use, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Activations after the norm: 0 none, 1 ReLU, 2 LeakyReLU(0.2).
constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2;
constexpr float LEAKY_SLOPE = 0.2f;

template <typename T>
__device__ __forceinline__ float round_to(float f);
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}
template <>
__device__ __forceinline__ float round_to<float>(float f) {
  return f;
}

// g * act'(y): the cotangent before the activation.  act'(0) follows JAX:
// 0 for relu (x > 0), 1 for leaky_relu (x >= 0).
__device__ __forceinline__ float act_grad(float g, float y, int act) {
  if (act == ACT_RELU) return y > 0.f ? g : 0.f;
  if (act == ACT_LEAKY) return y >= 0.f ? g : __fmul_rn(g, LEAKY_SLOPE);
  return g;
}

// grid (chunks, N); part: (N, chunks, 2, C) f32.  b == nullptr: [sum a,
// sum a^2]; else [sum a', sum a' * b] with a' = act_grad(a, b, act).
// Requires C / V to divide THREADS.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pair_sums_partial(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part,
                  long long R, int C, long long rows_per_chunk, int act) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[2][THREADS * V];

  const int n = blockIdx.y;
  const int chunk = blockIdx.x;
  const int chunks = gridDim.x;
  const int cv = C / V;               // threads per row
  const int rstep = THREADS / cv;     // rows per sweep of the block
  const int v = threadIdx.x % cv;
  const int rsub = threadIdx.x / cv;

  const long long r0 = chunk * rows_per_chunk;
  const long long r1 = min(R, r0 + rows_per_chunk);
  const long long off = static_cast<long long>(n) * R * C + v * V;

  float sa[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sq[j] = 0.f;
  if (b == nullptr) {
    for (long long r = r0 + rsub; r < r1; r += rstep) {
      float e[V];
      Vec<T>::load(a + off + r * C, e);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sa[j] += e[j];
        sq[j] = fmaf(e[j], e[j], sq[j]);
      }
    }
  } else {
    for (long long r = r0 + rsub; r < r1; r += rstep) {
      float e[V], f[V];
      Vec<T>::load(a + off + r * C, e);
      Vec<T>::load(b + off + r * C, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float ga = act_grad(e[j], f[j], act);
        sa[j] += ga;
        sq[j] = fmaf(ga, f[j], sq[j]);
      }
    }
  }
  // red[.][rsub * C + c]: every row group's sums for channel c
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][rsub * C + v * V + j] = sa[j];
    red[1][rsub * C + v * V + j] = sq[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s = 0.f, q = 0.f;
    for (int grp = 0; grp < rstep; ++grp) {
      s += red[0][grp * C + c];
      q += red[1][grp * C + c];
    }
    float* out = part + ((static_cast<long long>(n) * chunks + chunk) * 2) * C;
    out[c] = s;
    out[C + c] = q;
  }
}

// grid (N); out: (N, 2, C) f32, the chunks' partials added in chunk order.
__global__ void __launch_bounds__(THREADS)
pair_sums_combine(const float* __restrict__ part, float* __restrict__ out, int C, int chunks) {
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[(static_cast<long long>(n) * chunks + k) * 2 * C + i];
    out[static_cast<long long>(n) * 2 * C + i] = s;
  }
}

// scale, shift: (N, C) f32.  out = act(round(x * scale + shift)), rounded
// again; pre (if not null) gets round(x * scale + shift).
template <typename T>
__global__ void __launch_bounds__(THREADS)
affine_map_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ pre, T* __restrict__ y,
                      long long R, int C, long long total_vec, int act) {
  constexpr int V = Vec<T>::N;
  const long long rc = R * C;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < total_vec;
       i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long e = i * V;
    const long long n = e / rc;
    const int c = static_cast<int>(e % C);
    const float* sc = scale + n * C + c;
    const float* sh = shift + n * C + c;
    float v[V], p[V];
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = 0.f;
    Vec<T>::load(x + e, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = round_to<T>(__fadd_rn(__fmul_rn(v[j], sc[j]), sh[j]));
      p[j] = f;
      if (act == ACT_RELU) {
        v[j] = fmaxf(f, 0.f);
      } else if (act == ACT_LEAKY) {
        v[j] = f >= 0.f ? f : __fmul_rn(f, LEAKY_SLOPE);
      } else {
        v[j] = f;
      }
    }
    if (pre != nullptr) Vec<T>::store(pre + e, p);
    Vec<T>::store(y + e, v);
  }
}

// rstd, mg, mgy: (N, C) f32.  dx = rstd * ((act_grad(g, y) - mg) - y * mgy).
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_map_kernel(const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ rstd,
               const float* __restrict__ mg, const float* __restrict__ mgy, T* __restrict__ dx,
               long long R, int C, long long total_vec, int act) {
  constexpr int V = Vec<T>::N;
  const long long rc = R * C;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < total_vec;
       i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long e = i * V;
    const long long nc = (e / rc) * C + e % C;
    float gv[V], yv[V];
    Vec<T>::load(g + e, gv);
    Vec<T>::load(y + e, yv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = __fsub_rn(act_grad(gv[j], yv[j], act), mg[nc + j]);
      gv[j] = __fmul_rn(rstd[nc + j], __fsub_rn(t, __fmul_rn(yv[j], mgy[nc + j])));
    }
    Vec<T>::store(dx + e, gv);
  }
}

template <typename T>
int pair_sums_impl(const void* a, const void* b, void* part, void* out, long long N, long long R,
                   int C, int chunks, int act, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (N <= 0 || R <= 0 || chunks <= 0 || N > 65535 || C % V != 0 || THREADS % (C / V) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows_per_chunk = (R + chunks - 1) / chunks;
  pair_sums_partial<T><<<dim3(chunks, static_cast<unsigned>(N)), THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(part), R, C,
      rows_per_chunk, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_sums_combine<<<static_cast<unsigned>(N), THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), C, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a grid-stride pass over total_vec vectors: beyond ~16 blocks per
// SM the threads loop instead.
long long map_blocks(long long total_vec) {
  const long long blocks = (total_vec + THREADS - 1) / THREADS;
  return blocks < 132 * 16 ? blocks : 132 * 16;
}

template <typename T>
int affine_map_act_impl(const void* x, const void* scale, const void* shift, void* pre, void* y,
                        long long N, long long R, int C, int act, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (N <= 0 || R <= 0 || C % V != 0 || act < ACT_NONE || act > ACT_LEAKY)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total_vec = N * R * C / V;
  affine_map_act_kernel<T><<<static_cast<unsigned>(map_blocks(total_vec)), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(pre), static_cast<T*>(y), R, C,
      total_vec, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_map_impl(const void* g, const void* y, const void* rstd, const void* mg, const void* mgy,
                 void* dx, long long N, long long R, int C, int act, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (N <= 0 || R <= 0 || C % V != 0 || act < ACT_NONE || act > ACT_LEAKY)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total_vec = N * R * C / V;
  bwd_map_kernel<T><<<static_cast<unsigned>(map_blocks(total_vec)), THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const float*>(rstd),
      static_cast<const float*>(mg), static_cast<const float*>(mgy), static_cast<T*>(dx), R, C,
      total_vec, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: (N, R, C); b may be null (then [sum a, sum a^2]).  part: (N, chunks,
// 2, C) f32 scratch; out: (N, 2, C) f32.  act: 0 none, 1 relu, 2 leaky.
extern "C" int nc_pair_sums(const void* a, const void* b, void* part, void* out, long long N,
                            long long R, int C, int chunks, int act, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pair_sums_impl<__nv_bfloat16>(a, b, part, out, N, R, C, chunks, act, s)
                 : pair_sums_impl<float>(a, b, part, out, N, R, C, chunks, act, s);
}

// pre may be null (inference: only the activated output is written).
extern "C" int nc_affine_map_act(const void* x, const void* scale, const void* shift, void* pre,
                                 void* y, long long N, long long R, int C, int act, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? affine_map_act_impl<__nv_bfloat16>(x, scale, shift, pre, y, N, R, C, act, s)
                 : affine_map_act_impl<float>(x, scale, shift, pre, y, N, R, C, act, s);
}

extern "C" int nc_bwd_map(const void* g, const void* y, const void* rstd, const void* mg,
                          const void* mgy, void* dx, long long N, long long R, int C, int act,
                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd_map_impl<__nv_bfloat16>(g, y, rstd, mg, mgy, dx, N, R, C, act, s)
                 : bwd_map_impl<float>(g, y, rstd, mg, mgy, dx, N, R, C, act, s);
}

extern "C" const char* nc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
