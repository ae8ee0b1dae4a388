// Instance-norm statistics and the normalise-and-activate map over an
// (N, R, C) channels-last view, for bf16 or f32 activations.
//
// pair_sums replaces neuroclear_tpu/ops/pallas_ops.py::_pair_sums (with
// b = None): per (n, c) [sum x, sum x^2] in f32.  affine_map_act replaces
// _affine_map: y = act(x * scale + shift) with per-(n, c) f32 coefficients,
// the ReLU of instance_norm_act fused in.
//
// Bound on the H100: both are pure streaming passes (2-3 flops per element
// against 2 bytes read, and 2 written for the map), so device memory bounds
// them: 0.2 ms (sums) and 0.4 ms (map) at 2 x 140^3 x 64 bf16 at 3.35 TB/s.
// The design reads each element once with 16-byte vector loads, one thread
// per 8 (bf16) or 4 (f32) neighbouring channels, so a warp covers whole
// contiguous rows:
//   * pair_sums splits R over enough blocks to fill the card (the TPU's
//     sequential grid carried one accumulator instead); each block reduces
//     its rows in registers and then across its threads in shared memory,
//     and a second small kernel adds the blocks' partials in a fixed order,
//     so the result does not change from run to run;
//   * affine_map_act is one grid-stride pass; it multiplies and adds with
//     separate roundings (__fmul_rn, __fadd_rn), as the plain PyTorch
//     version does, so the two agree bit for bit.

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

// grid (chunks, N); part: (N, chunks, 2, C) f32.  Requires C / V to divide
// THREADS.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pair_sums_partial(const T* __restrict__ x, float* __restrict__ part, long long R, int C,
                  long long rows_per_chunk) {
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
  const T* base = x + static_cast<long long>(n) * R * C + v * V;

  float sa[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sq[j] = 0.f;
  for (long long r = r0 + rsub; r < r1; r += rstep) {
    float e[V];
    Vec<T>::load(base + r * C, e);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sa[j] += e[j];
      sq[j] = fmaf(e[j], e[j], sq[j]);
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
    float a = 0.f, q = 0.f;
    for (int g = 0; g < rstep; ++g) {
      a += red[0][g * C + c];
      q += red[1][g * C + c];
    }
    float* out = part + ((static_cast<long long>(n) * chunks + chunk) * 2) * C;
    out[c] = a;
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

// scale, shift: (N, C) f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
affine_map_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ y, long long R, int C,
                      long long total_vec, int relu) {
  constexpr int V = Vec<T>::N;
  const long long rc = R * C;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < total_vec;
       i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long e = i * V;
    const long long n = e / rc;
    const int c = static_cast<int>(e % C);
    const float* sc = scale + n * C + c;
    const float* sh = shift + n * C + c;
    float v[V];
    Vec<T>::load(x + e, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f = __fadd_rn(__fmul_rn(v[j], sc[j]), sh[j]);
      v[j] = relu ? fmaxf(f, 0.f) : f;
    }
    Vec<T>::store(y + e, v);
  }
}

template <typename T>
int pair_sums_impl(const void* x, void* part, void* out, long long N, long long R, int C,
                   int chunks, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (N <= 0 || R <= 0 || chunks <= 0 || N > 65535 || C % V != 0 || THREADS % (C / V) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows_per_chunk = (R + chunks - 1) / chunks;
  pair_sums_partial<T><<<dim3(chunks, static_cast<unsigned>(N)), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), R, C, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_sums_combine<<<static_cast<unsigned>(N), THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), C, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int affine_map_act_impl(const void* x, const void* scale, const void* shift, void* y,
                        long long N, long long R, int C, int relu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (N <= 0 || R <= 0 || C % V != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total_vec = N * R * C / V;
  long long blocks = (total_vec + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond ~16 blocks per SM
  affine_map_act_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(y), R, C, total_vec, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part: (N, chunks, 2, C) f32 scratch; out: (N, 2, C) f32.
extern "C" int nc_pair_sums(const void* x, void* part, void* out, long long N, long long R,
                            int C, int chunks, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pair_sums_impl<__nv_bfloat16>(x, part, out, N, R, C, chunks, s)
                 : pair_sums_impl<float>(x, part, out, N, R, C, chunks, s);
}

extern "C" int nc_affine_map_act(const void* x, const void* scale, const void* shift, void* y,
                                 long long N, long long R, int C, int relu, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? affine_map_act_impl<__nv_bfloat16>(x, scale, shift, y, N, R, C, relu, s)
                 : affine_map_act_impl<float>(x, scale, shift, y, N, R, C, relu, s);
}

extern "C" const char* nc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
