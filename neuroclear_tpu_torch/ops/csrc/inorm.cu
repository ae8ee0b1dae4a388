// Instance-norm statistics, the normalise-and-activate map and the norm's
// backward over an (N, R, C) channels-last view, for bf16 or f32 tensors.
//
// pair_sums replaces neuroclear_tpu/ops/pallas_ops.py::_pair_sums in both of
// its forms together with the coefficient lines around it:
//   * b = None: per (n, c) [sum x, sum x^2] in f32 and the forward's
//     coefficients (scale, shift) = (rstd, -mean * rstd) that
//     _inorm_fwd_impl derives from them;
//   * b = y: per (n, c) [sum g', sum g' * y] with g' = g * act'(y) (the
//     derivative of the activation that followed the norm applied on the
//     fly, so it needs no pass of its own) and the means (mg, mgy) that
//     _inorm_bwd derives from them.
// affine_map_act replaces _affine_map: y = x * scale + shift with per-(n, c)
// f32 coefficients, then the ReLU or LeakyReLU(0.2) of instance_norm_act; for
// training it also writes the pre-activation y, which the backward needs at
// every voxel.  bwd_map replaces _bwd_map: dx = rstd * (g * act'(y) - mg -
// y * mgy).
//
// Bound on the H100: all are pure streaming passes (2-6 flops per element
// against 2-6 bytes moved), so device memory bounds them: at 108^3 x 64
// bf16, 0.05 ms per 160 MB read or written at 3.35 TB/s.  The maps are
// grid-stride passes that read each element once with 16-byte vector loads;
// they multiply and add with separate roundings (__fmul_rn, __fadd_rn,
// __fsub_rn) in the order the plain PyTorch versions use, so the two agree
// bit for bit.
//
// The statistics are one launch per call, whose summation order is fixed, so
// two runs give the same bits:
//   * The streaming pass reads each element once with 16-byte loads, one
//     thread per 8 (bf16) or 4 (f32) neighbouring channels, so a warp covers
//     whole 32-byte-or-wider row segments; each thread keeps four rows of
//     loads in flight per operand, and the planner (inorm.stats_plan) cuts
//     the rows into enough chunks to put two blocks on every SM (the TPU's
//     sequential grid carried one accumulator instead).
//   * A block adds its rows in registers, then across a warp by shuffles and
//     across its warps in shared memory.
//   * Across blocks, in the same launch: each block writes its partial,
//     fences and draws a ticket (an atomic counter per (n, slab) group); the
//     group's last block adds the partials, spread over all its threads in
//     stripes of consecutive chunks whose sums it then adds in order, writes
//     the sums and the coefficients, and restores the ticket to zero.  The
//     counters are a buffer that the wrapper allocates zeroed once per
//     device; launches that share it must not overlap, which holds while the
//     port runs its work on one stream at a time, as it does.
//   * Small R (the discriminators' norms): one block per (n, slab of
//     channels) reads all of its rows, with no cross-block step, and one
//     short launch finishes the call.
// So a norm is two launches forward (statistics, map) and two backward, with
// no PyTorch operation between them.

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
constexpr float EPS = 1e-5f;  // the norm's epsilon, inorm.EPS

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

// Writes channel ch's sums and its coefficients, computed as the
// PyTorch glue computes them on the card (x / R as x * (1 / R), each step
// rounded): GY false, (rstd, -mean * rstd) with mean = sa / R, var =
// max(sq / R - mean^2, 0), rstd = rsqrt(var + EPS); GY true, (sa / R, sq / R).
template <bool GY>
__device__ __forceinline__ void finish(float* sums, float* coef, int n, int N, int C, int ch,
                                       long long R, float sa, float sq) {
  sums[2LL * n * C + ch] = sa;
  sums[(2LL * n + 1) * C + ch] = sq;
  const float inv = 1.f / static_cast<float>(R);
  float c0, c1;
  if (GY) {
    c0 = __fmul_rn(sa, inv);
    c1 = __fmul_rn(sq, inv);
  } else {
    const float mean = __fmul_rn(sa, inv);
    float var = __fsub_rn(__fmul_rn(sq, inv), __fmul_rn(mean, mean));
    var = var < 0.f ? 0.f : var;  // NaN stays NaN, as torch.clamp keeps it
    c0 = rsqrtf(__fadd_rn(var, EPS));
    c1 = __fmul_rn(-mean, c0);
  }
  coef[static_cast<long long>(n) * C + ch] = c0;
  coef[(static_cast<long long>(N) + n) * C + ch] = c1;
}

// The statistics of one (n, slab) group of channels: grid (chunks, slabs, N),
// block (chunk, s, n) reads rows [chunk * rows_per_chunk, +rows_per_chunk)
// of channels [s * slab, (s + 1) * slab).  GY false: [sum a, sum a^2] and the
// forward's (rstd, -mean * rstd); GY true: [sum a', sum a' * b] with a' =
// act_grad(a, b, act) and the backward's (mean a', mean a' b).  sums: (N, 2,
// C) f32; coef: (2, N, C) f32.  With one chunk each block finishes its own
// group; with more, each block writes its partial to part ((N, slabs,
// chunks, 2, slab) f32) and draws a ticket, and the group's last block adds
// the partials in a fixed order and finishes the group.  slab / V divides
// THREADS.
template <typename T, bool GY>
__global__ void __launch_bounds__(THREADS, 2)
pair_sums_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part,
                 unsigned* __restrict__ tickets, float* __restrict__ sums,
                 float* __restrict__ coef, long long R, int C, int slab,
                 long long rows_per_chunk, int act) {
  constexpr int V = Vec<T>::N;
  constexpr int U = 4;  // rows in flight per thread and operand; the sums below take 4
  __shared__ __align__(16) float red[2 * THREADS * V];
  __shared__ bool last;

  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int s = blockIdx.y, slabs = gridDim.y;
  const int n = blockIdx.z, N = gridDim.z;
  const int tpr = slab / V;           // threads per row
  const int rstep = THREADS / tpr;    // rows per sweep of the block
  const int v = threadIdx.x % tpr;
  const int rsub = threadIdx.x / tpr;

  const long long r0 = chunk * rows_per_chunk;
  const long long r1 = min(R, r0 + rows_per_chunk);
  const long long off = static_cast<long long>(n) * R * C + s * slab + v * V;
  const T* pa = a + off;
  const T* pb = GY ? b + off : nullptr;

  // The two summands of one element: (a', a' * b) or (a, a^2).
  auto terms = [&](float e, float f, float& ta, float& tq) {
    if (GY) {
      ta = act_grad(e, f, act);
      tq = __fmul_rn(ta, f);
    } else {
      ta = e;
      tq = __fmul_rn(e, e);
    }
  };
  float sa[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sq[j] = 0.f;
  long long r = r0 + rsub;
  for (; r + (U - 1) * rstep < r1; r += U * rstep) {
    float e[U][V], f[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Vec<T>::load(pa + (r + u * rstep) * C, e[u]);
      if (GY) Vec<T>::load(pb + (r + u * rstep) * C, f[u]);
    }
    // the U rows pairwise, then one add to the running sums: a thread's
    // sums take one rounding per U rows (the chunks of the streaming shapes
    // give a thread several hundred rows)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float ta[U], tq[U];
#pragma unroll
      for (int u = 0; u < U; ++u) terms(e[u][j], f[u][j], ta[u], tq[u]);
      sa[j] += __fadd_rn(__fadd_rn(ta[0], ta[1]), __fadd_rn(ta[2], ta[3]));
      sq[j] += __fadd_rn(__fadd_rn(tq[0], tq[1]), __fadd_rn(tq[2], tq[3]));
    }
  }
  for (; r < r1; r += rstep) {
    float e[V], f[V];
    Vec<T>::load(pa + r * C, e);
    if (GY) Vec<T>::load(pb + r * C, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float ta, tq;
      terms(e[j], f[j], ta, tq);
      sa[j] += ta;
      sq[j] += tq;
    }
  }

  // The block's sums: first across the rows of a warp (lanes tpr apart hold
  // the same channels), then across its row groups in shared memory.
  if (tpr < 32) {
#pragma unroll
    for (int o = tpr; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sa[j] += __shfl_xor_sync(0xffffffffu, sa[j], o);
        sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], o);
      }
    }
  }
  const int rows_per_warp = tpr < 32 ? 32 / tpr : 1;
  const int groups = rstep / rows_per_warp;
  float* red_q = red + groups * slab;
  if (threadIdx.x % 32 < tpr) {
    const int g = rsub / rows_per_warp;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[g * slab + v * V + j] = sa[j];
      red_q[g * slab + v * V + j] = sq[j];
    }
  }
  __syncthreads();

  const long long group = static_cast<long long>(n) * slabs + s;
  float* mine = chunks == 1 ? nullptr : part + (group * chunks + chunk) * 2 * slab;
  for (int c = threadIdx.x; c < slab; c += THREADS) {
    float ts = 0.f, tq = 0.f;
    for (int g = 0; g < groups; ++g) {
      ts += red[g * slab + c];
      tq += red_q[g * slab + c];
    }
    if (chunks == 1) {
      finish<GY>(sums, coef, n, N, C, s * slab + c, R, ts, tq);
    } else {
      mine[c] = ts;
      mine[slab + c] = tq;
    }
  }
  if (chunks == 1) return;

  // Cross-block step: the partial is visible before the ticket is drawn.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[group], 1u) == static_cast<unsigned>(chunks - 1);
  __syncthreads();
  if (!last) return;
  // Every block of the group has drawn: restore the ticket for the next launch.
  if (threadIdx.x == 0) tickets[group] = 0u;
  __threadfence();

  // The last block adds the group's partials: thread i takes float4 column
  // i % cols4 of the chunks of stripe i / cols4 (consecutive chunks, in
  // order); the stripes' sums are then added in stripe order.
  const float4* p4 = reinterpret_cast<const float4*>(part + group * chunks * 2 * slab);
  const int cols4 = slab / 2;
  const int stripes = cols4 >= THREADS ? 1 : THREADS / cols4;
  const int per = (chunks + stripes - 1) / stripes;
  float4* red4 = reinterpret_cast<float4*>(red);
  for (int i = threadIdx.x; i < stripes * cols4; i += THREADS) {
    const int col = i % cols4;
    const int k0 = (i / cols4) * per;
    const int k1 = min(chunks, k0 + per);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float4 p = __ldcg(p4 + static_cast<long long>(k) * cols4 + col);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    red4[i] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < slab; c += THREADS) {
    float ts = 0.f, tq = 0.f;
    for (int j = 0; j < stripes; ++j) {
      ts += red[j * 2 * slab + c];
      tq += red[j * 2 * slab + slab + c];
    }
    finish<GY>(sums, coef, n, N, C, s * slab + c, R, ts, tq);
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
int pair_sums_impl(const void* a, const void* b, void* part, void* tickets, void* sums,
                   void* coef, long long N, long long R, int C, int slab, int chunks,
                   long long rows_per_chunk, int act, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (N <= 0 || N > 65535 || R <= 0 || C <= 0 || slab <= 0 || slab % V != 0 || C % slab != 0 ||
      THREADS % (slab / V) != 0 || chunks <= 0 || rows_per_chunk <= 0 ||
      static_cast<long long>(chunks) * rows_per_chunk < R ||
      static_cast<long long>(chunks - 1) * rows_per_chunk >= R ||
      (chunks > 1 && (part == nullptr || tickets == nullptr)) || act < ACT_NONE ||
      act > ACT_LEAKY)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(C / slab),
                  static_cast<unsigned>(N));
  const T* ta = static_cast<const T*>(a);
  float* fpart = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* fs = static_cast<float*>(sums);
  float* fc = static_cast<float*>(coef);
  if (b == nullptr)
    pair_sums_kernel<T, false><<<grid, THREADS, 0, stream>>>(ta, nullptr, fpart, tk, fs, fc, R, C,
                                                             slab, rows_per_chunk, act);
  else
    pair_sums_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        ta, static_cast<const T*>(b), fpart, tk, fs, fc, R, C, slab, rows_per_chunk, act);
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

// a, b: (N, R, C); b may be null (then [sum a, sum a^2] and the forward's
// coefficients).  The plan (slab, chunks, rows_per_chunk) is
// inorm.stats_plan's.  part: (N, C / slab, chunks, 2, slab) f32 scratch and
// tickets: N * C / slab zeroed counters, both unused (may be null) with one
// chunk; sums: (N, 2, C) f32; coef: (2, N, C) f32.  act: 0 none, 1 relu, 2
// leaky.  Returns cudaGetLastError() after the launch.
extern "C" int nc_pair_sums(const void* a, const void* b, void* part, void* tickets, void* sums,
                            void* coef, long long N, long long R, int C, int slab, int chunks,
                            long long rows_per_chunk, int act, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pair_sums_impl<__nv_bfloat16>(a, b, part, tickets, sums, coef, N, R, C, slab,
                                                 chunks, rows_per_chunk, act, st)
                 : pair_sums_impl<float>(a, b, part, tickets, sums, coef, N, R, C, slab, chunks,
                                         rows_per_chunk, act, st);
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
