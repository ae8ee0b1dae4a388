// 3x3x3, stride-1, SAME convolution, NDHWC, bf16 in, f32 accumulation, bias
// fused (optional, f32, added before the one rounding), bf16 out, for cin
// any multiple of 32 and cout 32, 64, 96 or 128.  One kernel serves every
// hand-written 3x3x3 conv of the port:
//   * neuroclear_tpu/ops/pallas_conv.py::_conv_kernel (launched by
//     _conv3d_pallas, public entry conv3d_3x3), the dense-K conv.  The TPU
//     kernel DMAs three haloed z-planes of one row strip into VMEM, builds
//     the (T_h*W, 27*cin) im2col strip there and runs one dense-K matmul
//     against the (27*cin, cout) weights;
//   * neuroclear_tpu/ops/pallas_wconv.py::_kernel (launched by _conv_pallas)
//     in both of its uses: the W-pair forward conv (cout 64) and the input
//     gradient of its custom VJP (_bwd), the same conv of the 64-channel
//     cotangent with the flipped, in/out-transposed kernel, so its cout is
//     the forward's cin (64 or 128) and it carries no bias.  The TPU kernel
//     folds W pairs into the 128 lanes so its matrix unit sees K = 2*cin,
//     N = 128.
// The VMEM strip and the lane packing are TPU devices and are not carried
// over: here the conv is an implicit GEMM
//   out[m, n] = bias[n] + sum_{tap, c} x[m + shift(tap), c] * wt[tap, n, c]
// with M = B*D*H*W output voxels, N = cout, K = 27*cin, taps outside the
// volume read as zero, and the im2col rows are gathered stage by stage
// straight into shared memory.
//
// Bound on the H100: 2 * 27 * cin * cout FLOP per voxel against
// 2 * (cin + cout) bytes moved: at the path's shapes (cin 64-256, cout
// 64-128) 580-2300 FLOP/byte, far above the card's ~295 bf16 FLOP/byte
// ridge, so the tensor cores bound it.  The design keeps them fed from
// on-chip copies:
//   * a block owns BM = 128 consecutive output voxels and ALL of cout (at
//     most 128), so each gathered input tile is read once; its K loop walks
//     (tap, 32-channel chunk) stages;
//   * each stage's A tile (128 voxel rows x 32 channels, one 16-byte
//     cp.async per thread and row segment, zero-filled where the tap leaves
//     the volume) and B tile (cout x 32 weights) land in shared memory
//     through a 3-deep cp.async ring (dynamic shared memory, 61 KB at cout
//     128), so the next stages' loads overlap the current stage's math;
//   * four warps each compute a 32 x cout sub-tile with mma.sync m16n8k16
//     bf16 -> f32 fragments; rows are padded to 40 elements so the 32-bit
//     fragment loads hit 32 distinct banks.
// TMA, wgmma and warp specialisation are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output voxels per block
constexpr int BK = 32;        // input channels of one tap per stage
constexpr int LDS = BK + 8;   // padded shared-memory row, in elements
constexpr int STAGES = 3;
constexpr int THREADS = 128;  // four warps, each 32 voxel rows x all of cout

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // a source size of 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int COUT>
constexpr int smem_bytes() {
  return STAGES * (BM + COUT) * LDS * static_cast<int>(sizeof(__nv_bfloat16));
}

// x: (B, D, H, W, cin) bf16; wt: (27, COUT, cin) bf16, tap-major, channel
// contiguous; bias: (COUT,) f32 or null; y: (B, D, H, W, COUT) bf16.
template <int COUT>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int D, int H,
               int W, int cin, long long M) {
  constexpr int NT = COUT / 8;     // n8 fragment columns per warp
  constexpr int BROWS = COUT / 32;  // B rows each thread copies per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [STAGES][BM * LDS]
  __nv_bfloat16* Bs = As + STAGES * BM * LDS;                       // [STAGES][COUT * LDS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = lane >> 2;  // fragment row (A, C) or column (B)
  const int tig = lane & 3;     // thread in group
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;

  // Each thread copies one 16-byte segment (8 channels) of four A rows and
  // COUT / 32 B rows per stage; the rows stay fixed across stages, so their
  // coordinates are decoded once.
  const int seg = tid & 3;
  int rz[4], ry[4], rx[4];
  long long rm[4];
  bool rvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + (tid >> 2) + 32 * i;
    rvalid[i] = m < M;
    rm[i] = m;
    long long t = m;
    rx[i] = static_cast<int>(t % W);
    t /= W;
    ry[i] = static_cast<int>(t % H);
    t /= H;
    rz[i] = static_cast<int>(t % D);
  }

  const int chunks = cin / BK;
  const int nk = 27 * chunks;

  auto load_stage = [&](int stage, int kt) {
    const int tap = kt / chunks;
    const int c0 = (kt - tap * chunks) * BK + seg * 8;
    const int dz = tap / 9 - 1;
    const int dy = (tap / 3) % 3 - 1;
    const int dx = tap % 3 - 1;
    const long long shift = (static_cast<long long>(dz) * H + dy) * W + dx;
    __nv_bfloat16* as = As + stage * BM * LDS;
    __nv_bfloat16* bs = Bs + stage * COUT * LDS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int zz = rz[i] + dz, yy = ry[i] + dy, xx = rx[i] + dx;
      const bool ok = rvalid[i] && zz >= 0 && zz < D && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const __nv_bfloat16* src = ok ? x + (rm[i] + shift) * cin + c0 : x;
      cp_async16(as + ((tid >> 2) + 32 * i) * LDS + seg * 8, src, ok);
    }
#pragma unroll
    for (int j = 0; j < BROWS; ++j) {
      const int n = (tid >> 2) + 32 * j;
      const __nv_bfloat16* src = wt + (static_cast<long long>(tap) * COUT + n) * cin + c0;
      cp_async16(bs + n * LDS + seg * 8, src, true);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next);
    cp_async_commit();

    const __nv_bfloat16* as = As + (kt % STAGES) * BM * LDS;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * COUT * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = as + (warp * 32 + mi * 16 + group) * LDS + kk + tig * 2;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * LDS);
        a[mi][2] = lds32(p + 8);
        a[mi][3] = lds32(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const __nv_bfloat16* p = bs + (ni * 8 + group) * LDS + kk + tig * 2;
        const uint32_t b[2] = {lds32(p), lds32(p + 8)};
        mma_16816(acc[0][ni], a[0], b);
        mma_16816(acc[1][ni], a[1], b);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = ni * 8 + tig * 2;
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + warp * 32 + mi * 16 + group + 8 * h;
        if (m < M) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[mi][ni][2 * h] + b0, acc[mi][ni][2 * h + 1] + b1);
          *reinterpret_cast<__nv_bfloat162*>(y + m * COUT + col) = v;
        }
      }
    }
  }
}

template <int COUT>
int launch(const void* x, const void* wt, const void* bias, void* y, int D, int H, int W,
           int cin, long long M, cudaStream_t stream) {
  constexpr int smem = smem_bytes<COUT>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (M + BM - 1) / BM;
  conv3x3_kernel<COUT><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), D, H, W, cin, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bias may be null.
extern "C" int nc_conv3x3_bf16(const void* x, const void* wt, const void* bias, void* y,
                               int batch, int D, int H, int W, int cin, int cout,
                               void* stream) {
  if (cin <= 0 || cin % BK != 0 || batch <= 0 || D <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(batch) * D * H * W;
  if ((M + BM - 1) / BM > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 32: return launch<32>(x, wt, bias, y, D, H, W, cin, M, s);
    case 64: return launch<64>(x, wt, bias, y, D, H, W, cin, M, s);
    case 96: return launch<96>(x, wt, bias, y, D, H, W, cin, M, s);
    case 128: return launch<128>(x, wt, bias, y, D, H, W, cin, M, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* nc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
