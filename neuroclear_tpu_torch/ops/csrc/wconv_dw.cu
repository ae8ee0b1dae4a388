// Weight gradient of the 3x3x3, stride-1, SAME convolution: NDHWC bf16 input
// x and bf16 cotangent g (64 channels) in, f32 accumulation, f32 out in the
// kernel's packed (27, 64, cin) layout:
//   dw[tap, o, c] = sum_{b,z,y,x} x[b, (z,y,x) + shift(tap), c] * g[b, z, y, x, o]
// with taps that leave the volume reading zero.
//
// Replaces neuroclear_tpu/ops/pallas_wconv.py::_dw_kernel (launched by
// _dw_pallas, folded by _dw_unpack).  The TPU kernel carries one
// (18, 2*cin, 128) accumulator in VMEM across its sequential grid; Hopper
// blocks run in no order, so here the long reduction over voxels is split:
//   * it is a GEMM with M = 27*cin rows (tap, c), N = 64 (o) and K = the
//     B*D*H*W voxels (1.26 M at 108^3).  A block owns BM = 128 rows (tap, c)
//     by all 64 o, over one contiguous chunk of voxels; grid.y splits the
//     voxels into chunks, and each block writes its f32 partial tile;
//   * a second kernel adds the chunks' partials in chunk order and writes
//     (27, 64, cin), so the result does not change from run to run.
//
// Bound on the H100: 2 * 27 * cin * 64 FLOP per voxel, against 2 * (cin + 64)
// bytes read per voxel: ~440 (cin 64) to ~580 (cin 128) FLOP/byte, above the
// card's ~295 bf16 FLOP/byte ridge, so the tensor cores bound it.  The design:
//   * each stage brings 32 voxels of the shifted x (32 x 128 row segments,
//     zero-filled off the volume) and of g (32 x 64) into shared memory with
//     16-byte cp.async through a 3-deep ring, in their natural
//     voxel-major layout;
//   * both operands need the voxel axis as the MMA's K axis, which is the
//     strided one in memory, so fragments come from ldmatrix.trans;
//     rows are padded by 16 bytes so the eight row addresses of each 8x8
//     matrix fall in distinct bank groups;
//   * four warps each compute a 32 x 64 sub-tile with mma.sync m16n8k16
//     bf16 -> f32.
// TMA, wgmma and a fused partial reduction are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // (tap, c) rows per block
constexpr int BN = 64;        // output channels o (all of them)
constexpr int BK = 32;        // voxels per stage
constexpr int LDA = BM + 8;   // padded shared-memory rows, in elements
constexpr int LDB = BN + 8;
constexpr int STAGES = 3;
constexpr int THREADS = 128;  // four warps, each 32 rows x 64 o
constexpr int TAPS = 27;

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

// Four transposed 8x8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x: (M voxels, cin) bf16 over (B, D, H, W); g: (M, 64) bf16;
// part: (chunks, 27 * cin, 64) f32.  grid (row tiles, chunks).
__global__ void __launch_bounds__(THREADS)
wconv_dw_partial(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                 float* __restrict__ part, int D, int H, int W, int cin, int M,
                 int voxels_per_chunk) {
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][BK * LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[STAGES][BK * LDB];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = lane >> 2;
  const int tig = lane & 3;
  const int rows = TAPS * cin;
  const int r0 = blockIdx.x * BM;
  const int k_begin = blockIdx.y * voxels_per_chunk;
  const int k_end = min(M, k_begin + voxels_per_chunk);

  // A loads: each thread copies row segment aseg (8 of the tile's 128
  // (tap, c) rows) for voxels arow + 8 i.  The segment lies inside one tap
  // (cin is a multiple of 8), so its tap and shift are fixed for the block.
  const int aseg = tid & 15;
  const int arow = tid >> 4;
  const int ar = r0 + aseg * 8;
  const bool a_live = ar < rows;
  const int tap = a_live ? ar / cin : 0;
  const int ac = ar - tap * cin;
  const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
  const int shift = (dz * H + dy) * W + dx;
  // B loads: segment bseg (8 of the 64 o) for voxels brow + 16 j
  const int bseg = tid & 7;
  const int brow = tid >> 3;

  // (z, y, x) of each A row's next voxel, decoded once and then advanced by
  // BK voxels per stage (stages are loaded in order)
  int vz[4], vy[4], vx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k_begin + arow + 8 * i;
    vx[i] = k % W;
    vy[i] = (k / W) % H;
    vz[i] = (k / W / H) % D;
  }

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + arow + 8 * i;
      const int zz = vz[i] + dz, yy = vy[i] + dy, xx = vx[i] + dx;
      const bool ok = a_live && k < k_end && zz >= 0 && zz < D && yy >= 0 && yy < H &&
                      xx >= 0 && xx < W;
      const __nv_bfloat16* src = ok ? x + static_cast<long long>(k + shift) * cin + ac : x;
      cp_async16(&As[stage][(arow + 8 * i) * LDA + aseg * 8], src, ok);
      vx[i] += BK;
      while (vx[i] >= W) {
        vx[i] -= W;
        if (++vy[i] == H) {
          vy[i] = 0;
          if (++vz[i] == D) vz[i] = 0;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + brow + 16 * j;
      const bool ok = k < k_end;
      const __nv_bfloat16* src = ok ? g + static_cast<long long>(k) * BN + bseg * 8 : g;
      cp_async16(&Bs[stage][(brow + 16 * j) * LDB + bseg * 8], src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const int nk = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, k_begin + s * BK);
    cp_async_commit();
  }

  // ldmatrix lane roles: matrix lane / 8, its row lane % 8
  const int lm = lane >> 3;
  const int lr = lane & 7;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, k_begin + next * BK);
    cp_async_commit();

    const __nv_bfloat16* as = As[kt % STAGES];
    const __nv_bfloat16* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // A[m][k] = As[k][m]: matrices (k, m), (k, m + 8), (k + 8, m), (k + 8, m + 8)
        const int m = warp * 32 + mi * 16 + (lm & 1) * 8;
        ldmatrix_x4_trans(a[mi], as + (kk + lr + (lm >> 1) * 8) * LDA + m);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ni += 2) {
        // B[k][n] = Bs[k][n]: matrices (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + lr + (lm & 1) * 8) * LDB + (ni + (lm >> 1)) * 8);
        b[ni][0] = r[0];
        b[ni][1] = r[1];
        b[ni + 1][0] = r[2];
        b[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  float* out = part + static_cast<long long>(blockIdx.y) * rows * BN;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * 32 + mi * 16 + group + 8 * h;
      if (r < rows) {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = ni * 8 + tig * 2;
          *reinterpret_cast<float2*>(out + static_cast<long long>(r) * BN + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
      }
    }
  }
}

// dw[tap, o, c] = sum over chunks, in chunk order, of part[chunk, tap*cin + c, o].
__global__ void __launch_bounds__(256)
wconv_dw_combine(const float* __restrict__ part, float* __restrict__ dw, int cin, int chunks) {
  const int rows = TAPS * cin;
  const long long total = static_cast<long long>(rows) * BN;
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[k * total + i];
    const int r = static_cast<int>(i / BN), o = static_cast<int>(i % BN);
    const int tap = r / cin, c = r - tap * cin;
    dw[(static_cast<long long>(tap) * BN + o) * cin + c] = s;
  }
}

}  // namespace

// x: (batch, D, H, W, cin) bf16; g: (batch, D, H, W, 64) bf16;
// part: (chunks, 27 * cin, 64) f32 scratch; dw: (27, 64, cin) f32.
extern "C" int nc_wconv_dw_bf16(const void* x, const void* g, void* part, void* dw, int batch,
                                int D, int H, int W, int cin, int chunks, void* stream) {
  const long long M = static_cast<long long>(batch) * D * H * W;
  if (cin <= 0 || cin % 8 != 0 || batch <= 0 || D <= 0 || H <= 0 || W <= 0 || chunks <= 0 ||
      chunks > 65535 || M > 0x7fffffffLL - 2LL * H * W)
    return static_cast<int>(cudaErrorInvalidValue);
  const int voxels_per_chunk = static_cast<int>(((M + chunks - 1) / chunks + BK - 1) / BK * BK);
  const int tiles = (TAPS * cin + BM - 1) / BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wconv_dw_partial<<<dim3(tiles, chunks), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<float*>(part), D, H, W, cin, static_cast<int>(M), voxels_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(TAPS) * cin * BN;
  const long long blocks = (total + 255) / 256;
  wconv_dw_combine<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), cin, chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
