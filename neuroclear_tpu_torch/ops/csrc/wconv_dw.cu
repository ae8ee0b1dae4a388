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
//     voxels (1.26 M at 108^3).  A block owns 128 rows (two 64-row halves,
//     each one tap and 64 channels) by all 64 o, over one chunk of voxel
//     boxes; grid.y walks the chunks, and each block writes its f32 partial
//     tile;
//   * a second kernel adds the chunks' partials in chunk order and writes
//     (27, 64, cin), so the result does not change from run to run.
//
// Bound on the H100: 2 * 27 * cin * 64 FLOP per voxel, against 2 * (cin + 64)
// bytes read per voxel: ~440 (cin 64) to ~580 (cin 128) FLOP/byte, above the
// card's ~295 bf16 FLOP/byte ridge, so the tensor cores bound it.  The design:
//   * the K tile is a box of BK = 128 voxels, (bz, by, bx) in (z, y, x).  A
//     stage is three TMA tiled loads of the 5-D tensors: g at the box, and x
//     at the box shifted by each half's tap, 64 channels each.  TMA fills
//     coordinates outside the tensor with zeros: the shifted x reads zero
//     where a tap leaves the volume, and g reads zero past the volume's
//     edge, so the ragged boxes add nothing;
//   * both operands arrive in their natural (voxel, channel) layout, 128-byte
//     rows under the 128-byte swizzle: the voxel axis, the GEMM's K, is the
//     strided one.  wgmma reads them MN-major (its transpose immediates), so
//     nothing is transposed by hand;
//   * one producer warp keeps a ring of STAGES stages in flight (full and
//     empty mbarriers per stage), its one issuing thread stepping the box
//     coordinates by increments: a 64-bit division per stage there held the
//     whole kernel near 350 TFLOP/s; two consumer warpgroups, one per half,
//     run wgmma m64n64k16, f32 accumulators in registers;
//   * blocks that share a chunk (the row tiles, grid.x) are adjacent in the
//     launch order, so their shifted reads of the same voxels meet in L2.
// One block per SM: a ring of four 48 KB stages (~193 KB of shared memory),
// which measured faster than two blocks of half the depth.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 64;            // output channels o (all of them)
constexpr int BK = 128;           // voxels per stage: one box
constexpr int TAPS = 27;
constexpr int CONSUMERS = 2;      // warpgroups: one 64-row half each
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int OP_BYTES = BK * 64 * 2;          // one operand tile: 128 voxels x 64 channels
constexpr int STAGE_BYTES = 3 * OP_BYTES;      // x half 0, x half 1, g
constexpr int STAGES = 4;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

// xmap: (B, D, H, W, cin) bf16, box (1, bz, by, bx, 64); gmap: (B, D, H, W,
// 64) bf16, the same box; part: (chunks, 27 * cin, 64) f32.  grid (row tiles,
// chunks); chunk k owns boxes [k * per_chunk, (k + 1) * per_chunk), boxes
// numbered x fastest, then y, z and the batch.
__global__ void __launch_bounds__(THREADS, 1)
wconv_dw_partial(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                 float* __restrict__ part, int cin, int bz, int by, int bx, int nbz, int nby,
                 int nbx, int nboxes, int per_chunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int rowblocks = TAPS * cin / 64;  // 64-row halves of the (tap, c) rows
  const int k_begin = blockIdx.y * per_chunk;  // chunks * per_chunk fits an int
  const int nk = max(0, min(nboxes, k_begin + per_chunk) - k_begin);

  if (warp == CONSUMERS * 4) {
    // producer: one thread issues every TMA load
    if (lane == 0) {
      int tap[CONSUMERS], c0[CONSUMERS];
      for (int h = 0; h < CONSUMERS; ++h) {
        const int rb = 2 * blockIdx.x + h;
        // a half past the last row loads a valid tile and discards its sums
        tap[h] = rb < rowblocks ? rb * 64 / cin : 0;
        c0[h] = rb < rowblocks ? rb * 64 - tap[h] * cin : 0;
      }
      // the chunk's first box, then one step per stage, x fastest
      int ix = k_begin % nbx, iy = k_begin / nbx % nby, iz = k_begin / nbx / nby % nbz;
      int b = k_begin / nbx / nby / nbz;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        const int x0 = ix * bx, y0 = iy * by, z0 = iz * bz;
        unsigned char* st = smem + s * STAGE_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        for (int h = 0; h < CONSUMERS; ++h) {
          const int t = tap[h];
          hopper::tma_load_5d(st + h * OP_BYTES, &xmap, &full[s], c0[h], x0 + t % 3 - 1,
                              y0 + (t / 3) % 3 - 1, z0 + t / 9 - 1, b);
        }
        hopper::tma_load_5d(st + 2 * OP_BYTES, &gmap, &full[s], 0, x0, y0, z0, b);
        if (++ix == nbx) {
          ix = 0;
          if (++iy == nby) {
            iy = 0;
            if (++iz == nbz) {
              iz = 0;
              ++b;
            }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup h owns the 64 rows of row block 2 blockIdx.x + h
  const int h = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t a = hopper::smem_addr(smem + s * STAGE_BYTES + h * OP_BYTES);
    const uint32_t bb = hopper::smem_addr(smem + s * STAGE_BYTES + 2 * OP_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // 16 voxels = two 8-voxel swizzle atoms of 1024 bytes further on
      const uint64_t da = hopper::make_desc(a + ks * 2048, 1024, 1024, hopper::kSwizzle128B);
      const uint64_t db = hopper::make_desc(bb + ks * 2048, 1024, 1024, hopper::kSwizzle128B);
      hopper::Wgmma<BN, 1, 1>::run(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // stage kt - 1's MMAs are done with its buffers
    if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int rb = 2 * blockIdx.x + h;
  if (rb >= rowblocks) return;
  const int rows = TAPS * cin;
  float* out = part + static_cast<long long>(blockIdx.y) * rows * BN;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rb * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * hh;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(out + static_cast<long long>(r) * BN + col) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
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

// x: (batch, D, H, W, cin) bf16, cin a multiple of 64; g: (batch, D, H, W,
// 64) bf16; part: (chunks, 27 * cin, 64) f32 scratch; dw: (27, 64, cin) f32.
// (bz, by, bx) is the voxel box of a pipeline stage, bz * by * bx = 64, and
// chunk k sums boxes [k * per_chunk, (k + 1) * per_chunk) of the
// batch * ceil(D / bz) * ceil(H / by) * ceil(W / bx) boxes, which the chunks
// must cover.  x and g 16-byte aligned.
extern "C" int nc_wconv_dw_bf16(const void* x, const void* g, void* part, void* dw, int batch,
                                int D, int H, int W, int cin, int chunks, int bz, int by, int bx,
                                int per_chunk, void* stream) {
  if (cin <= 0 || cin % 64 != 0 || batch <= 0 || D <= 0 || H <= 0 || W <= 0 || chunks <= 0 ||
      chunks > 65535 || per_chunk <= 0 || bz <= 0 || by <= 0 || bx <= 0 || bz > 256 ||
      by > 256 || bx > 256 || bz * by * bx != BK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nbz = (D + bz - 1) / bz, nby = (H + by - 1) / by, nbx = (W + bx - 1) / bx;
  const long long nboxes = static_cast<long long>(batch) * nbz * nby * nbx;
  const long long covered = static_cast<long long>(chunks) * per_chunk;
  if (covered > 0x7fffffffLL || covered < nboxes)
    return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap xmap, gmap;
  const uint32_t box[5] = {64, static_cast<uint32_t>(bx), static_cast<uint32_t>(by),
                           static_cast<uint32_t>(bz), 1};
  uint64_t dims[5] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(W),
                      static_cast<uint64_t>(H), static_cast<uint64_t>(D),
                      static_cast<uint64_t>(batch)};
  uint64_t row = static_cast<uint64_t>(cin) * 2;
  uint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  int err = hopper::encode_bf16(&xmap, x, 5, dims, strides, box, hopper::kSwizzle128B);
  if (err) return err;
  dims[0] = BN;
  row = BN * 2;
  const uint64_t gstrides[4] = {row, row * W, row * W * H, row * W * H * D};
  err = hopper::encode_bf16(&gmap, g, 5, dims, gstrides, box, hopper::kSwizzle128B);
  if (err) return err;

  cudaError_t e =
      cudaFuncSetAttribute(wconv_dw_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (TAPS * cin / 64 + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wconv_dw_partial<<<dim3(tiles, chunks), THREADS, SMEM, s>>>(
      xmap, gmap, static_cast<float*>(part), cin, bz, by, bx, nbz, nby, nbx,
      static_cast<int>(nboxes), per_chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(TAPS) * cin * BN;
  const long long blocks = (total + 255) / 256;
  wconv_dw_combine<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), cin, chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nc_error_string(int code) { return hopper::error_string(code); }
