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
// with M = output voxels, N = cout, K = 27*cin, and taps outside the volume
// reading zero.
//
// Bound on the H100: 2 * 27 * cin * cout FLOP per voxel against
// 2 * (cin + cout) bytes moved: at the path's shapes (cin 64-256, cout
// 64-128) 580-2300 FLOP/byte, far above the card's ~295 bf16 FLOP/byte
// ridge, so the tensor cores bound it, as far as shared memory feeds them: a
// wgmma m64nNk16 with both operands in shared memory reads 2 (64 + N) * 16
// bytes for 2 * 64 * N * 16 FLOP, so its N should be large.  Here the
// GEMM's M is cout (the weights are wgmma's A) and its N the output voxels:
//   * a block owns a box of 2 x 28 x 8 (cout 32 or 64) or 1 x 14 x 8 (cout
//     96 or 128) output voxels in (z, y, x), and all of cout, padded to 64
//     or 128 (the padded rows are computed and dropped); two consumer
//     warpgroups each run wgmma m64n224k16 (m64n112k16) over one z-plane of
//     the box for one 64-row tile of cout, and one producer warp issues
//     every load;
//   * the K loop walks 32-channel stages of cin, and within a stage the 27
//     taps.  A stage's input tile is the haloed box, 4 x 30 x 10 (3 x 16 x 10)
//     voxels of 32 channels, loaded by four TMA tiled loads of the 5-D (B,
//     D, H, W, cin) tensor (an 8-channel box each) into wgmma's interleaved
//     K-major layout: for each 8-channel chunk, the voxels' 16-byte rows in
//     (z, y, x) order.  TMA fills coordinates outside the tensor, negative
//     ones included, with zeros: that fill is the SAME padding, and no
//     thread computes an address or a mask;
//   * a tap's B operand is a view into that tile: 8 consecutive x form a
//     core matrix, the y of a plane step by one halo row (160 bytes), the
//     two chunks of a k16 step by one chunk, and the tap's shift moves the
//     view's start by whole voxels.  Its A operand is the tap's (cout, 32)
//     slice of the (27 * cout, cin) weights, one 2-D TMA load into the
//     64-byte-swizzled K-major layout, through a ring of 6-8 stages (two
//     input stages alternate beside it);
//   * f32 accumulators in registers (112 or 56 a thread), one tap's MMAs left in
//     flight while the next tap's are issued; full and empty mbarriers per
//     stage of each ring;
//   * the epilogue adds the f32 bias, rounds once to bf16, gathers the
//     block's outputs in shared memory and stores those of the voxels that
//     lie inside the volume in 16-byte pieces.
// The input is loaded once per channel stage for all 27 taps.  At cout 96
// and 128 two blocks share an SM (~110 KB of shared memory each), so one
// block's ring fill and epilogue overlap the other's MMAs; at cout 32 and
// 64 one block (~183 KB) runs the wider N, which measured faster.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BX = 8;                 // x extent of the output box: one core matrix
constexpr int HX = BX + 2;
constexpr int KC = 32;                // input channels per stage
constexpr int CONSUMERS = 2;          // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr int TAPS = 27;

// MT 64-row tiles of cout: MT = 1 gives the block two z-planes of 28 x 8
// voxels (one per warpgroup, 112 accumulators a thread, one block per SM),
// MT = 2 one plane of 14 x 8 and one cout tile per warpgroup (56
// accumulators, two blocks per SM).  28 and 14 divide the 140^3 and 70^3
// tiles of inference.
template <int COUT>
struct Plan {
  static constexpr int MT = COUT > 64 ? 2 : 1;
  static constexpr int BLOCKS_PER_SM = MT;
  static constexpr int SMEM_BUDGET = MT == 1 ? 216 * 1024 : 108 * 1024;
  static constexpr int BZ = 2 / MT;
  static constexpr int BY = MT == 1 ? 28 : 14;
  static constexpr int HY = BY + 2;
  static constexpr int N = BY * BX;                            // the wgmma N: one plane
  static constexpr int NV = (BZ + 2) * HY * HX;                // haloed voxels
  static constexpr int CHUNK_BYTES = (NV * 16 + 127) / 128 * 128;  // 8 channels of them
  static constexpr int A_BYTES = CHUNK_BYTES * (KC / 8);        // one input stage
  static constexpr int W_BYTES = 64 * MT * KC * 2;              // one tap's weights
  static constexpr int W_OFFSET = (2 * A_BYTES + 1023) / 1024 * 1024;
  static constexpr int W_FIT = (SMEM_BUDGET - W_OFFSET) / W_BYTES;
  static constexpr int STAGES = W_FIT > 8 ? 8 : W_FIT;         // weight stages
  // the rings, 1024-byte alignment slack, then the barriers
  static constexpr int SMEM = W_OFFSET + STAGES * W_BYTES + 1024 + (2 + STAGES) * 2 * 8;
  static_assert(STAGES >= 2, "weight ring");
};

// xmap: (B, D, H, W, cin) bf16, box (1, BZ + 2, BY + 2, HX, 8), no swizzle;
// wmap: (27 * COUT, cin) bf16, box (64 MT, KC), 64-byte swizzle; bias:
// (COUT,) f32 or null; y: (B, D, H, W, COUT) bf16.  Blocks walk the boxes x
// fastest, then y, z and the batch.
template <int COUT>
__global__ void __launch_bounds__(THREADS, Plan<COUT>::BLOCKS_PER_SM)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int D, int H,
               int W, int cin, int nbz, int nby, int nbx) {
  using P = Plan<COUT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* wring = smem + P::W_OFFSET;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(wring + P::STAGES * P::W_BYTES);
  uint64_t* a_empty = a_full + 2;
  uint64_t* w_full = a_empty + 2;
  uint64_t* w_empty = w_full + P::STAGES;

  int id = blockIdx.x;
  const int x0 = (id % nbx) * BX;
  id /= nbx;
  const int y0 = (id % nby) * P::BY;
  id /= nby;
  const int z0 = (id % nbz) * P::BZ;
  const int b = id / nbz;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&a_full[s], 1);
      hopper::mbar_init(&a_empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < P::STAGES; ++s) {
      hopper::mbar_init(&w_full[s], 1);
      hopper::mbar_init(&w_empty[s], CONSUMERS * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int cstages = cin / KC;

  if (warp == CONSUMERS * 4) {
    // producer: one thread issues every TMA load
    if (lane == 0) {
      int kt = 0;
      for (int cs = 0; cs < cstages; ++cs) {
        const int a = cs & 1;
        hopper::mbar_wait(&a_empty[a], ((cs >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&a_full[a], KC / 8 * (P::NV * 16));
        for (int ch = 0; ch < KC / 8; ++ch)
          hopper::tma_load_5d(smem + a * P::A_BYTES + ch * P::CHUNK_BYTES, &xmap, &a_full[a],
                              cs * KC + ch * 8, x0 - 1, y0 - 1, z0 - 1, b);
        for (int tap = 0; tap < TAPS; ++tap, ++kt) {
          const int s = kt % P::STAGES;
          hopper::mbar_wait(&w_empty[s], ((kt / P::STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&w_full[s], P::W_BYTES);
          hopper::tma_load_2d(wring + s * P::W_BYTES, &wmap, &w_full[s], cs * KC, tap * COUT);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns cout tile wg % MT of z-plane wg / MT
  const int wg = warp >> 2;
  const int mt = wg % P::MT, plane = wg / P::MT;
  float acc[P::N / 2];
#pragma unroll
  for (int i = 0; i < P::N / 2; ++i) acc[i] = 0.f;

  int kt = 0;
  for (int cs = 0; cs < cstages; ++cs) {
    const int a = cs & 1;
    hopper::mbar_wait(&a_full[a], (cs >> 1) & 1);
    const uint32_t abase = hopper::smem_addr(smem + a * P::A_BYTES);
    for (int tap = 0; tap < TAPS; ++tap, ++kt) {
      const int s = kt % P::STAGES;
      hopper::mbar_wait(&w_full[s], (kt / P::STAGES) & 1);
      // the tap's view: output voxel (plane, y, x) of the box reads haloed
      // voxel (plane + dz, y + dy, x + dx), with dz, dy, dx in 0..2
      const int v0 = ((plane + tap / 9) * P::HY + (tap / 3) % 3) * HX + tap % 3;
      const uint32_t xv = abase + v0 * 16;
      const uint32_t wv = hopper::smem_addr(wring + s * P::W_BYTES) + mt * 64 * KC * 2;
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        // A, the weights: k16 step ks starts 32 bytes further into each
        // 64-byte swizzled row; B, the input view: two chunks further on
        const uint64_t da = hopper::make_desc(wv + ks * 32, 16, 8 * KC * 2, hopper::kSwizzle64B);
        const uint64_t db = hopper::make_desc(xv + ks * 2 * P::CHUNK_BYTES, P::CHUNK_BYTES,
                                              HX * 16, hopper::kInterleave);
        hopper::Wgmma<P::N, 0, 0>::run(acc, da, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous tap's MMAs are done with their tiles
      if (kt > 0 && lane == 0) {
        hopper::mbar_arrive(&w_empty[(kt - 1) % P::STAGES]);
        if (tap == 0) hopper::mbar_arrive(&a_empty[(cs - 1) & 1]);  // stage cs - 1 is done
      }
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // The block's output goes through shared memory, (voxel of the box, COUT)
  // bf16, so that it leaves in 16-byte pieces: the input ring is free once
  // both warpgroups' MMAs are done.  Thread t holds output channels co (+ 8)
  // of voxels 8 j + 2 (t % 4) (+ 1) of its plane.
  constexpr int BOX = P::BZ * P::BY * BX;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  hopper::named_barrier_sync(1, CONSUMERS * 128);
  const int co = mt * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (co + 8 * h >= COUT) continue;  // a padded row
    const float bs = bias ? bias[co + 8 * h] : 0.f;
#pragma unroll
    for (int j = 0; j < P::BY; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tile[(plane * P::N + 8 * j + 2 * (lane & 3) + e) * COUT + co + 8 * h] =
            __float2bfloat16_rn(acc[4 * j + 2 * h + e] + bs);
  }
  hopper::named_barrier_sync(1, CONSUMERS * 128);
  constexpr int PIECES = COUT / 8;  // 16-byte pieces of a voxel's outputs
  for (int i = threadIdx.x; i < BOX * PIECES; i += CONSUMERS * 128) {
    const int v = i / PIECES, piece = i - v * PIECES;
    const int xx = x0 + v % BX, yy = y0 + (v / BX) % P::BY, zz = z0 + v / P::N;
    if (xx >= W || yy >= H || zz >= D) continue;
    *reinterpret_cast<uint4*>(
        y + ((((static_cast<long long>(b) * D + zz) * H + yy) * W + xx) * COUT) + 8 * piece) =
        *reinterpret_cast<const uint4*>(tile + v * COUT + 8 * piece);
  }
}

template <int COUT>
int launch(const void* x, const void* wt, const void* bias, void* y, int batch, int D, int H,
           int W, int cin, cudaStream_t stream) {
  using P = Plan<COUT>;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[5] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(W),
                             static_cast<uint64_t>(H), static_cast<uint64_t>(D),
                             static_cast<uint64_t>(batch)};
  const uint64_t row = static_cast<uint64_t>(cin) * 2;
  const uint64_t xstrides[4] = {row, row * W, row * W * H, row * W * H * D};
  const uint32_t xbox[5] = {8, HX, P::HY, P::BZ + 2, 1};
  int err = hopper::encode_bf16(&xmap, x, 5, xdims, xstrides, xbox, hopper::kInterleave);
  if (err) return err;
  const uint64_t wdims[2] = {static_cast<uint64_t>(cin), 27ull * COUT};
  const uint64_t wstrides[1] = {row};
  const uint32_t wbox[2] = {KC, 64 * P::MT};
  err = hopper::encode_bf16(&wmap, wt, 2, wdims, wstrides, wbox, hopper::kSwizzle64B);
  if (err) return err;

  cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<COUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nbz = (D + P::BZ - 1) / P::BZ, nby = (H + P::BY - 1) / P::BY;
  const int nbx = (W + BX - 1) / BX;
  const long long blocks = static_cast<long long>(batch) * nbz * nby * nbx;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_kernel<COUT><<<static_cast<unsigned>(blocks), THREADS, P::SMEM, stream>>>(
      xmap, wmap, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), D, H, W, cin,
      nbz, nby, nbx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch, D, H, W, cin) bf16; wt: (27, cout, cin) bf16, tap-major, channel
// contiguous; bias: (cout,) f32 or null; y: (batch, D, H, W, cout) bf16.  kc
// (the channels per stage) and the output box (bz, by, bx) of a block are
// the kernel's own, 32 and (2, 28, 8) or (1, 14, 8) for cout up to 64 or
// above: the caller's plan must name them.  x and wt 16-byte aligned.
extern "C" int nc_conv3x3_bf16(const void* x, const void* wt, const void* bias, void* y,
                               int batch, int D, int H, int W, int cin, int cout, int kc, int bz,
                               int by, int bx, void* stream) {
  if (cin <= 0 || batch <= 0 || D <= 0 || H <= 0 || W <= 0 || kc != KC || cin % KC != 0 ||
      bz != (cout > 64 ? 1 : 2) || by != (cout > 64 ? 14 : 28) || bx != BX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 32: return launch<32>(x, wt, bias, y, batch, D, H, W, cin, s);
    case 64: return launch<64>(x, wt, bias, y, batch, D, H, W, cin, s);
    case 96: return launch<96>(x, wt, bias, y, batch, D, H, W, cin, s);
    case 128: return launch<128>(x, wt, bias, y, batch, D, H, W, cin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* nc_error_string(int code) { return hopper::error_string(code); }
