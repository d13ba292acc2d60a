// The irCSN stem in one pass on Hopper: conv 3x7x7 / stride (1,2,2) / pad
// (1,3,3), 3 -> 64 channels, then per-channel scale and bias (folded BN),
// ReLU and the 1x3x3 / stride (1,2,2) / pad (0,1,1) max-pool. Channels-last
// in and out: x (B,T,H,W,3) -> out (B,T,Hp,Wp,64).
//
// Replaces the two TPU kernels of tubelet_transformer_tpu/ops/pallas/stem.py
// that stem_forward runs: K1 `_deinterleave` (a lane permutation of the
// padded frames into W-parity-split blocks, done on the TPU as a one-hot
// matmul) and K2 `_stem_matmul(pool=True)`. K1 exists only for the TPU's
// lane layout; here the same gather is the block's load of its input halo
// into shared memory, with the zero padding applied as it is loaded.
//
// What bounds it: at the flagship shape (1,32,256,256,3) the conv is
// 2*32*128*128*64*441 = 29.6 GFLOP against 12.6 MB of bf16 input and
// 16.8 MB of bf16 output, about 1000 FLOP per byte: bound by operations, on
// the tensor cores in bf16 (30 us at 989 TFLOP/s). The pre-pool conv tensor
// (67 MB in bf16) never goes to device memory: each block keeps its conv
// tile in shared memory and pools it there.
//
// bf16 (stem_pool_tc_kernel, every model path): the implicit GEMM of
// stem_tc.cuh on the tensor cores, shared with the statistics kernel
// (stem_stats.cu). A work item is one (b, t) and an 8x8 tile of pooled
// outputs, so a 17x17 conv tile: M = 289 conv pixels (19 row tiles of 16),
// N = 64, K = 480. The grid is persistent, one block of 16 warps per SM.
// Scale, bias and ReLU run on the float32 accumulators; the conv tile is
// kept in shared memory in bf16 and max-pooled there: rounding is monotone,
// so the max of bf16-rounded values equals the bf16 rounding of the max.
//
// float32 (stem_pool_kernel, float32 models and tests): the direct conv on
// the CUDA cores in f32 (stem_conv.cuh), a 17x17 conv tile per block.
//
// Both pooled kernels run on a row window (spatial parallelism, where each
// model peer holds a band of the clip's rows): x is a slab of the clip's
// global input rows [row0, row0 + rows) (tuber_stem::Slab), the launch
// writes the global pooled rows [out0, out0 + out_rows), and the zero
// padding of the conv and the 0 that stands for the pool's -inf padding
// stay at the clip's border, where a peer's edge finds its halo rows
// instead. A pooled row p reads input rows 4p - 5 .. 4p + 5. Every output
// pixel is summed in the same order wherever its tile starts, so the rows
// of a window equal the same rows of the whole clip bit for bit.
//
// The unpooled kernels here are the same conv with the affine (and the ReLU
// when asked) and no pool, channels-mid out: x (B,T,H,W,3) -> out
// (B,T,64,Hc,Wc). They replace `_stem_matmul(pool=False)` of
// tubelet_transformer_tpu/ops/pallas/stem.py, which `stem_conv_bn_relu` runs
// there; no model path of either package calls it. At (1,32,256,256,3) the
// conv must write 67 MB of bf16 (20 us at 3.35 TB/s) for 29.6 GFLOP (30 us
// at the bf16 tensor-core peak): the operations bound it.
//
// bf16 (stem_conv_tc_kernel): the statistics kernel's implicit GEMM
// (stem_tc.cuh, stem_stats.cu) on 16x16 conv tiles that do not overlap,
// 16 row tiles of one conv row each, 4 a warp, in a persistent grid of 16
// warps a block; stored instead of reduced. The epilogue is the pooled
// kernel's (affine_relu on the float32 sums, one rounding to bf16), so a
// 1x3x3 / (1,2,2) max-pool of this output equals stem_pool_tc_kernel's
// bit for bit: both sum each conv pixel's A row against the same B columns
// in the same k order, and an mma's result for one element does not depend
// on the fragment row it sits in. The tile goes through a [64 channels][16
// rows][16 px] bf16 stage (channel rows 264 elements apart, so the four
// channel pairs of a fragment store hit distinct banks) and leaves as
// 16-byte vectors, each channel row of 16 px one whole 32-byte sector; the
// stores of one tile drain while the next tile's GEMM runs.
//
// float32 (stem_conv_kernel, tests only): the direct conv on the CUDA cores
// (stem_conv.cuh) on 16x16 conv tiles, through shared memory as
// [channel][pixel] (rows of 257 floats, so the eight channel groups of a
// warp hit distinct banks), each channel's rows of 16 pixels written
// contiguously.

#include <cstdint>

#include "stem_conv.cuh"
#include "stem_tc.cuh"

namespace {

using namespace tuber_stem;

constexpr int kPT = 8;                        // pooled tile edge
constexpr int kCT = 2 * kPT + 1;              // conv tile edge: 17
constexpr int kConvPix = kCT * kCT;           // 289
constexpr int kPixPerThread = pix_per_thread(kCT);                      // 10
constexpr int kConvElems = kConvPix * kCout;  // 18496
constexpr int kSmemFloats = conv_smem_floats(kCT) > kConvElems
                                ? conv_smem_floats(kCT) : kConvElems;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// max that keeps a NaN, as torch's max-pool does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Conv pixels pg, pg+32, ..., pg+288 of the 17x17 tile (stem_conv.cuh).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int frames, Slab slab, int W, int Hc, int Wc, int Wp,
                 int out0, int out_rows, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float* conv_s = smem;            // [kConvPix][64], after the accumulation

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;       // b * frames + t
  const int t = bt % frames;
  const int py0 = out0 + (blockIdx.x / tiles_x) * kPT;   // a global row
  const int px0 = (blockIdx.x % tiles_x) * kPT;
  const int cy0 = 2 * py0 - 1;     // first conv row of the tile
  const int cx0 = 2 * px0 - 1;
  const int cg = tid % kChanGroups;
  const int pg = tid / kChanGroups;

  float acc[kPixPerThread][8];
  conv_tile<kCT>(x, w, smem, bt, t, frames, slab, W, cy0, cx0, acc);

  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = scale[channel_of(cg, j)];
    bi[j] = bias[channel_of(cg, j)];
  }
  __syncthreads();                 // halo and weights are no longer read
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = pg + k * kPixGroups;
    if (p >= kConvPix) continue;
    const int cy = cy0 + p / kCT;
    const int cx = cx0 + p % kCT;
    // Conv pixels outside the image are 0: every pool window holds its
    // in-image centre, and after the ReLU all values are >= 0, so a 0 there
    // pools like the -inf padding of the reference.
    const bool inside = cy >= 0 && cy < Hc && cx >= 0 && cx < Wc;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = fmaf(acc[k][j], sc[j], bi[j]);
      v[j] = inside ? (y < 0.f ? 0.f : y) : 0.f;   // ReLU that keeps a NaN
    }
    float* dst = conv_s + p * kCout + cg * 4;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 32) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();

  // 8x8 pooled pixels x 32 channel pairs; a warp stores one pixel's 64
  // channels, 128 contiguous bytes in bf16.
  for (int idx = tid; idx < kPT * kPT * (kCout / 2); idx += kThreads) {
    const int pix = idx / (kCout / 2);
    const int cp = idx % (kCout / 2);
    const int u = pix / kPT;
    const int v = pix % kPT;
    const int py = py0 + u;
    const int px = px0 + v;
    if (py >= out0 + out_rows || px >= Wp) continue;
    float m0 = 0.f, m1 = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const float2 q = *reinterpret_cast<const float2*>(
            conv_s + ((2 * u + a) * kCT + 2 * v + b) * kCout + 2 * cp);
        m0 = nan_max(m0, q.x);
        m1 = nan_max(m1, q.y);
      }
    store2(out + ((static_cast<size_t>(bt) * out_rows + py - out0) * Wp +
                  px) * kCout + 2 * cp,
           m0, m1);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int batch, int frames, int H, int W, int row0, int rows,
           int out0, int out_rows, void* stream) {
  const int Hc = (H - 1) / 2 + 1;   // conv 7 / stride 2 / pad 3
  const int Wc = (W - 1) / 2 + 1;
  const int Wp = (Wc - 1) / 2 + 1;  // pool 3 / stride 2 / pad 1
  const int tiles_y = (out_rows + kPT - 1) / kPT;
  const int tiles_x = (Wp + kPT - 1) / kPT;
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_y * tiles_x, batch * frames);
  stem_pool_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), frames, make_slab(row0, rows, H), W, Hc, Wc, Wp,
      out0, out_rows, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: the implicit GEMM (stem_tc.cuh) of the 17x17
// conv tile of an 8x8 pooled tile.
using bf16 = __nv_bfloat16;
using namespace tuber_stem_tc;
using HaloP = Halo<kCT>;                        // 39 rows of 117, stride 120
constexpr int kLdConv = kCout + 8;              // conv tile row stride
constexpr int kMTiles = (kConvPix + 15) / 16;   // 19 row tiles of 16
constexpr int kWarpTiles = 5;                   // row tiles of a warp: 5 or 4
constexpr size_t kConvBytes = static_cast<size_t>(kConvPix) * kLdConv * 2;
constexpr size_t kSmemTc = kWBytes + HaloP::kBytes + kConvBytes + kTabBytes;
static_assert(kConvBytes % 16 == 0, "shared sub-buffers stay 16-byte aligned");
static_assert(4 * kWarpTiles >= kMTiles, "four warp rows cover the tile");

// First input row and column of pooled tile `rem` of a frame, whose tiles
// start at global pooled row out0: 2 * (first conv row 2 py0 - 1) - 3.
__device__ __forceinline__ int2 pool_halo_origin(int rem, int tiles_x,
                                                 int out0) {
  return make_int2(4 * (out0 + (rem / tiles_x) * kPT) - 5,
                   4 * ((rem % tiles_x) * kPT) - 5);
}

__device__ __forceinline__ void fetch_pool_halo(
    unsigned short (&r)[HaloP::kPerThread], const unsigned short* x,
    int tile, int kt, int tiles_x, int tiles_hw, int frames, const Slab& slab,
    int W, int out0) {
  const int bt = tile / tiles_hw;
  const int2 o = pool_halo_origin(tile - bt * tiles_hw, tiles_x, out0);
  fetch_halo<kCT>(r, x, bt, kt, o.x, o.y, frames, slab, W);
}

// Persistent: block i takes tiles i, i + gridDim.x, ... of the B*T*tiles_hw
// (b, t, 8x8 pooled) tiles. Warp w owns output channels 16 (w % 4).. and
// row tiles 5 (w / 4).. of the conv tile.
__global__ void __launch_bounds__(kThreadsTc, 1)
stem_pool_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    int frames, Slab slab, int W, int Hc, int Wc, int Wp,
                    int out0, int out_rows, int tiles_x, int tiles_hw,
                    int tiles) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_tc);                     // [480][72]
  unsigned short* halo =
      reinterpret_cast<unsigned short*>(smem_tc + kWBytes);          // [3][39][120]
  bf16* conv_s =
      reinterpret_cast<bf16*>(smem_tc + kWBytes + HaloP::kBytes);    // [289][72]
  int* tab_off = reinterpret_cast<int*>(smem_tc + kWBytes + HaloP::kBytes +
                                        kConvBytes);                 // [80]
  uint32_t* tab_mask = reinterpret_cast<uint32_t*>(tab_off + kPairsF);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ng = (tid >> 5) & 3;
  const int mg = (tid >> 5) >> 2;

  load_weights_and_tables(w_s, w, tab_off, tab_mask, HaloP::kLd);
  int poff[kWarpTiles][2];          // halo offset of the rows g, g+8 owned
  pixel_offsets<kCT>(poff, mg, g);
  float sc[2][2], bi[2][2];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[ni][j] = scale[ng * 16 + ni * 8 + 2 * t4 + j];
      bi[ni][j] = bias[ng * 16 + ni * 8 + 2 * t4 + j];
    }

  unsigned short pre[HaloP::kPerThread];
  fetch_pool_halo(pre, xs, blockIdx.x, 0, tiles_x, tiles_hw, frames, slab, W,
                  out0);
  stash_halo<kCT>(pre, halo);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[kWarpTiles][2][4];
#pragma unroll
    for (int i = 0; i < kWarpTiles; ++i)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][ni][j] = 0.f;

    for (int kt = 0; kt < 3; ++kt) {
      // the next (tile, frame) goes into registers while this one multiplies
      const int nt = kt < 2 ? tile : tile + gridDim.x;
      const int nkt = kt < 2 ? kt + 1 : 0;
      if (nt < tiles)
        fetch_pool_halo(pre, xs, nt, nkt, tiles_x, tiles_hw, frames, slab, W,
                        out0);
      tuber_mma::cp_async_wait<0>();
      __syncthreads();              // frame kt's halo (and the weights) are in
      frame_products<kWarpTiles, kMTiles>(
          acc, halo + kt * HaloP::kFrameElems, w_s + kt * kSlotsF * kLdW,
          tab_off, tab_mask, poff, lane, mg, ng);
      // the buffer of frame nkt was last read two barriers ago
      if (nt < tiles) stash_halo<kCT>(pre, halo + nkt * HaloP::kFrameElems);
    }

    // affine + ReLU on the f32 sums, 0 outside the image (every pool window
    // holds its in-image centre and all values are >= 0, so a 0 pools like
    // the reference's -inf padding), into the bf16 conv tile
    const int bt = tile / tiles_hw;
    const int rem = tile - bt * tiles_hw;
    const int py0 = out0 + (rem / tiles_x) * kPT;   // a global row
    const int px0 = (rem % tiles_x) * kPT;
#pragma unroll
    for (int i = 0; i < kWarpTiles; ++i) {
      if (mg * kWarpTiles + i >= kMTiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mg * kWarpTiles + i) * 16 + g + 8 * h;
        if (p >= kConvPix) continue;
        const int cy = 2 * py0 - 1 + p / kCT;
        const int cx = 2 * px0 - 1 + p % kCT;
        const bool inside = cy >= 0 && cy < Hc && cx >= 0 && cx < Wc;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const float y0 = affine_relu(acc[i][ni][2 * h], sc[ni][0],
                                       bi[ni][0], true);
          const float y1 = affine_relu(acc[i][ni][2 * h + 1], sc[ni][1],
                                       bi[ni][1], true);
          *reinterpret_cast<__nv_bfloat162*>(conv_s + p * kLdConv + ng * 16 +
                                             ni * 8 + 2 * t4) =
              __floats2bfloat162_rn(inside ? y0 : 0.f, inside ? y1 : 0.f);
        }
      }
    }
    __syncthreads();
    // 8x8 pooled pixels x 32 channel pairs; a warp stores one pixel's 64
    // channels, 128 contiguous bytes
    for (int idx = tid; idx < kPT * kPT * (kCout / 2); idx += kThreadsTc) {
      const int pix = idx / (kCout / 2);
      const int cp = idx % (kCout / 2);
      const int u = pix / kPT;
      const int v = pix % kPT;
      const int py = py0 + u;
      const int px = px0 + v;
      if (py >= out0 + out_rows || px >= Wp) continue;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float2 q = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  conv_s + ((2 * u + a) * kCT + 2 * v + b) * kLdConv + 2 * cp));
          q0 = nan_max(q0, q.x);
          q1 = nan_max(q1, q.y);
        }
      store2(out + ((static_cast<size_t>(bt) * out_rows + py - out0) * Wp +
                    px) * kCout + 2 * cp,
             q0, q1);
    }
  }
}

int launch_tc(const void* x, const void* w, const void* scale,
              const void* bias, void* out, int batch, int frames, int H,
              int W, int row0, int rows, int out0, int out_rows,
              void* stream) {
  const int Hc = (H - 1) / 2 + 1;   // conv 7 / stride 2 / pad 3
  const int Wc = (W - 1) / 2 + 1;
  const int Wp = (Wc - 1) / 2 + 1;  // pool 3 / stride 2 / pad 1
  const int tiles_x = (Wp + kPT - 1) / kPT;
  const int tiles_hw = ((out_rows + kPT - 1) / kPT) * tiles_x;
  const long long tiles = static_cast<long long>(batch) * frames * tiles_hw;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<int> cache[kMaxDevices];
  int resident = 0;
  const cudaError_t err =
      resident_blocks(stem_pool_tc_kernel, kSmemTc, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);
  stem_pool_tc_kernel<<<blocks, kThreadsTc, kSmemTc,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(out), frames, make_slab(row0, rows, H), W, Hc, Wc,
      Wp, out0, out_rows, tiles_x, tiles_hw, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kCTc = 16;                      // unpooled conv tile edge
constexpr int kCPix = kCTc * kCTc;            // 256

// float32: conv pixels pg, pg+32, ..., pg+224 of the 16x16 tile
// (stem_conv.cuh), through shared memory as [channel][pixel].
constexpr int kLdC = kCPix + 1;               // [channel][pixel] row stride
constexpr int kSmemFloatsC = conv_smem_floats(kCTc) > kCout * kLdC
                                 ? conv_smem_floats(kCTc) : kCout * kLdC;

__global__ void __launch_bounds__(kThreads, 2)
stem_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int frames, int H, int W, int Hc, int Wc, int tiles_x,
                 int relu) {
  extern __shared__ __align__(16) float smem[];
  float* conv_s = smem;            // [64][kLdC], after the accumulation

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;       // b * frames + t
  const int t = bt % frames;
  const int cy0 = (blockIdx.x / tiles_x) * kCTc;
  const int cx0 = (blockIdx.x % tiles_x) * kCTc;
  const int cg = tid % kChanGroups;
  const int pg = tid / kChanGroups;

  float acc[pix_per_thread(kCTc)][8];
  conv_tile<kCTc>(x, w, smem, bt, t, frames, make_slab(0, H, H), W, cy0,
                  cx0, acc);

  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = scale[channel_of(cg, j)];
    bi[j] = bias[channel_of(cg, j)];
  }
  __syncthreads();                 // halo and weights are no longer read
#pragma unroll
  for (int k = 0; k < pix_per_thread(kCTc); ++k) {
    const int p = pg + k * kPixGroups;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float y = fmaf(acc[k][j], sc[j], bi[j]);
      conv_s[channel_of(cg, j) * kLdC + p] =
          relu ? (y < 0.f ? 0.f : y) : y;          // ReLU that keeps a NaN
    }
  }
  __syncthreads();

  // a warp stores two 16-pixel rows of one channel
  float* dst = out + static_cast<size_t>(bt) * kCout * Hc * Wc;
  for (int idx = tid; idx < kCout * kCPix; idx += kThreads) {
    const int c = idx / kCPix;
    const int p = idx % kCPix;
    const int cy = cy0 + p / kCTc;
    const int cx = cx0 + p % kCTc;
    if (cy >= Hc || cx >= Wc) continue;
    dst[(static_cast<size_t>(c) * Hc + cy) * Wc + cx] = conv_s[c * kLdC + p];
  }
}

int launch_conv_f32(const void* x, const void* w, const void* scale,
                    const void* bias, void* out, int batch, int frames, int H,
                    int W, int relu, void* stream) {
  const int Hc = (H - 1) / 2 + 1;   // conv 7 / stride 2 / pad 3
  const int Wc = (W - 1) / 2 + 1;
  const int tiles_y = (Hc + kCTc - 1) / kCTc;
  const int tiles_x = (Wc + kCTc - 1) / kCTc;
  const size_t smem = kSmemFloatsC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_y * tiles_x, batch * frames);
  stem_conv_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), frames, H, W, Hc, Wc, tiles_x, relu);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: the implicit GEMM (stem_tc.cuh) of 16x16 conv
// tiles, as stem_stats_tc_kernel runs it, stored through a bf16 stage.
using HaloC = Halo<kCTc>;                       // 37 rows of 111, stride 112
constexpr int kMTilesC = kCPix / 16;            // 16 row tiles: a conv row each
constexpr int kWarpTilesC = kMTilesC / 4;       // 4 a warp
constexpr int kLdStage = kCPix + 8;             // [channel] stride of the stage
constexpr size_t kStageBytes = static_cast<size_t>(kCout) * kLdStage * 2;
constexpr size_t kSmemConvTc =
    kWBytes + HaloC::kBytes + kTabBytes + kStageBytes;
// two channels apart is 2 * kLdStage / 2 words, 8 banks
static_assert(kLdStage % 32 == 8,
              "a fragment store's four channel pairs hit distinct banks");
static_assert((kWBytes + HaloC::kBytes + kTabBytes) % 16 == 0,
              "the stage is 16-byte aligned");

// Persistent: block i takes tiles i, i + gridDim.x, ... of the B*T*tiles_hw
// (b, t, 16x16 conv) tiles. Warp w owns channels 16 (w % 4).. and conv rows
// 4 (w / 4).. of the tile; lane (g, t4) the columns g and g + 8 and the
// channels 2 t4, 2 t4 + 1 of each n8 half.
__global__ void __launch_bounds__(kThreadsTc, 1)
stem_conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    int frames, int H, int W, int Hc, int Wc, int tiles_x,
                    int tiles_hw, int tiles, int relu) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_tc);                     // [480][72]
  unsigned short* halo =
      reinterpret_cast<unsigned short*>(smem_tc + kWBytes);          // [3][37][112]
  int* tab_off =
      reinterpret_cast<int*>(smem_tc + kWBytes + HaloC::kBytes);     // [80]
  uint32_t* tab_mask = reinterpret_cast<uint32_t*>(tab_off + kPairsF);
  bf16* stage = reinterpret_cast<bf16*>(smem_tc + kWBytes + HaloC::kBytes +
                                        kTabBytes);                  // [64][264]
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ng = (tid >> 5) & 3;
  const int mg = (tid >> 5) >> 2;
  const bool vec_ok = (Wc & 7) == 0;  // channel rows 16-byte aligned

  load_weights_and_tables(w_s, w, tab_off, tab_mask, HaloC::kLd);
  int poff[kWarpTilesC][2];         // halo offset of the columns g, g+8 owned
  pixel_offsets<kCTc>(poff, mg, g);
  float sc[2][2], bi[2][2];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[ni][j] = scale[ng * 16 + ni * 8 + 2 * t4 + j];
      bi[ni][j] = bias[ng * 16 + ni * 8 + 2 * t4 + j];
    }

  unsigned short pre[HaloC::kPerThread];
  const Slab clip = make_slab(0, H, H);
  fetch_tile_halo<kCTc>(pre, xs, blockIdx.x, 0, tiles_x, tiles_hw, frames,
                        clip, W, 0);
  stash_halo<kCTc>(pre, halo);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[kWarpTilesC][2][4];
#pragma unroll
    for (int i = 0; i < kWarpTilesC; ++i)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][ni][j] = 0.f;

    for (int kt = 0; kt < 3; ++kt) {
      // the next (tile, frame) goes into registers while this one multiplies
      const int nt = kt < 2 ? tile : tile + gridDim.x;
      const int nkt = kt < 2 ? kt + 1 : 0;
      if (nt < tiles)
        fetch_tile_halo<kCTc>(pre, xs, nt, nkt, tiles_x, tiles_hw, frames,
                              clip, W, 0);
      tuber_mma::cp_async_wait<0>();
      // frame kt's halo (and the weights) are in; the previous tile's stage
      // has been read
      __syncthreads();
      frame_products<kWarpTilesC, kMTilesC>(
          acc, halo + kt * HaloC::kFrameElems, w_s + kt * kSlotsF * kLdW,
          tab_off, tab_mask, poff, lane, mg, ng);
      // the buffer of frame nkt was last read two barriers ago
      if (nt < tiles) stash_halo<kCTc>(pre, halo + nkt * HaloC::kFrameElems);
    }

    // affine (+ ReLU) on the f32 sums, rounded once, into the stage
#pragma unroll
    for (int i = 0; i < kWarpTilesC; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = ng * 16 + ni * 8 + 2 * t4 + j;
            stage[c * kLdStage + (mg * kWarpTilesC + i) * kCTc + g + 8 * h] =
                __float2bfloat16_rn(affine_relu(acc[i][ni][2 * h + j],
                                                sc[ni][j], bi[ni][j], relu));
          }
    __syncthreads();
    // 64 channels x 16 rows x 2 halves of 8 px; a warp stores one channel's
    // 16 rows, each a 32-byte sector
    const int bt = tile / tiles_hw;
    const int rem = tile - bt * tiles_hw;
    const int cy0 = (rem / tiles_x) * kCTc;
    const int cx0 = (rem % tiles_x) * kCTc;
    bf16* dst_bt = out + static_cast<size_t>(bt) * kCout * Hc * Wc;
    for (int v = tid; v < kCout * kCTc * 2; v += kThreadsTc) {
      const int half = v & 1;
      const int r = (v >> 1) & (kCTc - 1);
      const int c = v >> 5;
      const int cy = cy0 + r;
      const int cx = cx0 + 8 * half;
      if (cy >= Hc || cx >= Wc) continue;
      const bf16* src = stage + c * kLdStage + r * kCTc + 8 * half;
      bf16* dst = dst_bt + (static_cast<size_t>(c) * Hc + cy) * Wc + cx;
      if (vec_ok && cx + 8 <= Wc) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && cx + e < Wc; ++e) dst[e] = src[e];
      }
    }
  }
}

int launch_conv_tc(const void* x, const void* w, const void* scale,
                   const void* bias, void* out, int batch, int frames, int H,
                   int W, int relu, void* stream) {
  const int Hc = (H - 1) / 2 + 1;   // conv 7 / stride 2 / pad 3
  const int Wc = (W - 1) / 2 + 1;
  const int tiles_x = (Wc + kCTc - 1) / kCTc;
  const int tiles_hw = ((Hc + kCTc - 1) / kCTc) * tiles_x;
  const long long tiles = static_cast<long long>(batch) * frames * tiles_hw;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<int> cache[kMaxDevices];
  int resident = 0;
  const cudaError_t err =
      resident_blocks(stem_conv_tc_kernel, kSmemConvTc, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);
  stem_conv_tc_kernel<<<blocks, kThreadsTc, kSmemConvTc,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(out), frames, H, W, Hc, Wc, tiles_x, tiles_hw,
      static_cast<int>(tiles), relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. x and w have the element type in the
// name; scale and bias are float32; every pointer is device memory, w
// 16-byte aligned. The launch goes on `stream` and does not synchronise.
// Returns a cudaError_t. The bf16 pooled stem runs on the tensor cores, the
// float32 one on the CUDA cores. The pooled stems take a row window: x
// (B,T,rows,W,3) holds the global input rows [row0, row0 + rows) of a clip
// of height H, out (B,T,out_rows,Wp,64) the global pooled rows [out0, out0 +
// out_rows); the whole clip is row0 0, rows H, out0 0, out_rows Hp.
extern "C" int tuber_stem_pool_bf16(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int batch, int frames, int H,
                                    int W, int row0, int rows, int out0,
                                    int out_rows, void* stream) {
  return launch_tc(x, w, scale, bias, out, batch, frames, H, W, row0, rows,
                   out0, out_rows, stream);
}

extern "C" int tuber_stem_pool_f32(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int batch, int frames, int H,
                                   int W, int row0, int rows, int out0,
                                   int out_rows, void* stream) {
  return launch<float>(x, w, scale, bias, out, batch, frames, H, W, row0,
                       rows, out0, out_rows, stream);
}

// The unpooled kernels: out (B,T,64,Hc,Wc) in x's type; relu 0 or 1. bf16
// on the tensor cores, float32 on the CUDA cores.
extern "C" int tuber_stem_conv_bf16(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int batch, int frames, int H,
                                    int W, int relu, void* stream) {
  return launch_conv_tc(x, w, scale, bias, out, batch, frames, H, W, relu,
                        stream);
}

extern "C" int tuber_stem_conv_f32(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int batch, int frames, int H,
                                   int W, int relu, void* stream) {
  return launch_conv_f32(x, w, scale, bias, out, batch, frames, H, W, relu,
                         stream);
}
