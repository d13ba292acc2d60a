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
// bf16 (stem_pool_tc_kernel, every model path): an implicit GEMM on the
// tensor cores (mma.sync.m16n8k16, bf16 in, float32 sums). A work item is one
// (b, t) and an 8x8 tile of pooled outputs, so a 17x17 conv tile: M = 289
// conv pixels (19 row tiles of 16), N = 64 channels, K = 3 frames x 7 rows x
// 21 (kw, c) inputs, each run of 21 padded to 22 and each frame to 160: 480.
// For a fixed (frame, kernel row) the 21 inputs of a conv pixel are
// contiguous in a channels-last halo row, so the A fragments are gathered
// straight from the halo in shared memory (a pixel's base offset plus a
// table of k offsets; the pad slot of each run is masked to zero), with no
// im2col buffer. The grid is persistent, one block of 16 warps per SM (the
// warps hide each other's shared-load latency): the weights (480 x 64 bf16)
// go into shared memory once per block by cp.async, and the halo of the
// next (tile, frame) is loaded into registers while the current frame is
// multiplied, then stored to its own buffer (three frame buffers).
// Input rows start at any 2-byte offset, so the halo cannot be copied in
// 16-byte pieces. Scale, bias and ReLU run on the float32 accumulators; the
// conv tile is kept in shared memory in bf16 and max-pooled there: rounding
// is monotone, so the max of bf16-rounded values equals the bf16 rounding of
// the max.
//
// float32 (stem_pool_kernel, tests only): the direct conv on the CUDA cores
// in f32 (stem_conv.cuh), a 17x17 conv tile per block.
//
// The second kernel here, stem_conv_kernel, is the same conv with the
// affine (and the ReLU when asked) and no pool, channels-mid out:
// x (B,T,H,W,3) -> out (B,T,64,Hc,Wc). It replaces `_stem_matmul(pool=False)`
// of tubelet_transformer_tpu/ops/pallas/stem.py, which `stem_conv_bn_relu`
// runs there; no model path of either package calls it. It is the
// statistics kernel's 16x16 conv tile (stem_stats.cu), stored instead of
// reduced: the f32 tile goes through shared memory as [channel][pixel]
// (rows of 257 floats, so the eight channel groups of a warp hit distinct
// banks), and each channel's rows of 16 pixels are written contiguously,
// rounded once to the output type. At
// (1,32,256,256,3) it must write 67 MB of bf16 (22 us at 3.35 TB/s) for
// 29.6 GFLOP (30 us at the bf16 tensor-core peak): the operations bound it,
// and this kernel runs them on the CUDA cores in f32.

#include <cstdint>

#include "mma.cuh"
#include "stem_conv.cuh"

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
                 int frames, int H, int W, int Hc, int Wc, int Hp, int Wp,
                 int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float* conv_s = smem;            // [kConvPix][64], after the accumulation

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;       // b * frames + t
  const int t = bt % frames;
  const int py0 = (blockIdx.x / tiles_x) * kPT;
  const int px0 = (blockIdx.x % tiles_x) * kPT;
  const int cy0 = 2 * py0 - 1;     // first conv row of the tile
  const int cx0 = 2 * px0 - 1;
  const int cg = tid % kChanGroups;
  const int pg = tid / kChanGroups;

  float acc[kPixPerThread][8];
  conv_tile<kCT>(x, w, smem, bt, t, frames, H, W, cy0, cx0, acc);

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
    if (py >= Hp || px >= Wp) continue;
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
    store2(out + ((static_cast<size_t>(bt) * Hp + py) * Wp + px) * kCout +
               2 * cp,
           m0, m1);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int batch, int frames, int H, int W, void* stream) {
  const int Hc = (H - 1) / 2 + 1;   // conv 7 / stride 2 / pad 3
  const int Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1;  // pool 3 / stride 2 / pad 1
  const int Wp = (Wc - 1) / 2 + 1;
  const int tiles_y = (Hp + kPT - 1) / kPT;
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
      static_cast<T*>(out), frames, H, W, Hc, Wc, Hp, Wp, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: the implicit GEMM of the 17x17 conv tile.
using bf16 = __nv_bfloat16;
using namespace tuber_mma;
constexpr int kIT = halo_edge(kCT);             // 39 halo rows and columns
constexpr int kRowElems = kIT * 3;              // 117 bf16 of a halo row
constexpr int kLdH = 120;                       // halo row stride (even)
constexpr int kFrameElems = kIT * kLdH;         // one frame's halo buffer
constexpr int kHaloElems = kIT * kRowElems;     // 4563 inputs of a frame
constexpr int kThreadsTc = 512;                 // 16 warps: 4 (rows) x 4 (cols)
constexpr int kPerThread = (kHaloElems + kThreadsTc - 1) / kThreadsTc;   // 9
constexpr int kRun = 22;                        // a (kt, kh) run of 21, padded
constexpr int kSlotsF = 160;                    // k of a frame: 7 x 22 + 6
constexpr int kStepsF = kSlotsF / 16;           // k16 steps of a frame
constexpr int kPairsF = kSlotsF / 2;            // k pairs of a frame
constexpr int kPairsUsed = 7 * kRun / 2;        // 77: the rest are zero
constexpr int kKRows = 3 * kSlotsF;             // 480
constexpr int kLdW = kCout + 8;                 // weight row stride
constexpr int kLdConv = kCout + 8;              // conv tile row stride
constexpr int kMTiles = (kConvPix + 15) / 16;   // 19 row tiles of 16
constexpr int kWarpTiles = 5;                   // row tiles of a warp: 5 or 4
constexpr size_t kWBytes = static_cast<size_t>(kKRows) * kLdW * 2;
constexpr size_t kHBytes = 3 * static_cast<size_t>(kFrameElems) * 2;
constexpr size_t kConvBytes = static_cast<size_t>(kConvPix) * kLdConv * 2;
constexpr size_t kSmemTc = kWBytes + kHBytes + kConvBytes + kPairsF * 8;
static_assert(kWBytes % 16 == 0 && kHBytes % 16 == 0 && kConvBytes % 16 == 0,
              "shared sub-buffers stay 16-byte aligned");
static_assert(4 * kWarpTiles >= kMTiles, "four warp rows cover the tile");

// One frame (kt = 0, 1, 2 for t-1, t, t+1) of the input halo of `tile` into
// registers, as bf16 bits; zeros outside the clip and the frame. Thread i
// holds halo elements i, i + 512, ... (row-major, 117 to a row).
__device__ __forceinline__ void fetch_halo(
    unsigned short (&r)[kPerThread], const unsigned short* __restrict__ x,
    int tile, int kt, int tiles_x, int tiles_hw, int frames, int H, int W) {
  const int bt = tile / tiles_hw;
  const int rem = tile - bt * tiles_hw;
  const int tt = bt % frames + kt - 1;
  const int iy0 = 4 * ((rem / tiles_x) * kPT) - 5;   // 2 * (first conv row) - 3
  const int ix0 = 4 * ((rem % tiles_x) * kPT) - 5;
  const bool frame_ok = tt >= 0 && tt < frames;
  const unsigned short* xf =
      x + (frame_ok ? static_cast<size_t>(bt + kt - 1) * H * W * 3 : 0);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreadsTc;
    const int row = e / kRowElems;
    const int q = e - row * kRowElems;              // 3 * column + channel
    const int iy = iy0 + row;
    const int ix = ix0 + q / 3;
    unsigned short v = 0;
    if (frame_ok && e < kHaloElems && iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = __ldg(xf + static_cast<size_t>(iy) * W * 3 + ix0 * 3 + q);
    r[j] = v;
  }
}

__device__ __forceinline__ void stash_halo(
    const unsigned short (&r)[kPerThread], unsigned short* hb) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreadsTc;
    const int row = e / kRowElems;
    if (e < kHaloElems) hb[row * kLdH + e - row * kRowElems] = r[j];
  }
}

// Persistent: block i takes tiles i, i + gridDim.x, ... of the B*T*tiles_hw
// (b, t, 8x8 pooled) tiles. Warp w owns output channels 16 (w % 4).. and
// row tiles 5 (w / 4).. of the conv tile.
__global__ void __launch_bounds__(kThreadsTc, 1)
stem_pool_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    int frames, int H, int W, int Hc, int Wc, int Hp, int Wp,
                    int tiles_x, int tiles_hw, int tiles) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_tc);                     // [480][72]
  unsigned short* halo =
      reinterpret_cast<unsigned short*>(smem_tc + kWBytes);          // [3][39][120]
  bf16* conv_s = reinterpret_cast<bf16*>(smem_tc + kWBytes + kHBytes);  // [289][72]
  int* tab_off =
      reinterpret_cast<int*>(smem_tc + kWBytes + kHBytes + kConvBytes);  // [80]
  uint32_t* tab_mask = reinterpret_cast<uint32_t*>(tab_off + kPairsF);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ng = (tid >> 5) & 3;
  const int mg = (tid >> 5) >> 2;

  // B: k row (kt, kh, j) is w's row (kt, kh, kw, c) for j = 3 kw + c < 21,
  // zero for the pad slots; once per block
  for (int i = tid; i < kKRows * 8; i += kThreadsTc) {
    const int row = i >> 3;
    const int c = i & 7;
    const int kt = row / kSlotsF;
    const int kh = (row - kt * kSlotsF) / kRun;
    const int j = row - kt * kSlotsF - kh * kRun;
    bf16* dst = w_s + row * kLdW + c * 8;
    if (kh < 7 && j < 21)
      cp_async16(dst, w + static_cast<size_t>(kt * kFrameTaps + kh * 21 + j) *
                              kCout + c * 8, true);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  // A: k pair P of a frame is halo offset kh * kLdH + 2 j (P = 11 kh + j);
  // its second half is the pad slot where j = 10, and both are zero past 77
  for (int i = tid; i < kPairsF; i += kThreadsTc) {
    const int kh = i / 11;
    const int j = i - kh * 11;
    tab_off[i] = i < kPairsUsed ? kh * kLdH + 2 * j : 0;
    tab_mask[i] = i < kPairsUsed ? (j == 10 ? 0xFFFFu : 0xFFFFFFFFu) : 0u;
  }
  int poff[kWarpTiles][2];          // halo offset of the rows g, g+8 owned
#pragma unroll
  for (int i = 0; i < kWarpTiles; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = (mg * kWarpTiles + i) * 16 + g + 8 * h;
      p = p < kConvPix ? p : 0;
      poff[i][h] = 2 * (p / kCT) * kLdH + 6 * (p % kCT);
    }
  float sc[2][2], bi[2][2];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[ni][j] = scale[ng * 16 + ni * 8 + 2 * t4 + j];
      bi[ni][j] = bias[ng * 16 + ni * 8 + 2 * t4 + j];
    }

  unsigned short pre[kPerThread];
  fetch_halo(pre, xs, blockIdx.x, 0, tiles_x, tiles_hw, frames, H, W);
  stash_halo(pre, halo);
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
        fetch_halo(pre, xs, nt, nkt, tiles_x, tiles_hw, frames, H, W);
      cp_async_wait<0>();
      __syncthreads();              // frame kt's halo (and the weights) are in
      const unsigned short* hb = halo + kt * kFrameElems;
      const bf16* wb = w_s + kt * kSlotsF * kLdW;
#pragma unroll 2
      for (int s = 0; s < kStepsF; ++s) {
        const int p0 = s * 8 + t4;
        const int o0 = tab_off[p0];
        const int o1 = tab_off[p0 + 4];
        const uint32_t m0 = tab_mask[p0];
        const uint32_t m1 = tab_mask[p0 + 4];
        uint32_t bfr[4];
        ldsm_x4_t(bfr, wb + (s * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdW +
                           ng * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < kWarpTiles; ++i) {
          if (mg * kWarpTiles + i >= kMTiles) continue;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(hb + poff[i][0] + o0) & m0;
          a[1] = *reinterpret_cast<const uint32_t*>(hb + poff[i][1] + o0) & m0;
          a[2] = *reinterpret_cast<const uint32_t*>(hb + poff[i][0] + o1) & m1;
          a[3] = *reinterpret_cast<const uint32_t*>(hb + poff[i][1] + o1) & m1;
          mma_bf16(acc[i][0], a, bfr[0], bfr[1]);
          mma_bf16(acc[i][1], a, bfr[2], bfr[3]);
        }
      }
      // the buffer of frame nkt was last read two barriers ago
      if (nt < tiles) stash_halo(pre, halo + nkt * kFrameElems);
    }

    // affine + ReLU on the f32 sums, 0 outside the image (every pool window
    // holds its in-image centre and all values are >= 0, so a 0 pools like
    // the reference's -inf padding), into the bf16 conv tile
    const int bt = tile / tiles_hw;
    const int rem = tile - bt * tiles_hw;
    const int py0 = (rem / tiles_x) * kPT;
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
          const float y0 = fmaf(acc[i][ni][2 * h], sc[ni][0], bi[ni][0]);
          const float y1 = fmaf(acc[i][ni][2 * h + 1], sc[ni][1], bi[ni][1]);
          *reinterpret_cast<__nv_bfloat162*>(conv_s + p * kLdConv + ng * 16 +
                                             ni * 8 + 2 * t4) =
              __floats2bfloat162_rn(inside ? (y0 < 0.f ? 0.f : y0) : 0.f,
                                    inside ? (y1 < 0.f ? 0.f : y1) : 0.f);
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
      if (py >= Hp || px >= Wp) continue;
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
      store2(out + ((static_cast<size_t>(bt) * Hp + py) * Wp + px) * kCout +
                 2 * cp,
             q0, q1);
    }
  }
}

int launch_tc(const void* x, const void* w, const void* scale,
              const void* bias, void* out, int batch, int frames, int H,
              int W, void* stream) {
  const int Hc = (H - 1) / 2 + 1;   // conv 7 / stride 2 / pad 3
  const int Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1;  // pool 3 / stride 2 / pad 1
  const int Wp = (Wc - 1) / 2 + 1;
  const int tiles_x = (Wp + kPT - 1) / kPT;
  const int tiles_hw = ((Hp + kPT - 1) / kPT) * tiles_x;
  const long long tiles = static_cast<long long>(batch) * frames * tiles_hw;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemTc));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stem_pool_tc_kernel, kThreadsTc, kSmemTc);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);
  stem_pool_tc_kernel<<<blocks, kThreadsTc, kSmemTc,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(out), frames, H, W, Hc, Wc, Hp, Wp, tiles_x,
      tiles_hw, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

constexpr int kCTc = 16;                     // unpooled conv tile edge
constexpr int kCPix = kCTc * kCTc;            // 256
constexpr int kLdC = kCPix + 1;               // [channel][pixel] row stride
constexpr int kSmemFloatsC = conv_smem_floats(kCTc) > kCout * kLdC
                                 ? conv_smem_floats(kCTc) : kCout * kLdC;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Conv pixels pg, pg+32, ..., pg+224 of the 16x16 tile (stem_conv.cuh).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
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
  conv_tile<kCTc>(x, w, smem, bt, t, frames, H, W, cy0, cx0, acc);

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
  T* dst = out + static_cast<size_t>(bt) * kCout * Hc * Wc;
  for (int idx = tid; idx < kCout * kCPix; idx += kThreads) {
    const int c = idx / kCPix;
    const int p = idx % kCPix;
    const int cy = cy0 + p / kCTc;
    const int cx = cx0 + p % kCTc;
    if (cy >= Hc || cx >= Wc) continue;
    store1(dst + (static_cast<size_t>(c) * Hc + cy) * Wc + cx,
           conv_s[c * kLdC + p]);
  }
}

template <typename T>
int launch_conv(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int batch, int frames, int H,
                int W, int relu, void* stream) {
  const int Hc = (H - 1) / 2 + 1;   // conv 7 / stride 2 / pad 3
  const int Wc = (W - 1) / 2 + 1;
  const int tiles_y = (Hc + kCTc - 1) / kCTc;
  const int tiles_x = (Wc + kCTc - 1) / kCTc;
  const size_t smem = kSmemFloatsC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_y * tiles_x, batch * frames);
  stem_conv_kernel<T><<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), frames, H, W, Hc, Wc, tiles_x, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. x and w have the element type in the
// name; scale and bias are float32; every pointer is device memory, w
// 16-byte aligned. The launch goes on `stream` and does not synchronise.
// Returns a cudaError_t. The bf16 pooled stem runs on the tensor cores, the
// float32 one on the CUDA cores.
extern "C" int tuber_stem_pool_bf16(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int batch, int frames, int H,
                                    int W, void* stream) {
  return launch_tc(x, w, scale, bias, out, batch, frames, H, W, stream);
}

extern "C" int tuber_stem_pool_f32(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int batch, int frames, int H,
                                   int W, void* stream) {
  return launch<float>(x, w, scale, bias, out, batch, frames, H, W, stream);
}

// The unpooled kernel: out (B,T,64,Hc,Wc) in x's type; relu 0 or 1.
extern "C" int tuber_stem_conv_bf16(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int batch, int frames, int H,
                                    int W, int relu, void* stream) {
  return launch_conv<__nv_bfloat16>(x, w, scale, bias, out, batch, frames, H,
                                    W, relu, stream);
}

extern "C" int tuber_stem_conv_f32(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int batch, int frames, int H,
                                   int W, int relu, void* stream) {
  return launch_conv<float>(x, w, scale, bias, out, batch, frames, H, W, relu,
                            stream);
}
