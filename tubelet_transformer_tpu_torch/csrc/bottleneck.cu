// One stride-1 identity ir-bottleneck of irCSN on Hopper, inference:
//   mid = relu((x @ w1) * a1 + b1)                        (conv1, bf16 out)
//   mdw = relu(depthwise3x3x3(mid, wd) * a3 + b3)        (zero padding 1)
//   out = relu((mdw @ w4) * a4 + b4 + x)                  (conv4, residual)
// x and out (B,T,H,W,Ci) channels-last, bf16 or float32; w1 (Ci,Cm), wd
// (3,3,3,Cm) and w4 (Cm,Ci) bf16; the six affines float32. Products of bf16
// operands, float32 sums; mid and mdw are rounded to bf16, as the TPU kernel
// keeps them; out is rounded once, to x's type.
//
// Replaces `_bottleneck_pallas` of tubelet_transformer_tpu/ops/pallas/
// bottleneck.py. That kernel walks a sequential grid over (b, t) and carries
// a ring of three mid frames in scratch from one step to the next, so conv1
// runs once per frame. Hopper's blocks run in no order, so the ring does not
// carry over; this port runs in two kernels instead:
//   1. conv1_kernel: the conv1 product of every pixel, with its affine and
//      ReLU, written once as bf16 (Cm = Ci/4: a quarter of x's bytes);
//   2. dw_conv4_kernel: one block per (b, t, 8x8 pixel tile) reads the mid
//      halo of frames t-1..t+1 (zero outside the clip, which resets the ring
//      at t = 0 and t = T-1 of every clip), runs the depthwise taps, the
//      affine and ReLU into shared memory, then the conv4 product, its
//      affine, the residual and the ReLU, and writes the output once.
// The other way, conv1 recomputed in each block for its own halo, would
// read x's halo of three frames (3 x 1.56 of x) and run conv1 4.7 times
// over to save mid's 4.2 MB write and read; writing mid once is simpler
// and moves fewer bytes.
// Both products are bf16 WMMA tiles (16x16x16, float32 accumulators) in the
// kernels' own bodies: conv1 stages x and w1 in shared memory 64 channels
// at a time; conv4 reads its A tiles from the block's mdw in shared memory
// and its B tiles of w4 (128 KB, shared by every block) through L1 and L2.
//
// What bounds it: at the main path's shape, layer2 of CSN-152 at 256 px,
// (1,16,32,32,512) bf16 with Cm = 128, the function must read x (16.8 MB) and
// write out (16.8 MB): 10.0 us at 3.35 TB/s; its two products are 4.3 GFLOP,
// 4.3 us at the 989 TFLOP/s bf16 tensor-core peak: bound by bytes. This
// design moves 16.8 MB (x, conv1) + 4.2 MB (mid) + 4.2 MB x 1.56 x 3 (mid
// halos) + 16.8 MB (x, residual) + 16.8 MB (out), about 75 MB, most of the
// mid halo from L2; the TPU kernel's two reads of x and one write are the
// floor it approaches when the ring of mids stays on chip.

#include <cuda_bf16.h>
#include <mma.h>

#include "vec.cuh"

namespace {

using namespace nvcuda;
using tuber::Vec;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;               // pixels per block, both kernels
constexpr int kChunk = 64;              // channels per step
constexpr int kPadB = 8;                // bf16 padding of a shared row
constexpr int kPadF = 4;                // float padding of a shared row
constexpr int kTile = 8;                // kernel 2: 8x8 pixels per block
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kTaps = 27;
constexpr int kVecs = kChunk / 8;       // 16-byte bf16 vectors per slice
constexpr int kConv1Threads = 128;      // 4 warps x 16 rows
constexpr int kThreads = 256;           // kernel 2: 8 warps
constexpr int kN4 = 128;                // kernel 2: conv4 columns per step
static_assert(kRows == kChunk, "kernel 1 loads its A and B tiles in one loop");

// Eight channels of x at p as eight bf16 in one 16-byte vector.
__device__ __forceinline__ uint4 load8_bf16(const bf16* p) {
  return tuber::load_vec(p);
}
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  float f[8];
  Vec<float>::unpack(tuber::load_vec(p), f);
  Vec<float>::unpack(tuber::load_vec(p + 4), f + 4);
  return Vec<bf16>::pack(f);
}

// Eight channels of x at p as float.
__device__ __forceinline__ void load8_f32(const bf16* p, float* f) {
  Vec<bf16>::unpack(tuber::load_vec(p), f);
}
__device__ __forceinline__ void load8_f32(const float* p, float* f) {
  Vec<float>::unpack(tuber::load_vec(p), f);
  Vec<float>::unpack(tuber::load_vec(p + 4), f + 4);
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  tuber::store_vec(p, Vec<bf16>::pack(f));
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  tuber::store_vec(p, Vec<float>::pack(f));
  tuber::store_vec(p + 4, Vec<float>::pack(f + 4));
}

// Kernel 1. Grid (ceil(M / 64), Cm / 64); warp w owns rows 16w..16w+15 of
// the block's 64 and its 64 columns (four accumulator tiles).
template <typename T>
__global__ void __launch_bounds__(kConv1Threads)
conv1_kernel(const T* __restrict__ x, const bf16* __restrict__ w1,
             const float* __restrict__ a1, const float* __restrict__ b1,
             bf16* __restrict__ mid, long long M, int Ci, int Cm) {
  __shared__ __align__(128) bf16 a_s[kRows][kChunk + kPadB];
  __shared__ __align__(128) bf16 b_s[kChunk][kChunk + kPadB];
  __shared__ __align__(128) float c_s[kRows][kChunk + kPadF];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int n0 = blockIdx.y * kChunk;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < Ci; k0 += kChunk) {
    for (int i = tid; i < kRows * kVecs; i += kConv1Threads) {
      const int r = i / kVecs;
      const int v = i - r * kVecs;
      const long long row = row0 + r;
      *reinterpret_cast<uint4*>(&a_s[r][v * 8]) =
          row < M ? load8_bf16(x + row * Ci + k0 + v * 8) : tuber::zero_vec();
      *reinterpret_cast<uint4*>(&b_s[r][v * 8]) =
          tuber::load_vec(w1 + static_cast<size_t>(k0 + r) * Cm + n0 + v * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &a_s[warp * 16][kk], kChunk + kPadB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &b_s[kk][j * 16], kChunk + kPadB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&c_s[warp * 16][j * 16], acc[j], kChunk + kPadF,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kRows * kVecs; i += kConv1Threads) {
    const int r = i / kVecs;
    const int v = i - r * kVecs;
    const long long row = row0 + r;
    if (row >= M) continue;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + v * 8 + j;
      f[j] = tuber::relu(fmaf(c_s[r][v * 8 + j], a1[c], b1[c]));
    }
    store8(mid + row * Cm + n0 + v * 8, f);
  }
}

// Shared memory of kernel 2: a region that holds the mid halo of one
// 64-channel slice (3 frames x 10x10 pixels) and later the float32 conv4
// tile (64 x 128), the slice's 27 depthwise taps in float32, and mdw
// (64 pixels x Cm, bf16).
constexpr size_t kHaloBytes = 3 * kHaloPix * kChunk * sizeof(bf16);
constexpr size_t kEpiBytes = kRows * (kN4 + kPadF) * sizeof(float);
constexpr size_t kRegionBytes = kHaloBytes > kEpiBytes ? kHaloBytes : kEpiBytes;
constexpr size_t kTapBytes = kTaps * kChunk * sizeof(float);
static_assert(kRegionBytes % 128 == 0 && kTapBytes % 128 == 0,
              "shared sub-buffers stay 128-byte aligned");

size_t dw_conv4_smem(int Cm) {
  return kRegionBytes + kTapBytes +
         static_cast<size_t>(kRows) * (Cm + kPadB) * sizeof(bf16);
}

// Kernel 2. Grid (tiles_y * tiles_x, T, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_conv4_kernel(const T* __restrict__ x, const bf16* __restrict__ mid,
                const bf16* __restrict__ wd, const bf16* __restrict__ w4,
                const float* __restrict__ a3, const float* __restrict__ b3,
                const float* __restrict__ a4, const float* __restrict__ b4,
                T* __restrict__ out, int frames, int H, int W, int Ci, int Cm,
                int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* halo = reinterpret_cast<uint4*>(smem);          // [3*100][kVecs]
  float* c_s = reinterpret_cast<float*>(smem);           // [64][kN4+kPadF]
  float* w_s = reinterpret_cast<float*>(smem + kRegionBytes);  // [27][64]
  bf16* m_s = reinterpret_cast<bf16*>(smem + kRegionBytes + kTapBytes);
  const int ldm = Cm + kPadB;                             // m_s row stride

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int h0 = (blockIdx.x / tiles_x) * kTile;
  const int w0 = (blockIdx.x % tiles_x) * kTile;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const size_t frame0 = static_cast<size_t>(b) * frames;

  // depthwise + affine + ReLU, one 64-channel slice at a time, into m_s
  for (int c0 = 0; c0 < Cm; c0 += kChunk) {
    for (int i = tid; i < kTaps * kChunk; i += kThreads) {
      const int tap = i / kChunk;
      w_s[i] = tuber::to_f32(wd[tap * Cm + c0 + i - tap * kChunk]);
    }
    for (int i = tid; i < 3 * kHaloPix * kVecs; i += kThreads) {
      const int fp = i / kVecs;                  // frame * 100 + pixel
      const int v = i - fp * kVecs;
      const int f = t - 1 + fp / kHaloPix;
      const int p = fp % kHaloPix;
      const int h = h0 - 1 + p / kHalo;
      const int w = w0 - 1 + p % kHalo;
      uint4 val = tuber::zero_vec();
      if (f >= 0 && f < frames && h >= 0 && h < H && w >= 0 && w < W)
        val = tuber::load_vec(
            mid + ((frame0 + f) * H + h) * static_cast<size_t>(W) * Cm +
            static_cast<size_t>(w) * Cm + c0 + v * 8);
      halo[i] = val;
    }
    __syncthreads();
    for (int i = tid; i < kRows * kVecs; i += kThreads) {
      const int p = i / kVecs;
      const int v = i - p * kVecs;
      const int py = p / kTile;
      const int px = p % kTile;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            float m[8];
            Vec<bf16>::unpack(
                halo[(dt * kHaloPix + (py + dh) * kHalo + px + dw) * kVecs + v],
                m);
            const float* wt = w_s + ((dt * 3 + dh) * 3 + dw) * kChunk + v * 8;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] = fmaf(m[j], wt[j], acc[j]);
          }
      const int c = c0 + v * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] = tuber::relu(fmaf(acc[j], a3[c + j], b3[c + j]));
      store8(m_s + p * ldm + c, acc);
    }
    __syncthreads();             // the halo region is reloaded or reused
  }

  // conv4 + affine + residual + ReLU, kN4 output channels at a time; warp w
  // owns rows 16 (w % 4) .. +15 and columns 64 (w / 4) .. +63 of the step
  const int r16 = (warp % 4) * 16;
  const int cw = (warp / 4) * 64;
  for (int n0 = 0; n0 < Ci; n0 += kN4) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k = 0; k < Cm; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, m_s + r16 * ldm + k, ldm);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(
            bm, w4 + static_cast<size_t>(k) * Ci + n0 + cw + j * 16, Ci);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(c_s + r16 * (kN4 + kPadF) + cw + j * 16, acc[j],
                              kN4 + kPadF, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kRows * (kN4 / 8); i += kThreads) {
      const int p = i / (kN4 / 8);
      const int v = i - p * (kN4 / 8);
      const int h = h0 + p / kTile;
      const int w = w0 + p % kTile;
      if (h >= H || w >= W) continue;
      const size_t pix = ((frame0 + t) * H + h) * static_cast<size_t>(W) + w;
      const int c = n0 + v * 8;
      float xr[8], f[8];
      load8_f32(x + pix * Ci + c, xr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = tuber::relu(
            fmaf(c_s[p * (kN4 + kPadF) + v * 8 + j], a4[c + j], b4[c + j]) +
            xr[j]);
      store8(out + pix * Ci + c, f);
    }
    __syncthreads();             // c_s is rewritten by the next step
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* wd, const void* w4,
           const void* a1, const void* b1, const void* a3, const void* b3,
           const void* a4, const void* b4, void* mid, void* out, int batch,
           int frames, int H, int W, int Ci, int Cm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(batch) * frames * H * W;
  const dim3 grid1(static_cast<unsigned>((M + kRows - 1) / kRows),
                   Cm / kChunk);
  conv1_kernel<T><<<grid1, kConv1Threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(a1), static_cast<const float*>(b1),
      static_cast<bf16*>(mid), M, Ci, Cm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = dw_conv4_smem(Cm);
  err = cudaFuncSetAttribute(dw_conv4_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const dim3 grid2(tiles_y * tiles_x, frames, batch);
  dw_conv4_kernel<T><<<grid2, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(mid),
      static_cast<const bf16*>(wd), static_cast<const bf16*>(w4),
      static_cast<const float*>(a3), static_cast<const float*>(b3),
      static_cast<const float*>(a4), static_cast<const float*>(b4),
      static_cast<T*>(out), frames, H, W, Ci, Cm, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. x and out have the element type in the
// name; w1, wd, w4 and mid (the (B,T,H,W,Cm) bf16 scratch) are bf16, the
// affines float32; every pointer is device memory, x, w1, mid and out
// 16-byte aligned, w4 32-byte aligned (WMMA loads its tiles in place). Cm must
// be a multiple of 64 and Ci of 128. The two launches go on `stream` and do
// not synchronise. Returns a cudaError_t.
extern "C" int tuber_bottleneck_bf16(
    const void* x, const void* w1, const void* wd, const void* w4,
    const void* a1, const void* b1, const void* a3, const void* b3,
    const void* a4, const void* b4, void* mid, void* out, int batch,
    int frames, int H, int W, int Ci, int Cm, void* stream) {
  return launch<bf16>(x, w1, wd, w4, a1, b1, a3, b3, a4, b4, mid, out, batch,
                      frames, H, W, Ci, Cm, stream);
}

extern "C" int tuber_bottleneck_f32(
    const void* x, const void* w1, const void* wd, const void* w4,
    const void* a1, const void* b1, const void* a3, const void* b3,
    const void* a4, const void* b4, void* mid, void* out, int batch,
    int frames, int H, int W, int Ci, int Cm, void* stream) {
  return launch<float>(x, w1, wd, w4, a1, b1, a3, b3, a4, b4, mid, out,
                       batch, frames, H, W, Ci, Cm, stream);
}
