// The two tile bodies of a stride-1 identity ir-bottleneck of irCSN, as the
// fused-bottleneck kernels (bottleneck.cu) run them (the stage chain,
// stage.cu, has tile bodies of its own):
//   conv1_tile:    mid = relu((x @ w1) * a1 + b1) of a block of pixel rows
//                  and 64 columns of C_mid, rounded to bf16;
//   dw_conv4_tile: for one (b, t, 8x8 pixel tile), the depthwise 3x3x3 over
//                  the mid halo of frames t-1..t+1 (zero outside the clip
//                  and the frame), affine + ReLU into shared memory (bf16),
//                  then out = relu((mdw @ w4) * a4 + b4 + x), written once.
// Both products are bf16 WMMA tiles (16x16x16, float32 accumulators).
//
// Activations (x, mid, out) are read through L2 (ld.global.cg), never L1.
// x and out carry no __restrict__ here, so that dw_conv4_tile may run in
// place (x == out): every element of the residual is read by the thread that
// then writes it, so an in-place update is safe.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include <cstddef>

#include "vec.cuh"

namespace tuber_bottleneck {

using namespace nvcuda;
using tuber::Vec;
using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;              // channels per step
constexpr int kPadB = 8;                // bf16 padding of a shared row
constexpr int kPadF = 4;                // float padding of a shared row
constexpr int kTile = 8;                // dw_conv4: 8x8 pixels per tile
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kPix = kTile * kTile;     // dw_conv4: pixel rows of a tile
constexpr int kTaps = 27;
constexpr int kVecs = kChunk / 8;       // 16-byte bf16 vectors per slice
constexpr int kDwThreads = 256;         // dw_conv4: 8 warps
constexpr int kN4 = 128;                // dw_conv4: conv4 columns per step

// Eight channels at p as eight bf16 in one 16-byte vector, through L2.
__device__ __forceinline__ uint4 load8_bf16(const bf16* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  float f[8];
  Vec<float>::unpack(__ldcg(reinterpret_cast<const uint4*>(p)), f);
  Vec<float>::unpack(__ldcg(reinterpret_cast<const uint4*>(p + 4)), f + 4);
  return Vec<bf16>::pack(f);
}

// Eight channels at p as float, through L2.
__device__ __forceinline__ void load8_f32(const bf16* p, float* f) {
  Vec<bf16>::unpack(__ldcg(reinterpret_cast<const uint4*>(p)), f);
}
__device__ __forceinline__ void load8_f32(const float* p, float* f) {
  Vec<float>::unpack(__ldcg(reinterpret_cast<const uint4*>(p)), f);
  Vec<float>::unpack(__ldcg(reinterpret_cast<const uint4*>(p + 4)), f + 4);
}

__device__ __forceinline__ void store8(bf16* p, const float* f) {
  tuber::store_vec(p, Vec<bf16>::pack(f));
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  tuber::store_vec(p, Vec<float>::pack(f));
  tuber::store_vec(p + 4, Vec<float>::pack(f + 4));
}

// conv1_tile with kThreadsA threads: warp w owns pixel rows 16w..16w+15 of
// the tile's conv1_rows and its 64 columns (four accumulator tiles).
__host__ __device__ constexpr int conv1_rows(int threads) {
  return threads / 32 * 16;
}
// shared bytes of conv1_tile: A tile, B tile (bf16), float32 result tile
__host__ __device__ constexpr size_t conv1_smem(int threads) {
  return static_cast<size_t>(conv1_rows(threads)) * (kChunk + kPadB) * 2 +
         static_cast<size_t>(kChunk) * (kChunk + kPadB) * 2 +
         static_cast<size_t>(conv1_rows(threads)) * (kChunk + kPadF) * 4;
}

// Rows row0.. of x (M pixel rows of Ci channels) times columns n0..n0+63 of
// w1 (Ci, Cm), affine and ReLU, to mid (M, Cm) bf16. `smem` holds
// conv1_smem(kThreadsA) bytes, 128-byte aligned.
template <int kThreadsA, typename T>
__device__ __forceinline__ void conv1_tile(
    const T* x, const bf16* __restrict__ w1, const float* __restrict__ a1,
    const float* __restrict__ b1, bf16* mid, long long M, int Ci, int Cm,
    long long row0, int n0, unsigned char* smem) {
  constexpr int kRows = conv1_rows(kThreadsA);
  constexpr int kLdB = kChunk + kPadB;
  constexpr int kLdF = kChunk + kPadF;
  bf16* a_s = reinterpret_cast<bf16*>(smem);                  // [kRows][kLdB]
  bf16* b_s = a_s + kRows * kLdB;                             // [64][kLdB]
  float* c_s = reinterpret_cast<float*>(b_s + kChunk * kLdB); // [kRows][kLdF]

  const int tid = threadIdx.x;
  const int warp = tid / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < Ci; k0 += kChunk) {
    for (int i = tid; i < kRows * kVecs; i += kThreadsA) {
      const int r = i / kVecs;
      const int v = i - r * kVecs;
      const long long row = row0 + r;
      *reinterpret_cast<uint4*>(a_s + r * kLdB + v * 8) =
          row < M ? load8_bf16(x + row * Ci + k0 + v * 8) : tuber::zero_vec();
    }
    for (int i = tid; i < kChunk * kVecs; i += kThreadsA) {
      const int r = i / kVecs;
      const int v = i - r * kVecs;
      *reinterpret_cast<uint4*>(b_s + r * kLdB + v * 8) =
          tuber::load_vec(w1 + static_cast<size_t>(k0 + r) * Cm + n0 + v * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_s + warp * 16 * kLdB + kk, kLdB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, b_s + kk * kLdB + j * 16, kLdB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(c_s + warp * 16 * kLdF + j * 16, acc[j], kLdF,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kRows * kVecs; i += kThreadsA) {
    const int r = i / kVecs;
    const int v = i - r * kVecs;
    const long long row = row0 + r;
    if (row >= M) continue;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + v * 8 + j;
      f[j] = tuber::relu(fmaf(c_s[r * kLdF + v * 8 + j], a1[c], b1[c]));
    }
    store8(mid + row * Cm + n0 + v * 8, f);
  }
  // c_s is rewritten after the next tile's first barrier: no sync needed
}

// Shared memory of dw_conv4_tile: a region that holds the mid halo of one
// 64-channel slice (3 frames x 10x10 pixels) and later the float32 conv4
// tile (64 x 128), the slice's 27 depthwise taps in float32, and mdw
// (64 pixels x Cm, bf16).
constexpr size_t kHaloBytes = 3 * kHaloPix * kChunk * sizeof(bf16);
constexpr size_t kEpiBytes = kPix * (kN4 + kPadF) * sizeof(float);
constexpr size_t kRegionBytes = kHaloBytes > kEpiBytes ? kHaloBytes : kEpiBytes;
constexpr size_t kTapBytes = kTaps * kChunk * sizeof(float);
static_assert(kRegionBytes % 128 == 0 && kTapBytes % 128 == 0,
              "shared sub-buffers stay 128-byte aligned");

inline size_t dw_conv4_smem(int Cm) {
  return kRegionBytes + kTapBytes +
         static_cast<size_t>(kPix) * (Cm + kPadB) * sizeof(bf16);
}

// The tile (b, t, h0.., w0..) of one block, with kDwThreads threads. x is
// the residual, out the output, both (B,T,H,W,Ci); they may be the same
// buffer. With `round_out` the output is rounded to bf16 (the chain's
// blocks but the last) before it is stored in T. `smem` holds
// dw_conv4_smem(Cm) bytes, 128-byte aligned. Ends with a barrier.
template <typename T>
__device__ __forceinline__ void dw_conv4_tile(
    const T* x, const bf16* mid, const bf16* __restrict__ wd,
    const bf16* __restrict__ w4, const float* __restrict__ a3,
    const float* __restrict__ b3, const float* __restrict__ a4,
    const float* __restrict__ b4, T* out, int b, int t, int h0, int w0,
    int frames, int H, int W, int Ci, int Cm, bool round_out,
    unsigned char* smem) {
  uint4* halo = reinterpret_cast<uint4*>(smem);          // [3*100][kVecs]
  float* c_s = reinterpret_cast<float*>(smem);           // [64][kN4+kPadF]
  float* w_s = reinterpret_cast<float*>(smem + kRegionBytes);  // [27][64]
  bf16* m_s = reinterpret_cast<bf16*>(smem + kRegionBytes + kTapBytes);
  const int ldm = Cm + kPadB;                             // m_s row stride

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const size_t frame0 = static_cast<size_t>(b) * frames;

  // depthwise + affine + ReLU, one 64-channel slice at a time, into m_s
  for (int c0 = 0; c0 < Cm; c0 += kChunk) {
    for (int i = tid; i < kTaps * kChunk; i += kDwThreads) {
      const int tap = i / kChunk;
      w_s[i] = tuber::to_f32(wd[tap * Cm + c0 + i - tap * kChunk]);
    }
    for (int i = tid; i < 3 * kHaloPix * kVecs; i += kDwThreads) {
      const int fp = i / kVecs;                  // frame * 100 + pixel
      const int v = i - fp * kVecs;
      const int f = t - 1 + fp / kHaloPix;
      const int p = fp % kHaloPix;
      const int h = h0 - 1 + p / kHalo;
      const int w = w0 - 1 + p % kHalo;
      uint4 val = tuber::zero_vec();
      if (f >= 0 && f < frames && h >= 0 && h < H && w >= 0 && w < W)
        val = load8_bf16(
            mid + ((frame0 + f) * H + h) * static_cast<size_t>(W) * Cm +
            static_cast<size_t>(w) * Cm + c0 + v * 8);
      halo[i] = val;
    }
    __syncthreads();
    for (int i = tid; i < kPix * kVecs; i += kDwThreads) {
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
    for (int i = tid; i < kPix * (kN4 / 8); i += kDwThreads) {
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
      for (int j = 0; j < 8; ++j) {
        f[j] = tuber::relu(
            fmaf(c_s[p * (kN4 + kPadF) + v * 8 + j], a4[c + j], b4[c + j]) +
            xr[j]);
        if (round_out) f[j] = __bfloat162float(__float2bfloat16(f[j]));
      }
      store8(out + pix * Ci + c, f);
    }
    __syncthreads();             // c_s is rewritten by the next step
  }
}

}  // namespace tuber_bottleneck
