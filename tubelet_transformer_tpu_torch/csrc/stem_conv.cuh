// The direct 3x7x7 / stride (1,2,2) / pad (1,3,3) conv of the irCSN stem,
// 3 -> 64 channels, as the two stem kernels share it (stem.cu, pooled
// output; stem_stats.cu, batch statistics). One block owns one (b, t) frame
// and a kCT x kCT tile of conv outputs. For each of the three input frames it
// stages the (2*kCT+5)^2 x 3 input halo (zero padding applied as it is
// loaded: the gather that replaces the TPU's `_deinterleave`) and that
// frame's 147x64 weights in shared memory as f32; each thread accumulates
// its conv pixels x 8 channels in f32 registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace tuber_stem {

constexpr int kCout = 64;
constexpr int kFrameTaps = 7 * 7 * 3;         // (kh, kw, c) taps of one frame
constexpr int kWElems = kFrameTaps * kCout;   // 9408
constexpr int kThreads = 256;
constexpr int kChanGroups = 8;                // 8 channels per thread
constexpr int kPixGroups = kThreads / kChanGroups;   // 32

// The input rows that a launch holds (spatial parallelism: a model peer's
// rows of the clip and their halo): x holds global rows [row0, row0 + rows)
// of a clip of height H, and a halo row is read where it lies in [lo, hi) =
// [max(0, row0), min(H, row0 + rows)), zero elsewhere, so the zero padding
// stays at the clip's border. The whole clip is {0, H, 0, H}.
struct Slab {
  int row0, rows, lo, hi;
};

__host__ __device__ inline Slab make_slab(int row0, int rows, int H) {
  return Slab{row0, rows, row0 > 0 ? row0 : 0,
              row0 + rows < H ? row0 + rows : H};
}

// input halo edge and conv pixels per thread of a kCT x kCT conv tile
__host__ __device__ constexpr int halo_edge(int ct) { return 2 * (ct - 1) + 7; }
__host__ __device__ constexpr int pix_per_thread(int ct) {
  return (ct * ct + kPixGroups - 1) / kPixGroups;
}
// shared floats of the accumulation: one frame's weights and its halo
__host__ __device__ constexpr int conv_smem_floats(int ct) {
  return kWElems + halo_edge(ct) * halo_edge(ct) * 3;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Thread (cg, pg) = (tid % 8, tid / 8) owns channels {4cg..4cg+3} and
// {32+4cg..32+4cg+3}, so the eight threads of a quarter warp read 128
// contiguous bytes of weights; accumulator j holds channel_of(cg, j).
__device__ __forceinline__ int channel_of(int cg, int j) {
  return (j < 4 ? 0 : 32) + cg * 4 + (j & 3);
}

// The bare conv of conv pixels pg, pg+32, ... of the tile whose first conv
// pixel is (cy0, cx0) (a global row), in frame `bt` (= b * frames + t) of x
// (B,T,slab.rows,W,3); w is (3,7,7,3,64). A slot past the tile's last pixel
// computes pixel 0 and is left to the caller to ignore. Ends with a
// barrier-free accumulation: the caller syncs before it reuses `smem`.
template <int kCT, typename T>
__device__ __forceinline__ void conv_tile(
    const T* __restrict__ x, const T* __restrict__ w, float* smem, int bt,
    int t, int frames, const Slab& slab, int W, int cy0, int cx0,
    float (&acc)[pix_per_thread(kCT)][8]) {
  constexpr int kIT = halo_edge(kCT);
  constexpr int kInElems = kIT * kIT * 3;
  constexpr int kPix = pix_per_thread(kCT);
  float* w_s = smem;               // [kFrameTaps][64], one input frame
  float* in_s = smem + kWElems;    // [kIT][kIT][3]

  const int tid = threadIdx.x;
  const int cg = tid % kChanGroups;
  const int pg = tid / kChanGroups;
  const int iy0 = 2 * cy0 - 3;     // first input row of the halo
  const int ix0 = 2 * cx0 - 3;

  int off[kPix];                   // halo offset of each owned conv pixel
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    int p = pg + k * kPixGroups;
    p = p < kCT * kCT ? p : 0;
    off[k] = (2 * (p / kCT) * kIT + 2 * (p % kCT)) * 3;
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;

  for (int kt = 0; kt < 3; ++kt) {
    const int tt = t + kt - 1;
    if (tt < 0 || tt >= frames) continue;  // zero temporal padding
    __syncthreads();               // the previous frame's reads are done
    const T* wk = w + kt * kWElems;
    for (int i = tid; i < kWElems; i += kThreads) w_s[i] = to_f32(wk[i]);
    const T* xf = x + static_cast<size_t>(bt + kt - 1) * slab.rows * W * 3;
    for (int i = tid; i < kInElems; i += kThreads) {
      const int r = i / (kIT * 3);
      const int rem = i - r * (kIT * 3);
      const int s = rem / 3;
      const int c = rem - s * 3;
      const int iy = iy0 + r;
      const int ix = ix0 + s;
      float v = 0.f;
      if (iy >= slab.lo && iy < slab.hi && ix >= 0 && ix < W)
        v = to_f32(
            xf[(static_cast<size_t>(iy - slab.row0) * W + ix) * 3 + c]);
      in_s[i] = v;
    }
    __syncthreads();

    for (int kh = 0; kh < 7; ++kh) {
      const float* in_row = in_s + kh * kIT * 3;
      const float* w_row = w_s + kh * 7 * 3 * kCout + cg * 4;
#pragma unroll
      for (int kwc = 0; kwc < 21; ++kwc) {       // (kw, c), kw*3 + c
        const float4 wa = *reinterpret_cast<const float4*>(w_row + kwc * kCout);
        const float4 wb =
            *reinterpret_cast<const float4*>(w_row + kwc * kCout + 32);
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float v = in_row[off[k] + kwc];
          acc[k][0] = fmaf(v, wa.x, acc[k][0]);
          acc[k][1] = fmaf(v, wa.y, acc[k][1]);
          acc[k][2] = fmaf(v, wa.z, acc[k][2]);
          acc[k][3] = fmaf(v, wa.w, acc[k][3]);
          acc[k][4] = fmaf(v, wb.x, acc[k][4]);
          acc[k][5] = fmaf(v, wb.y, acc[k][5]);
          acc[k][6] = fmaf(v, wb.z, acc[k][6]);
          acc[k][7] = fmaf(v, wb.w, acc[k][7]);
        }
      }
    }
  }
}

}  // namespace tuber_stem
