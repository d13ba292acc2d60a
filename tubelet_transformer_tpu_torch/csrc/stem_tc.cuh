// The bf16 tensor-core body of the irCSN stem's conv (3x7x7 / stride (1,2,2)
// / pad (1,3,3), 3 -> 64 channels) as an implicit GEMM, shared by the pooled
// kernel (stem.cu: stem_pool_tc_kernel) and the statistics kernel
// (stem_stats.cu: stem_stats_tc_kernel). mma.sync.m16n8k16 (mma.cuh), bf16
// in, float32 sums.
//
// A work item is one (b, t) frame and a CT x CT tile of conv pixels: M = CT^2
// conv pixels in row tiles of 16, N = 64 channels, K = 3 frames x 7 kernel
// rows x 21 (kw, c) inputs, each run of 21 padded to 22 slots and each frame
// to 160: 480. For a fixed (frame, kernel row) the 21 inputs of a conv pixel
// are contiguous in a channels-last halo row, so the A fragments are 32-bit
// shared loads straight from the input halo (a pixel's base offset plus a
// table of k offsets; the pad slot of each run is masked to zero, so a
// non-finite neighbour cannot leak in), with no im2col buffer. The weights
// (480 x 64 bf16) go into shared memory once per persistent block by
// cp.async. Input rows start at any 2-byte offset, so a halo cannot be
// copied in 16-byte pieces: it comes through registers (fetch_halo, then
// stash_halo), which lets a kernel load the next (tile, frame) while the
// current one multiplies. The block is 16 warps, 4 (groups of row tiles) x 4
// (16-channel groups): the warps hide each other's shared-load latency.

#pragma once

#include <cstdint>

#include "mma.cuh"
#include "stem_conv.cuh"

namespace tuber_stem_tc {

using bf16 = __nv_bfloat16;
using tuber_stem::kCout;
using tuber_stem::kFrameTaps;

constexpr int kThreadsTc = 512;                 // 16 warps
constexpr int kRun = 22;                        // a (kt, kh) run of 21, padded
constexpr int kSlotsF = 160;                    // k of a frame: 7 x 22 + 6
constexpr int kStepsF = kSlotsF / 16;           // k16 steps of a frame
constexpr int kPairsF = kSlotsF / 2;            // k pairs of a frame
constexpr int kPairsUsed = 7 * kRun / 2;        // 77: the rest are zero
constexpr int kKRows = 3 * kSlotsF;             // 480
constexpr int kLdW = kCout + 8;                 // weight row stride
constexpr size_t kWBytes = static_cast<size_t>(kKRows) * kLdW * 2;
constexpr size_t kTabBytes = kPairsF * 8;       // k offsets and masks
static_assert(kWBytes % 16 == 0, "the weights stay 16-byte aligned");

// The input halo of a CT x CT conv tile: kIT rows of kIT pixels x 3
// channels, each row padded to kLd bf16 (even, and past the last pixel's
// pad slot: 6 (CT - 1) + 21 < kLd).
template <int CT>
struct Halo {
  static constexpr int kIT = tuber_stem::halo_edge(CT);
  static constexpr int kRowElems = kIT * 3;
  static constexpr int kLd = (kRowElems + 1 + 7) / 8 * 8;
  static constexpr int kFrameElems = kIT * kLd;     // one frame's buffer
  static constexpr int kElems = kIT * kRowElems;    // inputs of a frame
  static constexpr int kPerThread = (kElems + kThreadsTc - 1) / kThreadsTc;
  static constexpr size_t kBytes = 3 * static_cast<size_t>(kFrameElems) * 2;
  static_assert(kBytes % 16 == 0, "the halo stays 16-byte aligned");
};

// One frame (kt = 0, 1, 2 for t-1, t, t+1) of the halo whose first input
// row and column are (iy0, ix0) around output frame bt = b * frames + t,
// into registers as bf16 bits; zeros outside the clip and the frame.
// Thread i holds halo elements i, i + 512, ... (row-major).
template <int CT>
__device__ __forceinline__ void fetch_halo(
    unsigned short (&r)[Halo<CT>::kPerThread],
    const unsigned short* __restrict__ x, int bt, int kt, int iy0, int ix0,
    int frames, int H, int W) {
  using Hl = Halo<CT>;
  const int tt = bt % frames + kt - 1;
  const bool frame_ok = tt >= 0 && tt < frames;
  const unsigned short* xf =
      x + (frame_ok ? static_cast<size_t>(bt + kt - 1) * H * W * 3 : 0);
#pragma unroll
  for (int j = 0; j < Hl::kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreadsTc;
    const int row = e / Hl::kRowElems;
    const int q = e - row * Hl::kRowElems;          // 3 * column + channel
    const int iy = iy0 + row;
    const int ix = ix0 + q / 3;
    unsigned short v = 0;
    if (frame_ok && e < Hl::kElems && iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = __ldg(xf + static_cast<size_t>(iy) * W * 3 + ix0 * 3 + q);
    r[j] = v;
  }
}

template <int CT>
__device__ __forceinline__ void stash_halo(
    const unsigned short (&r)[Halo<CT>::kPerThread], unsigned short* hb) {
  using Hl = Halo<CT>;
#pragma unroll
  for (int j = 0; j < Hl::kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreadsTc;
    const int row = e / Hl::kRowElems;
    if (e < Hl::kElems) hb[row * Hl::kLd + e - row * Hl::kRowElems] = r[j];
  }
}

// B: k row (kt, kh, j) is w's row (kt, kh, kw, c) for j = 3 kw + c < 21,
// zero for the pad slots, by one committed group of async copies. A: k pair
// P of a frame is halo offset kh * ld + 2 j (P = 11 kh + j); its second half
// is the pad slot where j = 10, and both are zero past 77. Once per block;
// the caller waits for the copies and syncs before the first product.
__device__ __forceinline__ void load_weights_and_tables(
    bf16* w_s, const bf16* __restrict__ w, int* tab_off, uint32_t* tab_mask,
    int ld) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kKRows * 8; i += kThreadsTc) {
    const int row = i >> 3;
    const int c = i & 7;
    const int kt = row / kSlotsF;
    const int kh = (row - kt * kSlotsF) / kRun;
    const int j = row - kt * kSlotsF - kh * kRun;
    bf16* dst = w_s + row * kLdW + c * 8;
    if (kh < 7 && j < 21)
      tuber_mma::cp_async16(
          dst, w + static_cast<size_t>(kt * kFrameTaps + kh * 21 + j) * kCout +
                   c * 8,
          true);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  tuber_mma::cp_async_commit();
  for (int i = tid; i < kPairsF; i += kThreadsTc) {
    const int kh = i / 11;
    const int j = i - kh * 11;
    tab_off[i] = i < kPairsUsed ? kh * ld + 2 * j : 0;
    tab_mask[i] = i < kPairsUsed ? (j == 10 ? 0xFFFFu : 0xFFFFFFFFu) : 0u;
  }
}

// Halo offsets of the conv pixels (rows g and g + 8 of each of a warp's
// kWT row tiles, row tiles mg * kWT..) that lane g owns; pixels past the
// tile's CT^2 take pixel 0 (the caller leaves them out).
template <int CT, int kWT>
__device__ __forceinline__ void pixel_offsets(int (&poff)[kWT][2], int mg,
                                              int g) {
#pragma unroll
  for (int i = 0; i < kWT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = (mg * kWT + i) * 16 + g + 8 * h;
      p = p < CT * CT ? p : 0;
      poff[i][h] = 2 * (p / CT) * Halo<CT>::kLd + 6 * (p % CT);
    }
}

// acc[i][ni] += the products of one input frame: the halo hb (one frame
// buffer) against that frame's 160 k rows of weights wb, for the warp's
// row tiles mg * kWT + i < kMTiles and its 16 channels ng * 16...
template <int kWT, int kMTiles>
__device__ __forceinline__ void frame_products(
    float (&acc)[kWT][2][4], const unsigned short* hb, const bf16* wb,
    const int* tab_off, const uint32_t* tab_mask, const int (&poff)[kWT][2],
    int lane, int mg, int ng) {
  const int t4 = lane & 3;
#pragma unroll 2
  for (int s = 0; s < kStepsF; ++s) {
    const int p0 = s * 8 + t4;
    const int o0 = tab_off[p0];
    const int o1 = tab_off[p0 + 4];
    const uint32_t m0 = tab_mask[p0];
    const uint32_t m1 = tab_mask[p0 + 4];
    uint32_t bfr[4];
    tuber_mma::ldsm_x4_t(bfr, wb + (s * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * kLdW +
                                   ng * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < kWT; ++i) {
      if (mg * kWT + i >= kMTiles) continue;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(hb + poff[i][0] + o0) & m0;
      a[1] = *reinterpret_cast<const uint32_t*>(hb + poff[i][1] + o0) & m0;
      a[2] = *reinterpret_cast<const uint32_t*>(hb + poff[i][0] + o1) & m1;
      a[3] = *reinterpret_cast<const uint32_t*>(hb + poff[i][1] + o1) & m1;
      tuber_mma::mma_bf16(acc[i][0], a, bfr[0], bfr[1]);
      tuber_mma::mma_bf16(acc[i][1], a, bfr[2], bfr[3]);
    }
  }
}

}  // namespace tuber_stem_tc
