// Per-channel batch statistics of the irCSN stem's bare conv (3x7x7 /
// stride (1,2,2) / pad (1,3,3), 3 -> 64 channels, no affine, no ReLU): the
// train-mode BN mean and biased variance over (B, T, Hc, Wc), without ever
// writing the conv output to device memory. x (B,T,H,W,3), w (3,7,7,3,64) ->
// stats (2,64) float32: [0] mean, [1] var.
//
// Replaces `_stem_stats_matmul` of tubelet_transformer_tpu/ops/pallas/stem.py
// (phase 1 of the frozen-stem train path, via `stem_batch_stats`). The TPU
// kernel carries its sums in one output block that stays resident across a
// sequential grid; Hopper's blocks run in no order, so here each block writes
// its partial (sum, sum of squares) per channel and a second one-block pass
// adds the partials in a fixed order. The statistics are therefore the same
// bits from run to run, with no atomics.
//
// What bounds it: the conv of the train shape (2,32,256,256,3) is 59 GFLOP
// against 25 MB of bf16 input, and the output is 512 bytes: compute-bound.
// The conv output (134 MB in bf16, 268 MB in f32 at that shape) stays in
// registers: each thread adds its 8 conv pixels x 8 channels of f32
// accumulators into y and y^2 sums, warp shuffles add the four pixel groups
// of a warp, and shared memory the eight warps of the block.
//
// The accumulation is the direct conv of stem_conv.cuh (shared with the
// pooled kernel, stem.cu) on a 16x16 conv tile: a 37x37x3 halo, 8 conv pixels
// per thread, no recomputed pixels. Conv pixels past the image's bottom or
// right edge (the tiles' ragged edge; the TPU kernel's ghost lanes for
// W' < 128) are left out of the sums.
//
// The variance keeps the JAX formula, E[y^2] - E[y]^2 in float32, so that
// the port matches it; it cancels when |mean| >> std. The cross-block sums are
// taken in double before the division by n.

#include "stem_conv.cuh"

namespace {

using namespace tuber_stem;

constexpr int kCT = 16;                       // conv tile edge
constexpr int kPixPerThread = pix_per_thread(kCT);                       // 8
constexpr int kWarps = kThreads / 32;
constexpr int kSmemFloats = conv_smem_floats(kCT);
constexpr int kFinalSlices = 8;               // threads per output value

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_stats_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          float* __restrict__ partial, int frames, int H,
                          int W, int Hc, int Wc, int tiles_x) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;       // b * frames + t
  const int t = bt % frames;
  const int cy0 = (blockIdx.x / tiles_x) * kCT;
  const int cx0 = (blockIdx.x % tiles_x) * kCT;
  const int cg = tid % kChanGroups;
  const int pg = tid / kChanGroups;

  float acc[kPixPerThread][8];
  conv_tile<kCT>(x, w, smem, bt, t, frames, H, W, cy0, cx0, acc);

  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = pg + k * kPixGroups;
    if (cy0 + p / kCT >= Hc || cx0 + p % kCT >= Wc) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] += acc[k][j];
      q[j] = fmaf(acc[k][j], acc[k][j], q[j]);
    }
  }
  // lanes l, l^8, l^16, l^24 of a warp hold the same channels
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] += __shfl_xor_sync(0xffffffffu, s[j], 8);
    s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
    q[j] += __shfl_xor_sync(0xffffffffu, q[j], 8);
    q[j] += __shfl_xor_sync(0xffffffffu, q[j], 16);
  }
  __syncthreads();                 // halo and weights are no longer read
  float* red = smem;               // [kWarps][2][64]
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (lane < kChanGroups) {        // lane == cg
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[(warp * 2 + 0) * kCout + channel_of(cg, j)] = s[j];
      red[(warp * 2 + 1) * kCout + channel_of(cg, j)] = q[j];
    }
  }
  __syncthreads();
  if (tid < 2 * kCout) {           // tid = stat * 64 + channel
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp)
      v += red[(wp * 2 + tid / kCout) * kCout + tid % kCout];
    const size_t block = static_cast<size_t>(blockIdx.y) * gridDim.x +
                         blockIdx.x;
    partial[block * 2 * kCout + tid] = v;
  }
}

// One block of 8 x 128 threads: slice i of value v adds partials i, i+8, ...
// in double; the eight slices are added in order.
__global__ void __launch_bounds__(kFinalSlices * 2 * kCout)
stem_stats_finalize_kernel(const float* __restrict__ partial, int n_blocks,
                           double count, float* __restrict__ stats) {
  __shared__ double part[kFinalSlices][2 * kCout];
  const int v = threadIdx.x % (2 * kCout);
  const int slice = threadIdx.x / (2 * kCout);
  double acc = 0.0;
  for (int b = slice; b < n_blocks; b += kFinalSlices)
    acc += partial[static_cast<size_t>(b) * 2 * kCout + v];
  part[slice][v] = acc;
  __syncthreads();
  if (threadIdx.x < kCout) {
    const int c = threadIdx.x;
    double sum = 0.0, sq = 0.0;
    for (int i = 0; i < kFinalSlices; ++i) {
      sum += part[i][c];
      sq += part[i][kCout + c];
    }
    const float mean = static_cast<float>(sum / count);
    const float ex2 = static_cast<float>(sq / count);
    stats[c] = mean;
    stats[kCout + c] = ex2 - mean * mean;
  }
}

struct Geometry {
  int Hc, Wc, tiles_x, tiles;
};

Geometry geometry(int H, int W) {
  Geometry g;
  g.Hc = (H - 1) / 2 + 1;           // conv 7 / stride 2 / pad 3
  g.Wc = (W - 1) / 2 + 1;
  g.tiles_x = (g.Wc + kCT - 1) / kCT;
  g.tiles = ((g.Hc + kCT - 1) / kCT) * g.tiles_x;
  return g;
}

template <typename T>
int launch(const void* x, const void* w, void* partial, void* stats,
           int batch, int frames, int H, int W, void* stream) {
  const Geometry g = geometry(H, W);
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_stats_partial_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(g.tiles, batch * frames);
  stem_stats_partial_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<float*>(partial), frames, H, W, g.Hc, g.Wc, g.tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const double count = static_cast<double>(batch) * frames * g.Hc * g.Wc;
  stem_stats_finalize_kernel<<<1, kFinalSlices * 2 * kCout, 0, s>>>(
      static_cast<const float*>(partial), g.tiles * batch * frames, count,
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Every pointer is device memory; the
// launches go on `stream` and do not synchronise. `partial` is float32 scratch
// of tuber_stem_stats_partials(...) elements, `stats` float32 (2, 64).
// Returns a cudaError_t.
extern "C" int tuber_stem_stats_partials(int batch, int frames, int H, int W) {
  return geometry(H, W).tiles * batch * frames * 2 * kCout;
}

extern "C" int tuber_stem_stats_bf16(const void* x, const void* w,
                                     void* partial, void* stats, int batch,
                                     int frames, int H, int W, void* stream) {
  return launch<__nv_bfloat16>(x, w, partial, stats, batch, frames, H, W,
                               stream);
}

extern "C" int tuber_stem_stats_f32(const void* x, const void* w,
                                    void* partial, void* stats, int batch,
                                    int frames, int H, int W, void* stream) {
  return launch<float>(x, w, partial, stats, batch, frames, H, W, stream);
}
