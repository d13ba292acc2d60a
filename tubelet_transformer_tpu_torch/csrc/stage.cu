// K consecutive stride-1 identity ir-bottlenecks of an irCSN stage in one
// launch, inference. For block k = 0..K-1, on the stream y (y_0 = x):
//   mid     = relu((y_k @ w1[k]) * a1[k] + b1[k])              (bf16)
//   mdw     = relu(depthwise3x3x3(mid, wd[k]) * a3[k] + b3[k]) (bf16)
//   y_{k+1} = relu((mdw @ w4[k]) * a4[k] + b4[k] + y_k)
// x and out (B,T,H,W,Ci) channels-last, bf16 or float32; the stacked weights
// w1 (K,Ci,Cm), wd (K,3,3,3,Cm), w4 (K,Cm,Ci) bf16; the affines (K,Cm) and
// (K,Ci) float32. As in the TPU kernel, every y_k but the last is rounded to
// bf16; the last is rounded once, to x's type.
//
// Replaces `_chain_pallas` of tubelet_transformer_tpu/ops/pallas/stage.py.
// That kernel walks a sequential (b, t) grid and skews the K blocks two
// steps apart over rings of frames in VMEM, so one HBM read and one write of
// the stream serve the whole chain. Hopper's blocks run in no order and its
// shared memory holds no frame ring (a layer2 frame is 1 MiB), so the port
// is one cooperative kernel: every block is resident (the grid is at most
// what the occupancy calculator allows on all SMs), and for each k the
// blocks run two phases over the whole clip, separated by grid barriers:
//   phase A: conv1_tile over every (128-row, 64-column) tile -> mid;
//   phase B: dw_conv4_tile over every (b, t, 8x8) tile, in place on out.
// Phase B reads each residual element in the thread that then overwrites
// it, so block k's output replaces block k-1's: the chain needs one out and
// one mid buffer whatever K is, and at the flagship's batch of 1 the largest
// (layer2: 16.8 MB out + 4.2 MB mid) stays in the 50 MB L2 from block to
// block. The tile bodies are those of the fused bottleneck
// (bottleneck_tile.cuh).
//
// What bounds it: the function must read x and the stacked weights and
// write out; its products are 2 x pixels x K x (2 Ci Cm + 27 Cm) operations.
// At the flagship's layer3 tail (1,8,16,16,1024), Cm 256, K 35: 76 GFLOP,
// 77 us at the 989 TFLOP/s bf16 peak, against 46 MB (14 us at 3.35 TB/s):
// bound by operations. This design is far from it (6.4 ms there on an H100
// SXM at 700 W): phase B's conv4 loads its w4 fragments from L2 one after
// another, and the phases have few tiles where the frames are small
// (layer3's phase B has 32 tiles for 132 SMs), besides two grid barriers
// per block.

#include <cooperative_groups.h>

#include "bottleneck_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace tuber_bottleneck;

constexpr int kThreads = kDwThreads;                  // 8 warps
constexpr int kRowsA = conv1_rows(kThreads);          // 128 pixel rows

size_t chain_smem(int Cm) {
  const size_t a = conv1_smem(kThreads);
  const size_t b = dw_conv4_smem(Cm);
  return a > b ? a : b;
}

struct Work {
  int tiles_a, tiles_b, tiles_x, tiles_hw;
};

Work work(int batch, int frames, int H, int W, int Cm) {
  Work g;
  const long long M = static_cast<long long>(batch) * frames * H * W;
  g.tiles_a = static_cast<int>((M + kRowsA - 1) / kRowsA) * (Cm / kChunk);
  g.tiles_x = (W + kTile - 1) / kTile;
  g.tiles_hw = ((H + kTile - 1) / kTile) * g.tiles_x;
  g.tiles_b = g.tiles_hw * frames * batch;
  return g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chain_kernel(const T* x, const bf16* __restrict__ w1,
             const bf16* __restrict__ wd, const bf16* __restrict__ w4,
             const float* __restrict__ a1, const float* __restrict__ b1,
             const float* __restrict__ a3, const float* __restrict__ b3,
             const float* __restrict__ a4, const float* __restrict__ b4,
             bf16* mid, T* out, int batch, int frames, int H, int W, int Ci,
             int Cm, int K, Work g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const long long M = static_cast<long long>(batch) * frames * H * W;
  const int n_cols = Cm / kChunk;

  for (int k = 0; k < K; ++k) {
    const T* src = k == 0 ? x : out;
    const size_t wk = static_cast<size_t>(k) * Ci * Cm;
    for (int i = blockIdx.x; i < g.tiles_a; i += gridDim.x)
      conv1_tile<kThreads>(src, w1 + wk, a1 + k * Cm, b1 + k * Cm, mid, M,
                           Ci, Cm, static_cast<long long>(i / n_cols) * kRowsA,
                           (i % n_cols) * kChunk, smem);
    grid.sync();                 // mid is whole; src is no longer read
    for (int i = blockIdx.x; i < g.tiles_b; i += gridDim.x) {
      const int tile = i % g.tiles_hw;
      const int bt = i / g.tiles_hw;
      dw_conv4_tile(src, mid, wd + static_cast<size_t>(k) * kTaps * Cm,
                    w4 + wk, a3 + k * Cm, b3 + k * Cm, a4 + k * Ci,
                    b4 + k * Ci, out, bt / frames, bt % frames,
                    (tile / g.tiles_x) * kTile, (tile % g.tiles_x) * kTile,
                    frames, H, W, Ci, Cm, k + 1 < K, smem);
    }
    if (k + 1 < K) grid.sync();  // y_{k+1} is whole; mid is free
  }
}

// Blocks of the cooperative grid: every SM's share of resident blocks, no
// more than the larger phase has tiles. 0 with an error where the device
// cannot launch it.
template <typename T>
cudaError_t grid_blocks(int Cm, const Work& g, int* blocks) {
  *blocks = 0;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = chain_smem(Cm);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chain_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_kernel<T>, kThreads, smem);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  const int most = g.tiles_a > g.tiles_b ? g.tiles_a : g.tiles_b;
  *blocks = per_sm * sms < most ? per_sm * sms : most;
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, const void* w1, const void* wd, const void* w4,
           const void* a1, const void* b1, const void* a3, const void* b3,
           const void* a4, const void* b4, void* mid, void* out, int batch,
           int frames, int H, int W, int Ci, int Cm, int K, void* stream) {
  Work g = work(batch, frames, H, W, Cm);
  int blocks = 0;
  cudaError_t err = grid_blocks<T>(Cm, g, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xp = static_cast<const T*>(x);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* wdp = static_cast<const bf16*>(wd);
  const bf16* w4p = static_cast<const bf16*>(w4);
  const float* a1p = static_cast<const float*>(a1);
  const float* b1p = static_cast<const float*>(b1);
  const float* a3p = static_cast<const float*>(a3);
  const float* b3p = static_cast<const float*>(b3);
  const float* a4p = static_cast<const float*>(a4);
  const float* b4p = static_cast<const float*>(b4);
  bf16* midp = static_cast<bf16*>(mid);
  T* outp = static_cast<T*>(out);
  void* args[] = {&xp,  &w1p,  &wdp,  &w4p,  &a1p,   &b1p, &a3p,
                  &b3p, &a4p,  &b4p,  &midp, &outp,  &batch, &frames,
                  &H,   &W,    &Ci,   &Cm,   &K,     &g};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(chain_kernel<T>), dim3(blocks),
      dim3(kThreads), args, chain_smem(Cm),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. x and out have the element type in the
// name; the stacked w1, wd, w4 and mid (the (B,T,H,W,Cm) bf16 scratch) are
// bf16, the stacked affines float32; every pointer is device memory, x, w1,
// mid and out 16-byte aligned, w4 32-byte aligned (WMMA loads its tiles in
// place). Cm must be a multiple of 64 and Ci of 128. The launch goes on
// `stream` and does not synchronise. Returns a cudaError_t.
extern "C" int tuber_chain_bf16(
    const void* x, const void* w1, const void* wd, const void* w4,
    const void* a1, const void* b1, const void* a3, const void* b3,
    const void* a4, const void* b4, void* mid, void* out, int batch,
    int frames, int H, int W, int Ci, int Cm, int K, void* stream) {
  return launch<bf16>(x, w1, wd, w4, a1, b1, a3, b3, a4, b4, mid, out, batch,
                      frames, H, W, Ci, Cm, K, stream);
}

extern "C" int tuber_chain_f32(
    const void* x, const void* w1, const void* wd, const void* w4,
    const void* a1, const void* b1, const void* a3, const void* b3,
    const void* a4, const void* b4, void* mid, void* out, int batch,
    int frames, int H, int W, int Ci, int Cm, int K, void* stream) {
  return launch<float>(x, w1, wd, w4, a1, b1, a3, b3, a4, b4, mid, out,
                       batch, frames, H, W, Ci, Cm, K, stream);
}

// The blocks of the cooperative grid that tuber_chain_* launches for this
// shape on the current device (is_f32: x is float32), or -cudaError_t.
extern "C" int tuber_chain_blocks(int is_f32, int batch, int frames, int H,
                                  int W, int Cm) {
  const Work g = work(batch, frames, H, W, Cm);
  int blocks = 0;
  const cudaError_t err = is_f32 ? grid_blocks<float>(Cm, g, &blocks)
                                 : grid_blocks<bf16>(Cm, g, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
