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
// tile bodies of bottleneck_tile.cuh (the stage chain, stage.cu, has its
// own): conv1 stages x and w1 in shared memory 64 channels at a time;
// conv4 reads its A tiles from the block's mdw in shared memory and its B
// tiles of w4 (128 KB, shared by every block) through L1 and L2.
//
// What bounds it: at the main path's shape, layer2 of CSN-152 at 256 px,
// (1,16,32,32,512) bf16 with Cm = 128, the function must read x (16.8 MB) and
// write out (16.8 MB): 10.0 us at 3.35 TB/s; its two products are 4.3 GFLOP,
// 4.3 us at the 989 TFLOP/s bf16 tensor-core peak: bound by bytes. This
// design moves 16.8 MB (x, conv1) + 4.2 MB (mid) + 4.2 MB x 1.56 x 3 (mid
// halos) + 16.8 MB (x, residual) + 16.8 MB (out), about 75 MB, most of the
// mid halo from L2; the TPU kernel's two reads of x and one write are the
// floor it approaches when the ring of mids stays on chip.

#include "bottleneck_tile.cuh"

namespace {

using namespace tuber_bottleneck;

constexpr int kConv1Threads = 128;      // 4 warps x 16 rows
constexpr int kRows = conv1_rows(kConv1Threads);

// Kernel 1. Grid (ceil(M / 64), Cm / 64).
template <typename T>
__global__ void __launch_bounds__(kConv1Threads)
conv1_kernel(const T* __restrict__ x, const bf16* __restrict__ w1,
             const float* __restrict__ a1, const float* __restrict__ b1,
             bf16* __restrict__ mid, long long M, int Ci, int Cm) {
  __shared__ __align__(128) unsigned char smem[conv1_smem(kConv1Threads)];
  conv1_tile<kConv1Threads>(x, w1, a1, b1, mid, M, Ci, Cm,
                            static_cast<long long>(blockIdx.x) * kRows,
                            blockIdx.y * kChunk, smem);
}

// Kernel 2. Grid (tiles_y * tiles_x, T, B).
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
dw_conv4_kernel(const T* __restrict__ x, const bf16* __restrict__ mid,
                const bf16* __restrict__ wd, const bf16* __restrict__ w4,
                const float* __restrict__ a3, const float* __restrict__ b3,
                const float* __restrict__ a4, const float* __restrict__ b4,
                T* __restrict__ out, int frames, int H, int W, int Ci, int Cm,
                int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  dw_conv4_tile(x, mid, wd, w4, a3, b3, a4, b4, out, blockIdx.z, blockIdx.y,
                (blockIdx.x / tiles_x) * kTile, (blockIdx.x % tiles_x) * kTile,
                frames, H, W, Ci, Cm, false, smem);
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
  dw_conv4_kernel<T><<<grid2, kDwThreads, smem, s>>>(
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
