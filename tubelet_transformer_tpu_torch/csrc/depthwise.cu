// Depthwise (channel-separated) 3x3x3 conv on Hopper: stride 1, zero padding
// 1 in T, H and W, channels-last in and out. x (B,T,H,W,C), w (3,3,3,C),
// both bf16 or both float32; optionally y = relu?(y * scale + bias) with
// float32 scale and bias (C,), applied to the float32 sum before the one
// rounding to the output type.
//
// Replaces two TPU kernels of tubelet_transformer_tpu/ops/pallas/depthwise.py:
// `_dw_pallas` (the bare conv, W*C flattened onto the TPU's lanes) and
// `_dw_pallas_v2` (T-blocked, padding in the kernel, the fused affine + ReLU
// epilogue). On the TPU the flattening is what keeps C = 64 from leaving half
// of each 128-lane vector empty; on Hopper a thread holds 16 bytes of
// channels (8 bf16 or 4 float) and a warp covers whole 128-byte pixels, so
// the layout needs no such trick.
//
// What bounds it: at the main path's shape, layer1 of CSN-152 at 256 px,
// (1,32,64,64,64) bf16, the conv reads 16.8 MB and writes 16.8 MB (10.0 us at
// 3.35 TB/s) for 0.45 GFLOP of float32 FMAs (6.8 us at the 67 TFLOP/s
// CUDA-core peak): bound by bytes. The design reads each input element from
// device memory about once: a block owns an 8x8 pixel tile of up to 64
// channels of one clip over 4 frames, keeps a ring of 3 zero-padded 10x10
// halo frames in shared memory, and loads one new frame per output frame
// (16-byte loads, whole pixels per warp). The halo (1.56x) and the frames
// before and after the block's four (1.5x) are read again, mostly from L2.
// Each thread sums 27 taps x 8 (bf16) or 4 (float) channels of one output
// pixel in float32 and writes them as one 16-byte store. The model's two
// layout copies around the conv (channels-first and back) are gone.

#include "vec.cuh"

namespace {

using tuber::Vec;

constexpr int kTile = 8;                   // output pixels per tile edge
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;    // 100
constexpr int kFrames = 4;                 // output frames per block
constexpr int kSlice = 64;                 // channels per block
constexpr int kTaps = 27;
constexpr int kThreads = 256;

template <typename T>
constexpr size_t smem_bytes() {
  return kTaps * kSlice * sizeof(float) +
         3 * kHaloPix * (kSlice / Vec<T>::kN) * sizeof(uint4);
}

// The 10x10 halo of frame f around the tile at (h0, w0), channels
// [c0, c0 + nv * kN), zero outside the clip: dst[pixel][vector].
template <typename T>
__device__ __forceinline__ void load_frame(const T* __restrict__ x, uint4* dst,
                                           int b, int f, int frames, int H,
                                           int W, int C, int c0, int nv,
                                           int h0, int w0) {
  const bool frame_in = f >= 0 && f < frames;
  for (int i = threadIdx.x; i < kHaloPix * nv; i += kThreads) {
    const int p = i / nv;
    const int v = i - p * nv;
    const int h = h0 - 1 + p / kHalo;
    const int w = w0 - 1 + p % kHalo;
    uint4 val = tuber::zero_vec();
    if (frame_in && h >= 0 && h < H && w >= 0 && w < W)
      val = tuber::load_vec(
          x + ((static_cast<size_t>(b * frames + f) * H + h) * W + w) * C +
          c0 + v * Vec<T>::kN);
    dst[i] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int frames, int H, int W, int C, int tiles_x, int relu) {
  constexpr int kN = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);       // [27][kSlice]
  uint4* ring = reinterpret_cast<uint4*>(smem + kTaps * kSlice * sizeof(float));

  const int tid = threadIdx.x;
  const int h0 = (blockIdx.x / tiles_x) * kTile;
  const int w0 = (blockIdx.x % tiles_x) * kTile;
  const int n_slices = (C + kSlice - 1) / kSlice;
  const int c0 = (blockIdx.y % n_slices) * kSlice;
  const int t0 = (blockIdx.y / n_slices) * kFrames;
  const int t1 = min(t0 + kFrames, frames);
  const int b = blockIdx.z;
  const int cs = min(kSlice, C - c0);
  const int nv = cs / kN;                           // vectors per pixel
  const int frame_vecs = kHaloPix * nv;

  for (int i = tid; i < kTaps * cs; i += kThreads) {
    const int tap = i / cs;
    const int c = i - tap * cs;
    w_s[tap * kSlice + c] = tuber::to_f32(w[tap * C + c0 + c]);
  }
  // ring slot of frame f is (f - t0 + 1) % 3
  load_frame(x, ring, b, t0 - 1, frames, H, W, C, c0, nv, h0, w0);
  load_frame(x, ring + frame_vecs, b, t0, frames, H, W, C, c0, nv, h0, w0);
  for (int t = t0; t < t1; ++t) {
    const int s = t - t0;
    load_frame(x, ring + ((s + 2) % 3) * frame_vecs, b, t + 1, frames, H, W,
               C, c0, nv, h0, w0);
    __syncthreads();
    for (int i = tid; i < kTile * kTile * nv; i += kThreads) {
      const int p = i / nv;
      const int v = i - p * nv;
      const int py = p / kTile;
      const int px = p % kTile;
      const int h = h0 + py;
      const int wc = w0 + px;
      if (h >= H || wc >= W) continue;
      float acc[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[j] = 0.f;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const uint4* fr = ring + ((s + dt) % 3) * frame_vecs;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            float xv[kN];
            Vec<T>::unpack(fr[((py + dh) * kHalo + px + dw) * nv + v], xv);
            const float* wt = w_s + ((dt * 3 + dh) * 3 + dw) * kSlice + v * kN;
#pragma unroll
            for (int j = 0; j < kN; j += 4) {
              const float4 wq = *reinterpret_cast<const float4*>(wt + j);
              acc[j] = fmaf(xv[j], wq.x, acc[j]);
              acc[j + 1] = fmaf(xv[j + 1], wq.y, acc[j + 1]);
              acc[j + 2] = fmaf(xv[j + 2], wq.z, acc[j + 2]);
              acc[j + 3] = fmaf(xv[j + 3], wq.w, acc[j + 3]);
            }
          }
      }
      const int c = c0 + v * kN;
      if (scale != nullptr) {
#pragma unroll
        for (int j = 0; j < kN; ++j) acc[j] = fmaf(acc[j], scale[c + j], bias[c + j]);
      }
      if (relu) {
#pragma unroll
        for (int j = 0; j < kN; ++j) acc[j] = tuber::relu(acc[j]);
      }
      tuber::store_vec(
          out + ((static_cast<size_t>(b * frames + t) * H + h) * W + wc) * C + c,
          Vec<T>::pack(acc));
    }
    __syncthreads();               // frame t-1's slot is reloaded next
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int batch, int frames, int H, int W, int C, int relu,
           void* stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      depthwise_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_y = (H + kTile - 1) / kTile;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int n_slices = (C + kSlice - 1) / kSlice;
  const dim3 grid(tiles_y * tiles_x, ((frames + kFrames - 1) / kFrames) * n_slices,
                  batch);
  depthwise_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), frames, H, W, C, tiles_x, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. x, w and out have the element type in the
// name; scale and bias are float32 (C,) or both null; every pointer is device
// memory. C must be a multiple of 8 (bf16) or 4 (float32). The launch goes on
// `stream` and does not synchronise. Returns a cudaError_t.
extern "C" int tuber_depthwise_bf16(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int batch, int frames, int H,
                                    int W, int C, int relu, void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, bias, out, batch, frames, H, W, C,
                               relu, stream);
}

extern "C" int tuber_depthwise_f32(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int batch, int frames, int H,
                                   int W, int C, int relu, void* stream) {
  return launch<float>(x, w, scale, bias, out, batch, frames, H, W, C, relu,
                       stream);
}
