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
// 16.8 MB of bf16 output, about 1000 FLOP per byte: compute-bound on any
// route. The pre-pool conv tensor (67 MB in bf16) never goes to device
// memory: each block keeps its conv tile in shared memory and pools it there.
//
// The design is the simple one: the FMAs run on the CUDA cores in f32
// (67 TFLOP/s peak on an H100 SXM, against 989 bf16 on the tensor cores).
// Each block owns one (b, t) and an 8x8 tile of pooled outputs, so a 17x17
// conv tile (the pool's 3x3 windows overlap by one conv row and column, which
// costs 13% recomputed FMAs). For each of the three input frames it stages
// the 39x39x3 input halo and that frame's 147x64 weights in shared memory as
// f32; each thread accumulates 10 conv pixels x 8 channels in registers
// (80 FMAs per 2 float4 weight loads and 10 input loads). Scale, bias and
// ReLU are applied to the f32 accumulator, the tile goes to shared memory and
// is max-pooled there, and the result is rounded once to the output type.
// Tensor cores (wgmma on an implicit-GEMM layout, K = 441 padded to 448), TMA
// loads and a persistent schedule are the way to the tensor-core bound.
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
// and this kernel runs them on the CUDA cores in f32, as the pooled one does.

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

constexpr int kCTc = 16;                      // unpooled conv tile edge
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
// name; scale and bias are float32; every pointer is device memory. The
// launch goes on `stream` and does not synchronise. Returns a cudaError_t.
extern "C" int tuber_stem_pool_bf16(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int batch, int frames, int H,
                                    int W, void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, bias, out, batch, frames, H, W,
                               stream);
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
