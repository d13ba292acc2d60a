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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kCout = 64;
constexpr int kFrameTaps = 7 * 7 * 3;        // (kh, kw, c) taps of one frame
constexpr int kPT = 8;                        // pooled tile edge
constexpr int kCT = 2 * kPT + 1;              // conv tile edge: 17
constexpr int kIT = 2 * (kCT - 1) + 7;        // input tile edge: 39
constexpr int kConvPix = kCT * kCT;           // 289
constexpr int kThreads = 256;
constexpr int kChanGroups = 8;                // 8 channels per thread
constexpr int kPixGroups = kThreads / kChanGroups;                      // 32
constexpr int kPixPerThread = (kConvPix + kPixGroups - 1) / kPixGroups;  // 10
constexpr int kInElems = kIT * kIT * 3;       // 4563
constexpr int kWElems = kFrameTaps * kCout;   // 9408
constexpr int kConvElems = kConvPix * kCout;  // 18496
constexpr int kSmemFloats =
    kWElems + kInElems > kConvElems ? kWElems + kInElems : kConvElems;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// Thread (cg, pg) owns channels {4cg..4cg+3} and {32+4cg..32+4cg+3}, so the
// eight threads of a quarter warp read 128 contiguous bytes of weights, and
// conv pixels pg, pg+32, ..., pg+288 of the 17x17 tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int frames, int H, int W, int Hc, int Wc, int Hp, int Wp,
                 int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;               // [kFrameTaps][64], one input frame
  float* in_s = smem + kWElems;    // [kIT][kIT][3]
  float* conv_s = smem;            // [kConvPix][64], after the accumulation

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;       // b * frames + t
  const int t = bt % frames;
  const int py0 = (blockIdx.x / tiles_x) * kPT;
  const int px0 = (blockIdx.x % tiles_x) * kPT;
  const int cy0 = 2 * py0 - 1;     // first conv row of the tile
  const int cx0 = 2 * px0 - 1;
  const int iy0 = 2 * cy0 - 3;     // first input row of the halo
  const int ix0 = 2 * cx0 - 3;

  const int cg = tid % kChanGroups;
  const int pg = tid / kChanGroups;

  int off[kPixPerThread];          // halo offset of each owned conv pixel
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    int p = pg + k * kPixGroups;
    p = p < kConvPix ? p : 0;      // the spare slot computes pixel 0, unused
    off[k] = (2 * (p / kCT) * kIT + 2 * (p % kCT)) * 3;
  }

  float acc[kPixPerThread][8];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;

  for (int kt = 0; kt < 3; ++kt) {
    const int tt = t + kt - 1;
    if (tt < 0 || tt >= frames) continue;  // zero temporal padding
    __syncthreads();               // the previous frame's reads are done
    const T* wk = w + kt * kWElems;
    for (int i = tid; i < kWElems; i += kThreads) w_s[i] = to_f32(wk[i]);
    const T* xf = x + static_cast<size_t>(bt + kt - 1) * H * W * 3;
    for (int i = tid; i < kInElems; i += kThreads) {
      const int r = i / (kIT * 3);
      const int rem = i - r * (kIT * 3);
      const int s = rem / 3;
      const int c = rem - s * 3;
      const int iy = iy0 + r;
      const int ix = ix0 + s;
      float v = 0.f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = to_f32(xf[(static_cast<size_t>(iy) * W + ix) * 3 + c]);
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
        for (int k = 0; k < kPixPerThread; ++k) {
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

  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = (j < 4 ? 0 : 32) + cg * 4 + (j & 3);
    sc[j] = scale[ch];
    bi[j] = bias[ch];
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
