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
// of each 128-lane vector empty; on Hopper a warp covers whole 64-byte pixel
// slices, so the layout needs no such trick.
//
// What bounds it: at the main path's shape, layer1 of CSN-152 at 256 px,
// (1,32,64,64,64) bf16, the conv reads 16.8 MB and writes 16.8 MB (10.0 us at
// 3.35 TB/s) for 0.45 GFLOP of float32 FMAs (6.8 us at the 67 TFLOP/s
// CUDA-core peak): bound by bytes, with the FMAs close behind, so the design
// keeps the issue slots for the FMAs.
//
// Design. A block owns a 16x16 output tile, a slice of 64 bytes of channels
// (32 bf16 or 16 float) and a run of 8 frames of one clip: at layer1 16 tiles
// x 2 slices x 4 runs = 128 blocks of 16 warps, one wave on 132 SMs. The 18x18
// input halo of a frame (1.27x the tile) lands in one slot of a ring of 5 in
// shared memory by 16-byte cp.async copies whose zero-fill form is the
// padding, in space and at the clip's first and last frames; a run reads
// 10 frames for 8 outputs (1.25x). Frame j + 3 is copied while output j is
// summed, two frames ahead of the frames it needs; an mbarrier per slot
// completes when every thread's copies into it have landed
// (cp.async.mbarrier.arrive), and a second one when every thread has read
// it for the last time, so a slot is refilled without a block-wide barrier
// and threads drift by up to one frame. Thread (pair, row, half) holds its
// channel pair's 27 taps in float32 registers and sums a strip of 8 outputs
// along W of one row: for each of the 9 (frame, kernel row) it reads the 10
// pixels under the strip once (4 bytes each in bf16) and applies them to
// 3 taps from registers. Shared-memory reads: 90 x 4 B per 8 outputs of 2
// channels, so 180 B per 16-byte output vector (a thread that read 27 halo
// vectors and 54 float4 of weights for each output would read 1296 B). The
// halo rows are 19 pixels apart, so the two rows a warp reads fall in
// opposite halves of the banks. Each output's 27 taps are summed in one
// fixed order (frame, row, column), so a repeat launch gives the same bits.

#include <atomic>
#include <cstdint>

#include "mma.cuh"
#include "vec.cuh"

namespace {

using tuber::Vec;

constexpr int kTile = 16;                   // output pixels per tile edge
constexpr int kHalo = kTile + 2;            // 18
constexpr int kLdPix = kHalo + 1;           // pixels per halo row in shared
constexpr int kPixBytes = 64;               // a pixel's channel slice
constexpr int kSlotBytes = kHalo * kLdPix * kPixBytes;   // 21888
constexpr int kSlots = 5;                   // the ring of input frames
constexpr int kRun = 8;                     // output frames per block
constexpr int kStrip = 8;                   // outputs along W per thread
constexpr int kTaps = 27;
constexpr int kThreads = 512;               // 16 warps
constexpr size_t kSmem =
    static_cast<size_t>(kSlots) * kSlotBytes + 2 * kSlots * sizeof(uint64_t);
static_assert(kSlotBytes % 16 == 0, "slots stay 16-byte aligned");
static_assert((kLdPix * kPixBytes / 4) % 32 == 16,
              "a warp's two rows fall in opposite halves of the banks");
static_assert(kThreads == 16 * kTile * (kTile / kStrip),
              "16 pairs x 16 rows x 2 strips");

// Two adjacent channels in 4 bytes (bf16) or 8 (float), to and from float.
template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using Raw = uint32_t;
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xFFFF0000u));
  }
  __device__ __forceinline__ static uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

template <>
struct Pair<float> {
  using Raw = float2;
  __device__ __forceinline__ static float2 unpack(float2 u) { return u; }
  __device__ __forceinline__ static float2 pack(float a, float b) {
    return make_float2(a, b);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int frames, int H, int W, int C, int tiles_x, int relu) {
  constexpr int kN = Vec<T>::kN;                 // channels of a 16 B copy
  constexpr int kSliceC = kPixBytes / sizeof(T);
  constexpr int kFull = kSliceC / kN;            // copies of a whole slice
  using P = Pair<T>;
  using Raw = typename P::Raw;
  constexpr int kRawPerPix = kPixBytes / sizeof(Raw);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSlots * kSlotBytes);
  uint64_t* empty = full + kSlots;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h0 = (blockIdx.x / tiles_x) * kTile;
  const int w0 = (blockIdx.x % tiles_x) * kTile;
  const int n_slices = (C + kSliceC - 1) / kSliceC;
  const int c0 = (blockIdx.y % n_slices) * kSliceC;
  const int t0 = (blockIdx.y / n_slices) * kRun;
  const int outs = min(kRun, frames - t0);      // output frames of the run
  const int b = blockIdx.z;
  const int cs = min(kSliceC, C - c0);
  const int chunks = cs / kN;                   // 16 B copies per pixel
  const int n_in = outs + 2;                    // input frames t0-1..t0+outs

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      tuber_mma::mbar_init(full + s, kThreads);
      tuber_mma::mbar_init(empty + s, kThreads);
    }
  }
  __syncthreads();

  // input frame j of the run (t0 - 1 + j) into slot j % kSlots
  auto issue = [&](int j) {
    const int f = t0 - 1 + j;
    const bool frame_in = f >= 0 && f < frames;
    unsigned char* slot = smem + (j % kSlots) * kSlotBytes;
    const T* xf = x + (static_cast<size_t>(b) * frames + (frame_in ? f : 0)) *
                          H * W * C + c0;
    for (int i = tid; i < kHalo * kHalo * chunks; i += kThreads) {
      // a constant divisor where the slice is whole (a division by a
      // variable costs the loop tens of instructions)
      const int p = chunks == kFull ? i / kFull : i / chunks;
      const int q = i - p * chunks;
      const int r = p / kHalo;
      const int col = p - r * kHalo;
      const int h = h0 - 1 + r;
      const int wc = w0 - 1 + col;
      const bool ok = frame_in && h >= 0 && h < H && wc >= 0 && wc < W;
      tuber_mma::cp_async16(
          slot + (r * kLdPix + col) * kPixBytes + q * 16,
          ok ? xf + (static_cast<size_t>(h) * W + wc) * C + q * kN : x, ok);
    }
    tuber_mma::cp_async_arrive(full + j % kSlots);
  };

  for (int j = 0; j < 3; ++j) issue(j);

  // this thread: channel pair cp of the slice, tile row `row`, columns
  // col0..col0+7
  const int cp = lane & 15;
  const int row = 2 * (warp & 7) + (lane >> 4);
  const int col0 = kStrip * (warp >> 3);
  const bool active = 2 * cp < cs;
  const int c = c0 + 2 * cp;
  float wr[kTaps][2];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    wr[k][0] = active ? tuber::to_f32(w[k * C + c]) : 0.f;
    wr[k][1] = active ? tuber::to_f32(w[k * C + c + 1]) : 0.f;
  }
  float sc[2] = {1.f, 1.f}, bi[2] = {0.f, 0.f};
  if (scale != nullptr && active) {
    sc[0] = scale[c];
    sc[1] = scale[c + 1];
    bi[0] = bias[c];
    bi[1] = bias[c + 1];
  }
  tuber_mma::mbar_wait(full + 0, 0);
  tuber_mma::mbar_wait(full + 1, 0);

  for (int s = 0; s < outs; ++s) {
    // frame s + 3 refills the slot that frame s - 2 left after output s - 2
    const int j = s + 3;
    if (j < n_in) {
      if (j >= kSlots)
        tuber_mma::mbar_wait(empty + j % kSlots, (j / kSlots - 1) & 1);
      issue(j);
    }
    tuber_mma::mbar_wait(full + (s + 2) % kSlots, ((s + 2) / kSlots) & 1);

    if (active) {
      float acc[kStrip][2];
#pragma unroll
      for (int k = 0; k < kStrip; ++k) acc[k][0] = acc[k][1] = 0.f;
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const unsigned char* fr = smem + ((s + dt) % kSlots) * kSlotBytes;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const Raw* src = reinterpret_cast<const Raw*>(
                               fr + ((row + dh) * kLdPix + col0) * kPixBytes) +
                           cp;
          float2 v[kStrip + 2];
#pragma unroll
          for (int k = 0; k < kStrip + 2; ++k)
            v[k] = P::unpack(src[k * kRawPerPix]);
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const int tap = (dt * 3 + dh) * 3 + dw;
#pragma unroll
            for (int k = 0; k < kStrip; ++k) {
              acc[k][0] = fmaf(v[k + dw].x, wr[tap][0], acc[k][0]);
              acc[k][1] = fmaf(v[k + dw].y, wr[tap][1], acc[k][1]);
            }
          }
        }
      }
      const int h = h0 + row;
      if (h < H) {
        T* dst = out + ((static_cast<size_t>(b) * frames + t0 + s) * H + h) *
                           W * C + c;
#pragma unroll
        for (int k = 0; k < kStrip; ++k) {
          const int wc = w0 + col0 + k;
          if (wc >= W) break;
          float y0 = acc[k][0], y1 = acc[k][1];
          if (scale != nullptr) {
            y0 = fmaf(y0, sc[0], bi[0]);
            y1 = fmaf(y1, sc[1], bi[1]);
          }
          if (relu) {
            y0 = tuber::relu(y0);
            y1 = tuber::relu(y1);
          }
          *reinterpret_cast<Raw*>(dst + static_cast<size_t>(wc) * C) =
              P::pack(y0, y1);
        }
      }
    }
    tuber_mma::mbar_arrive(empty + s % kSlots);   // frame s is read for good
  }
}

constexpr int kMaxDevices = 64;

// The kernel's shared-memory attribute, set once per device and type: the
// call costs more host time than the kernel takes at layer1.
template <typename T>
cudaError_t prepare() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(depthwise_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int batch, int frames, int H, int W, int C, int relu,
           void* stream) {
  constexpr int kSliceC = kPixBytes / sizeof(T);
  const cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_y = (H + kTile - 1) / kTile;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int n_slices = (C + kSliceC - 1) / kSliceC;
  const dim3 grid(tiles_y * tiles_x, ((frames + kRun - 1) / kRun) * n_slices,
                  batch);
  depthwise_kernel<T><<<grid, kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), frames, H, W, C, tiles_x, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. x, w and out have the element type in the
// name; scale and bias are float32 (C,) or both null; every pointer is device
// memory, x 16-byte aligned. C must be a multiple of 8 (bf16) or 4 (float32);
// ceil(T/8) * ceil(C/32) (bf16) or ceil(T/8) * ceil(C/16) (float32) and B at
// most 65535. The launch goes on `stream` and does not synchronise. Returns
// a cudaError_t.
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
