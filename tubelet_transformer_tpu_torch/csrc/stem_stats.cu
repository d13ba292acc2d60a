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
// adds the partials in a fixed order, in double. The statistics are
// therefore the same bits from run to run, with no atomics.
//
// What bounds it: the conv of the train shape (2,32,256,256,3) is 59 GFLOP
// against 25 MB of bf16 input, and the output is 512 bytes: bound by
// operations (60 us at the 989 TFLOP/s bf16 tensor-core peak). The conv
// output (134 MB in bf16, 268 MB in f32 at that shape) stays in registers.
//
// bf16 (stem_stats_tc_kernel, the train path): the pooled stem's implicit
// GEMM on the tensor cores (stem_tc.cuh), on 16x16 conv tiles that do not
// overlap (M = 256 = 16 row tiles, one conv row each; a 37x37 halo). A
// persistent block of 16 warps walks its tiles in a fixed order with the
// next (tile, frame) halo loaded while the current one multiplies, as the
// pooled kernel does; its epilogue stores nothing: each thread adds its
// float32 accumulators and their squares per channel over the tile's conv
// pixels that lie inside the image (the tiles' ragged edge past Hc / Wc is
// masked out, as the TPU kernel masks its ghost lanes), and carries the
// tile's sums in double across its tiles. At the end, warp shuffles add the
// eight pixel rows of a warp, shared memory the four warps of each channel
// group, and the block writes one partial: one per block, not per tile.
//
// float32 (stem_stats_partial_kernel, float32 models and tests): the direct
// conv of stem_conv.cuh on the CUDA cores, one 16x16 conv tile per block, a
// 37x37x3 halo, 8 conv pixels per thread, one partial per tile.
//
// Both kernels run on a row window (spatial parallelism, where each model
// peer holds a band of the clip's rows): x is a slab of the clip's global
// input rows [row0, row0 + rows) (tuber_stem::Slab), and the statistics are
// those of the global conv rows [out0, out0 + out_rows) alone, the peer's
// own, so that the peers' statistics average to the clip's; a conv row c
// reads input rows 2c - 3 .. 2c + 3, zero-padded at the clip's border only.
//
// The variance keeps the JAX formula, E[y^2] - E[y]^2 in float32, so that
// the port matches it; it cancels when |mean| >> std. The cross-block sums are
// taken in double before the division by n.

#include "stem_conv.cuh"
#include "stem_tc.cuh"

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
                          float* __restrict__ partial, int frames, Slab slab,
                          int W, int c_end, int Wc, int c0, int tiles_x) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int bt = blockIdx.y;       // b * frames + t
  const int t = bt % frames;
  const int cy0 = c0 + (blockIdx.x / tiles_x) * kCT;    // a global row
  const int cx0 = (blockIdx.x % tiles_x) * kCT;
  const int cg = tid % kChanGroups;
  const int pg = tid / kChanGroups;

  float acc[kPixPerThread][8];
  conv_tile<kCT>(x, w, smem, bt, t, frames, slab, W, cy0, cx0, acc);

  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = pg + k * kPixGroups;
    if (cy0 + p / kCT >= c_end || cx0 + p % kCT >= Wc) continue;
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

// bf16 on the tensor cores: the implicit GEMM (stem_tc.cuh) of 16x16 conv
// tiles, reduced instead of stored.
using bf16 = __nv_bfloat16;
namespace tc = tuber_stem_tc;
using HaloS = tc::Halo<kCT>;                    // 37 rows of 111, stride 112
constexpr int kMTilesS = kCT * kCT / 16;        // 16 row tiles: a conv row each
constexpr int kWarpTilesS = kMTilesS / 4;       // 4 a warp
constexpr size_t kRedBytes = 4 * 2 * kCout * sizeof(double);
constexpr size_t kSmemTc =
    tc::kWBytes + HaloS::kBytes + tc::kTabBytes + kRedBytes;
static_assert(tc::kTabBytes % 8 == 0, "the reduction stays 8-byte aligned");

// Persistent: block i takes tiles i, i + gridDim.x, ... of the B*T*tiles_hw
// (b, t, 16x16 conv) tiles. Warp w owns channels 16 (w % 4).. and conv rows
// 4 (w / 4).. of the tile; lane (g, t4) the columns g and g + 8 and the
// channels 2 t4, 2 t4 + 1 of each n8 half. Writes partial[block] =
// (sum[64], sum of squares[64]) over the conv rows [c0, c_end).
__global__ void __launch_bounds__(tc::kThreadsTc, 1)
stem_stats_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     float* __restrict__ partial, int frames, Slab slab,
                     int W, int c_end, int Wc, int c0, int tiles_x,
                     int tiles_hw, int tiles) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_tc);                   // [480][72]
  unsigned short* halo =
      reinterpret_cast<unsigned short*>(smem_tc + tc::kWBytes);    // [3][37][112]
  int* tab_off =
      reinterpret_cast<int*>(smem_tc + tc::kWBytes + HaloS::kBytes);   // [80]
  uint32_t* tab_mask = reinterpret_cast<uint32_t*>(tab_off + tc::kPairsF);
  double* red = reinterpret_cast<double*>(
      smem_tc + tc::kWBytes + HaloS::kBytes + tc::kTabBytes);      // [4][2][64]
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ng = (tid >> 5) & 3;
  const int mg = (tid >> 5) >> 2;

  tc::load_weights_and_tables(w_s, w, tab_off, tab_mask, HaloS::kLd);
  int poff[kWarpTilesS][2];         // halo offset of the columns g, g+8 owned
  tc::pixel_offsets<kCT>(poff, mg, g);
  double sum[2][2] = {}, sq[2][2] = {};   // [n8 half][channel of the pair]

  unsigned short pre[HaloS::kPerThread];
  tc::fetch_tile_halo<kCT>(pre, xs, blockIdx.x, 0, tiles_x, tiles_hw, frames,
                           slab, W, c0);
  tc::stash_halo<kCT>(pre, halo);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[kWarpTilesS][2][4];
#pragma unroll
    for (int i = 0; i < kWarpTilesS; ++i)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][ni][j] = 0.f;

    for (int kt = 0; kt < 3; ++kt) {
      // the next (tile, frame) goes into registers while this one multiplies
      const int nt = kt < 2 ? tile : tile + gridDim.x;
      const int nkt = kt < 2 ? kt + 1 : 0;
      if (nt < tiles)
        tc::fetch_tile_halo<kCT>(pre, xs, nt, nkt, tiles_x, tiles_hw, frames,
                                 slab, W, c0);
      tuber_mma::cp_async_wait<0>();
      __syncthreads();              // frame kt's halo (and the weights) are in
      tc::frame_products<kWarpTilesS, kMTilesS>(
          acc, halo + kt * HaloS::kFrameElems,
          w_s + kt * tc::kSlotsF * tc::kLdW, tab_off, tab_mask, poff, lane,
          mg, ng);
      // the buffer of frame nkt was last read two barriers ago
      if (nt < tiles)
        tc::stash_halo<kCT>(pre, halo + nkt * HaloS::kFrameElems);
    }

    // this tile's sums over its conv pixels inside the image, in float32,
    // then into the block's running sums in double
    const int rem = tile % tiles_hw;
    const int cy0 = c0 + (rem / tiles_x) * kCT;         // a global row
    const int cx0 = (rem % tiles_x) * kCT;
    float s[2][2] = {}, q[2][2] = {};
#pragma unroll
    for (int i = 0; i < kWarpTilesS; ++i) {
      if (cy0 + mg * kWarpTilesS + i >= c_end) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cx0 + g + 8 * h >= Wc) continue;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float y = acc[i][ni][2 * h + j];
            s[ni][j] += y;
            q[ni][j] = fmaf(y, y, q[ni][j]);
          }
      }
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sum[ni][j] += s[ni][j];
        sq[ni][j] += q[ni][j];
      }
  }

  // lanes t4, t4 + 4, ..., t4 + 28 of a warp hold the same channels
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        sum[ni][j] += __shfl_xor_sync(0xffffffffu, sum[ni][j], m);
        sq[ni][j] += __shfl_xor_sync(0xffffffffu, sq[ni][j], m);
      }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ng * 16 + ni * 8 + 2 * t4 + j;
        red[(mg * 2 + 0) * kCout + c] = sum[ni][j];
        red[(mg * 2 + 1) * kCout + c] = sq[ni][j];
      }
  }
  __syncthreads();
  if (tid < 2 * kCout) {            // tid = stat * 64 + channel
    double v = 0.0;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      v += red[(m * 2 + tid / kCout) * kCout + tid % kCout];
    partial[static_cast<size_t>(blockIdx.x) * 2 * kCout + tid] =
        static_cast<float>(v);
  }
}

struct Geometry {
  int Wc, tiles_x, tiles_hw;
  long long tiles;                  // of every frame: B * T * tiles_hw
};

// The tiles of `out_rows` conv rows of every frame.
Geometry geometry(int batch, int frames, int out_rows, int W) {
  Geometry g;
  g.Wc = (W - 1) / 2 + 1;           // conv 7 / stride 2 / pad 3
  g.tiles_x = (g.Wc + kCT - 1) / kCT;
  g.tiles_hw = ((out_rows + kCT - 1) / kCT) * g.tiles_x;
  g.tiles = static_cast<long long>(batch) * frames * g.tiles_hw;
  return g;
}

// The blocks that write a partial: float32, one per tile; bf16, the
// persistent grid of the tensor-core kernel, min(tiles, resident blocks),
// the resident blocks queried once per device.
cudaError_t partial_blocks(bool f32, const Geometry& g, int* blocks) {
  *blocks = 0;
  if (g.tiles > 0x7fffffff) return cudaErrorInvalidValue;
  if (f32) {
    *blocks = static_cast<int>(g.tiles);
    return cudaSuccess;
  }
  static std::atomic<int> cache[tc::kMaxDevices];
  int resident = 0;
  const cudaError_t err =
      tc::resident_blocks(stem_stats_tc_kernel, kSmemTc, cache, &resident);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<int>(g.tiles < resident ? g.tiles : resident);
  return cudaSuccess;
}

int launch(bool f32, const void* x, const void* w, void* partial,
           void* stats, int batch, int frames, int H, int W, int row0,
           int rows, int out0, int out_rows, void* stream) {
  const Geometry g = geometry(batch, frames, out_rows, W);
  const Slab slab = make_slab(row0, rows, H);
  int blocks = 0;
  cudaError_t err = partial_blocks(f32, g, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    const size_t smem = kSmemFloats * sizeof(float);
    err = cudaFuncSetAttribute(stem_stats_partial_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(g.tiles_hw, batch * frames);
    stem_stats_partial_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(partial), frames, slab, W, out0 + out_rows, g.Wc,
        out0, g.tiles_x);
  } else {
    stem_stats_tc_kernel<<<blocks, tc::kThreadsTc, kSmemTc, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<float*>(partial), frames, slab, W, out0 + out_rows, g.Wc,
        out0, g.tiles_x, g.tiles_hw, static_cast<int>(g.tiles));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const double count = static_cast<double>(batch) * frames * out_rows * g.Wc;
  stem_stats_finalize_kernel<<<1, kFinalSlices * 2 * kCout, 0, s>>>(
      static_cast<const float*>(partial), blocks, count,
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Every pointer is device memory; the
// launches go on `stream` and do not synchronise. `partial` is float32 scratch
// of tuber_stem_stats_partials(...) elements, `stats` float32 (2, 64).
// Returns a cudaError_t. The statistics are those of a row window: x
// (B,T,rows,W,3) holds the global input rows [row0, row0 + rows) of a clip
// of height H, and the conv rows reduced are [out0, out0 + out_rows); the
// whole clip is row0 0, rows H, out0 0, out_rows Hc.

// Elements of the partial scratch for `out_rows` conv rows of x's frames
// of width W and this type (is_f32: x is float32, else bf16) on the
// current device, or -cudaError_t.
extern "C" int tuber_stem_stats_partials(int batch, int frames, int out_rows,
                                         int W, int is_f32) {
  int blocks = 0;
  const cudaError_t err = partial_blocks(
      is_f32 != 0, geometry(batch, frames, out_rows, W), &blocks);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (blocks > 0x7fffffff / (2 * kCout))
    return -static_cast<int>(cudaErrorInvalidValue);
  return blocks * 2 * kCout;
}

extern "C" int tuber_stem_stats_bf16(const void* x, const void* w,
                                     void* partial, void* stats, int batch,
                                     int frames, int H, int W, int row0,
                                     int rows, int out0, int out_rows,
                                     void* stream) {
  return launch(false, x, w, partial, stats, batch, frames, H, W, row0, rows,
                out0, out_rows, stream);
}

extern "C" int tuber_stem_stats_f32(const void* x, const void* w,
                                    void* partial, void* stats, int batch,
                                    int frames, int H, int W, int row0,
                                    int rows, int out0, int out_rows,
                                    void* stream) {
  return launch(true, x, w, partial, stats, batch, frames, H, W, row0, rows,
                out0, out_rows, stream);
}
