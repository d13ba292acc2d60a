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
// is one cooperative kernel: every block is resident (the grid is what the
// occupancy calculator allows on all SMs), and for each k the blocks run
// three phases over the whole clip, separated by grid barriers:
//   A: conv1, a GEMM (pixels x Ci) @ (Ci x Cm) in 64x64 tiles -> mid;
//   B: the depthwise over mid, one (b, t, 8x8 pixels, 64 channels) item at
//      a time, with the halo of frames t-1..t+1 -> mdw;
//   C: conv4, a GEMM (pixels x Cm) @ (Cm x Ci) in 64x128 tiles, with the
//      residual, in place on out.
// Phase C reads each residual element in the thread that then overwrites
// it, and nothing else of out, so block k's output replaces block k-1's: the
// chain needs one out, one mid and one mdw buffer whatever K is, and at the
// flagship's batch of 1 the largest (layer2: 16.8 MB out + 2 x 4.2 MB) stays
// in the 50 MB L2 from block to block.
//
// What bounds it: the function must read x and the stacked weights and
// write out; its products are 2 x pixels x K x (2 Ci Cm + 27 Cm) operations.
// At the flagship's layer3 tail (1,8,16,16,1024), Cm 256, K 35: 76 GFLOP,
// 77 us at the 989 TFLOP/s bf16 peak, against 46 MB (14 us at 3.35 TB/s):
// bound by operations, on the tensor cores. What the design does about it:
// - every phase has work for the whole card at the flagship's three tails
//   (conv1 128-512 tiles, depthwise 128-512 items, conv4 256-1024 tiles);
// - both GEMM operands reach the tensor cores from shared memory: a ring of
//   three k-stages of 64, filled by cp.async.cg two stages ahead of use,
//   read by ldmatrix into mma.sync.m16n8k16 (bf16 in, float32 sums); no
//   operand is loaded from device memory inside the product loop. Each
//   thread's copy addresses are set once per tile and advance by a stage;
//   the tile's affine columns, and the depthwise item's taps and affine,
//   arrive by the same async copies;
// - activations are read through L2 only (cp.async.cg, ld.global.cg): the
//   launch reads what other blocks wrote before a grid barrier, and L1 is
//   not coherent across SMs. No async-proxy copy (TMA) or wgmma is used, so
//   no proxy fence is needed.
// What still holds it back (tools/kernel_probe.py): at layers 3-4 a phase
// has at most one tile or item per block, so a block-k costs one tile's
// latency per phase plus three grid barriers; inside a GEMM tile each warp's
// 32x16 or 32x32 piece reads its fragments by ldmatrix for every four or
// eight mma, so shared-memory traffic and the per-stage barrier, not the
// tensor cores, set the pace. wgmma on 64-row warpgroup tiles (B read by the
// tensor cores from shared memory once per warpgroup) is the next step.
// A float32 x (tests only) reaches phase A's shared stages through
// registers, converted to bf16 on the way; the residual stays in x's type.
// Every tile and item is computed by one block in a fixed order whatever
// the grid: a repeat launch, and K launches of one block each with bf16
// between them, give the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstddef>

#include "mma.cuh"
#include "vec.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using tuber::Vec;
using namespace tuber_mma;

constexpr int kThreads = 256;       // 8 warps: 2 (tile rows) x 4 (columns)
constexpr int kBM = 64;             // GEMM tile: pixel rows
constexpr int kBN1 = 64;            // conv1 tile: C_mid columns
constexpr int kBN4 = 128;           // conv4 tile: C_in columns
constexpr int kBK = 64;             // k of one pipeline stage
constexpr int kStages = 3;          // stages of the cp.async ring
constexpr int kLdA = kBK + 8;       // bf16 row stride of an A stage
constexpr int kSlice = 64;          // depthwise: channels of an item
constexpr int kTile = 8;            // depthwise: 8x8 pixels of an item
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kTaps = 27;
constexpr int kVecs = kSlice / 8;   // 16-byte vectors of a pixel's slice

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}
// bf16 row stride of a B stage, float row stride of the epilogue tile: the
// padding keeps ldmatrix's eight row addresses on distinct banks
__host__ __device__ constexpr int ld_b(int bn) { return bn + 8; }
__host__ __device__ constexpr int ld_c(int bn) { return bn + 4; }
__host__ __device__ constexpr size_t stage_bytes(int bn) {
  return (static_cast<size_t>(kBM) * kLdA + static_cast<size_t>(kBK) * ld_b(bn))
         * sizeof(bf16);
}
// the ring (later the float32 epilogue tile), then the affine's columns
constexpr size_t gemm_smem(int bn) {
  return cmax(kStages * stage_bytes(bn),
              static_cast<size_t>(kBM) * ld_c(bn) * sizeof(float)) +
         2 * bn * sizeof(float);
}
constexpr size_t kHaloBytes = 3 * kHaloPix * kSlice * sizeof(bf16);
constexpr size_t kTapBytes = kTaps * kSlice * sizeof(bf16);
constexpr size_t kDwSmem = kHaloBytes + kTapBytes + 2 * kSlice * sizeof(float);
constexpr size_t kSmem = cmax(cmax(gemm_smem(kBN1), gemm_smem(kBN4)), kDwSmem);
static_assert(stage_bytes(kBN1) % 128 == 0 && stage_bytes(kBN4) % 128 == 0 &&
                  kHaloBytes % 16 == 0 && kTapBytes % 16 == 0,
              "shared stages stay 128-byte aligned");

// Eight channels at src into shared dst as bf16: an async copy for bf16, a
// load through L2 and a conversion for float32; zeros where !valid.
__device__ __forceinline__ void load_a8(bf16* dst, const bf16* src,
                                        bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void load_a8(bf16* dst, const float* src,
                                        bool valid) {
  uint4 v = tuber::zero_vec();
  if (valid) {
    float f[8];
    Vec<float>::unpack(__ldcg(reinterpret_cast<const uint4*>(src)), f);
    Vec<float>::unpack(__ldcg(reinterpret_cast<const uint4*>(src + 4)), f + 4);
    v = Vec<bf16>::pack(f);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// Eight channels at p as float, through L2; eight floats stored in T.
__device__ __forceinline__ void load8_f32(const bf16* p, float* f) {
  Vec<bf16>::unpack(__ldcg(reinterpret_cast<const uint4*>(p)), f);
}
__device__ __forceinline__ void load8_f32(const float* p, float* f) {
  Vec<float>::unpack(__ldcg(reinterpret_cast<const uint4*>(p)), f);
  Vec<float>::unpack(__ldcg(reinterpret_cast<const uint4*>(p + 4)), f + 4);
}
__device__ __forceinline__ void store8(bf16* p, const float* f) {
  tuber::store_vec(p, Vec<bf16>::pack(f));
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  tuber::store_vec(p, Vec<float>::pack(f));
  tuber::store_vec(p + 4, Vec<float>::pack(f + 4));
}

// Rows row0..row0+63 of a (M rows of K, in TA) times columns n0..n0+BN-1 of
// b (K x N bf16, row-major), times scale plus bias (indexed by the column of
// b), into the float32 tile [kBM][ld_c(BN)] at the start of smem. Warp w
// owns rows 32 (w / 4).. and columns BN/4 (w % 4)..; K is a multiple of kBK.
template <int BN, typename TA>
__device__ __forceinline__ void gemm_tile(
    const TA* a, long long M, int K, const bf16* __restrict__ b, int N,
    long long row0, int n0, const float* __restrict__ scale,
    const float* __restrict__ bias, unsigned char* smem) {
  constexpr int kNI = BN / 32;      // n8 tiles of a warp
  constexpr int kWN = BN / 4;       // columns of a warp
  constexpr int kLdB = ld_b(BN);
  constexpr int kPerA = kBM * kBK / 8 / kThreads;   // 16-byte copies a thread
  constexpr int kPerB = kBK * BN / 8 / kThreads;    // makes of each stage
  static_assert(kPerA * kThreads * 8 == kBM * kBK &&
                    kPerB * kThreads * 8 == kBK * BN,
                "every thread copies the same number of chunks");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 2;
  const int wn = (tid >> 5) & 3;

  // A thread copies the same (row, 16-byte chunk) places of every stage:
  // its sources advance by kBK along k from one stage to the next.
  const TA* a_src[kPerA];
  int a_dst[kPerA];
  bool a_ok[kPerA];
#pragma unroll
  for (int j = 0; j < kPerA; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / (kBK / 8);
    const int c = i % (kBK / 8);
    const long long row = row0 + r;
    a_ok[j] = row < M;
    a_src[j] = a + (a_ok[j] ? row : 0) * K + c * 8;
    a_dst[j] = r * kLdA + c * 8;
  }
  const bf16* b_src[kPerB];
  int b_dst[kPerB];
#pragma unroll
  for (int j = 0; j < kPerB; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / (BN / 8);
    const int c = i % (BN / 8);
    b_src[j] = b + static_cast<size_t>(r) * N + n0 + c * 8;
    b_dst[j] = kBM * kLdA + r * kLdB + c * 8;
  }
  const size_t b_step = static_cast<size_t>(kBK) * N;
  // ldmatrix row addresses of this lane in a stage (bf16 elements)
  const int a_frag = (wm * 32 + (lane & 15)) * kLdA + (lane >> 4) * 8;
  const int b_frag = kBM * kLdA +
                     (((lane >> 3) & 1) * 8 + (lane & 7)) * kLdB + wn * kWN +
                     (lane >> 4) * 8;

  __syncthreads();                  // the previous user of smem is done
  // the tile's scale and bias columns arrive with the first stage
  float* aff = reinterpret_cast<float*>(
      smem + cmax(kStages * stage_bytes(BN),
                  static_cast<size_t>(kBM) * ld_c(BN) * sizeof(float)));
  if (tid < BN / 2)
    cp_async16(aff + tid * 4,
               (tid < BN / 4 ? scale + tid * 4 : bias + (tid - BN / 4) * 4) +
                   n0,
               true);
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * stage_bytes(BN));
  };
  auto load = [&](int s) {          // the next stage in k order, into slot s
    bf16* st = stage(s);
#pragma unroll
    for (int j = 0; j < kPerA; ++j) {
      load_a8(st + a_dst[j], a_src[j], a_ok[j]);
      a_src[j] += kBK;
    }
#pragma unroll
    for (int j = 0; j < kPerB; ++j) {
      cp_async16(st + b_dst[j], b_src[j], true);
      b_src[j] += b_step;
    }
  };

  float acc[2][kNI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int steps = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int ks = 0; ks < steps; ++ks) {
    cp_async_wait<kStages - 2>();   // stage ks has landed (this thread's)
    __syncthreads();                // ... every thread's; stage ks-1 is free
    if (ks + kStages - 1 < steps) load((ks + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* st = stage(ks % kStages);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], st + a_frag + mi * 16 * kLdA + kk);
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, st + b_frag + kk * kLdB + nj * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free: the tile reuses it

  float* c_s = reinterpret_cast<float*>(smem);
  const int g = lane >> 2;
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni) {
    const int col = wn * kWN + ni * 8 + 2 * (lane & 3);
    const float sc[2] = {aff[col], aff[col + 1]};
    const float bi[2] = {aff[BN + col], aff[BN + col + 1]};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = wm * 32 + mi * 16 + g;
      *reinterpret_cast<float2*>(c_s + row * ld_c(BN) + col) =
          make_float2(fmaf(acc[mi][ni][0], sc[0], bi[0]),
                      fmaf(acc[mi][ni][1], sc[1], bi[1]));
      *reinterpret_cast<float2*>(c_s + (row + 8) * ld_c(BN) + col) =
          make_float2(fmaf(acc[mi][ni][2], sc[0], bi[0]),
                      fmaf(acc[mi][ni][3], sc[1], bi[1]));
    }
  }
  __syncthreads();
}

// Eight floats of row r, columns 8v.. of the epilogue tile.
template <int BN>
__device__ __forceinline__ void tile8(const unsigned char* smem, int r, int v,
                                      float* f) {
  const float* p = reinterpret_cast<const float*>(smem) + r * ld_c(BN) + v * 8;
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

// Phase A: mid rows row0.., columns n0..n0+63 = relu(src @ w1 * a1 + b1).
template <typename T>
__device__ __forceinline__ void conv1_tile(
    const T* src, const bf16* __restrict__ w1, const float* __restrict__ a1,
    const float* __restrict__ b1, bf16* mid, long long M, int Ci, int Cm,
    long long row0, int n0, unsigned char* smem) {
  gemm_tile<kBN1>(src, M, Ci, w1, Cm, row0, n0, a1, b1, smem);
  for (int i = threadIdx.x; i < kBM * kBN1 / 8; i += kThreads) {
    const int r = i / (kBN1 / 8);
    const int v = i % (kBN1 / 8);
    const long long row = row0 + r;
    if (row >= M) continue;
    float f[8];
    tile8<kBN1>(smem, r, v, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = tuber::relu(f[j]);
    store8(mid + row * Cm + n0 + v * 8, f);
  }
}

// Phase B: one (b, t, 8x8 pixels at h0, w0, channels c0..c0+63) item of
// mdw = relu(depthwise(mid) * a3 + b3), zero padding outside the clip. The
// mid halo, the item's taps and its affine slices arrive by one group of
// async copies.
__device__ __forceinline__ void dw_item(
    const bf16* mid, const bf16* __restrict__ wd, const float* __restrict__ a3,
    const float* __restrict__ b3, bf16* mdw, int b, int t, int h0, int w0,
    int c0, int frames, int H, int W, int Cm, unsigned char* smem) {
  constexpr int kHaloChunks = 3 * kHaloPix * kVecs;
  constexpr int kUnits = kTile * kTile * kVecs / kThreads;   // per thread
  static_assert(kTaps * kVecs + 2 * kSlice / 4 <= kThreads,
                "one copy a thread brings the taps and the affine");
  bf16* halo = reinterpret_cast<bf16*>(smem);                  // [300][64]
  bf16* w_s = reinterpret_cast<bf16*>(smem + kHaloBytes);      // [27][64]
  float* aff = reinterpret_cast<float*>(smem + kHaloBytes + kTapBytes);
  const int tid = threadIdx.x;
  const size_t frame0 = static_cast<size_t>(b) * frames;

  __syncthreads();                  // the previous user of smem is done
#pragma unroll
  for (int j = 0; j < (kHaloChunks + kThreads - 1) / kThreads; ++j) {
    const int i = tid + j * kThreads;
    if (i >= kHaloChunks) break;
    const int fp = i / kVecs;       // frame * 100 + halo pixel
    const int v = i - fp * kVecs;
    const int f = t - 1 + fp / kHaloPix;
    const int p = fp % kHaloPix;
    const int h = h0 - 1 + p / kHalo;
    const int w = w0 - 1 + p % kHalo;
    const bool ok = f >= 0 && f < frames && h >= 0 && h < H && w >= 0 && w < W;
    const bf16* src =
        ok ? mid + (((frame0 + f) * H + h) * static_cast<size_t>(W) + w) * Cm +
                 c0 + v * 8
           : mid;
    cp_async16(halo + i * 8, src, ok);
  }
  if (tid < kTaps * kVecs) {
    cp_async16(w_s + tid * 8, wd + (tid / kVecs) * Cm + c0 + (tid % kVecs) * 8,
               true);
  } else if (tid < kTaps * kVecs + 2 * kSlice / 4) {
    const int j = tid - kTaps * kVecs;            // a3 then b3, 4 floats each
    cp_async16(aff + j * 4,
               (j < kSlice / 4 ? a3 + j * 4 : b3 + (j - kSlice / 4) * 4) + c0,
               true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const uint4* hv = reinterpret_cast<const uint4*>(halo);
  const uint4* wv = reinterpret_cast<const uint4*>(w_s);
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int i = tid + u * kThreads;
    const int p = i / kVecs;
    const int v = i - p * kVecs;
    const int py = p / kTile;
    const int px = p % kTile;
    const int h = h0 + py;
    const int w = w0 + px;
    if (h >= H || w >= W) continue;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          float m[8], wt[8];
          Vec<bf16>::unpack(
              hv[(dt * kHaloPix + (py + dh) * kHalo + px + dw) * kVecs + v], m);
          Vec<bf16>::unpack(wv[((dt * 3 + dh) * 3 + dw) * kVecs + v], wt);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(m[j], wt[j], acc[j]);
        }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j] = tuber::relu(fmaf(acc[j], aff[v * 8 + j], aff[kSlice + v * 8 + j]));
    store8(mdw + (((frame0 + t) * H + h) * static_cast<size_t>(W) + w) * Cm +
               c0 + v * 8,
           acc);
  }
}

// Phase C: out rows row0.., columns n0..n0+127 = relu(mdw @ w4 * a4 + b4 +
// res), rounded to bf16 first with `round_out`. res and out may be the same
// buffer: each element of res is read by the thread that then writes it.
template <typename T>
__device__ __forceinline__ void conv4_tile(
    const T* res, const bf16* mdw, const bf16* __restrict__ w4,
    const float* __restrict__ a4, const float* __restrict__ b4, T* out,
    long long M, int Ci, int Cm, long long row0, int n0, bool round_out,
    unsigned char* smem) {
  gemm_tile<kBN4>(mdw, M, Cm, w4, Ci, row0, n0, a4, b4, smem);
  for (int i = threadIdx.x; i < kBM * kBN4 / 8; i += kThreads) {
    const int r = i / (kBN4 / 8);
    const int v = i % (kBN4 / 8);
    const long long row = row0 + r;
    if (row >= M) continue;
    const size_t at = static_cast<size_t>(row) * Ci + n0 + v * 8;
    float f[8], xr[8];
    tile8<kBN4>(smem, r, v, f);
    load8_f32(res + at, xr);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      f[j] = tuber::relu(f[j] + xr[j]);
      if (round_out) f[j] = __bfloat162float(__float2bfloat16(f[j]));
    }
    store8(out + at, f);
  }
}

struct Work {
  int tiles_a, items_b, tiles_c, tiles_x, tiles_hw, slices;
};

Work work(int batch, int frames, int H, int W, int Ci, int Cm) {
  Work g;
  const long long M = static_cast<long long>(batch) * frames * H * W;
  const int row_tiles = static_cast<int>((M + kBM - 1) / kBM);
  g.tiles_a = row_tiles * (Cm / kBN1);
  g.tiles_c = row_tiles * (Ci / kBN4);
  g.tiles_x = (W + kTile - 1) / kTile;
  g.tiles_hw = ((H + kTile - 1) / kTile) * g.tiles_x;
  g.slices = Cm / kSlice;
  g.items_b = g.tiles_hw * frames * batch * g.slices;
  return g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
chain_kernel(const T* x, const bf16* __restrict__ w1,
             const bf16* __restrict__ wd, const bf16* __restrict__ w4,
             const float* __restrict__ a1, const float* __restrict__ b1,
             const float* __restrict__ a3, const float* __restrict__ b3,
             const float* __restrict__ a4, const float* __restrict__ b4,
             bf16* mid, bf16* mdw, T* out, int batch, int frames, int H,
             int W, int Ci, int Cm, int K, Work g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const long long M = static_cast<long long>(batch) * frames * H * W;
  const int n1 = Cm / kBN1;
  const int n4 = Ci / kBN4;

  for (int k = 0; k < K; ++k) {
    const T* src = k == 0 ? x : out;
    const size_t wk = static_cast<size_t>(k) * Ci * Cm;
    for (int i = blockIdx.x; i < g.tiles_a; i += gridDim.x)
      conv1_tile(src, w1 + wk, a1 + k * Cm, b1 + k * Cm, mid, M, Ci, Cm,
                 static_cast<long long>(i / n1) * kBM, (i % n1) * kBN1, smem);
    grid.sync();                    // mid is whole
    for (int i = blockIdx.x; i < g.items_b; i += gridDim.x) {
      const int rest = i / g.slices;
      const int tile = rest % g.tiles_hw;
      const int bt = rest / g.tiles_hw;
      dw_item(mid, wd + static_cast<size_t>(k) * kTaps * Cm, a3 + k * Cm,
              b3 + k * Cm, mdw, bt / frames, bt % frames,
              (tile / g.tiles_x) * kTile, (tile % g.tiles_x) * kTile,
              (i % g.slices) * kSlice, frames, H, W, Cm, smem);
    }
    grid.sync();                    // mdw is whole; mid is free
    for (int i = blockIdx.x; i < g.tiles_c; i += gridDim.x)
      conv4_tile(src, mdw, w4 + wk, a4 + k * Ci, b4 + k * Ci, out, M, Ci, Cm,
                 static_cast<long long>(i / n4) * kBM, (i % n4) * kBN4,
                 k + 1 < K, smem);
    if (k + 1 < K) grid.sync();     // y_{k+1} is whole; mdw is free
  }
}

// Blocks of the cooperative grid: every SM's share of resident blocks. 0
// with an error where the device cannot launch it.
template <typename T>
cudaError_t grid_blocks(int* blocks) {
  *blocks = 0;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chain_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_kernel<T>, kThreads, kSmem);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int launch(const void* x, const void* w1, const void* wd, const void* w4,
           const void* a1, const void* b1, const void* a3, const void* b3,
           const void* a4, const void* b4, void* mid, void* mdw, void* out,
           int batch, int frames, int H, int W, int Ci, int Cm, int K,
           void* stream) {
  Work g = work(batch, frames, H, W, Ci, Cm);
  int blocks = 0;
  cudaError_t err = grid_blocks<T>(&blocks);
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
  bf16* mdwp = static_cast<bf16*>(mdw);
  T* outp = static_cast<T*>(out);
  void* args[] = {&xp,  &w1p,  &wdp,  &w4p,  &a1p,   &b1p,    &a3p,
                  &b3p, &a4p,  &b4p,  &midp, &mdwp,  &outp,   &batch,
                  &frames, &H, &W,    &Ci,   &Cm,    &K,      &g};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(chain_kernel<T>), dim3(blocks),
      dim3(kThreads), args, kSmem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. x and out have the element type in the
// name; the stacked w1, wd, w4, and mid and mdw (two (B,T,H,W,Cm) bf16
// scratch buffers) are bf16, the stacked affines float32; every pointer is
// device memory, 16-byte aligned. Cm must be a multiple of 64 and Ci of 128.
// The launch goes on `stream` and does not synchronise. Returns a
// cudaError_t.
extern "C" int tuber_chain_bf16(
    const void* x, const void* w1, const void* wd, const void* w4,
    const void* a1, const void* b1, const void* a3, const void* b3,
    const void* a4, const void* b4, void* mid, void* mdw, void* out,
    int batch, int frames, int H, int W, int Ci, int Cm, int K,
    void* stream) {
  return launch<bf16>(x, w1, wd, w4, a1, b1, a3, b3, a4, b4, mid, mdw, out,
                      batch, frames, H, W, Ci, Cm, K, stream);
}

extern "C" int tuber_chain_f32(
    const void* x, const void* w1, const void* wd, const void* w4,
    const void* a1, const void* b1, const void* a3, const void* b3,
    const void* a4, const void* b4, void* mid, void* mdw, void* out,
    int batch, int frames, int H, int W, int Ci, int Cm, int K,
    void* stream) {
  return launch<float>(x, w1, wd, w4, a1, b1, a3, b3, a4, b4, mid, mdw, out,
                       batch, frames, H, W, Ci, Cm, K, stream);
}

// The blocks of the cooperative grid that tuber_chain_* launches on the
// current device (is_f32: x is float32), whatever the shape, or
// -cudaError_t.
extern "C" int tuber_chain_blocks(int is_f32) {
  int blocks = 0;
  const cudaError_t err =
      is_f32 ? grid_blocks<float>(&blocks) : grid_blocks<bf16>(&blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
