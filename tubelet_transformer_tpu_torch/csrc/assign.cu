// Optimal assignment of the DETR set matcher on Hopper: for each of N
// problems, cost (Q, M) float32 and valid (M) targets, the assignment of
// least total cost between the Q queries and the valid targets, as scipy's
// linear_sum_assignment gives it on the valid columns: every query gets a
// target when there are at least Q valid targets, every valid target a query
// otherwise.
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// on-device solver, `_solve_rect` and `solve_assignment` of
// tubelet_transformer_tpu/ops/matcher.py (shortest augmenting paths with
// potentials in lax.fori_loop and lax.while_loop, vmapped over the batch),
// which keeps the train step's costs on the device. Two things differ from
// it. JAX solves the Q x M problem with the invalid columns at PAD_COST and
// float32 potentials, which beside 1e6 can round away the optimum; here each
// problem solves its valid submatrix alone, with float64 potentials, and
// transposes itself when it has fewer valid columns than rows. Non-finite
// costs become +-PAD_COST (NaN: +PAD_COST), as the matcher's host solve did,
// so a diverged step still gets a valid assignment.
//
// What bounds it: not bytes (the costs are a few KB) nor operations, but the
// chain of dependent passes: row i runs Dijkstra passes until it reaches a
// free column, each pass a block-wide argmin. So the design keeps a pass
// short: one block per problem, one thread per column (the columns of the
// solved problem, at most 1024); a thread keeps its column's potential v,
// its slack minv and its used flag in registers; the argmin is a warp
// shuffle, then one __syncthreads and a shuffle over the warps' results,
// ties to the lowest column. Row potentials u, the column owners p and the
// back pointers live in shared memory. The arithmetic is that of
// ops/cuda/assign.py:assign_reference, operation for operation in float64
// and without products, so nothing contracts into an FMA and the kernel and
// its plain version agree bit for bit, on ties too.
//
// Bounds by construction: in row i's Dijkstra every pass marks one more
// column used and the search stops at a free column; with C + 1 columns
// (column 0 the virtual start) it ends within C + 1 passes. The augmenting
// walk visits each used column once, so it also ends within C + 1 steps.
// Both loops are written with that bound.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 1024;      // one thread per column
constexpr double kPadCost = 1.0e6;  // ops/matcher.py PAD_COST

__device__ __forceinline__ double sanitize(float x) {
  if (isnan(x)) return kPadCost;
  if (isinf(x)) return x > 0.0f ? kPadCost : -kPadCost;
  return static_cast<double>(x);
}

// (val, idx) := the least pair over the warp, ties to the lower index; every
// lane ends with it.
__device__ __forceinline__ void warp_argmin(double& val, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const double v = __shfl_xor_sync(0xffffffffu, val, off);
    const int i = __shfl_xor_sync(0xffffffffu, idx, off);
    if (v < val || (v == val && i < idx)) {
      val = v;
      idx = i;
    }
  }
}

__global__ void __launch_bounds__(kMaxCols)
    assign_kernel(const float* __restrict__ cost,
                  const uint8_t* __restrict__ valid,
                  int64_t* __restrict__ tgt_for_query,
                  int64_t* __restrict__ query_for_tgt, int Q, int M) {
  __shared__ double s_u[kMaxCols + 1];  // row potentials, rows 1-indexed
  __shared__ int s_p[kMaxCols + 1];     // the row on column j, 0: free
  __shared__ int s_way[kMaxCols + 1];   // the column before j on its path
  __shared__ int s_col[kMaxCols];       // the valid targets, in order
  __shared__ int s_count[32];           // valid targets of each warp
  __shared__ double s_val[2][32];       // each warp's argmin, two buffers
  __shared__ int s_idx[2][32];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int warps = blockDim.x >> 5;
  const size_t n = blockIdx.x;
  const float* c = cost + n * Q * M;
  const uint8_t* ok = valid + n * M;
  int64_t* tfq = tgt_for_query + n * Q;
  int64_t* qft = query_for_tgt + n * M;

  // the valid targets, compacted in order
  const bool mine = t < M && ok[t] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, mine);
  if (lane == 0) s_count[warp] = __popc(ballot);
  if (t < Q) tfq[t] = -1;
  if (t < M) qft[t] = -1;
  __syncthreads();
  int before = 0, nv = 0;
  for (int w = 0; w < warps; ++w) {
    before += w < warp ? s_count[w] : 0;
    nv += s_count[w];
  }
  if (mine) s_col[before + __popc(ballot & ((1u << lane) - 1u))] = t;

  // R rows each get one of C >= R columns: the queries and the valid
  // targets, or (fewer valid targets than queries) the transpose
  const bool flip = nv < Q;
  const int R = flip ? nv : Q;
  const int C = flip ? Q : nv;
  const int j = t + 1;  // this thread's column, 1-indexed
  const bool column = j <= C;
  for (int k = t; k <= R; k += blockDim.x) s_u[k] = 0.0;
  for (int k = t; k <= C; k += blockDim.x) s_p[k] = 0;
  double v = 0.0;
  __syncthreads();

  int buf = 0;
  for (int i = 1; i <= R; ++i) {
    if (t == 0) s_p[0] = i;
    double minv = INFINITY;
    bool used = false;
    int j0 = 0;
    __syncthreads();
    // Dijkstra from row i: at most C + 1 passes (see the top)
    for (int pass = 0; pass <= C; ++pass) {
      if (j == j0) used = true;
      const int i0 = s_p[j0];
      const double ui0 = s_u[i0];
      double val = INFINITY;
      if (column && !used) {
        const double a = sanitize(
            flip ? c[static_cast<size_t>(j - 1) * M + s_col[i0 - 1]]
                 : c[static_cast<size_t>(i0 - 1) * M + s_col[j - 1]]);
        const double cur = a - ui0 - v;
        if (cur < minv) {
          minv = cur;
          s_way[j] = j0;
        }
        val = minv;
      }
      int idx = j;
      warp_argmin(val, idx);
      if (lane == 0) {
        s_val[buf][warp] = val;
        s_idx[buf][warp] = idx;
      }
      // the one barrier of a pass: s_u[i0] was read above and is written
      // below; the next pass writes the other buffer of warp results
      __syncthreads();
      val = lane < warps ? s_val[buf][lane] : INFINITY;
      idx = lane < warps ? s_idx[buf][lane] : INT_MAX;
      warp_argmin(val, idx);
      buf ^= 1;
      const double delta = val;
      if (used) {
        s_u[s_p[j]] += delta;  // the rows of used columns are distinct
        v -= delta;
      } else if (column) {
        minv -= delta;
      }
      if (t == 0) s_u[i] += delta;  // the virtual column 0 holds row i
      j0 = idx;
      if (s_p[j0] == 0) break;
    }
    __syncthreads();
    // augment along the back pointers to column 0: at most C + 1 steps
    if (t == 0) {
      for (int step = 0; step <= C && j0 != 0; ++step) {
        const int j1 = s_way[j0];
        s_p[j0] = s_p[j1];
        j0 = j1;
      }
    }
  }
  __syncthreads();
  if (column && s_p[j] > 0) {
    const int r = s_p[j] - 1;
    const int query = flip ? j - 1 : r;
    const int target = flip ? s_col[r] : s_col[j - 1];
    tfq[query] = target;
    qft[target] = query;
  }
}

}  // namespace

// Plain C entry point for ctypes. cost (N, Q, M) float32 and valid (N, M)
// bool (one byte each) are contiguous device memory; tgt_for_query (N, Q)
// and query_for_tgt (N, M) int64 receive the target of each query and the
// query of each target, -1 where unmatched. N >= 1, Q and M at most 1024.
// The launch goes on `stream` and does not synchronise. Returns a
// cudaError_t.
extern "C" int tuber_assign(const void* cost, const void* valid,
                            void* tgt_for_query, void* query_for_tgt, int n,
                            int q, int m, void* stream) {
  const int widest = q > m ? q : m;
  const int threads = 32 * (((widest > 1 ? widest : 1) + 31) / 32);
  assign_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(valid),
      static_cast<int64_t*>(tgt_for_query),
      static_cast<int64_t*>(query_for_tgt), q, m);
  return static_cast<int>(cudaGetLastError());
}
