// The exact matcher of the executor's set loss, CUDA C++ for sm_90a.
//
// Replaces explainable_spatial_vqa_tpu/ops/matching.py:hungarian_assignment_jax
// (with _lap_single, :238-340): the Jonker-Volgenant shortest-augmenting-path
// LAP that the JAX package runs on the device, inside jit, in every executor
// train step.  It takes (B, Q, T) float32 costs and a (B, T) mask of valid
// targets, and returns (B, Q) int64: the target each query is matched to, -1
// for a query left unmatched.
//
// Bound on the H100: neither bytes nor operations.  A problem is at most
// 31 x 31 (the executor's are 8 x 8 or 10 x 10) and its algorithm is a chain
// of at most n * (m + 1) dependent steps, so one launch is latency: the
// launch itself and the path loop's shuffles.  Design: one warp per problem,
// one lane per column of the 1-based padded matrix (column 0 is the
// sentinel), so m + 1 <= 32.  Each lane keeps its column's v, minv, way, used
// and p in registers; the padded cost matrix and the row potentials u sit in
// shared memory; the argmin is a shuffle reduction.  Nothing is read back by
// the host: the launch goes on the caller's stream.
//
// The arithmetic repeats _lap_single's float32 operations in its order, so
// that ties fall as JAX breaks them:
//   - pad = max|cost * mask| * 4 + 1e3 per problem (products and sums rounded
//     apart, no FMA), NaN-propagating like jnp.max; invalid target columns and
//     the dummy columns of Q > T take it;
//   - cur = (costp[i0] - u[i0]) - v;
//   - the argmin takes the first NaN, else the first index of the minimum
//     (jnp.argmin's rule), over columns that are not used and not column 0,
//     which read as big = FLT_MAX / 4;
//   - u[p[j]] += delta on used columns (p[0] = i + 1 included), v -= delta
//     on used columns (v[0] too), minv -= delta on the others.
// The path and augmenting loops stop after m + 1 steps, which a finite cost
// never reaches: a NaN or infinite cost cannot hang the card.
//
// C interface, bound with ctypes (every pointer and the stream a void*):
//   int esv_hungarian(cost, mask, out, B, Q, T, stream)
// cost is (B, Q, T) float32, mask (B, T) bool (one byte each), out (B, Q)
// int64, all contiguous; 1 <= Q, 1 <= T and max(Q, T) <= 31.  Returns the
// CUDA error of the launch (0 on success).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;  // problems per block
constexpr int kCols = 32;  // lanes = columns of the padded matrix, sentinel included
constexpr unsigned kAll = 0xffffffffu;

// jnp.max: NaN wins.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// (value, index) a precedes (value, index) b under jnp.argmin's rule: the
// first NaN, else the smaller value, else the smaller index.
__device__ __forceinline__ bool precedes(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  return av < bv || (av == bv && ai < bi);
}

__global__ void __launch_bounds__(kWarps * 32)
    hungarian_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ mask,
                     long long* __restrict__ out, int B, int Q, int T) {
  __shared__ float costp_s[kWarps][kCols][kCols];  // [row][column], 1-based, row/col 0 = 0
  __shared__ float u_s[kWarps][kCols];
  __shared__ int row_col_s[kWarps][kCols];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // whole warps leave together
  const int n = Q;
  const int m = Q > T ? Q : T;
  const float* c = cost + b * Q * T;
  const uint8_t* keep = mask + b * T;
  float(*costp)[kCols] = costp_s[warp];
  float* u = u_s[warp];

  // pad = max|where(mask, cost, 0)| * 4 + 1e3
  float mx = 0.0f;
  for (int e = lane; e < Q * T; e += 32) mx = max_nan(mx, keep[e % T] ? fabsf(c[e]) : 0.0f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = max_nan(mx, __shfl_xor_sync(kAll, mx, off));
  const float pad = __fadd_rn(__fmul_rn(mx, 4.0f), 1000.0f);

  // costp[r][j] = cost[r - 1][j - 1], or pad on an invalid or dummy column
  for (int r = 0; r <= n; ++r) {
    float val = 0.0f;
    if (r > 0 && lane > 0 && lane <= m) {
      const int t = lane - 1;
      val = (t < T && keep[t]) ? c[(r - 1) * T + t] : pad;
    }
    costp[r][lane] = val;
  }
  u[lane] = 0.0f;
  __syncwarp();

  const float big = FLT_MAX / 4.0f;
  const bool column = lane <= m;  // lanes past m hold no column
  float v = 0.0f;
  int p = 0;  // the row (1-based) matched to this lane's column, 0 = none

  for (int i = 0; i < n; ++i) {
    if (lane == 0) p = i + 1;
    float minv = big;
    int way = 0;
    bool used = false;
    int j0 = 0;
    for (int step = 0; step <= m; ++step) {
      const int i0 = __shfl_sync(kAll, p, j0);
      if (i0 == 0) break;
      if (lane == j0) used = true;
      const float cur = (costp[i0][lane] - u[i0]) - v;
      if (column && lane > 0 && !used && cur < minv) {
        minv = cur;
        way = j0;
      }
      float best = (used || lane == 0) ? big : minv;
      int arg = lane;
      if (!column) {  // never chosen: a value no column can lose to
        best = INFINITY;
        arg = kCols;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kAll, best, off);
        const int oi = __shfl_xor_sync(kAll, arg, off);
        if (precedes(ov, oi, best, arg)) {
          best = ov;
          arg = oi;
        }
      }
      const float delta = best;
      __syncwarp();  // every lane has read u[i0]
      if (column && used) u[p] += delta;
      __syncwarp();
      if (column) {
        if (used) {
          v -= delta;
        } else {
          minv -= delta;
        }
      }
      j0 = arg;
    }
    for (int step = 0; step <= m && j0 != 0; ++step) {  // augment along way
      const int j1 = __shfl_sync(kAll, way, j0);
      const int pj1 = __shfl_sync(kAll, p, j1);
      if (lane == j0) p = pj1;
      j0 = j1;
    }
  }

  // row_to_col[p[j] - 1] = j - 1 for matched columns; rows left unset read
  // column 0, as the JAX package's zero-initialised scatter leaves them
  row_col_s[warp][lane] = 0;
  __syncwarp();
  if (column && lane > 0 && p > 0 && p <= n) row_col_s[warp][p - 1] = lane - 1;
  __syncwarp();
  if (lane < n) {
    const int col = row_col_s[warp][lane];
    out[b * Q + lane] = (col < T && keep[col]) ? col : -1;
  }
}

}  // namespace

extern "C" int esv_hungarian(const void* cost, const void* mask, void* out, int B, int Q, int T,
                             void* stream) {
  if (B < 0 || Q < 1 || T < 1 || Q > kCols - 1 || T > kCols - 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  hungarian_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(mask),
      static_cast<long long*>(out), B, Q, T);
  return static_cast<int>(cudaGetLastError());
}
