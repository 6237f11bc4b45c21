// The exact matcher of the executor's set loss, CUDA C++ for sm_90a.
//
// Replaces explainable_spatial_vqa_tpu/ops/matching.py:hungarian_assignment_jax
// (with _lap_single, :238-340): the Jonker-Volgenant shortest-augmenting-path
// LAP that the JAX package runs on the device, inside jit, in every executor
// train step.  It takes (B, Q, T) float32 costs and a (B, T) mask of valid
// targets, and returns (B, Q) int64: the target each query is matched to, -1
// for a query left unmatched.  Like JAX's, it takes any size: it solves the
// n x m problem with n = Q and m = max(Q, T) (dummy columns when Q > T).
//
// Bound on the H100: neither bytes nor operations.  The algorithm is a chain
// of at most n * (m + 1) dependent steps, each an argmin over m + 1 columns,
// so one launch is latency: the launch itself and each step's reduction.
// Two kernels, chosen by m in esv_hungarian alone:
//   * m + 1 <= 32 (hungarian_kernel; the executor's 8 x 8 and 10 x 10
//     problems): one warp per problem, one lane per column of the 1-based
//     padded matrix (column 0 is the sentinel).  Each lane keeps its
//     column's v, minv, way, used and p in registers; the padded cost matrix
//     and the row potentials u sit in shared memory; the argmin is a
//     shuffle reduction.
//   * m + 1 > 32 (hungarian_block_kernel): one block per problem, 128-1024
//     threads chosen from m, thread t owning the columns j = t (mod
//     blockDim).  The per-column state (v, minv, way, used, p), u and the
//     row-to-column map live in shared memory, or past its capacity in a
//     global scratch the caller allocates; each path step reads the one
//     padded cost row it needs, costp[i0], from global memory, coalesced
//     over j.  The argmin is each thread's own columns, then a shuffle
//     reduction within each warp, then one across the warps through shared
//     memory, every comparison under the warp kernel's rule (precedes): the
//     comparisons are exact, so the block reaches the j1 of JAX's serial
//     jnp.argmin.  Two block barriers a step: after the argmin (u[i0] read),
//     and after the updates.
// Nothing is read back by the host: the launch goes on the caller's stream.
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
//   long long esv_hungarian_scratch_bytes(B, Q, T)
// the bytes of global scratch a launch at (B, Q, T) needs (0 but for the
// block kernel past the shared memory it may take; a negative CUDA error
// on failure), for the caller to allocate: the kernels allocate nothing;
//   int esv_hungarian(cost, mask, out, scratch, B, Q, T, stream)
// cost is (B, Q, T) float32, mask (B, T) bool (one byte each), out (B, Q)
// int64, all contiguous; scratch that many bytes, 16-byte aligned, or null
// when none is needed; 1 <= Q and 1 <= T.  Returns the CUDA error of the
// launch (0 on success).
//   const char* esv_hungarian_kernel(int i)
//   long long esv_hungarian_launches(int i)
// name and count (since the library was loaded) the launches of kernel i: 0
// hungarian_kernel, 1 hungarian_block_kernel, 2 hungarian_block_kernel's
// launches whose state went to the global scratch (also counted under 1);
// null and -1 past the last.
//   long long esv_hungarian_set_shared_limit(long long bytes)
// caps the block kernel's shared memory at bytes (a negative value: the
// device's capacity, the default) and returns the cap it replaces: a cap of
// 0 sends every block launch's state to the global scratch, for tests.

#include <cuda_runtime.h>

#include <atomic>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // problems per block
constexpr int kCols = 32;  // lanes = columns of the padded matrix, sentinel included
constexpr unsigned kAll = 0xffffffffu;
constexpr int kBlockMinThreads = 128, kBlockMaxThreads = 1024;  // the block kernel's range

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

// The block kernel's state for one problem, n rows and m + 1 columns, in
// bytes: v, minv, way and p (4 bytes a column), u (n + 1 floats), the
// row-to-column map (n ints), used (a byte a column), rounded up to 16
__host__ __device__ constexpr size_t block_state_bytes(int n, int m) {
  return ((size_t)4 * (4 * (m + 1) + (n + 1) + n) + (m + 1) + 15) / 16 * 16;
}

// (best, arg) of the whole block under precedes: each warp's by shuffles,
// then across the warps through red_v / red_i, read by every thread.  The
// caller puts a block barrier between this call and the next write of
// red_v / red_i.
__device__ __forceinline__ void block_argmin(float& best, int& arg, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kAll, best, off);
    const int oi = __shfl_xor_sync(kAll, arg, off);
    if (precedes(ov, oi, best, arg)) {
      best = ov;
      arg = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = arg;
  }
  __syncthreads();
  best = red_v[0];
  arg = red_i[0];
  for (int w = 1; w < warps; ++w) {
    if (precedes(red_v[w], red_i[w], best, arg)) {
      best = red_v[w];
      arg = red_i[w];
    }
  }
}

// One problem per block (m + 1 > 32).  scratch: null for the state in
// dynamic shared memory, else B states of block_state_bytes(n, m) in global
// memory, problem b's at b times that.
__global__ void __launch_bounds__(kBlockMaxThreads)
    hungarian_block_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ mask,
                           long long* __restrict__ out, int Q, int T,
                           unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char state_s[];
  __shared__ float red_v[kBlockMaxThreads / 32];
  __shared__ int red_i[kBlockMaxThreads / 32];

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = Q;
  const int m = Q > T ? Q : T;
  const int cols = m + 1;
  const float* c = cost + b * Q * T;
  const uint8_t* keep = mask + b * T;
  unsigned char* base = scratch == nullptr ? state_s : scratch + b * block_state_bytes(n, m);
  float* v = reinterpret_cast<float*>(base);  // [cols]
  float* minv = v + cols;                     // [cols]
  int* way = reinterpret_cast<int*>(minv + cols);  // [cols]
  int* p = way + cols;                        // [cols]: the row (1-based) matched to column j
  float* u = reinterpret_cast<float*>(p + cols);   // [n + 1]
  int* row_col = reinterpret_cast<int*>(u + n + 1);  // [n]
  unsigned char* used = reinterpret_cast<unsigned char*>(row_col + n);  // [cols]

  // pad = max|where(mask, cost, 0)| * 4 + 1e3
  float mx = 0.0f;
  for (int e = tid; e < Q * T; e += nt) mx = max_nan(mx, keep[e % T] ? fabsf(c[e]) : 0.0f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = max_nan(mx, __shfl_xor_sync(kAll, mx, off));
  if ((tid & 31) == 0) red_v[tid >> 5] = mx;
  for (int j = tid; j < cols; j += nt) {
    v[j] = 0.0f;
    p[j] = 0;
  }
  for (int r = tid; r <= n; r += nt) u[r] = 0.0f;
  __syncthreads();
  for (int w = 0; w < nt / 32; ++w) mx = max_nan(mx, red_v[w]);
  const float pad = __fadd_rn(__fmul_rn(mx, 4.0f), 1000.0f);
  const float big = FLT_MAX / 4.0f;
  __syncthreads();  // red_v read by every thread before the first argmin writes it

  for (int i = 0; i < n; ++i) {
    for (int j = tid; j < cols; j += nt) {
      minv[j] = big;
      way[j] = 0;
      used[j] = 0;
    }
    if (tid == 0) p[0] = i + 1;
    __syncthreads();
    int j0 = 0;
    for (int step = 0; step <= m; ++step) {
      const int i0 = p[j0];  // p does not change in the path loop: one value for the block
      if (i0 == 0) break;
      if (tid == j0 % nt) used[j0] = 1;  // its owner, the one thread that reads it below
      const float ui0 = u[i0];
      const float* row = c + (long long)(i0 - 1) * T;
      float best = INFINITY;  // a thread with no column: never chosen
      int arg = INT_MAX;
      for (int j = tid; j < cols; j += nt) {
        const bool uj = used[j] != 0;
        float mv = minv[j];
        if (j > 0) {
          const int t = j - 1;
          const float cp = (t < T && keep[t]) ? row[t] : pad;
          const float cur = (cp - ui0) - v[j];
          if (!uj && cur < mv) {
            mv = cur;
            minv[j] = cur;
            way[j] = j0;
          }
        }
        const float masked = (uj || j == 0) ? big : mv;
        if (precedes(masked, j, best, arg)) {
          best = masked;
          arg = j;
        }
      }
      block_argmin(best, arg, red_v, red_i);  // every thread has read u[i0]
      const float delta = best;
      for (int j = tid; j < cols; j += nt) {
        if (used[j]) {
          u[p[j]] += delta;  // distinct rows: p matches used columns to rows one to one
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      __syncthreads();  // the updates land before the next step reads them
      j0 = arg;
    }
    if (tid == 0) {  // augment along way
      for (int step = 0; step <= m && j0 != 0; ++step) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }

  // row_to_col[p[j] - 1] = j - 1 for matched columns; rows left unset read
  // column 0, as the JAX package's zero-initialised scatter leaves them
  for (int r = tid; r < n; r += nt) row_col[r] = 0;
  __syncthreads();
  for (int j = tid; j < cols; j += nt)
    if (j > 0 && p[j] > 0 && p[j] <= n) row_col[p[j] - 1] = j - 1;
  __syncthreads();
  for (int r = tid; r < n; r += nt) {
    const int col = row_col[r];
    out[b * Q + r] = (col < T && keep[col]) ? col : -1;
  }
}

// Launches of each kernel since the library was loaded (esv_hungarian_launches)
enum HungarianKernel { kWarpKernel, kBlockKernel, kBlockGlobalState, kHungarianKernels };
const char* const kHungarianKernelNames[kHungarianKernels] = {
    "hungarian_kernel", "hungarian_block_kernel", "hungarian_block_kernel_global_state"};
std::atomic<long long> g_launches[kHungarianKernels];
std::atomic<long long> g_shared_limit{-1};  // bytes; negative: the device's capacity

// The block kernel's threads for m: a warp per 32 columns, 128 to 1024
int block_threads(int m) {
  const int warps = (m + 1 + 31) / 32;
  const int threads = warps * 32;
  return threads < kBlockMinThreads ? kBlockMinThreads
                                    : threads > kBlockMaxThreads ? kBlockMaxThreads : threads;
}

// The largest dynamic shared memory a block kernel launch may take on the
// current device: the opt-in capacity less the kernel's static arrays, the
// attribute raised to it once per device
cudaError_t block_shared_capacity(size_t* bytes) {
  int dev;
  static int capacity[esv::kMaxDevices];
  const cudaError_t err =
      esv::once_per_device<esv::KernelSite<hungarian_block_kernel> >(&dev, [](int d) {
        int optin = 0;
        cudaFuncAttributes attr;
        cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, d);
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, hungarian_block_kernel);
        if (e != cudaSuccess) return e;
        capacity[d] = optin - (int)attr.sharedSizeBytes;
        return cudaFuncSetAttribute(hungarian_block_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, capacity[d]);
      });
  if (err != cudaSuccess) return err;
  *bytes = (size_t)capacity[dev];
  return cudaSuccess;
}

// The bytes of global scratch a launch at (B, Q, T) needs: the block
// kernel's states where one exceeds the shared memory it may take, else 0
cudaError_t scratch_bytes(int B, int Q, int T, size_t* bytes) {
  *bytes = 0;
  const int m = Q > T ? Q : T;
  if (m + 1 <= kCols) return cudaSuccess;
  size_t capacity;
  const cudaError_t err = block_shared_capacity(&capacity);
  if (err != cudaSuccess) return err;
  const long long limit = g_shared_limit.load();
  if (limit >= 0 && (size_t)limit < capacity) capacity = (size_t)limit;
  const size_t state = block_state_bytes(Q, m);
  if (state > capacity) *bytes = state * (size_t)B;
  return cudaSuccess;
}

}  // namespace

extern "C" long long esv_hungarian_scratch_bytes(int B, int Q, int T) {
  if (B < 0 || Q < 1 || T < 1) return -(long long)cudaErrorInvalidValue;
  size_t bytes;
  const cudaError_t err = scratch_bytes(B, Q, T, &bytes);
  return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

extern "C" int esv_hungarian(const void* cost, const void* mask, void* out, void* scratch, int B,
                             int Q, int T, void* stream) {
  if (B < 0 || Q < 1 || T < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = Q > T ? Q : T;
  if (m + 1 <= kCols) {
    const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
    hungarian_kernel<<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(cost), static_cast<const uint8_t*>(mask),
        static_cast<long long*>(out), B, Q, T);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) g_launches[kWarpKernel].fetch_add(1, std::memory_order_relaxed);
    return static_cast<int>(err);
  }
  size_t global;
  cudaError_t err = scratch_bytes(B, Q, T, &global);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (global > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t state = block_state_bytes(Q, m);
  hungarian_block_kernel<<<B, block_threads(m), global > 0 ? 0 : state, s>>>(
      static_cast<const float*>(cost), static_cast<const uint8_t*>(mask),
      static_cast<long long*>(out), Q, T,
      global > 0 ? static_cast<unsigned char*>(scratch) : nullptr);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_launches[kBlockKernel].fetch_add(1, std::memory_order_relaxed);
    if (global > 0) g_launches[kBlockGlobalState].fetch_add(1, std::memory_order_relaxed);
  }
  return static_cast<int>(err);
}

extern "C" const char* esv_hungarian_kernel(int i) {
  return i >= 0 && i < kHungarianKernels ? kHungarianKernelNames[i] : nullptr;
}

extern "C" long long esv_hungarian_launches(int i) {
  return i >= 0 && i < kHungarianKernels ? g_launches[i].load() : -1;
}

extern "C" long long esv_hungarian_set_shared_limit(long long bytes) {
  return g_shared_limit.exchange(bytes < 0 ? -1 : bytes);
}
