// Column reductions for BatchNorm statistics, float32, for sm_90a.
//
// Replaces the Pallas kernels of ofa_sr_tpu/ops/pallas/bn_stats.py:
//   `col_sums2` (`_kernel`)       -> (sum_n a[n,c], sum_n a[n,c]*b[n,c])
//   `bn_bwd_sums` (`_bwd_kernel`) -> (sum_n dy[n,c],
//                                     sum_n dy[n,c]*(x[n,c]-mean[c])*inv[c])
// over the rows of row-major (N, C) arrays (an NHWC activation viewed as
// (B*H*W, C)), accumulated in float32. The moments of BN are col_sums2(x, x)
// finalized as mean = s1/N, var = s2/N - mean^2 (`bn_moments_pallas`); the
// moments mode reads x once and finalizes in pass 2.
//
// What bounds it on the H100: bytes. Each element is read once and costs 2
// to 5 FLOP, far below the card's float32 FLOP/byte ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so the least time is N*C*4 bytes (moments) or 2*N*C*4
// bytes (backward) over the memory rate.
//
// Design. The Pallas kernel walks row tiles in order and adds into one
// resident (2, C) block; blocks of a CUDA grid run in parallel and in no
// order, so the sum is split in two passes, with no atomics, so the same
// input gives the same bits on every run:
//   pass 1: block (g, t) sums rows [g*R, (g+1)*R) of column tile t (up to 256
//           columns) into a partial pair. Thread i owns column c0 + i % ct of
//           row group i / ct, and steps by 256 / ct rows, so neighbouring
//           threads read neighbouring addresses at every C (C=3 too: 255
//           threads cover 85 consecutive rows of 3). Rows past N are never
//           read. The row groups of a column are then summed in shared
//           memory, in order, and the block writes its pair to
//           partial[(k*C + c)*G + g] (k = 0 for the first sum, 1 for the
//           second).
//   pass 2: one warp per column c sums its G partials of both sums: lane l
//           takes g = l, l+32, ... in order, then a fixed shuffle tree; the
//           moments mode writes (mean, var) in place of (s1, s2).
// The scratch `partial` (2*C*G floats) and `out` (2*C) are allocated by the
// caller.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;   // pass 1 block; also the widest column tile
constexpr int WARPS2 = 8;      // pass 2: warps (columns) per block

// MOMENTS reads `a` once (b = a) and finalizes in pass 2
enum Mode { SUMS2 = 0, MOMENTS = 1, BWD = 2 };

template <int MODE>
__global__ void __launch_bounds__(THREADS)
col_partials_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    float* __restrict__ partial, int N, int C,
                    int rows_per_block) {
  __shared__ float sh1[THREADS];
  __shared__ float sh2[THREADS];
  const int c0 = blockIdx.y * THREADS;
  const int ct = min(THREADS, C - c0);   // columns in this tile
  const int rp = THREADS / ct;           // row groups (rows per step)
  const int tid = threadIdx.x;
  const int col = c0 + tid % ct;
  const int grp = tid / ct;

  float s1 = 0.f, s2 = 0.f;
  if (grp < rp) {
    const long long r0 = (long long)blockIdx.x * rows_per_block;
    const long long r1 = min((long long)N, r0 + rows_per_block);
    float m = 0.f, iv = 0.f;
    if (MODE == BWD) {
      m = mean[col];
      iv = inv[col];
    }
#pragma unroll 4
    for (long long r = r0 + grp; r < r1; r += rp) {
      const size_t i = (size_t)r * C + col;
      const float av = a[i];
      float bv = MODE == MOMENTS ? av : b[i];
      if (MODE == BWD) bv = (bv - m) * iv;
      s1 += av;
      s2 = fmaf(av, bv, s2);
    }
  }
  sh1[tid] = s1;
  sh2[tid] = s2;
  __syncthreads();
  if (tid < ct) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < rp; ++j) {
      t1 += sh1[j * ct + tid];
      t2 += sh2[j * ct + tid];
    }
    const size_t G = gridDim.x;
    partial[(size_t)col * G + blockIdx.x] = t1;
    partial[((size_t)C + col) * G + blockIdx.x] = t2;
  }
}

__global__ void __launch_bounds__(WARPS2 * 32)
finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int C,
              int G, int finalize_n) {
  const int c = blockIdx.x * WARPS2 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= C) return;  // the whole warp leaves together
  const float* p1 = partial + (size_t)c * G;
  const float* p2 = partial + ((size_t)C + c) * G;
  float s1 = 0.f, s2 = 0.f;
  for (int g = lane; g < G; g += 32) {
    s1 += p1[g];
    s2 += p2[g];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  if (lane != 0) return;
  if (finalize_n > 0) {
    const float n = (float)finalize_n;
    const float mean = s1 / n;
    s1 = mean;
    s2 = s2 / n - mean * mean;
  }
  out[c] = s1;
  out[C + c] = s2;
}

template <int MODE>
cudaError_t launch(const float* a, const float* b, const float* mean,
                   const float* inv, float* partial, float* out, int N, int C,
                   int G, int rows_per_block, cudaStream_t stream) {
  const dim3 grid1(G, (C + THREADS - 1) / THREADS);
  col_partials_kernel<MODE><<<grid1, THREADS, 0, stream>>>(
      a, b, mean, inv, partial, N, C, rows_per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finish_kernel<<<(C + WARPS2 - 1) / WARPS2, WARPS2 * 32, 0, stream>>>(
      partial, out, C, G, MODE == MOMENTS ? N : 0);
  return cudaGetLastError();
}

}  // namespace

// mode 0: col_sums2(a, b); 1: the moments (mean, biased var) of a's
// columns, reading a once (b unused); 2: bn_bwd_sums(dy=a, x=b, mean, inv).
// `partial` holds 2*C*G floats, `out` 2*C:
// out[c] is the first result of column c, out[C + c] the second. Block g of
// pass 1 covers rows [g*rows_per_block, (g+1)*rows_per_block).
extern "C" int ofa_col_sums2_f32(const float* a, const float* b,
                                 const float* mean, const float* inv,
                                 float* partial, float* out, int N, int C,
                                 int G, int rows_per_block, int mode,
                                 void* stream) {
  if (N <= 0 || C <= 0 || G <= 0 || rows_per_block <= 0 ||
      (long long)G * rows_per_block < N || (C + THREADS - 1) / THREADS > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case SUMS2:
      return (int)launch<SUMS2>(a, b, mean, inv, partial, out, N, C, G,
                                rows_per_block, s);
    case MOMENTS:
      return (int)launch<MOMENTS>(a, a, mean, inv, partial, out, N, C, G,
                                  rows_per_block, s);
    case BWD:
      if (mean == nullptr || inv == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<BWD>(a, b, mean, inv, partial, out, N, C, G,
                              rows_per_block, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
