// Column reductions for BatchNorm statistics, and the train-mode BN
// backward built on them, float32, for sm_90a.
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
// `ofa_bn_backward_f32` is the whole backward of `bn_train_fused`
// (ofa_sr_tpu/ops/pallas/bn.py `_bwd`, without the moments' cotangents):
//   s1 = sum_n dy, s2 = sum_n dy*xhat, xhat = (x - mean)*inv
//   dx = inv*scale*(dy - s1/N - xhat*s2/N), dscale = s2, dbias = s1
// where the JAX package leaves the dx pass to XLA, which fuses it; eager
// PyTorch would run it as ~9 elementwise kernels. Here it is a third pass
// in the same call.
//
// What bounds it on the H100: bytes. Each element is read once and costs 2
// to 5 FLOP, far below the card's float32 FLOP/byte ridge (67 TFLOP/s over
// 3.35 TB/s = 20), so the least time is N*C*4 bytes (moments), 2*N*C*4
// bytes (backward sums) or 3*N*C*4 bytes (backward with dx) over the memory
// rate.
//
// Design. The Pallas kernel walks row tiles in order and adds into one
// resident (2, C) block; blocks of a CUDA grid run in parallel and in no
// order, so the sum is split in two passes, with no atomics, so the same
// input gives the same bits on every run:
//   pass 1: block (g, t) sums rows [g*R, (g+1)*R), R = ceil(N / G), of
//           column tile t (up to 256 column groups) into a partial pair. A column group is 4
//           adjacent columns read as one float4 where C % 4 == 0 and the
//           rows are 16-byte aligned, else one column. Thread i owns group
//           i % cq of row group i / cq, and steps by 256 / cq rows, so
//           neighbouring threads read neighbouring addresses at every C
//           (C=3 too: 255 threads cover 85 consecutive rows of 3). Rows past
//           N are never read. The row groups of a column are then summed in
//           shared memory, in order, and the block writes its pair to
//           partial[(k*C + c)*G + g] (k = 0 for the first sum, 1 for the
//           second).
//   pass 2: one warp per column c sums its G partials of both sums: lane l
//           takes g = l, l+32, ... in order, then a fixed shuffle tree; the
//           moments mode writes (mean, var) in place of (s1, s2), the
//           backward also the column's dx coefficients (inv*scale, s1/N,
//           s2/N).
//   pass 3 (backward): dx, one grid-stride pass, float4 loads and stores
//           where C % 4 == 0 and the pointers are 16-byte aligned. The grid
//           is a multiple of C / gcd(C, stride) so that a thread's columns
//           stay the same on every step and their coefficients are loaded
//           once.
// The scratch `partial` (2*C*G floats), `out` (2*C) and `coef` (3*C) are
// allocated by the caller.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // pass 1 block; also the widest column tile
constexpr int WARPS2 = 8;      // pass 2: warps (columns) per block
constexpr int DX_BLOCKS = 1024;  // pass 3: blocks aimed at (before rounding)

// MOMENTS reads `a` once (b = a) and finalizes in pass 2
enum Mode { SUMS2 = 0, MOMENTS = 1, BWD = 2 };

// V = 4: each thread owns 4 adjacent columns and reads them as one float4
// (C % 4 == 0, 16-byte aligned rows); V = 1: one column, any C
template <int MODE, int V>
__global__ void __launch_bounds__(THREADS)
col_partials_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    float* __restrict__ partial, int N, int C) {
  __shared__ float sh1[THREADS * V];
  __shared__ float sh2[THREADS * V];
  const int c0 = blockIdx.y * THREADS * V;
  const int cq = min(THREADS, (C - c0) / V);  // column groups in this tile
  const int rp = THREADS / cq;                // row groups (rows per step)
  const int tid = threadIdx.x;
  const int col = c0 + (tid % cq) * V;
  const int grp = tid / cq;

  float s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
  if (grp < rp) {
    float m[V], iv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      m[e] = MODE == BWD ? mean[col + e] : 0.f;
      iv[e] = MODE == BWD ? inv[col + e] : 0.f;
    }
    // block g: rows [g*R, (g+1)*R), R = ceil(N / G)
    const long long R = ((long long)N + gridDim.x - 1) / gridDim.x;
    const long long r0 = (long long)blockIdx.x * R;
    const long long r1 = min((long long)N, r0 + R);
#pragma unroll 4
    for (long long r = r0 + grp; r < r1; r += rp) {
      const size_t i = (size_t)r * C + col;
      float av[V], bv[V];
      if constexpr (V == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(a + i);
        av[0] = a4.x, av[1] = a4.y, av[2] = a4.z, av[3] = a4.w;
        if (MODE != MOMENTS) {
          const float4 b4 = *reinterpret_cast<const float4*>(b + i);
          bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
        }
      } else {
        av[0] = a[i];
        if (MODE != MOMENTS) bv[0] = b[i];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float x = MODE == MOMENTS ? av[e] : bv[e];
        if (MODE == BWD) x = (x - m[e]) * iv[e];
        s1[e] += av[e];
        s2[e] = fmaf(av[e], x, s2[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sh1[tid * V + e] = s1[e];
    sh2[tid * V + e] = s2[e];
  }
  __syncthreads();
  if (tid < cq) {
    const size_t G = gridDim.x;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float t1 = 0.f, t2 = 0.f;
      for (int j = 0; j < rp; ++j) {
        t1 += sh1[(j * cq + tid) * V + e];
        t2 += sh2[(j * cq + tid) * V + e];
      }
      partial[(size_t)(col + e) * G + blockIdx.x] = t1;
      partial[((size_t)C + col + e) * G + blockIdx.x] = t2;
    }
  }
}

// templated on the mode so that a profile tells the forward's finish from
// the backward's
template <int MODE>
__global__ void __launch_bounds__(WARPS2 * 32)
finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
              const float* __restrict__ scale, const float* __restrict__ inv,
              float* __restrict__ coef, int N, int C, int G) {
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
  const float n = (float)N;
  if (MODE == MOMENTS) {
    const float mean = s1 / n;
    s1 = mean;
    s2 = s2 / n - mean * mean;
  }
  if (MODE == BWD && coef != nullptr) {
    coef[c] = inv[c] * scale[c];
    coef[C + c] = s1 / n;
    coef[2 * C + c] = s2 / n;
  }
  out[c] = s1;
  out[C + c] = s2;
}

__device__ __forceinline__ float dx_of(float dy, float x, float mean,
                                       float inv, float k, float m1,
                                       float m2) {
  // the JAX package's association: inv*scale*(dy - s1/n - xhat*s2/n)
  return k * (dy - m1 - ((x - mean) * inv) * m2);
}

// pass 3, C % 4 == 0: thread t handles float4 u = t, t + S, ... of the
// N*C/4; S*4 % C == 0, so its 4 columns are the same on every step
__global__ void __launch_bounds__(THREADS)
bn_dx_kernel_vec4(const float4* __restrict__ dy, const float4* __restrict__ x,
                  const float4* __restrict__ mean,
                  const float4* __restrict__ inv,
                  const float4* __restrict__ coef, float4* __restrict__ dx,
                  long long units, int C4) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (t >= units) return;
  const int q = (int)(t % C4);
  const float4 m = mean[q], iv = inv[q], k = coef[q], m1 = coef[C4 + q],
               m2 = coef[2 * C4 + q];
  for (long long u = t; u < units; u += stride) {
    const float4 d = dy[u], xv = x[u];
    float4 r;
    r.x = dx_of(d.x, xv.x, m.x, iv.x, k.x, m1.x, m2.x);
    r.y = dx_of(d.y, xv.y, m.y, iv.y, k.y, m1.y, m2.y);
    r.z = dx_of(d.z, xv.z, m.z, iv.z, k.z, m1.z, m2.z);
    r.w = dx_of(d.w, xv.w, m.w, iv.w, k.w, m1.w, m2.w);
    dx[u] = r;
  }
}

// pass 3, any C: one element a step, S % C == 0
__global__ void __launch_bounds__(THREADS)
bn_dx_kernel(const float* __restrict__ dy, const float* __restrict__ x,
             const float* __restrict__ mean, const float* __restrict__ inv,
             const float* __restrict__ coef, float* __restrict__ dx,
             long long units, int C) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (t >= units) return;
  const int c = (int)(t % C);
  const float m = mean[c], iv = inv[c], k = coef[c], m1 = coef[C + c],
              m2 = coef[2 * C + c];
  for (long long u = t; u < units; u += stride)
    dx[u] = dx_of(dy[u], x[u], m, iv, k, m1, m2);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int MODE>
cudaError_t launch(const float* a, const float* b, const float* mean,
                   const float* inv, const float* scale, float* partial,
                   float* out, float* coef, int N, int C, int G,
                   cudaStream_t stream) {
  const bool vec = C % 4 == 0 && aligned16(a) && aligned16(b);
  if (vec)
    col_partials_kernel<MODE, 4>
        <<<dim3(G, (C + 4 * THREADS - 1) / (4 * THREADS)), THREADS, 0,
           stream>>>(a, b, mean, inv, partial, N, C);
  else
    col_partials_kernel<MODE, 1>
        <<<dim3(G, (C + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
            a, b, mean, inv, partial, N, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finish_kernel<MODE><<<(C + WARPS2 - 1) / WARPS2, WARPS2 * 32, 0, stream>>>(
      partial, out, scale, inv, coef, N, C, G);
  return cudaGetLastError();
}

bool bad_shape(int N, int C, int G) {
  return N <= 0 || C <= 0 || G <= 0 || (C + THREADS - 1) / THREADS > 65535;
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

// mode 0: col_sums2(a, b); 1: the moments (mean, biased var) of a's
// columns, reading a once (b unused); 2: bn_bwd_sums(dy=a, x=b, mean, inv).
// `partial` holds 2*C*G floats, `out` 2*C:
// out[c] is the first result of column c, out[C + c] the second. Pass 1
// runs G blocks along the rows, each over ceil(N / G) rows.
extern "C" int ofa_col_sums2_f32(const float* a, const float* b,
                                 const float* mean, const float* inv,
                                 float* partial, float* out, int N, int C,
                                 int G, int mode, void* stream) {
  if (bad_shape(N, C, G)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case SUMS2:
      return (int)launch<SUMS2>(a, b, mean, inv, nullptr, partial, out,
                                nullptr, N, C, G, s);
    case MOMENTS:
      return (int)launch<MOMENTS>(a, a, mean, inv, nullptr, partial, out,
                                  nullptr, N, C, G, s);
    case BWD:
      if (mean == nullptr || inv == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<BWD>(a, b, mean, inv, nullptr, partial, out, nullptr,
                              N, C, G, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The train-mode BN backward: out = (s1 = dbias, s2 = dscale) as in mode 2,
// and dx (N, C). `partial` holds 2*C*G floats, `coef` 3*C.
extern "C" int ofa_bn_backward_f32(const float* dy, const float* x,
                                   const float* scale, const float* mean,
                                   const float* inv, float* partial,
                                   float* coef, float* out, float* dx, int N,
                                   int C, int G, void* stream) {
  if (bad_shape(N, C, G) || !dy || !x || !scale || !mean ||
      !inv || !coef || !dx)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch<BWD>(dy, x, mean, inv, scale, partial, out, coef, N,
                              C, G, s);
  if (e != cudaSuccess) return (int)e;
  const bool vec = C % 4 == 0 && aligned16(dy) && aligned16(x) &&
                   aligned16(mean) && aligned16(inv) && aligned16(coef) &&
                   aligned16(dx);
  const int width = vec ? C / 4 : C;            // units per row
  const long long units = (long long)N * width;
  // blocks: a multiple of q, so that stride * k covers whole rows
  const int q = width / gcd(width, THREADS);
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > DX_BLOCKS) blocks = DX_BLOCKS;
  blocks = (blocks + q - 1) / q * q;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec)
    bn_dx_kernel_vec4<<<(unsigned)blocks, THREADS, 0, s>>>(
        (const float4*)dy, (const float4*)x, (const float4*)mean,
        (const float4*)inv, (const float4*)coef, (float4*)dx, units, width);
  else
    bn_dx_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(dy, x, mean, inv, coef,
                                                      dx, units, C);
  return (int)cudaGetLastError();
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
