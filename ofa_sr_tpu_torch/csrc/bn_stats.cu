// Column reductions for BatchNorm statistics, and the train-mode BN
// forward and backward built on them, for sm_90a, on float32 or bfloat16
// activations.
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
// `ofa_bn_forward_*` is the whole train-mode BN forward: the Pallas moments
// (`bn_moments_pallas`, called from ofa_sr_tpu/ops/pallas/bn.py `_fwd_impl`),
// the normalize XLA fuses after them there
//   inv = rsqrt(var + eps), y = (x - mean)*(inv*scale) + bias
// and the running statistics' EMA of ofa_sr_tpu/ops/norm.py `batch_norm`
//   r = (1 - m)*r + m*stat   (stat: mean, and var*(N/(N-1)) or var)
// in one call, where eager PyTorch ran ~15 small kernels after the moments.
//
// `ofa_bn_backward_*` is the whole backward of `bn_train_fused`
// (ofa_sr_tpu/ops/pallas/bn.py `_bwd`, without the moments' cotangents):
//   s1 = sum_n dy, s2 = sum_n dy*xhat, xhat = (x - mean)*inv
//   dx = inv*scale*(dy - s1/N - xhat*s2/N), dscale = s2, dbias = s1
// where the JAX package leaves the dx pass to XLA, which fuses it; eager
// PyTorch would run it as ~9 elementwise kernels. Here it is a third pass
// in the same call.
//
// Operand types. The Pallas kernels read their operands in whatever type
// they come in and accumulate in float32 (`.astype(jnp.float32)` on each
// tile); under the JAX trainer's bf16 compute (`cast_params_for_compute`)
// BN receives bf16 activations. So each entry point has two forms: `_f32`
// (float a, b / dy, x, dx / x, y) and `_bf16` (__nv_bfloat16), one template
// instantiated twice. Both convert every element to float32 with the
// intrinsics, add in the same fixed order, and write float32 sums, moments
// and coefficients; a bf16 dx or y is rounded once, from its float32 value
// (`__floats2bfloat162_rn` / `__float2bfloat16_rn`), as the JAX package's
// `.astype(x.dtype)` does. scale, bias, mean, inv and the running
// statistics are float32 in both.
//
// What bounds it on the H100: bytes. Each element costs 2 to 5 FLOP, far
// below the card's float32 FLOP/byte ridge (67 TFLOP/s over 3.35 TB/s = 20),
// so the least time is N*C*s bytes (moments), 2*N*C*s (forward: x read, y
// written; backward sums) or 3*N*C*s (backward with dx) over the memory
// rate, s = 4 (float32) or 2 (bf16): the bf16 forms' bound is half.
//
// Design. The Pallas kernel walks row tiles in order and adds into one
// resident (2, C) block; blocks of a CUDA grid run in parallel and in no
// order, so the sum is split in two passes, with no atomics, so the same
// input gives the same bits on every run:
//   pass 1: block (g, t) sums rows [g*R, (g+1)*R), R = ceil(N / G), of
//           column tile t (up to 256 column groups) into a partial pair. A
//           column group is V adjacent columns read as one 16-byte load
//           (V = 4 floats or 8 bf16) where C % V == 0 and the rows are
//           16-byte aligned; else, for bf16, 2 columns (4 bytes) where
//           C % 2 == 0; else one column. Thread i owns group i % cq of row
//           group i / cq, and steps by 256 / cq rows, so neighbouring
//           threads read neighbouring addresses at every C (C=3 too: 255
//           threads cover 85 consecutive rows of 3). Rows past N are never
//           read. The row groups of a column are then summed in shared
//           memory, in order, by one thread a column, and the block writes
//           its pair to
//           partial[(k*C + c)*G + g] (k = 0 for the first sum, 1 for the
//           second).
//   pass 2: one warp per column c sums its G partials of both sums: lane l
//           takes g = l, l+32, ... in order, then a fixed shuffle tree; the
//           moments mode writes (mean, var) in place of (s1, s2), the
//           backward also the column's dx coefficients (inv*scale, s1/N,
//           s2/N), the forward the column's statistics and the running
//           statistics' update (`bn_fwd_finish_kernel`).
//   pass 3 (backward, forward): dx or y, one grid-stride pass, with pass
//           1's vector width where the operands are aligned for it. The
//           grid is a multiple of W / gcd(W, THREADS) (W = C / V groups a
//           row) so that a thread's columns stay the same on every step and
//           their coefficients are loaded once.
// The forward's finalize rounds each product and sum on its own
// (`__fmul_rn`, `__fadd_rn`, `__fdiv_rn`: no FMA contraction), in the
// association of the plain version's PyTorch ops, so that given the same
// moments the kernel's inv, y and running statistics are those ops' bits.
// The forward takes three launches, not two. Two were tried: pass 2 in
// pass 1's kernel, done by the last block of each column tile to arrive (an
// arrival counter), with 64-column tiles and G <= 128 to bound what that
// block reads. In chip_smoke.py's step profile on an H100 it took 1.679 ms
// of device time a one-subnet step in float32 and 1.522 in bf16, against
// 1.360 and 0.979 for three launches: the lone last block finalized its
// columns one after another, its 108 registers a thread halved pass 1's
// blocks an SM, and the narrow tiles cut bf16 rows into 128-byte pieces,
// while a finish launch costs 2-3 us.
// Under a mesh (data parallelism, the batch's rows split over ranks) the
// BN statistics are the global batch's, as the JAX package's are under a
// sharded jit: each direction runs in two calls with an all-reduce of the
// (2, C) float32 totals between them, made by the caller: pass 1 and its
// column sums (`ofa_col_sums2_*` mode 3 for the forward, mode 2 for the
// backward), then `ofa_bn_forward_from_sums_*` (the finish on the totals
// and the global row count, then the normalize) or
// `ofa_bn_backward_from_sums_*` (the dx coefficients, then dx). The totals
// are summed in the fused call's order, so at one rank they are its bits.
// The masked forward (one captured program for every middle width) passes
// `active`, a device pointer to the active width (JAX's channel mask, a
// prefix), to the fused forward and backward; null means every column. The
// forward's finish updates the running statistics only for c < active and
// its normalize writes y = 0 from there on (JAX's `jnp.where(mask, new,
// old)` and `y * mask`); the backward's finish writes zero sums and dx
// coefficients there, so dx, dscale and dbias are 0: the gradient of the
// re-masked y. The width is read on the device, never by the host, so a
// CUDA graph replays the same launches for any width; a null pointer
// leaves every bit as it was without the operand. Under a mesh the width
// reaches the same places: the backward's pass 1 (mode 2) zeroes this
// rank's sums from it on, so dscale, dbias and the all-reduced totals are
// 0 there; the apply calls' finish keeps the running statistics and writes
// zero dx coefficients there, and the normalize writes y = 0.
// The scratch `partial` (2*C*G floats), `out` (2*C), `coef` (3*C) and
// `stats` (4*C) are allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // pass 1 block; also the widest column tile
constexpr int WARPS2 = 8;      // pass 2: warps (columns) per block
constexpr int DX_BLOCKS = 1024;  // pass 3: blocks aimed at (before rounding)

// MOMENTS reads `a` once (b = a) and finalizes in pass 2
// FWD is MOMENTS for the forward, apart in a profile
enum Mode { SUMS2 = 0, MOMENTS = 1, BWD = 2, FWD = 3 };

// V adjacent elements at p (aligned to V elements) as float32
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    static_assert(V == 1, "float columns are read 4 or 1 at a time");
    v[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x, v[2 * e + 1] = f.y;
    }
  } else if constexpr (V == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x, v[1] = f.y;
  } else {
    static_assert(V == 1, "bf16 columns are read 8, 2 or 1 at a time");
    v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(V == 1, "float columns are written 4 or 1 at a time");
    p[0] = v[0];
  }
}

// one rounding to nearest even per element, from its float32 value
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  } else if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    static_assert(V == 1, "bf16 columns are written 8, 2 or 1 at a time");
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// each thread owns V adjacent columns, read as one load (see load_vec)
template <int MODE, typename T, int V>
__global__ void __launch_bounds__(THREADS)
col_partials_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    float* __restrict__ partial, int N, int C) {
  constexpr bool ONE = MODE == MOMENTS || MODE == FWD;  // reads a alone
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
      load_vec<V>(a + i, av);
      if (!ONE) load_vec<V>(b + i, bv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float x = ONE ? av[e] : bv[e];
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
  // column c0 + k of the tile: its rp row groups summed in order, one
  // thread a column (not a column group: V times fewer additions in a row)
  const size_t G = gridDim.x;
  for (int k = tid; k < cq * V; k += THREADS) {
    const int q = k / V, e = k % V;
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < rp; ++j) {
      t1 += sh1[(j * cq + q) * V + e];
      t2 += sh2[(j * cq + q) * V + e];
    }
    partial[(size_t)(c0 + k) * G + blockIdx.x] = t1;
    partial[((size_t)C + c0 + k) * G + blockIdx.x] = t2;
  }
}

// templated on the mode so that a profile tells the forward's finish from
// the backward's
template <int MODE>
__global__ void __launch_bounds__(WARPS2 * 32)
finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
              const float* __restrict__ scale, const float* __restrict__ inv,
              float* __restrict__ coef, int N, int C, int G,
              const int* __restrict__ active) {
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
  // a column past the active width: zero sums and coefficients (BWD only)
  const bool live = active == nullptr || c < *active;
  if (!live) s1 = s2 = 0.f;
  if (MODE == MOMENTS) {
    const float mean = s1 / n;
    s1 = mean;
    s2 = s2 / n - mean * mean;
  }
  if (MODE == BWD && coef != nullptr) {
    coef[c] = live ? inv[c] * scale[c] : 0.f;
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

// pass 3: thread t handles the V-element groups u = t, t + S, ... of the
// N*C/V; S % (C/V) == 0, so its V columns are the same on every step
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
             const float* __restrict__ mean, const float* __restrict__ inv,
             const float* __restrict__ coef, T* __restrict__ dx,
             long long units, int C) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (t >= units) return;
  const int c0 = (int)(t % (C / V)) * V;
  float m[V], iv[V], k[V], m1[V], m2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = mean[c0 + e], iv[e] = inv[c0 + e], k[e] = coef[c0 + e];
    m1[e] = coef[C + c0 + e], m2[e] = coef[2 * C + c0 + e];
  }
  for (long long u = t; u < units; u += stride) {
    float d[V], xv[V], r[V];
    load_vec<V>(dy + u * V, d);
    load_vec<V>(x + u * V, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) r[e] = dx_of(d[e], xv[e], m[e], iv[e], k[e], m1[e], m2[e]);
    store_vec<V>(dx + u * V, r);
  }
}

// Column c's statistics from its sums (s1, s2) over N rows: mean, var,
// inv, k = inv*scale into stats[c], [C + c], [2C + c], [3C + c], and the
// running statistics' EMA in place from their values rm_c, rv_c (skipped
// where rm and rv are null).
// Every product and sum is rounded on its own (no FMA contraction), in the
// order of the plain version's PyTorch ops.
__device__ __forceinline__ void bn_fwd_finalize(int c, float s1, float s2, int N, int C,
                                                float scale, float* __restrict__ rm,
                                                float* __restrict__ rv, float rm_c,
                                                float rv_c, float* __restrict__ stats,
                                                float one_minus_m, float m,
                                                int unbiased, float unbias,
                                                float eps, bool live = true) {
  // mean = s1/n, var = s2/n - mean^2 (no clamp), inv = rsqrt(var + eps):
  // rsqrtf is what torch.rsqrt runs on the card
  const float n = (float)N;
  const float mean = __fdiv_rn(s1, n);
  const float var = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  const float inv = rsqrtf(__fadd_rn(var, eps));
  stats[c] = mean;
  stats[C + c] = var;
  stats[2 * C + c] = inv;
  stats[3 * C + c] = __fmul_rn(inv, scale);
  if (rm != nullptr && live) {
    // r = (1 - m)*r + m*stat, from the unbiased var*(n/(n-1)) or the
    // biased var
    const float v = unbiased ? __fmul_rn(var, unbias) : var;
    rm[c] = __fadd_rn(__fmul_rn(one_minus_m, rm_c), __fmul_rn(m, mean));
    rv[c] = __fadd_rn(__fmul_rn(one_minus_m, rv_c), __fmul_rn(m, v));
  }
}

// the forward's pass 2: one warp per column sums its G partials as
// finish_kernel does, then finalizes the column (bn_fwd_finalize)
__global__ void __launch_bounds__(WARPS2 * 32)
bn_fwd_finish_kernel(const float* __restrict__ partial,
                     const float* __restrict__ scale, float* __restrict__ rm,
                     float* __restrict__ rv, float* __restrict__ stats, int N,
                     int C, int G, float one_minus_m, float m, int unbiased,
                     float unbias, float eps, const int* __restrict__ active) {
  const int c = blockIdx.x * WARPS2 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= C) return;  // the whole warp leaves together
  // the column's vectors are read first, under the partials' latency
  const float sc = scale[c];
  const float rm_c = rm != nullptr ? rm[c] : 0.f;
  const float rv_c = rv != nullptr ? rv[c] : 0.f;
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
  if (lane == 0)
    bn_fwd_finalize(c, s1, s2, N, C, sc, rm, rv, rm_c, rv_c, stats, one_minus_m,
                    m, unbiased, unbias, eps, active == nullptr || c < *active);
}

// the forward's pass 3: y = (x - mean)*k + bias in float32, each operation
// rounded on its own as the plain version's PyTorch ops, and 0 from column
// *active on where `active` is given; grid as bn_dx_kernel's, so a
// thread's coefficients load once
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_norm_kernel(const T* __restrict__ x, const float* __restrict__ stats,
               const float* __restrict__ bias, T* __restrict__ y,
               long long units, int C, const int* __restrict__ active) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (t >= units) return;
  const int c0 = (int)(t % (C / V)) * V;
  const int width = active == nullptr ? C : *active;
  float m[V], k[V], b[V];
  bool live[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = stats[c0 + e], k[e] = stats[3 * C + c0 + e], b[e] = bias[c0 + e];
    live[e] = c0 + e < width;
  }
  for (long long u = t; u < units; u += stride) {
    float xv[V], r[V];
    load_vec<V>(x + u * V, xv);
#pragma unroll
    for (int e = 0; e < V; ++e)
      r[e] = live[e] ? __fadd_rn(__fmul_rn(__fsub_rn(xv[e], m[e]), k[e]), b[e]) : 0.f;
    store_vec<V>(y + u * V, r);
  }
}

bool aligned(const void* p, size_t bytes) { return ((uintptr_t)p % bytes) == 0; }

// the widest group of columns every row of `p`s can be read in: 16 bytes
// (4 floats, 8 bf16) where C allows it and the rows are aligned, then, for
// bf16, 2 columns (4 bytes), then 1
template <typename T>
int vec_width(int C, const void* p0, const void* p1, const void* p2 = nullptr) {
  auto ok = [&](int v) {
    const size_t bytes = v * sizeof(T);
    return C % v == 0 && aligned(p0, bytes) && aligned(p1, bytes) &&
           (p2 == nullptr || aligned(p2, bytes));
  };
  constexpr int wide = 16 / sizeof(T);
  if (ok(wide)) return wide;
  if (sizeof(T) == 2 && ok(2)) return 2;
  return 1;
}

template <int MODE, typename T, int V>
void launch_partials(const T* a, const T* b, const float* mean,
                     const float* inv, float* partial, int N, int C, int G,
                     cudaStream_t stream) {
  col_partials_kernel<MODE, T, V>
      <<<dim3(G, (C + V * THREADS - 1) / (V * THREADS)), THREADS, 0,
         stream>>>(a, b, mean, inv, partial, N, C);
}

// pass 1 at the widest column group a and b allow
template <int MODE, typename T>
cudaError_t launch_pass1(const T* a, const T* b, const float* mean,
                         const float* inv, float* partial, int N, int C, int G,
                         cudaStream_t stream) {
  constexpr int wide = 16 / sizeof(T);
  const int v = vec_width<T>(C, a, b);
  if (v == wide)
    launch_partials<MODE, T, wide>(a, b, mean, inv, partial, N, C, G, stream);
  else if constexpr (sizeof(T) == 2) {
    if (v == 2)
      launch_partials<MODE, T, 2>(a, b, mean, inv, partial, N, C, G, stream);
    else
      launch_partials<MODE, T, 1>(a, b, mean, inv, partial, N, C, G, stream);
  } else {
    launch_partials<MODE, T, 1>(a, b, mean, inv, partial, N, C, G, stream);
  }
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t launch(const T* a, const T* b, const float* mean,
                   const float* inv, const float* scale, float* partial,
                   float* out, float* coef, int N, int C, int G,
                   cudaStream_t stream, const int* active = nullptr) {
  cudaError_t e = launch_pass1<MODE, T>(a, b, mean, inv, partial, N, C, G, stream);
  if (e != cudaSuccess) return e;
  finish_kernel<MODE><<<(C + WARPS2 - 1) / WARPS2, WARPS2 * 32, 0, stream>>>(
      partial, out, scale, inv, coef, N, C, G, active);
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

// blocks of an elementwise pass over N rows of `width` units: about
// DX_BLOCKS, rounded up to a multiple of width / gcd(width, THREADS) so that
// a grid stride covers whole rows; -1 where that is more than a grid holds
long long elementwise_blocks(long long units, int width) {
  const int q = width / gcd(width, THREADS);
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > DX_BLOCKS) blocks = DX_BLOCKS;
  blocks = (blocks + q - 1) / q * q;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

template <typename T, int V>
cudaError_t launch_dx(const T* dy, const T* x, const float* mean,
                      const float* inv, const float* coef, T* dx, int N,
                      int C, cudaStream_t stream) {
  const long long units = (long long)N * (C / V);
  const long long blocks = elementwise_blocks(units, C / V);
  if (blocks < 0) return cudaErrorInvalidValue;
  bn_dx_kernel<T, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      dy, x, mean, inv, coef, dx, units, C);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_norm(const T* x, const float* stats, const float* bias,
                        T* y, int N, int C, const int* active, cudaStream_t stream) {
  const long long units = (long long)N * (C / V);
  const long long blocks = elementwise_blocks(units, C / V);
  if (blocks < 0) return cudaErrorInvalidValue;
  bn_norm_kernel<T, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      x, stats, bias, y, units, C, active);
  return cudaGetLastError();
}

// dx at the widest column group dy, x and dx allow
template <typename T>
cudaError_t launch_dx_widest(const T* dy, const T* x, const float* mean,
                             const float* inv, const float* coef, T* dx, int N,
                             int C, cudaStream_t s) {
  constexpr int wide = 16 / sizeof(T);
  const int v = vec_width<T>(C, dy, x, dx);
  if (v == wide) return launch_dx<T, wide>(dy, x, mean, inv, coef, dx, N, C, s);
  if constexpr (sizeof(T) == 2) {
    if (v == 2) return launch_dx<T, 2>(dy, x, mean, inv, coef, dx, N, C, s);
  }
  return launch_dx<T, 1>(dy, x, mean, inv, coef, dx, N, C, s);
}

// y at the widest column group x and y allow
template <typename T>
cudaError_t launch_norm_widest(const T* x, const float* stats,
                               const float* bias, T* y, int N, int C,
                               cudaStream_t s, const int* active = nullptr) {
  constexpr int wide = 16 / sizeof(T);
  const int v = vec_width<T>(C, x, y);
  if (v == wide) return launch_norm<T, wide>(x, stats, bias, y, N, C, active, s);
  if constexpr (sizeof(T) == 2) {
    if (v == 2) return launch_norm<T, 2>(x, stats, bias, y, N, C, active, s);
  }
  return launch_norm<T, 1>(x, stats, bias, y, N, C, active, s);
}

// mode 0: col_sums2(a, b); 1: the moments (mean, biased var) of a's
// columns, reading a once (b unused); 2: bn_bwd_sums(dy=a, x=b, mean, inv),
// with `active` (null, or the active width: 0 sums from it on, as the fused
// backward's finish writes them; the backward's pass 1 under a mesh);
// 3: (sum a, sum a*a) reading a once, the forward's pass 1 and its sums in
// bn_fwd_finish_kernel's order (the forward's totals under a mesh). Modes
// other than 2 take no width.
template <typename T>
int col_sums2(const T* a, const T* b, const float* mean, const float* inv,
              float* partial, float* out, int N, int C, int G, int mode,
              const int* active, void* stream) {
  if (bad_shape(N, C, G) || (active != nullptr && mode != BWD))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case SUMS2:
      return (int)launch<SUMS2, T>(a, b, mean, inv, nullptr, partial, out,
                                   nullptr, N, C, G, s);
    case MOMENTS:
      return (int)launch<MOMENTS, T>(a, a, mean, inv, nullptr, partial, out,
                                     nullptr, N, C, G, s);
    case BWD:
      if (mean == nullptr || inv == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch<BWD, T>(a, b, mean, inv, nullptr, partial, out,
                                 nullptr, N, C, G, s, active);
    case FWD:
      return (int)launch<FWD, T>(a, a, mean, inv, nullptr, partial, out,
                                 nullptr, N, C, G, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bn_backward(const T* dy, const T* x, const float* scale,
                const float* mean, const float* inv, float* partial,
                float* coef, float* out, T* dx, int N, int C, int G,
                const int* active, void* stream) {
  if (bad_shape(N, C, G) || !dy || !x || !scale || !mean || !inv || !coef ||
      !dx)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch<BWD, T>(dy, x, mean, inv, scale, partial, out, coef,
                                 N, C, G, s, active);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_dx_widest<T>(dy, x, mean, inv, coef, dx, N, C, s);
}

// the train-mode BN forward: the moments' pass 1, the finish with the
// running statistics, the normalize
template <typename T>
int bn_forward(const T* x, const float* scale, const float* bias, float* rm,
               float* rv, float* stats, float* partial, T* y, int N, int C,
               int G, double momentum, double eps, int unbiased,
               const int* active, void* stream) {
  if (bad_shape(N, C, G) || !x || !scale || !bias || !stats || !partial ||
      !y || (rm == nullptr) != (rv == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_pass1<FWD, T>(x, x, nullptr, nullptr, partial, N, C, G, s);
  if (err != cudaSuccess) return (int)err;
  // the plain version's scalars: Python doubles, rounded to float32 where
  // PyTorch multiplies a float32 tensor by them
  bn_fwd_finish_kernel<<<(C + WARPS2 - 1) / WARPS2, WARPS2 * 32, 0, s>>>(
      partial, scale, rm, rv, stats, N, C, G, (float)(1.0 - momentum),
      (float)momentum, unbiased,
      (float)((double)N / (double)(N > 1 ? N - 1 : 1)), (float)eps, active);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_norm_widest<T>(x, stats, bias, y, N, C, s, active);
}

// Under a mesh the moments' and the backward's sums are taken over every
// rank's rows: pass 1 and the sums of its partials run per rank (mode 3,
// mode 2 of col_sums2), the caller all-reduces the (2, C) totals, and the
// apply part below starts from them and the global row count Ng, while the
// normalize or dx pass runs over this rank's n rows. Its per-column
// arithmetic is bn_fwd_finish_kernel's and finish_kernel<BWD>'s, on the
// same sums, so at one rank the two calls give the fused call's bits,
// with the active width too (`active` as the fused calls take it; mode 2
// zeroes the backward's sums from it on before the all-reduce).

// the forward's finish from the totals: one thread a column
__global__ void __launch_bounds__(THREADS)
bn_fwd_from_sums_kernel(const float* __restrict__ sums,
                        const float* __restrict__ scale, float* __restrict__ rm,
                        float* __restrict__ rv, float* __restrict__ stats, int Ng,
                        int C, float one_minus_m, float m, int unbiased,
                        float unbias, float eps, const int* __restrict__ active) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  bn_fwd_finalize(c, sums[c], sums[C + c], Ng, C, scale[c], rm, rv,
                  rm != nullptr ? rm[c] : 0.f, rv != nullptr ? rv[c] : 0.f,
                  stats, one_minus_m, m, unbiased, unbias, eps,
                  active == nullptr || c < *active);
}

// the backward's dx coefficients from the totals, as finish_kernel<BWD>
// writes them: one thread a column, zero past the active width
__global__ void __launch_bounds__(THREADS)
bn_bwd_coef_kernel(const float* __restrict__ sums, const float* __restrict__ scale,
                   const float* __restrict__ inv, float* __restrict__ coef, int Ng,
                   int C, const int* __restrict__ active) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const float n = (float)Ng;
  const bool live = active == nullptr || c < *active;
  coef[c] = live ? inv[c] * scale[c] : 0.f;
  coef[C + c] = (live ? sums[c] : 0.f) / n;
  coef[2 * C + c] = (live ? sums[C + c] : 0.f) / n;
}

template <typename T>
int bn_forward_from_sums(const T* x, const float* sums, const float* scale,
                         const float* bias, float* rm, float* rv, float* stats,
                         T* y, int n, int C, int Ng, double momentum,
                         double eps, int unbiased, const int* active,
                         void* stream) {
  if (n <= 0 || C <= 0 || Ng < n || !x || !sums || !scale || !bias ||
      !stats || !y || (rm == nullptr) != (rv == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  bn_fwd_from_sums_kernel<<<(C + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      sums, scale, rm, rv, stats, Ng, C, (float)(1.0 - momentum), (float)momentum,
      unbiased, (float)((double)Ng / (double)(Ng > 1 ? Ng - 1 : 1)), (float)eps,
      active);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_norm_widest<T>(x, stats, bias, y, n, C, s, active);
}

template <typename T>
int bn_backward_from_sums(const T* dy, const T* x, const float* sums,
                          const float* scale, const float* mean,
                          const float* inv, float* coef, T* dx, int n, int C,
                          int Ng, const int* active, void* stream) {
  if (n <= 0 || C <= 0 || Ng < n || !dy || !x || !sums || !scale || !mean ||
      !inv || !coef || !dx)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  bn_bwd_coef_kernel<<<(C + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      sums, scale, inv, coef, Ng, C, active);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dx_widest<T>(dy, x, mean, inv, coef, dx, n, C, s);
}

}  // namespace

// `partial` holds 2*C*G floats, `out` 2*C: out[c] is the first result of
// column c, out[C + c] the second. Pass 1 runs G blocks along the rows,
// each over ceil(N / G) rows. mode and `active` (mode 2 only, else null):
// see col_sums2 above.
extern "C" int ofa_col_sums2_f32(const float* a, const float* b,
                                 const float* mean, const float* inv,
                                 float* partial, float* out, int N, int C,
                                 int G, int mode, const int* active,
                                 void* stream) {
  return col_sums2<float>(a, b, mean, inv, partial, out, N, C, G, mode,
                          active, stream);
}

extern "C" int ofa_col_sums2_bf16(const __nv_bfloat16* a,
                                  const __nv_bfloat16* b, const float* mean,
                                  const float* inv, float* partial,
                                  float* out, int N, int C, int G, int mode,
                                  const int* active, void* stream) {
  return col_sums2<__nv_bfloat16>(a, b, mean, inv, partial, out, N, C, G,
                                  mode, active, stream);
}

// The train-mode BN backward: out = (s1 = dbias, s2 = dscale) as in mode 2,
// and dx (N, C) in the operands' type. `partial` holds 2*C*G floats, `coef`
// 3*C. `active`: null, or the device address of the active width (columns
// from it on: out and dx 0).
extern "C" int ofa_bn_backward_f32(const float* dy, const float* x,
                                   const float* scale, const float* mean,
                                   const float* inv, float* partial,
                                   float* coef, float* out, float* dx, int N,
                                   int C, int G, const int* active, void* stream) {
  return bn_backward<float>(dy, x, scale, mean, inv, partial, coef, out, dx,
                            N, C, G, active, stream);
}

extern "C" int ofa_bn_backward_bf16(const __nv_bfloat16* dy,
                                    const __nv_bfloat16* x,
                                    const float* scale, const float* mean,
                                    const float* inv, float* partial,
                                    float* coef, float* out,
                                    __nv_bfloat16* dx, int N, int C, int G,
                                    const int* active, void* stream) {
  return bn_backward<__nv_bfloat16>(dy, x, scale, mean, inv, partial, coef,
                                    out, dx, N, C, G, active, stream);
}

// The train-mode BN forward: y (N, C) in x's type; stats = [mean | biased
// var | inv = rsqrt(var + eps) | inv*scale], 4*C floats; running_mean and
// running_var (C floats each, both or neither) take the momentum EMA in
// place, from the unbiased var (unbiased != 0) or the biased one. `partial`
// holds 2*C*G floats. `active`: null, or the device address of the active
// width (columns from it on: running statistics kept, y 0).
extern "C" int ofa_bn_forward_f32(const float* x, const float* scale,
                                  const float* bias, float* running_mean,
                                  float* running_var, float* stats,
                                  float* partial, float* y, int N, int C,
                                  int G, double momentum, double eps,
                                  int unbiased, const int* active, void* stream) {
  return bn_forward<float>(x, scale, bias, running_mean, running_var, stats,
                           partial, y, N, C, G, momentum, eps, unbiased,
                           active, stream);
}

extern "C" int ofa_bn_forward_bf16(const __nv_bfloat16* x, const float* scale,
                                   const float* bias, float* running_mean,
                                   float* running_var, float* stats,
                                   float* partial, __nv_bfloat16* y, int N,
                                   int C, int G, double momentum, double eps,
                                   int unbiased, const int* active, void* stream) {
  return bn_forward<__nv_bfloat16>(x, scale, bias, running_mean, running_var,
                                   stats, partial, y, N, C, G, momentum, eps,
                                   unbiased, active, stream);
}

// The apply part of the forward under a mesh: from sums = [sum x | sum x*x]
// (2*C floats) over all Ng rows of every rank, stats (as ofa_bn_forward_*)
// and the running statistics' update (the unbiased factor Ng/(Ng-1)), then
// y over this rank's n rows of x. `active`: null, or the device address of
// the active width (columns from it on: running statistics kept, y 0).
extern "C" int ofa_bn_forward_from_sums_f32(const float* x, const float* sums,
                                            const float* scale, const float* bias,
                                            float* running_mean, float* running_var,
                                            float* stats, float* y, int n, int C,
                                            int Ng, double momentum, double eps,
                                            int unbiased, const int* active,
                                            void* stream) {
  return bn_forward_from_sums<float>(x, sums, scale, bias, running_mean,
                                     running_var, stats, y, n, C, Ng, momentum,
                                     eps, unbiased, active, stream);
}

extern "C" int ofa_bn_forward_from_sums_bf16(const __nv_bfloat16* x, const float* sums,
                                             const float* scale, const float* bias,
                                             float* running_mean, float* running_var,
                                             float* stats, __nv_bfloat16* y, int n,
                                             int C, int Ng, double momentum,
                                             double eps, int unbiased,
                                             const int* active, void* stream) {
  return bn_forward_from_sums<__nv_bfloat16>(x, sums, scale, bias, running_mean,
                                             running_var, stats, y, n, C, Ng,
                                             momentum, eps, unbiased, active,
                                             stream);
}

// The apply part of the backward under a mesh: from sums = [sum dy | sum
// dy*xhat] over all Ng rows, the dx coefficients into coef (3*C floats),
// then dx over this rank's n rows. `active`: null, or the device address of
// the active width (columns from it on: coefficients and dx 0).
extern "C" int ofa_bn_backward_from_sums_f32(const float* dy, const float* x,
                                             const float* sums, const float* scale,
                                             const float* mean, const float* inv,
                                             float* coef, float* dx, int n, int C,
                                             int Ng, const int* active,
                                             void* stream) {
  return bn_backward_from_sums<float>(dy, x, sums, scale, mean, inv, coef, dx,
                                      n, C, Ng, active, stream);
}

extern "C" int ofa_bn_backward_from_sums_bf16(const __nv_bfloat16* dy,
                                              const __nv_bfloat16* x,
                                              const float* sums, const float* scale,
                                              const float* mean, const float* inv,
                                              float* coef, __nv_bfloat16* dx, int n,
                                              int C, int Ng, const int* active,
                                              void* stream) {
  return bn_backward_from_sums<__nv_bfloat16>(dy, x, sums, scale, mean, inv,
                                              coef, dx, n, C, Ng, active, stream);
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
