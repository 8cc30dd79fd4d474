// The masked MBConv's two 1x1 convolutions bounded by the sampled middle
// width, read on the device: a GEMM over NHWC rows (R = N*H*W) on the
// tensor cores, float32 (3xTF32) and bf16, for sm_90a.
//
// Replaces no Pallas kernel. It stands for the XLA 1x1 convs of the JAX
// package's expand-switch branch (ofa_sr_tpu/models/layers.py
// `_sliced_mbconv_branch`, :126 and :156), which compiles one branch per
// middle width. Here the width m is a device int32 read by every block, so
// one launch (and one captured CUDA graph) serves every width, and the
// work past m is skipped:
//
//   direction        product                              bound        past it
//   expand forward   Y[R,M]    = X[R,Cin] . We[M,Cin]^T   columns < m  Y written 0
//   project forward  Z[R,Cout] = H[R,:m]  . Wp[Cout,:m]^T K < m        not read
//   expand dgrad     dX[R,Cin] = dY[R,:m] . We[:m,Cin]    K < m        not read
//   project dgrad    dH[R,M]   = dZ[R,Cout] . Wp[Cout,M]  columns < m  dH written 0
//   expand wgrad     dWe[M,Cin]  = dY^T . X               rows < m     dWe written 0
//   project wgrad    dWp[Cout,M] = (H^T . dZ)^T           columns < m  dWp written 0
//
// The forward and dgrad products are one kernel form, C[R,N] = A[R,K] .
// op(B) with B stored [N,K] (the forwards) or [K,N] (the dgrads) and the
// bound on N or on K; the wgrads another, C[P,Q] = A[R,P]^T . B[R,Q] with
// the bound on P (the project's product is taken transposed, so that both
// bound P, and its second pass writes it back as [Cout,M]).
//
// What bounds it on the H100: bytes. The float32 expand forward at m = 384,
// R = 36,864 (the S4's bs16 48x48 step) moves (64 + 384) * 4 bytes a row,
// 66 MB, which takes 19.7 us at 3.35 TB/s; its 1.81 GFLOP take 11 us as
// 3xTF32 products at 495 TFLOP/s (5.4 G products). bf16 halves the bytes.
// What the design does about it: each operand is read once from device
// memory by a block (the narrow Cin-wide operands, 64 channels, are re-read
// by the few N tiles of a row block from L2: x is the fastest grid index),
// each output written once, with 16-byte cp.async copies double-buffered
// behind the MMAs; and the bound cuts the bytes with the work: an N-bounded
// block past m writes its zeros and reads nothing, a K-bounded one stops
// its K loop at ceil(m / BK) chunks. mma.sync's rate (far below wgmma's)
// is what the 3xTF32 forms lean on: three MMAs a multiply-add.
//
// Numerics:
// - float32 runs 3xTF32 as csrc/mbconv.cu does: each operand is split as
//   big = tf32(v), small = tf32(v - big) (two integer operations a value),
//   and each k8 step's three products (small*big, big*small, big*big) go
//   into a zeroed register tile that is then added into the float32 sum
//   with a rounded add (an MMA truncates when it accumulates);
// - bf16 runs mma.sync m16n8k16 with float32 accumulation, and each output
//   is rounded to bf16 once;
// - the wgrads sum over R in two passes with no atomics: pass 1 gives each
//   block a fixed run of rows (a multiple of BK; the partition comes from
//   the shapes alone) and writes its float32 partial, pass 2 adds the
//   partials in order. Two calls give the same bits.
//
// Design: a block of 4 warps owns a 64 x 64 output tile (warps 2 x 2, a
// warp 32 x 32: two m16 tiles by four n8 tiles) and walks K in chunks of 32
// through two shared-memory stages. Small blocks, 3-5 resident an SM (by
// registers), keep more copies in flight: with K 64 (the expand's) a block
// has only two chunks to overlap, and a 128-row tile (two blocks an SM)
// was slower in float32 and no faster in bf16 on the card. A tile is stored as its global rows
// are: [rows][BK] when K is the contiguous index, [BK][cols] when it is not
// (the dgrads' B, the wgrads' A and B), so every copy is a straight 16-byte
// cp.async of a row segment, zero-filled past the tensor; the fragment
// loads index either layout, with row strides padded so that a warp's loads
// hit 32 distinct banks. Every dimension but R is a multiple of 8 and every
// pointer 16-byte aligned (the wrapper checks both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // tile rows (R, or the wgrads' P)
constexpr int BN = 64;              // tile columns
constexpr int BK = 32;              // K chunk
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int NM = 2;               // m16 tiles a warp (32 rows)
constexpr int NN = 4;               // n8 tiles a warp (32 columns)
static_assert(WARPS == (BM / (16 * NM)) * (BN / (8 * NN)), "warps cover the tile");

// A shared tile of ROWS rows (M or N) by BK, in the layout of its source:
// KMAJ false: [ROWS][LD], K contiguous; KMAJ true: [BK][LD], K the row.
template <typename T, bool KMAJ, int ROWS>
struct Tile {
  static constexpr int EPC = 16 / (int)sizeof(T);               // elements a 16-byte copy
  static constexpr int LD = KMAJ ? ROWS + 8 : BK + 16 / (int)sizeof(T);
  static constexpr int ELEMS = KMAJ ? BK * LD : ROWS * LD;
  static constexpr int BYTES = ELEMS * (int)sizeof(T);
  static_assert((LD * (int)sizeof(T)) % 16 == 0, "rows stay 16-byte aligned");
  static __device__ __forceinline__ int at(int row, int k) {
    return KMAJ ? k * LD + row : row * LD + k;
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool A_KMAJ, bool B_KMAJ>
struct Stages {
  using TA = Tile<T, A_KMAJ, BM>;
  using TB = Tile<T, B_KMAJ, BN>;
  static constexpr int STAGE = TA::BYTES + TB::BYTES;
  static constexpr int BYTES = 2 * STAGE;
  static_assert(TA::BYTES % 16 == 0 && TB::BYTES % 16 == 0, "stage offsets aligned");
};

// 16 bytes, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy one chunk of a global operand into a shared tile.
// KMAJ false: rows [r0, r0 + ROWS) of G (row length ld, rows < r_end) at
//   columns [k0, k0 + BK) (< k_end);
// KMAJ true: G's rows [k0, k0 + BK) (< k_end) at columns [r0, r0 + ROWS)
//   (< r_end).
// Out-of-range pieces are zero-filled; r_end and k_end are multiples of
// the copy's EPC elements where they are a column bound.
template <typename T, bool KMAJ, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ G, long long ld, int r0,
                                          int r_end, int k0, int k_end, int tid) {
  using TT = Tile<T, KMAJ, ROWS>;
  constexpr int EPC = TT::EPC;
  if (!KMAJ) {
    constexpr int CPR = BK / EPC;  // copies a row
    for (int i = tid; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      const bool ok = (r0 + r < r_end) && (k0 + c < k_end);
      const T* src = ok ? G + (long long)(r0 + r) * ld + k0 + c : G;
      cp_async16(s + r * TT::LD + c, src, ok);
    }
  } else {
    constexpr int CPR = ROWS / EPC;
    for (int i = tid; i < BK * CPR; i += THREADS) {
      const int k = i / CPR, c = (i % CPR) * EPC;
      const bool ok = (k0 + k < k_end) && (r0 + c < r_end);
      const T* src = ok ? G + (long long)(k0 + k) * ld + r0 + c : G;
      cp_async16(s + k * TT::LD + c, src, ok);
    }
  }
}

// Zero the entries of a staged chunk at K index >= kz (chunk-relative):
// the K bound inside the last chunk, where a 16-byte copy straddled it.
template <typename T, bool KMAJ, int ROWS>
__device__ __forceinline__ void zero_k_from(T* s, int kz, int tid) {
  using TT = Tile<T, KMAJ, ROWS>;
  const T zero = from_float<T>(0.f);
  for (int i = tid; i < ROWS * BK; i += THREADS) {
    const int r = i / BK, k = i % BK;
    if (k >= kz) s[TT::at(r, k)] = zero;
  }
}

// -- float32: 3xTF32 ---------------------------------------------------------

// v = big + small (+ ~2^-22 v), each rounded to TF32 (csrc/mbconv.cu's split)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one chunk's products for a warp: its NM x NN tiles at (wr, wc) of the
// block tile, BK / 8 k8 steps
template <bool A_KMAJ, bool B_KMAJ>
__device__ __forceinline__ void chunk_mma(const float* sa, const float* sb, int wr, int wc,
                                          int g, int t, float (&acc)[NM][NN][4]) {
  using TA = Tile<float, A_KMAJ, BM>;
  using TB = Tile<float, B_KMAJ, BN>;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ab[NM][4], as[NM][4], bb[NN][2], bs[NN][2];
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      const int r = wr + i * 16 + g;
      split_tf32(sa[TA::at(r, kk + t)], ab[i][0], as[i][0]);              // (g, t)
      split_tf32(sa[TA::at(r + 8, kk + t)], ab[i][1], as[i][1]);          // (g + 8, t)
      split_tf32(sa[TA::at(r, kk + t + 4)], ab[i][2], as[i][2]);          // (g, t + 4)
      split_tf32(sa[TA::at(r + 8, kk + t + 4)], ab[i][3], as[i][3]);      // (g + 8, t + 4)
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int c = wc + n * 8 + g;
      split_tf32(sb[TB::at(c, kk + t)], bb[n][0], bs[n][0]);              // (k t, n g)
      split_tf32(sb[TB::at(c, kk + t + 4)], bb[n][1], bs[n][1]);          // (k t + 4, n g)
    }
    float part[NM][NN][4];
#pragma unroll
    for (int i = 0; i < NM; ++i)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][n][q] = 0.f;
#pragma unroll
    for (int i = 0; i < NM; ++i)
#pragma unroll
      for (int n = 0; n < NN; ++n) mma_tf32(part[i][n], as[i], bb[n]);
#pragma unroll
    for (int i = 0; i < NM; ++i)
#pragma unroll
      for (int n = 0; n < NN; ++n) mma_tf32(part[i][n], ab[i], bs[n]);
#pragma unroll
    for (int i = 0; i < NM; ++i)
#pragma unroll
      for (int n = 0; n < NN; ++n) mma_tf32(part[i][n], ab[i], bb[n]);
#pragma unroll
    for (int i = 0; i < NM; ++i)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][n][q] += part[i][n][q];
  }
}

// -- bf16: m16n8k16, float32 accumulation --------------------------------------

// the 32-bit word of two bf16 at K indices k, k + 1 (k even) of row `row`
template <bool KMAJ, int ROWS>
__device__ __forceinline__ uint32_t pair_k(const __nv_bfloat16* s, int row, int k) {
  using TT = Tile<__nv_bfloat16, KMAJ, ROWS>;
  if (!KMAJ) return *reinterpret_cast<const uint32_t*>(s + TT::at(row, k));
  const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
  return (uint32_t)u[TT::at(row, k)] | ((uint32_t)u[TT::at(row, k + 1)] << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool A_KMAJ, bool B_KMAJ>
__device__ __forceinline__ void chunk_mma(const __nv_bfloat16* sa, const __nv_bfloat16* sb,
                                          int wr, int wc, int g, int t,
                                          float (&acc)[NM][NN][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[NM][4], b[NN][2];
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      const int r = wr + i * 16 + g;
      a[i][0] = pair_k<A_KMAJ, BM>(sa, r, kk + 2 * t);          // (g, 2t..2t+1)
      a[i][1] = pair_k<A_KMAJ, BM>(sa, r + 8, kk + 2 * t);      // (g + 8, 2t..)
      a[i][2] = pair_k<A_KMAJ, BM>(sa, r, kk + 2 * t + 8);      // (g, 2t + 8..)
      a[i][3] = pair_k<A_KMAJ, BM>(sa, r + 8, kk + 2 * t + 8);  // (g + 8, 2t + 8..)
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int c = wc + n * 8 + g;
      b[n][0] = pair_k<B_KMAJ, BN>(sb, c, kk + 2 * t);          // (k 2t.., n g)
      b[n][1] = pair_k<B_KMAJ, BN>(sb, c, kk + 2 * t + 8);      // (k 2t + 8.., n g)
    }
#pragma unroll
    for (int i = 0; i < NM; ++i)
#pragma unroll
      for (int n = 0; n < NN; ++n) mma_bf16(acc[i][n], a[i], b[n]);
  }
}

// -- the main loop -------------------------------------------------------------

// acc += A[r0:+BM, k_beg:k_end] . op(B)[k_beg:k_end, c0:+BN] through two
// shared stages. A is [R][lda] (A_KMAJ false) or [K][lda] (true); B is
// [N][ldb] (B_KMAJ false) or [K][ldb] (true). r_end / c_end bound the
// tile's rows and columns; from k_end on (a bound that may fall inside a
// chunk) the values count as 0.
template <typename T, bool A_KMAJ, bool B_KMAJ>
__device__ __forceinline__ void main_loop(unsigned char* smem, const T* __restrict__ A,
                                          long long lda, const T* __restrict__ B, long long ldb,
                                          int r0, int r_end, int c0, int c_end, int k_beg,
                                          int k_end, float (&acc)[NM][NN][4]) {
  using S = Stages<T, A_KMAJ, B_KMAJ>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % (BM / (16 * NM))) * 16 * NM, wc = (warp / (BM / (16 * NM))) * 8 * NN;
  auto sa = [&](int s) { return reinterpret_cast<T*>(smem + s * S::STAGE); };
  auto sb = [&](int s) { return reinterpret_cast<T*>(smem + s * S::STAGE + S::TA::BYTES); };
  const int n_chunks = k_end > k_beg ? (k_end - k_beg + BK - 1) / BK : 0;
  if (n_chunks == 0) return;
  load_tile<T, A_KMAJ, BM>(sa(0), A, lda, r0, r_end, k_beg, k_end, tid);
  load_tile<T, B_KMAJ, BN>(sb(0), B, ldb, c0, c_end, k_beg, k_end, tid);
  cp_async_commit();
  for (int j = 0; j < n_chunks; ++j) {
    const int k0 = k_beg + j * BK;
    if (j + 1 < n_chunks) {
      const int s = (j + 1) & 1;
      load_tile<T, A_KMAJ, BM>(sa(s), A, lda, r0, r_end, k0 + BK, k_end, tid);
      load_tile<T, B_KMAJ, BN>(sb(s), B, ldb, c0, c_end, k0 + BK, k_end, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk j landed (for this thread)
    __syncthreads();     // ... for all
    if (k0 + BK > k_end) {  // the last chunk ends inside: zero K >= k_end
      zero_k_from<T, A_KMAJ, BM>(sa(j & 1), k_end - k0, tid);
      zero_k_from<T, B_KMAJ, BN>(sb(j & 1), k_end - k0, tid);
      __syncthreads();
    }
    chunk_mma<A_KMAJ, B_KMAJ>(sa(j & 1), sb(j & 1), wr, wc, g, t, acc);
    __syncthreads();     // the stage is free for chunk j + 2
  }
}

__device__ __forceinline__ int clamp_bound(const int* bound, int dim) {
  return min(max(__ldg(bound), 0), dim);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);

template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// -- forward and dgrad: C[R,N] = A[R,K] . op(B), bound on N or on K -----------

template <typename T, bool B_KN, bool BOUND_K>
__device__ __forceinline__ void gemm_block(unsigned char* smem, const T* __restrict__ A,
                                           const T* __restrict__ B,
                                           const int* __restrict__ bound, T* __restrict__ C,
                                           int R, int K, int N) {
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int m = clamp_bound(bound, BOUND_K ? K : N);
  const int tid = threadIdx.x;
  if (!BOUND_K && c0 >= m) {  // wholly past the bound: zeros, nothing read
    constexpr int EPC = 16 / (int)sizeof(T);
    const int cols = min(BN, N - c0);
    for (int i = tid; i < BM * (BN / EPC); i += THREADS) {
      const int r = i / (BN / EPC), c = (i % (BN / EPC)) * EPC;
      if (r0 + r < R && c < cols)
        *reinterpret_cast<uint4*>(C + (long long)(r0 + r) * N + c0 + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  float acc[NM][NN][4];
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
  // B is [N][K] (the forwards: row length K) or [K][N] (the dgrads: N)
  main_loop<T, false, B_KN>(smem, A, K, B, B_KN ? N : K, r0, R, c0, N, 0, BOUND_K ? m : K, acc);

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = (warp % (BM / (16 * NM))) * 16 * NM, wc = (warp / (BM / (16 * NM))) * 8 * NN;
  const int live = BOUND_K ? N : m;  // columns below it are stored, the rest 0
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wr + i * 16 + g + 8 * half;
      if (r >= R) continue;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int c = c0 + wc + n * 8 + 2 * t;
        if (c >= N) continue;
        const float* a = acc[i][n] + 2 * half;
        store2<T>(C + (long long)r * N + c, c < live ? a[0] : 0.f, c + 1 < live ? a[1] : 0.f);
      }
    }
}

// the forwards (B [N,K]) and the dgrads (B [K,N]), by name apart in a profile
template <typename T, bool BOUND_K>
__global__ void __launch_bounds__(THREADS) pw_fwd_kernel(const T* __restrict__ A,
                                                         const T* __restrict__ B,
                                                         const int* __restrict__ bound,
                                                         T* __restrict__ C, int R, int K,
                                                         int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemm_block<T, false, BOUND_K>(smem, A, B, bound, C, R, K, N);
}

template <typename T, bool BOUND_K>
__global__ void __launch_bounds__(THREADS) pw_dgrad_kernel(const T* __restrict__ A,
                                                           const T* __restrict__ B,
                                                           const int* __restrict__ bound,
                                                           T* __restrict__ C, int R, int K,
                                                           int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemm_block<T, true, BOUND_K>(smem, A, B, bound, C, R, K, N);
}

// -- wgrad: C[P,Q] = A[R,P]^T . B[R,Q], bound on P, two passes -----------------

// pass 1: block (P tile, Q tile, run z) sums rows [z * rows_per, ...) into
// its float32 partial part[z][P][Q]; blocks wholly past the bound do nothing
template <typename T>
__global__ void __launch_bounds__(THREADS) pw_wgrad_partial_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const int* __restrict__ bound,
    float* __restrict__ part, int R, int P, int Q, int rows_per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN, z = blockIdx.z;
  if (r0 >= clamp_bound(bound, P)) return;
  float acc[NM][NN][4];
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
  const int k_beg = z * rows_per, k_end = min(R, k_beg + rows_per);
  main_loop<T, true, true>(smem, A, P, B, Q, r0, P, c0, Q, k_beg, k_end, acc);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = (warp % (BM / (16 * NM))) * 16 * NM, wc = (warp / (BM / (16 * NM))) * 8 * NN;
  float* out = part + (long long)z * P * Q;
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wr + i * 16 + g + 8 * half;
      if (r >= P) continue;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int c = c0 + wc + n * 8 + 2 * t;
        if (c >= Q) continue;
        store2<float>(out + (long long)r * Q + c, acc[i][n][2 * half], acc[i][n][2 * half + 1]);
      }
    }
}

// pass 2: out[p][q] (or out[q][p], `transpose`) = the G partials added in
// order for p below the bound, else 0
template <typename T>
__global__ void __launch_bounds__(256) pw_wgrad_finish_kernel(const float* __restrict__ part,
                                                              const int* __restrict__ bound,
                                                              T* __restrict__ out, int P, int Q,
                                                              int G, int transpose) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)P * Q) return;
  const int p = (int)(i / Q), q = (int)(i % Q);
  float v = 0.f;
  if (p < clamp_bound(bound, P))
    for (int z = 0; z < G; ++z) v += part[(long long)z * P * Q + i];
  out[transpose ? (long long)q * P + p : i] = from_float<T>(v);
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, bool B_KN, bool BOUND_K>
int launch_gemm(const T* A, const T* B, const int* bound, T* C, int R, int K, int N,
                cudaStream_t stream) {
  const int bytes = Stages<T, false, B_KN>::BYTES;
  void (*kernel)(const T*, const T*, const int*, T*, int, int, int) =
      B_KN ? &pw_dgrad_kernel<T, BOUND_K> : &pw_fwd_kernel<T, BOUND_K>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(A, B, bound, C, R, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int pw_gemm(const T* A, const T* B, const int* bound, T* C, int R, int K, int N, int b_kn,
            int bound_k, void* stream) {
  if (R < 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || (R + BM - 1) / BM > 65535 ||
      !aligned16(A) || !aligned16(B) || !aligned16(C))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (!b_kn && !bound_k) return launch_gemm<T, false, false>(A, B, bound, C, R, K, N, s);
  if (!b_kn && bound_k) return launch_gemm<T, false, true>(A, B, bound, C, R, K, N, s);
  if (b_kn && bound_k) return launch_gemm<T, true, true>(A, B, bound, C, R, K, N, s);
  return launch_gemm<T, true, false>(A, B, bound, C, R, K, N, s);
}

template <typename T>
int pw_wgrad(const T* A, const T* B, const int* bound, float* part, T* out, int R, int P,
             int Q, int transpose, int rows_per, int G, void* stream) {
  if (R <= 0 || P <= 0 || Q <= 0 || P % 8 || Q % 8 || rows_per <= 0 || rows_per % BK ||
      G <= 0 || G > 65535 || (long long)(G - 1) * rows_per >= R ||
      (long long)G * rows_per < R || (P + BM - 1) / BM > 65535 || !aligned16(A) ||
      !aligned16(B) || !aligned16(part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bytes = Stages<T, true, true>::BYTES;
  cudaError_t e = allow_smem(pw_wgrad_partial_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + BN - 1) / BN, (P + BM - 1) / BM, G);
  pw_wgrad_partial_kernel<T><<<grid, THREADS, bytes, s>>>(A, B, bound, part, R, P, Q, rows_per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)P * Q;
  pw_wgrad_finish_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, bound, out, P, Q,
                                                                        G, transpose);
  return (int)cudaGetLastError();
}

}  // namespace

// forward / dgrad: C [R,N] = A [R,K] . op(B); B [N,K] (b_kn 0: the
// forwards) or [K,N] (b_kn 1: the dgrads); the bound m (one device int32,
// clamped to [0, N] or [0, K]) on N (bound_k 0: C written 0 from column m
// on) or on K (bound_k 1: A's and B's K entries from m on not read)
extern "C" int ofa_pw_masked_gemm_f32(const float* a, const float* b, const int* bound,
                                      float* c, int R, int K, int N, int b_kn, int bound_k,
                                      void* stream) {
  return pw_gemm<float>(a, b, bound, c, R, K, N, b_kn, bound_k, stream);
}

extern "C" int ofa_pw_masked_gemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                       const int* bound, __nv_bfloat16* c, int R, int K, int N,
                                       int b_kn, int bound_k, void* stream) {
  return pw_gemm<__nv_bfloat16>(a, b, bound, c, R, K, N, b_kn, bound_k, stream);
}

// wgrad: out = A [R,P]^T . B [R,Q] as [P,Q] (transpose 0) or [Q,P] (1),
// rows of P from the bound m on written 0; part: G*P*Q floats of scratch,
// run z of pass 1 summing rows [z*rows_per, min(R, (z+1)*rows_per))
extern "C" int ofa_pw_masked_wgrad_f32(const float* a, const float* b, const int* bound,
                                       float* part, float* out, int R, int P, int Q,
                                       int transpose, int rows_per, int G, void* stream) {
  return pw_wgrad<float>(a, b, bound, part, out, R, P, Q, transpose, rows_per, G, stream);
}

extern "C" int ofa_pw_masked_wgrad_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                        const int* bound, float* part, __nv_bfloat16* out,
                                        int R, int P, int Q, int transpose, int rows_per, int G,
                                        void* stream) {
  return pw_wgrad<__nv_bfloat16>(a, b, bound, part, out, R, P, Q, transpose, rows_per, G,
                                 stream);
}

// the dynamic shared memory a block takes (bytes): form 0 the forwards, 1
// the dgrads, 2 the wgrads' pass 1
extern "C" int ofa_pw_masked_smem_bytes(int form, int bf16) {
  if (form == 0) return bf16 ? Stages<__nv_bfloat16, false, false>::BYTES
                             : Stages<float, false, false>::BYTES;
  if (form == 1) return bf16 ? Stages<__nv_bfloat16, false, true>::BYTES
                             : Stages<float, false, true>::BYTES;
  if (form == 2) return bf16 ? Stages<__nv_bfloat16, true, true>::BYTES
                             : Stages<float, true, true>::BYTES;
  return -1;
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
