// The masked MBConv's two 1x1 convolutions bounded by the sampled middle
// width, read on the device: a GEMM family over NHWC rows (R = N*H*W) for
// sm_90a, float32 (3xTF32) and bf16.
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
// B^T with the 1x1 bank B as [N,K] (the forwards' We or Wp as stored; the
// dgrads' transposed) and the bound on N or on K; the wgrads another,
// C[P,Q] = A[R,P]^T . B[R,Q] with the bound on P (the project's product is
// taken transposed, so that both bound P, and written back as [Cout,M]).
//
// What bounds it on the H100: bytes. The S4 step's shapes (R 36,864 or
// 9,216, Cin = Cout = 64, M 384) do at most ~55 bf16 multiply-adds a byte
// moved, against the ~295 a byte at which the tensor cores would be the
// limit; the float32 forms' 3xTF32 products (three TF32 MMAs a
// multiply-add) come to about half the bytes' time at 495 TFLOP/s. So the
// design keeps the bytes few and in flight:
//   - Persistent blocks. The forward / dgrad grid is sized from R alone (a
//     block a 64-row tile, at most GEMM_BLOCKS; never from the card): a
//     block of one producer warp and Cfg::WGS consumer warpgroups walks the
//     tiles blockIdx.x, blockIdx.x + gridDim.x, ..., its j-th going to
//     warpgroup j % WGS, so one tile's epilogue (its stores and the zeros
//     past the width) runs while the other warpgroups compute and the
//     producer keeps loading.
//   - The bank held in shared memory. Each block stages the 1x1 weight
//     matrix once, as [N, K] in the 128-byte swizzled layout the tensor
//     cores read: only its first m rows (N bound) or columns (K bound), the
//     rest of the chunk holding m zeroed, the chunks past it not staged.
//     The dgrads' bank is stored [K, N] and staged transposed (8 x 8 or 4 x
//     4 blocks turned in registers, 16-byte loads and stores).
//   - Activations streamed by TMA. The producer warp keeps a ring of
//     64-row x 128-byte boxes a warpgroup in flight (one mbarrier a stage
//     for its bytes, one for its release; a ring a warpgroup, so that no
//     waiter runs a phase ahead of a barrier it would share), from tensor
//     maps built on the host (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint, passed as __grid_constant__), zero-filled
//     past the tensor. A K-bounded loop stops at the chunk holding m and
//     zeroes that chunk past m in shared memory; an N-bounded one computes
//     the 64-column chunks below m, writes zeros past m and reads nothing
//     there. A K-bounded tile (one N chunk) streams its K chunks, each box
//     released when its products are done; an N-bounded one holds its K
//     chunks across its N chunks, so A is read from device memory once.
//   - bf16 on wgmma: m64n64k16 wgmma.mma_async, both operands in shared
//     memory (128-byte swizzle descriptors), float32 sums in registers, each
//     output rounded to bf16 once, staged in shared memory and written by a
//     TMA store (whole 128-byte lines; the zeros past m from a zero panel).
//   - float32 keeps 3xTF32, each operand split as big = tf32(v), small =
//     tf32(v - big) (csrc/mbconv.cu's split), the three products
//     small*big, big*small, big*big of a K chunk summed in a tile started
//     at 0 that is added into the float32 sum with a rounded add (an MMA
//     truncates when it accumulates). wgmma's tf32 form takes only K-major
//     operands and needs both halves of an operand it reads from shared
//     memory, and the bank held split (big and small) is 192 KB at M 384,
//     which leaves room for two 8 KB boxes a warpgroup. The N-bounded forms
//     (wide outputs, K 64) use it: m64n64k8 wgmma with A's halves in
//     registers (ldmatrix from the box, split there) and the split bank's.
//     The K-bounded forms (K 384 streamed, N 64) need a deep ring and take
//     mma.sync m16n8k8 instead: the raw bank (96 KB), eight boxes a
//     warpgroup, warps of 32 x 32 reading both operands by ldmatrix and
//     splitting them at use. float32 stores directly (a quad of threads
//     writes 32 whole bytes of a row).
//   - The wgrads: a block owns a 64 x 64 tile of [P, Q] and sums it in
//     registers over a run of rows (a multiple of 64) that its producer
//     streams (A's and B's boxes of a chunk on one mbarrier); bf16 on wgmma
//     reading both operands MN-major through its transpose bit, float32 on
//     mma.sync (3xTF32, warps of 32 x 32, fragment offsets computed once).
//     Blocks form clusters of CLUSTER consecutive runs that add their
//     tiles through distributed shared memory, each block summing an eighth
//     of the tile over the cluster's ranks in rank order. With one cluster
//     of runs (G = 1) that sum is the result, written in place (zeros past
//     m); with G > 1 each cluster writes a float32 partial and
//     pw_wgrad_finish_kernel adds the G partials in order. The partition
//     (rows a block, G) comes from the shapes alone, with G bounded so that
//     the partials' traffic is at most a tenth of the operands' bytes. No
//     atomics: two calls give the same bits on any card.
// No setmaxnreg: every warp keeps the launch's registers (no instance
// spills; ptxas's report is printed by chip_smoke.py phase 1).
//
// Every dimension but R is a multiple of 8 and every pointer 16-byte
// aligned (the wrapper checks both, which TMA's stride rules also need);
// the bank fits beside the rings (the wrapper's `smem_bytes` mirror).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                  // rows of a tile (wgmma's M)
constexpr int BN = 64;                  // columns of an N chunk
constexpr int LINE = 128;               // bytes of a swizzled row: one K chunk
constexpr int PANEL = BM * LINE;        // one TMA box, 8 KB
constexpr int WGRAD_THREADS = 128 + 32;
constexpr int CLUSTER = 8;              // wgrad blocks adding their tiles on chip
constexpr int HEAD = 1024;              // the mbarriers
constexpr int ALIGN = 1024;             // slack to put the buffers on the swizzle atom
constexpr int SMEM_MAX = 232448;

template <typename T>
struct Ty;

template <>
struct Ty<float> {
  static constexpr int CK = LINE / 4;                  // K a chunk
  static constexpr int WSTAGES = 3;                    // the wgrad ring
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <>
struct Ty<__nv_bfloat16> {
  static constexpr int CK = LINE / 2;
  static constexpr int WSTAGES = 6;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// A forward / dgrad block's shape, by type and bound: consumer warpgroups,
// boxes in a warpgroup's ring, output through shared memory and TMA (else
// stored directly), copies of the bank, and the engine: wgmma (MMA 0; for
// float32, 3xTF32 with A split in registers and the bank held split, big
// and small: the N-bounded forms) or float32 3xTF32 on mma.sync (MMA 1: the
// raw bank and a deep ring, every operand split at use: the K-bounded
// forms, whose K chunks stream).
template <typename T, bool BOUND_K>
struct Cfg {  // bf16
  static constexpr int WGS = 3, STAGES = 4, BANKS = 1, MMA = 0;
  static constexpr bool STAGED = true;
};

template <>
struct Cfg<float, false> {
  static constexpr int WGS = 2, STAGES = 2, BANKS = 2, MMA = 0;
  static constexpr bool STAGED = false;
};

template <>
struct Cfg<float, true> {
  static constexpr int WGS = 2, STAGES = 8, BANKS = 1, MMA = 1;
  static constexpr bool STAGED = false;
};

// a wgrad stage: the A box(es) of a 64-row chunk (64 columns of P) and B's
template <typename T>
__host__ __device__ constexpr int wstage_bytes() {
  return 2 * (BM / Ty<T>::CK) * PANEL;
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// the bank [ceil(N/64)*64 rows][K chunks of 128 bytes]
template <typename T>
__host__ __device__ constexpr int bank_rows(int n) {
  return cdiv(n, BN) * BN;
}

// a forward / dgrad block: its warpgroups' rings, and (bf16) their output
// staging (two 64 x 64 chunks each) and a zero panel, then the bank
template <typename T, bool BOUND_K>
__host__ __device__ constexpr int gemm_stage_panels() {
  using C = Cfg<T, BOUND_K>;
  return C::STAGED ? C::WGS * (C::STAGES + 2 * (BN / Ty<T>::CK)) + 1 : C::WGS * C::STAGES;
}

template <typename T, bool BOUND_K>
__host__ __device__ constexpr int gemm_threads() {
  return 128 * Cfg<T, BOUND_K>::WGS + 32;
}

// one copy of the bank [ceil(N/64)*64 rows][K chunks of 128 bytes]
template <typename T>
__host__ __device__ constexpr int bank_bytes(int k, int n) {
  return bank_rows<T>(n) * cdiv(k, Ty<T>::CK) * LINE;
}

template <typename T, bool BOUND_K>
constexpr int gemm_smem(int k, int n) {
  return ALIGN + HEAD + gemm_stage_panels<T, BOUND_K>() * PANEL +
         Cfg<T, BOUND_K>::BANKS * bank_bytes<T>(k, n);
}

template <typename T>
constexpr int wgrad_smem() {
  return ALIGN + HEAD + Ty<T>::WSTAGES * wstage_bytes<T>();
}

// -- shared memory, barriers, TMA ------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = saddr(p);
  return p + ((ALIGN - (a & (ALIGN - 1))) & (ALIGN - 1));
}

// byte offset of (row, byte) in a 128-byte-swizzled panel whose rows are
// LINE bytes (TMA's CU_TENSOR_MAP_SWIZZLE_128B; the panel 1024-aligned)
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  return (uint32_t)(row * LINE + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}

// order this thread's generic-proxy accesses of shared memory before the
// async proxy's (TMA writes, wgmma reads)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the box of `map` at (column c, row r) into dst, counted on bar; out of
// bounds elements arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c), "r"(r)
      : "memory");
}

// the box of `map` at (column c, row r) from src: its bytes are read by
// the async proxy, committed as a bulk group by the caller
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c, int r) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(saddr(src)), "r"(c), "r"(r)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the producer's fill q of a ring of n stages: wait for the stage's
// release, then count `bytes` on its full barrier
__device__ __forceinline__ int ring_fill(uint64_t* full, uint64_t* empty, int q, int n,
                                         unsigned bytes) {
  const int s = q % n;
  mbar_wait(&empty[s], ((q / n) & 1) ^ 1);
  fence_async();
  mbar_expect(&full[s], bytes);
  return s;
}

// a consumer's wait for fill q
__device__ __forceinline__ int ring_take(uint64_t* full, int q, int n) {
  const int s = q % n;
  mbar_wait(&full[s], (q / n) & 1);
  return s;
}

__device__ __forceinline__ int clamp_bound(const int* bound, int dim) {
  return min(max(__ldg(bound), 0), dim);
}

// -- wgmma (bf16) ------------------------------------------------------------------

// a shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major (K along the 128-byte line, 8-row groups 1024 bytes apart; the
// k16 step kk 32 bytes along the line) and MN-major (MN along the line, K
// the row: the k16 step 16 rows on; both offsets the 8-row group's 1024
// bytes, the leading one unused at 64 MN elements)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  return sw128_desc(base + kk * 32, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk) {
  return sw128_desc(base + kk * 16 * LINE, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across the async MMAs
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B over one k16 step, m64n64k16, both operands from shared
// memory; TRANS 1 reads both MN-major (the wgrads)
template <int TRANS>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TRANS));
}

// d (+)= A . B over one k8 step, m64n64k8 tf32: A from registers (a
// warp's 16 x 8 slice as mma.m16n8k8's A fragment), B K-major from shared
// memory; the hardware reads the top 19 bits of each operand
__device__ __forceinline__ void wgmma64_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// -- float32: 3xTF32 mma.sync --------------------------------------------------------

// v = big + small (+ ~2^-22 v), each rounded to TF32 (csrc/mbconv.cu's
// split), from v's bits
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& big, uint32_t& small) {
  big = (v + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(v) - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8 x 16-byte matrices of shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; of each, a thread receives the 4 bytes at
// (row lane / 4, column lane % 4): for 32-bit data the MMA fragments
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d = a . b, the tile's sum starting from 0
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

template <int M, int E>
__device__ __forceinline__ void split_all(const uint32_t (&v)[M][E], uint32_t (&big)[M][E],
                                          uint32_t (&small)[M][E]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) split_tf32(v[i][e], big[i][e], small[i][e]);
}

// One k8 step of a warp's 32 x 32 share of a 64 x 64 float32 tile (warps 2
// x 2: its two m16 tiles mi, four n8 tiles nj): the three TF32 products
// small*big, big*small, big*big into part[16 mi + 4 nj + q], which FIRST
// starts from 0 (a run of k8 steps sums in part, truncating as an MMA
// does; the caller adds part into its float32 sum with a rounded add)
template <bool FIRST>
__device__ __forceinline__ void mma3_f32(float (&part)[32], const uint32_t (&ab)[2][4],
                                         const uint32_t (&as)[2][4], const uint32_t (&bb)[4][2],
                                         const uint32_t (&bs)[4][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      float(&d)[4] = *reinterpret_cast<float(*)[4]>(part + 16 * mi + 4 * nj);
      if (FIRST)
        mma_tf32_z(d, as[mi], bb[nj]);
      else
        mma_tf32(d, as[mi], bb[nj]);
      mma_tf32(d, ab[mi], bs[nj]);
      mma_tf32(d, ab[mi], bb[nj]);
    }
}

__device__ __forceinline__ void add_into(float (&acc)[32], const float (&part)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
}

// -- output ----------------------------------------------------------------------

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

// (row, column) within a 64 x 64 tile of accumulator element i of thread
// `tid` of a warpgroup: wgmma's m64n64 layout (L 0: warp w rows 16w.., n8
// block i / 4), or the float32 wgrad warps' 2 x 2 of 32 x 32 (L 1:
// element 16 mi + 4 nj + q of m16 tile mi and n8 tile nj)
template <int L>
__device__ __forceinline__ int acc_row(int tid, int i) {
  const int base = L == 0 ? 16 * (tid >> 5) : 32 * ((tid >> 5) & 1) + 16 * (i >> 4);
  return base + ((tid & 31) >> 2) + 8 * ((i & 3) >> 1);
}

template <int L>
__device__ __forceinline__ int acc_col(int tid, int i) {
  const int base = L == 0 ? 8 * (i >> 2) : 32 * (tid >> 6) + 8 * ((i >> 2) & 3);
  return base + 2 * (tid & 3) + (i & 1);
}

// A warpgroup's output C [R, N]: bf16 through its two staging buffers (a
// 64 x 64 chunk each, as 128-byte panels), C's tensor map and the zero
// panel, only its thread 0 issuing and waiting for the stores (n counts the
// chunks staged); float32 stored directly (a quad of threads writes 32
// whole bytes of a row).
struct Out {
  unsigned char* stage;
  const CUtensorMap* map;
  const unsigned char* zero;
  int n;
  void* C;
  int R, N;
};

// the chunk of C at (r0, c0) from the accumulator, columns from `live` on
// written 0, rows from R and columns from N not at all (TMA clips its box)
template <typename T, typename CF>
__device__ __forceinline__ void store_chunk(const float (&acc)[32], Out& o, int r0, int c0,
                                            int live, int wtid, int bar) {
  if constexpr (!CF::STAGED) {
    T* C = reinterpret_cast<T*>(o.C);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = r0 + acc_row<CF::MMA>(wtid, i), c = c0 + acc_col<CF::MMA>(wtid, i);
      if (r < o.R && c < o.N)
        store2<T>(C + (long long)r * o.N + c, c < live ? acc[i] : 0.f,
                  c + 1 < live ? acc[i + 1] : 0.f);
    }
  } else {
    constexpr int CK = Ty<T>::CK, PANELS = BN / CK;
    unsigned char* buf = o.stage + (o.n & 1) * PANELS * PANEL;
    if (wtid == 0) bulk_wait_read<1>();  // the store from this buffer two chunks ago has read it
    bar_sync(bar, 128);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = acc_row<0>(wtid, i), c = acc_col<0>(wtid, i);
      const float a = c0 + c < live ? acc[i] : 0.f, b = c0 + c + 1 < live ? acc[i + 1] : 0.f;
      store2<T>(reinterpret_cast<T*>(buf + (c / CK) * PANEL + swz(r, (c % CK) * sizeof(T))), a,
                b);
    }
    fence_async();
    bar_sync(bar, 128);
    if (wtid == 0) {
#pragma unroll
      for (int i = 0; i < PANELS; ++i) tma_store(o.map, buf + i * PANEL, c0 + i * CK, r0);
      bulk_commit();
    }
    ++o.n;
  }
}

// columns [c0, N) of the tile's rows written 0 (c0 a multiple of BN): bf16
// by TMA stores of the zero panel from the warpgroup's thread 0, float32
// by 16-byte stores
template <typename T, typename CF>
__device__ __forceinline__ void zero_columns(const Out& o, int r0, int c0, int wtid) {
  if (c0 >= o.N) return;
  if constexpr (!CF::STAGED) {
    T* C = reinterpret_cast<T*>(o.C);
    constexpr int EPC = 16 / (int)sizeof(T);
    const int per_row = (o.N - c0) / EPC;
    for (int i = wtid; i < BM * per_row; i += 128) {
      const int r = r0 + i / per_row, c = c0 + (i % per_row) * EPC;
      if (r < o.R) *reinterpret_cast<uint4*>(C + (long long)r * o.N + c) = make_uint4(0, 0, 0, 0);
    }
  } else {
    if (wtid != 0) return;
    for (int c = c0; c < o.N; c += Ty<T>::CK) tma_store(o.map, o.zero, c, r0);
    bulk_commit();
  }
}

// -- forward and dgrad: C[R,N] = A[R,K] . B^T, bound on N or on K -----------------

// What a launch computes, from the bound read on the device.
struct Plan {
  int half;     // bytes from the bank's big half to its small half (float32)
  int m;        // the bound, clamped
  int nkc;      // K chunks a tile
  int n_comp;   // 64-column chunks computed (0: C is all zeros, nothing read)
  int live;     // columns below it stored, the rest 0
  int k_tail;   // K-bounded: the last chunk zeroed from this K on (chunk-relative), else CK
};

template <typename T, bool BOUND_K>
__device__ __forceinline__ Plan make_plan(const int* bound, int K, int N) {
  constexpr int CK = Ty<T>::CK;
  Plan p;
  p.half = bank_bytes<T>(K, N);
  p.m = clamp_bound(bound, BOUND_K ? K : N);
  const int k_live = BOUND_K ? p.m : K;
  p.nkc = cdiv(k_live, CK);
  p.n_comp = p.nkc == 0 ? 0 : cdiv(BOUND_K ? N : p.m, BN);
  p.live = BOUND_K ? N : p.m;
  p.k_tail = (BOUND_K && k_live < K && k_live % CK) ? k_live % CK : CK;
  return p;
}

// Stage the bank into shared memory as [rows][K chunks] swizzled: B(n, k)
// is W[n*K + k] (the forwards) or W[k*N + n] (B_KN: the dgrads, transposed
// here). Only rows n < n_lim and columns k < k_lim are read; the rest of
// the computed chunks is zeroed, the chunks past them are not touched.
// Store a bank value (or four, a 16-byte piece) at byte `off`: as it is
// (bf16), or split, big at `off` and small `half` bytes on (float32).
template <int BANKS, typename V>
__device__ __forceinline__ void put_bank(unsigned char* bank, int half, int off, V v) {
  if constexpr (BANKS == 1) {
    *reinterpret_cast<V*>(bank + off) = v;
  } else {
    uint32_t* u = reinterpret_cast<uint32_t*>(&v);
    V big, small;
    uint32_t* ub = reinterpret_cast<uint32_t*>(&big);
    uint32_t* us = reinterpret_cast<uint32_t*>(&small);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(V) / 4); ++i) split_tf32(u[i], ub[i], us[i]);
    *reinterpret_cast<V*>(bank + off) = big;
    *reinterpret_cast<V*>(bank + half + off) = small;
  }
}

template <typename T, bool BOUND_K, bool B_KN>
__device__ __forceinline__ void stage_bank(unsigned char* bank, const T* __restrict__ W, int K,
                                           int N, const Plan& p, int ctid, int nthreads) {
  constexpr int CK = Ty<T>::CK, EPC = 16 / (int)sizeof(T);
  const int NP = bank_rows<T>(N), half = bank_bytes<T>(K, N);
  const int n_lim = BOUND_K ? N : p.m, k_lim = BOUND_K ? p.m : K;
  const int rows = BOUND_K ? NP : p.n_comp * BN;
  const int cols = p.nkc * CK;
  if (!B_KN) {  // 16-byte pieces along k, stored as they are
    const int per_row = cols / EPC;
    for (int i = ctid; i < rows * per_row; i += nthreads) {
      const int n = i / per_row, k0 = (i % per_row) * EPC;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n < n_lim && k0 < k_lim) {
        v = *reinterpret_cast<const uint4*>(W + (long long)n * K + k0);
        if (k0 + EPC > k_lim) {  // the piece holding the bound
          T* e = reinterpret_cast<T*>(&v);
#pragma unroll
          for (int q = 0; q < EPC; ++q)
            if (k0 + q >= k_lim) e[q] = from_float<T>(0.f);
        }
      }
      put_bank<Cfg<T, BOUND_K>::BANKS>(bank, half,
                                       (k0 / CK) * NP * LINE + swz(n, (k0 % CK) * sizeof(T)), v);
    }
  } else {  // EPC x EPC blocks of W [K, N]: EPC 16-byte rows of W in, transposed in
            // registers, EPC 16-byte rows of the bank out
    const int per_k = rows / EPC;
    for (int i = ctid; i < (cols / EPC) * per_k; i += nthreads) {
      const int k0 = (i / per_k) * EPC, n0 = (i % per_k) * EPC;
      uint4 v[EPC];
#pragma unroll
      for (int r = 0; r < EPC; ++r) {
        v[r] = make_uint4(0, 0, 0, 0);
        if (k0 + r < k_lim && n0 < n_lim)
          v[r] = *reinterpret_cast<const uint4*>(W + (long long)(k0 + r) * N + n0);
      }
      const int panel = (k0 / CK) * NP * LINE;
#pragma unroll
      for (int c = 0; c < EPC; ++c) {
        uint4 u;
        T* e = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int r = 0; r < EPC; ++r)
          e[r] = n0 + c < n_lim ? reinterpret_cast<const T*>(&v[r])[c] : from_float<T>(0.f);
        put_bank<Cfg<T, BOUND_K>::BANKS>(bank, half, panel + swz(n0 + c, (k0 % CK) * sizeof(T)), u);
      }
    }
  }
}

// Zero K from k_tail on in a staged A box (the chunk holding a K bound),
// then make the warpgroup's writes visible to its reads (barrier `bar`).
template <typename T>
__device__ __forceinline__ void zero_tail(unsigned char* panel, int k_tail, int wtid, int bar) {
  constexpr int CK = Ty<T>::CK;
  const int n = CK - k_tail;
  for (int i = wtid; i < BM * n; i += 128) {
    const int r = i / n, k = k_tail + i % n;
    *reinterpret_cast<T*>(panel + swz(r, k * sizeof(T))) = from_float<T>(0.f);
  }
  fence_async();
  bar_sync(bar, 128);
}

// One tile of a warpgroup from its ring (full / empty barriers, STAGES
// boxes): q0 is the ring's fill of the tile's first K chunk. With one N
// chunk the K chunks stream, each released when its products are done;
// with more, the tile's chunks are held across them.
template <typename CF>
__device__ __forceinline__ void tile_bf16(const Plan& p, unsigned char* ring, uint64_t* full,
                                          uint64_t* empty, const unsigned char* bank, int NP,
                                          int q0, Out& o, int r0, int wtid, int bar) {
  using T = __nv_bfloat16;
  constexpr int S = CF::STAGES;
  const uint32_t ring_a = saddr(ring), bank_a = saddr(bank);
  float acc[32];
  if (p.n_comp == 1) {
    int prev = -1;
    for (int kc = 0; kc < p.nkc; ++kc) {
      const int s = ring_take(full, q0 + kc, S);
      if (kc == p.nkc - 1 && p.k_tail < Ty<T>::CK)
        zero_tail<T>(ring + s * PANEL, p.k_tail, wtid, bar);
      wg_fence();
      const uint32_t a = ring_a + s * PANEL, b = bank_a + kc * NP * LINE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma64<0>(acc, kmajor_desc(a, kk), kmajor_desc(b, kk), kc | kk);
      wg_commit();
      if (prev >= 0) {
        wg_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wg_wait<0>();
    pin(acc);
    mbar_arrive(&empty[prev]);
    store_chunk<T, CF>(acc, o, r0, 0, p.live, wtid, bar);
  } else if (p.n_comp > 1) {
    for (int kc = 0; kc < p.nkc; ++kc) {
      const int s = ring_take(full, q0 + kc, S);
      if (kc == p.nkc - 1 && p.k_tail < Ty<T>::CK)
        zero_tail<T>(ring + s * PANEL, p.k_tail, wtid, bar);
    }
    for (int nc = 0; nc < p.n_comp; ++nc) {
      wg_fence();
      for (int kc = 0; kc < p.nkc; ++kc) {
        const uint32_t a = ring_a + ((q0 + kc) % S) * PANEL,
                       b = bank_a + kc * NP * LINE + nc * BN * LINE;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma64<0>(acc, kmajor_desc(a, kk), kmajor_desc(b, kk), kc | kk);
      }
      wg_commit();
      wg_wait<0>();
      pin(acc);
      if (nc == p.n_comp - 1)  // the tile's boxes are free before its last stores
        for (int kc = 0; kc < p.nkc; ++kc) mbar_arrive(&empty[(q0 + kc) % S]);
      store_chunk<T, CF>(acc, o, r0, nc * BN, p.live, wtid, bar);
    }
  }
}

// float32: a warpgroup's 64 x 64 chunk over one or two K chunks (`two`)
// as 3xTF32 on wgmma: its warps' A slices (16 rows each) loaded from the
// boxes a[] by ldmatrix (lane l addresses row l % 8 of matrix l / 8) and
// split in registers, the bank's big and small halves (b[], `half` bytes
// on) read from shared memory. The products (12 a chunk) sum in a tile
// started at 0, one wgmma group, added into acc with a rounded add.
__device__ __forceinline__ void chunks_f32(float (&acc)[32], const unsigned char* const (&a)[2],
                                           const uint32_t (&b)[2], bool two, int half,
                                           int wtid) {
  constexpr int KS = Ty<float>::CK / 8;  // k8 steps a chunk
  const int l = wtid & 31, x = l & 7;
  const int row = (16 * (wtid >> 5) + 8 * ((l >> 3) & 1) + x) * LINE;
  uint32_t ab[2][KS][4], as[2][KS][4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c == 1 && !two) break;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t v[4];
      ldsm4(v, saddr(a[c]) + row + (((2 * kk + (l >> 4)) ^ x) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], ab[c][kk][e], as[c][kk][e]);
    }
  }
  float part[32];
  wg_fence();
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c == 1 && !two) break;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma64_tf32(part, as[c][kk], kmajor_desc(b[c], kk), c | kk);
      wgmma64_tf32(part, ab[c][kk], kmajor_desc(b[c] + half, kk), 1);
      wgmma64_tf32(part, ab[c][kk], kmajor_desc(b[c], kk), 1);
    }
  }
  wg_commit();
  wg_wait<0>();
  pin(part);
  add_into(acc, part);
}

template <typename CF>
__device__ __forceinline__ void tile_f32_wgmma(const Plan& p, unsigned char* ring,
                                               uint64_t* full, uint64_t* empty,
                                               const unsigned char* bank, int NP, int q0,
                                               Out& o, int r0, int wtid, int bar) {
  constexpr int S = CF::STAGES;
  const uint32_t bank_a = saddr(bank);
  auto take = [&](int kc) {  // wait for K chunk kc's box, zero its tail past a K bound
    const int s = ring_take(full, q0 + kc, S);
    if (kc == p.nkc - 1 && p.k_tail < Ty<float>::CK)
      zero_tail<float>(ring + s * PANEL, p.k_tail, wtid, bar);
    return s;
  };
  float acc[32];
  if (p.n_comp == 1) {  // stream the K chunks two at a time, each box released after use
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < p.nkc; kc += 2) {
      const bool two = kc + 1 < p.nkc;
      const int s0 = take(kc), s1 = two ? take(kc + 1) : s0;
      const unsigned char* const a[2] = {ring + s0 * PANEL, ring + s1 * PANEL};
      const uint32_t b[2] = {bank_a + kc * NP * LINE, bank_a + (kc + 1) * NP * LINE};
      chunks_f32(acc, a, b, two, p.half, wtid);
      mbar_arrive(&empty[s0]);
      if (two) mbar_arrive(&empty[s1]);
    }
    store_chunk<float, CF>(acc, o, r0, 0, p.live, wtid, bar);
  } else if (p.n_comp > 1) {  // hold the tile's (at most two) K chunks across its N chunks
    const int s0 = take(0), s1 = p.nkc > 1 ? take(1) : s0;
    const unsigned char* const a[2] = {ring + s0 * PANEL, ring + s1 * PANEL};
    for (int nc = 0; nc < p.n_comp; ++nc) {
      const uint32_t b[2] = {bank_a + nc * BN * LINE, bank_a + NP * LINE + nc * BN * LINE};
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      chunks_f32(acc, a, b, p.nkc > 1, p.half, wtid);
      if (nc == p.n_comp - 1) {
        mbar_arrive(&empty[s0]);
        if (p.nkc > 1) mbar_arrive(&empty[s1]);
      }
      store_chunk<float, CF>(acc, o, r0, nc * BN, p.live, wtid, bar);
    }
  }
}

// float32 on mma.sync (MMA 1): a warp's 32 x 32 share (warps 2 x 2) of
// one K chunk against an N chunk, the A box and the raw bank's rows at
// b_chunk (K-major) read by ldmatrix (lane l addresses row l % 8 of
// matrix l / 8) and split at use; the chunk's products sum in a tile
// started at 0, added into acc once
__device__ __forceinline__ void chunk_f32_mma(float (&acc)[32], const unsigned char* a_panel,
                                              const unsigned char* b_chunk, int wtid) {
  const int warp = wtid >> 5, l = wtid & 31, x = l & 7;
  const uint32_t a0 = saddr(a_panel) + (32 * (warp & 1) + 8 * ((l >> 3) & 1) + x) * LINE;
  const uint32_t b0 = saddr(b_chunk) + (32 * (warp >> 1) + 8 * (l >> 4) + x) * LINE;
  const int ka = l >> 4, kb = (l >> 3) & 1;  // the 16-byte column (k 0-3 or 4-7) a lane reads
  float part[32];
#pragma unroll
  for (int kk = 0; kk < Ty<float>::CK / 8; ++kk) {
    uint32_t a[2][4], q[2][4], b[4][2], ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) ldsm4(a[mi], a0 + mi * 16 * LINE + (((2 * kk + ka) ^ x) << 4));
#pragma unroll
    for (int pj = 0; pj < 2; ++pj) ldsm4(q[pj], b0 + pj * 16 * LINE + (((2 * kk + kb) ^ x) << 4));
#pragma unroll
    for (int pj = 0; pj < 2; ++pj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        b[2 * pj][e] = q[pj][e];
        b[2 * pj + 1][e] = q[pj][2 + e];
      }
    split_all(a, ab, as);
    split_all(b, bb, bs);
    if (kk == 0)
      mma3_f32<true>(part, ab, as, bb, bs);
    else
      mma3_f32<false>(part, ab, as, bb, bs);
  }
  add_into(acc, part);
}

template <typename CF>
__device__ __forceinline__ void tile_f32_mma(const Plan& p, unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, const unsigned char* bank, int NP,
                                             int q0, Out& o, int r0, int wtid, int bar) {
  constexpr int S = CF::STAGES;
  float acc[32];
  if (p.n_comp == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < p.nkc; ++kc) {
      const int s = ring_take(full, q0 + kc, S);
      if (kc == p.nkc - 1 && p.k_tail < Ty<float>::CK)
        zero_tail<float>(ring + s * PANEL, p.k_tail, wtid, bar);
      chunk_f32_mma(acc, ring + s * PANEL, bank + kc * NP * LINE, wtid);
      mbar_arrive(&empty[s]);
    }
    store_chunk<float, CF>(acc, o, r0, 0, p.live, wtid, bar);
  } else if (p.n_comp > 1) {
    for (int kc = 0; kc < p.nkc; ++kc) {
      const int s = ring_take(full, q0 + kc, S);
      if (kc == p.nkc - 1 && p.k_tail < Ty<float>::CK)
        zero_tail<float>(ring + s * PANEL, p.k_tail, wtid, bar);
    }
    for (int nc = 0; nc < p.n_comp; ++nc) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < p.nkc; ++kc)
        chunk_f32_mma(acc, ring + ((q0 + kc) % S) * PANEL, bank + kc * NP * LINE + nc * BN * LINE,
                      wtid);
      if (nc == p.n_comp - 1)
        for (int kc = 0; kc < p.nkc; ++kc) mbar_arrive(&empty[(q0 + kc) % S]);
      store_chunk<float, CF>(acc, o, r0, nc * BN, p.live, wtid, bar);
    }
  }
}

template <typename T, bool BOUND_K>
__device__ __forceinline__ void gemm_tile(const Plan& p, unsigned char* ring, uint64_t* full,
                                          uint64_t* empty, const unsigned char* bank, int NP,
                                          int q0, Out& o, int r0, int wtid, int bar) {
  using CF = Cfg<T, BOUND_K>;
  if constexpr (sizeof(T) == 2)
    tile_bf16<CF>(p, ring, full, empty, bank, NP, q0, o, r0, wtid, bar);
  else if constexpr (CF::MMA)
    tile_f32_mma<CF>(p, ring, full, empty, bank, NP, q0, o, r0, wtid, bar);
  else
    tile_f32_wgmma<CF>(p, ring, full, empty, bank, NP, q0, o, r0, wtid, bar);
}

template <typename T, bool BOUND_K, bool B_KN>
__device__ __forceinline__ void gemm_block(const CUtensorMap* amap, const CUtensorMap* cmap,
                                           const T* __restrict__ W,
                                           const int* __restrict__ bound, T* C, int R, int K,
                                           int N, unsigned char* smem_raw) {
  using CF = Cfg<T, BOUND_K>;
  constexpr int CK = Ty<T>::CK, S = CF::STAGES, WGS = CF::WGS;
  constexpr int OUT = CF::STAGED ? 2 * (BN / CK) * PANEL : 0;
  // a ring (S boxes, a full and an empty barrier each) a warpgroup: with
  // one consumer a ring, no waiter runs a phase ahead of its barrier
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + WGS * S;
  unsigned char* ring = smem + HEAD;
  unsigned char* stage = ring + WGS * S * PANEL;
  unsigned char* zero = stage + WGS * OUT;
  unsigned char* bank = zero + (CF::STAGED ? PANEL : 0);
  const int NP = bank_rows<T>(N);
  const Plan p = make_plan<T, BOUND_K>(bound, K, N);
  const int n_tiles = cdiv(R, BM);
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < WGS * S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 4 * WGS) {  // the producer: the block's tiles' K chunks, in order,
    if ((tid & 31) == 0 && p.n_comp > 0) {  // tile j into warpgroup j % WGS's ring
      for (int j = 0;; ++j) {
        const int t = blockIdx.x + j * gridDim.x;
        if (t >= n_tiles) break;
        const int w = j % WGS;
        for (int kc = 0; kc < p.nkc; ++kc) {
          const int s = ring_fill(full + w * S, empty + w * S, (j / WGS) * p.nkc + kc, S,
                                  PANEL);
          tma_load(ring + (w * S + s) * PANEL, amap, &full[w * S + s], kc * CK, t * BM);
        }
      }
    }
    __syncwarp();
    return;
  }
  const int wg = warp >> 2, wtid = tid & 127;
  if (CF::STAGED)
    for (int i = tid; i < PANEL / 16; i += 128 * WGS)
      reinterpret_cast<uint4*>(zero)[i] = make_uint4(0, 0, 0, 0);
  stage_bank<T, BOUND_K, B_KN>(bank, W, K, N, p, tid, 128 * WGS);
  fence_async();
  bar_sync(1, 128 * WGS);
  Out o{stage + wg * OUT, cmap, zero, 0, C, R, N};
  for (int j = wg;; j += WGS) {
    const int t = blockIdx.x + j * gridDim.x;
    if (t >= n_tiles) break;
    gemm_tile<T, BOUND_K>(p, ring + wg * S * PANEL, full + wg * S, empty + wg * S, bank, NP,
                 (j / WGS) * p.nkc, o, t * BM, wtid, 2 + wg);
    zero_columns<T, CF>(o, t * BM, p.n_comp * BN, wtid);
  }
  if (CF::STAGED && wtid == 0) bulk_wait_all();  // the stores are done
}

// the forwards (B stored [N,K]) and the dgrads (B stored [K,N]), by name
// apart in a profile
template <typename T, bool BOUND_K>
__global__ void __launch_bounds__(gemm_threads<T, BOUND_K>(), 1)
    pw_fwd_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap cmap, const T* __restrict__ W,
                  const int* __restrict__ bound, T* C, int R, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemm_block<T, BOUND_K, false>(&amap, &cmap, W, bound, C, R, K, N, smem);
}

template <typename T, bool BOUND_K>
__global__ void __launch_bounds__(gemm_threads<T, BOUND_K>(), 1)
    pw_dgrad_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap cmap, const T* __restrict__ W,
                    const int* __restrict__ bound, T* C, int R, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemm_block<T, BOUND_K, true>(&amap, &cmap, W, bound, C, R, K, N, smem);
}

// -- wgrad: C[P,Q] = A[R,P]^T . B[R,Q], bound on P -----------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t local, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// out[p][q] (or out[q][p], `transpose`) = v for p below the bound, else 0
template <typename T>
__device__ __forceinline__ void put_out(T* __restrict__ out, int P, int Q, int transpose, int m,
                                        int p, int q, float v) {
  if (p < P && q < Q)
    out[transpose ? (long long)q * P + p : (long long)p * Q + q] = from_float<T>(p < m ? v : 0.f);
}

// the run chunk's products of a warpgroup, bf16: acc (+)= A^T . B over 64
// rows, both MN-major
__device__ __forceinline__ void wchunk_bf16(float (&acc)[32], uint32_t a, uint32_t b, int first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma64<1>(acc, mnmajor_desc(a, kk), mnmajor_desc(b, kk), (!first) | kk);
}

// float32: a warp's 32 x 32 share (warps 2 x 2) over a run chunk of 64
// rows; A's two boxes (64 rows x 32 columns of P each) at a, B's at b, both
// MN-major. A thread's fragment offsets in a box repeat every 8 rows (the
// swizzle's period), so they are computed once a block (`wgrad_offsets`)
// and a k8 step adds 8 rows.
struct WOff {
  int a[2][4];  // m16 tile mi, fragment register e
  int b[4][2];  // n8 tile nj, fragment register e
};

__device__ __forceinline__ int box_off(int row, int col) {
  return (col >> 5) * PANEL + (int)swz(row, (col & 31) * 4);
}

__device__ __forceinline__ WOff wgrad_offsets(int wtid) {
  const int warp = wtid >> 5, g = (wtid & 31) >> 2, t = wtid & 3;
  const int wr = 32 * (warp & 1), wc = 32 * (warp >> 1);
  WOff o;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e)  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      o.a[mi][e] = box_off(t + 4 * (e >> 1), wr + 16 * mi + g + 8 * (e & 1));
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e)  // b0 (k t, n g), b1 (k t + 4, n g)
      o.b[nj][e] = box_off(t + 4 * e, wc + 8 * nj + g);
  return o;
}

__device__ __forceinline__ void wchunk_f32(float (&acc)[32], const unsigned char* a,
                                           const unsigned char* b, const WOff& o) {
#pragma unroll 1
  for (int kk = 0; kk < BM / 8; kk += 2) {
    float part[32];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* ak = a + (kk + h) * 8 * LINE;
      const unsigned char* bk = b + (kk + h) * 8 * LINE;
      uint32_t fa[2][4], fb[4][2], ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fa[mi][e] = *reinterpret_cast<const uint32_t*>(ak + o.a[mi][e]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fb[nj][e] = *reinterpret_cast<const uint32_t*>(bk + o.b[nj][e]);
      split_all(fa, ab, as);
      split_all(fb, bb, bs);
      if (h == 0)
        mma3_f32<true>(part, ab, as, bb, bs);
      else
        mma3_f32<false>(part, ab, as, bb, bs);
    }
    add_into(acc, part);
  }
}

template <typename T>
__device__ __forceinline__ void wgrad_block(const CUtensorMap* amap, const CUtensorMap* bmap,
                                            const int* __restrict__ bound,
                                            float* __restrict__ part, T* __restrict__ out, int R,
                                            int P, int Q, int transpose, int rows_per, int G,
                                            unsigned char* smem_raw) {
  constexpr int CK = Ty<T>::CK, NS = Ty<T>::WSTAGES, SB = wstage_bytes<T>();
  constexpr int BOXES = BM / CK;  // boxes of A (and of B) a stage
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + NS;
  unsigned char* ring = smem + HEAD;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int q_tiles = cdiv(Q, BN);
  const int p0 = (blockIdx.y / q_tiles) * BM, q0 = (blockIdx.y % q_tiles) * BN;
  const int m = clamp_bound(bound, P);
  const unsigned rank = cluster_rank();
  if (p0 >= m) {  // the whole cluster's tile is past the bound
    if (G == 1)
      for (int i = tid; i < 8 * BN; i += WGRAD_THREADS)
        put_out<T>(out, P, Q, transpose, m, p0 + 8 * rank + i / BN, q0 + i % BN, 0.f);
    return;
  }
  const int row_beg = min(R, (int)blockIdx.x * rows_per);
  const int n_ch = cdiv(min(R, row_beg + rows_per) - row_beg, BM);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (warp == 4) {  // the producer: the run's chunks, A's and B's boxes on one barrier
    if ((tid & 31) == 0)
      for (int c = 0; c < n_ch; ++c) {
        const int s = ring_fill(full, empty, c, NS, SB);
        unsigned char* st = ring + s * SB;
        for (int i = 0; i < BOXES; ++i) {
          tma_load(st + i * PANEL, amap, &full[s], p0 + i * CK, row_beg + c * BM);
          tma_load(st + (BOXES + i) * PANEL, bmap, &full[s], q0 + i * CK, row_beg + c * BM);
        }
      }
    __syncwarp();
  } else if constexpr (sizeof(T) == 2) {
    int prev = -1;
    for (int c = 0; c < n_ch; ++c) {
      const int s = ring_take(full, c, NS);
      wg_fence();
      const uint32_t a = saddr(ring + s * SB);
      wchunk_bf16(acc, a, a + BOXES * PANEL, c == 0);
      wg_commit();
      if (prev >= 0) {
        wg_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wg_wait<0>();
    pin(acc);
    if (prev >= 0) mbar_arrive(&empty[prev]);
  } else {
    const WOff off = wgrad_offsets(tid);
    for (int c = 0; c < n_ch; ++c) {
      const int s = ring_take(full, c, NS);
      const unsigned char* st = ring + s * SB;
      wchunk_f32(acc, st, st + BOXES * PANEL, off);
      mbar_arrive(&empty[s]);
    }
  }
  // the cluster's sum: each block's tile into its shared memory (over the
  // ring, now idle), then block `rank` adds an eighth of it over the ranks
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  if (tid < 128) {
    fence_async();
#pragma unroll
    for (int i = 0; i < 32; ++i) red[i * 128 + tid] = acc[i];
  }
  cluster_sync();
  if (tid < 128) {
    const int e0 = (int)rank * 512 + 4 * tid;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (unsigned r = 0; r < CLUSTER; ++r) {
      const float4 v = ld_cluster4(saddr(red + e0), r);
      s[0] += v.x;
      s[1] += v.y;
      s[2] += v.z;
      s[3] += v.w;
    }
    const int z = blockIdx.x / CLUSTER;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = e0 + c, i = e >> 7, owner = e & 127;
      constexpr int L = sizeof(T) == 2 ? 0 : 1;  // wgmma's layout, or the f32 warps' 2 x 2
      const int p = p0 + acc_row<L>(owner, i), q = q0 + acc_col<L>(owner, i);
      if (G == 1)
        put_out<T>(out, P, Q, transpose, m, p, q, s[c]);
      else if (p < P && q < Q)
        part[(long long)z * P * Q + (long long)p * Q + q] = s[c];
    }
  }
  cluster_sync();  // no block leaves while its shared memory is read
}

template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(WGRAD_THREADS, 1)
    pw_wgrad_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap, const int* __restrict__ bound,
                    float* __restrict__ part, T* __restrict__ out, int R, int P, int Q,
                    int transpose, int rows_per, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  wgrad_block<T>(&amap, &bmap, bound, part, out, R, P, Q, transpose, rows_per, G, smem);
}

// G > 1: out[p][q] (or out[q][p], `transpose`) = the G clusters' partials
// added in order for p below the bound, else 0
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

// -- host ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time (no link to libcuda needed)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
                       cudaSuccess &&
                   q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a map over row-major [rows, cols] at p whose box is 64 rows x 128 bytes,
// 128-byte swizzled, zeros out of bounds
template <typename T>
bool rows_map(CUtensorMap* m, const T* p, int rows, int cols) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Ty<T>::CK, (cuuint32_t)BM};
  const cuuint32_t unit[2] = {1, 1};
  return enc(m, Ty<T>::MAP, 2, const_cast<T*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, bool BOUND_K, bool B_KN>
int launch_gemm(const T* A, const T* W, const int* bound, T* C, int R, int K, int N, int grid,
                cudaStream_t stream) {
  CUtensorMap amap, cmap;
  if (!rows_map<T>(&amap, A, R, K) || !rows_map<T>(&cmap, C, R, N))
    return (int)cudaErrorInvalidValue;
  const int bytes = gemm_smem<T, BOUND_K>(K, N);
  if constexpr (B_KN) {
    cudaError_t e = allow_smem(pw_dgrad_kernel<T, BOUND_K>, bytes);
    if (e != cudaSuccess) return (int)e;
    pw_dgrad_kernel<T, BOUND_K>
        <<<grid, gemm_threads<T, BOUND_K>(), bytes, stream>>>(amap, cmap, W, bound, C, R, K, N);
  } else {
    cudaError_t e = allow_smem(pw_fwd_kernel<T, BOUND_K>, bytes);
    if (e != cudaSuccess) return (int)e;
    pw_fwd_kernel<T, BOUND_K>
        <<<grid, gemm_threads<T, BOUND_K>(), bytes, stream>>>(amap, cmap, W, bound, C, R, K, N);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int pw_gemm(const T* A, const T* W, const int* bound, T* C, int R, int K, int N, int b_kn,
            int bound_k, int grid, void* stream) {
  if (R < 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || grid <= 0 || (R > 0 && grid > cdiv(R, BM)) ||
      (bound_k ? gemm_smem<T, true>(K, N) : gemm_smem<T, false>(K, N)) > SMEM_MAX ||
      (N > BN && cdiv(K, Ty<T>::CK) > (bound_k ? Cfg<T, true>::STAGES : Cfg<T, false>::STAGES)) ||
      !aligned16(A) || !aligned16(W) || !aligned16(C))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (!b_kn && !bound_k) return launch_gemm<T, false, false>(A, W, bound, C, R, K, N, grid, s);
  if (!b_kn && bound_k) return launch_gemm<T, true, false>(A, W, bound, C, R, K, N, grid, s);
  if (b_kn && bound_k) return launch_gemm<T, true, true>(A, W, bound, C, R, K, N, grid, s);
  return launch_gemm<T, false, true>(A, W, bound, C, R, K, N, grid, s);
}

template <typename T>
int pw_wgrad(const T* A, const T* B, const int* bound, float* part, T* out, int R, int P, int Q,
             int transpose, int rows_per, int G, void* stream) {
  if (R <= 0 || P <= 0 || Q <= 0 || P % 8 || Q % 8 || rows_per <= 0 || rows_per % BM ||
      G <= 0 || (long long)G * CLUSTER > 65535 || (long long)G * CLUSTER * rows_per < R ||
      (long long)cdiv(P, BM) * cdiv(Q, BN) > 65535 || !aligned16(A) || !aligned16(B) ||
      (G > 1 && !aligned16(part)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  if (!rows_map<T>(&amap, A, R, P) || !rows_map<T>(&bmap, B, R, Q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bytes = wgrad_smem<T>();
  cudaError_t e = allow_smem(pw_wgrad_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(G * CLUSTER, cdiv(P, BM) * cdiv(Q, BN));
  pw_wgrad_kernel<T><<<grid, WGRAD_THREADS, bytes, s>>>(amap, bmap, bound, part, out, R, P, Q,
                                                        transpose, rows_per, G);
  e = cudaGetLastError();
  if (e != cudaSuccess || G == 1) return (int)e;
  const long long n = (long long)P * Q;
  pw_wgrad_finish_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, bound, out, P, Q,
                                                                        G, transpose);
  return (int)cudaGetLastError();
}

}  // namespace

// forward / dgrad: C [R,N] = A [R,K] . B^T; the bank W [N,K] (b_kn 0: the
// forwards) or [K,N] (b_kn 1: the dgrads); the bound m (one device int32,
// clamped to [0, N] or [0, K]) on N (bound_k 0: C written 0 from column m
// on) or on K (bound_k 1: A's and W's K entries from m on not read); `grid`
// persistent blocks over the 64-row tiles (the wrapper's plan)
extern "C" int ofa_pw_masked_gemm_f32(const float* a, const float* w, const int* bound, float* c,
                                      int R, int K, int N, int b_kn, int bound_k, int grid,
                                      void* stream) {
  return pw_gemm<float>(a, w, bound, c, R, K, N, b_kn, bound_k, grid, stream);
}

extern "C" int ofa_pw_masked_gemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* w,
                                       const int* bound, __nv_bfloat16* c, int R, int K, int N,
                                       int b_kn, int bound_k, int grid, void* stream) {
  return pw_gemm<__nv_bfloat16>(a, w, bound, c, R, K, N, b_kn, bound_k, grid, stream);
}

// wgrad: out = A [R,P]^T . B [R,Q] as [P,Q] (transpose 0) or [Q,P] (1),
// rows of P from the bound m on written 0; CLUSTER * G runs of rows_per
// rows (block z summing rows [z*rows_per, min(R, (z+1)*rows_per))); with
// G > 1, part holds G*P*Q floats of scratch (else it may be null)
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

// the dynamic shared memory a block takes (bytes): form 0 a forward or
// dgrad bounded on N, 1 one bounded on K (of a product with K `k` and N
// `n`: its rings and its bank), 2 the wgrads
extern "C" int ofa_pw_masked_smem_bytes(int form, int bf16, int k, int n) {
  if (form == 0)
    return bf16 ? gemm_smem<__nv_bfloat16, false>(k, n) : gemm_smem<float, false>(k, n);
  if (form == 1)
    return bf16 ? gemm_smem<__nv_bfloat16, true>(k, n) : gemm_smem<float, true>(k, n);
  if (form == 2) return bf16 ? wgrad_smem<__nv_bfloat16>() : wgrad_smem<float>();
  return -1;
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
