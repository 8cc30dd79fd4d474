// Fused MBConv inference block (BN folded), float32 in and out, with both
// 1x1 convs on the tensor cores in 3xTF32, for sm_90a.
//
// Replaces the Pallas kernel `fused_mbconv_infer` (ofa_sr_tpu/ops/pallas/
// mbconv.py: `_kernel`, `_dispatch`).
//
//   mid = relu6(x @ ib_w + ib_b)                 1x1 expand, C -> M
//   dw  = relu6(depthwise_k(mid, dw_w) + dw_b)   k x k, zero padding of mid
//   out = dw @ pl_w + pl_b (+ x if residual)     1x1 project, M -> C
//
// x, out [B,H,W,C] NHWC; ib_w [C,M]; dw_w [k,k,M]; pl_w [M,C]; biases [M]/[C].
//
// What bounds it on the H100: arithmetic. At the serving path's shape (C 64,
// M 384, k 7) a pixel takes 2*64*384*2 = 98,304 FLOP of 1x1 convs and
// 2*49*384 = 37,632 of depthwise against 512 bytes of x read and out
// written. The 1x1 convs run as three TF32 products a multiply-add on the
// tensor cores (495 TFLOP/s dense), the depthwise on the FP32 pipe (67
// TFLOP/s): a 180x320 launch cannot take less than ~0.034 ms (the 1x1
// convs' 3xTF32 products), against ~0.117 ms on the FP32 pipe alone.
//
// 3xTF32, as in shuffle_tail.cu: each operand is split as big = tf32(v),
// small = tf32(v - big), and each k8 step's three products (small*big,
// big*small, big*big) go into a zeroed register tile that is then added
// into the float32 sum with a rounded add. An MMA adds into its accumulator
// with truncation, so chaining the project's 48 k8 steps (M 384) into one
// accumulator would drift several times past cuDNN's float32 error.
//
// What holds it back on the card: mma.sync's TF32 rate, far below the
// 495 TFLOP/s that wgmma reaches (the shuffle tail gets ~26% of it); the
// expand's halo recompute, a third of the MMAs at k 7 (12.2 M m16n8k8
// MMAs a 180x320 launch in all); and shared-memory loads, which the
// expand's A fragments (x is loaded and split anew for every chunk) and the
// depthwise both lean on, so that running one chunk's depthwise beside the
// next chunk's expand (mids double-buffered) was no faster.
//
// Design: the (B,H,W,M) mid activation never reaches device memory.
// - A block of 16 warps owns a 15x16 tile of output pixels and all C output
//   channels; 180x320 is 12x20 = 240 such tiles with no ragged edge. At k 7
//   a block takes 226,176 bytes of shared memory, so one block an SM, with
//   16 warps to hide latency behind. The 15-row tile expands 1.93x as many
//   halo'd pixels as it outputs at k 7 (the 8x16 tile of the FP32 kernel
//   this replaces: 2.41x).
// - The tile's (15+k-1)x(16+k-1) halo of x (zeros outside the image,
//   channels zero-padded to a multiple of 8) is copied into shared memory
//   once with cp.async, pixel-major with stride C+4, so that the A-fragment
//   loads are free of bank conflicts.
// - The mid channels are walked in chunks of 16. A chunk's weights are
//   copied with cp.async (behind the previous chunk's depthwise), and its
//   ib_w and pl_w are split into big and small once, in shared memory, for
//   every warp's B fragments: splitting them per fragment cost the expand
//   29 splits of each weight a chunk. Per chunk, between three barriers:
//   (1) the expand over the halo, an m16n8k8 GEMM (halo pixels x C) @
//       (C x 16), two m16 tiles a warp so that B fragments are shared,
//       into `mids` [pixel][16] (+ bias, relu6, zero outside the image
//       since relu6(bias) != 0);
//   (2) the depthwise on the FP32 pipe from `mids`, one (channel, tile row,
//       8 columns) per thread (half-warps on adjacent rows: conflict-free
//       at k 3 and 7, two-way at k 5), into `dwo` [pixel][16] (+ bias,
//       relu6);
//   (3) the project, (tile pixels x 16) @ (16 x C), accumulated across the
//       chunks in registers: warp r owns tile row r (one m16 tile) and all
//       C columns. Bias and the residual (read from the staged halo) are
//       added at the end, stored straight from the accumulators.
// - Any H and W (edge tiles masked), k 3/5/7, C a multiple of 4 up to 64,
//   any M >= 1 (the last chunk's missing channels are zero-filled, which
//   makes their mid and depthwise values exactly 0). Weights are copied 16
//   bytes at a time when M % 4 == 0 and the pointers are 16-byte aligned,
//   else 4 bytes at a time.
// - Row bounds: for a frame padded with rows, or a slab of one with its
//   halos (spatial inference), the mid activation is zeroed outside the
//   valid rows [row_lo, row_hi) as well as outside the image, where the
//   expand stores it (JAX re-zeroes those rows between the expand and the
//   depthwise: ofa_sr_tpu/models/materialize.py `_mbconv`). x, the project
//   and the residual are not masked, as there. The bounds cost one compare
//   a stored value; (0, H) is the unbounded kernel.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TH = 15;             // tile rows
constexpr int TW = 16;             // tile cols: one m16 tile of the project
constexpr int TP = TH * TW;        // tile pixels
constexpr int MC = 16;             // mid channels per chunk
constexpr int NWARPS = 16;
constexpr int THREADS = 32 * NWARPS;
constexpr int CMAX = 64;
constexpr int MS = MC + 8;         // mids pixel stride: conflict-free stores, dw loads
constexpr int DS = MC + 4;         // dwo pixel stride: conflict-free A loads
constexpr int IS = MC + 8;         // split ib_w row stride: conflict-free B loads
constexpr int PS = CMAX + 8;       // split pl_w row stride: conflict-free B loads
constexpr size_t MAX_SMEM = 232448;

static_assert(TW == 16, "a tile row is one m16 tile of the project");
static_assert(TH <= NWARPS, "one project m16 tile a warp");
static_assert(THREADS == MC * 2 * 16, "depthwise: (channel, row < 16, 8-column half)");
static_assert(IS % 32 == 24 && PS % 32 == 8 && DS % 8 == 4 && MS % 16 == 8, "bank maps");

template <int KS>
struct Geo {
  static constexpr int P = KS / 2;
  static constexpr int HH = TH + 2 * P;
  static constexpr int HWD = TW + 2 * P;
  static constexpr int HP = HH * HWD;                 // halo pixels
  static constexpr int HMT = (HP + 15) / 16;          // expand m16 tiles
  static constexpr int HPP = HMT * 16;                // padded halo pixels
  static constexpr int TAPS = KS * KS;
};

// shared-memory carve-up, in floats; every region starts 16-byte aligned
struct Layout {
  int xs, mids, dwo, rib, rpl, rdw, rib_b, rdw_b, ibw_b, ibw_s, plw_b, plw_s, total;
  __host__ __device__ Layout(int HPP, int XS, int TAPS) {
    int o = 0;
    xs = o;    o += HPP * XS;       // [HPP][XS]     halo of x
    mids = o;  o += HPP * MS;       // [HPP][MS]     expand output
    dwo = o;   o += TP * DS;        // [TP][DS]      depthwise output
    rib = o;   o += CMAX * MC;      // [C][MC]       ib_w chunk as copied
    rpl = o;   o += MC * CMAX;      // [MC][C]       pl_w chunk as copied
    rdw = o;   o += 2 * TAPS * MC;  // 2 x [TAPS][MC] dw_w, by chunk parity
    rib_b = o; o += 2 * MC;         // 2 x [MC]       ib_b
    rdw_b = o; o += 2 * MC;         // 2 x [MC]       dw_b
    ibw_b = o; o += CMAX * IS;      // [C][IS]  ib_w split: big
    ibw_s = o; o += CMAX * IS;      //                      small
    plw_b = o; o += MC * PS;        // [MC][PS] pl_w split: big
    plw_s = o; o += MC * PS;        //                      small
    total = o;
  }
};

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// 16 bytes, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, zero-filled when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v = big + small (+ ~2^-22 v), both rounded to TF32 to nearest with ties
// away from zero, as cvt.rna.tf32.f32 rounds: half of the 13 dropped bits'
// unit is added to the magnitude. big's dropped bits are cleared, since
// v - big needs its exact value; small's are left, since an MMA reads only
// the top 19 bits of a TF32 operand. Two integer operations a value, where
// cvt.rna compiles to four (it also tests for infinity and NaN).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) + 0x1000u;
}

// d += a * b on one 16x8x8 tile: a (row-major 16x8), b (col-major 8x8)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the A fragment of one m16k8 step from a row-major tile at `p` (row g,
// column t of the fragment), rows `stride` floats apart, split big / small
__device__ __forceinline__ void load_a(const float* p, int stride, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  split_tf32(p[0], ab[0], as[0]);               // (g, t)
  split_tf32(p[8 * stride], ab[1], as[1]);      // (g + 8, t)
  split_tf32(p[4], ab[2], as[2]);               // (g, t + 4)
  split_tf32(p[8 * stride + 4], ab[3], as[3]);  // (g + 8, t + 4)
}

// the B fragment of one k8n8 step from split row-major [k][n] tiles at
// offset `o` (row t, column g), rows `stride` floats apart
__device__ __forceinline__ void load_b(const float* big, const float* small, int o,
                                       int stride, uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  bb[0] = __float_as_uint(big[o]);               // (k t, n g)
  bb[1] = __float_as_uint(big[o + 4 * stride]);  // (k t + 4, n g)
  bs[0] = __float_as_uint(small[o]);
  bs[1] = __float_as_uint(small[o + 4 * stride]);
}

// one k8 step's three products for NM m16 tiles x NN n8 tiles, into zeroed
// partial tiles added to the float32 sums `acc` (each term over all tiles
// before the next: independent MMAs)
template <int NM, int NN>
__device__ __forceinline__ void mma3(float (&acc)[NM][NN][4], const uint32_t (&ab)[NM][4],
                                     const uint32_t (&as)[NM][4], const uint32_t (&bb)[NN][2],
                                     const uint32_t (&bs)[NN][2]) {
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

// the expand of NM halo m16 tiles (mt0, mt0 + NWARPS, ...) by the chunk's
// 16 mid channels, then + bias, relu6, zero outside the image and outside
// the valid rows [row_lo, row_hi) (within [0, H)), into mids
template <int KS, int NM>
__device__ __forceinline__ void expand(const float* xs, int XS, int nk8, const float* ibw_b,
                                       const float* ibw_s, const float* ibb, float* mids,
                                       int mt0, int h0, int w0, int row_lo, int row_hi, int W,
                                       int g, int t) {
  using G = Geo<KS>;
  float e[NM][2][4];
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) e[i][n][q] = 0.f;
#pragma unroll
  for (int k8 = 0; k8 < CMAX / 8; ++k8) {
    if (k8 >= nk8) break;
    uint32_t ab[NM][4], as[NM][4], bb[2][2], bs[2][2];
#pragma unroll
    for (int i = 0; i < NM; ++i)
      load_a(xs + ((mt0 + i * NWARPS) * 16 + g) * XS + k8 * 8 + t, XS, ab[i], as[i]);
#pragma unroll
    for (int n = 0; n < 2; ++n)
      load_b(ibw_b, ibw_s, (k8 * 8 + t) * IS + n * 8 + g, IS, bb[n], bs[n]);
    mma3<NM, 2>(e, ab, as, bb, bs);
  }
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int hp = (mt0 + i * NWARPS) * 16 + g + 8 * half;
      if (hp >= G::HP) continue;
      const int gh = h0 - G::P + hp / G::HWD, gw = w0 - G::P + hp % G::HWD;
      const bool inside = gh >= row_lo && gh < row_hi && gw >= 0 && gw < W;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = n * 8 + 2 * t;
        float2 v = make_float2(0.f, 0.f);
        if (inside) {
          v.x = relu6f(e[i][n][2 * half] + ibb[col]);
          v.y = relu6f(e[i][n][2 * half + 1] + ibb[col + 1]);
        }
        *reinterpret_cast<float2*>(mids + hp * MS + col) = v;
      }
    }
}

template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
mbconv_kernel(const float* __restrict__ x, const float* __restrict__ ib_w,
              const float* __restrict__ ib_b, const float* __restrict__ dw_w,
              const float* __restrict__ dw_b, const float* __restrict__ pl_w,
              const float* __restrict__ pl_b, float* __restrict__ out, int H, int W,
              int C, int M, int residual, int row_lo, int row_hi, int tiles_w, int vec_x,
              int vec_w) {
  using G = Geo<KS>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int CP = (C + 7) & ~7;  // C zero-padded to whole k8 / n8 steps
  const int XS = CP + 4;        // halo pixel stride: conflict-free A loads
  const Layout L(G::HPP, XS, G::TAPS);
  float* xs = sm + L.xs;
  float* mids = sm + L.mids;
  float* dwo = sm + L.dwo;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * H * W * C;

  // the x halo: zeros outside the image, past C, and on the padding rows
  if (vec_x) {
    const int q = CP / 4;
    for (int i = tid; i < G::HPP * q; i += THREADS) {
      const int hp = i / q, ci = (i % q) * 4;
      const int gh = h0 - G::P + hp / G::HWD, gw = w0 - G::P + hp % G::HWD;
      const bool ok = hp < G::HP && gh >= 0 && gh < H && gw >= 0 && gw < W && ci < C;
      cp_async16(xs + hp * XS + ci, ok ? xb + ((size_t)gh * W + gw) * C + ci : x, ok);
    }
  } else {
    for (int i = tid; i < G::HPP * CP; i += THREADS) {
      const int hp = i / CP, ci = i % CP;
      const int gh = h0 - G::P + hp / G::HWD, gw = w0 - G::P + hp % G::HWD;
      const bool ok = hp < G::HP && gh >= 0 && gh < H && gw >= 0 && gw < W && ci < C;
      cp_async4(xs + hp * XS + ci, ok ? xb + ((size_t)gh * W + gw) * C + ci : x, ok);
    }
  }

  // chunk j's weights as they are in memory: ib_w and pl_w into the one
  // copy buffer, dw_w and the biases into slot j & 1; mid channels past M
  // (and ib_w rows / pl_w columns past C) are zeros
  auto stage = [&](int j) {
    const int m0 = j * MC, s = j & 1;
    float* rib = sm + L.rib;
    float* rpl = sm + L.rpl;
    float* rdw = sm + L.rdw + s * G::TAPS * MC;
    float* ibb = sm + L.rib_b + s * MC;
    float* dwb = sm + L.rdw_b + s * MC;
    if (vec_w) {  // M % 4 == 0: every 4-run is all in or all out
      for (int i = tid; i < CP * (MC / 4); i += THREADS) {
        const int ci = i / (MC / 4), mm = (i % (MC / 4)) * 4, m = m0 + mm;
        const bool ok = ci < C && m < M;
        cp_async16(rib + ci * MC + mm, ok ? ib_w + (size_t)ci * M + m : ib_w, ok);
      }
      for (int i = tid; i < MC * (CP / 4); i += THREADS) {
        const int mm = i / (CP / 4), co = (i % (CP / 4)) * 4, m = m0 + mm;
        const bool ok = co < C && m < M;
        cp_async16(rpl + mm * CP + co, ok ? pl_w + (size_t)m * C + co : pl_w, ok);
      }
      for (int i = tid; i < G::TAPS * (MC / 4); i += THREADS) {
        const int tap = i / (MC / 4), mm = (i % (MC / 4)) * 4, m = m0 + mm;
        const bool ok = m < M;
        cp_async16(rdw + tap * MC + mm, ok ? dw_w + (size_t)tap * M + m : dw_w, ok);
      }
      if (tid < MC / 4) {
        const int mm = tid * 4, m = m0 + mm;
        cp_async16(ibb + mm, m < M ? ib_b + m : ib_b, m < M);
      } else if (tid < MC / 2) {
        const int mm = (tid - MC / 4) * 4, m = m0 + mm;
        cp_async16(dwb + mm, m < M ? dw_b + m : dw_b, m < M);
      }
    } else {
      for (int i = tid; i < CP * MC; i += THREADS) {
        const int ci = i / MC, mm = i % MC, m = m0 + mm;
        const bool ok = ci < C && m < M;
        cp_async4(rib + i, ok ? ib_w + (size_t)ci * M + m : ib_w, ok);
      }
      for (int i = tid; i < MC * CP; i += THREADS) {
        const int mm = i / CP, co = i % CP, m = m0 + mm;
        const bool ok = co < C && m < M;
        cp_async4(rpl + i, ok ? pl_w + (size_t)m * C + co : pl_w, ok);
      }
      for (int i = tid; i < G::TAPS * MC; i += THREADS) {
        const int tap = i / MC, mm = i % MC, m = m0 + mm;
        const bool ok = m < M;
        cp_async4(rdw + i, ok ? dw_w + (size_t)tap * M + m : dw_w, ok);
      }
      if (tid < MC) {
        const int m = m0 + tid;
        cp_async4(ibb + tid, m < M ? ib_b + m : ib_b, m < M);
      } else if (tid < 2 * MC) {
        const int m = m0 + tid - MC;
        cp_async4(dwb + tid - MC, m < M ? dw_b + m : dw_b, m < M);
      }
    }
  };
  // the copied ib_w / pl_w chunk split into big and small once, for every
  // warp's B fragments
  auto split_ibw = [&]() {
    for (int i = tid; i < CP * MC; i += THREADS) {
      uint32_t bg, sl;
      split_tf32(sm[L.rib + i], bg, sl);
      const int o = (i / MC) * IS + i % MC;
      sm[L.ibw_b + o] = __uint_as_float(bg);
      sm[L.ibw_s + o] = __uint_as_float(sl);
    }
  };
  auto split_plw = [&]() {
    for (int i = tid; i < MC * CP; i += THREADS) {
      uint32_t bg, sl;
      split_tf32(sm[L.rpl + i], bg, sl);
      const int o = (i / CP) * PS + i % CP;
      sm[L.plw_b + o] = __uint_as_float(bg);
      sm[L.plw_s + o] = __uint_as_float(sl);
    }
  };

  // the project's accumulators: tile row `warp`, n8 tile 4*n4 + n, as the
  // MMA lays out C (pixel g or g + 8, channel (4*n4 + n)*8 + 2t + {0, 1})
  const int nk8 = CP / 8;
  float acc[CMAX / 32][1][4][4];
#pragma unroll
  for (int n4 = 0; n4 < CMAX / 32; ++n4)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n4][0][n][q] = 0.f;

  stage(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  split_ibw();
  const int n_chunks = (M + MC - 1) / MC;
  for (int j = 0; j < n_chunks; ++j) {
    __syncthreads();  // chunk j's split ib_w; chunk j-1's project is done

    // (1) the expand of chunk j over the halo, two m16 tiles a warp where
    // there are two; pl_w of chunk j split for the project
    {
      const float* ibb = sm + L.rib_b + (j & 1) * MC;
      for (int mt = warp; mt < G::HMT; mt += 2 * NWARPS) {
        if (mt + NWARPS < G::HMT)
          expand<KS, 2>(xs, XS, nk8, sm + L.ibw_b, sm + L.ibw_s, ibb, mids, mt, h0, w0,
                        row_lo, row_hi, W, g, t);
        else
          expand<KS, 1>(xs, XS, nk8, sm + L.ibw_b, sm + L.ibw_s, ibb, mids, mt, h0, w0,
                        row_lo, row_hi, W, g, t);
      }
      split_plw();
    }
    __syncthreads();  // mids and the split pl_w written; the copy buffer is free

    // chunk j+1's weights, behind the depthwise
    if (j + 1 < n_chunks) stage(j + 1);
    cp_async_commit();

    // (2) depthwise + bias + relu6: channel c, tile row r, 8 columns
    {
      const int c = tid & (MC - 1), u = tid >> 4;
      const int r = u & 15, c0 = (u >> 4) * 8;
      if (r < TH) {
        const float* dww = sm + L.rdw + (j & 1) * G::TAPS * MC + c;
        const float* mrow = mids + (r * G::HWD + c0) * MS + c;
        float d[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = 0.f;
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          float seg[8 + KS - 1];
#pragma unroll
          for (int i = 0; i < 8 + KS - 1; ++i) seg[i] = mrow[(dy * G::HWD + i) * MS];
#pragma unroll
          for (int dx = 0; dx < KS; ++dx) {
            const float wv = dww[(dy * KS + dx) * MC];
#pragma unroll
            for (int i = 0; i < 8; ++i) d[i] = fmaf(seg[i + dx], wv, d[i]);
          }
        }
        const float bv = sm[L.rdw_b + (j & 1) * MC + c];
#pragma unroll
        for (int i = 0; i < 8; ++i) dwo[(r * TW + c0 + i) * DS + c] = relu6f(d[i] + bv);
      }
    }
    cp_async_wait_all();  // chunk j+1's weights landed
    __syncthreads();      // ... for all; dwo written

    // (3) chunk j's share of the project, tile row `warp`; chunk j+1's
    // ib_w split for the next expand
    if (warp < TH) {
      const float* da = dwo + (warp * TW + g) * DS + t;
#pragma unroll
      for (int k8 = 0; k8 < MC / 8; ++k8) {
        uint32_t ab[1][4], as[1][4];
        load_a(da + k8 * 8, DS, ab[0], as[0]);
#pragma unroll
        for (int n4 = 0; n4 < CMAX / 32; ++n4) {
          if (n4 * 4 >= nk8) break;
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n)
            load_b(sm + L.plw_b, sm + L.plw_s, (k8 * 8 + t) * PS + (n4 * 4 + n) * 8 + g, PS,
                   bb[n], bs[n]);
          mma3<1, 4>(acc[n4], ab, as, bb, bs);
        }
      }
    }
    if (j + 1 < n_chunks) split_ibw();
  }

  // epilogue: bias, residual from the staged halo, straight from the
  // accumulators (C % 4 == 0, so each float2 is 8-byte aligned)
  const int h = h0 + warp;
  if (warp >= TH || h >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = g + 8 * half, wq = w0 + col;
    if (wq >= W) continue;
    float* dst = out + (((size_t)b * H + h) * W + wq) * C;
    const float* xr = xs + ((warp + G::P) * G::HWD + col + G::P) * XS;
#pragma unroll
    for (int n = 0; n < CMAX / 8; ++n) {
      const int co = n * 8 + 2 * t;
      if (co >= C) break;
      const float* a = acc[n / 4][0][n % 4];
      float2 v = make_float2(a[2 * half] + pl_b[co], a[2 * half + 1] + pl_b[co + 1]);
      if (residual) {
        v.x += xr[co];
        v.y += xr[co + 1];
      }
      *reinterpret_cast<float2*>(dst + co) = v;
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// dynamic shared memory of a launch with C channels (bytes)
template <int KS>
size_t smem_bytes(int C) {
  using G = Geo<KS>;
  return (size_t)Layout(G::HPP, ((C + 7) & ~7) + 4, G::TAPS).total * sizeof(float);
}

template <int KS>
int launch(const float* x, const float* ib_w, const float* ib_b, const float* dw_w,
           const float* dw_b, const float* pl_w, const float* pl_b, float* out, int B,
           int H, int W, int C, int M, int residual, int row_lo, int row_hi,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<KS>(C);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mbconv_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long tiles_w = (W + TW - 1) / TW;
  const long long tiles = (H + TH - 1) / TH * tiles_w;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec_x = aligned16(x);
  const int vec_w = M % 4 == 0 && aligned16(ib_w) && aligned16(ib_b) && aligned16(dw_w) &&
                    aligned16(dw_b) && aligned16(pl_w);
  mbconv_kernel<KS><<<dim3((unsigned)tiles, B), THREADS, bytes, stream>>>(
      x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out, H, W, C, M, residual, row_lo, row_hi,
      (int)tiles_w, vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

// row_lo, row_hi: the valid rows [row_lo, row_hi) of x (0 <= row_lo,
// row_hi <= H; (0, H) is the whole image): the mid activation is zeroed
// outside them, as the depthwise's zero padding is outside the image
extern "C" int ofa_mbconv_f32(const float* x, const float* ib_w,
                              const float* ib_b, const float* dw_w,
                              const float* dw_b, const float* pl_w,
                              const float* pl_b, float* out, int B, int H,
                              int W, int C, int M, int ks, int residual,
                              int row_lo, int row_hi, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || M <= 0 || C <= 0 ||
      C > CMAX || C % 4 != 0 || ((uintptr_t)out & 7) || row_lo < 0 ||
      row_hi > H)
    return (int)cudaErrorInvalidValue;  // B is grid.y; out is stored as float2
  cudaStream_t s = (cudaStream_t)stream;
  switch (ks) {
    case 3: return launch<3>(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out, B, H, W, C, M, residual,
                             row_lo, row_hi, s);
    case 5: return launch<5>(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out, B, H, W, C, M, residual,
                             row_lo, row_hi, s);
    case 7: return launch<7>(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out, B, H, W, C, M, residual,
                             row_lo, row_hi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the dynamic shared memory a launch takes (bytes), 0 for a k or C the
// kernel does not take
extern "C" int ofa_mbconv_smem_bytes(int C, int ks) {
  if (C <= 0 || C > CMAX || C % 4 != 0) return 0;
  switch (ks) {
    case 3: return (int)smem_bytes<3>(C);
    case 5: return (int)smem_bytes<5>(C);
    case 7: return (int)smem_bytes<7>(C);
    default: return 0;
  }
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
