// The masked depthwise convolution of the graphed training step, for
// sm_90a, on float32 or bfloat16 NHWC activations: forward, dgrad (dx) and a
// deterministic wgrad (dW), each reading the sampled kernel size and the
// channel bound from the device.
//
// Replaces no Pallas kernel. It is the port's form of the JAX package's
// depthwise levers in the masked MBConv, which are XLA ops there
// (ofa_sr_tpu/models/layers.py:248-288 `_dw_switched`, and :425-442 the
// `ks_switch` branch of `_masked_mbconv_apply`): `lax.switch` over one
// depthwise branch per (kernel size, middle width), so that the sampled
// subnet runs only its own k x k taps on its first `mid` channels. The
// masked step otherwise runs the depthwise at the bank's size K (7) over
// every channel, with the selected kernel zero-embedded at the centre of the
// K x K window. A CUDA graph cannot branch on a device value, so here one
// kernel reads the branch on the device:
//   ks_idx   (device int32): index into the sorted kernel sizes, passed as
//            host ints (n_ks, ks0..ks3); the kernel runs the k x k centre
//            taps of the bank, k = ks[ks_idx];
//   bound    (device int32): the channels below it run, the rest are
//            written 0.
// With x [N,H,W,C], w [C,1,K,K] (the selected candidate, K the bank size),
// stride s in {1, 2} and padding K//2 per side (the bank's, as the masked
// step pads; a k x k window at pad k//2 is the same conv):
//   forward: y[n,o,p,c]  = sum_{i,j<k} x[n, o*s-k/2+i, p*s-k/2+j, c]
//                                     * w[c, off+i, off+j]   (c < bound)
//            y = 0 for c >= bound;                          off = (K-k)/2
//   dgrad:   dx[n,h,v,c] = sum over the taps (i, j) and outputs (o, p) with
//            o*s-k/2+i = h, p*s-k/2+j = v of dy[n,o,p,c] * w[c,off+i,off+j]
//            (c < bound), 0 from the bound on;
//   wgrad:   dW[c,0,off+i,off+j] = sum_{n,o,p} x[n,o*s-k/2+i,p*s-k/2+j,c]
//                                              * dy[n,o,p,c]  (c < bound),
//            0 at every other tap and channel.
// That is the plain version `depthwise_conv2d(x * cmask, w * tapmask) *
// cmask` and its two gradients (ofa_sr_tpu_torch/ops/kernels/dw_masked.py).
// The nothing-above-the-bound rule is exact on the step's path: the masked
// BN writes 0 to the channels from `mid` on, so they carry nothing.
//
// Types. `_f32` entry points take float x, w, dy and write float y, dx, dW;
// `_bf16` ones take and write __nv_bfloat16 (the bf16 compute of the
// trainers casts the bank and the activations); both accumulate in float32
// and round a bf16 result once.
//
// What bounds it on the H100: bytes, at the sampled work. A direction reads
// its live channels (below the bound) once and writes its whole output
// (zeros from the bound on). At the S4 step's C 384 that is 4 (float32) or
// 2 (bf16) bytes read and written an output channel against at most 49
// FMAs; over the step's mix of (k, mid) the FMAs at the FP32 pipe's 67
// TFLOP/s take about half the time of the bytes at 3.35 TB/s in bf16 and
// a quarter in float32. The arithmetic still has to keep up: every FMA is
// fed from shared memory, and the loads (with bf16's two conversions a
// loaded pair) share the FMAs' issue slots; the layout below keeps them few.
//
// Design, against the first form of this kernel (which re-read each input
// row through L1, one channel a thread, gathered the stride-2 dgrad with
// parity tests and reduced the wgrad with two barriers a tap):
//   1. Shared-memory halo tiles. A block takes a channel group and walks a
//      run of output tiles (TH rows x TW = 16 columns of one image). For
//      each it stages the input window under the tile, ((TH-1)*s+k) x
//      ((TW-1)*s+k) pixels of the group, into shared memory, zero-filled
//      outside the image (that is the padding), double-buffered: the next
//      tile's copy is issued before this tile's FMAs and runs under them.
//      The copy is one TMA box a tile (a tensor map a kernel size over the
//      NHWC tensor, built by the host; its out-of-bounds fill is the
//      padding), counted on an mbarrier a buffer. Where TMA cannot take the
//      tensor (pixel rows not a multiple of 16 bytes, a pointer not 16-byte
//      aligned, a window larger than the image) the block's threads stage
//      it with cp.async instead: 16-, 4- or 2-byte pieces. A thread keeps
//      its channels' k x k taps in registers, loaded once a block, and
//      computes a strip of RH rows x SW = 8 columns of outputs: each staged
//      value it loads feeds every output of the strip whose window holds
//      it, RH*SW*k*k FMAs for ((RH-1)*s+k)*((SW-1)*s+k) loads (7 an FMA-load
//      at k 7 and RH 2, where the first form had 4). Forward and stride-1
//      dgrad (the same correlation over dy, the taps flipped) share this
//      code.
//   2. A group is 128 bytes of a pixel: 32 float32 or 64 bf16 channels. A
//      float32 thread takes one channel, a bf16 thread two
//      (__nv_bfloat162), so a warp's shared-memory load is one 128-byte
//      wavefront and its store a full 128-byte line in both types, and
//      bf16 issues half the loads of float32 a channel. Odd-C bf16 stores
//      go one value at a time.
//   3. The stride-2 dgrad is branch-free. dx splits by the parity (ph, pv)
//      of its pixel into four classes; each class is a dense stride-1
//      correlation of dy with a fixed sub-grid of the taps, rows i = i0 +
//      2t (i0 = (ph + k/2) & 1, ceil((k - i0)/2) rows) and the columns
//      likewise: dx[2a+ph, 2b+pv] = sum_{t,u} dy[a+ci-t, b+cj-u] *
//      w[i0+2t, j0+2u], ci = (ph + k/2 - i0)/2. A block stages the dy
//      window under a 16 x 32 dx tile, and each of its four warps runs one
//      class with its sub-kernel (at most 4 x 4 taps) in registers: every
//      loaded value feeds an FMA, and no tap is tested for parity.
//   4. The wgrad's pass 1 walks its tiles as (1) does, staging each tile's
//      x window and dy tile (two TMA boxes on one mbarrier), each thread
//      summing its channels' k x k products over its strips in registers.
//      The block reduces once at the end: every warp writes its sums to
//      shared memory, one barrier, then the threads split the (tap,
//      channel) pairs and add the warps in order.
// Shared memory a block, at K 7: forward and stride-1 dgrad 78,976 bytes
// (stride-2 forward 85,376), stride-2 dgrad 53,632, wgrad pass 1 111,744
// (stride 2: 93,568): a 128-byte head (the mbarriers) and two buffers.
// Above 48 KB, so each launch sets cudaFuncAttributeMaxDynamicSharedMemorySize;
// two blocks (8 warps) an SM.
// The kernel size is read once a block and dispatched to code unrolled for
// it (k in {1, 3, 5, 7}, k <= K), so a k = 3 subnet runs 9 taps, not 49.
// Blocks whose channels all lie at or past the bound write their zeros (the
// wgrad's exit) and load nothing else. Every direction takes its runs of
// tiles from the caller (`per` tiles a block, G blocks), chosen from the
// shapes alone. The wgrad runs in two passes with no atomics, so two
// launches give the same bits:
//   pass 1: block (group, g) sums the tiles [g*per, (g+1)*per) for its
//           channels and writes partial[g][tap][c] (tap in K x K
//           numbering) below the bound;
//   pass 2: one thread a (tap, c) of dW adds its G partials in order, or
//           writes 0 outside the window or from the bound on.
// The workspace (G*K*K*C floats) is allocated by the caller. Each entry
// point returns cudaGetLastError() after its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps a block
constexpr int NW = THREADS / 32;
constexpr int SW = 8;         // output columns a strip (one thread's)
constexpr int TW = 16;        // output columns a tile: 2 strips
constexpr int PB = 128;       // bytes of a staged pixel: one channel group
constexpr int DA = 8, DB = 16;  // stride-2 dgrad: a parity class's rows and columns a tile
constexpr int SMEM_STATIC = 48 * 1024;

// a tile's output rows and a strip's (one thread's), by stride: forward
// and stride-1 dgrad (CORR, RH), wgrad (WGRAD, WRH); the stride-2 dgrad's
// class strips are one class row
template <int S>
struct Tile {
  static constexpr int CORR = S == 1 ? 8 : 2, RH = S == 1 ? 2 : 1;
  static constexpr int WGRAD = S == 1 ? 8 : 2, WRH = S == 1 ? 2 : 1;
};

// one thread's channels of a staged pixel (4 bytes at lane * 4), and its
// store of them to device memory
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int VC = 1;
  static __device__ __forceinline__ void get(const unsigned char* p, float (&v)[1]) {
    v[0] = *reinterpret_cast<const float*>(p);
  }
  // n: the channels from this thread's first that lie below C
  static __device__ __forceinline__ void put(float* p, const float (&v)[1], int n, bool) {
    if (n > 0) *p = v[0];
  }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int VC = 2;
  static __device__ __forceinline__ void get(const unsigned char* p, float (&v)[2]) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    v[0] = __uint_as_float(u << 16);
    v[1] = __uint_as_float(u & 0xffff0000u);
  }
  // pair: the two channels may be stored as one aligned __nv_bfloat162
  static __device__ __forceinline__ void put(__nv_bfloat16* p, const float (&v)[2], int n,
                                             bool pair) {
    if (n >= 2 && pair) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    } else {
      if (n > 0) p[0] = __float2bfloat16_rn(v[0]);
      if (n > 1) p[1] = __float2bfloat16_rn(v[1]);
    }
  }
};

struct KsTable {
  int n;
  int ks[4];
};

struct Geom {
  int N, H, W, C, Ho, Wo;
};

// what a launch's blocks share: the tiles a block walks, the copy unit
// (16, 4 or 2 bytes), whether two bf16 channels store as one pair, and
// whether the tensor maps below stage the tiles (else cp.async does)
struct Launch {
  int per, unit, pair, tma;
};

// TMA tensor maps over the NHWC source, one a kernel size of the table
// (the box is the window k needs), and over dy for the wgrad's tile
struct Maps {
  CUtensorMap src[4];
  CUtensorMap dy;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the selected kernel size's index (an index out of range is clamped, as
// lax.switch clamps its index) and the channel bound, clamped to [0, C]
__device__ __forceinline__ int selected(const int* ks_idx, const KsTable& t) {
  const int i = *ks_idx;
  return i < 0 ? 0 : (i >= t.n ? t.n - 1 : i);
}

__device__ __forceinline__ int channel_bound(const int* bound, int C) {
  const int b = *bound;
  return b < 0 ? 0 : (b > C ? C : b);
}

// run BODY with the compile-time kernel size kk = k (odd, <= K); a k the
// bank cannot hold runs nothing (the wrapper refuses it on the host)
#define DW_WITH_K(K, k, BODY)                      \
  switch (k) {                                     \
    case 1: { constexpr int kk = 1; BODY; } break; \
    case 3:                                        \
      if constexpr (K >= 3) { constexpr int kk = 3; BODY; } \
      break;                                       \
    case 5:                                        \
      if constexpr (K >= 5) { constexpr int kk = 5; BODY; } \
      break;                                       \
    case 7:                                        \
      if constexpr (K >= 7) { constexpr int kk = 7; BODY; } \
      break;                                       \
    default: break;                                \
  }

// -- staging --------------------------------------------------------------

// 16 or 4 bytes, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// an mbarrier a buffer: one arrival (the issuing thread's) plus the bytes
// of its TMA copies
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
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
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A buffer's next copies, `bytes` in all, are to be counted on bar. The
// issuing thread first orders the threads' earlier reads of the buffer
// (ended by a barrier) before the copies' writes.
__device__ __forceinline__ void tma_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(bar, bytes);
}

// the box of `map` at (channel c, column v, row h, image n) into dst,
// counted on bar; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int v, int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(v), "r"(h), "r"(n)
      : "memory");
}

// A block's dynamic shared memory: the two buffers' mbarriers, then the
// buffers from byte 128 (TMA writes 128-byte aligned boxes).
constexpr int SMEM_HEAD = 128;

__device__ __forceinline__ uint64_t* block_bars(unsigned char* smem) {
  return reinterpret_cast<uint64_t*>(smem);
}

__device__ __forceinline__ void init_bars(unsigned char* smem, bool tma) {
  if (tma && threadIdx.x == 0) {
    mbar_init(block_bars(smem));
    mbar_init(block_bars(smem) + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// What a block copies of each pixel: `bytes` bytes (its live channels,
// rounded up to the unit) from byte `cb` of the pixel's `pix` bytes.
struct Span {
  int pix, cb, bytes, unit;
};

// Copy the ROWS x COLS pixel window at (h0, v0) of one H x W image `img`
// into shared memory [ROWS][COLS][PB]; a pixel outside the image is zero.
template <int UNIT, int ROWS, int COLS>
__device__ __forceinline__ void stage_units(unsigned char* dst, const unsigned char* img, int H,
                                            int W, const Span& sp, int h0, int v0) {
  constexpr int UPP = PB / UNIT;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * COLS * UPP; i += THREADS) {
    const int off = (i % UPP) * UNIT, pix = i / UPP;
    if (off >= sp.bytes) continue;
    const int h = h0 + pix / COLS, v = v0 + pix % COLS;
    const bool in = (unsigned)h < (unsigned)H && (unsigned)v < (unsigned)W;
    const unsigned char* s = in ? img + ((size_t)h * W + v) * sp.pix + sp.cb + off : img;
    unsigned char* d = dst + pix * PB + off;
    if constexpr (UNIT == 16) {
      cp16(d, s, in);
    } else if constexpr (UNIT == 4) {
      cp4(d, s, in);
    } else {
      *reinterpret_cast<unsigned short*>(d) =
          in ? *reinterpret_cast<const unsigned short*>(s) : (unsigned short)0;
    }
  }
}

template <int ROWS, int COLS>
__device__ __forceinline__ void stage(unsigned char* dst, const unsigned char* img, int H, int W,
                                      const Span& sp, int h0, int v0) {
  if (sp.unit == 16)
    stage_units<16, ROWS, COLS>(dst, img, H, W, sp, h0, v0);
  else if (sp.unit == 4)
    stage_units<4, ROWS, COLS>(dst, img, H, W, sp, h0, v0);
  else
    stage_units<2, ROWS, COLS>(dst, img, H, W, sp, h0, v0);
}

// the block's copy: its live channels of group c0 (b the bound, b > c0)
template <typename T>
__device__ __forceinline__ Span group_span(int C, int c0, int b, int unit) {
  constexpr int CG = 32 * Lane<T>::VC;
  const int live = min(b - c0, CG) * (int)sizeof(T);
  return Span{C * (int)sizeof(T), c0 * (int)sizeof(T), (live + unit - 1) / unit * unit, unit};
}

template <typename T>
__device__ __forceinline__ const unsigned char* image(const T* p, int n, int H, int W, int C) {
  return reinterpret_cast<const unsigned char*>(p + (size_t)n * H * W * C);
}

// The tiles [t0, t1) of a block, double-buffered: tile t+1's copies are
// issued before tile t's arithmetic and run under it. stage(t, buf, bar)
// issues tile t's copies into buf (TMA: counted on bar), compute(t, buf)
// reads it.
template <int STAGE, typename Stage, typename Compute>
__device__ __forceinline__ void walk_tiles(int t0, int t1, unsigned char* smem, bool tma,
                                           const Stage& stage_tile, const Compute& compute) {
  unsigned char* bufs = smem + SMEM_HEAD;
  uint64_t* bars = block_bars(smem);
  if (t0 < t1) stage_tile(t0, bufs, bars);
  cp_commit();
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const int j = t - t0;
    if (t + 1 < t1) stage_tile(t + 1, bufs + (j + 1) % 2 * STAGE, bars + (j + 1) % 2);
    cp_commit();
    cp_wait<1>();  // this tile's copies are in; the next one's may still run
    if (tma) mbar_wait(bars + j % 2, (j / 2) & 1);
    __syncthreads();
    compute(t, bufs + j % 2 * STAGE);
    __syncthreads();  // the buffer is free for the tile after next
  }
}

// tile t of a grid of tiles_h x tiles_w tiles an image: (image, row, column)
struct TileAt {
  int n, r0, q0;
  __device__ __forceinline__ TileAt(int t, int tiles_h, int tiles_w, int rows, int cols)
      : n(t / tiles_w / tiles_h), r0(t / tiles_w % tiles_h * rows), q0(t % tiles_w * cols) {}
};

// blocks past the bound: zeros over their tiles
template <typename T>
__device__ void zero_tiles(T* dst, int t0, int t1, int tiles_h, int tiles_w, int rows, int cols,
                           int Hd, int Wd, int C, int c0, bool pair) {
  constexpr int VC = Lane<T>::VC;
  const int c = c0 + (threadIdx.x & 31) * VC;
  const float z[VC] = {};
  for (int t = t0; t < t1; ++t) {
    const TileAt at(t, tiles_h, tiles_w, rows, cols);
    for (int i = threadIdx.x >> 5; i < rows * cols; i += NW) {
      const int h = at.r0 + i / cols, v = at.q0 + i % cols;
      if (h < Hd && v < Wd)
        Lane<T>::put(dst + (((size_t)at.n * Hd + h) * Wd + v) * C + c, z, C - c, pair);
    }
  }
}

// -- forward and stride-1 dgrad ---------------------------------------------

// dst[n,o,p,c] = sum_{i,j<k} src[n, o*S-k/2+i, p*S-k/2+j, c] * w~[c,i,j] over
// the block's tiles: the forward (src x, dst y, w~ the centre taps) and at
// stride 1 the dgrad (src dy, dst dx, the taps flipped). A thread's strip
// is RH output rows x SW columns: each staged input value it loads feeds
// every output of the strip whose window holds it.
template <typename T, int K, int S, int k>
__device__ __forceinline__ void corr_tiles(const T* __restrict__ src, const T* __restrict__ w,
                                           T* __restrict__ dst, int N, int Hs, int Ws, int Hd,
                                           int Wd, int C, int c0, int b, bool flip,
                                           const Launch& ln, const CUtensorMap* map,
                                           unsigned char* smem) {
  constexpr int VC = Lane<T>::VC, TH = Tile<S>::CORR, RH = Tile<S>::RH, off = (K - k) / 2;
  constexpr int HR = (TH - 1) * S + k, WR = (TW - 1) * S + k;
  constexpr int SPAN = (SW - 1) * S + k, IR = (RH - 1) * S + k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + lane * VC;
  const int tiles_h = (Hd + TH - 1) / TH, tiles_w = (Wd + TW - 1) / TW;
  const int t0 = blockIdx.y * ln.per, t1 = min(t0 + ln.per, N * tiles_h * tiles_w);
  const Span sp = group_span<T>(C, c0, b, ln.unit);
  const auto stage_tile = [&](int t, unsigned char* buf, uint64_t* bar) {
    const TileAt at(t, tiles_h, tiles_w, TH, TW);
    if (!ln.tma)
      stage<HR, WR>(buf, image(src, at.n, Hs, Ws, C), Hs, Ws, sp, at.r0 * S - k / 2,
                    at.q0 * S - k / 2);
    else if (threadIdx.x == 0) {
      tma_expect(bar, HR * WR * PB);
      tma_load(buf, map, bar, c0, at.q0 * S - k / 2, at.r0 * S - k / 2, at.n);
    }
  };
  init_bars(smem, ln.tma);
  float wr[VC][k * k];
#pragma unroll
  for (int v = 0; v < VC; ++v) {
    const bool live = c + v < b;
    const T* wc = w + (size_t)(c + v) * K * K;
#pragma unroll
    for (int i = 0; i < k; ++i)
#pragma unroll
      for (int j = 0; j < k; ++j) {
        const int a = flip ? k - 1 - i : i, bb = flip ? k - 1 - j : j;
        wr[v][i * k + j] = live ? ld(wc + (off + a) * K + off + bb) : 0.f;
      }
  }
  walk_tiles<HR * WR * PB>(t0, t1, smem, ln.tma, stage_tile, [&](int t, const unsigned char* buf) {
    const TileAt at(t, tiles_h, tiles_w, TH, TW);
#pragma unroll 1
    for (int q = warp; q < TH / RH * (TW / SW); q += NW) {
      const int r = q / (TW / SW) * RH, s0 = q % (TW / SW) * SW;
      const int o = at.r0 + r, p = at.q0 + s0;
      if (o >= Hd || p >= Wd) continue;
      float acc[RH][SW][VC];
#pragma unroll
      for (int rr = 0; rr < RH; ++rr)
#pragma unroll
        for (int e = 0; e < SW; ++e)
#pragma unroll
          for (int v = 0; v < VC; ++v) acc[rr][e][v] = 0.f;
#pragma unroll
      for (int qr = 0; qr < IR; ++qr) {
        const unsigned char* row = buf + lane * 4 + ((r * S + qr) * WR + s0 * S) * PB;
#pragma unroll
        for (int u = 0; u < SPAN; ++u) {
          float xv[VC];
          Lane<T>::get(row + u * PB, xv);
#pragma unroll
          for (int rr = 0; rr < RH; ++rr) {
            const int i = qr - rr * S;
            if (i < 0 || i >= k) continue;
#pragma unroll
            for (int e = 0; e < SW; ++e) {
              const int j = u - e * S;
              if (j < 0 || j >= k) continue;
#pragma unroll
              for (int v = 0; v < VC; ++v)
                acc[rr][e][v] = fmaf(xv[v], wr[v][i * k + j], acc[rr][e][v]);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < RH; ++rr) {
        if (o + rr >= Hd) break;
        T* out = dst + (((size_t)at.n * Hd + o + rr) * Wd + p) * C + c;
#pragma unroll
        for (int e = 0; e < SW; ++e) {
          if (p + e >= Wd) break;
          float val[VC];
#pragma unroll
          for (int v = 0; v < VC; ++v) val[v] = c + v < b ? acc[rr][e][v] : 0.f;
          Lane<T>::put(out + (size_t)e * C, val, C - c, ln.pair != 0);
        }
      }
    }
  });
}

// blockIdx.x: the channel group; blockIdx.y: the run of tiles
// [y*per, (y+1)*per) of the Hd x Wd output
template <typename T, int K, int S>
__device__ __forceinline__ void corr_block(const T* src, const T* w, const int* ks_idx,
                                           const int* bound, T* dst, int N, int Hs, int Ws,
                                           int Hd, int Wd, int C, const KsTable& tab, bool flip,
                                           const Launch& ln, const Maps& maps,
                                           unsigned char* smem) {
  constexpr int TH = Tile<S>::CORR;
  const int c0 = blockIdx.x * 32 * Lane<T>::VC;
  const int b = channel_bound(bound, C);
  if (c0 >= b) {
    const int tiles_h = (Hd + TH - 1) / TH, tiles_w = (Wd + TW - 1) / TW;
    const int t0 = blockIdx.y * ln.per;
    zero_tiles(dst, t0, min(t0 + ln.per, N * tiles_h * tiles_w), tiles_h, tiles_w, TH, TW, Hd,
               Wd, C, c0, ln.pair != 0);
    return;
  }
  const int i = selected(ks_idx, tab);
  DW_WITH_K(K, tab.ks[i], (corr_tiles<T, K, S, kk>(src, w, dst, N, Hs, Ws, Hd, Wd, C, c0, b,
                                                   flip, ln, &maps.src[i], smem)))
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS, 2)
dw_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* ks_idx,
              const int* bound, T* __restrict__ y, const Geom g, const KsTable tab,
              const Launch ln, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  corr_block<T, K, S>(x, w, ks_idx, bound, y, g.N, g.H, g.W, g.Ho, g.Wo, g.C, tab, false, ln,
                      maps, smem);
}

// -- stride-2 dgrad: four dense parity classes -------------------------------

// class p (the parity of a dx row or column) at kernel size k: its first
// tap i0, its number of taps n, and the offset of its first dy row from a
// (dx row 2a+p reads dy rows a+base .. a+base+n-1 against taps
// i0+2(n-1) .. i0, descending)
#define HD __host__ __device__
HD constexpr int par_i0(int k, int p) { return (p + k / 2) & 1; }
HD constexpr int par_n(int k, int p) { return (k - par_i0(k, p) + 1) / 2; }
HD constexpr int par_base(int k, int p) {
  return (p + k / 2 - par_i0(k, p)) / 2 - par_n(k, p) + 1;
}
HD constexpr int cmin(int a, int b) { return a < b ? a : b; }
HD constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the dy rows (columns) a tile's classes read, relative to its first a
HD constexpr int par_lo(int k) {
  return par_n(k, 1) == 0 ? par_base(k, 0) : cmin(par_base(k, 0), par_base(k, 1));
}
HD constexpr int par_hi(int k) {
  return par_n(k, 1) == 0 ? par_base(k, 0) + par_n(k, 0) - 1
                          : cmax(par_base(k, 0) + par_n(k, 0) - 1,
                                 par_base(k, 1) + par_n(k, 1) - 1);
}
#undef HD

// one warp: dx[n, 2a+PH, 2b+PV, c] for the class's DA x DB pixels of the
// tile, in strips of SW class columns
template <typename T, int K, int k, int PH, int PV>
__device__ __forceinline__ void dgrad_s2_class(const float (&wr)[Lane<T>::VC][16],
                                               T* __restrict__ dx, const unsigned char* buf,
                                               int H, int W, int C, int n, int a0, int b0, int c,
                                               int b, bool pair) {
  constexpr int VC = Lane<T>::VC, NI = par_n(k, PH), NJ = par_n(k, PV);
  constexpr int DC = DB + par_hi(k) - par_lo(k);  // staged dy columns
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int q = 0; q < DA * (DB / SW); ++q) {
    const int r = q / (DB / SW), s0 = q % (DB / SW) * SW;
    const int h = 2 * (a0 + r) + PH;
    if (h >= H || 2 * (b0 + s0) + PV >= W) continue;
    float acc[SW][VC];
#pragma unroll
    for (int e = 0; e < SW; ++e)
#pragma unroll
      for (int v = 0; v < VC; ++v) acc[e][v] = 0.f;
    if constexpr (NI * NJ > 0) {  // k = 1 has no tap on an odd row or column
      constexpr int BI = par_base(k, PH) - par_lo(k), BJ = par_base(k, PV) - par_lo(k);
#pragma unroll
      for (int t = 0; t < NI; ++t) {
        const unsigned char* row = buf + lane * 4 + ((r + BI + t) * DC + s0 + BJ) * PB;
#pragma unroll
        for (int u = 0; u < SW + NJ - 1; ++u) {
          float xv[VC];
          Lane<T>::get(row + u * PB, xv);
#pragma unroll
          for (int e = 0; e < SW; ++e) {
            const int j = u - e;
            if (j < 0 || j >= NJ) continue;
#pragma unroll
            for (int v = 0; v < VC; ++v) acc[e][v] = fmaf(xv[v], wr[v][t * NJ + j], acc[e][v]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < SW; ++e) {
      const int vx = 2 * (b0 + s0 + e) + PV;
      if (vx >= W) break;
      float val[VC];
#pragma unroll
      for (int v = 0; v < VC; ++v) val[v] = c + v < b ? acc[e][v] : 0.f;
      Lane<T>::put(dx + (((size_t)n * H + h) * W + vx) * C + c, val, C - c, pair);
    }
  }
}

// the class's sub-kernel, the taps in the order its window reads dy
template <typename T, int K, int k, int PH, int PV>
__device__ __forceinline__ void class_taps(const T* __restrict__ w, int c, int b,
                                           float (&wr)[Lane<T>::VC][16]) {
  constexpr int NI = par_n(k, PH), NJ = par_n(k, PV), off = (K - k) / 2;
  constexpr int I0 = par_i0(k, PH), J0 = par_i0(k, PV);
#pragma unroll
  for (int v = 0; v < Lane<T>::VC; ++v) {
    const bool live = c + v < b;
    const T* wc = w + (size_t)(c + v) * K * K;
#pragma unroll
    for (int t = 0; t < NI; ++t)
#pragma unroll
      for (int u = 0; u < NJ; ++u)
        wr[v][t * NJ + u] =
            live ? ld(wc + (off + I0 + 2 * (NI - 1 - t)) * K + off + J0 + 2 * (NJ - 1 - u))
                 : 0.f;
  }
}

template <typename T, int K, int k>
__device__ __forceinline__ void dgrad_s2_tiles(const T* __restrict__ dy, const T* __restrict__ w,
                                               T* __restrict__ dx, const Geom& g, int c0, int b,
                                               const Launch& ln, const CUtensorMap* map,
                                               unsigned char* smem) {
  constexpr int LO = par_lo(k), HI = par_hi(k), DR = DA + HI - LO, DC = DB + HI - LO;
  const int tiles_a = (g.H + 2 * DA - 1) / (2 * DA), tiles_b = (g.W + 2 * DB - 1) / (2 * DB);
  const int t0 = blockIdx.y * ln.per, t1 = min(t0 + ln.per, g.N * tiles_a * tiles_b);
  const Span sp = group_span<T>(g.C, c0, b, ln.unit);
  const auto stage_tile = [&](int t, unsigned char* buf, uint64_t* bar) {
    const TileAt at(t, tiles_a, tiles_b, DA, DB);
    if (!ln.tma)
      stage<DR, DC>(buf, image(dy, at.n, g.Ho, g.Wo, g.C), g.Ho, g.Wo, sp, at.r0 + LO,
                    at.q0 + LO);
    else if (threadIdx.x == 0) {
      tma_expect(bar, DR * DC * PB);
      tma_load(buf, map, bar, c0, at.q0 + LO, at.r0 + LO, at.n);
    }
  };
  init_bars(smem, ln.tma);
  const int warp = threadIdx.x >> 5, c = c0 + (threadIdx.x & 31) * Lane<T>::VC;
  float wr[Lane<T>::VC][16];  // one parity class a warp: at most 4 x 4 taps
  switch (warp) {
    case 0: class_taps<T, K, k, 0, 0>(w, c, b, wr); break;
    case 1: class_taps<T, K, k, 0, 1>(w, c, b, wr); break;
    case 2: class_taps<T, K, k, 1, 0>(w, c, b, wr); break;
    default: class_taps<T, K, k, 1, 1>(w, c, b, wr); break;
  }
  walk_tiles<DR * DC * PB>(t0, t1, smem, ln.tma, stage_tile, [&](int t, const unsigned char* buf) {
    const TileAt at(t, tiles_a, tiles_b, DA, DB);
    const bool pair = ln.pair != 0;
#define DW_CLASS(PH, PV) \
  dgrad_s2_class<T, K, k, PH, PV>(wr, dx, buf, g.H, g.W, g.C, at.n, at.r0, at.q0, c, b, pair)
    switch (warp) {
      case 0: DW_CLASS(0, 0); break;
      case 1: DW_CLASS(0, 1); break;
      case 2: DW_CLASS(1, 0); break;
      default: DW_CLASS(1, 1); break;
    }
#undef DW_CLASS
  });
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS, 2)
dw_dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ w, const int* ks_idx,
                const int* bound, T* __restrict__ dx, const Geom g, const KsTable tab,
                const Launch ln, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (S == 1) {
    // stride 1: a correlation of dy with the flipped taps (Ho, Wo = H, W)
    corr_block<T, K, 1>(dy, w, ks_idx, bound, dx, g.N, g.Ho, g.Wo, g.H, g.W, g.C, tab, true, ln,
                        maps, smem);
  } else {
    // tile t: dx rows [2*a0, 2*a0 + 2*DA), columns [2*b0, 2*b0 + 2*DB)
    const int c0 = blockIdx.x * 32 * Lane<T>::VC;
    const int b = channel_bound(bound, g.C);
    if (c0 >= b) {
      const int tiles_a = (g.H + 2 * DA - 1) / (2 * DA);
      const int tiles_b = (g.W + 2 * DB - 1) / (2 * DB), t0 = blockIdx.y * ln.per;
      zero_tiles(dx, t0, min(t0 + ln.per, g.N * tiles_a * tiles_b), tiles_a, tiles_b, 2 * DA,
                 2 * DB, g.H, g.W, g.C, c0, ln.pair != 0);
      return;
    }
    const int i = selected(ks_idx, tab);
    DW_WITH_K(K, tab.ks[i], (dgrad_s2_tiles<T, K, kk>(dy, w, dx, g, c0, b, ln, &maps.src[i],
                                                      smem)))
  }
}

// -- wgrad ------------------------------------------------------------------

template <typename T, int K, int S, int k>
__device__ __forceinline__ void wgrad_tiles(const T* __restrict__ x, const T* __restrict__ dy,
                                            float* __restrict__ part, const Geom& g, int c0,
                                            int b, const Launch& ln, const CUtensorMap* xmap,
                                            const CUtensorMap* dymap, unsigned char* smem) {
  constexpr int VC = Lane<T>::VC, CG = 32 * VC, off = (K - k) / 2;
  constexpr int TH = Tile<S>::WGRAD, RH = Tile<S>::WRH;
  constexpr int HR = (TH - 1) * S + k, WR = (TW - 1) * S + k;
  constexpr int SPAN = (SW - 1) * S + k, IR = (RH - 1) * S + k;
  constexpr int XB = HR * WR * PB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles_h = (g.Ho + TH - 1) / TH, tiles_w = (g.Wo + TW - 1) / TW;
  const int t0 = blockIdx.y * ln.per, t1 = min(t0 + ln.per, g.N * tiles_h * tiles_w);
  const Span sp = group_span<T>(g.C, c0, b, ln.unit);
  const auto stage_tile = [&](int t, unsigned char* buf, uint64_t* bar) {
    const TileAt at(t, tiles_h, tiles_w, TH, TW);
    if (!ln.tma) {
      stage<HR, WR>(buf, image(x, at.n, g.H, g.W, g.C), g.H, g.W, sp, at.r0 * S - k / 2,
                    at.q0 * S - k / 2);
      stage<TH, TW>(buf + XB, image(dy, at.n, g.Ho, g.Wo, g.C), g.Ho, g.Wo, sp, at.r0, at.q0);
    } else if (threadIdx.x == 0) {
      tma_expect(bar, XB + TH * TW * PB);
      tma_load(buf, xmap, bar, c0, at.q0 * S - k / 2, at.r0 * S - k / 2, at.n);
      tma_load(buf + XB, dymap, bar, c0, at.q0, at.r0, at.n);
    }
  };
  init_bars(smem, ln.tma);
  float acc[VC][k * k];
#pragma unroll
  for (int v = 0; v < VC; ++v)
#pragma unroll
    for (int i = 0; i < k * k; ++i) acc[v][i] = 0.f;
  walk_tiles<XB + TH * TW * PB>(t0, t1, smem, ln.tma, stage_tile,
                                [&](int t, const unsigned char* buf) {
    const TileAt at(t, tiles_h, tiles_w, TH, TW);
#pragma unroll 1
    for (int q = warp; q < TH / RH * (TW / SW); q += NW) {
      const int r = q / (TW / SW) * RH, s0 = q % (TW / SW) * SW;
      if (at.r0 + r >= g.Ho || at.q0 + s0 >= g.Wo) continue;  // dy is 0 there
      float d[RH][SW][VC];
#pragma unroll
      for (int rr = 0; rr < RH; ++rr)
#pragma unroll
        for (int e = 0; e < SW; ++e)
          Lane<T>::get(buf + XB + ((r + rr) * TW + s0 + e) * PB + lane * 4, d[rr][e]);
#pragma unroll
      for (int qr = 0; qr < IR; ++qr) {
        const unsigned char* row = buf + lane * 4 + ((r * S + qr) * WR + s0 * S) * PB;
#pragma unroll
        for (int u = 0; u < SPAN; ++u) {
          float xv[VC];
          Lane<T>::get(row + u * PB, xv);
#pragma unroll
          for (int rr = 0; rr < RH; ++rr) {
            const int i = qr - rr * S;
            if (i < 0 || i >= k) continue;
#pragma unroll
            for (int e = 0; e < SW; ++e) {
              const int j = u - e * S;
              if (j < 0 || j >= k) continue;
#pragma unroll
              for (int v = 0; v < VC; ++v)
                acc[v][i * k + j] = fmaf(xv[v], d[rr][e][v], acc[v][i * k + j]);
            }
          }
        }
      }
    }
  });
  // one reduction a block: each warp's sums to shared memory, one barrier,
  // then a thread a (tap, channel) adds the warps in order
  float* red = reinterpret_cast<float*>(smem + SMEM_HEAD);
#pragma unroll
  for (int i = 0; i < k * k; ++i)
#pragma unroll
    for (int v = 0; v < VC; ++v) red[(warp * k * k + i) * CG + lane * VC + v] = acc[v][i];
  __syncthreads();
  const int live = min(b - c0, CG);
  for (int i = threadIdx.x; i < k * k * CG; i += THREADS) {
    const int tap = i / CG, cl = i % CG;
    if (cl >= live) continue;
    float s = red[tap * CG + cl];
#pragma unroll
    for (int l = 1; l < NW; ++l) s += red[(l * k * k + tap) * CG + cl];
    const int kt = (off + tap / k) * K + off + tap % k;
    part[((size_t)blockIdx.y * K * K + kt) * g.C + c0 + cl] = s;
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(THREADS, 2)
dw_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy, const int* ks_idx,
                        const int* bound, float* __restrict__ part, const Geom g,
                        const KsTable tab, const Launch ln, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = channel_bound(bound, g.C);
  const int c0 = blockIdx.x * 32 * Lane<T>::VC;
  if (c0 >= b) return;  // every channel of the block is past the bound
  const int i = selected(ks_idx, tab);
  DW_WITH_K(K, tab.ks[i], (wgrad_tiles<T, K, S, kk>(x, dy, part, g, c0, b, ln, &maps.src[i],
                                                    &maps.dy, smem)))
}

template <typename T, int K>
__global__ void __launch_bounds__(256)
dw_wgrad_finish_kernel(const float* __restrict__ part, const int* ks_idx, const int* bound,
                       T* __restrict__ dw, int C, int G, const KsTable tab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * K * K) return;
  const int tap = i / C, c = i % C;
  const int a = tap / K, bb = tap % K;
  const int k = tab.ks[selected(ks_idx, tab)];
  const int off = (K - k) / 2;
  float s = 0.f;
  if (c < channel_bound(bound, C) && a >= off && a < off + k && bb >= off && bb < off + k) {
#pragma unroll 4
    for (int gi = 0; gi < G; ++gi) s += part[((size_t)gi * K * K + tap) * C + c];
  }
  st(dw + (size_t)c * K * K + tap, s);
}

// -- host -------------------------------------------------------------------

enum Dir { FWD = 0, DGRAD = 1, WGRAD = 2 };

// a window's rows x columns (pixels staged for a tile) at kernel size k:
// the source's under a forward / stride-1 dgrad tile, dy's under a
// stride-2 dgrad tile, x's under a wgrad tile
template <int S>
constexpr int window_rows(int dir, int k) {
  return dir == DGRAD && S == 2 ? DA + par_hi(k) - par_lo(k)
                                : ((dir == WGRAD ? Tile<S>::WGRAD : Tile<S>::CORR) - 1) * S + k;
}

template <int S>
constexpr int window_cols(int dir, int k) {
  return dir == DGRAD && S == 2 ? DB + par_hi(k) - par_lo(k) : (TW - 1) * S + k;
}

// dynamic shared memory of a launch (bytes), sized for k = K: the head and
// two buffers of a tile's staged pixels (the wgrad's: the x window and the
// dy tile), or the wgrad's reduction where it is larger
template <int K, int S>
constexpr int smem_bytes(int dir, int vc) {
  const int stage = window_rows<S>(dir, K) * window_cols<S>(dir, K) * PB +
                    (dir == WGRAD ? Tile<S>::WGRAD * TW * PB : 0);
  const int red = dir == WGRAD ? NW * K * K * 32 * vc * 4 : 0;
  return SMEM_HEAD + (2 * stage > red ? 2 * stage : red);
}

// the tiles of a launch, in the order the blocks walk them
template <int S>
long long tiles_of(int dir, const Geom& g) {
  const auto grid = [](long long n, int rows, int cols, int th, int tw) {
    return n * ((rows + th - 1) / th) * ((cols + tw - 1) / tw);
  };
  if (dir == FWD) return grid(g.N, g.Ho, g.Wo, Tile<S>::CORR, TW);
  if (dir == WGRAD) return grid(g.N, g.Ho, g.Wo, Tile<S>::WGRAD, TW);
  if (S == 1) return grid(g.N, g.H, g.W, Tile<1>::CORR, TW);
  return grid(g.N, g.H, g.W, 2 * DA, 2 * DB);
}

bool aligned(const void* p, int n) { return ((uintptr_t)p & (n - 1)) == 0; }

// the copy unit: 16 bytes where every pixel row of the group is 16-byte
// aligned, else 4, else 2 (an odd bf16 C)
int copy_unit(int row_bytes, const void* a, const void* b) {
  if (row_bytes % 16 == 0 && aligned(a, 16) && (!b || aligned(b, 16))) return 16;
  if (row_bytes % 4 == 0 && aligned(a, 4) && (!b || aligned(b, 4))) return 4;
  return 2;
}

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

// a map over NHWC `p` [N, H, W, C] whose box is one channel group (128
// bytes) of rows x cols pixels of one image; false where TMA cannot take it
// (then cp.async stages): a box larger than the image, an encoder refusal
template <typename T>
bool nhwc_map(CUtensorMap* m, const T* p, int N, int H, int W, int C, int rows, int cols) {
  const EncodeTiled enc = tensor_map_encoder();
  if (!enc || rows > H || cols > W) return false;
  const cuuint64_t esz = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {C * esz, (cuuint64_t)W * C * esz, (cuuint64_t)H * W * C * esz};
  const cuuint32_t box[4] = {(cuuint32_t)(PB / esz), (cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(m, esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<T*>(p), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the launch's maps, one a kernel size of the table; whether TMA stages
template <typename T, int S>
bool launch_maps(Maps* maps, int dir, const T* src, const T* dy, const Geom& g,
                 const KsTable& tab) {
  const bool src_is_dy = dir == DGRAD;
  const int h = src_is_dy ? g.Ho : g.H, w = src_is_dy ? g.Wo : g.W;
  for (int i = 0; i < tab.n; ++i)
    if (!nhwc_map(&maps->src[i], src, g.N, h, w, g.C, window_rows<S>(dir, tab.ks[i]),
                  window_cols<S>(dir, tab.ks[i])))
      return false;
  return dir != WGRAD || nhwc_map(&maps->dy, dy, g.N, g.Ho, g.Wo, g.C, Tile<S>::WGRAD, TW);
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  if (bytes <= SMEM_STATIC) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int K, int S>
int launch_dir(int dir, const T* a, const T* b, const int* ks_idx, const int* bound,
               float* part, T* out, const Geom g, const KsTable tab, int per, int G,
               cudaStream_t stream) {
  constexpr int VC = Lane<T>::VC;
  const unsigned groups = (g.C + 32 * VC - 1) / (32 * VC);
  if ((long long)per * G < tiles_of<S>(dir, g)) return (int)cudaErrorInvalidValue;
  Launch ln{per, copy_unit(g.C * (int)sizeof(T), a, dir == WGRAD ? b : nullptr),
            g.C % 2 == 0 && aligned(out, 4), 0};
  Maps maps;
  ln.tma = ln.unit == 16 && launch_maps<T, S>(&maps, dir, a, b, g, tab);
  const int smem = smem_bytes<K, S>(dir, VC);
  const dim3 grid(groups, (unsigned)G);
  cudaError_t e;
  if (dir == FWD) {
    if ((e = allow_smem(dw_fwd_kernel<T, K, S>, smem)) != cudaSuccess) return (int)e;
    dw_fwd_kernel<T, K, S><<<grid, THREADS, smem, stream>>>(a, b, ks_idx, bound, out, g, tab, ln,
                                                            maps);
  } else if (dir == DGRAD) {
    if ((e = allow_smem(dw_dgrad_kernel<T, K, S>, smem)) != cudaSuccess) return (int)e;
    dw_dgrad_kernel<T, K, S><<<grid, THREADS, smem, stream>>>(a, b, ks_idx, bound, out, g, tab,
                                                              ln, maps);
  } else {
    if ((e = allow_smem(dw_wgrad_partial_kernel<T, K, S>, smem)) != cudaSuccess) return (int)e;
    dw_wgrad_partial_kernel<T, K, S><<<grid, THREADS, smem, stream>>>(a, b, ks_idx, bound, part,
                                                                      g, tab, ln, maps);
    const int n = g.C * K * K;
    dw_wgrad_finish_kernel<T, K><<<(n + 255) / 256, 256, 0, stream>>>(part, ks_idx, bound, out,
                                                                      g.C, G, tab);
  }
  return (int)cudaGetLastError();
}

// one direction at any (K, stride) the nets have; returns the launch error
template <typename T>
int dw_masked(int dir, const T* a, const T* b, const int* ks_idx, const int* bound,
              float* part, T* out, int N, int H, int W, int C, int Ho, int Wo, int K,
              int stride, int n_ks, int ks0, int ks1, int ks2, int ks3, int per, int G,
              void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Geom g{N, H, W, C, Ho, Wo};
  const KsTable tab{n_ks, {ks0, ks1, ks2, ks3}};
  if (N < 1 || H < 1 || W < 1 || C < 1 || n_ks < 1 || n_ks > 4 || per < 1 || G < 1 ||
      G > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ks; ++i)
    if (tab.ks[i] < 1 || tab.ks[i] > K || !(tab.ks[i] & 1)) return (int)cudaErrorInvalidValue;
#define DW_CASE(KK, SS)                                                                   \
  if (K == KK && stride == SS)                                                            \
    return launch_dir<T, KK, SS>(dir, a, b, ks_idx, bound, part, out, g, tab, per, G, stream);
  DW_CASE(3, 1) DW_CASE(3, 2) DW_CASE(5, 1) DW_CASE(5, 2) DW_CASE(7, 1) DW_CASE(7, 2)
#undef DW_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each direction takes per and G: its blocks walk runs of `per` tiles, G
// runs along the tiles (all N*tiles of the output: TH x 16 outputs, or the
// stride-2 dgrad's 16 x 32 dx pixels), from the caller's partition.

// forward: x [N,H,W,C], w [C,1,K,K] -> y [N,Ho,Wo,C]
extern "C" int ofa_dw_masked_fwd_f32(const float* x, const float* w, const int* ks_idx,
                                     const int* bound, float* y, int N, int H, int W, int C,
                                     int Ho, int Wo, int K, int stride, int n_ks, int ks0,
                                     int ks1, int ks2, int ks3, int per, int G, void* stream) {
  return dw_masked<float>(FWD, x, w, ks_idx, bound, nullptr, y, N, H, W, C, Ho, Wo, K, stride,
                          n_ks, ks0, ks1, ks2, ks3, per, G, stream);
}

extern "C" int ofa_dw_masked_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                      const int* ks_idx, const int* bound, __nv_bfloat16* y,
                                      int N, int H, int W, int C, int Ho, int Wo, int K,
                                      int stride, int n_ks, int ks0, int ks1, int ks2, int ks3,
                                      int per, int G, void* stream) {
  return dw_masked<__nv_bfloat16>(FWD, x, w, ks_idx, bound, nullptr, y, N, H, W, C, Ho, Wo, K,
                                  stride, n_ks, ks0, ks1, ks2, ks3, per, G, stream);
}

// dgrad: dy [N,Ho,Wo,C], w [C,1,K,K] -> dx [N,H,W,C]
extern "C" int ofa_dw_masked_dgrad_f32(const float* dy, const float* w, const int* ks_idx,
                                       const int* bound, float* dx, int N, int H, int W, int C,
                                       int Ho, int Wo, int K, int stride, int n_ks, int ks0,
                                       int ks1, int ks2, int ks3, int per, int G, void* stream) {
  return dw_masked<float>(DGRAD, dy, w, ks_idx, bound, nullptr, dx, N, H, W, C, Ho, Wo, K,
                          stride, n_ks, ks0, ks1, ks2, ks3, per, G, stream);
}

extern "C" int ofa_dw_masked_dgrad_bf16(const __nv_bfloat16* dy, const __nv_bfloat16* w,
                                        const int* ks_idx, const int* bound,
                                        __nv_bfloat16* dx, int N, int H, int W, int C, int Ho,
                                        int Wo, int K, int stride, int n_ks, int ks0, int ks1,
                                        int ks2, int ks3, int per, int G, void* stream) {
  return dw_masked<__nv_bfloat16>(DGRAD, dy, w, ks_idx, bound, nullptr, dx, N, H, W, C, Ho, Wo,
                                  K, stride, n_ks, ks0, ks1, ks2, ks3, per, G, stream);
}

// wgrad: x [N,H,W,C], dy [N,Ho,Wo,C] -> dW [C,1,K,K]; part: G*K*K*C floats
// of scratch (one partial a pass-1 block)
extern "C" int ofa_dw_masked_wgrad_f32(const float* x, const float* dy, const int* ks_idx,
                                       const int* bound, float* part, float* dw, int N, int H,
                                       int W, int C, int Ho, int Wo, int K, int stride,
                                       int n_ks, int ks0, int ks1, int ks2, int ks3, int per,
                                       int G, void* stream) {
  return dw_masked<float>(WGRAD, x, dy, ks_idx, bound, part, dw, N, H, W, C, Ho, Wo, K, stride,
                          n_ks, ks0, ks1, ks2, ks3, per, G, stream);
}

extern "C" int ofa_dw_masked_wgrad_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                                        const int* ks_idx, const int* bound, float* part,
                                        __nv_bfloat16* dw, int N, int H, int W, int C, int Ho,
                                        int Wo, int K, int stride, int n_ks, int ks0, int ks1,
                                        int ks2, int ks3, int per, int G, void* stream) {
  return dw_masked<__nv_bfloat16>(WGRAD, x, dy, ks_idx, bound, part, dw, N, H, W, C, Ho, Wo,
                                  K, stride, n_ks, ks0, ks1, ks2, ks3, per, G, stream);
}

// the dynamic shared memory a block of direction `dir` (0 forward, 1 dgrad,
// 2 wgrad pass 1) takes at bank size K and stride s, bf16 or float32
extern "C" int ofa_dw_masked_smem_bytes(int dir, int K, int stride, int bf16) {
  const int vc = bf16 ? 2 : 1;
#define DW_SMEM(KK, SS) \
  if (K == KK && stride == SS) return smem_bytes<KK, SS>(dir, vc);
  DW_SMEM(3, 1) DW_SMEM(3, 2) DW_SMEM(5, 1) DW_SMEM(5, 2) DW_SMEM(7, 1) DW_SMEM(7, 2)
#undef DW_SMEM
  return -1;
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
