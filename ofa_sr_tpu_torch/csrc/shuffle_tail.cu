// Fused conv5x5 (SAME, +bias) + PixelShuffle(2), float32 in and out, on the
// tensor cores with 3xTF32, for sm_90a.
//
// Replaces the Pallas kernel `fused_shuffle_tail` (ofa_sr_tpu/ops/pallas/
// shuffle_tail.py: `_kernel`, `_dispatch`).
//
//   out[b, 2h+y, 2w+x, c] = bias[4c+2y+x]
//       + sum_{dy,dx,ci} x[b, h+dy-2, w+dx-2, ci] * w[dy, dx, ci, 4c+2y+x]
//
// x [B,H,W,Cin] NHWC, w [5,5,Cin,Cconv] HWIO, bias [Cconv], out
// [B,2H,2W,Cconv/4] NHWC; zero padding outside the image.
//
// What bounds it on the H100: arithmetic. At the serving path's shapes
// (Cin 64, Cconv 256) it does 2*25*64 = 3200 FLOP per conv output against
// 4 bytes written, far above any FLOP/byte ridge of the card. On the
// float32 FMA pipe (67 TFLOP/s) the two launches of a 720p frame cannot
// take less than 3.5 ms; the tensor cores do TF32 at 495 TFLOP/s dense.
//
// Why 3xTF32. A TF32 operand keeps 10 mantissa bits, and one TF32 product
// per multiply-add misses float32 accuracy by far over K = 1600 terms
// (about 1e-3 against a 1e-4 tolerance at the path's scales). Each operand
// is split as big = tf32(v), small = tf32(v - big) (round to nearest, ties
// away: cvt.rna), and the kernel sums
//   a_small*b_big + a_big*b_small + a_big*b_big
// in float32: the dropped a_small*b_small term is ~2^-22 of the product.
// The TF32 products are compensated, not approximate. Three products per
// multiply-add put the tensor-core bound at 3x the TF32 one: 1.43 ms a
// 720p frame.
//
// Where the sum is kept. An MMA adds its products into the accumulator
// with truncation, not rounding, so a chain of 600 MMAs into one float32
// accumulator drifts by hundreds of its last bits, several times cuDNN's
// float32 error. So each k8 step's three products go into a zeroed
// register tile and that tile is added into the float32 sum with an
// ordinary rounded add: the error then is that of a float32 sum of 200
// terms, below cuDNN's (chip_smoke.py measures both against a float64
// conv). It costs registers and adds, hence the tiles of four n8 tiles.
//
// Design: an implicit GEMM with M = LR pixels, N = conv channels, K =
// 25*Cin, on mma.sync.m16n8k8 (TF32 in, FP32 accumulate).
// - A block owns 8x16 LR pixels x 128 conv channels (8 warps: 4 along M,
//   each 2 rows of 16 pixels, x 2 along N, each 64 channels; 64
//   accumulators a thread). The (8+4)x(16+4) halo of x, all Cin channels
//   (zero-padded to a multiple of 16, zero outside the image), is loaded
//   into shared memory once with cp.async; the pixel stride Cin+4 keeps the
//   A-fragment loads free of bank conflicts.
// - K is walked as 25 taps x Cin/16: each step's 16 x 128 slice of w is
//   streamed with cp.async into a ring of 4 shared-memory stages, so the
//   loads of the next 3 steps overlap the MMAs of this one (row stride 136
//   keeps the B-fragment loads conflict-free). A and B fragments are split
//   into big / small in registers as they are loaded.
// - About 98 KB of shared memory a block at Cin 64: 2 blocks an SM.
// - Epilogue: the PixelShuffle is an address map. Conv channel 4c+2y+x of
//   LR pixel (h, w) goes to HR pixel (2h+y, 2w+x), channel c. The
//   accumulators (+bias) are staged in shared memory as the block's 16x32
//   HR pixels x 32 HR channels, then every thread writes whole 16-byte runs
//   of the NHWC output (a warp: four 128-byte runs).
// - Ragged H, W (180 rows, 7x13 frames) are zero-filled on load and masked
//   on store; ragged Cin is zero-padded in shared memory; Cconv past the
//   block's tile is zero-filled and not stored. Cin is limited by shared
//   memory (the halo holds all of it): up to 192.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KS = 5;
constexpr int PAD = KS / 2;
constexpr int TH = 8;                 // LR rows per block
constexpr int TW = 16;                // LR cols per block (one m16 tile)
constexpr int NT = 128;               // conv output channels per block
constexpr int KC = 16;                // input channels per K step
constexpr int STAGES = 4;             // w ring
constexpr int JG = 4;                 // n8 tiles per partial-sum group
constexpr int NP = NT + 8;            // w stage row stride (floats)
constexpr int HH = TH + 2 * PAD;      // halo rows
constexpr int HWD = TW + 2 * PAD;     // halo cols
constexpr int THREADS = 256;
constexpr int WS_FLOATS = STAGES * KC * NP;
// epilogue tile: 2*TH x 2*TW HR pixels x NT/4 HR channels
constexpr int ES_C = NT / 4 + 4;      // HR pixel stride (16-byte multiple)
constexpr int ES_R = 2 * TW * ES_C + 4;  // HR row stride
constexpr int ES_FLOATS = 2 * TH * ES_R;
constexpr size_t MAX_SMEM = 232448;   // 227 KB, the most a block may use

static_assert(THREADS == 32 * (TH / 2) * (NT / 64), "4 x 2 warps");
static_assert(NP % 32 == 8 && NP % 4 == 0, "conflict-free, 16-byte rows");
static_assert(ES_C % 4 == 0 && ES_R % 32 == 4, "16-byte reads, 2-way writes");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small (+ ~2^-22 v): both exact TF32 values
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// d += a * b on one 16x8x8 tile: a (row-major 16x8), b (col-major 8x8)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS, 2)
shuffle_tail_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int W, int Cin, int Cconv, int tiles_w,
                    int n_tiles, int vec_x, int vec_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ckp = (Cin + KC - 1) / KC * KC;  // Cin zero-padded
  const int cp = ckp + 4;                    // halo pixel stride
  float* xs = smem;                          // [HH][HWD][cp]
  float* ws = smem + HH * HWD * cp;          // [STAGES][KC][NP]

  const int tid = threadIdx.x;
  const int nt = blockIdx.x % n_tiles;       // N tiles of one M tile adjacent
  const int mtile = blockIdx.x / n_tiles;
  const int h0 = (mtile / tiles_w) * TH;
  const int w0 = (mtile % tiles_w) * TW;
  const int n0 = nt * NT;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * H * W * Cin;

  // the x halo: first of the cp.async group of step 0
  if (vec_x) {
    const int cq = ckp / 4;
    for (int i = tid; i < HH * HWD * cq; i += THREADS) {
      const int pix = i / cq, ci = (i % cq) * 4;
      const int gh = h0 - PAD + pix / HWD, gw = w0 - PAD + pix % HWD;
      const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && ci < Cin;
      cp_async16(xs + pix * cp + ci,
                 ok ? xb + ((size_t)gh * W + gw) * Cin + ci : x, ok);
    }
  } else {
    for (int i = tid; i < HH * HWD * ckp; i += THREADS) {
      const int pix = i / ckp, ci = i % ckp;
      const int gh = h0 - PAD + pix / HWD, gw = w0 - PAD + pix % HWD;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && ci < Cin)
        v = xb[((size_t)gh * W + gw) * Cin + ci];
      xs[pix * cp + ci] = v;
    }
  }

  const int nkc = ckp / KC;
  const int n_steps = KS * KS * nkc;
  // step s: tap s / nkc, input channels (s % nkc)*KC + [0, KC)
  auto load_step = [&](int s) {
    const int tap = s / nkc, ci0 = (s % nkc) * KC;
    float* dst = ws + (s % STAGES) * KC * NP;
    for (int i = tid; i < KC * NT / 4; i += THREADS) {
      const int r = i / (NT / 4), co = (i % (NT / 4)) * 4;
      const int ci = ci0 + r;
      const bool ok = ci < Cin && n0 + co < Cconv;
      cp_async16(dst + r * NP + co,
                 ok ? w + ((size_t)tap * Cin + ci) * Cconv + n0 + co : w, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % (TH / 2);   // LR rows 2*wm, 2*wm + 1 of the tile
  const int wn = warp / (TH / 2);   // conv channels wn*64 + [0, 64)
  const int g = lane >> 2, t = lane & 3;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s (and the halo) landed
    __syncthreads();              // ... for all; step s-1's stage is free
    if (s + STAGES - 1 < n_steps) load_step(s + STAGES - 1);
    cp_async_commit();

    const int tap = s / nkc, ci0 = (s % nkc) * KC;
    const int dy = tap / KS, dx = tap % KS;
    // A row r of tile mt: LR pixel (2*wm + mt, r); column k: channel ci0 + k
    const float* xa = xs + ((2 * wm + dy) * HWD + dx + g) * cp + ci0 + t;
    // B row k: channel ci0 + k; column n: conv channel n0 + wn*64 + n
    const float* wb = ws + (s % STAGES) * KC * NP + t * NP + wn * 64 + g;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = xa + mt * HWD * cp + kk * 8;
        split_tf32(p[0], ab[mt][0], as[mt][0]);           // (g, t)
        split_tf32(p[8 * cp], ab[mt][1], as[mt][1]);      // (g + 8, t)
        split_tf32(p[4], ab[mt][2], as[mt][2]);           // (g, t + 4)
        split_tf32(p[8 * cp + 4], ab[mt][3], as[mt][3]);  // (g + 8, t + 4)
      }
      // four n8 tiles at a time: their three products go into a zeroed
      // tile, which is then added into the float32 sum (see the note)
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += JG) {
        uint32_t bb[JG][2], bs[JG][2];
        float part[2][JG][4];
#pragma unroll
        for (int j = 0; j < JG; ++j) {
          const float* q = wb + kk * 8 * NP + (j0 + j) * 8;
          split_tf32(q[0], bb[j][0], bs[j][0]);       // (k t, n g)
          split_tf32(q[4 * NP], bb[j][1], bs[j][1]);  // (k t + 4, n g)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
        }
        // each term over all tiles before the next: independent MMAs
#pragma unroll
        for (int j = 0; j < JG; ++j)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j], as[mt], bb[j]);
#pragma unroll
        for (int j = 0; j < JG; ++j)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j], ab[mt], bs[j]);
#pragma unroll
        for (int j = 0; j < JG; ++j)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][j], ab[mt], bb[j]);
#pragma unroll
        for (int j = 0; j < JG; ++j)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j0 + j][e] += part[mt][j][e];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with xs / ws: reuse as the tile

  // accumulator (mt, j, e) is conv channel co = n0 + wn*64 + j*8 + 2t + e%2
  // of LR pixel (2*wm + mt, g + 8*(e/2)); co = 4c + 2y + x with y = t & 1,
  // x = e % 2
  float* es = smem;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = wn * 64 + j * 8 + 2 * t;  // local conv channel, even
    const int cl = col >> 2, y = t & 1;
    const float b0 = n0 + col < Cconv ? bias[n0 + col] : 0.f;
    const float b1 = n0 + col + 1 < Cconv ? bias[n0 + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float* row = es + (2 * (2 * wm + mt) + y) * ES_R + cl;
      row[(2 * g) * ES_C] = acc[mt][j][0] + b0;
      row[(2 * g + 1) * ES_C] = acc[mt][j][1] + b1;
      row[(2 * g + 16) * ES_C] = acc[mt][j][2] + b0;
      row[(2 * g + 17) * ES_C] = acc[mt][j][3] + b1;
    }
  }
  __syncthreads();

  const int Cout = Cconv / 4, c0 = n0 / 4;
  const int cvalid = min(NT / 4, Cout - c0);
  const int OH = 2 * H, OW = 2 * W;
  float* ob = out + (size_t)b * OH * OW * Cout;
  if (vec_out) {  // Cout % 4 == 0: runs of 4 channels, 16-byte aligned
    constexpr int Q = NT / 16;  // float4 runs per HR pixel
    for (int i = tid; i < 2 * TH * 2 * TW * Q; i += THREADS) {
      const int q = i % Q, pc = (i / Q) % (2 * TW), pr = i / (Q * 2 * TW);
      const int oy = 2 * h0 + pr, ox = 2 * w0 + pc;
      if (q * 4 >= cvalid || oy >= OH || ox >= OW) continue;
      *reinterpret_cast<float4*>(ob + ((size_t)oy * OW + ox) * Cout + c0 +
                                 q * 4) =
          *reinterpret_cast<const float4*>(es + pr * ES_R + pc * ES_C + q * 4);
    }
  } else {
    constexpr int Q = NT / 4;
    for (int i = tid; i < 2 * TH * 2 * TW * Q; i += THREADS) {
      const int q = i % Q, pc = (i / Q) % (2 * TW), pr = i / (Q * 2 * TW);
      const int oy = 2 * h0 + pr, ox = 2 * w0 + pc;
      if (q >= cvalid || oy >= OH || ox >= OW) continue;
      ob[((size_t)oy * OW + ox) * Cout + c0 + q] =
          es[pr * ES_R + pc * ES_C + q];
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// shared memory a launch needs for `Cin` input channels (bytes), or 0 when
// it exceeds what a block may use
long long smem_bytes(int Cin) {
  if (Cin <= 0) return 0;
  const long long ckp = (Cin + KC - 1) / KC * KC;
  long long floats = HH * HWD * (ckp + 4) + WS_FLOATS;
  if (floats < ES_FLOATS) floats = ES_FLOATS;
  const long long bytes = floats * (long long)sizeof(float);
  return bytes <= (long long)MAX_SMEM ? bytes : 0;
}

}  // namespace

extern "C" int ofa_shuffle_tail_f32(const float* x, const float* w,
                                    const float* bias, float* out, int B,
                                    int H, int W, int Cin, int Cconv,
                                    void* stream) {
  const long long smem = smem_bytes(Cin);
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cconv <= 0 ||
      Cconv % 4 != 0 || smem == 0 || !aligned16(w))
    return (int)cudaErrorInvalidValue;  // B is grid.y; w rows via cp.async
  const long long tiles_w = (W + TW - 1) / TW;
  const long long n_tiles = (Cconv + NT - 1) / NT;
  const long long blocks = (H + TH - 1) / TH * tiles_w * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      shuffle_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec_x = Cin % 4 == 0 && aligned16(x);
  const int vec_out = (Cconv / 4) % 4 == 0 && aligned16(out);
  shuffle_tail_kernel<<<dim3((unsigned)blocks, B), THREADS, (size_t)smem,
                        (cudaStream_t)stream>>>(x, w, bias, out, H, W, Cin,
                                                Cconv, (int)tiles_w,
                                                (int)n_tiles, vec_x, vec_out);
  return (int)cudaGetLastError();
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
