// Fused conv5x5 (SAME, +bias) + PixelShuffle(2), float32, for sm_90a.
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
// 4 bytes written, far above the card's float32 FLOP/byte ridge, so the
// float32 FMA rate (no tensor cores: FP32 in, FP32 out, no TF32) is the
// bound.
//
// Design: a direct implicit GEMM. A block owns 8x16 LR pixels x 128 conv
// output channels. Per 16-channel slice of the input it stages the
// (8+4)x(16+4) halo of x in shared memory once, and per kernel row dy the
// 5x16x128 slice of w; every thread keeps an 8-pixel x 8-channel tile of
// accumulators in registers, so each shared-memory value feeds 8 FMAs
// (one row of 12 halo values serves all 5 taps dx). The PixelShuffle is
// only the output address: a thread's channels 4c..4c+3 are one HR channel
// c at the four sub-pixels, so no permutation of w is needed. Edge tiles
// (H or W not a multiple of the tile, e.g. 180 rows) are masked on load
// (zeros) and on store.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int KS = 5;
constexpr int PAD = KS / 2;
constexpr int TH = 8;                 // LR rows per block
constexpr int TW = 16;                // LR cols per block
constexpr int NT = 128;               // conv output channels per block
constexpr int CK = 16;                // input channels staged per step
constexpr int HH = TH + 2 * PAD;      // halo rows
constexpr int HWD = TW + 2 * PAD;     // halo cols
constexpr int THREADS = 256;
constexpr int XS_FLOATS = CK * HH * HWD;        // [CK][HH][HWD]
constexpr int WS_FLOATS = KS * CK * NT;         // [dx][CK][NT]
constexpr size_t SMEM_BYTES = (XS_FLOATS + WS_FLOATS) * sizeof(float);

static_assert(XS_FLOATS % 4 == 0, "w slice must stay 16-byte aligned");
static_assert(THREADS == (NT / 8) * (TH * TW / 8), "one 8x8 tile per thread");

__global__ void __launch_bounds__(THREADS, 2)
shuffle_tail_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int W, int Cin, int Cconv) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + XS_FLOATS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;            // channels n0 + tx*4 + {0..3} and +64
  const int ty = tid >> 4;            // 8 pixels: tile row ty/2, cols (ty&1)*8..+7
  const int prow = ty >> 1;
  const int pcol = (ty & 1) * 8;

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * NT;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * H * W * Cin;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    for (int dy = 0; dy < KS; ++dy) {
      __syncthreads();  // the previous step's reads of xs / ws are done
      if (dy == 0) {
        for (int i = tid; i < XS_FLOATS; i += THREADS) {
          const int k = i % CK;
          const int pix = i / CK;
          const int hr = pix / HWD, hc = pix % HWD;
          const int gh = h0 - PAD + hr, gw = w0 - PAD + hc, ci = c0 + k;
          float v = 0.f;
          if (gh >= 0 && gh < H && gw >= 0 && gw < W && ci < Cin)
            v = xb[((size_t)gh * W + gw) * Cin + ci];
          xs[k * (HH * HWD) + pix] = v;
        }
      }
      for (int i = tid; i < WS_FLOATS; i += THREADS) {
        const int n = i % NT;
        const int k = (i / NT) % CK;
        const int dx = i / (NT * CK);
        const int ci = c0 + k, co = n0 + n;
        float v = 0.f;
        if (ci < Cin && co < Cconv)
          v = w[((size_t)(dy * KS + dx) * Cin + ci) * Cconv + co];
        ws[i] = v;
      }
      __syncthreads();

#pragma unroll 1
      for (int k = 0; k < CK; ++k) {
        const float* xr = xs + k * (HH * HWD) + (prow + dy) * HWD + pcol;
        float a[8 + KS - 1];
#pragma unroll
        for (int i = 0; i < 8 + KS - 1; ++i) a[i] = xr[i];
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const float* wr = ws + (dx * CK + k) * NT + tx * 4;
          const float4 b0 = *reinterpret_cast<const float4*>(wr);
          const float4 b1 = *reinterpret_cast<const float4*>(wr + 64);
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const float av = a[dx + p];
            acc[p][0] = fmaf(av, b0.x, acc[p][0]);
            acc[p][1] = fmaf(av, b0.y, acc[p][1]);
            acc[p][2] = fmaf(av, b0.z, acc[p][2]);
            acc[p][3] = fmaf(av, b0.w, acc[p][3]);
            acc[p][4] = fmaf(av, b1.x, acc[p][4]);
            acc[p][5] = fmaf(av, b1.y, acc[p][5]);
            acc[p][6] = fmaf(av, b1.z, acc[p][6]);
            acc[p][7] = fmaf(av, b1.w, acc[p][7]);
          }
        }
      }
    }
  }

  // epilogue: conv channel co = 4c + 2y + x goes to HR pixel
  // (2h+y, 2w+x), channel c
  const int Cout = Cconv / 4;
  const int OW = 2 * W;
  const int h = h0 + prow;
  if (h >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int co0 = n0 + half * 64 + tx * 4;
    if (co0 >= Cconv) continue;  // Cconv % 4 == 0: co0..co0+3 all valid
    const int c = co0 >> 2;
    const float bb[4] = {bias[co0], bias[co0 + 1], bias[co0 + 2], bias[co0 + 3]};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int wq = w0 + pcol + p;
      if (wq >= W) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int oy = 2 * h + (j >> 1), ox = 2 * wq + (j & 1);
        out[(((size_t)b * 2 * H + oy) * OW + ox) * Cout + c] =
            acc[p][half * 4 + j] + bb[j];
      }
    }
  }
}

}  // namespace

extern "C" int ofa_shuffle_tail_f32(const float* x, const float* w,
                                    const float* bias, float* out, int B,
                                    int H, int W, int Cin, int Cconv,
                                    void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cconv <= 0 ||
      Cconv % 4 != 0)
    return (int)cudaErrorInvalidValue;  // B is grid.z
  cudaError_t e = cudaFuncSetAttribute(
      shuffle_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
                  (Cconv + NT - 1) / NT, B);
  shuffle_tail_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, w, bias, out, H, W, Cin, Cconv);
  return (int)cudaGetLastError();
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
