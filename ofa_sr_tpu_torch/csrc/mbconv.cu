// Fused MBConv inference block (BN folded), float32, for sm_90a.
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
// What bounds it on the H100: arithmetic. At the serving path's shape
// (C 64, M 384, k 7) it does 2*(64*384*2 + 49*384) = 136 kFLOP per pixel
// against 512 bytes of x read and out written, so the float32 FMA rate (no
// tensor cores: FP32 in and out, no TF32) is the bound, not memory.
//
// Design: the (B,H,W,M) mid activation never reaches device memory. A block
// owns an 8x16 tile of pixels and all C output channels. It stages the
// tile's (8+2p)x(16+2p) halo of x in shared memory once, then walks the mid
// channels in chunks of 32, because the whole halo'd mid activation does not
// fit one block's shared memory (14x22 px x 384 ch x 4 B = 473 KB at k 7).
// For each chunk it (1) computes the expand over the halo into shared memory
// as a small GEMM with 4x4 register tiles, re-zeroing halo positions outside
// the image (relu6(bias) != 0, while the reference zero-pads mid), (2) takes
// the depthwise for the tile's pixels, one channel per thread along a tile
// row, and (3) accumulates the chunk's share of the 1x1 project into an
// 8-pixel x 4-channel register tile per thread. Bias and the residual (read
// back from the staged halo) are added at the end. The expand is recomputed
// on the halo ring: 308 halo pixels for 128 output pixels at k 7, the price
// of keeping blocks independent. Any H and W are handled (edge tiles are
// masked); k is 3, 5 or 7; C is a multiple of 4 up to 64.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TH = 8;        // tile rows
constexpr int TW = 16;       // tile cols
constexpr int MC = 32;       // mid channels per chunk
constexpr int THREADS = 256;
constexpr int CMAX = 64;     // 16 channel groups of 4 in the project tile

static_assert(THREADS == (TH * TW / 8) * (CMAX / 4), "project tiling");
static_assert(THREADS == MC * TH, "depthwise: one (channel, tile row) per thread");

template <int KS>
struct Geo {
  static constexpr int P = KS / 2;
  static constexpr int HH = TH + 2 * P;
  static constexpr int HWD = TW + 2 * P;
  static constexpr int HP = HH * HWD;                     // halo pixels
  static constexpr int MIDP = (HP + 31) / 32 * 32 + 1;    // mid row stride, 1 mod 32
  static constexpr int DWP = TH * TW + 1;                 // depthwise-out row stride
  static constexpr int TAPS = KS * KS;
  static_assert(HP % 4 == 0, "float4 reads of the halo");
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// shared-memory carve-up, in floats; every region starts 16-byte aligned
struct Layout {
  int xs, mids, ibw, ibb, dww, dwb, dwo, plw, total;
  __host__ __device__ Layout(int C, int HP, int MIDP, int TAPS, int DWP) {
    int o = 0;
    xs = o;   o += round4(C * HP);      // [C][HP]     halo of x
    mids = o; o += round4(MC * MIDP);   // [MC][MIDP]  expand output
    ibw = o;  o += round4(C * MC);      // [C][MC]
    ibb = o;  o += round4(MC);
    dww = o;  o += round4(MC * TAPS);   // [MC][TAPS]
    dwb = o;  o += round4(MC);
    dwo = o;  o += round4(MC * DWP);    // [MC][DWP]   depthwise output
    plw = o;  o += round4(MC * C);      // [MC][C]
    total = o;
  }
};

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
mbconv_kernel(const float* __restrict__ x, const float* __restrict__ ib_w,
              const float* __restrict__ ib_b, const float* __restrict__ dw_w,
              const float* __restrict__ dw_b, const float* __restrict__ pl_w,
              const float* __restrict__ pl_b, float* __restrict__ out,
              int H, int W, int C, int M, int residual) {
  using G = Geo<KS>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L(C, G::HP, G::MIDP, G::TAPS, G::DWP);
  float* xs = sm + L.xs;
  float* mids = sm + L.mids;
  float* ibw = sm + L.ibw;
  float* ibb = sm + L.ibb;
  float* dww = sm + L.dww;
  float* dwb = sm + L.dwb;
  float* dwo = sm + L.dwo;
  float* plw = sm + L.plw;

  const int tid = threadIdx.x;
  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * H * W * C;

  // project tile: pixels pg*8..pg*8+7 of the tile, channels cg*4..cg*4+3
  const int pg = tid >> 4, cg = tid & 15;
  const int prow = pg >> 1, pcol = (pg & 1) * 8;
  const bool co_ok = cg * 4 < C;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // the halo of x, zeros outside the image
  for (int i = tid; i < G::HP * C; i += THREADS) {
    const int ci = i % C, hp = i / C;
    const int gh = h0 - G::P + hp / G::HWD, gw = w0 - G::P + hp % G::HWD;
    float v = 0.f;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W) v = xb[((size_t)gh * W + gw) * C + ci];
    xs[ci * G::HP + hp] = v;
  }

  for (int m0 = 0; m0 < M; m0 += MC) {
    __syncthreads();  // the previous chunk's reads of mids / dwo / weights are done
    for (int i = tid; i < C * MC; i += THREADS) {
      const int mm = i % MC, ci = i / MC, m = m0 + mm;
      ibw[i] = m < M ? ib_w[(size_t)ci * M + m] : 0.f;
    }
    for (int i = tid; i < MC * C; i += THREADS) {
      const int co = i % C, mm = i / C, m = m0 + mm;
      plw[i] = m < M ? pl_w[(size_t)m * C + co] : 0.f;
    }
    for (int i = tid; i < MC * G::TAPS; i += THREADS) {
      const int mm = i % MC, t = i / MC, m = m0 + mm;
      dww[mm * G::TAPS + t] = m < M ? dw_w[(size_t)t * M + m] : 0.f;
    }
    if (tid < MC) {
      const int m = m0 + tid;
      ibb[tid] = m < M ? ib_b[m] : 0.f;
      dwb[tid] = m < M ? dw_b[m] : 0.f;
    }
    __syncthreads();

    // (1) expand over the halo: 4 halo pixels x 4 mid channels per thread
    {
      const int rg = tid >> 3, cq = (tid & 7) * 4;
      for (int hp0 = rg * 4; hp0 < G::HP; hp0 += (THREADS / 8) * 4) {
        float e[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) e[i][j] = 0.f;
#pragma unroll 4
        for (int ci = 0; ci < C; ++ci) {
          const float4 a = *reinterpret_cast<const float4*>(xs + ci * G::HP + hp0);
          const float4 wv = *reinterpret_cast<const float4*>(ibw + ci * MC + cq);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            e[i][0] = fmaf(av[i], wv.x, e[i][0]);
            e[i][1] = fmaf(av[i], wv.y, e[i][1]);
            e[i][2] = fmaf(av[i], wv.z, e[i][2]);
            e[i][3] = fmaf(av[i], wv.w, e[i][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hp = hp0 + i;
          const int gh = h0 - G::P + hp / G::HWD, gw = w0 - G::P + hp % G::HWD;
          const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mids[(cq + j) * G::MIDP + hp] = inside ? relu6f(e[i][j] + ibb[cq + j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // (2) depthwise + bias + relu6: channel mm, tile row r, all TW columns
    {
      const int mm = tid & (MC - 1), r = tid / MC;
      const float* mrow = mids + mm * G::MIDP + r * G::HWD;
      const float* wk = dww + mm * G::TAPS;
      float d[TW];
#pragma unroll
      for (int c = 0; c < TW; ++c) d[c] = 0.f;
#pragma unroll
      for (int dy = 0; dy < KS; ++dy) {
        float seg[G::HWD];
#pragma unroll
        for (int j = 0; j < G::HWD; ++j) seg[j] = mrow[dy * G::HWD + j];
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const float wv = wk[dy * KS + dx];
#pragma unroll
          for (int c = 0; c < TW; ++c) d[c] = fmaf(seg[c + dx], wv, d[c]);
        }
      }
      const float bv = dwb[mm];
#pragma unroll
      for (int c = 0; c < TW; ++c) dwo[mm * G::DWP + r * TW + c] = relu6f(d[c] + bv);
    }
    __syncthreads();

    // (3) this chunk's share of the 1x1 project
    if (co_ok) {
#pragma unroll 4
      for (int mm = 0; mm < MC; ++mm) {
        const float* ar = dwo + mm * G::DWP + pg * 8;
        const float4 wv = *reinterpret_cast<const float4*>(plw + mm * C + cg * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = ar[i];
          acc[i][0] = fmaf(a, wv.x, acc[i][0]);
          acc[i][1] = fmaf(a, wv.y, acc[i][1]);
          acc[i][2] = fmaf(a, wv.z, acc[i][2]);
          acc[i][3] = fmaf(a, wv.w, acc[i][3]);
        }
      }
    }
  }

  const int h = h0 + prow;
  if (h >= H || !co_ok) return;
  const int co = cg * 4;
  const float pb[4] = {pl_b[co], pl_b[co + 1], pl_b[co + 2], pl_b[co + 3]};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int wq = w0 + pcol + i;
    if (wq >= W) break;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = acc[i][j] + pb[j];
    if (residual) {
      const int hp = (prow + G::P) * G::HWD + pcol + i + G::P;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] += xs[(co + j) * G::HP + hp];
    }
    float* dst = out + (((size_t)b * H + h) * W + wq) * C + co;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = o[j];
  }
}

template <int KS>
int launch(const float* x, const float* ib_w, const float* ib_b,
           const float* dw_w, const float* dw_b, const float* pl_w,
           const float* pl_b, float* out, int B, int H, int W, int C, int M,
           int residual, cudaStream_t stream) {
  using G = Geo<KS>;
  const Layout L(C, G::HP, G::MIDP, G::TAPS, G::DWP);
  const size_t bytes = (size_t)L.total * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      mbconv_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), B);
  mbconv_kernel<KS><<<grid, THREADS, bytes, stream>>>(
      x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out, H, W, C, M, residual);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ofa_mbconv_f32(const float* x, const float* ib_w,
                              const float* ib_b, const float* dw_w,
                              const float* dw_b, const float* pl_w,
                              const float* pl_b, float* out, int B, int H,
                              int W, int C, int M, int ks, int residual,
                              void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || M <= 0 || C <= 0 ||
      C > CMAX || C % 4 != 0)
    return (int)cudaErrorInvalidValue;  // B is grid.y
  cudaStream_t s = (cudaStream_t)stream;
  switch (ks) {
    case 3: return launch<3>(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out, B, H, W, C, M, residual, s);
    case 5: return launch<5>(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out, B, H, W, C, M, residual, s);
    case 7: return launch<7>(x, ib_w, ib_b, dw_w, dw_b, pl_w, pl_b, out, B, H, W, C, M, residual, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
