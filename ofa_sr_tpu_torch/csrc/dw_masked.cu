// The masked depthwise convolution of the graphed training step, for
// sm_90a, on float32 or bfloat16 NHWC activations: forward, dgrad (dx) and a
// deterministic wgrad (dW), each reading the sampled kernel size and the
// channel bound from the device.
//
// Replaces no Pallas kernel. It is the port's form of the JAX package's
// depthwise levers in the masked MBConv (ofa_sr_tpu/models/layers.py
// `_dw_switched` and the `ks_switch` branch of `_masked_mbconv_apply`), which
// are XLA ops there: `lax.switch` over one depthwise branch per (kernel
// size, middle width), so that the sampled subnet runs only its own k x k
// taps on its first `mid` channels. The masked step otherwise runs the
// depthwise at the bank's size K (7) over every channel, with the selected
// kernel zero-embedded at the centre of the K x K window. A CUDA graph
// cannot branch on a device value, so here one kernel reads the branch on
// the device:
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
// What bounds it on the H100. Per output element k*k FMAs against a read
// of x and a write of y: at k = 7 that is 98 FLOP for 8 bytes (float32),
// above the FP32 pipe's ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte),
// so the bound is operations at k >= 5 and bytes at k = 3 (18 FLOP for 8
// bytes, 2.25 FLOP/byte in bf16 over 4 bytes is 4.5: bytes). The wgrad
// reads x and dy and writes C*K*K values; it does the forward's FMAs.
//
// Design. Thread (x, y) of a 32 x 8 block owns channel blockIdx.y*32 + x,
// so a warp's loads and stores are 32 neighbouring channels of one pixel
// (128 bytes in float32). A thread loads its channel's k*k taps into
// registers once, and works on segments: TW = 8 neighbouring outputs of one
// row. For each of the k input rows under a segment it loads the row's
// (TW-1)*s + k values once and adds their products into the segment's TW
// sums (forward, and dgrad at stride 1, which is the forward over dy with
// the taps flipped) or into the k*k tap sums (wgrad): about k*(TW+k-1)/TW
// loads an output in place of k*k. Each output sums its taps in row-major
// order. Forward and stride-1 dgrad: a block covers 2 segments a lane, 16
// a block, of its 32 channels. The stride-2 dgrad gathers each dx pixel
// from the outputs whose window holds it, 8 pixels a lane. The kernel size
// is read once a block and dispatched to code unrolled for it (k in {1, 3,
// 5, 7}, k <= K), so a k = 3 subnet runs 9 taps, not 49. Blocks whose
// channels all lie at or past the bound write their zeros and load
// nothing else. The wgrad runs in two passes with no atomics, so two
// launches give the same bits:
//   pass 1: block (g, t) sums the segments [g*R, (g+1)*R) of the output's
//           N*Ho*ceil(Wo/TW) row segments for its 32 channels: lane y takes
//           segments y, y+8, ..., each thread keeping its channel's k*k sums
//           in registers; the 8 lanes are then added in order through
//           shared memory, tap by tap, and the block writes
//           partial[g][c][tap] (tap in K x K numbering). Blocks past the
//           bound exit at once (their partials are unread).
//   pass 2: one thread a (c, tap) of dW adds its G partials in order, or
//           writes 0 outside the window or from the bound on.
// R and G are chosen by the caller from the shapes alone, so the bits do not
// depend on the card. The workspace (G*C*K*K floats) is allocated by the
// caller. Each entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CH = 32;     // channels a block (threadIdx.x)
constexpr int LANES = 8;   // segment / pixel lanes a block (threadIdx.y)
constexpr int TW = 8;      // outputs a segment: neighbours along a row
constexpr int SEGS = 2;    // segments a lane takes (forward, stride-1 dgrad)
constexpr int PIX = 8;     // pixels a lane takes (stride-2 dgrad)

struct KsTable {
  int n;
  int ks[4];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the selected kernel size (an index out of range is clamped, as lax.switch
// clamps its index) and the channel bound, clamped to [0, C]
__device__ __forceinline__ int selected_k(const int* ks_idx, const KsTable& t) {
  int i = *ks_idx;
  i = i < 0 ? 0 : (i >= t.n ? t.n - 1 : i);
  return t.ks[i];
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

struct Geom {
  int N, H, W, C, Ho, Wo;
};

template <typename T, int K, int k>
__device__ __forceinline__ void load_taps(const T* w, int c, bool live, bool flip,
                                          float (&wr)[k * k]) {
  constexpr int off = (K - k) / 2;
#pragma unroll
  for (int i = 0; i < k; ++i)
#pragma unroll
    for (int j = 0; j < k; ++j) {
      const int a = flip ? k - 1 - i : i, b = flip ? k - 1 - j : j;
      wr[i * k + j] = live ? ld(w + (size_t)c * K * K + (off + a) * K + (off + b)) : 0.f;
    }
}

// one input row's SPAN values of channel c from column v0 on (0 outside
// the row): the taps of TW neighbouring outputs, loaded once
template <typename T, int SPAN>
__device__ __forceinline__ void load_span(const T* row, int v0, int W, int C,
                                          float (&xr)[SPAN]) {
#pragma unroll
  for (int u = 0; u < SPAN; ++u) {
    const int v = v0 + u;
    xr[u] = (v >= 0 && v < W) ? ld(row + (size_t)v * C) : 0.f;
  }
}

// dst[n,o,p,c] = sum_{i,j<k} src[n, o*S-k/2+i, p*S-k/2+j, c] * wr[i*k+j]:
// the forward (src x, dst y), and at stride 1 the dgrad (src dy, dst dx,
// the taps flipped). A lane takes segments of TW outputs along a row,
// SEGS segments a lane; each source row's span is loaded once for the
// segment's TW outputs.
template <typename T, int K, int S, int k>
__device__ void corr_body(const T* __restrict__ src, const T* __restrict__ w,
                          T* __restrict__ dst, int N, int Hs, int Ws, int Hd, int Wd, int C,
                          int c, bool live, bool flip) {
  constexpr int SPAN = (TW - 1) * S + k;
  float wr[k * k];
  load_taps<T, K, k>(w, c, live, flip, wr);
  const int segw = (Wd + TW - 1) / TW;
  const int nseg = N * Hd * segw;
  const int s0 = blockIdx.x * (LANES * SEGS) + threadIdx.y;
#pragma unroll 1
  for (int t = 0; t < SEGS; ++t) {
    const int sg = s0 + t * LANES;
    if (sg >= nseg) break;
    const int p0 = (sg % segw) * TW, q = sg / segw;
    const int o = q % Hd, n = q / Hd;
    float acc[TW];
#pragma unroll
    for (int e = 0; e < TW; ++e) acc[e] = 0.f;
    if (live) {
      const int h0 = o * S - k / 2, v0 = p0 * S - k / 2;
#pragma unroll
      for (int i = 0; i < k; ++i) {
        const int h = h0 + i;
        if (h < 0 || h >= Hs) continue;
        float xr[SPAN];
        load_span<T, SPAN>(src + ((size_t)n * Hs + h) * Ws * C + c, v0, Ws, C, xr);
#pragma unroll
        for (int e = 0; e < TW; ++e)
#pragma unroll
          for (int j = 0; j < k; ++j) acc[e] = fmaf(xr[e * S + j], wr[i * k + j], acc[e]);
      }
    }
    T* out = dst + (((size_t)n * Hd + o) * Wd + p0) * C + c;
#pragma unroll
    for (int e = 0; e < TW; ++e)
      if (p0 + e < Wd) st(out + (size_t)e * C, acc[e]);
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(CH * LANES)
dw_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* ks_idx,
              const int* bound, T* __restrict__ y, const Geom g, const KsTable tab) {
  const int c = blockIdx.y * CH + threadIdx.x;
  if (c >= g.C) return;
  const bool live = c < channel_bound(bound, g.C);
  const int k = selected_k(ks_idx, tab);
  DW_WITH_K(K, k, (corr_body<T, K, S, kk>(x, w, y, g.N, g.H, g.W, g.Ho, g.Wo, g.C, c, live,
                                          false)))
}

// the stride-2 dgrad: each dx pixel gathers the outputs whose window holds
// it, PIX pixels a lane
template <typename T, int K, int k>
__device__ void dgrad_s2_body(const T* __restrict__ dy, const T* __restrict__ w,
                              T* __restrict__ dx, const Geom g, int c, bool live) {
  float wr[k * k];
  load_taps<T, K, k>(w, c, live, false, wr);
  const int P = g.N * g.H * g.W;
  const int p0 = blockIdx.x * (LANES * PIX) + threadIdx.y;
#pragma unroll 1
  for (int t = 0; t < PIX; ++t) {
    const int p = p0 + t * LANES;
    if (p >= P) break;
    float acc = 0.f;
    if (live) {
      const int v = p % g.W, q = p / g.W;
      const int h = q % g.H, n = q / g.H;
#pragma unroll
      for (int i = 0; i < k; ++i) {
        const int a = h + k / 2 - i;  // = o * 2
        if (a < 0 || (a & 1)) continue;
        const int o = a / 2;
        if (o >= g.Ho) continue;
        const T* row = dy + ((size_t)n * g.Ho + o) * g.Wo * g.C + c;
#pragma unroll
        for (int j = 0; j < k; ++j) {
          const int b = v + k / 2 - j;
          if (b < 0 || (b & 1)) continue;
          const int pp = b / 2;
          if (pp >= g.Wo) continue;
          acc = fmaf(ld(row + (size_t)pp * g.C), wr[i * k + j], acc);
        }
      }
    }
    st(dx + (size_t)p * g.C + c, acc);
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(CH * LANES)
dw_dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ w, const int* ks_idx,
                const int* bound, T* __restrict__ dx, const Geom g, const KsTable tab) {
  const int c = blockIdx.y * CH + threadIdx.x;
  if (c >= g.C) return;
  const bool live = c < channel_bound(bound, g.C);
  const int k = selected_k(ks_idx, tab);
  if constexpr (S == 1) {
    // stride 1: a correlation of dy with the flipped taps (Ho, Wo = H, W)
    DW_WITH_K(K, k, (corr_body<T, K, 1, kk>(dy, w, dx, g.N, g.Ho, g.Wo, g.H, g.W, g.C, c,
                                            live, true)))
  } else {
    DW_WITH_K(K, k, (dgrad_s2_body<T, K, kk>(dy, w, dx, g, c, live)))
  }
}

template <typename T, int K, int S, int k>
__device__ void wgrad_body(const T* __restrict__ x, const T* __restrict__ dy,
                           float* __restrict__ part, const Geom g, int c, bool live,
                           int segs, float (*red)[CH]) {
  constexpr int off = (K - k) / 2;
  constexpr int SPAN = (TW - 1) * S + k;
  float acc[k * k];
#pragma unroll
  for (int t = 0; t < k * k; ++t) acc[t] = 0.f;
  const int segw = (g.Wo + TW - 1) / TW;
  const int nseg = g.N * g.Ho * segw;
  const int s0 = blockIdx.x * segs;
  const int s1 = min(s0 + segs, nseg);
  if (live) {
#pragma unroll 1
    for (int sg = s0 + threadIdx.y; sg < s1; sg += LANES) {
      const int p0 = (sg % segw) * TW, q = sg / segw;
      const int ho = q % g.Ho, n = q / g.Ho;
      const T* drow = dy + (((size_t)n * g.Ho + ho) * g.Wo + p0) * g.C + c;
      float d[TW];
#pragma unroll
      for (int e = 0; e < TW; ++e) d[e] = p0 + e < g.Wo ? ld(drow + (size_t)e * g.C) : 0.f;
      const int h0 = ho * S - k / 2, v0 = p0 * S - k / 2;
#pragma unroll
      for (int i = 0; i < k; ++i) {
        const int h = h0 + i;
        if (h < 0 || h >= g.H) continue;
        float xr[SPAN];
        load_span<T, SPAN>(x + ((size_t)n * g.H + h) * g.W * g.C + c, v0, g.W, g.C, xr);
#pragma unroll
        for (int j = 0; j < k; ++j)
#pragma unroll
          for (int e = 0; e < TW; ++e)
            acc[i * k + j] = fmaf(xr[e * S + j], d[e], acc[i * k + j]);
      }
    }
  }
  // the 8 lanes of each channel, added in order, one tap at a time
#pragma unroll
  for (int t = 0; t < k * k; ++t) {
    red[threadIdx.y][threadIdx.x] = acc[t];
    __syncthreads();
    if (threadIdx.y == 0 && c < g.C) {
      float s = red[0][threadIdx.x];
#pragma unroll
      for (int l = 1; l < LANES; ++l) s += red[l][threadIdx.x];
      const int tap = (off + t / k) * K + (off + t % k);
      part[((size_t)blockIdx.x * g.C + c) * (K * K) + tap] = s;
    }
    __syncthreads();
  }
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(CH * LANES)
dw_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy, const int* ks_idx,
                        const int* bound, float* __restrict__ part, const Geom g,
                        const KsTable tab, int segs) {
  __shared__ float red[LANES][CH];
  const int b = channel_bound(bound, g.C);
  if ((int)blockIdx.y * CH >= b) return;  // every channel of the block is past the bound
  const int c = blockIdx.y * CH + threadIdx.x;
  const bool live = c < b;
  const int k = selected_k(ks_idx, tab);
  DW_WITH_K(K, k, (wgrad_body<T, K, S, kk>(x, dy, part, g, c, live, segs, red)))
}

template <typename T, int K>
__global__ void __launch_bounds__(256)
dw_wgrad_finish_kernel(const float* __restrict__ part, const int* ks_idx, const int* bound,
                       T* __restrict__ dw, int C, int G, const KsTable tab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * K * K) return;
  const int c = i / (K * K), tap = i % (K * K);
  const int a = tap / K, b = tap % K;
  const int k = selected_k(ks_idx, tab);
  const int off = (K - k) / 2;
  float s = 0.f;
  if (c < channel_bound(bound, C) && a >= off && a < off + k && b >= off && b < off + k) {
#pragma unroll 4
    for (int gi = 0; gi < G; ++gi) s += part[((size_t)gi * C + c) * (K * K) + tap];
  }
  st(dw + i, s);
}

enum Dir { FWD = 0, DGRAD = 1, WGRAD = 2 };

template <typename T, int K, int S>
void launch_dir(int dir, const T* a, const T* b, const int* ks_idx, const int* bound,
                float* part, T* out, const Geom g, const KsTable tab, int segs, int G,
                cudaStream_t stream) {
  const dim3 block(CH, LANES);
  const unsigned cgroups = (g.C + CH - 1) / CH;
  // segments of TW outputs along the rows of the output (forward) or of dx
  const auto seg_blocks = [](long long rows, int width) {
    const long long n = rows * ((width + TW - 1) / TW);
    return (unsigned)((n + LANES * SEGS - 1) / (LANES * SEGS));
  };
  if (dir == FWD) {
    dw_fwd_kernel<T, K, S><<<dim3(seg_blocks((long long)g.N * g.Ho, g.Wo), cgroups), block, 0,
                             stream>>>(a, b, ks_idx, bound, out, g, tab);
  } else if (dir == DGRAD) {
    const long long P = (long long)g.N * g.H * g.W;
    const unsigned blocks = S == 1 ? seg_blocks((long long)g.N * g.H, g.W)
                                   : (unsigned)((P + LANES * PIX - 1) / (LANES * PIX));
    dw_dgrad_kernel<T, K, S><<<dim3(blocks, cgroups), block, 0, stream>>>(a, b, ks_idx, bound,
                                                                          out, g, tab);
  } else {
    dw_wgrad_partial_kernel<T, K, S><<<dim3((unsigned)G, cgroups), block, 0, stream>>>(
        a, b, ks_idx, bound, part, g, tab, segs);
    const int n = g.C * K * K;
    dw_wgrad_finish_kernel<T, K><<<(n + 255) / 256, 256, 0, stream>>>(part, ks_idx, bound, out,
                                                                      g.C, G, tab);
  }
}

// one direction at any (K, stride) the nets have; returns the launch error
template <typename T>
int dw_masked(int dir, const T* a, const T* b, const int* ks_idx, const int* bound,
              float* part, T* out, int N, int H, int W, int C, int Ho, int Wo, int K,
              int stride, int n_ks, int ks0, int ks1, int ks2, int ks3, int segs, int G,
              void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Geom g{N, H, W, C, Ho, Wo};
  const KsTable tab{n_ks, {ks0, ks1, ks2, ks3}};
  if (N < 1 || H < 1 || W < 1 || C < 1 || n_ks < 1 || n_ks > 4 ||
      (dir == WGRAD && (segs < 1 || G < 1)))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_ks; ++i)
    if (tab.ks[i] < 1 || tab.ks[i] > K || !(tab.ks[i] & 1)) return (int)cudaErrorInvalidValue;
#define DW_CASE(KK, SS)                                                                 \
  if (K == KK && stride == SS) {                                                        \
    launch_dir<T, KK, SS>(dir, a, b, ks_idx, bound, part, out, g, tab, segs, G, stream); \
    return (int)cudaGetLastError();                                                     \
  }
  DW_CASE(3, 1) DW_CASE(3, 2) DW_CASE(5, 1) DW_CASE(5, 2) DW_CASE(7, 1) DW_CASE(7, 2)
#undef DW_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// forward: x [N,H,W,C], w [C,1,K,K] -> y [N,Ho,Wo,C]
extern "C" int ofa_dw_masked_fwd_f32(const float* x, const float* w, const int* ks_idx,
                                     const int* bound, float* y, int N, int H, int W, int C,
                                     int Ho, int Wo, int K, int stride, int n_ks, int ks0,
                                     int ks1, int ks2, int ks3, void* stream) {
  return dw_masked<float>(FWD, x, w, ks_idx, bound, nullptr, y, N, H, W, C, Ho, Wo, K, stride,
                          n_ks, ks0, ks1, ks2, ks3, 0, 0, stream);
}

extern "C" int ofa_dw_masked_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                      const int* ks_idx, const int* bound, __nv_bfloat16* y,
                                      int N, int H, int W, int C, int Ho, int Wo, int K,
                                      int stride, int n_ks, int ks0, int ks1, int ks2, int ks3,
                                      void* stream) {
  return dw_masked<__nv_bfloat16>(FWD, x, w, ks_idx, bound, nullptr, y, N, H, W, C, Ho, Wo, K,
                                  stride, n_ks, ks0, ks1, ks2, ks3, 0, 0, stream);
}

// dgrad: dy [N,Ho,Wo,C], w [C,1,K,K] -> dx [N,H,W,C]
extern "C" int ofa_dw_masked_dgrad_f32(const float* dy, const float* w, const int* ks_idx,
                                       const int* bound, float* dx, int N, int H, int W, int C,
                                       int Ho, int Wo, int K, int stride, int n_ks, int ks0,
                                       int ks1, int ks2, int ks3, void* stream) {
  return dw_masked<float>(DGRAD, dy, w, ks_idx, bound, nullptr, dx, N, H, W, C, Ho, Wo, K,
                          stride, n_ks, ks0, ks1, ks2, ks3, 0, 0, stream);
}

extern "C" int ofa_dw_masked_dgrad_bf16(const __nv_bfloat16* dy, const __nv_bfloat16* w,
                                        const int* ks_idx, const int* bound,
                                        __nv_bfloat16* dx, int N, int H, int W, int C, int Ho,
                                        int Wo, int K, int stride, int n_ks, int ks0, int ks1,
                                        int ks2, int ks3, void* stream) {
  return dw_masked<__nv_bfloat16>(DGRAD, dy, w, ks_idx, bound, nullptr, dx, N, H, W, C, Ho, Wo,
                                  K, stride, n_ks, ks0, ks1, ks2, ks3, 0, 0, stream);
}

// wgrad: x [N,H,W,C], dy [N,Ho,Wo,C] -> dW [C,1,K,K]; part: G*C*K*K floats
// of scratch; segs: the row segments (TW outputs along a row) a pass-1
// block sums, G = ceil(N*Ho*ceil(Wo/TW) / segs) blocks along them
extern "C" int ofa_dw_masked_wgrad_f32(const float* x, const float* dy, const int* ks_idx,
                                       const int* bound, float* part, float* dw, int N, int H,
                                       int W, int C, int Ho, int Wo, int K, int stride,
                                       int n_ks, int ks0, int ks1, int ks2, int ks3, int segs,
                                       int G, void* stream) {
  return dw_masked<float>(WGRAD, x, dy, ks_idx, bound, part, dw, N, H, W, C, Ho, Wo, K, stride,
                          n_ks, ks0, ks1, ks2, ks3, segs, G, stream);
}

extern "C" int ofa_dw_masked_wgrad_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                                        const int* ks_idx, const int* bound, float* part,
                                        __nv_bfloat16* dw, int N, int H, int W, int C, int Ho,
                                        int Wo, int K, int stride, int n_ks, int ks0, int ks1,
                                        int ks2, int ks3, int segs, int G, void* stream) {
  return dw_masked<__nv_bfloat16>(WGRAD, x, dy, ks_idx, bound, part, dw, N, H, W, C, Ho, Wo,
                                  K, stride, n_ks, ks0, ks1, ks2, ks3, segs, G, stream);
}

extern "C" const char* ofa_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
