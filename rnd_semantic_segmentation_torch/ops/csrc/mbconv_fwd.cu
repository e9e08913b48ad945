// Fused MBConv segment forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rnd_semantic_segmentation_tpu/ops/mbconv.py:
// _kernel (launched by fused_mbconv_core_pallas).  Same function as its oracle
// fused_mbconv_core_jnp, per image and output channel f:
//   e[f,h,w] = swish(s0[f] * sum_c w_exp[f,c] * x[c,h,w] + b0[f])     1x1 expand
//   y[f,h,w] = swish(s1[f] * sum_{dr,dc} w_dw[f,dr,dc] * e[f,h+dr-p,w+dc-p] + b1[f])
// with p = (k-1)/2 and e taken as ZERO outside the image (TF-SAME, stride 1):
// the expand value of a padded position would be swish(b0[f]), not zero, so
// the kernel zeroes it by the position's global row and column.
// Layout is NCHW, contiguous: x [B,C,H,W], w_exp [F,C], w_dw [F,k,k], the four
// affines [F], out [B,F,H,W].  x and w_exp are float32 or bfloat16 (the same
// type); the affines and w_dw are float32; the product, the expand value in
// shared memory, the stencil and both swishes run in float32; out is written
// in x's type.  swish(v) = v / (1 + expf(-v)).
//
// What bounds it on this card: in float32, operations.  At B=8, 128x128,
// C=24 -> F=144, k=3 the function reads x and writes y once, 88 MB or 26 us at
// 3.35 TB/s, and does B*H*W*F*(2C + 2k^2 + 12) = 1.5 GFLOP, 22 us at the
// 67 TFLOP/s float32 rate; at 16x16, C=352 -> F=2112 the product dominates
// (3.2 GFLOP, 47 us) against 5 us of traffic.  The unfused path writes and
// re-reads the F-wide tensor several times; this kernel never writes e.
//
// Design (simple first): one block per (image, 16x16 output tile, chunk of 32
// output channels), 256 threads.
//   1. The product for the tile plus its halo, (16+2p)^2 pixels by 32
//      channels, is a shared-memory tiled SGEMM on the float32 pipes: x and
//      w_exp are staged 16 input channels at a time, each thread keeps an
//      8-channel by 6- or 7-pixel register tile.  Halo pixels outside the image
//      are staged as zero.
//   2. Its epilogue applies the first affine and swish, zeroes positions
//      outside the image and leaves e in shared memory (float32), 32 planes
//      whose stride is 16 mod 32 words so that the stencil's half-warps, which
//      work on two channels at once, hit disjoint banks.
//   3. The stencil: a thread owns a column strip of 8 output rows of one
//      channel and slides down it, reading each e row segment once; then the
//      second affine and swish, and the store.
// Shared memory per block does not depend on C, F, H or W: 72 KB (k=3) or
// 86 KB (k=5), above the 48 KB a block gets without opting in,
// so the launcher raises the limit with cudaFuncSetAttribute; two blocks fit
// an SM.  Known costs of this design: the halo is recomputed per tile
// ((16+2p)^2/256 = 1.27x at k=3, 1.56x at k=5), halo positions outside the
// image are multiplied like any other, every chunk of 32 channels re-reads
// its x tile (from L2), and the product runs on CUDA cores, not wgmma, also
// for bfloat16 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;      // output tile: kTile x kTile pixels
constexpr int kFC = 32;        // output channels per block
constexpr int kKC = 16;        // input channels staged per step of the product
constexpr int kRN = 8;         // channels per thread in the product
constexpr int kTR = kThreads / (kFC / kRN);  // 64 thread rows over the pixels
constexpr int kWsStride = kFC + 4;           // staged w_exp rows, 16-byte aligned
constexpr int kStrip = 8;      // output rows per stencil strip
constexpr int kLoadsPerThread = 2;           // staged pixels per thread and channel

template <int K>
struct Geom {
  static constexpr int P = (K - 1) / 2;
  static constexpr int PW = kTile + 2 * P;               // halo tile width = height
  static constexpr int HP = PW * PW;                     // halo pixels
  static constexpr int MI = (HP + kTR - 1) / kTR;        // pixels per thread
  static constexpr int XS = MI * kTR;                    // stride of a staged x row
  static constexpr int ES = HP + (16 - HP % 32 + 32) % 32;  // plane stride, 16 mod 32
  static constexpr int kFloats = kFC * ES + kKC * XS + kKC * kWsStride + kFC * K * K + 4 * kFC;
  static constexpr size_t kSmemBytes = sizeof(float) * kFloats;
  static_assert(XS <= kLoadsPerThread * kThreads, "x staging covers the halo tile");
  static_assert(ES % 32 == 16 && ES >= HP, "bank-conflict-free plane stride");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// v * sigmoid(v); expf(-v) = inf for very negative v gives v / inf = -0
__device__ __forceinline__ float swish(float v) { return v / (1.f + expf(-v)); }

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2)
fused_mbconv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_exp,
                        const float* __restrict__ s0, const float* __restrict__ b0,
                        const float* __restrict__ w_dw, const float* __restrict__ s1,
                        const float* __restrict__ b1, T* __restrict__ out,
                        int C, int F, int H, int W, int tiles_w, int tiles_per_image,
                        int f_chunks) {
  using G = Geom<K>;
  constexpr int P = G::P, PW = G::PW, HP = G::HP, MI = G::MI, XS = G::XS, ES = G::ES;
  extern __shared__ __align__(16) float smem[];
  float* es = smem;                    // [kFC][ES]   expand values, tile plus halo
  float* xs = es + kFC * ES;           // [kKC][XS]   staged x
  float* ws = xs + kKC * XS;           // [kKC][kWsStride] staged w_exp, transposed
  float* wd = ws + kKC * kWsStride;    // [kFC][K*K]  depthwise weights
  float* aff = wd + kFC * K * K;       // [4][kFC]    s0, b0, s1, b1

  const int tid = threadIdx.x;
  // block -> (image, tile, channel chunk); the chunk runs fastest, so blocks
  // that are resident together share their x tile in L2
  int64_t blk = blockIdx.x;
  const int f0 = static_cast<int>(blk % f_chunks) * kFC;
  blk /= f_chunks;
  const int tile = static_cast<int>(blk % tiles_per_image);
  const int64_t b = blk / tiles_per_image;
  const int h0 = (tile / tiles_w) * kTile, w0 = (tile % tiles_w) * kTile;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* xb = x + b * C * plane;

  for (int i = tid; i < kFC; i += kThreads) {
    const int f = f0 + i;
    const bool ok = f < F;
    aff[i] = ok ? s0[f] : 0.f;
    aff[kFC + i] = ok ? b0[f] : 0.f;
    aff[2 * kFC + i] = ok ? s1[f] : 0.f;
    aff[3 * kFC + i] = ok ? b1[f] : 0.f;
  }
  for (int i = tid; i < kFC * K * K; i += kThreads) {
    const int64_t g = static_cast<int64_t>(f0) * K * K + i;
    wd[i] = g < static_cast<int64_t>(F) * K * K ? w_dw[g] : 0.f;
  }

  // the halo pixels this thread stages for every input channel: their offset
  // in an image plane, or -1 outside the image (staged as zero)
  int xoff[kLoadsPerThread];
#pragma unroll
  for (int j = 0; j < kLoadsPerThread; ++j) {
    const int m = tid + j * kThreads;
    xoff[j] = -1;
    if (m < HP) {
      const int gh = h0 - P + m / PW, gw = w0 - P + m % PW;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) xoff[j] = gh * W + gw;
    }
  }

  // 1. the expand product: acc[i][j] for pixel tr + i*kTR, channel tn*kRN + j
  const int tr = tid % kTR, tn = tid / kTR;
  float acc[MI][kRN];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kKC) {
#pragma unroll
    for (int j = 0; j < kLoadsPerThread; ++j) {
      const int m = tid + j * kThreads;
      if (m < XS) {
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) {
          const int c = c0 + kk;
          xs[kk * XS + m] = (xoff[j] >= 0 && c < C) ? to_f32(xb[c * plane + xoff[j]]) : 0.f;
        }
      }
    }
    for (int i = tid; i < kFC * kKC; i += kThreads) {
      const int kk = i % kKC, fl = i / kKC;
      const int f = f0 + fl, c = c0 + kk;
      ws[kk * kWsStride + fl] =
          (f < F && c < C) ? to_f32(w_exp[static_cast<int64_t>(f) * C + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 wa = *reinterpret_cast<const float4*>(ws + kk * kWsStride + tn * kRN);
      const float4 wb = *reinterpret_cast<const float4*>(ws + kk * kWsStride + tn * kRN + 4);
      const float wv[kRN] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float xv = xs[kk * XS + tr + i * kTR];
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // 2. first affine and swish; zero outside the image (channels >= F have
  // zero affines and give swish(0) = 0)
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int m = tr + i * kTR;
    if (m < HP) {
      const int gh = h0 - P + m / PW, gw = w0 - P + m % PW;
      const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int fl = tn * kRN + j;
        const float v = fmaf(acc[i][j], aff[fl], aff[kFC + fl]);
        es[fl * ES + m] = inside ? swish(v) : 0.f;
      }
    }
  }
  __syncthreads();

  // 3. the stencil: a half-warp spans the tile's 16 columns, the two halves
  // of a warp take two neighbouring channels; each thread slides down a strip
  // of kStrip output rows
  const int lane = tid & 31, warp = tid >> 5;
  const int tw = lane & 15, fsub = lane >> 4;
  constexpr int kRowGroups = kTile / kStrip;
  for (int item = warp; item < (kFC / 2) * kRowGroups; item += kThreads / 32) {
    const int r0 = (item % kRowGroups) * kStrip;
    const int fl = (item / kRowGroups) * 2 + fsub;
    const int f = f0 + fl;
    if (h0 + r0 >= H) continue;
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = wd[fl * K * K + t];
    float o[kStrip];
#pragma unroll
    for (int r = 0; r < kStrip; ++r) o[r] = 0.f;
    const float* ep = es + fl * ES + r0 * PW + tw;
#pragma unroll
    for (int ir = 0; ir < kStrip + K - 1; ++ir) {
      float v[K];
#pragma unroll
      for (int dc = 0; dc < K; ++dc) v[dc] = ep[ir * PW + dc];
#pragma unroll
      for (int dr = 0; dr < K; ++dr) {
        const int r = ir - dr;  // the output row that reads input row ir at tap dr
        if (r >= 0 && r < kStrip) {
#pragma unroll
          for (int dc = 0; dc < K; ++dc) o[r] = fmaf(v[dc], wk[dr * K + dc], o[r]);
        }
      }
    }
    const int gw = w0 + tw;
    if (f < F && gw < W) {
      const float sc = aff[2 * kFC + fl], sh = aff[3 * kFC + fl];
      T* op = out + (b * F + f) * plane + gw;
#pragma unroll
      for (int r = 0; r < kStrip; ++r) {
        const int gh = h0 + r0 + r;
        if (gh < H) store(op + static_cast<int64_t>(gh) * W, swish(fmaf(o[r], sc, sh)));
      }
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w_exp, const float* s0, const float* b0,
                   const float* w_dw, const float* s1, const float* b1, void* out,
                   int B, int C, int F, int H, int W, cudaStream_t stream) {
  using G = Geom<K>;
  auto kernel = fused_mbconv_fwd_kernel<T, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kSmemBytes));
  if (err != cudaSuccess) return err;
  const int tiles_h = (H + kTile - 1) / kTile, tiles_w = (W + kTile - 1) / kTile;
  const int f_chunks = (F + kFC - 1) / kFC;
  const int64_t blocks = static_cast<int64_t>(B) * tiles_h * tiles_w * f_chunks;
  if (blocks <= 0 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, G::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_exp), s0, b0, w_dw, s1, b1,
      static_cast<T*>(out), C, F, H, W, tiles_w, tiles_h * tiles_w, f_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, const void* w_exp, const float* s0, const float* b0,
                     const float* w_dw, const float* s1, const float* b1, void* out,
                     int B, int C, int F, int H, int W, int K, cudaStream_t stream) {
  switch (K) {
    case 3: return launch<T, 3>(x, w_exp, s0, b0, w_dw, s1, b1, out, B, C, F, H, W, stream);
    case 5: return launch<T, 5>(x, w_exp, s0, b0, w_dw, s1, b1, out, B, C, F, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, w_exp and out).  K is 3 or 5.
// Returns the cudaError_t of the launch.
extern "C" int fused_mbconv_fwd(const void* x, const void* w_exp, const void* s0,
                                const void* b0, const void* w_dw, const void* s1,
                                const void* b1, void* out, int B, int C, int F, int H,
                                int W, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fs0 = static_cast<const float*>(s0);
  const float* fb0 = static_cast<const float*>(b0);
  const float* fwd = static_cast<const float*>(w_dw);
  const float* fs1 = static_cast<const float*>(s1);
  const float* fb1 = static_cast<const float*>(b1);
  if (dtype == 0)
    return launch_k<float>(x, w_exp, fs0, fb0, fwd, fs1, fb1, out, B, C, F, H, W, K, s);
  if (dtype == 1)
    return launch_k<__nv_bfloat16>(x, w_exp, fs0, fb0, fwd, fs1, fb1, out, B, C, F, H, W, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
