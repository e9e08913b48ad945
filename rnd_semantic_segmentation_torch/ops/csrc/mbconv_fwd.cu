// Fused MBConv segment forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rnd_semantic_segmentation_tpu/ops/mbconv.py:
// _kernel (launched by fused_mbconv_core_pallas).  Same function as its oracle
// fused_mbconv_core_jnp, per image and output channel f:
//   e[f,h,w] = swish(s0[f] * sum_c w_exp[f,c] * x[c,h,w] + b0[f])     1x1 expand
//   y[f,h,w] = swish(s1[f] * sum_{dr,dc} w_dw[f,dr,dc] * e[f,h+dr-p,w+dc-p] + b1[f])
// with p = (k-1)/2 and e taken as ZERO outside the image (TF-SAME, stride 1):
// the expand value of a padded position would be swish(b0[f]), not zero, so
// the kernel writes zero there.
// Layout is NCHW, contiguous: x [B,C,H,W], w_exp [F,C], w_dw [F,k,k], the four
// affines [F], out [B,F,H,W].  x and w_exp are float32 or bfloat16 (the same
// type); the affines and w_dw are float32; the product accumulates in float32,
// the expand value in shared memory, the stencil and both swishes are float32;
// out is written in x's type.  swish(v) = v / (1 + exp(-v)), with the fast
// exponential and division (relative error near 1e-6).  Pointers need only
// the alignment of their element.
//
// What bounds it on this card: the expand product.  At B=8 it is 2C of the
// 2C + 2k^2 + 12 operations per output (704 of 734 at 16x16, C=352 -> F=2112),
// 3.2 GFLOP there; the function's bytes (x and y once) take 5 us at 3.35 TB/s.
// On the tensor cores that product is worth 20 us in float32 (three TF32
// passes at 495 TFLOP/s) and 3 us in bfloat16; the stencil and swishes stay on
// the float32 pipes.  Only at 128x128, C=24 -> F=144 do the bytes decide.
//
// Design: one block per (image, 16x16 output tile, chunk of 48 output
// channels), 256 threads in 8 warps.
//   1. The product on tensor cores, warp-level mma.sync.  M = the pixels of
//      the tile's halo that lie INSIDE the image (an nr x nc rectangle,
//      numbered row by row; halo pixels outside the image are never staged or
//      multiplied: at a 16x16 map M is 256, not 324 or 400), N = 48 channels,
//      K = C.  Warps form a 4 x 2 grid: a warp takes every fourth 16-row M
//      tile and 3 n-tiles of 8 channels.
//      float32: m16n8k8 TF32 with a 3xTF32 split, hi = a rounded to TF32
//      and lo = (a - hi) rounded to TF32, both to nearest with ties away (what
//      cvt.rna.tf32.f32 gives, done by an integer add and mask, since the
//      conversion instruction runs at a quarter of the rate), accumulating
//      a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small terms first): float32
//      accuracy, never a single pass.
//      bfloat16: m16n8k16, whose products are exact in the f32 accumulator;
//      its A fragments come from the channel-major staging by ldmatrix.trans.
//   2. Staging in slices of 16 input channels through a ring of three
//      buffers: slices s+1 and s+2 are in flight while the tensor cores work
//      on slice s, one barrier a slice.  x lands channel-major, [16][M].
//      Where the rectangle's rows are whole image rows (nc == W: the 16x16
//      maps) they are one contiguous run in memory and go by 16-byte cp.async
//      when aligned; otherwise float32 goes by 4-byte cp.async (a halo row
//      starts at column w0 - p, and the packed rows rarely line up) and
//      bfloat16 by plain loads, which cp.async cannot take in 2-byte pieces.
//      w_exp goes by 16-byte cp.async when C is a multiple of the vector.
//      Out-of-range channels are zero-filled: C is padded only to the mma's
//      K step (8 for TF32, 16 for bf16).  Row strides (8 mod 32 words for
//      float32 x, an odd number of 16-byte units for bf16 x, 4 mod 8 words
//      for w_exp) make every fragment load hit distinct banks.
//   3. The epilogue applies the first affine and swish to the accumulators
//      and leaves e in shared memory (float32, 48 planes, plane stride 4 mod
//      32 words, so a warp's stores hit 32 banks), in the same bytes the
//      staging used; halo positions outside the image are written as zero.
//   4. The stencil: a half-warp spans the tile's 16 columns, the two halves
//      of a warp take channels 4 apart (disjoint banks); a thread slides down
//      the tile's 16 output rows of one channel, reading each e row segment
//      once; then the second affine and swish, and the store.
// Shared memory does not depend on C, F, H or W: 100 KB at k=5, 84 KB at k=3
// (float32), opted in with cudaFuncSetAttribute; two blocks an SM.  F = 6C is
// a multiple of 48 at every fused EfficientNet-B2 shape, so no chunk is
// wasted there; any F works, masked.  Known costs: the halo is recomputed per
// tile inside the image (1.27x at k=3, 1.56x at k=5 for interior tiles), each
// 48-channel chunk re-reads its x tile (from L2), and mma.sync reaches about
// half of what wgmma could.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;      // output tile: kTile x kTile pixels
constexpr int kFC = 48;        // output channels per block
constexpr int kWarpsM = 4;     // warps along the pixels of the product
constexpr int kWarpsN = 2;     // warps along its channels
constexpr int kNT = kFC / (8 * kWarpsN);  // n-tiles of 8 channels per warp
constexpr int kKS = 16;        // input channels per staged slice
constexpr int kRing = 3;       // staging buffers
constexpr int kStage = 2;      // pixels per thread and channel without 16-byte copies

// n rounded up to r mod 32
constexpr int round_to(int n, int r) { return n + ((r - n % 32) % 32 + 32) % 32; }
// n rounded up to a multiple of 8 whose eighth is odd
constexpr int odd_octets(int n) { return (n + 7) / 8 % 2 ? (n + 7) / 8 * 8 : (n + 7) / 8 * 8 + 8; }

template <typename T, int K>
struct Geom {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kPer = 4 / sizeof(T);                // elements per 32-bit word
  static constexpr int P = (K - 1) / 2;
  static constexpr int PW = kTile + 2 * P;                  // halo tile width = height
  static constexpr int HP = PW * PW;                        // halo pixels
  static constexpr int MTILES = (HP + 15) / 16;             // most 16-row M tiles
  static constexpr int MT = (MTILES + kWarpsM - 1) / kWarpsM;  // M tiles per warp
  // elements per staged x channel row
  static constexpr int XS = kF32 ? round_to(MTILES * 16, 8) : odd_octets(MTILES * 16);
  static constexpr int XWORDS = kKS * XS / kPer;            // words of a staged x slice
  static constexpr int WS = kKS / kPer + 4;                 // words per staged w_exp row
  static constexpr int BUF = XWORDS + kFC * WS;             // words of one staging buffer
  static constexpr int ES = round_to(HP, 4);                // e plane stride, 4 mod 32
  static constexpr int UNION = kFC * ES > kRing * BUF ? kFC * ES : kRing * BUF;
  static constexpr int kWords = UNION + kFC * K * K + 4 * kFC + HP;
  static constexpr size_t kSmemBytes = sizeof(uint32_t) * kWords;
  static_assert(HP <= kStage * kThreads, "x staging covers the halo tile");
  static_assert(ES % 32 == 4 && WS % 8 == 4, "bank-conflict-free strides");
  static_assert(kF32 ? XS % 32 == 8 : XS / 8 % 2 == 1, "bank-conflict-free x rows");
  static_assert(XWORDS % 4 == 0 && BUF % 4 == 0 && WS % 4 == 0, "16-byte aligned rows");
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// v * sigmoid(v); __expf(-v) = inf for very negative v gives v * 0 = -0
__device__ __forceinline__ float swish(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the result of cvt.rna.tf32.f32 for every finite x, in one integer add
// and mask instead of an instruction of the quarter-rate conversion pipe
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32: hi keeps 11 significant bits, lo the next 11
// (a NaN stays a NaN in lo)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices, transposed: lane i names row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(smem_addr(row)));
}

// asynchronous copies to shared memory, zero-filled when !valid (src is then
// not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 2)
fused_mbconv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_exp,
                        const float* __restrict__ s0, const float* __restrict__ b0,
                        const float* __restrict__ w_dw, const float* __restrict__ s1,
                        const float* __restrict__ b1, T* __restrict__ out,
                        int C, int F, int H, int W, int tiles_w, int tiles_per_image,
                        int f_chunks) {
  using G = Geom<T, K>;
  constexpr int P = G::P, PW = G::PW, HP = G::HP, MT = G::MT, XS = G::XS, ES = G::ES;
  constexpr int WS = G::WS, BUF = G::BUF, XWORDS = G::XWORDS;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  using E = typename std::conditional<G::kF32, float, uint16_t>::type;  // staged element
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* stage = smem;                                  // [kRing][BUF] during the product
  float* es = reinterpret_cast<float*>(smem);              // [kFC][ES] after it
  float* wd = reinterpret_cast<float*>(smem + G::UNION);   // [kFC][K*K] depthwise weights
  float* aff = wd + kFC * K * K;                           // [4][kFC]  s0, b0, s1, b1
  int* ptab = reinterpret_cast<int*>(aff + 4 * kFC);       // [HP] halo position of m

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
  const E* xb = reinterpret_cast<const E*>(x) + b * C * plane;
  const E* wx = reinterpret_cast<const E*>(w_exp);

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

  // the halo rows [rlo, rhi) and columns [clo, chi) that lie inside the
  // image; the product's M index m runs over that rectangle row by row
  const int rlo = max(0, P - h0), rhi = min(PW, H - h0 + P);
  const int clo = max(0, P - w0), chi = min(PW, W - w0 + P);
  const int nc = chi - clo, mv = (rhi - rlo) * nc;
  const int mtiles = (mv + 15) / 16;
  for (int m = tid; m < mv; m += kThreads) ptab[m] = (rlo + m / nc) * PW + clo + m % nc;

  // the image-plane offset of m = 0; where the rectangle's rows are whole
  // image rows, m is at g0 + m and a channel's slice is one contiguous run
  const int g0 = (h0 - P + rlo) * W + (w0 - P + clo);
  const int nv = mv / kVec;  // 16-byte vectors per channel row of the run
  const bool xvec = nc == W && mv % kVec == 0 && plane % kVec == 0 &&
                    reinterpret_cast<uintptr_t>(xb + g0) % 16 == 0;
  const float inv_nv = 1.f / static_cast<float>(max(nv, 1));
  const bool wvec = C % kVec == 0 && reinterpret_cast<uintptr_t>(wx) % 16 == 0;
  // otherwise the pixels this thread stages for every channel: offset in an
  // image plane, or -1 past the rectangle
  int xoff[kStage];
#pragma unroll
  for (int j = 0; j < kStage; ++j) {
    const int m = tid + j * kThreads;
    xoff[j] = m < mv ? g0 + (m / nc) * W + m % nc : -1;
  }

  // stage slice s (channels s*kKS ...) into buffer buf
  auto issue = [&](int s, uint32_t* buf) {
    const int c0 = s * kKS;
    E* xs = reinterpret_cast<E*>(buf);  // [kKS][XS]
    if (xvec) {
      for (int i = tid; i < kKS * nv; i += kThreads) {
        const int kk = static_cast<int>((static_cast<float>(i) + 0.5f) * inv_nv);
        const int v = i - kk * nv;
        const bool ok = c0 + kk < C;
        cp_async16(xs + kk * XS + v * kVec, ok ? xb + (c0 + kk) * plane + g0 + v * kVec : xb,
                   ok);
      }
    } else if constexpr (G::kF32) {
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        if (xoff[j] < 0) continue;
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          const bool ok = c0 + kk < C;
          cp_async4(xs + kk * XS + tid + j * kThreads,
                    ok ? xb + (c0 + kk) * plane + xoff[j] : xb, ok);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        if (xoff[j] < 0) continue;
        E v[kKS];
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk)
          v[kk] = c0 + kk < C ? xb[(c0 + kk) * plane + xoff[j]] : E(0);
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) xs[kk * XS + tid + j * kThreads] = v[kk];
      }
    }
    E* ws = reinterpret_cast<E*>(buf + XWORDS);  // [kFC][WS words]
    constexpr int WE = WS * G::kPer;             // elements per staged w_exp row
    if (wvec) {
      constexpr int nw = kKS / kVec;
      for (int i = tid; i < kFC * nw; i += kThreads) {
        const int n = i / nw, c = c0 + (i % nw) * kVec;
        const bool ok = f0 + n < F && c < C;
        cp_async16(ws + n * WE + (i % nw) * kVec,
                   ok ? wx + static_cast<int64_t>(f0 + n) * C + c : wx, ok);
      }
    } else {
      for (int i = tid; i < kFC * kKS; i += kThreads) {
        const int n = i / kKS, kk = i % kKS;
        const bool ok = f0 + n < F && c0 + kk < C;
        const E* src = ok ? wx + static_cast<int64_t>(f0 + n) * C + c0 + kk : wx;
        if constexpr (G::kF32) {
          cp_async4(ws + n * WE + kk, src, ok);
        } else {
          ws[n * WE + kk] = ok ? *src : E(0);
        }
      }
    }
  };

  // 1-2. the expand product: acc[i][j] is the 16x8 tile of M tile
  // wm + i*kWarpsM and channels wn*kNT*8 + j*8
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, thread in group
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  float acc[MT][kNT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int slices = (C + kKS - 1) / kKS;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < slices) issue(s, stage + s * BUF);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // slice s has landed; every warp is done with slice s-1
    const int ahead = s + kRing - 1;
    if (ahead < slices) issue(ahead, stage + (ahead % kRing) * BUF);
    cp_async_commit();
    const uint32_t* xs = stage + (s % kRing) * BUF;
    const uint32_t* ws = xs + XWORDS;
    if constexpr (G::kF32) {
      const int ksteps = (min(kKS, C - s * kKS) + 7) / 8;
      const float* xf = reinterpret_cast<const float*>(xs);
      const float* wf = reinterpret_cast<const float*>(ws);
#pragma unroll
      for (int ks = 0; ks < kKS / 8; ++ks) {
        if (ks >= ksteps) break;
        const int kk = ks * 8;
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* wp = wf + (wn * kNT * 8 + j * 8 + g) * WS + kk + t;
          split_tf32(wp[0], bh[j][0], bl[j][0]);
          split_tf32(wp[4], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int mt = wm + i * kWarpsM;
          if (mt >= mtiles) break;
          const float* xp = xf + (kk + t) * XS + mt * 16 + g;
          uint32_t ah[4], al[4];
          split_tf32(xp[0], ah[0], al[0]);
          split_tf32(xp[8], ah[1], al[1]);
          split_tf32(xp[4 * XS], ah[2], al[2]);
          split_tf32(xp[4 * XS + 8], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            mma_tf32(acc[i][j], al, bh[j]);
            mma_tf32(acc[i][j], ah, bl[j]);
            mma_tf32(acc[i][j], ah, bh[j]);
          }
        }
      }
    } else {
      uint32_t bw[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t* wp = ws + (wn * kNT * 8 + j * 8 + g) * WS + t;
        bw[j][0] = wp[0];
        bw[j][1] = wp[4];
      }
      // ldmatrix rows: matrices 0..3 are (k 0-7, m 0-7), (k 0-7, m 8-15),
      // (k 8-15, m 0-7), (k 8-15, m 8-15) of the channel-major slice
      const uint16_t* xrow = reinterpret_cast<const uint16_t*>(xs) +
                             ((lane >> 4) * 8 + (lane & 7)) * XS + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = wm + i * kWarpsM;
        if (mt >= mtiles) break;
        uint32_t a[4];
        ldmatrix_x4_trans(a, xrow + mt * 16);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a, bw[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the staged slices: e reuses them

  // 3. first affine and swish into e; zero at halo positions outside the
  // image (channels >= F have zero affines and give swish(0) = 0)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = wm + i * kWarpsM;
    if (mt >= mtiles) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + g + 8 * half;
      if (m >= mv) continue;
      const int pos = ptab[m];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = wn * kNT * 8 + j * 8 + 2 * t + q;
          es[n * ES + pos] = swish(fmaf(acc[i][j][2 * half + q], aff[n], aff[kFC + n]));
        }
      }
    }
  }
  if (mv < HP) {
    for (int i = tid; i < kFC * PW; i += kThreads) {
      const int r = i % PW;
      float* row = es + (i / PW) * ES + r * PW;
      const bool outside = r < rlo || r >= rhi;
#pragma unroll
      for (int c = 0; c < PW; ++c)
        if (outside || c < clo || c >= chi) row[c] = 0.f;
    }
  }
  __syncthreads();

  // 4. the stencil: a half-warp spans the tile's 16 columns, the two halves
  // of a warp take channels 4 apart; each thread slides down the tile's
  // kTile output rows
  const int tw = lane & 15, fsub = lane >> 4;
  for (int pair = warp; pair < kFC / 2; pair += kThreads / 32) {
    const int fl = (pair / 4) * 8 + pair % 4 + 4 * fsub;
    const int f = f0 + fl;
    float wk[K * K];
#pragma unroll
    for (int q = 0; q < K * K; ++q) wk[q] = wd[fl * K * K + q];
    float o[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) o[r] = 0.f;
    const float* ep = es + fl * ES + tw;
#pragma unroll
    for (int ir = 0; ir < kTile + K - 1; ++ir) {
      float v[K];
#pragma unroll
      for (int dc = 0; dc < K; ++dc) v[dc] = ep[ir * PW + dc];
#pragma unroll
      for (int dr = 0; dr < K; ++dr) {
        const int r = ir - dr;  // the output row that reads input row ir at tap dr
        if (r >= 0 && r < kTile) {
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
      for (int r = 0; r < kTile; ++r) {
        const int gh = h0 + r;
        if (gh < H) store(op + static_cast<int64_t>(gh) * W, swish(fmaf(o[r], sc, sh)));
      }
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w_exp, const float* s0, const float* b0,
                   const float* w_dw, const float* s1, const float* b1, void* out,
                   int B, int C, int F, int H, int W, cudaStream_t stream) {
  using G = Geom<T, K>;
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

// registers, local (spill) bytes, dynamic shared bytes and resident blocks
// per SM of one instance, as the runtime reports them
template <typename T, int K>
cudaError_t info(int* res) {
  using G = Geom<T, K>;
  auto kernel = fused_mbconv_fwd_kernel<T, K>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kSmemBytes));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  res[0] = attr.numRegs;
  res[1] = static_cast<int>(attr.localSizeBytes);
  res[2] = static_cast<int>(G::kSmemBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[3], kernel, kThreads,
                                                       G::kSmemBytes);
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

// res[4] = {registers, local bytes, dynamic shared bytes, blocks per SM} of
// the instance for (K, dtype); returns a cudaError_t.
extern "C" int fused_mbconv_info(int K, int dtype, int* res) {
  if (dtype == 0 && K == 3) return info<float, 3>(res);
  if (dtype == 0 && K == 5) return info<float, 5>(res);
  if (dtype == 1 && K == 3) return info<__nv_bfloat16, 3>(res);
  if (dtype == 1 && K == 5) return info<__nv_bfloat16, 5>(res);
  return static_cast<int>(cudaErrorInvalidValue);
}
