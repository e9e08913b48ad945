// Criss-cross attention backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rnd_semantic_segmentation_tpu/ops/ccattn.py:
// _cc_bwd_kernel (launched by cc_attention_core_pallas_bwd, wired into the
// custom VJP _cc_pallas_ad).  Given q, k [B,H,W,Cq], v [B,H,W,C] and the
// gradient g [B,H,W,C] of the forward's output, it returns dq, dk, dv.  The
// attention is recomputed, not stored.  Per query pixel p = (b, h, w) with its
// H+W keys j (column keys (b, j, w) for j < H, row keys (b, h, j-H) after):
//   a     = softmax(e) as in the forward, e_h[h] = -inf
//   da[j] = <g[p], v[key_j]>
//   s     = sum_j a[j] * da[j]            over the joint H+W axis
//   de[j] = a[j] * (da[j] - s)
//   dq[p]      = sum_j de[j] * k[key_j]
//   dk[key_j] += de[j] * q[p]
//   dv[key_j] += a[j]  * g[p]
// Layout is NHWC, contiguous.  Inputs are float32 or bfloat16 (all the same
// type); everything inside runs in float32; dq, dk, dv are written in the
// inputs' type.
//
// What bounds it on this card: operations in float32, bytes in bfloat16.  At
// the training shape B=6, H=22, W=40, Cq=32, C=256 (a 1280x720 input) in
// float32 the function must read q, k, v, g and write dq, dk, dv:
// 5280 pixels * (4*32 + 3*256) * 4 bytes = 18.9 MB, about 5.6 us at
// 3.35 TB/s.  Its five contractions do 5280 * 62 * (6*32 + 4*256) = 398 MFLOP,
// 5.9 us at the 67 TFLOP/s float32 rate: the two sides are close.  In
// bfloat16 the bytes halve and the operation rate is the tensor cores', so
// the byte side is the larger by far.
//
// Design (simple first, and repeatable): dq belongs to the query, dk and dv
// belong to the key, so a block per query would have to scatter into dk and
// dv.  Instead there are two device functions and no atomics:
//   pass A, one block per query pixel: recomputes e and the softmax, forms da,
//     s and de, writes dq, and stores a and de into a float32 workspace
//     [B,H,W,H+W] each;
//   pass B, one block per key pixel: gathers from the workspace the
//     coefficients of the H queries of its column and the W queries of its
//     row, and sums de * q into dk and a * g into dv.
// Every sum runs in a fixed order, so two runs on the same inputs give the
// same bits.  The masked entry has a = 0 exactly (exp(-inf - max) with a
// finite max: the row branch is never masked), so de = 0 * (da - s) = 0 and
// it adds nothing to dq, dk or dv; no inf - inf or 0 * inf is formed.
// Pass A keeps 2*(H+W) + Cq + C floats in dynamic shared memory, pass B
// 2*(H+W).  Like the forward, pass A reads the k and v rows of its column
// and row again for every query; a tile of queries per block that shares
// those rows from shared memory is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Reduces one value per thread over the block; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float y = lane < kWarps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
    y = kMax ? warp_max(y) : warp_sum(y);
    if (lane == 0) scratch[kWarps] = y;
  }
  __syncthreads();
  const float r = scratch[kWarps];
  __syncthreads();  // scratch is reused by the next reduction
  return r;
}

// Pass A: one block per query pixel.  Writes dq and the workspace rows
// ws_a[pix, :] = a and ws_de[pix, :] = de.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cc_attention_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              T* __restrict__ dq, float* __restrict__ ws_a,
                              float* __restrict__ ws_de, int H, int W, int CQ, int C) {
  extern __shared__ float smem[];
  const int n = H + W;
  float* a = smem;         // H + W energies, then exp, then the softmax
  float* da = a + n;       // H + W values <g, v_j>, then de
  float* qs = da + n;      // Cq query values
  float* gs = qs + CQ;     // C gradient values
  __shared__ float scratch[kWarps + 1];

  const int64_t pix = blockIdx.x;  // ((b*H + h)*W + w)
  const int w = static_cast<int>(pix % W);
  const int h = static_cast<int>((pix / W) % H);
  const int64_t bh0 = (pix / W) - h;  // b*H: first row of this image
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int c = tid; c < CQ; c += kThreads) qs[c] = to_f32(q[pix * CQ + c]);
  for (int c = tid; c < C; c += kThreads) gs[c] = to_f32(g[pix * C + c]);
  __syncthreads();

  // one warp per key: j < H walks the column (b, j, w); j >= H the row (b, h, j-H)
  for (int j = warp; j < n; j += kWarps) {
    const int64_t kpix = j < H ? (bh0 + j) * W + w : (bh0 + h) * W + (j - H);
    const T* kr = k + kpix * CQ;
    const T* vr = v + kpix * C;
    float acc_e = 0.f, acc_d = 0.f;
    for (int c = lane; c < CQ; c += 32) acc_e += qs[c] * to_f32(kr[c]);
    for (int c = lane; c < C; c += 32) acc_d += gs[c] * to_f32(vr[c]);
    acc_e = warp_sum(acc_e);
    acc_d = warp_sum(acc_d);
    if (lane == 0) {
      a[j] = (j == h) ? -INFINITY : acc_e;
      da[j] = acc_d;
    }
  }
  __syncthreads();

  float m = -INFINITY;
  for (int j = tid; j < n; j += kThreads) m = fmaxf(m, a[j]);
  m = block_reduce<true>(m, scratch);  // finite: the row branch is never masked

  float den = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    const float p = expf(a[j] - m);  // exactly 0 at the masked entry
    a[j] = p;
    den += p;
  }
  const float inv_den = 1.f / block_reduce<false>(den, scratch);

  float s = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    const float aj = a[j] * inv_den;
    a[j] = aj;
    s += aj * da[j];
  }
  s = block_reduce<false>(s, scratch);

  for (int j = tid; j < n; j += kThreads) {
    const float aj = a[j];
    const float de = aj * (da[j] - s);
    da[j] = de;
    ws_a[pix * n + j] = aj;
    ws_de[pix * n + j] = de;
  }
  __syncthreads();

  const T* kcol = k + static_cast<int64_t>(w) * CQ;               // + (bh0+j)*W*CQ
  const T* krow = k + (bh0 + h) * static_cast<int64_t>(W) * CQ;    // + j*CQ
  for (int c = tid; c < CQ; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < H; ++j)
      acc += da[j] * to_f32(kcol[(bh0 + j) * static_cast<int64_t>(W) * CQ + c]);
    for (int j = 0; j < W; ++j)
      acc += da[H + j] * to_f32(krow[static_cast<int64_t>(j) * CQ + c]);
    store(dq + pix * CQ + c, acc);
  }
}

// Pass B: one block per key pixel r = (b, y, x).  Its queries are the H
// pixels (b, i, x) of its column, which hold it at index y of their joint
// axis, and the W pixels (b, y, i) of its row, which hold it at index H + x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cc_attention_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ g,
                            const float* __restrict__ ws_a,
                            const float* __restrict__ ws_de, T* __restrict__ dk,
                            T* __restrict__ dv, int H, int W, int CQ, int C) {
  extern __shared__ float smem[];
  const int n = H + W;
  float* ca = smem;        // a of each of the H + W queries for this key
  float* cde = smem + n;   // de likewise

  const int64_t pix = blockIdx.x;
  const int x = static_cast<int>(pix % W);
  const int y = static_cast<int>((pix / W) % H);
  const int64_t bh0 = (pix / W) - y;
  const int tid = threadIdx.x;

  for (int i = tid; i < n; i += kThreads) {
    const int64_t qpix = i < H ? (bh0 + i) * W + x : (bh0 + y) * W + (i - H);
    const int idx = i < H ? y : H + x;
    ca[i] = ws_a[qpix * n + idx];
    cde[i] = ws_de[qpix * n + idx];
  }
  __syncthreads();

  const int64_t col0 = bh0 * W + x;        // pixel (b, 0, x); + i*W walks the column
  const int64_t row0 = (bh0 + y) * W;      // pixel (b, y, 0); + i walks the row
  for (int idx = tid; idx < CQ + C; idx += kThreads) {
    float acc = 0.f;
    if (idx < CQ) {
      const int c = idx;
      for (int i = 0; i < H; ++i)
        acc += cde[i] * to_f32(q[(col0 + static_cast<int64_t>(i) * W) * CQ + c]);
      for (int i = 0; i < W; ++i)
        acc += cde[H + i] * to_f32(q[(row0 + i) * CQ + c]);
      store(dk + pix * CQ + c, acc);
    } else {
      const int c = idx - CQ;
      for (int i = 0; i < H; ++i)
        acc += ca[i] * to_f32(g[(col0 + static_cast<int64_t>(i) * W) * C + c]);
      for (int i = 0; i < W; ++i)
        acc += ca[H + i] * to_f32(g[(row0 + i) * C + c]);
      store(dv + pix * C + c, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   void* dq, void* dk, void* dv, float* ws_a, float* ws_de,
                   int B, int H, int W, int CQ, int C, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(B) * H * W);
  const size_t smem_a = static_cast<size_t>(2 * (H + W) + CQ + C) * sizeof(float);
  const size_t smem_b = static_cast<size_t>(2 * (H + W)) * sizeof(float);
  cc_attention_bwd_query_kernel<T><<<blocks, kThreads, smem_a, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), ws_a, ws_de, H, W, CQ, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cc_attention_bwd_key_kernel<T><<<blocks, kThreads, smem_b, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), ws_a, ws_de,
      static_cast<T*>(dk), static_cast<T*>(dv), H, W, CQ, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws_a and ws_de are float32 workspaces of
// B*H*W*(H+W) elements each.  Returns the cudaError_t of the first launch
// that was refused, or 0.
extern "C" int cc_attention_bwd(const void* q, const void* k, const void* v,
                                const void* g, void* dq, void* dk, void* dv,
                                void* ws_a, void* ws_de, int B, int H, int W,
                                int CQ, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wa = static_cast<float*>(ws_a);
  float* wd = static_cast<float*>(ws_de);
  if (dtype == 0)
    return launch<float>(q, k, v, g, dq, dk, dv, wa, wd, B, H, W, CQ, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, wa, wd, B, H, W, CQ, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
