// Criss-cross attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rnd_semantic_segmentation_tpu/ops/ccattn.py:
// _cc_kernel (launched by cc_attention_core_pallas).  Same function as its
// einsum oracle cc_attention_core_jnp: for every query pixel (b, h, w)
//   e_h[j] = <q[b,h,w,:], k[b,j,w,:]>   j in [0,H), e_h[h] = -inf
//   e_w[j] = <q[b,h,w,:], k[b,h,j,:]>   j in [0,W)
//   p      = softmax over the joint H+W concatenation of (e_h, e_w)
//   out    = sum_j p_h[j] v[b,j,w,:] + sum_j p_w[j] v[b,h,j,:]
// Layout is NHWC, contiguous: q, k [B,H,W,Cq]; v, out [B,H,W,C].  Inputs are
// float32 or bfloat16 (all three the same type); energies, the softmax and
// the aggregation run in float32; the output is written in v's type.
//
// What bounds it on this card: bytes.  At the serving shape B=8, H=16, W=32,
// Cq=32, C=256 in float32 the function must read q, k and v and write out:
// 2*4096*32*4 + 2*4096*256*4 = 9.44 MB, about 2.8 us at 3.35 TB/s.  It does
// about 113 MFLOP (2*(H+W)*(Cq+C) per pixel), 1.7 us at the 67 TFLOP/s
// float32 rate, so the memory side is the larger bound.
//
// Design (simple first): one thread block per query pixel.
//   1. the block loads q[b,h,w,:] into shared memory;
//   2. one warp per energy: lanes stride over Cq, a shuffle sum finishes it;
//   3. a block max and a block sum of exp over the H+W energies, in float32;
//   4. threads stride over C and accumulate p_h . v (down the column) and
//      p_w . v (along the row);
//   5. the sums are divided by the softmax denominator.
// Shared memory is (H+W+Cq)*4 bytes plus 32 floats of reduction scratch.
// This design reads each v row again for every query that needs it: a row of
// v is read by the W queries of its row and by the H queries of its column,
// so v traffic reaches the L2 (H+W) times over.  Keeping a tile of queries
// per block so v rows are shared from shared memory is later work.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cc_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        int H, int W, int CQ, int C) {
  extern __shared__ float smem[];
  float* e = smem;              // H + W energies, then exp(e - max)
  float* qs = smem + H + W;     // Cq query values
  __shared__ float scratch[kWarps + 1];

  const int64_t pix = blockIdx.x;  // ((b*H + h)*W + w)
  const int w = static_cast<int>(pix % W);
  const int h = static_cast<int>((pix / W) % H);
  const int64_t bh0 = (pix / W) - h;  // b*H: first row of this image
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = H + W;

  for (int c = tid; c < CQ; c += kThreads) qs[c] = to_f32(q[pix * CQ + c]);
  __syncthreads();

  // energies: j < H walks the column (b, j, w); j >= H walks the row (b, h, j-H)
  for (int j = warp; j < n; j += kWarps) {
    const int64_t kpix = j < H ? (bh0 + j) * W + w : (bh0 + h) * W + (j - H);
    const T* kr = k + kpix * CQ;
    float acc = 0.f;
    for (int c = lane; c < CQ; c += 32) acc += qs[c] * to_f32(kr[c]);
    acc = warp_sum(acc);
    if (lane == 0) e[j] = (j == h) ? -INFINITY : acc;
  }
  __syncthreads();

  float m = -INFINITY;
  for (int j = tid; j < n; j += kThreads) m = fmaxf(m, e[j]);
  m = block_reduce<true>(m, scratch);  // finite: the row branch is never masked

  float s = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    const float p = expf(e[j] - m);
    e[j] = p;
    s += p;
  }
  const float inv_den = 1.f / block_reduce<false>(s, scratch);  // syncs e too

  const T* vcol = v + static_cast<int64_t>(w) * C;           // + (bh0+j)*W*C
  const T* vrow = v + (bh0 + h) * static_cast<int64_t>(W) * C;  // + j*C
  for (int c = tid; c < C; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < H; ++j)
      acc += e[j] * to_f32(vcol[(bh0 + j) * static_cast<int64_t>(W) * C + c]);
    for (int j = 0; j < W; ++j)
      acc += e[H + j] * to_f32(vrow[static_cast<int64_t>(j) * C + c]);
    store(out + pix * C + c, acc * inv_den);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int W, int CQ, int C, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * H * W;
  const size_t smem = static_cast<size_t>(H + W + CQ) * sizeof(float);
  cc_attention_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, W, CQ, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int cc_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                int B, int H, int W, int CQ, int C, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, B, H, W, CQ, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, B, H, W, CQ, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
