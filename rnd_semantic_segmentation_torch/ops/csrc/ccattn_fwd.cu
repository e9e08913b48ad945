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
// float32 rate, so the memory side is the larger bound.  A block per query
// pixel reads the H+W rows of k and v of its column and row once per query:
// at 64x128, about 1.6 GB of L2 reads for 19 MB of data.
//
// Design: every query of an image row shares that row's W keys, and every
// query of an image column that column's H keys.  So a block takes one line
// (or a tile of at most kQT queries of it), stages the line's q, k and v in
// shared memory and forms its products from there.  The output is linear in
// the two branches, so they combine at the end as flash attention combines
// its key blocks, in two passes:
//   pass 1 (rows), one block per image row, query tile and channel group:
//     E_r = Q.K_row^T; per query the row partials m_r = max e and
//     l_r = sum exp(e - m_r) into a float32 workspace stats [B,H,W,2], and
//     the unnormalised O_r = exp(E_r - m_r).V_row into a float32 workspace
//     partial [B,H,W,C];
//   pass 2 (columns), one block per image column, query tile and channel
//     group: E_c = Q.K_col^T with the query's own row masked, its partials
//     m_c, l_c and O_c, then with m = max(m_r, m_c), a_r = e^(m_r-m),
//     a_c = e^(m_c-m), out = (a_r O_r + a_c O_c) / (a_r l_r + a_c l_c),
//     written once in v's type.
// Each pass reads q, k and v about once (from L2 in pass 2) instead of H+W
// times.  Every output pixel has one writer, every sum runs in a fixed order
// and there are no atomics, so two calls give the same bits.
//
// Where the trouble is, and what the design does about it:
//   1. Long lines.  Keys stream through tiles of at most kKT pixels (equal
//      tiles), with the usual online rescaling of each query's max, sum and
//      accumulator; queries go in equal tiles of at most kQT.  The line's
//      length does not bound shared memory: the wrapper's only limits are
//      the grid's (blocks < 2^31) and B*H*W < 2^31.
//   2. Channels.  Cq goes through kCH-channel slices of q and k; C through
//      channel groups of at most kCG channels, one block each, which
//      recompute E (2Cq operations a key, against 2C for the output).  A
//      pass whose lines give fewer than one wave of blocks splits C into more
//      groups, down to 64 channels, so that B=1 maps keep more SMs busy.
//   3. The masked column.  With H = 1 every column energy is -inf: the
//      column's max stays -inf, its weights and sum 0 (no -inf - -inf is
//      formed) and a_c = 0, so the row branch carries the query.
//   4. Registers and shared memory.  A thread accumulates up to kRO query
//      rows x 4 channels of O, reading 4 keys of P and V per 16-byte load:
//      12 shared loads a 128 FMAs.  Registers are capped at 128 a thread so
//      that two blocks share an SM (uncapped, 172-255 registers left one
//      block an SM and two waves at the training shape); a few bytes spill.
//      A block holds a q and a k slice, a V tile [keys][group channels] and
//      E/P [queries][keys]: 89 KB at most (opted in once per instance and
//      card; that error is returned like a launch error), 53 KB for a row of
//      40 at C=256.
//   5. Two dependent launches.  The column pass is launched as a
//      programmatic dependent of the row pass: every row block lets it start
//      at once, and a column block reads the row partials only after
//      griddepcontrol.wait, so its staging, products and softmax overlap the
//      row pass and its launch latency is hidden.
//   6. Arithmetic.  Float32 on the CUDA cores: a single TF32 pass cannot
//      meet the kernel's 1e-4 tolerance.
// Copies: float32 goes by 16-byte cp.async where a pixel's channels start
// 16-byte aligned (channels a multiple of 4, the tensor 16-byte aligned), by
// 4-byte cp.async elsewhere; bfloat16 by 8-byte or 2-byte plain loads,
// converted to float32 on the way into shared memory.  Staged q and k rows
// are an odd number of 16-byte groups apart (kS floats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 32;                // queries of a block, at most
constexpr int kKT = 64;                // keys of a tile, at most
constexpr int kCH = 32;                // channels of a q or k slice
constexpr int kS = kCH + 4;            // floats per staged q or k row
constexpr int kCG = 256;               // channels of a group, at most
constexpr int kMinSplitCG = 64;        // groups split for fill keep this many
constexpr int kRO = kQT / (kThreads / (kCG / 4));  // O rows of a thread: 8
constexpr int kLanes = 8;              // lanes that share one query's softmax
constexpr int kMinBlocks = 2;          // resident blocks an SM: at most 128 registers
constexpr int kMaxSmemBytes = 232448;  // the most a block can opt in to on sm_90
constexpr int kMaxDevices = 64;        // cards whose opt-in and SM count are kept

__host__ __device__ constexpr int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int ceil_div(int64_t x, int64_t m) { return static_cast<int>((x + m - 1) / m); }

struct Params {
  const void *q, *k, *v;
  void* out;
  float* stats;    // [B,H,W,2]: each query's row max and row sum
  float* partial;  // [B,H,W,C]: each query's unnormalised row output
  int B, H, W, CQ, C;
  int vec;         // bit t: tensor t of (q, k, v, out and partial) takes vector copies
};

// How one pass cuts its lines: query tiles, key tiles and channel groups.
struct Plan {
  int qtile, qtiles, ktile, ktiles, cg, groups;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// channels [c, c+4) of one pixel into 4 floats of shared memory; channels at
// or past `rem` (the channels left from c on) are written as zeros
__device__ __forceinline__ void copy4(float* d, const float* s, int rem, bool vec) {
  if (vec && rem >= 4) {
    cp_async16(d, s);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < rem) cp_async4(d + e, s + e);
    else d[e] = 0.f;
  }
}
__device__ __forceinline__ void copy4(float* d, const __nv_bfloat16* s, int rem, bool vec) {
  if (vec && rem >= 4) {
    const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(s);
    const float2 lo = __bfloat1622float2(s2[0]), hi = __bfloat1622float2(s2[1]);
    *reinterpret_cast<float4*>(d) = make_float4(lo.x, lo.y, hi.x, hi.y);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = e < rem ? __bfloat162float(s[e]) : 0.f;
}

// one operand along a line: channel 0 of its first pixel, the elements from
// one pixel of the line to the next, its channels, whether it takes vector copies
template <typename T>
struct Line {
  const T* base;
  int64_t step;
  int C;
  bool vec;
};

// channels [c0, c0 + width) of pixels [0, rows) of a line into dst [rows][ld];
// pixels from `valid` on are written as zeros
template <typename T>
__device__ void stage(float* dst, int ld, const Line<T>& op, int c0, int width, int rows,
                      int valid) {
  const int groups = width / 4;
  for (int idx = threadIdx.x; idx < rows * groups; idx += kThreads) {
    const int r = idx / groups, c = c0 + 4 * (idx % groups);
    float* d = dst + r * ld + (c - c0);
    if (r < valid) copy4(d, op.base + r * op.step + c, op.C - c, op.vec);
    else *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// P[i][j] (first ? = : +=) sum over c < kCH of Qs[i][c] * Ks[j][c], i < nq,
// j < nk; a thread takes a 2x2 tile (u + Ux*a, v + Uy*b).
__device__ __forceinline__ void energies(float* P, int ldp, const float* Qs, const float* Ks,
                                         int nq, int nk, bool first) {
  const int Ux = (nq + 1) / 2, Uy = (nk + 1) / 2;
  for (int t = threadIdx.x; t < Ux * Uy; t += kThreads) {
    const int u = t / Uy, v = t % Uy;
    const int xo[2] = {u * kS, min(u + Ux, nq - 1) * kS};
    const int yo[2] = {v * kS, min(v + Uy, nk - 1) * kS};
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < kCH; c += 4) {
      float4 x[2], y[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        x[a] = *reinterpret_cast<const float4*>(Qs + xo[a] + c);
        y[a] = *reinterpret_cast<const float4*>(Ks + yo[a] + c);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          acc[a][b] = fmaf(x[a].x, y[b].x, acc[a][b]);
          acc[a][b] = fmaf(x[a].y, y[b].y, acc[a][b]);
          acc[a][b] = fmaf(x[a].z, y[b].z, acc[a][b]);
          acc[a][b] = fmaf(x[a].w, y[b].w, acc[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = u + Ux * a, j = v + Uy * b;
        if (i < nq && j < nk) {
          float* p = P + i * ldp + j;
          *p = first ? acc[a][b] : *p + acc[a][b];
        }
      }
  }
}

__device__ __forceinline__ void load4(float (&d)[4], const float* s, int rem, bool vec) {
  if (vec && rem >= 4) {
    const float4 x = *reinterpret_cast<const float4*>(s);
    d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = e < rem ? s[e] : 0.f;
}

__device__ __forceinline__ void store4(float* d, const float (&x)[4], int rem, bool vec) {
  if (vec && rem >= 4) {
    *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < rem) d[e] = x[e];
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, const float (&x)[4], int rem, bool vec) {
  if (vec && rem >= 4) {
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(d);
    d2[0] = __floats2bfloat162_rn(x[0], x[1]);
    d2[1] = __floats2bfloat162_rn(x[2], x[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < rem) d[e] = __float2bfloat16(x[e]);
}

// One block of one pass: kColumn false takes queries of an image row against
// the row's keys and writes the row partials; true takes queries of an image
// column against the column's keys (own row masked), combines them with the
// row partials and writes the output.
template <typename T, bool kColumn>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cc_attention_fwd_kernel(const Params p, const Plan pl) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  int bid = blockIdx.x;
  const int g = bid % pl.groups;
  bid /= pl.groups;
  const int qt = bid % pl.qtiles, line = bid / pl.qtiles;
  const int n = kColumn ? p.H : p.W;
  int64_t pix0, pstep;  // the line's first pixel; pixels from one of its pixels to the next
  if (kColumn) {
    pix0 = static_cast<int64_t>(line / p.W) * p.H * p.W + line % p.W;
    pstep = p.W;
  } else {
    pix0 = static_cast<int64_t>(line) * p.W;
    pstep = 1;
  }
  const int i0 = qt * pl.qtile, nq = min(pl.qtile, n - i0);
  const int c0 = g * pl.cg, cw = min(pl.cg, p.C - c0);  // this group's channels

  const int ldv = pl.cg, ldp = static_cast<int>(round_up(pl.ktile, 4)) + 4;
  float* Qs = smem;                                  // [qtile][kS]
  float* Ks = Qs + pl.qtile * kS;                    // [ktile][kS]
  float* Vs = Ks + pl.ktile * kS;                    // [round4(ktile)][ldv]
  float* Ps = Vs + round_up(pl.ktile, 4) * ldv;      // [qtile][ldp]: E, then P
  float* ms = Ps + pl.qtile * ldp;                   // [kQT] running max of each query
  float* ls = ms + kQT;                              // [kQT] running sum
  float* alpha = ls + kQT;                           // [kQT] this tile's rescale

  const int64_t qpix = pix0 + i0 * pstep;
  const Line<T> lq{static_cast<const T*>(p.q) + qpix * p.CQ, pstep * p.CQ, p.CQ, (p.vec & 1) != 0};
  const Line<T> lk{static_cast<const T*>(p.k) + pix0 * p.CQ, pstep * p.CQ, p.CQ, (p.vec & 2) != 0};
  const Line<T> lv{static_cast<const T*>(p.v) + pix0 * p.C, pstep * p.C, p.C, (p.vec & 4) != 0};

  // the column pass may start once every row block has: it reads nothing of
  // the row pass before its griddepcontrol.wait
  if (!kColumn) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid < nq) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }

  // O: thread (u, gq) takes rows u + rowgroups*a and channels 4gq..4gq+3
  const int cg4 = pl.cg / 4, rowgroups = kThreads / cg4;
  const int u = tid / cg4, c = 4 * (tid % cg4);
  const bool active = u < rowgroups;
  const int ro = (nq + rowgroups - 1) / rowgroups;  // rows a thread takes (<= kRO)
  int row[kRO];
#pragma unroll
  for (int a = 0; a < kRO; ++a) row[a] = min(u + rowgroups * a, nq - 1);
  float acc[kRO][4];
#pragma unroll
  for (int a = 0; a < kRO; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;

  const int slices = max(1, ceil_div(p.CQ, kCH));
  const int lane = tid & (kLanes - 1);
  for (int kt = 0; kt < pl.ktiles; ++kt) {
    const int j0 = kt * pl.ktile, nk = min(pl.ktile, n - j0), nk4 = static_cast<int>(round_up(nk, 4));
    __syncthreads();  // the last tile's V and P have been read
    const Line<T> lkt{lk.base + j0 * lk.step, lk.step, lk.C, lk.vec};
    const Line<T> lvt{lv.base + j0 * lv.step, lv.step, lv.C, lv.vec};
    stage(Qs, kS, lq, 0, kCH, nq, nq);
    stage(Ks, kS, lkt, 0, kCH, nk, nk);
    cp_async_commit();
    stage(Vs, ldv, lvt, c0, pl.cg, nk4, nk);  // arrives while E is formed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    energies(Ps, ldp, Qs, Ks, nq, nk, true);
    for (int s = 1; s < slices; ++s) {
      __syncthreads();
      stage(Qs, kS, lq, s * kCH, kCH, nq, nq);
      stage(Ks, kS, lkt, s * kCH, kCH, nk, nk);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      energies(Ps, ldp, Qs, Ks, nq, nk, false);
    }
    cp_async_wait<0>();
    __syncthreads();

    // online softmax: kLanes lanes per query; a group past the last query
    // repeats it, and writes nothing
    {
      const int i = min(tid / kLanes, nq - 1);
      const bool mine = tid / kLanes < nq;
      float* e = Ps + i * ldp;
      const int self = kColumn ? i0 + i - j0 : -1;  // the masked key, in a column
      const float m_old = ms[i], l_old = ls[i];
      float t = -INFINITY;
      for (int j = lane; j < nk; j += kLanes)
        if (j != self) t = fmaxf(t, e[j]);
      const float m_new = fmaxf(m_old, group_max(t));
      const bool none = m_new == -INFINITY;  // only a column of one pixel
      float sum = 0.f;
      float x[kKT / kLanes];
#pragma unroll
      for (int r = 0; r < kKT / kLanes; ++r) {
        const int j = lane + r * kLanes;
        x[r] = (j < nk && j != self && !none) ? expf(e[j] - m_new) : 0.f;
        sum += x[r];
      }
      sum = group_sum(sum);
      __syncwarp();
      if (mine) {
#pragma unroll
        for (int r = 0; r < kKT / kLanes; ++r) {
          const int j = lane + r * kLanes;
          if (j < nk4) e[j] = x[r];
        }
        if (lane == 0) {
          const float a = none ? 1.f : expf(m_old - m_new);
          ms[i] = m_new;
          ls[i] = l_old * a + sum;
          alpha[i] = a;
        }
      }
    }
    __syncthreads();

    if (active) {
#pragma unroll
      for (int a = 0; a < kRO; ++a) {
        if (a >= ro) break;
        const float f = alpha[row[a]];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] *= f;
      }
      for (int j = 0; j < nk4; j += 4) {
        const float4 v0 = *reinterpret_cast<const float4*>(Vs + (j + 0) * ldv + c);
        const float4 v1 = *reinterpret_cast<const float4*>(Vs + (j + 1) * ldv + c);
        const float4 v2 = *reinterpret_cast<const float4*>(Vs + (j + 2) * ldv + c);
        const float4 v3 = *reinterpret_cast<const float4*>(Vs + (j + 3) * ldv + c);
#pragma unroll
        for (int a = 0; a < kRO; ++a) {
          if (a >= ro) break;
          const float4 w = *reinterpret_cast<const float4*>(Ps + row[a] * ldp + j);
          acc[a][0] = fmaf(w.x, v0.x, fmaf(w.y, v1.x, fmaf(w.z, v2.x, fmaf(w.w, v3.x, acc[a][0]))));
          acc[a][1] = fmaf(w.x, v0.y, fmaf(w.y, v1.y, fmaf(w.z, v2.y, fmaf(w.w, v3.y, acc[a][1]))));
          acc[a][2] = fmaf(w.x, v0.z, fmaf(w.y, v1.z, fmaf(w.z, v2.z, fmaf(w.w, v3.z, acc[a][2]))));
          acc[a][3] = fmaf(w.x, v0.w, fmaf(w.y, v1.w, fmaf(w.z, v2.w, fmaf(w.w, v3.w, acc[a][3]))));
        }
      }
    }
  }

  if (!kColumn && g == 0 && tid < nq)
    reinterpret_cast<float2*>(p.stats)[qpix + tid * pstep] = make_float2(ms[tid], ls[tid]);
  if (!active) return;
  // the column pass's row partials, all loads in flight at once, once the
  // row pass has finished and its writes are visible
  float prev[kRO][4];
  float2 rs[kRO];
  if (kColumn) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int a = 0; a < kRO; ++a)
      if (a < ro) {
        rs[a] = reinterpret_cast<const float2*>(p.stats)[qpix + row[a] * pstep];
        load4(prev[a], p.partial + (qpix + row[a] * pstep) * p.C + c0 + c, cw - c,
              (p.vec & 16) != 0);
      }
  }
#pragma unroll
  for (int a = 0; a < kRO; ++a) {
    if (a >= ro) break;
    const int r = u + rowgroups * a;
    if (r >= nq) break;
    const int64_t off = (qpix + r * pstep) * p.C + c0 + c;
    if (!kColumn) {
      store4(p.partial + off, acc[a], cw - c, (p.vec & 16) != 0);
      continue;
    }
    const float m_r = rs[a].x, l_r = rs[a].y, m_c = ms[r], l_c = ls[r];
    const float m = fmaxf(m_r, m_c);  // finite: the row branch is never masked
    const float a_r = expf(m_r - m), a_c = l_c > 0.f ? expf(m_c - m) : 0.f;
    const float inv = 1.f / (a_r * l_r + a_c * l_c);
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = (a_r * prev[a][e] + a_c * acc[a][e]) * inv;
    store4(static_cast<T*>(p.out) + off, o, cw - c, (p.vec & 8) != 0);
  }
}

// The calling thread's current card, or -1 past kMaxDevices.
int current_device() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return -1;
  return device;
}

// SMs of the current card, read once per card.
int sm_count() {
  static std::atomic<int> counts[kMaxDevices];
  const int device = current_device();
  if (device < 0) return 132;
  int n = counts[device].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) n = 132;
    counts[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Equal query tiles of at most kQT and key tiles of at most kKT along a line
// of n pixels; channel groups of at most kCG channels (a multiple of 4), split
// further while a pass of `lines` lines stays within one wave of blocks and a
// group keeps kMinSplitCG channels.
Plan plan_pass(int n, int64_t lines, int C) {
  Plan pl;
  pl.qtiles = ceil_div(n, kQT);
  pl.qtile = ceil_div(n, pl.qtiles);
  pl.ktiles = ceil_div(n, kKT);
  pl.ktile = ceil_div(n, pl.ktiles);
  const int fewest = max(1, ceil_div(C, kCG));
  const int sms = sm_count();
  int G = fewest;
  while (lines * pl.qtiles * G * 2 <= sms && ceil_div(C, 2 * G) >= kMinSplitCG) G *= 2;
  pl.cg = static_cast<int>(round_up(ceil_div(max(C, 1), G), 4));
  pl.groups = ceil_div(max(C, 1), pl.cg);
  return pl;
}

size_t plan_smem(const Plan& pl) {
  const int64_t kt4 = round_up(pl.ktile, 4);
  const int64_t floats = static_cast<int64_t>(pl.qtile) * kS + pl.ktile * kS + kt4 * pl.cg +
                         pl.qtile * (kt4 + 4) + 3 * kQT;
  return static_cast<size_t>(floats) * sizeof(float);
}

int64_t plan_blocks(const Plan& pl, int64_t lines) { return lines * pl.qtiles * pl.groups; }

// The shared-memory opt-in holds per card: made once on each.
template <typename T, bool kColumn>
cudaError_t opt_in() {
  static std::atomic<bool> done[kMaxDevices];
  const int device = current_device();
  if (device >= 0 && done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      cc_attention_fwd_kernel<T, kColumn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (err == cudaSuccess && device >= 0) done[device].store(true, std::memory_order_release);
  return err;
}

template <typename T>
cudaError_t opt_in_all() {
  cudaError_t err = opt_in<T, false>();
  return err == cudaSuccess ? opt_in<T, true>() : err;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t s) {
  cudaError_t err = opt_in_all<T>();
  if (err != cudaSuccess) return err;
  const int64_t row_lines = static_cast<int64_t>(p.B) * p.H, col_lines = static_cast<int64_t>(p.B) * p.W;
  const Plan rows = plan_pass(p.W, row_lines, p.C);
  const Plan cols = plan_pass(p.H, col_lines, p.C);
  const int64_t row_blocks = plan_blocks(rows, row_lines), col_blocks = plan_blocks(cols, col_lines);
  if (row_blocks <= 0 || row_blocks > 2147483647LL || col_blocks <= 0 ||
      col_blocks > 2147483647LL)
    return cudaErrorInvalidValue;
  cc_attention_fwd_kernel<T, false>
      <<<static_cast<unsigned>(row_blocks), kThreads, plan_smem(rows), s>>>(p, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the column blocks stage, multiply and
  // take their softmax while the last row blocks run
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(col_blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = plan_smem(cols);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cc_attention_fwd_kernel<T, true>, p, cols);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

bool vector_ok(const void* ptr, int channels, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0 && channels % 4 == 0;
}

// registers, local (spill) bytes, dynamic shared bytes, resident blocks per
// SM, blocks, query tile, key tile and channel groups of pass `pass`
template <typename T>
cudaError_t info(const Params& p, int pass, int* res) {
  cudaError_t err = opt_in_all<T>();
  if (err != cudaSuccess) return err;
  const bool column = pass == 1;
  const int64_t lines = static_cast<int64_t>(p.B) * (column ? p.W : p.H);
  const Plan pl = plan_pass(column ? p.H : p.W, lines, p.C);
  const size_t smem = plan_smem(pl);
  const void* kernel = column ? reinterpret_cast<const void*>(cc_attention_fwd_kernel<T, true>)
                              : reinterpret_cast<const void*>(cc_attention_fwd_kernel<T, false>);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  res[0] = attr.numRegs;
  res[1] = static_cast<int>(attr.localSizeBytes);
  res[2] = static_cast<int>(smem);
  res[4] = static_cast<int>(plan_blocks(pl, lines));
  res[5] = pl.qtile;
  res[6] = pl.ktile;
  res[7] = pl.groups;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[3], kernel, kThreads, smem);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats is a float32 workspace of B*H*W*2
// elements, partial one of B*H*W*C.  Returns the cudaError_t of the
// shared-memory opt-in or of the first launch that was refused, or 0;
// cudaErrorInvalidValue for a grid of 2^31 blocks or more.
extern "C" int cc_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                void* stats, void* partial, int B, int H, int W, int CQ,
                                int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = dtype == 0 ? 16 : 8;
  const int vec = (vector_ok(q, CQ, bytes) ? 1 : 0) | (vector_ok(k, CQ, bytes) ? 2 : 0) |
                  (vector_ok(v, C, bytes) ? 4 : 0) | (vector_ok(out, C, bytes) ? 8 : 0) |
                  (vector_ok(partial, C, 16) ? 16 : 0);
  const Params p{q, k, v, out, static_cast<float*>(stats), static_cast<float*>(partial),
                 B, H, W, CQ, C, vec};
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// res[8] = {registers, local (spill) bytes, dynamic shared bytes, resident
// blocks per SM, blocks, query tile, key tile, channel groups} of pass `pass`
// (0: rows, 1: columns and the sum) at this shape in dtype; returns a
// cudaError_t.
extern "C" int cc_attention_fwd_info(int B, int H, int W, int CQ, int C, int dtype, int pass,
                                     int* res) {
  if (pass < 0 || pass > 1 || B < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, CQ, C, 0};
  if (dtype == 0) return static_cast<int>(info<float>(p, pass, res));
  if (dtype == 1) return static_cast<int>(info<__nv_bfloat16>(p, pass, res));
  return static_cast<int>(cudaErrorInvalidValue);
}
