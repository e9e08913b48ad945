// Criss-cross attention backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rnd_semantic_segmentation_tpu/ops/ccattn.py:
// _cc_bwd_kernel (launched by cc_attention_core_pallas_bwd, wired into the
// custom VJP _cc_pallas_ad).  Given q, k [B,H,W,Cq], v [B,H,W,C] and the
// gradient g [B,H,W,C] of the forward's output, it returns dq, dk, dv.  The
// attention is recomputed, not stored.  Per query pixel p = (b, h, w) with its
// H+W keys j (column keys (b, j, w), the query's own row masked to -inf, and
// row keys (b, h, j)):
//   a     = softmax(e) over the joint H+W axis
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
// float32 the function must read q, k, v, g and write dq, dk, dv: 18.9 MB,
// about 5.6 us at 3.35 TB/s; its five contractions do 398 MFLOP, 5.9 us at
// 67 TFLOP/s.  A kernel per query pixel reads the H+W rows of k, v, q and g of
// its column and row once per query: 377 MB per pass from L2 at that shape.
//
// Design: every query of an image column shares that column's H keys, every
// query of an image row its W keys, as the Pallas kernel's batched products
// over the row axis and the transposed column axis do.  So a block takes one
// line (a row or a column), stages the line's q, k, v and g in shared memory
// once, and forms the line's energies E = Q.K^T and value products D = G.V^T
// as register-tiled products from there.  The joint softmax couples the two
// branches of a query, so its statistics are put together from branch
// partials in three passes:
//   pass 1, one block per image row: E_r, D_r; per query the row partials
//     m_r = max e, l_r = sum exp(e - m_r), t_r = sum exp(e - m_r) * da,
//     into a float32 workspace stats [B,H,W,3];
//   pass 2, one block per image column: E_c (diagonal masked), D_c and their
//     partials, combined with pass 1's into the query's final max m, 1/l and
//     s = (t_r e^(m_r-m) + t_c e^(m_c-m)) / l, written back to stats; then
//     a_c, de_c and the column contributions dq_c = de_c.K, dk_c = de_c^T.Q,
//     dv_c = a_c^T.G into a float32 workspace contrib [B,H,W,2Cq+C];
//   pass 3, one block per image row: E_r and D_r again, a_r and de_r from the
//     final statistics, the row contributions, plus pass 2's, written once
//     each into dq, dk, dv.
// Each pass reads q, k, v and g about once (from L2 after pass 1) instead of
// H+W times.  Every output pixel has one writer, every sum runs in a fixed
// order and there are no atomics, so two runs give the same bits.
//
// Where the trouble is, and what the design does about it:
//   1. Shared memory.  Where a block's q, k, v and g fit whole beside E and D
//      (q, g of nq queries, k, v of nk keys: 2nq(nk+1) + (nq+nk)(Cq+C+8)
//      floats with the channels rounded up to 32), they are staged once, with
//      q and k first so that E is formed while g and v arrive: 108 KB for a
//      row of 40 at Cq=32, C=256.  Otherwise they stream through 32-channel
//      slices, two stages, slice t+1 copied while the block multiplies slice
//      t.  Above 48 KB a block must opt in: cudaFuncSetAttribute runs once per
//      instance and card, and its error is returned like a launch's.
//   2. Large lines.  A row of more than 64 pixels is cut into equal query
//      tiles (pass 1) and, in pass 3, into query tiles that write dq (all
//      keys) and key tiles that write dk and dv (all queries), in one grid:
//      no output has two writers, and a long row keeps more SMs busy.  The
//      tile is the largest (of at least 16 pixels) whose blocks still stage
//      their operands whole: 32 pixels for a row of 128 at Cq=32, C=256.
//      Failing that, tiles of 64 stream their operands in slices.  The limit
//      is then that the slices fit: H <= 137 (whole columns) and W <= 259,
//      whatever Cq and C; the wrapper raises beyond it, and the C function
//      returns cudaErrorInvalidValue.
//   3. The masked column.  With H = 1 every column energy is -inf: its
//      partials are set to l_c = t_c = 0 and its weight to 0, so no -inf - -inf
//      is formed and the row branch carries the query.  The masked entry's
//      attention is written as 0 directly.
//   4. Occupancy and shared-memory bandwidth.  Passes 1 and 3 have B*H
//      blocks at the training shape (132, one per SM); pass 2 has B*W (240).
//      A thread's register tile of E and D is 4x4 for lines of 64 pixels or
//      more (16 FMAs per 16-byte shared load), 2x2 below, so that shorter
//      lines spread over the block, and where even so the tiles leave threads
//      idle, the channel sum is split among them (its partial sums added in
//      a fixed order).  An output product's tile is 4 rows x 4 channels, and
//      the column contribution it adds is loaded before its loop.  Each
//      query's statistics take 8 lanes, so a warp treats 4 queries at once.
//      Cutting short rows into tiles for more blocks was slower (it recomputes
//      E and D for both tile kinds).  The queries' statistics that passes 2
//      and 3 read are staged with the operands.  The two product functions
//      are not inlined, so that each is compiled once per instance: that
//      halved the build.
//   5. Arithmetic.  The products run on the CUDA cores in float32: a single
//      TF32 pass cannot meet the 1e-5 tolerance.  With the L2 traffic gone,
//      what is left is each block's chain of dependent phases (staging, E, D,
//      statistics, outputs) at one or two blocks an SM, and products at a
//      fraction of the float32 rate; a 3xTF32 mma.sync product is the next
//      step (ROADMAP).
// Copies: float32 goes by 16-byte cp.async where a pixel's channels start
// 16-byte aligned (C a multiple of 4, the tensor 16-byte aligned), by 4-byte
// cp.async elsewhere; bfloat16 by 8-byte or 2-byte plain loads, converted to
// float32 on the way into shared memory.  Staged rows are an odd number of
// 16-byte groups apart (the channels rounded up to 32, plus 4 floats), so
// eight threads reading eight rows' groups hit eight different bank groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kCH = 32;                // channels per staged slice
constexpr int kS = kCH + 4;            // floats per staged row
constexpr int kTile = 64;              // pixels of a row tile, for rows longer than that
constexpr int kMaxSmemBytes = 232448;  // the most a block can opt in to on sm_90
constexpr int kMaxDevices = 64;        // cards whose opt-in is kept

enum Pass : int { kRowStats = 0, kColumn = 1, kRowFinal = 2 };

__host__ __device__ constexpr int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int64_t round4(int64_t x) { return round_up(x, 4); }

struct Params {
  const void *q, *k, *v, *g;
  void *dq, *dk, *dv;
  float* stats;    // [B,H,W,3]: the row partials, then the final (m, 1/l, s)
  float* contrib;  // [B,H,W,2Cq+C]: the column branch's dq, dk, dv
  int B, H, W, CQ, C;
  int tile, tiles;  // pixels of a row tile, and tiles of a row
  int vec;          // bit t: tensor t of (q, k, v, g) takes vector copies
};

// one operand along a line: channel 0 of its first pixel, the elements from
// one pixel of the line to the next, its channels
template <typename T>
struct Line {
  const T* base;
  int64_t step;
  int C;
  bool vec;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int kLanes = 8;  // lanes that share one query's softmax statistics

// over the kLanes lanes of an aligned group; every lane gets the result
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

// channels [c0, c0 + width) of `rows` pixels of a line into dst [rows][ld]
template <typename T>
__device__ void stage(float* dst, int ld, const Line<T>& op, int c0, int width, int rows) {
  const int groups = width / 4;
  for (int idx = threadIdx.x; idx < rows * groups; idx += kThreads) {
    const int r = idx / groups, c = c0 + 4 * (idx % groups);
    copy4(dst + r * ld + (c - c0), op.base + r * op.step + c, op.C - c, op.vec);
  }
}

// Runs body(slice_a, slice_b, c0) over the kCH-channel slices of operand a
// (na pixels) and of b (nb pixels, a's channel count; or none), staging slice
// t+1 while the block works on slice t.  buf holds two stages of [na + nb][kS].
template <typename T, typename Body>
__device__ void over_slices(float* buf, const Line<T>& a, int na, const Line<T>* b, int nb,
                            Body body) {
  const int slices = (a.C + kCH - 1) / kCH;
  const int size = (na + nb) * kS;
  auto issue = [&](int t) {
    float* d = buf + (t & 1) * size;
    stage(d, kS, a, t * kCH, kCH, na);
    if (b) stage(d + na * kS, kS, *b, t * kCH, kCH, nb);
    cp_async_commit();
  };
  issue(0);
  for (int t = 0; t < slices; ++t) {
    if (t + 1 < slices) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* d = buf + (t & 1) * size;
    body(d, d + na * kS, t * kCH);
    __syncthreads();  // the stage is refilled two slices on
  }
}

// How many ways product_xyt splits its channels: the most (a power of two,
// at most one per kCH channels) that keeps all its tile-splits within the block.
__host__ __device__ inline int ksplit(int nx, int ny, int R, int width) {
  const int tiles = ((nx + R - 1) / R) * ((ny + R - 1) / R);
  int s = 1;
  while (2 * s * tiles <= kThreads && 2 * s * kCH <= width) s *= 2;
  return s;
}

// M[i][j] = (first ? 0 : M[i][j]) + sum over c < width of X[i][c] * Y[j][c],
// for i < nx, j < ny; width is a multiple of kCH.  Thread t takes the R x R
// entries (u + Ux*a, v + Uy*b) with Ux = ceil(nx/R), Uy = ceil(ny/R),
// u = t / Uy, v = t % Uy: neighbouring threads read neighbouring Y rows, and
// few X rows (broadcast).  Rows past nx or ny are read clamped and not stored.
// Where the tiles leave threads idle, the channels are split ksplit ways:
// split s > 0 leaves its partial sums in scratch [s-1][nx][ny], and they are
// added to split 0's in the order of s.  Every thread of the block calls it.
template <int R>
__device__ __noinline__ void product_xyt(float* M, int ldm, const float* X, int ldx,
                                         int nx, const float* Y, int ldy, int ny, int width,
                                         bool first, float* scratch) {
  const int Ux = (nx + R - 1) / R, Uy = (ny + R - 1) / R, tiles = Ux * Uy;
  const int splits = ksplit(nx, ny, R, width), chunks = width / kCH;
  for (int t = threadIdx.x; t < tiles * splits; t += kThreads) {
    const int split = t / tiles, u = (t % tiles) / Uy, v = (t % tiles) % Uy;
    int xo[R], yo[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      xo[a] = min(u + Ux * a, nx - 1) * ldx;
      yo[a] = min(v + Uy * a, ny - 1) * ldy;
    }
    float acc[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = 0.f;
    // split s takes the kCH-channel chunks [s*chunks/splits, (s+1)*chunks/splits)
    for (int c0 = split * chunks / splits * kCH; c0 < (split + 1) * chunks / splits * kCH;
         c0 += kCH) {
#pragma unroll
      for (int c = c0; c < c0 + kCH; c += 4) {
        float4 x[R], y[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          x[a] = *reinterpret_cast<const float4*>(X + xo[a] + c);
          y[a] = *reinterpret_cast<const float4*>(Y + yo[a] + c);
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int b = 0; b < R; ++b) {
            acc[a][b] = fmaf(x[a].x, y[b].x, acc[a][b]);
            acc[a][b] = fmaf(x[a].y, y[b].y, acc[a][b]);
            acc[a][b] = fmaf(x[a].z, y[b].z, acc[a][b]);
            acc[a][b] = fmaf(x[a].w, y[b].w, acc[a][b]);
          }
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int i = u + Ux * a, j = v + Uy * b;
        if (i < nx && j < ny) {
          if (split > 0) {
            scratch[((split - 1) * nx + i) * ny + j] = acc[a][b];
          } else {
            float* p = M + i * ldm + j;
            *p = first ? acc[a][b] : *p + acc[a][b];
          }
        }
      }
  }
  if (splits == 1) return;
  __syncthreads();
  for (int idx = threadIdx.x; idx < nx * ny; idx += kThreads) {
    const int i = idx / ny, j = idx % ny;
    float sum = M[i * ldm + j];
    for (int split = 1; split < splits; ++split) sum += scratch[((split - 1) * nx + i) * ny + j];
    M[i * ldm + j] = sum;
  }
}

constexpr int kOutRows = 4;  // output rows of a thread's tile in product_out

template <bool kTrans, typename Emit>
__device__ __noinline__ void product_out(const float* M, int ldm, const float* S, int lds,
                                         int nout, int nin, int width, Emit emit) {
  constexpr int RO = kOutRows;
  const int U = (nout + RO - 1) / RO, groups = width / 4;
  for (int t = threadIdx.x; t < U * groups; t += kThreads) {
    const int u = t / groups, c = 4 * (t % groups);
    int mo[RO];  // M's offset of each row at x = 0
#pragma unroll
    for (int a = 0; a < RO; ++a) {
      const int r = min(u + U * a, nout - 1);
      mo[a] = kTrans ? r : r * ldm;
    }
    const int mstep = kTrans ? ldm : 1;  // from x to x + 1
    float add[RO][4];  // what emit adds, loaded now so that the loop hides it
#pragma unroll
    for (int a = 0; a < RO; ++a) emit.load(min(u + U * a, nout - 1), c, add[a]);
    float acc[RO][4];
#pragma unroll
    for (int a = 0; a < RO; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
#pragma unroll 2
    for (int x = 0; x < nin; ++x) {
      const float4 sv = *reinterpret_cast<const float4*>(S + x * lds + c);
#pragma unroll
      for (int a = 0; a < RO; ++a) {
        const float m = M[mo[a] + x * mstep];
        acc[a][0] = fmaf(m, sv.x, acc[a][0]);
        acc[a][1] = fmaf(m, sv.y, acc[a][1]);
        acc[a][2] = fmaf(m, sv.z, acc[a][2]);
        acc[a][3] = fmaf(m, sv.w, acc[a][3]);
      }
    }
#pragma unroll
    for (int a = 0; a < RO; ++a)
      if (u + U * a < nout) emit(u + U * a, c, acc[a], add[a]);
  }
}

// What one block takes: a rectangle of queries [i0, i0+nq) and keys
// [j0, j0+nk) of one line, and which outputs it writes.
struct Rect {
  int64_t pix0, pstep;  // the line's first pixel; pixels from one of its pixels to the next
  int i0, nq, j0, nk;
  bool dq, dkdv;        // dq needs all keys, dk and dv all queries
};

// The output rows of one product, emitted by product_out: the column pass
// writes its contribution into contrib at channel offset off, the final row
// pass adds that contribution and writes out in the inputs' type.
template <typename T>
struct Sink {
  int64_t pix0, pstep;
  int r0;       // the line index of output row 0
  int C, left;  // the output's channels; those from the slice's first on
  float* contrib;
  int cw;
  T* out;  // null in the column pass
  // the column pass's contribution to output row r, channels c..c+3 (final pass)
  __device__ void load(int r, int c, float (&add)[4]) const {
    const float* w = contrib + (pix0 + (r0 + r) * pstep) * cw + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) add[e] = out && c + e < left ? w[e] : 0.f;
  }
  __device__ void operator()(int r, int c, const float (&sums)[4],
                             const float (&add)[4]) const {
    const int64_t pix = pix0 + (r0 + r) * pstep;
    float* w = contrib + pix * cw + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= left) break;
      if (out) store(out + pix * C + c + e, sums[e] + add[e]);
      else w[e] = sums[e];
    }
  }
};

// the sink for output rows from line index r0 on, of C channels at channel
// offset off in contrib, for the slice that starts at channel c0
template <typename T>
__device__ Sink<T> sink(const Rect& rc, int r0, int C, const Params& p, int off, int c0,
                        void* out) {
  return {rc.pix0, rc.pstep, r0, C, C - c0, p.contrib + off + c0, 2 * p.CQ + p.C,
          out ? static_cast<T*>(out) + c0 : nullptr};
}

// Blocks of each pass.  A row of p.tiles == 1 tile is one block; a longer
// row is cut into query tiles of p.tile pixels (pass 1), and into query tiles
// that write dq and key tiles that write dk and dv (pass 3).
__device__ Rect decode(const Params& p, int pass) {
  Rect rc;
  const int bid = blockIdx.x;
  if (pass == kColumn) {
    const int b = bid / p.W, w = bid % p.W;
    rc.pix0 = static_cast<int64_t>(b) * p.H * p.W + w;
    rc.pstep = p.W;
    rc.i0 = rc.j0 = 0;
    rc.nq = rc.nk = p.H;
    rc.dq = rc.dkdv = true;
    return rc;
  }
  const int tiles = p.tiles, lines = p.B * p.H;
  const bool key_side = pass == kRowFinal && tiles > 1 && bid >= lines * tiles;
  const int r = key_side ? bid - lines * tiles : bid;
  const int t0 = (r % tiles) * p.tile, nt = min(p.tile, p.W - t0);
  rc.pix0 = static_cast<int64_t>(r / tiles) * p.W;
  rc.pstep = 1;
  rc.i0 = key_side ? 0 : t0;
  rc.nq = key_side ? p.W : nt;
  rc.j0 = key_side ? t0 : 0;
  rc.nk = key_side ? nt : p.W;
  rc.dq = !key_side;
  rc.dkdv = key_side || tiles == 1;
  return rc;
}

// One block of one pass.  R is the side of a thread's register tile of E and
// D.  With `resident`, q, k, v and g of the rectangle are staged whole, once;
// otherwise they stream through kCH-channel slices.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
cc_attention_bwd_kernel(const Params p, const int pass, const bool resident) {
  extern __shared__ __align__(16) float smem[];
  const Rect rc = decode(p, pass);
  const bool column = pass == kColumn;
  const int nq = rc.nq, nk = rc.nk, ldm = nk + 1;
  const int wq = round_up(p.CQ, kCH), wc = round_up(p.C, kCH);
  float* E = smem;                           // [nq][ldm] energies, then the attention a
  float* D = E + nq * ldm;                   // [nq][ldm] <g_i, v_j>, then de
  float* stats = smem + round4(2 * nq * ldm);  // [nq][4]: the queries' statistics
  float* scratch = stats + 4 * nq;           // partial sums of split products
  float* ops = scratch + round4(resident ? (ksplit(nq, nk, R, wc) - 1) * nq * nk : 0);

  const int64_t qpix = rc.pix0 + rc.i0 * rc.pstep, kpix = rc.pix0 + rc.j0 * rc.pstep;
  const int64_t qstep = rc.pstep * p.CQ, cstep = rc.pstep * p.C;
  const Line<T> lq{static_cast<const T*>(p.q) + qpix * p.CQ, qstep, p.CQ, (p.vec & 1) != 0};
  const Line<T> lk{static_cast<const T*>(p.k) + kpix * p.CQ, qstep, p.CQ, (p.vec & 2) != 0};
  const Line<T> lv{static_cast<const T*>(p.v) + kpix * p.C, cstep, p.C, (p.vec & 4) != 0};
  const Line<T> lg{static_cast<const T*>(p.g) + qpix * p.C, cstep, p.C, (p.vec & 8) != 0};

  // passes 2 and 3 read the statistics pass 1 and pass 2 left for the queries
  if (pass != kRowStats) {
    const Line<float> ls{p.stats + qpix * 3, rc.pstep * 3, 3, false};
    stage(stats, 4, ls, 0, 4, nq);
  }
  cp_async_commit();

  // resident layout: q [nq][lq], g [nq][lc], k [nk][lq], v [nk][lc]
  const int lq_ = wq + 4, lc_ = wc + 4;
  float* Qs = ops;
  float* Gs = Qs + nq * lq_;
  float* Ks = Gs + nq * lc_;
  float* Vs = Ks + nk * lq_;

  if (resident) {
    stage(Qs, lq_, lq, 0, wq, nq);
    stage(Ks, lq_, lk, 0, wq, nk);
    cp_async_commit();
    stage(Gs, lc_, lg, 0, wc, nq);
    stage(Vs, lc_, lv, 0, wc, nk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    product_xyt<R>(E, ldm, Qs, lq_, nq, Ks, lq_, nk, wq, true, scratch);  // g, v arrive
    cp_async_wait<0>();
    __syncthreads();
    product_xyt<R>(D, ldm, Gs, lc_, nq, Vs, lc_, nk, wc, true, scratch);
    __syncthreads();
  } else {
    over_slices(ops, lq, nq, &lk, nk, [&](const float* X, const float* Y, int c0) {
      product_xyt<R>(E, ldm, X, kS, nq, Y, kS, nk, kCH, c0 == 0, scratch);
    });
    over_slices(ops, lg, nq, &lv, nk, [&](const float* X, const float* Y, int c0) {
      product_xyt<R>(D, ldm, X, kS, nq, Y, kS, nk, kCH, c0 == 0, scratch);
    });
  }

  // the softmax statistics and their gradient: kLanes lanes per query i, so
  // that a warp takes 32 / kLanes queries at once.  Passes 1 and 2 see all of
  // the query's keys in their branch (nk = n, j0 = 0)
  const int lane = threadIdx.x & (kLanes - 1);
  for (int i0 = (threadIdx.x >> 5) * (32 / kLanes); i0 < nq; i0 += kThreads / kLanes) {
    // a group past the last query repeats it, reads only and writes nothing
    const int i = min(i0 + (threadIdx.x & 31) / kLanes, nq - 1);
    const bool mine = i0 + (threadIdx.x & 31) / kLanes < nq;
    float* e = E + i * ldm;
    float* d = D + i * ldm;
    const int self = column ? rc.i0 + i - rc.j0 : -1;  // the masked key, in a column
    float* st = p.stats + (rc.pix0 + (rc.i0 + i) * rc.pstep) * 3;
    const float* sts = stats + 4 * i;  // st as the block found it
    float m, inv_l, s;
    if (pass == kRowFinal) {
      m = sts[0];
      inv_l = sts[1];
      s = sts[2];
    } else {
      float m_b = -INFINITY;  // this branch's max
      for (int j = lane; j < nk; j += kLanes)
        if (j != self) m_b = fmaxf(m_b, e[j]);
      m_b = group_max(m_b);
      float l_b = 0.f, t_b = 0.f;
      if (m_b != -INFINITY) {  // -inf only for a column of one pixel: l_b = t_b = 0
        for (int j = lane; j < nk; j += kLanes) {
          if (j == self) continue;
          const float x = expf(e[j] - m_b);
          l_b += x;
          t_b += x * d[j];
        }
      }
      l_b = group_sum(l_b);
      t_b = group_sum(t_b);
      if (pass == kRowStats) {
        if (lane == 0 && mine) {
          st[0] = m_b;
          st[1] = l_b;
          st[2] = t_b;
        }
        continue;
      }
      const float m_r = sts[0], l_r = sts[1], t_r = sts[2];
      m = fmaxf(m_r, m_b);  // finite: the row branch is never masked
      const float w_r = expf(m_r - m), w_c = l_b > 0.f ? expf(m_b - m) : 0.f;
      inv_l = 1.f / (l_r * w_r + l_b * w_c);
      s = (t_r * w_r + t_b * w_c) * inv_l;
      if (lane == 0 && mine) {
        st[0] = m;
        st[1] = inv_l;
        st[2] = s;
      }
    }
    __syncwarp();  // the last query's row is rewritten after its repeats in the warp read it
    if (!mine) continue;
    for (int j = lane; j < nk; j += kLanes) {
      const float a = j == self ? 0.f : expf(e[j] - m) * inv_l;
      e[j] = a;
      d[j] = a * (d[j] - s);
    }
  }
  if (pass == kRowStats) return;
  __syncthreads();

  // dq = de.K over the keys; dk = de^T.Q and dv = a^T.G over the queries
  const bool final_pass = pass == kRowFinal;
  void* dq = final_pass ? p.dq : nullptr;
  void* dk = final_pass ? p.dk : nullptr;
  void* dv = final_pass ? p.dv : nullptr;
  if (resident) {
    if (rc.dq)
      product_out<false>(D, ldm, Ks, lq_, nq, nk, wq, sink<T>(rc, rc.i0, p.CQ, p, 0, 0, dq));
    if (rc.dkdv) {
      product_out<true>(D, ldm, Qs, lq_, nk, nq, wq, sink<T>(rc, rc.j0, p.CQ, p, p.CQ, 0, dk));
      product_out<true>(E, ldm, Gs, lc_, nk, nq, wc,
                        sink<T>(rc, rc.j0, p.C, p, 2 * p.CQ, 0, dv));
    }
    return;
  }
  const Line<T>* none = nullptr;
  if (rc.dq)
    over_slices(ops, lk, nk, none, 0, [&](const float* S, const float*, int c0) {
      product_out<false>(D, ldm, S, kS, nq, nk, kCH, sink<T>(rc, rc.i0, p.CQ, p, 0, c0, dq));
    });
  if (rc.dkdv) {
    over_slices(ops, lq, nq, none, 0, [&](const float* S, const float*, int c0) {
      product_out<true>(D, ldm, S, kS, nk, nq, kCH, sink<T>(rc, rc.j0, p.CQ, p, p.CQ, c0, dk));
    });
    over_slices(ops, lg, nq, none, 0, [&](const float* S, const float*, int c0) {
      product_out<true>(E, ldm, S, kS, nk, nq, kCH,
                        sink<T>(rc, rc.j0, p.C, p, 2 * p.CQ, c0, dv));
    });
  }
}

// R: a 4x4 register tile of E and D for lines of 64 pixels or more, 2x2 below
// (on an H100 the 2x2 tile was faster at 32 and 40 pixels)
inline int tile_side(int n) { return n >= 64 ? 4 : 2; }

// shared floats of a block of nq queries and nk keys of a line of n pixels:
// E and D, the queries' statistics, then q, g, k, v whole (resident), with
// the split products' partial sums, or two stages of one slice of two of them
int64_t rect_floats(int nq, int nk, int n, int CQ, int C, bool resident) {
  const int64_t wc = round_up(C, kCH);
  const int64_t rest =
      resident ? (static_cast<int64_t>(nq) + nk) * (round_up(CQ, kCH) + wc + 8) +
                     round4(static_cast<int64_t>(ksplit(nq, nk, tile_side(n), wc) - 1) * nq * nk)
               : 2 * (static_cast<int64_t>(nq) + nk) * kS;
  return round4(2LL * nq * (nk + 1)) + 4LL * nq + rest;
}

// the largest block of a pass whose rows go in tiles of T pixels
int64_t pass_floats(int H, int W, int CQ, int C, int T, int pass, bool resident) {
  if (pass == kColumn) return rect_floats(H, H, H, CQ, C, resident);
  if (T >= W) return rect_floats(W, W, W, CQ, C, resident);
  const int64_t query_tiles = rect_floats(T, W, W, CQ, C, resident);
  if (pass == kRowStats) return query_tiles;
  const int64_t key_tiles = rect_floats(W, T, W, CQ, C, resident);
  return query_tiles > key_tiles ? query_tiles : key_tiles;
}

constexpr int64_t kMaxFloats = kMaxSmemBytes / sizeof(float);

// The row tile: the whole row up to kTile pixels; beyond, the largest tile of
// equal tiles (at least 16 pixels) whose blocks take q, k, v and g whole, else
// kTile, whose blocks stream them in slices.
int row_tile(int W, int CQ, int C) {
  if (W <= kTile) return W;
  for (int tiles = (W + kTile - 1) / kTile;; ++tiles) {
    const int T = (W + tiles - 1) / tiles;
    if (T < 16) break;
    if (pass_floats(1, W, CQ, C, T, kRowFinal, true) <= kMaxFloats) return T;
  }
  return kTile;
}

int64_t pass_blocks(const Params& p, int pass) {
  if (pass == kColumn) return static_cast<int64_t>(p.B) * p.W;
  const int64_t blocks = static_cast<int64_t>(p.B) * p.H * p.tiles;
  return pass == kRowFinal && p.tiles > 1 ? 2 * blocks : blocks;
}

template <typename T>
auto instance(int n) {
  return tile_side(n) == 4 ? &cc_attention_bwd_kernel<T, 4> : &cc_attention_bwd_kernel<T, 2>;
}

// The calling thread's current card, or -1 past kMaxDevices.
int current_device() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return -1;
  return device;
}

// The shared-memory opt-in holds per card: made once on each (and on every
// launch on a card past kMaxDevices).
template <typename T, int R>
cudaError_t opt_in() {
  static std::atomic<bool> done[kMaxDevices];
  const int device = current_device();
  if (device >= 0 && done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      cc_attention_bwd_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (err == cudaSuccess && device >= 0) done[device].store(true, std::memory_order_release);
  return err;
}

// Fills in the row tiling; false where even slices do not fit: a column of
// more than 137 pixels, or a row of more than 259 in tiles of kTile.
bool plan(Params& p) {
  const int fallback = p.W < kTile ? p.W : kTile;
  for (int pass : {kRowStats, kColumn, kRowFinal})
    if (pass_floats(p.H, p.W, p.CQ, p.C, fallback, pass, false) > kMaxFloats) return false;
  p.tile = row_tile(p.W, p.CQ, p.C);
  p.tiles = (p.W + p.tile - 1) / p.tile;
  return true;
}

// the dynamic shared memory of a pass, and whether its operands go whole
size_t pass_smem(const Params& p, int pass, bool* resident) {
  *resident = pass_floats(p.H, p.W, p.CQ, p.C, p.tile, pass, true) <= kMaxFloats;
  return pass_floats(p.H, p.W, p.CQ, p.C, p.tile, pass, *resident) * sizeof(float);
}

template <typename T>
cudaError_t launch(Params p, cudaStream_t s) {
  if (!plan(p)) return cudaErrorInvalidValue;
  cudaError_t err = opt_in<T, 2>();
  if (err == cudaSuccess) err = opt_in<T, 4>();
  if (err != cudaSuccess) return err;
  for (int pass : {kRowStats, kColumn, kRowFinal}) {
    bool resident;
    const size_t smem = pass_smem(p, pass, &resident);
    const int64_t blocks = pass_blocks(p, pass);
    if (blocks <= 0 || blocks > 2147483647LL) return cudaErrorInvalidValue;
    auto kernel = instance<T>(pass == kColumn ? p.H : p.W);
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(p, pass, resident);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool vector_ok(const void* ptr, int channels, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0 && channels % 4 == 0;
}

// registers, local (spill) bytes, dynamic shared bytes, resident blocks per
// SM, whether the operands go whole, blocks, and the row tile of pass `pass`
template <typename T>
cudaError_t info(Params p, int pass, int* res) {
  if (!plan(p)) return cudaErrorInvalidValue;
  cudaError_t err = opt_in<T, 2>();
  if (err == cudaSuccess) err = opt_in<T, 4>();
  if (err != cudaSuccess) return err;
  bool resident;
  const size_t smem = pass_smem(p, pass, &resident);
  auto kernel = instance<T>(pass == kColumn ? p.H : p.W);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  res[0] = attr.numRegs;
  res[1] = static_cast<int>(attr.localSizeBytes);
  res[2] = static_cast<int>(smem);
  res[4] = resident ? 1 : 0;
  res[5] = static_cast<int>(pass_blocks(p, pass));
  res[6] = pass == kColumn ? p.H : p.tile;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res[3], kernel, kThreads, smem);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats is a float32 workspace of B*H*W*3
// elements, contrib one of B*H*W*(2*CQ + C).  Returns the cudaError_t of the
// shared-memory opt-in or of the first launch that was refused, or 0;
// cudaErrorInvalidValue for a shape whose blocks shared memory cannot hold.
extern "C" int cc_attention_bwd(const void* q, const void* k, const void* v,
                                const void* g, void* dq, void* dk, void* dv,
                                void* stats, void* contrib, int B, int H, int W,
                                int CQ, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = dtype == 0 ? 16 : 8;
  const int vec = (vector_ok(q, CQ, bytes) ? 1 : 0) | (vector_ok(k, CQ, bytes) ? 2 : 0) |
                  (vector_ok(v, C, bytes) ? 4 : 0) | (vector_ok(g, C, bytes) ? 8 : 0);
  const Params p{q, k, v, g, dq, dk, dv, static_cast<float*>(stats),
                 static_cast<float*>(contrib), B, H, W, CQ, C, 0, 0, vec};
  if (dtype == 0) return static_cast<int>(launch<float>(p, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// res[7] = {registers, local (spill) bytes, dynamic shared bytes, resident
// blocks per SM, 1 if the operands are staged whole, blocks, pixels of a
// block's line or row tile} of pass `pass` (0: row statistics, 1: columns,
// 2: rows and the sum) at this shape in dtype; returns a cudaError_t.
extern "C" int cc_attention_bwd_info(int B, int H, int W, int CQ, int C, int dtype,
                                     int pass, int* res) {
  if (pass < kRowStats || pass > kRowFinal || B < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, B, H, W, CQ, C, 0, 0, 0};
  if (dtype == 0) return static_cast<int>(info<float>(p, pass, res));
  if (dtype == 1) return static_cast<int>(info<__nv_bfloat16>(p, pass, res));
  return static_cast<int>(cudaErrorInvalidValue);
}
