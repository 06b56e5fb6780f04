// wkv_chunk: chunked RWKV-6 WKV, the time-mix core of every RWKV layer's
// prefill. Per row of the (BH, S, hd) inputs and per chunk of `chunk` steps,
// with the log decays lw cumulated along time inside the chunk, per column:
//
//     l_exc = cumsum(lw) - lw,  l_inc = l_exc + lw,  l_tot = l_inc[last]
//     out   = strict_lower((r e^{l_exc}) (k e^{-l_inc})^T) v
//             + (sum_d r u k) v + (r e^{l_exc}) S_in
//     S_out = e^{l_tot} . S_in + (k e^{l_tot - l_inc})^T v
//
// with the (hd, hd) state S zero at the row's first chunk. Its gradient,
// wkv_chunked_backward_f32 (the chunk-parallel backward, four kernels) and
// the first backward kernel, wkv_chunked_backward_f32_v1, close this file.
//
// Replaces the Pallas TPU kernel repro/kernels/wkv_chunk.py::wkv_chunked
// (pallas_call at wkv_chunk.py:85), which kept the state of 8 rows in VMEM
// scratch across the sequential chunk axis of its grid and needed BH padded
// to 8 and S to `chunk` (repro/kernels/ops.py:383-399). These kernels take
// any BH and any S (the last chunk of a row may be short) and any hd.
//
// What bounds it on an H100: bytes. Per chunk of K steps the two products
// over the strict lower triangle take K (K - 1) hd fp32 FLOP each and the two
// with the state 2 K hd^2 each; at the rwkv6-3b prefill shape (BH = 160,
// S = 2,048, hd = chunk = 64) that is 8.0 GFLOP, 0.120 ms at the 67 TFLOP/s
// fp32 SIMT peak, against 0.125 ms for the 419 MB it must move.
//
// Every output is one fixed chain of fp32 operations, the same in both
// designs below (the build has no fast-math: expf is the accurate one):
//   * the bonus: lane l of a warp runs fmaf(r_j u_j, k_j, acc) over
//     j = l, l + 32, ... from 0, then a fixed xor-shuffle tree;
//   * the decays, per column in time order: cs += lw, l_exc = cs - lw,
//     l_inc = l_exc + lw; r e^{l_exc}, k e^{-l_inc}, k e^{l_tot - l_inc};
//   * a score: fmaf over j = 0 .. hd-1 from 0; intra: fmaf over b = 0 .. a-1
//     from 0; cross: fmaf over j from 0; out = (intra + bonus v) + cross;
//   * the state: delta = fmaf over a from 0, S = e^{l_tot} S + delta.
// Tiling changes which outputs a thread computes, never the operations of
// one output, so wkv_chunked_f32 gives wkv_chunked_f32_v1's bits. There are
// no atomics, so two runs give the same bits too.
//
// wkv_chunked_f32: the chunk-parallel form, three kernels. Only the state
// carries from one chunk to the next, and its update is elementwise, so:
//   A. wkv_local_kernel, a block per (row, chunk), all 5,120 at the prefill
//      shape in parallel: the chunk's decays, bonus, scores (only the strict
//      lower triangle's 4 x 4 tiles, 16 chains a thread, 8 float4 loads per
//      64 FMAs; the diagonal tiles' 6 entries in pairs), intra + bonus v
//      (into out), r e^{l_exc} (into scratch) and the chunk's state delta
//      (k e^{l_tot - l_inc})^T v (into scratch);
//   B. wkv_scan_kernel, a thread per (row, state row, 4 columns): the 32
//      chunks' states in time order, S = e^{l_tot} S + delta, each written
//      over its chunk's delta as the state entering that chunk;
//   C. wkv_cross_kernel, a block per (row, chunk, 64 columns): cross =
//      (r e^{l_exc}) S_in, 4 x 4 outputs a thread, then out += cross.
// Pass A keeps rows of r, k e^{-l_inc} and k e^{l_tot - l_inc} in shared
// memory with their float4s XOR-swizzled by (row / 4) mod 8, so 8 score
// tiles that read 8 different rows at the same j hit 8 different bank
// groups; at hd = chunk = 64 a block takes 74,496 bytes, three to an SM.
// The price is scratch the caller allocates: r e^{l_exc} and the (hd, hd)
// states, twice the size of r (168 MB at the prefill shape), and about
// 1.1 GB of traffic a call where one kernel that kept the state on chip
// would move 0.42 GB. A block per (row, 32 state columns) that does keep it
// (the column-split design) was slower in trials on the H100: its 320
// blocks are three to an SM on some SMs and two on others, each walks 32
// chunks through barrier phases with few warps busy, and each recomputes
// the row's scores and exps. So was a pass that carried each row's state
// through its chunks in place of passes B and C: its chunks run one after
// another.
//
// What held the first kernel back (wkv_chunked_f32_v1, wkv_chunk_kernel_v1:
// one block per row, kept so that the chip smoke run can hold the new
// kernels against it bit for bit):
//   * 160 blocks for 132 SMs, each walking its 32 chunks through six
//     barrier phases with the whole state;
//   * two scalar shared-memory loads per FMA in every product;
//   * the decays' exps on 64 of 256 threads, and a thread for each of the
//     n^2 scores, half of which do nothing.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------- //
// the first kernel (wkv_chunked_f32_v1)
// ---------------------------------------------------------------------- //
constexpr int V1_THREADS = 256;
constexpr int V1_WARPS = V1_THREADS / 32;

__global__ void __launch_bounds__(V1_THREADS)
wkv_chunk_kernel_v1(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u, float* __restrict__ out,
                    int S, int hd, int chunk) {
  extern __shared__ float smem[];
  const int P = hd + 1;                    // odd pitch of k e^{-l_inc}
  float* st = smem;                        // (hd, hd) state, row j = key dim
  float* rs = st + hd * hd;                // (chunk, hd) r, then r e^{l_exc}
  float* ks = rs + chunk * hd;             // k, then k e^{l_tot - l_inc}
  float* vs = ks + chunk * hd;             // v
  float* ls = vs + chunk * hd;             // lw, then l_inc
  float* kt = ls + chunk * hd;             // (chunk, hd + 1) k e^{-l_inc}
  float* sc = kt + chunk * P;              // (chunk, chunk) scores
  float* bonus = sc + chunk * chunk;       // (chunk,) sum_d r u k

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * S * hd;
  const float* ur = u + static_cast<int64_t>(blockIdx.x) * hd;
  for (int i = t; i < hd * hd; i += V1_THREADS) st[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int n = min(chunk, S - c0);      // steps in this chunk
    const int64_t off = base + static_cast<int64_t>(c0) * hd;
    for (int i = t; i < n * hd; i += V1_THREADS) {
      rs[i] = r[off + i];
      ks[i] = k[off + i];
      vs[i] = v[off + i];
      ls[i] = lw[off + i];
    }
    __syncthreads();

    // the bonus from the unscaled r and k: one warp per step, each lane a
    // fixed strided chain over the columns, then a fixed shuffle tree
    for (int a = warp; a < n; a += V1_WARPS) {
      float acc = 0.0f;
      for (int j = lane; j < hd; j += 32)
        acc = fmaf(rs[a * hd + j] * ur[j], ks[a * hd + j], acc);
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) bonus[a] = acc;
    }
    __syncthreads();

    // the cumulated decays, one thread per column, in time order
    for (int j = t; j < hd; j += V1_THREADS) {
      float cs = 0.0f;
      for (int a = 0; a < n; ++a) {
        const float w = ls[a * hd + j];
        cs += w;
        const float lexc = cs - w;
        const float linc = lexc + w;
        rs[a * hd + j] *= expf(lexc);
        kt[a * P + j] = ks[a * hd + j] * expf(-linc);
        ls[a * hd + j] = linc;
      }
    }
    __syncthreads();

    // k e^{l_tot - l_inc} for the state update (l_tot: the last row of
    // l_inc), and the strictly lower scores (consecutive threads on
    // consecutive key steps b)
    const float* ltot = ls + (n - 1) * hd;
    for (int i = t; i < n * hd; i += V1_THREADS)
      ks[i] *= expf(ltot[i % hd] - ls[i]);
    for (int i = t; i < n * n; i += V1_THREADS) {
      const int a = i / n, b = i - a * n;
      float acc = 0.0f;
      if (b < a)
        for (int j = 0; j < hd; ++j)
          acc = fmaf(rs[a * hd + j], kt[b * P + j], acc);
      sc[a * chunk + b] = acc;
    }
    __syncthreads();

    // out = (intra + bonus v) + cross, consecutive threads on consecutive
    // value columns c
    for (int i = t; i < n * hd; i += V1_THREADS) {
      const int a = i / hd, c = i - a * hd;
      float intra = 0.0f;
      for (int b = 0; b < a; ++b)
        intra = fmaf(sc[a * chunk + b], vs[b * hd + c], intra);
      float cross = 0.0f;
      for (int j = 0; j < hd; ++j)
        cross = fmaf(rs[a * hd + j], st[j * hd + c], cross);
      out[off + i] = (intra + bonus[a] * vs[i]) + cross;
    }
    __syncthreads();

    // S = e^{l_tot} S + (k e^{l_tot - l_inc})^T v
    for (int i = t; i < hd * hd; i += V1_THREADS) {
      const int j = i / hd, c = i - j * hd;
      float delta = 0.0f;
      for (int a = 0; a < n; ++a)
        delta = fmaf(ks[a * hd + j], vs[a * hd + c], delta);
      st[i] = expf(ltot[j]) * st[i] + delta;
    }
    __syncthreads();
  }
}

// Bytes of dynamic shared memory one v1 block needs: the (hd, hd) state,
// the r, k, v and L tiles at pitch hd, k e^{-L} at pitch hd + 1, the
// (chunk, chunk) scores and the bonus.
size_t smem_bytes_v1(int hd, int chunk) {
  return sizeof(float) * (static_cast<size_t>(hd) * hd +
                          4 * static_cast<size_t>(chunk) * hd +
                          static_cast<size_t>(chunk) * (hd + 1) +
                          static_cast<size_t>(chunk) * chunk + chunk);
}


// ---------------------------------------------------------------------- //
// the chunk-parallel kernels (wkv_chunked_f32)
// ---------------------------------------------------------------------- //
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCORE_THREADS = 128;  // threads on the scores in pass A
constexpr int MIN_BLOCKS = 3;       // pass-A blocks per SM the registers allow
constexpr int CROSS_COLS = 64;      // value columns per pass-C block

// Offset of row a in the packed strict lower triangle, each row's a entries
// padded to a multiple of 4 (so every row starts 16-byte aligned).
__host__ __device__ __forceinline__ int tri_off(int a) {
  const int m = a >> 2, s = a & 3;
  return 8 * m * m + 4 * m + (s ? 4 * m + (s - 1) * (4 * m + 4) : 0);
}

// Pass A's shared memory, offsets in floats, all multiples of 4. rt, kt,
// ko: (NR, P) rows of r, k and lw, then r e^{l_exc}, k e^{-l_inc} and
// k e^{l_tot - l_inc}; rt's and kt's float4s swizzled when P is a multiple
// of 32 (ko is read a row at a time). x: the decay cumsum (NR, P), then
// the packed scores; vs: v's (NR, P) tile, inside x's tail (loaded after
// the cumsum is read); bonus (NR), ltot (P).
struct Layout {
  int P, NR, swz, kt, ko, x, vs, bonus, ltot, total;
};

__host__ __device__ __forceinline__ Layout layout(int hd, int chunk) {
  Layout L;
  L.P = (hd + 3) & ~3;
  L.NR = (chunk + 3) & ~3;
  L.swz = (L.P % 32) == 0;
  const int tile = L.NR * L.P;
  L.kt = tile;
  L.ko = 2 * tile;
  L.x = 3 * tile;
  L.vs = L.x + tri_off(L.NR);
  L.bonus = L.vs + tile;
  L.ltot = L.bonus + L.NR;
  L.total = L.ltot + L.P;
  return L;
}

// pass C's shared memory: r e^{l_exc} transposed (P, NR + 4), and a
// (P, CROSS_COLS) slice of the state
__host__ __device__ __forceinline__ int cross_floats(int hd, int chunk) {
  const int P = (hd + 3) & ~3;
  return P * (((chunk + 3) & ~3) + 4) + P * CROSS_COLS;
}

// the float4 group of element (row, j) of a swizzled (NR, P) array: f is
// (row / 4) mod 8 when the layout swizzles, else 0
__device__ __forceinline__ int swz_f(int row, int swz) {
  return swz ? (row >> 2) & 7 : 0;
}
__device__ __forceinline__ int swz_at(int row, int j, int P, int f) {
  return row * P + ((((j >> 2) ^ f) << 2) | (j & 3));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// One off-diagonal 4 x 4 score tile: rows a0 .. a0+3, key steps
// b0 .. b0+3 (b0 + 3 < a0), each entry an fmaf chain over j = 0 .. hd-1.
template <int HD>
__device__ __forceinline__ void score_tile(const float* rt, const float* kt,
                                           float* sc, int a0, int b0,
                                           int hd_arg, int P, int swz) {
  const int hd = HD ? HD : hd_arg;
  const int fa = swz_f(a0, swz), fb = swz_f(b0, swz);
  const float* ra = rt + a0 * P;
  const float* kb = kt + b0 * P;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.0f;
  int j = 0;
#pragma unroll 2
  for (; j + 4 <= hd; j += 4) {
    const int oa = ((j >> 2) ^ fa) << 2, ob = ((j >> 2) ^ fb) << 2;
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = ld4(ra + i * P + oa);
      y[i] = ld4(kb + i * P + ob);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          acc[i][m] = fmaf(at(x[i], s), at(y[m], s), acc[i][m]);
  }
  for (; j < hd; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        acc[i][m] = fmaf(ra[swz_at(i, j, P, fa)], kb[swz_at(m, j, P, fb)],
                         acc[i][m]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(sc + tri_off(a0 + i) + b0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The 6 strictly lower entries of the diagonal tile at rows and key steps
// a0 .. a0+3: (a0 + i, a0 + m) for m < i.
template <int HD>
__device__ __forceinline__ void score_diag(const float* rt, const float* kt,
                                           float* sc, int a0, int hd_arg,
                                           int P, int swz) {
  const int hd = HD ? HD : hd_arg;
  const int f = swz_f(a0, swz);
  const float* ra = rt + a0 * P;
  const float* kb = kt + a0 * P;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int j = 0;
#pragma unroll 2
  for (; j + 4 <= hd; j += 4) {
    const int o = ((j >> 2) ^ f) << 2;
    const float4 x1 = ld4(ra + P + o), x2 = ld4(ra + 2 * P + o),
                 x3 = ld4(ra + 3 * P + o);
    const float4 y0 = ld4(kb + o), y1 = ld4(kb + P + o),
                 y2 = ld4(kb + 2 * P + o);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      acc[0] = fmaf(at(x1, s), at(y0, s), acc[0]);
      acc[1] = fmaf(at(x2, s), at(y0, s), acc[1]);
      acc[2] = fmaf(at(x2, s), at(y1, s), acc[2]);
      acc[3] = fmaf(at(x3, s), at(y0, s), acc[3]);
      acc[4] = fmaf(at(x3, s), at(y1, s), acc[4]);
      acc[5] = fmaf(at(x3, s), at(y2, s), acc[5]);
    }
  }
  for (; j < hd; ++j) {
    const float x1 = ra[swz_at(1, j, P, f)], x2 = ra[swz_at(2, j, P, f)],
                x3 = ra[swz_at(3, j, P, f)];
    const float y0 = kb[swz_at(0, j, P, f)], y1 = kb[swz_at(1, j, P, f)],
                y2 = kb[swz_at(2, j, P, f)];
    acc[0] = fmaf(x1, y0, acc[0]);
    acc[1] = fmaf(x2, y0, acc[1]);
    acc[2] = fmaf(x2, y1, acc[2]);
    acc[3] = fmaf(x3, y0, acc[3]);
    acc[4] = fmaf(x3, y1, acc[4]);
    acc[5] = fmaf(x3, y2, acc[5]);
  }
  sc[tri_off(a0 + 1) + a0] = acc[0];
  sc[tri_off(a0 + 2) + a0] = acc[1];
  sc[tri_off(a0 + 2) + a0 + 1] = acc[2];
  sc[tri_off(a0 + 3) + a0] = acc[3];
  sc[tri_off(a0 + 3) + a0 + 1] = acc[4];
  sc[tri_off(a0 + 3) + a0 + 2] = acc[5];
}

__device__ __forceinline__ void fma4(float* acc, float s, const float4& v) {
  acc[0] = fmaf(s, v.x, acc[0]);
  acc[1] = fmaf(s, v.y, acc[1]);
  acc[2] = fmaf(s, v.z, acc[2]);
  acc[3] = fmaf(s, v.w, acc[3]);
}

// Pass A, a block per (row, chunk): everything that needs no state.
//   out  <- intra + bonus v            (the chunk's rows, hd columns)
//   rbuf <- r e^{l_exc}                (row-major at pitch P)
//   dbuf <- delta = (k e^{l_tot - l_inc})^T v   ((P, P) per chunk)
//   lbuf <- l_tot                      (P per chunk)
// HD: hd when known at compile time (the rwkv6-3b heads, 64), else 0.
// vec: hd % 4 == 0 and r, k, v, lw, out 16-byte aligned.
template <int HD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wkv_local_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, float* __restrict__ out,
                 float* __restrict__ rbuf, float* __restrict__ dbuf,
                 float* __restrict__ lbuf, int S, int hd_arg, int chunk,
                 int nch, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int hd = HD ? HD : hd_arg;
  const Layout L = layout(hd, chunk);
  const int P = L.P, swz = L.swz;
  float* rt = smem;
  float* kt = smem + L.kt;
  float* ko = smem + L.ko;
  float* cs = smem + L.x;      // phases 2-3
  float* sc = smem + L.x;      // phases 4-5
  float* vs = smem + L.vs;     // phases 4-5
  float* bonus = smem + L.bonus;
  float* ltot = smem + L.ltot;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int row = blockIdx.x / nch, ch = blockIdx.x - row * nch;
  const int s0 = ch * chunk;
  const int n = min(chunk, S - s0);            // steps in this chunk
  const int64_t off = (static_cast<int64_t>(row) * S + s0) * hd;
  const int64_t roff = (static_cast<int64_t>(row) * S + s0) * P;
  const int64_t item = static_cast<int64_t>(row) * nch + ch;
  const float* ur = u + static_cast<int64_t>(row) * hd;
  const int pq = P >> 2;

  // 1. r, k and lw into their rows
  if (vec) {
    for (int i = t; i < n * pq; i += THREADS) {
      const int a = i / pq, q = i - a * pq;
      const int64_t g = off + static_cast<int64_t>(a) * hd + 4 * q;
      const int sidx = a * P + ((q ^ swz_f(a, swz)) << 2);
      *reinterpret_cast<float4*>(rt + sidx) = ld4(r + g);
      *reinterpret_cast<float4*>(kt + sidx) = ld4(k + g);
      *reinterpret_cast<float4*>(ko + a * P + 4 * q) = ld4(lw + g);
    }
  } else {
    for (int i = t; i < n * hd; i += THREADS) {
      const int a = i / hd, j = i - a * hd;
      const int sidx = swz_at(a, j, P, swz_f(a, swz));
      rt[sidx] = r[off + i];
      kt[sidx] = k[off + i];
      ko[a * P + j] = lw[off + i];
    }
  }
  __syncthreads();

  // 2. the cumulated decays, a thread per column in time order, and l_tot;
  // the bonus from the unscaled r and k, a warp per step
  for (int j = t; j < hd; j += THREADS) {
    float c = 0.0f, w = 0.0f;
#pragma unroll 4
    for (int a = 0; a < n; ++a) {
      w = ko[a * P + j];
      c += w;
      cs[a * P + j] = c;
    }
    const float lexc = c - w;
    ltot[j] = lexc + w;
    lbuf[item * P + j] = lexc + w;
  }
  for (int a = warp; a < n; a += WARPS) {
    const int f = swz_f(a, swz);
    float acc = 0.0f;
    for (int j = lane; j < hd; j += 32) {
      const int sidx = swz_at(a, j, P, f);
      acc = fmaf(rt[sidx] * ur[j], kt[sidx], acc);
    }
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) bonus[a] = acc;
  }
  __syncthreads();

  // 3. the exps over all threads: r e^{l_exc} (also to rbuf), k e^{-l_inc}
  // and k e^{l_tot - l_inc}, in place
  for (int i = t; i < n * hd; i += THREADS) {
    const int a = i / hd, j = i - a * hd;
    const int sidx = swz_at(a, j, P, swz_f(a, swz));
    const float w = ko[a * P + j];
    const float lexc = cs[a * P + j] - w;
    const float linc = lexc + w;
    const float kk = kt[sidx];
    const float rr = rt[sidx] * expf(lexc);
    rt[sidx] = rr;
    rbuf[roff + a * P + j] = rr;
    kt[sidx] = kk * expf(-linc);
    ko[a * P + j] = kk * expf(ltot[j] - linc);
  }
  __syncthreads();

  // 4. the strictly lower scores on SCORE_THREADS threads: first the
  // off-diagonal 4 x 4 tiles (ia > ib, by ia then ib), then the diagonal
  // tiles in pairs; the other threads load v's tile (zero past hd)
  const int nq = (n + 3) >> 2;
  const int n_off = nq * (nq - 1) / 2;
  if (t < SCORE_THREADS) {
    const int items = n_off + (nq + 1) / 2;
    for (int it = t; it < items; it += SCORE_THREADS) {
      if (it < n_off) {
        int ia = static_cast<int>(
            (1.0f + sqrtf(1.0f + 8.0f * static_cast<float>(it))) * 0.5f);
        while (ia * (ia - 1) / 2 > it) --ia;
        while ((ia + 1) * ia / 2 <= it) ++ia;
        const int ib = it - ia * (ia - 1) / 2;
        score_tile<HD>(rt, kt, sc, 4 * ia, 4 * ib, hd, P, swz);
      } else {
        const int ia = 2 * (it - n_off);
        score_diag<HD>(rt, kt, sc, 4 * ia, hd, P, swz);
        if (ia + 1 < nq) score_diag<HD>(rt, kt, sc, 4 * ia + 4, hd, P, swz);
      }
    }
  } else {
    for (int i = t - SCORE_THREADS; i < n * pq;
         i += THREADS - SCORE_THREADS) {
      const int a = i / pq, c = 4 * (i - a * pq);
      const int64_t g = off + static_cast<int64_t>(a) * hd + c;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (vec) {
        x = ld4(v + g);
      } else {
        if (c < hd) x.x = v[g];
        if (c + 1 < hd) x.y = v[g + 1];
        if (c + 2 < hd) x.z = v[g + 2];
        if (c + 3 < hd) x.w = v[g + 3];
      }
      *reinterpret_cast<float4*>(vs + a * P + c) = x;
    }
  }
  __syncthreads();

  // 5. intra + bonus v for the rows a1 = p and a2 = n - 1 - p, 4 columns
  // an item (so every item's intra chains have n - 1 terms between them):
  // both rows over b < a1, then each row's rest. Then delta, rows j and
  // j + 1 and 4 columns an item (rows and columns past hd are never read).
  const int npairs = (n + 1) >> 1;
  for (int it = t; it < npairs * pq; it += THREADS) {
    const int p = it / pq, c = 4 * (it - p * pq);
    const int a1 = p, a2 = n - 1 - p;
    float i1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float i2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* s1 = sc + tri_off(a1);
    const float* s2 = sc + tri_off(a2);
    const float* vb = vs + c;
    int b = 0;
    for (; b + 4 <= a1; b += 4) {
      const float4 y1 = ld4(s1 + b), y2 = ld4(s2 + b);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 vv = ld4(vb + (b + x) * P);
        fma4(i1, at(y1, x), vv);
        fma4(i2, at(y2, x), vv);
      }
    }
    for (int bb = b; bb < a1; ++bb) fma4(i1, s1[bb], ld4(vb + bb * P));
    for (; b + 4 <= a2; b += 4) {
      const float4 y2 = ld4(s2 + b);
#pragma unroll
      for (int x = 0; x < 4; ++x) fma4(i2, at(y2, x), ld4(vb + (b + x) * P));
    }
    for (; b < a2; ++b) fma4(i2, s2[b], ld4(vb + b * P));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = h ? a2 : a1;
      if (h && a2 == a1) break;
      const float* in = h ? i2 : i1;
      const float4 va = ld4(vs + a * P + c);
      const float ba = bonus[a];
      float* o = out + off + static_cast<int64_t>(a) * hd + c;
      const float o0 = in[0] + ba * va.x, o1 = in[1] + ba * va.y,
                  o2 = in[2] + ba * va.z, o3 = in[3] + ba * va.w;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(o0, o1, o2, o3);
      } else {
        if (c < hd) o[0] = o0;
        if (c + 1 < hd) o[1] = o1;
        if (c + 2 < hd) o[2] = o2;
        if (c + 3 < hd) o[3] = o3;
      }
    }
  }
  float* db = dbuf + item * P * P;
  for (int it = t; it < (P >> 1) * pq; it += THREADS) {
    const int jp = it / pq, c = 4 * (it - jp * pq);
    const int j = 2 * jp;
    float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* kp = ko + j;
    const float* vp = vs + c;
#pragma unroll 4
    for (int a = 0; a < n; ++a, kp += P, vp += P) {
      const float2 kk = *reinterpret_cast<const float2*>(kp);
      const float4 vv = ld4(vp);
      fma4(d0, kk.x, vv);
      fma4(d1, kk.y, vv);
    }
    *reinterpret_cast<float4*>(db + j * P + c) =
        make_float4(d0[0], d0[1], d0[2], d0[3]);
    *reinterpret_cast<float4*>(db + (j + 1) * P + c) =
        make_float4(d1[0], d1[1], d1[2], d1[3]);
  }
}

// Pass B, a thread per (row, j, 4 columns): the states entering each chunk,
// in place of the deltas: S_0 = 0, S_{i+1} = e^{l_tot,i} S_i + delta_i,
// SCAN_AHEAD chunks' deltas loaded before they are used.
constexpr int SCAN_AHEAD = 4;

__global__ void __launch_bounds__(256)
wkv_scan_kernel(float* __restrict__ dbuf, const float* __restrict__ lbuf,
                int64_t BH, int P, int nch) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int pq = P >> 2;
  const int64_t per_row = static_cast<int64_t>(P) * pq;
  if (idx >= BH * per_row) return;
  const int64_t row = idx / per_row;
  const int jq = static_cast<int>(idx - row * per_row);
  const int j = jq / pq;
  const int64_t pp = static_cast<int64_t>(P) * P;
  float4* d = reinterpret_cast<float4*>(dbuf + row * nch * pp) + jq;
  const float* l = lbuf + row * nch * P + j;
  float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < nch; c0 += SCAN_AHEAD) {
    float4 x[SCAN_AHEAD];
    float e[SCAN_AHEAD];
#pragma unroll
    for (int b = 0; b < SCAN_AHEAD; ++b) {
      if (c0 + b < nch) {
        x[b] = d[(c0 + b) * pp / 4];
        e[b] = l[(c0 + b) * P];
      }
    }
#pragma unroll
    for (int b = 0; b < SCAN_AHEAD; ++b) {
      if (c0 + b >= nch) break;
      d[(c0 + b) * pp / 4] = st;
      const float g = expf(e[b]);
      st.x = g * st.x + x[b].x;
      st.y = g * st.y + x[b].y;
      st.z = g * st.z + x[b].z;
      st.w = g * st.w + x[b].w;
    }
  }
}

// Pass C, a block per (row, chunk, CROSS_COLS columns): out += (r e^{l_exc})
// S_in, a thread per 4 x 4 outputs, an fmaf chain over j = 0 .. hd-1 from
// 0, then out = (intra + bonus v) + cross. r e^{l_exc} is transposed into
// shared memory, so a step of j reads one float4 of 4 rows and one of 4
// columns.
template <int HD>
__global__ void __launch_bounds__(THREADS)
wkv_cross_kernel(const float* __restrict__ rbuf,
                 const float* __restrict__ dbuf, float* __restrict__ out,
                 int S, int hd_arg, int chunk, int nch, int ctiles, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int hd = HD ? HD : hd_arg;
  const int P = (hd + 3) & ~3, RP = ((chunk + 3) & ~3) + 4;
  float* rT = smem;             // (P, RP)
  float* ss = smem + P * RP;    // (P, CROSS_COLS)
  const int t = threadIdx.x;
  const int ct = blockIdx.x % ctiles;
  const int it0 = blockIdx.x / ctiles;
  const int row = it0 / nch, ch = it0 - row * nch;
  const int s0 = ch * chunk;
  const int n = min(chunk, S - s0);
  const int64_t off = (static_cast<int64_t>(row) * S + s0) * hd;
  const int64_t roff = (static_cast<int64_t>(row) * S + s0) * P;
  const int c0 = ct * CROSS_COLS;
  const int ncol = min(CROSS_COLS, P - c0);    // a multiple of 4
  const int pq = P >> 2, cq = ncol >> 2;
  for (int i = t; i < n * pq; i += THREADS) {
    const int a = i / pq, q = i - a * pq;
    const float4 x = ld4(rbuf + roff + static_cast<int64_t>(a) * P + 4 * q);
    rT[(4 * q) * RP + a] = x.x;
    rT[(4 * q + 1) * RP + a] = x.y;
    rT[(4 * q + 2) * RP + a] = x.z;
    rT[(4 * q + 3) * RP + a] = x.w;
  }
  const float* sg = dbuf + (static_cast<int64_t>(row) * nch + ch) * P * P +
                    c0;
  for (int i = t; i < P * cq; i += THREADS) {
    const int j = i / cq, q = i - j * cq;
    *reinterpret_cast<float4*>(ss + j * CROSS_COLS + 4 * q) =
        ld4(sg + static_cast<int64_t>(j) * P + 4 * q);
  }
  __syncthreads();
  const int nrq = (n + 3) >> 2;
  for (int it = t; it < nrq * cq; it += THREADS) {
    const int rq = it / cq, c = 4 * (it - rq * cq);
    if (c0 + c >= hd) continue;
    const int a0 = 4 * rq;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[i][m] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < hd; ++j) {
      const float4 ra = ld4(rT + j * RP + a0);
      const float4 sv = ld4(ss + j * CROSS_COLS + c);
      fma4(acc[0], ra.x, sv);
      fma4(acc[1], ra.y, sv);
      fma4(acc[2], ra.z, sv);
      fma4(acc[3], ra.w, sv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (a0 + i >= n) break;
      float* o = out + off + static_cast<int64_t>(a0 + i) * hd + c0 + c;
      if (vec) {
        const float4 lo = *reinterpret_cast<const float4*>(o);
        *reinterpret_cast<float4*>(o) =
            make_float4(lo.x + acc[i][0], lo.y + acc[i][1],
                        lo.z + acc[i][2], lo.w + acc[i][3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (c0 + c + m < hd) o[m] = o[m] + acc[i][m];
      }
    }
  }
}

// The largest dynamic shared memory a block may opt in to on the current
// device.
int max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return bytes;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int HD>
cudaError_t launch_all(const float* r, const float* k, const float* v,
                       const float* lw, const float* u, float* out,
                       float* rbuf, float* dbuf, float* lbuf, int BH, int S,
                       int hd, int chunk, size_t smem_a, size_t smem_c,
                       int vec, cudaStream_t stream) {
  const int nch = (S + chunk - 1) / chunk;
  const int P = (hd + 3) & ~3;
  const unsigned items = static_cast<unsigned>(BH) * nch;
  cudaError_t e = cudaFuncSetAttribute(
      wkv_local_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv_local_kernel<HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv_cross_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (e != cudaSuccess) return e;
  wkv_local_kernel<HD><<<items, THREADS, smem_a, stream>>>(
      r, k, v, lw, u, out, rbuf, dbuf, lbuf, S, hd, chunk, nch, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t scan = static_cast<int64_t>(BH) * P * (P >> 2);
  wkv_scan_kernel<<<static_cast<unsigned>((scan + 255) / 256), 256, 0,
                    stream>>>(dbuf, lbuf, BH, P, nch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int ctiles = (P + CROSS_COLS - 1) / CROSS_COLS;
  wkv_cross_kernel<HD><<<items * ctiles, THREADS, smem_c, stream>>>(
      rbuf, dbuf, out, S, hd, chunk, nch, ctiles, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------- //
// the backward (wkv_chunked_backward_f32, and its first kernel _v1)
// ---------------------------------------------------------------------- //
// The VJP of the recurrence (S_{-1} = 0, w_t = e^{lw_t}):
//
//     out_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1}
//                                                       + k_t^T v_t
//
// for the output cotangent g. Replaces no Pallas kernel: the reference
// differentiates its kernel through jax.vjp of the sequential oracle
// (repro/kernels/ops.py:408-414), which XLA compiles into one scan.
// Without a compiler, autograd through the per-token loop would launch
// some 20 operations a step.
//
// wkv_chunked_backward_f32 differentiates the forward's chunked form. Per
// row and chunk of K steps (the forward's chunk), with the forward's
// r~ = r e^{l_exc}, k~ = k e^{-l_inc}, A = strict_lower(r~ k~^T), its
// entering state S_in, G_out = dL/dS_out (zero for a row's last chunk),
// G' = e^{l_tot} . G_out and dA = strict_lower(g v^T):
//
//     out   = A v + (sum r u k) v + r~ S_in
//     S_out = e^{l_tot} . S_in + k^^T v
//     dv    = A^T g + (sum r u k) g + k~ G'         (k~ G' = k^ G_out)
//     dr'   = e^{l_exc} . (dA k~ + g S_in^T),       dr = dr' + u k (g . v)
//     dk'   = e^{-l_inc} . (dA^T r~ + v G'^T),      dk = dk' + u r (g . v)
//     G_in  = G' + r~^T g                 (the previous chunk's G_out)
//     du    = sum_t r_t k_t (g_t . v_t)
//
// with k^ = k e^{l_tot - l_inc}; e^{-l_inc} v G'^T is e^{l_tot - l_inc}
// v G_out^T regrouped. dlw: the loss sees the row's cumulative log decay
// L_t only through r_{t+1} e^{L_t} and k_t e^{-L_t}, so with dr', dk' the
// bonus-free gradients and x_s = r_s dr'_s - k_s dk'_s,
//
//     dlw_t = sum_{s>t} r_s dr'_s - sum_{s>=t} k_s dk'_s,
//
// O(hd) a step and no contraction. Over a chunk ending at step e the tail
// sum_{s>e} x_s is the same identity taken at the chunk's edge, where it is
// Z = sum_j G_out[:, j] S_out[:, j] (the gradient of a common log scale of
// the state leaving the chunk). So dlw_t = Z + sum_{t<s<=e} r_s dr'_s -
// sum_{t<=s<=e} k_s dk'_s, a reverse cumulative sum inside the chunk. Z is
// formed from the edge's state and gradient, not by adding the later
// chunks' totals: that suffix sum carries every later step's rounding, so
// its error grows with the distance to the row's end, where Z's does not.
//
// Four kernels, one counted call (the wrapper's), all sums in a fixed order
// and no atomics, so two calls give the same bits:
//   B1. wkv_bwd_gx_kernel, a block per (row, chunk): r~^T g (P x P) of the
//       chunk into gbuf, and g S_in^T, the part of dr~ with no intra-chunk
//       term, into dr, from the forward's r~ (rbuf) and S_in (dbuf);
//   B2. wkv_bwd_scan_kernel, a thread per (row, state row, 4 columns): the
//       chunks last to first, G = e^{l_tot} G + r~^T g, writing G_out over
//       each chunk's r~^T g;
//   C.  wkv_bwd_local_kernel, a block per (row, chunk), 2,560 at the
//       training shape (BH 80, S 2,048, K = hd = 64), two to an SM: the
//       decays (a column's cumulative sum walked by one thread, the factors
//       applied by all), A over the strict lower triangle's 4 x 4 tiles
//       (packed onto the first threads, so whole warps sit out), dv, then
//       dA in A's place, then dk' and dr' (a 4 x 4 tile of each a thread,
//       register-tiled products over XOR-swizzled shared memory as in pass
//       A of the forward), Z, the in-chunk reverse cumulative sum of dlw,
//       and the chunk's du partial;
//   D.  wkv_bwd_du_kernel: du, the chunks' partials added in chunk order.
// B1 and C stage a chunk's operands with 16-byte cp.async when every
// (BH, S, hd) operand allows float4 access. Pass C keeps in shared memory
// only the four (K, hd) operands r~, k~, v, g, one (K, K) slot that holds
// A and then dA, and G' (100 KB at K = hd = 64, so two blocks share an SM
// and one's loads and serial steps overlap the other's products); g S_in^T
// comes from B1 through dr, l_exc waits in dlw, and r, k, lw are read
// again from device memory for the bonus terms and the factors. The
// chunks' entering states S_in are the forward's pass-B scratch (dbuf),
// kept by the autograd op; with none given, the Python wrapper runs the
// forward's kernel for them first. Only the forward's decay factors
// appear, e^{l_exc}, e^{-l_inc} and e^{l_tot} within one chunk (the
// forward forms e^{l_tot - l_inc} and e^{l_tot}), so the backward
// overflows only where the forward does. What each of pass C's stages
// costs is read by tools/wkv_backward_trials.py --cuts.
//
// What bounds it on an H100: from its inputs alone the gradient needs, a
// step and row in chunks of K, the states' k^T v, G's r~^T g and the
// cross terms g S_in^T, v G'^T and k~ G' (2 hd^2 each), the two decays
// once a chunk (2 hd^2 / K) and five strict-lower products inside the
// chunk (5 (K - 1) hd): 10.7 hd^2 at its best K (about 5 at hd 64; K = 1
// is the sequential recurrence's 12 hd^2), dlw being O(hd). That is 7.19
// GFLOP at BH 80, S 2,048, hd 64, 0.107 ms at the 67 TFLOP/s fp32 peak,
// below the 0.113 ms for the 377 MB it must move (r, k, v, lw, g in; dr,
// dk, dv, dlw out), so bytes bound it. Given the forward's states it
// needs fewer operations still (8 hd^2 + 2 hd^2 / K + 5 (K - 1) hd).
// This design does 2.5 K hd + 4 hd^2 FMA a step (13 hd^2 FLOP at K = hd)
// and moves about 1.1 GB: pass C reads r, k and lw again for its epilogue
// and du, and S_in, S_out, r~, G and g S_in^T pass through device memory.
//
// What held the first kernel back (wkv_chunked_backward_f32_v1, below), and
// what this design does about it:
//   * one block per row, 80 blocks for 132 SMs: here 2,560 blocks;
//   * 2,048 steps one after another, a barrier and a shared-memory
//     reduction each: here the chunks run in parallel, and a chunk's steps
//     are the rows of its 4 x 4-tiled products;
//   * every step replayed S_{t-1} from a checkpoint 16 steps back, the
//     state's work about 7.5 times over: here the states are the forward's;
//   * dlw by a direct hd^2 contraction a step: here the O(hd) identity.
// The first kernel stays as the yardstick the chip smoke run times this
// one against and holds to its own bound; it is on no path of the port.
//
// wkv_chunked_backward_f32_v1: one block per row, (P / 4)^2 threads for P
// = hd rounded up to 4 (256 at hd = 64); thread (ti, tj) holds the 4 x 4
// tile of S and of G at rows 4 ti .. 4 ti + 3 and columns 4 tj .. 4 tj + 3
// in registers. A forward sweep writes the state entering every
// seg_len-step segment to the caller's scratch. The reverse sweep then
// takes the segments last to first with G_t = dL/dS_t, G_{S-1} = 0:
//     dr_t[i]  = sum_j g_t[j] S_{t-1}[i,j] + u[i] k_t[i] (g_t . v_t)
//     dk_t[i]  = sum_j G_t[i,j] v_t[j]     + u[i] r_t[i] (g_t . v_t)
//     dv_t[j]  = sum_i k_t[i] G_t[i,j]     + g_t[j] (sum_i r_t[i] u[i] k_t[i])
//     dlw_t[i] = w_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
//     G_{t-1}  = diag(w_t) G_t + r_t^T g_t
// staging the segment's inputs in shared memory and, for each step t,
// replaying S_{t-1} from the segment's checkpoint in registers (never
// S_{t-1} = (S_t - k v) / w_t, which blows up for decays near 0). Each
// thread's row sums (dr, dk, dlw over its 4 columns) and column sums (dv
// over its 4 rows) go to shared memory, double-buffered by step parity so
// a step takes one barrier; one thread per (output, index) adds the P / 4
// partials in tile order. seg_len is the caller's (the Python wrapper's
// BACKWARD_SEGMENT), which sizes the checkpoint scratch by it.
constexpr int BWD_MAX_HD = 64;    // (64 / 4)^2 = 256 threads a block

struct BwdLayout {
  int P, NQ, rp, sr, sk, sv, sw, sg, gv, bk, su, sdu, red, red_buf, total;
};

// Shared memory, offsets in floats, every array 16-byte aligned: the
// segment's r, k, v, w = e^{lw} and g (seg_len, P), zero past hd; its
// g . v and sum r u k (seg_len); u and the du sums (P); two reduction
// buffers, each the row partials (3, NQ, P + 4) - the pitch P + 4 keeps
// the 8 lanes of a float4 store phase on 8 different bank groups - then
// the column partials (NQ, P).
__host__ __device__ __forceinline__ BwdLayout bwd_layout(int hd,
                                                        int seg_len) {
  BwdLayout L;
  L.P = (hd + 3) & ~3;
  L.NQ = L.P >> 2;
  L.rp = L.P + 4;
  const int tile = seg_len * L.P;
  L.sr = 0;
  L.sk = tile;
  L.sv = 2 * tile;
  L.sw = 3 * tile;
  L.sg = 4 * tile;
  L.gv = 5 * tile;
  L.bk = L.gv + seg_len;
  L.su = L.bk + seg_len;
  L.sdu = L.su + L.P;
  L.red = L.sdu + L.P;
  L.red_buf = 3 * L.NQ * L.rp + L.NQ * L.P;
  L.total = L.red + 2 * L.red_buf;
  return L;
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// S <- diag(w) S + k^T v on a thread's tile, one fmaf an element.
__device__ __forceinline__ void state_step(float (&st)[4][4],
                                           const float4& w, const float4& k,
                                           const float4& v) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st[a][c] = fmaf(at(w, a), st[a][c], at(k, a) * at(v, c));
}

// Stage steps t0 .. t0 + n - 1 of a row into shared memory, zero past hd
// (w = e^{lw}); with g == nullptr only k, v and w (the forward sweep).
__device__ __forceinline__ void stage(float* smem, const BwdLayout& L,
                                      const float* r, const float* k,
                                      const float* v, const float* lw,
                                      const float* g, int64_t off, int n,
                                      int hd, int tid, int nt) {
  for (int x = tid; x < n * L.P; x += nt) {
    const int a = x / L.P, j = x - a * L.P;
    const bool in = j < hd;
    const int64_t gi = off + static_cast<int64_t>(a) * hd + j;
    smem[L.sk + x] = in ? k[gi] : 0.0f;
    smem[L.sv + x] = in ? v[gi] : 0.0f;
    smem[L.sw + x] = in ? expf(lw[gi]) : 0.0f;
    if (g != nullptr) {
      smem[L.sr + x] = in ? r[gi] : 0.0f;
      smem[L.sg + x] = in ? g[gi] : 0.0f;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(256)
wkv_bwd_kernel_v1(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ g,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dlw,
               float* __restrict__ du, float* __restrict__ ckpt, int S,
               int hd_arg, int seg_len) {
  extern __shared__ __align__(16) float smem[];
  const int hd = HD ? HD : hd_arg;
  const BwdLayout L = bwd_layout(hd, seg_len);
  const int P = L.P, NQ = L.NQ, nt = NQ * NQ;
  const int tid = threadIdx.x;
  const int ti = tid / NQ, tj = tid - ti * NQ;
  const int r0 = 4 * ti, c0 = 4 * tj;
  const int row = blockIdx.x;
  const int nseg = (S + seg_len - 1) / seg_len;
  const int64_t base = static_cast<int64_t>(row) * S * hd;
  float* ck_row = ckpt + static_cast<int64_t>(row) * nseg * P * P;

  for (int j = tid; j < P; j += nt) {
    smem[L.su + j] = j < hd ? u[static_cast<int64_t>(row) * hd + j] : 0.0f;
    smem[L.sdu + j] = 0.0f;
  }

  // forward sweep: the state entering each segment
  float st[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[a][c] = 0.0f;
  for (int seg = 0; seg < nseg; ++seg) {
    const int t0 = seg * seg_len, n = min(seg_len, S - t0);
    float* ck = ck_row + static_cast<int64_t>(seg) * P * P;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      st4(ck + (r0 + a) * P + c0, st[a][0], st[a][1], st[a][2], st[a][3]);
    if (seg == nseg - 1) break;          // the last segment's end: unused
    __syncthreads();
    stage(smem, L, r, k, v, lw, nullptr, base + static_cast<int64_t>(t0) * hd,
          n, hd, tid, nt);
    __syncthreads();
    for (int p = 0; p < n; ++p)
      state_step(st, ld4(smem + L.sw + p * P + r0),
                 ld4(smem + L.sk + p * P + r0), ld4(smem + L.sv + p * P + c0));
  }

  // reverse sweep
  float gg[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) gg[a][c] = 0.0f;
  int buf = 0;
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * seg_len, n = min(seg_len, S - t0);
    const int64_t off = base + static_cast<int64_t>(t0) * hd;
    __syncthreads();                     // the last segment's reads done
    stage(smem, L, r, k, v, lw, g, off, n, hd, tid, nt);
    float ck[4][4];
    const float* cks = ck_row + static_cast<int64_t>(seg) * P * P;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 q = ld4(cks + (r0 + a) * P + c0);
      ck[a][0] = q.x;
      ck[a][1] = q.y;
      ck[a][2] = q.z;
      ck[a][3] = q.w;
    }
    __syncthreads();
    // per step: g . v and sum_i r u k, each an fmaf chain in index order
    for (int s = tid; s < n; s += nt) {
      float gv = 0.0f, bk = 0.0f;
      for (int j = 0; j < hd; ++j) {
        gv = fmaf(smem[L.sg + s * P + j], smem[L.sv + s * P + j], gv);
        bk = fmaf(smem[L.sr + s * P + j] * smem[L.su + j],
                  smem[L.sk + s * P + j], bk);
      }
      smem[L.gv + s] = gv;
      smem[L.bk + s] = bk;
    }
    __syncthreads();
    for (int s = n - 1; s >= 0; --s) {
      // S_{t-1}: the checkpoint with steps 0 .. s-1 of the segment
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[a][c] = ck[a][c];
      for (int p = 0; p < s; ++p)
        state_step(st, ld4(smem + L.sw + p * P + r0),
                   ld4(smem + L.sk + p * P + r0),
                   ld4(smem + L.sv + p * P + c0));
      const float4 gc = ld4(smem + L.sg + s * P + c0);
      const float4 vc = ld4(smem + L.sv + s * P + c0);
      const float4 kr = ld4(smem + L.sk + s * P + r0);
      const float4 rr = ld4(smem + L.sr + s * P + r0);
      const float4 wr = ld4(smem + L.sw + s * P + r0);
      float pr[4], pk[4], pl[4], pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pr[a] = 0.0f;
        pk[a] = 0.0f;
        pl[a] = 0.0f;
        pv[a] = 0.0f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pr[a] = fmaf(at(gc, c), st[a][c], pr[a]);
          pk[a] = fmaf(gg[a][c], at(vc, c), pk[a]);
          pl[a] = fmaf(gg[a][c], st[a][c], pl[a]);
        }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[c] = fmaf(at(kr, a), gg[a][c], pv[c]);
      float* red = smem + L.red + buf * L.red_buf;
      st4(red + (0 * NQ + tj) * L.rp + r0, pr[0], pr[1], pr[2], pr[3]);
      st4(red + (1 * NQ + tj) * L.rp + r0, pk[0], pk[1], pk[2], pk[3]);
      st4(red + (2 * NQ + tj) * L.rp + r0, pl[0], pl[1], pl[2], pl[3]);
      st4(red + 3 * NQ * L.rp + ti * P + c0, pv[0], pv[1], pv[2], pv[3]);
      // G_{t-1} = diag(w_t) G_t + r_t^T g_t
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          gg[a][c] = fmaf(at(wr, a), gg[a][c], at(rr, a) * at(gc, c));
      __syncthreads();
      // one thread per (output, index): the partials in tile order, then
      // the bonus terms
      const int64_t o = off + static_cast<int64_t>(s) * hd;
      const float gvs = smem[L.gv + s];
      for (int x = tid; x < 4 * P; x += nt) {
        const int q = x / P, i = x - q * P;
        if (i >= hd) continue;
        float acc = 0.0f;
        if (q < 3) {
          for (int m = 0; m < NQ; ++m) acc += red[(q * NQ + m) * L.rp + i];
        } else {
          for (int m = 0; m < NQ; ++m) acc += red[3 * NQ * L.rp + m * P + i];
        }
        const float ri = smem[L.sr + s * P + i], ki = smem[L.sk + s * P + i];
        const float ui = smem[L.su + i];
        if (q == 0) {
          dr[o + i] = acc + ui * ki * gvs;
        } else if (q == 1) {
          dk[o + i] = acc + ui * ri * gvs;
          smem[L.sdu + i] += ri * ki * gvs;
        } else if (q == 2) {
          dlw[o + i] = smem[L.sw + s * P + i] * acc;
        } else {
          dv[o + i] = acc + smem[L.bk + s] * smem[L.sg + s * P + i];
        }
      }
      buf ^= 1;
    }
  }
  __syncthreads();
  for (int j = tid; j < hd; j += nt)
    du[static_cast<int64_t>(row) * hd + j] = smem[L.sdu + j];
}


// ---------------------------------------------------------------------- //
// the chunk-parallel backward (wkv_chunked_backward_f32)
// ---------------------------------------------------------------------- //
constexpr int BWD_THREADS = 256;
constexpr int BWD_MAX_CHUNK = 64;    // a (chunk, chunk) product: 16 x 16 tiles

// Element (row, col) of a (rows, W) tile whose float4s are XOR-swizzled by
// (row / 4) mod 8 when sw (W a multiple of 32), as in the forward's pass A.
__device__ __forceinline__ int sidx(int row, int col, int W, int sw) {
  return row * W + ((((col >> 2) ^ (sw ? (row >> 2) & 7 : 0)) << 2) |
                    (col & 3));
}

// acc[i][m] += sum_{k0 <= k < k1} X(r0 + i, k) Y(k, c0 + m): X(row, k)
// stored at [row][k] (or [k][row] when XT), Y(k, col) at [k][col] (or
// [col][k] when YT), tiles of pitch WX, WY swizzled when sx, sy. k0 and k1
// are multiples of 4; each output is an fmaf chain in k order. A quarter
// warp shares r0 and reads 8 consecutive c0: the X side is a broadcast and
// the Y side 8 different float4 slots in either orientation.
template <bool XT, bool YT>
__device__ __forceinline__ void mm4(float (&acc)[4][4],
                                    const float* __restrict__ X, int WX,
                                    int sx, const float* __restrict__ Y,
                                    int WY, int sy, int r0, int c0, int k0,
                                    int k1) {
  const int rq = r0 >> 2, cq = c0 >> 2;
  const int fr = sx ? rq & 7 : 0, fc = sy ? cq & 7 : 0;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    const int kq = k >> 2;
    float4 x[4], y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = XT ? ld4(X + (k + q) * WX + ((rq ^ (sx ? kq & 7 : 0)) << 2))
                : ld4(X + (r0 + q) * WX + ((kq ^ fr) << 2));
      y[q] = YT ? ld4(Y + (c0 + q) * WY + ((kq ^ fc) << 2))
                : ld4(Y + (k + q) * WY + ((cq ^ (sy ? kq & 7 : 0)) << 2));
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          acc[i][m] = fmaf(XT ? at(x[s], i) : at(x[i], s),
                           YT ? at(y[m], s) : at(y[s], m), acc[i][m]);
  }
}

__device__ __forceinline__ void zero4x4(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.0f;
}

// strict_lower(X Y^T) of two (NR, P) tiles (pitch P, swizzled when sp) into
// Z (pitch NR, swizzled when sn): the (NR / 4)(NR / 4 + 1) / 2 tiles of 4 x
// 4 on or below the diagonal, packed onto the first threads so that whole
// warps sit out (spread over the grid, most warps would wait on a few
// lanes); the tiles above the diagonal are left as they are, no product
// reads them.
__device__ __forceinline__ void lower_product(float* Z, int NR, int sn,
                                              const float* X, const float* Y,
                                              int P, int sp, int t,
                                              int nthreads) {
  const int nq = NR >> 2;
  for (int x = t; x < nq * (nq + 1) / 2; x += nthreads) {
    int tr = static_cast<int>((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
    while (tr * (tr + 1) / 2 > x) --tr;
    while ((tr + 1) * (tr + 2) / 2 <= x) ++tr;
    const int r0 = 4 * tr, c0 = 4 * (x - tr * (tr + 1) / 2);
    float a4[4][4];
    zero4x4(a4);
    mm4<false, true>(a4, X, P, sp, Y, P, sp, r0, c0, 0, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (c0 + m >= r0 + i) a4[i][m] = 0.0f;
      *reinterpret_cast<float4*>(Z + sidx(r0 + i, c0, NR, sn)) =
          make_float4(a4[i][0], a4[i][1], a4[i][2], a4[i][3]);
    }
  }
}

// Pass C's shared memory, offsets in floats (all multiples of 4): four
// (NR, P) tiles - r~, k~, v, g (r, k raw until the decays) -, X (NR,
// max(NR, P)): lw until the decays, then A, then dA, at pitch NR -, G'
// (P, P), then e^{l_tot}, g . v, sum r u k, u, Z and the partial sums (of
// g . v, sum r u k and Z, then of dlw and du). 100 KB at hd = chunk = 64,
// so two blocks share an SM.
struct LocalLayout {
  int P, NR, sp, sn, rt, kt, vv, gg, X, Gp, etot, gv, bk, su, z, part,
      total;
};

__host__ __device__ __forceinline__ LocalLayout local_layout(int hd,
                                                            int chunk) {
  LocalLayout L;
  L.P = (hd + 3) & ~3;
  L.NR = (chunk + 3) & ~3;
  L.sp = (L.P % 32) == 0;
  L.sn = (L.NR % 32) == 0;
  const int tile = L.NR * L.P;
  L.rt = 0;
  L.kt = tile;
  L.vv = 2 * tile;
  L.gg = 3 * tile;
  L.X = 4 * tile;
  L.Gp = L.X + L.NR * (L.NR > L.P ? L.NR : L.P);
  L.etot = L.Gp + L.P * L.P;
  L.gv = L.etot + L.P;
  L.bk = L.gv + L.NR;
  L.su = L.bk + L.NR;
  L.z = L.su + L.P;
  L.part = L.z + L.P;
  L.total = L.part + 8 * (L.NR > L.P ? L.NR : L.P) + 4 * L.P;
  return L;
}

// Pass B1's shared memory: r~ and g (NR, P), S_in (P, P) swizzled.
__host__ __device__ __forceinline__ int gx_floats(int hd, int chunk) {
  const int P = (hd + 3) & ~3, NR = (chunk + 3) & ~3;
  return 2 * NR * P + P * P;
}

// Pass B1, a block per (row, chunk), from the forward's r~ (rbuf, pitch P;
// columns past hd are not written there and are read as 0), S_in (dbuf)
// and g: gbuf <- r~^T g (P, P) and dr <- g S_in^T (the chunk's rows, the
// part of dr~ that needs no intra-chunk term; pass C adds the rest and
// writes dr over it), a thread per 4 x 4 outputs of each, fmaf chains.
// With vec (then P = hd) the operands come in by 16-byte cp.async.
__global__ void __launch_bounds__(BWD_THREADS)
wkv_bwd_gx_kernel(const float* __restrict__ rbuf,
                  const float* __restrict__ dbuf, const float* __restrict__ g,
                  float* __restrict__ gbuf, float* __restrict__ dr, int S,
                  int hd, int chunk, int nch, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int P = (hd + 3) & ~3, NR = (chunk + 3) & ~3, pq = P >> 2;
  const int sp = (P % 32) == 0;
  float* rt = smem;                   // (NR, P)
  float* gs = smem + NR * P;          // (NR, P)
  float* ss = smem + 2 * NR * P;      // (P, P), swizzled
  const int t = threadIdx.x;
  const int row = blockIdx.x / nch, ch = blockIdx.x - row * nch;
  const int s0 = ch * chunk, n = min(chunk, S - s0);
  const int64_t off = (static_cast<int64_t>(row) * S + s0) * hd;
  const int64_t roff = (static_cast<int64_t>(row) * S + s0) * P;
  const int64_t item = static_cast<int64_t>(row) * nch + ch;
  for (int i = t; i < NR * pq; i += BWD_THREADS) {
    const int a = i / pq, c = 4 * (i - a * pq);
    if (vec && a < n) {             // P = hd: 16-byte cp.async
      const int64_t gi = off + static_cast<int64_t>(a) * hd + c;
      __pipeline_memcpy_async(rt + a * P + c,
                              rbuf + roff + static_cast<int64_t>(a) * P + c,
                              16);
      __pipeline_memcpy_async(gs + a * P + c, g + gi, 16);
      continue;
    }
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y = x;
    if (a < n) {
      x = ld4(rbuf + roff + static_cast<int64_t>(a) * P + c);
      if (c + 3 >= hd) {
        if (c >= hd) x.x = 0.0f;
        if (c + 1 >= hd) x.y = 0.0f;
        if (c + 2 >= hd) x.z = 0.0f;
        x.w = 0.0f;
      }
      const int64_t gi = off + static_cast<int64_t>(a) * hd + c;
      if (vec) {
        y = ld4(g + gi);
      } else {
        if (c < hd) y.x = g[gi];
        if (c + 1 < hd) y.y = g[gi + 1];
        if (c + 2 < hd) y.z = g[gi + 2];
        if (c + 3 < hd) y.w = g[gi + 3];
      }
    }
    *reinterpret_cast<float4*>(rt + a * P + c) = x;
    *reinterpret_cast<float4*>(gs + a * P + c) = y;
  }
  const float* sin_g = dbuf + item * P * P;
  for (int i = t; i < P * pq; i += BWD_THREADS) {
    const int a = i / pq, c = 4 * (i - a * pq);
    if (vec && a < hd) {
      __pipeline_memcpy_async(ss + sidx(a, c, P, sp), sin_g + a * P + c, 16);
      continue;
    }
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a < hd) {
      x = ld4(sin_g + a * P + c);
      if (c + 3 >= hd) {
        if (c >= hd) x.x = 0.0f;
        if (c + 1 >= hd) x.y = 0.0f;
        if (c + 2 >= hd) x.z = 0.0f;
        x.w = 0.0f;
      }
    }
    *reinterpret_cast<float4*>(ss + sidx(a, c, P, sp)) = x;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int r0 = 4 * (t >> 4), c0 = 4 * (t & 15);
  if (r0 < P && c0 < P) {
    float acc[4][4];
    zero4x4(acc);
    mm4<true, false>(acc, rt, P, 0, gs, P, 0, r0, c0, 0, NR);
    float* gb = gbuf + item * P * P;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(gb + (r0 + i) * P + c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (r0 < NR && c0 < P) {
    float acc[4][4];
    zero4x4(acc);
    mm4<false, true>(acc, gs, P, 0, ss, P, sp, r0, c0, 0, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = r0 + i;
      if (a >= n) break;
      const int64_t go = off + static_cast<int64_t>(a) * hd + c0;
      if (vec) {
        *reinterpret_cast<float4*>(dr + go) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (c0 + m < hd) dr[go + m] = acc[i][m];
      }
    }
  }
}

// Pass B2, a thread per (row, state row i < hd, 4 columns): from the last
// chunk to the first, G_out = G, then G = e^{l_tot} G + r~^T g, each G_out
// written over its chunk's r~^T g; SCAN_AHEAD chunks loaded ahead.
__global__ void __launch_bounds__(256)
wkv_bwd_scan_kernel(float* __restrict__ gbuf, const float* __restrict__ lbuf,
                    int64_t BH, int P, int hd, int nch) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int pq = P >> 2;
  const int64_t per_row = static_cast<int64_t>(P) * pq;
  if (idx >= BH * per_row) return;
  const int64_t row = idx / per_row;
  const int iq = static_cast<int>(idx - row * per_row);
  const int i = iq / pq;
  if (i >= hd) return;                     // never read
  const int64_t pp = static_cast<int64_t>(P) * P;
  float4* d = reinterpret_cast<float4*>(gbuf + row * nch * pp) + iq;
  const float* l = lbuf + row * nch * P + i;
  float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = nch - 1; c0 >= 0; c0 -= SCAN_AHEAD) {
    float4 x[SCAN_AHEAD];
    float e[SCAN_AHEAD];
#pragma unroll
    for (int b = 0; b < SCAN_AHEAD; ++b) {
      if (c0 - b >= 0) {
        x[b] = d[(c0 - b) * pp / 4];
        e[b] = l[(c0 - b) * P];
      }
    }
#pragma unroll
    for (int b = 0; b < SCAN_AHEAD; ++b) {
      if (c0 - b < 0) break;
      d[(c0 - b) * pp / 4] = st;
      const float w = expf(e[b]);
      st.x = fmaf(w, st.x, x[b].x);
      st.y = fmaf(w, st.y, x[b].y);
      st.z = fmaf(w, st.z, x[b].z);
      st.w = fmaf(w, st.w, x[b].w);
    }
  }
}

// (BH, S, hd) element (a, c .. c + 3) of a chunk, zero past hd, as a
// float4 (a 16-byte load when vec).
__device__ __forceinline__ float4 ld_row4(const float* p, int64_t gi, int c,
                                          int hd, int vec) {
  if (vec) return ld4(p + gi);
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c < hd) x.x = p[gi];
  if (c + 1 < hd) x.y = p[gi + 1];
  if (c + 2 < hd) x.z = p[gi + 2];
  if (c + 3 < hd) x.w = p[gi + 3];
  return x;
}

__device__ __forceinline__ void st_row4(float* p, int64_t gi, int c, int hd,
                                        int vec, const float (&x)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + gi) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (c + m < hd) p[gi + m] = x[m];
  }
}

// Pass C, a block per (row, chunk): dv, dk, dr, dlw of the chunk's steps
// and its du partial (dpart, (P) per chunk), from the inputs, g S_in^T
// (B1's, in dr), S_out (dbuf's next chunk) and G_out (gbuf). l_exc is kept
// in dlw until dlw is written over it. PC, NC: P and NR when known at
// compile time (64 and 64 on the rwkv6-3b path), else 0. vec: hd % 4 == 0
// and every (BH, S, hd) operand 16-byte aligned.
template <int PC, int NC>
__global__ void __launch_bounds__(BWD_THREADS, 2)
wkv_bwd_local_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u, const float* __restrict__ g,
                     const float* __restrict__ dbuf,
                     const float* __restrict__ gbuf, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dlw, float* __restrict__ dpart,
                     int S, int hd, int chunk, int nch, int vec) {
  extern __shared__ __align__(16) float smem[];
  const LocalLayout L = local_layout(hd, chunk);
  const int P = PC ? PC : L.P, NR = NC ? NC : L.NR;
  const int sp = PC ? (PC % 32 == 0) : L.sp;
  const int sn = NC ? (NC % 32 == 0) : L.sn;
  float* rt = smem + L.rt;
  float* kt = smem + L.kt;
  float* vv = smem + L.vv;
  float* gg = smem + L.gg;
  float* sX = smem + L.X;
  float* Gp = smem + L.Gp;
  float* etot = smem + L.etot;
  float* gvs = smem + L.gv;
  float* bks = smem + L.bk;
  float* su = smem + L.su;
  float* zs = smem + L.z;
  float* part = smem + L.part;
  const int t = threadIdx.x;
  const int row = blockIdx.x / nch, ch = blockIdx.x - row * nch;
  const int s0 = ch * chunk, n = min(chunk, S - s0);
  const int64_t off = (static_cast<int64_t>(row) * S + s0) * hd;
  const int64_t item = static_cast<int64_t>(row) * nch + ch;
  const int64_t pp = static_cast<int64_t>(P) * P;
  const float* gout_g = gbuf + item * pp;
  const float* sout_g = ch + 1 < nch ? dbuf + (item + 1) * pp : nullptr;
  const int pq = P >> 2;

  // 1. r, k, v, g as (NR, P) tiles (r and k into r~'s and k~'s), zero past
  // n and hd; lw into X; G_out (unscaled, into G'), zero past hd; u. With
  // vec (then P = hd) every in-range float4 is a 16-byte cp.async, all in
  // flight at once and none through registers
  for (int i = t; i < NR * pq; i += BWD_THREADS) {
    const int a = i / pq, c = 4 * (i - a * pq);
    const int o = sidx(a, c, P, sp);
    const int64_t gi = off + static_cast<int64_t>(a) * hd + c;
    float* const dst[5] = {rt + o, kt + o, vv + o, gg + o, sX + a * P + c};
    const float* const src[5] = {r, k, v, g, lw};
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      if (vec && a < n) {
        __pipeline_memcpy_async(dst[m], src[m] + gi, 16);
      } else {
        *reinterpret_cast<float4*>(dst[m]) =
            a < n ? ld_row4(src[m], gi, c, hd, vec)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  for (int i = t; i < P * pq; i += BWD_THREADS) {
    const int a = i / pq, c = 4 * (i - a * pq);
    float* const dst = Gp + sidx(a, c, P, sp);
    if (vec && a < hd) {
      __pipeline_memcpy_async(dst, gout_g + a * P + c, 16);
      continue;
    }
    float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (a < hd) {
      y = ld4(gout_g + a * P + c);
      if (c + 3 >= hd) {
        if (c >= hd) y.x = 0.0f;
        if (c + 1 >= hd) y.y = 0.0f;
        if (c + 2 >= hd) y.z = 0.0f;
        y.w = 0.0f;
      }
    }
    *reinterpret_cast<float4*>(dst) = y;
  }
  __pipeline_commit();
  for (int j = t; j < P; j += BWD_THREADS)
    su[j] = j < hd ? u[static_cast<int64_t>(row) * hd + j] : 0.0f;
  __pipeline_wait_prior(0);
  __syncthreads();

  // 2. four threads a step (or state row), each a quarter of the columns,
  // fmaf chains in column order: g . v and sum r u k from the raw r and k,
  // and Z's quarters, sum_j G_out S_out, S_out from device memory (zero at
  // a row's end)
  const int w4 = t >> 2, q4 = t & 3;
  const int qw = (hd + 3) >> 2, j0 = q4 * qw, j1 = min(j0 + qw, hd);
  if (w4 < n) {
    float gv = 0.0f, bk = 0.0f;
    for (int j = j0; j < j1; ++j) {
      const int o = sidx(w4, j, P, sp);
      gv = fmaf(gg[o], vv[o], gv);
      bk = fmaf(rt[o] * su[j], kt[o], bk);
    }
    part[q4 * NR + w4] = gv;
    part[(4 + q4) * NR + w4] = bk;
  }
  if (w4 < hd) {
    float z = 0.0f;
    if (sout_g != nullptr)
      for (int j = j0; j < j1; ++j)
        z = fmaf(Gp[sidx(w4, j, P, sp)], sout_g[w4 * P + j], z);
    part[8 * NR + q4 * P + w4] = z;
  }
  __syncthreads();

  // 3. threads 0-63: the cumulative decays per column in time order (the
  // forward's chain), l_exc into dlw, e^{l_tot}; the others: the quarters
  // added in order
  if (t < 64) {
    const int j = t;
    if (j < hd) {
      float c = 0.0f, w = 0.0f;
      for (int a = 0; a < n; ++a) {
        w = sX[a * P + j];
        c += w;
        dlw[off + static_cast<int64_t>(a) * hd + j] = c - w;
      }
      etot[j] = expf((c - w) + w);
    }
  } else {
    const int x = t - 64;
    if (x < n) {
      gvs[x] = ((part[x] + part[NR + x]) + part[2 * NR + x]) +
               part[3 * NR + x];
      bks[x] = ((part[4 * NR + x] + part[5 * NR + x]) + part[6 * NR + x]) +
               part[7 * NR + x];
    }
    if (x < hd) {
      const float* zp = part + 8 * NR;
      zs[x] = ((zp[x] + zp[P + x]) + zp[2 * P + x]) + zp[3 * P + x];
    }
  }
  __syncthreads();

  // 4. every thread: r~ = r e^{l_exc} and k~ = k e^{-l_inc} in place, with
  // l_exc read back from dlw and l_inc = l_exc + lw (the forward's
  // factors, bit for bit); G' = e^{l_tot} G_out
  for (int x = t; x < n * hd; x += BWD_THREADS) {
    const int a = x / hd, j = x - a * hd;
    const float lexc = dlw[off + static_cast<int64_t>(a) * hd + j];
    const float linc = lexc + sX[a * P + j];
    const int o = sidx(a, j, P, sp);
    rt[o] = rt[o] * expf(lexc);
    kt[o] = kt[o] * expf(-linc);
  }
  for (int x = t; x < hd * P; x += BWD_THREADS) {
    const int i = x / P, j = x - i * P;
    const int o = sidx(i, j, P, sp);
    Gp[o] = etot[i] * Gp[o];
  }
  __syncthreads();

  // thread -> 4 x 4 output tile: tile row w (lanes 0-15) or 15 - w (lanes
  // 16-31) of warp w, tile column lane mod 16, so every warp holds one
  // short and one long row of each triangle
  const int warp = t >> 5, lane = t & 31;
  const int tr = (lane & 16) ? 15 - warp : warp;
  const int r0 = 4 * tr, c0 = 4 * (lane & 15);
  const bool active = r0 < NR && c0 < P;    // a tile of dv, dk, dr

  // 5. A = strict_lower(r~ k~^T) into X, then dv = A^T g + k~ G' + (sum r
  // u k) g, written out; then dA = strict_lower(g v^T) into X
  lower_product(sX, NR, sn, rt, kt, P, sp, t, BWD_THREADS);
  __syncthreads();
  if (active) {
    float acc[4][4];
    zero4x4(acc);
    mm4<true, false>(acc, sX, NR, sn, gg, P, sp, r0, c0, r0, NR);
    mm4<false, false>(acc, kt, P, sp, Gp, P, sp, r0, c0, 0, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = r0 + i;
      if (a >= n) break;
      const float4 g4 = ld4(gg + sidx(a, c0, P, sp));
      const float bk = bks[a];
      const float ov[4] = {acc[i][0] + bk * g4.x, acc[i][1] + bk * g4.y,
                           acc[i][2] + bk * g4.z, acc[i][3] + bk * g4.w};
      st_row4(dv, off + static_cast<int64_t>(a) * hd + c0, c0, hd, vec, ov);
    }
  }
  __syncthreads();
  lower_product(sX, NR, sn, gg, vv, P, sp, t, BWD_THREADS);
  __syncthreads();

  // 6. dk' = e^{-l_inc} (dA^T r~ + v G'^T) and dr' = e^{l_exc} (dA k~ +
  // g S_in^T), written with their bonus terms and kept as x = r dr' and
  // y = k dk' for dlw
  float xr[4][4], yk[4][4];
  zero4x4(xr);
  zero4x4(yk);
  if (active) {
    mm4<true, false>(yk, sX, NR, sn, rt, P, sp, r0, c0, r0, NR);
    mm4<false, true>(yk, vv, P, sp, Gp, P, sp, r0, c0, 0, P);
    mm4<false, false>(xr, sX, NR, sn, kt, P, sp, r0, c0, 0, r0 + 4);
    const float4 u4 = ld4(su + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = r0 + i;
      if (a >= n) break;
      const int64_t gi = off + static_cast<int64_t>(a) * hd + c0;
      const float4 r4 = ld_row4(r, gi, c0, hd, vec);
      const float4 k4 = ld_row4(k, gi, c0, hd, vec);
      const float4 w4v = ld_row4(lw, gi, c0, hd, vec);
      const float4 lx4 = ld_row4(dlw, gi, c0, hd, vec);
      const float4 gs4 = ld_row4(dr, gi, c0, hd, vec);
      const float gv = gvs[a];
      float ok[4], orr[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float lexc = at(lx4, m);
        const float dkp = expf(-(lexc + at(w4v, m))) * yk[i][m];
        const float drp = expf(lexc) * (xr[i][m] + at(gs4, m));
        ok[m] = dkp + at(u4, m) * at(r4, m) * gv;
        orr[m] = drp + at(u4, m) * at(k4, m) * gv;
        yk[i][m] = at(k4, m) * dkp;
        xr[i][m] = at(r4, m) * drp;
      }
      st_row4(dk, gi, c0, hd, vec, ok);
      st_row4(dr, gi, c0, hd, vec, orr);
    }
  }
  __syncthreads();                  // every product has read r~ and k~
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = sidx(r0 + i, c0, P, sp);
      *reinterpret_cast<float4*>(rt + o) =
          make_float4(xr[i][0], xr[i][1], xr[i][2], xr[i][3]);
      *reinterpret_cast<float4*>(kt + o) =
          make_float4(yk[i][0], yk[i][1], yk[i][2], yk[i][3]);
    }
  }
  __syncthreads();

  // 7. dlw_t = Z + sum_{t<s<=e} x_s - sum_{t<=s<=e} y_s, a thread per
  // (column, quarter of the chunk's steps): the quarters' totals, then each
  // quarter's reverse scan from Z plus the later quarters' totals, written
  // over l_exc; du's partial per quarter, then added in quarter order
  const int ci = t & 63, qt = t >> 6, seg = NR >> 2;
  const int a_lo = qt * seg, a_hi = min(a_lo + seg, n);
  float* tot = part;                 // (4, P)
  float* dup = part + 4 * P;         // (4, P)
  if (ci < hd) {
    float tq = 0.0f, dq = 0.0f;
    for (int a = a_lo; a < a_hi; ++a) {
      const int o = sidx(a, ci, P, sp);
      const int64_t gi = off + static_cast<int64_t>(a) * hd + ci;
      tq += rt[o] - kt[o];
      dq = fmaf(r[gi] * k[gi], gvs[a], dq);
    }
    tot[qt * P + ci] = tq;
    dup[qt * P + ci] = dq;
  }
  __syncthreads();
  if (ci < hd) {
    float acc = zs[ci];
    for (int q = 3; q > qt; --q) acc += tot[q * P + ci];
    for (int a = a_hi - 1; a >= a_lo; --a) {
      const int o = sidx(a, ci, P, sp);
      acc -= kt[o];
      dlw[off + static_cast<int64_t>(a) * hd + ci] = acc;
      acc += rt[o];
    }
    if (qt == 0)
      dpart[item * P + ci] = ((dup[ci] + dup[P + ci]) + dup[2 * P + ci]) +
                             dup[3 * P + ci];
  }
}

// Pass D, a thread per (row, column): du = the chunks' partials in chunk
// order.
__global__ void __launch_bounds__(256)
wkv_bwd_du_kernel(const float* __restrict__ dpart, float* __restrict__ du,
                  int64_t BH, int hd, int P, int nch) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= BH * hd) return;
  const int64_t row = idx / hd;
  const int i = static_cast<int>(idx - row * hd);
  const float* p = dpart + row * nch * P + i;
  float acc = 0.0f;
  for (int c = 0; c < nch; ++c) acc += p[static_cast<int64_t>(c) * P];
  du[idx] = acc;
}

template <int PC, int NC>
cudaError_t launch_bwd_local(const float* r, const float* k, const float* v,
                             const float* lw, const float* u, const float* g,
                             const float* dbuf, const float* gbuf, float* dr,
                             float* dk, float* dv, float* dlw, float* dpart,
                             unsigned items, int S, int hd, int chunk,
                             int nch, size_t smem, int vec,
                             cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      wkv_bwd_local_kernel<PC, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  wkv_bwd_local_kernel<PC, NC><<<items, BWD_THREADS, smem, stream>>>(
      r, k, v, lw, u, g, dbuf, gbuf, dr, dk, dv, dlw, dpart, S, hd, chunk,
      nch, vec);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t, or WKV_SMEM_TOO_LARGE (the Python wrapper's
// _SMEM_TOO_LARGE) when one block of hd and chunk needs more shared memory
// than the device gives a block. Checked before the empty-input return, so
// a shape is refused whatever BH and S are.
#define WKV_SMEM_TOO_LARGE (-1)

// The chunk-parallel kernels. rbuf (BH, S, P), dbuf (BH, nch, P, P) and
// lbuf (BH, nch, P) are the caller's scratch, P = hd rounded up to 4 and
// nch = ceil(S / chunk).
extern "C" int wkv_chunked_f32(const void* r, const void* k, const void* v,
                               const void* lw, const void* u, void* out,
                               void* rbuf, void* dbuf, void* lbuf, int BH,
                               int S, int hd, int chunk, void* stream) {
  if (hd <= 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_a = sizeof(float) * static_cast<size_t>(
                                            layout(hd, chunk).total);
  const size_t smem_c = sizeof(float) * static_cast<size_t>(
                                            cross_floats(hd, chunk));
  const size_t limit = static_cast<size_t>(max_smem());
  if (smem_a > limit || smem_c > limit) return WKV_SMEM_TOO_LARGE;
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t nch = (S + chunk - 1) / chunk;
  const int64_t ctiles = ((hd + 3) / 4 * 4 + CROSS_COLS - 1) / CROSS_COLS;
  if (static_cast<int64_t>(BH) * nch * ctiles >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = hd % 4 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(lw) && aligned16(out);
  const auto* fr = static_cast<const float*>(r);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fl = static_cast<const float*>(lw);
  const auto* fu = static_cast<const float*>(u);
  auto* fo = static_cast<float*>(out);
  auto* rb = static_cast<float*>(rbuf);
  auto* db = static_cast<float*>(dbuf);
  auto* lb = static_cast<float*>(lbuf);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      hd == 64 ? launch_all<64>(fr, fk, fv, fl, fu, fo, rb, db, lb, BH, S,
                                hd, chunk, smem_a, smem_c, vec, st)
               : launch_all<0>(fr, fk, fv, fl, fu, fo, rb, db, lb, BH, S,
                               hd, chunk, smem_a, smem_c, vec, st);
  return static_cast<int>(e);
}

extern "C" int wkv_chunked_f32_v1(const void* r, const void* k, const void* v,
                                  const void* lw, const void* u, void* out,
                                  int BH, int S, int hd, int chunk,
                                  void* stream) {
  if (hd <= 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes_v1(hd, chunk);
  if (smem > static_cast<size_t>(max_smem())) return WKV_SMEM_TOO_LARGE;
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv_chunk_kernel_v1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wkv_chunk_kernel_v1<<<static_cast<unsigned>(BH), V1_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(out), S, hd, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The first backward kernel (the sequential recurrence's VJP, a block per
// row): dr, dk, dv, dlw (BH, S, hd) and du (BH, hd) from the forward's
// inputs and the output cotangent g.
// ckpt (BH, ceil(S / seg_len), P, P), P = hd rounded up to 4, is the
// caller's scratch, a checkpoint every seg_len steps. S > 0 and BH > 0
// (the wrapper returns zeros for an empty input), and hd <= BWD_MAX_HD: a
// block holds the whole (hd, hd) state, 16 elements a thread, in at most
// 256 threads. WKV_SMEM_TOO_LARGE when a block of hd and seg_len needs
// more shared memory than the device gives a block.
extern "C" int wkv_chunked_backward_f32_v1(const void* r, const void* k,
                                           const void* v, const void* lw,
                                           const void* u, const void* g,
                                           void* dr, void* dk, void* dv,
                                           void* dlw, void* du, void* ckpt,
                                           int BH, int S, int hd,
                                           int seg_len, void* stream) {
  if (hd <= 0 || hd > BWD_MAX_HD || BH <= 0 || S <= 0 || seg_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdLayout L = bwd_layout(hd, seg_len);
  const size_t smem = sizeof(float) * static_cast<size_t>(L.total);
  if (smem > static_cast<size_t>(max_smem())) return WKV_SMEM_TOO_LARGE;
  const auto* fr = static_cast<const float*>(r);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fl = static_cast<const float*>(lw);
  const auto* fu = static_cast<const float*>(u);
  const auto* fg = static_cast<const float*>(g);
  auto* odr = static_cast<float*>(dr);
  auto* odk = static_cast<float*>(dk);
  auto* odv = static_cast<float*>(dv);
  auto* odl = static_cast<float*>(dlw);
  auto* odu = static_cast<float*>(du);
  auto* ck = static_cast<float*>(ckpt);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned threads = static_cast<unsigned>(L.NQ * L.NQ);
  cudaError_t e;
  if (hd == 64) {
    e = cudaFuncSetAttribute(wkv_bwd_kernel_v1<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    wkv_bwd_kernel_v1<64><<<static_cast<unsigned>(BH), threads, smem, st>>>(
        fr, fk, fv, fl, fu, fg, odr, odk, odv, odl, odu, ck, S, hd, seg_len);
  } else {
    e = cudaFuncSetAttribute(wkv_bwd_kernel_v1<0>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    wkv_bwd_kernel_v1<0><<<static_cast<unsigned>(BH), threads, smem, st>>>(
        fr, fk, fv, fl, fu, fg, odr, odk, odv, odl, odu, ck, S, hd, seg_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chunk-parallel backward: dr, dk, dv, dlw (BH, S, hd) and du (BH, hd)
// from the forward's inputs and the output cotangent g, in chunks of
// `chunk` steps (at most BWD_MAX_CHUNK; hd at most BWD_MAX_HD). rbuf (BH,
// S, P), dbuf (BH, nch, P, P) and lbuf (BH, nch, P) are the forward's
// scratch (wkv_chunked_f32's, same inputs and chunk); gbuf (BH, nch, P, P)
// and dpart (BH, nch, P) are scratch. P = hd rounded up to 4,
// nch = ceil(S / chunk). S > 0 and BH > 0 (the wrapper returns zeros for an
// empty input). WKV_SMEM_TOO_LARGE when a block needs more shared memory
// than the device gives one.
extern "C" int wkv_chunked_backward_f32(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* g, void* dr, void* dk, void* dv, void* dlw,
    void* du, void* rbuf, void* dbuf, void* lbuf, void* gbuf, void* dpart,
    int BH, int S, int hd, int chunk, void* stream) {
  if (hd <= 0 || hd > BWD_MAX_HD || chunk <= 0 || chunk > BWD_MAX_CHUNK ||
      BH <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const LocalLayout L = local_layout(hd, chunk);
  const size_t smem_c = sizeof(float) * static_cast<size_t>(L.total);
  const size_t smem_b = sizeof(float) * static_cast<size_t>(
                                            gx_floats(hd, chunk));
  const size_t limit = static_cast<size_t>(max_smem());
  if (smem_c > limit || smem_b > limit) return WKV_SMEM_TOO_LARGE;
  const int nch = (S + chunk - 1) / chunk;
  if (static_cast<int64_t>(BH) * nch >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned items = static_cast<unsigned>(BH) * nch;
  const int vec = hd % 4 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(lw) && aligned16(g) &&
                  aligned16(dr) && aligned16(dk) && aligned16(dv) &&
                  aligned16(dlw);
  const auto* fr = static_cast<const float*>(r);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fl = static_cast<const float*>(lw);
  const auto* fu = static_cast<const float*>(u);
  const auto* fg = static_cast<const float*>(g);
  auto* odr = static_cast<float*>(dr);
  auto* odk = static_cast<float*>(dk);
  auto* odv = static_cast<float*>(dv);
  auto* odl = static_cast<float*>(dlw);
  const auto* rb = static_cast<const float*>(rbuf);
  const auto* db = static_cast<const float*>(dbuf);
  const auto* lb = static_cast<const float*>(lbuf);
  auto* gb = static_cast<float*>(gbuf);
  auto* dp = static_cast<float*>(dpart);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(wkv_bwd_gx_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_b));
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv_bwd_gx_kernel<<<items, BWD_THREADS, smem_b, st>>>(rb, db, fg, gb, odr,
                                                        S, hd, chunk, nch,
                                                        vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t scan = static_cast<int64_t>(BH) * L.P * (L.P >> 2);
  wkv_bwd_scan_kernel<<<static_cast<unsigned>((scan + 255) / 256), 256, 0,
                        st>>>(gb, lb, BH, L.P, hd, nch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = L.P == 64 && L.NR == 64
          ? launch_bwd_local<64, 64>(fr, fk, fv, fl, fu, fg, db, gb, odr,
                                     odk, odv, odl, dp, items, S, hd, chunk,
                                     nch, smem_c, vec, st)
          : launch_bwd_local<0, 0>(fr, fk, fv, fl, fu, fg, db, gb, odr, odk,
                                   odv, odl, dp, items, S, hd, chunk, nch,
                                   smem_c, vec, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t cols = static_cast<int64_t>(BH) * hd;
  wkv_bwd_du_kernel<<<static_cast<unsigned>((cols + 255) / 256), 256, 0,
                      st>>>(dp, static_cast<float*>(du), BH, hd, L.P, nch);
  return static_cast<int>(cudaGetLastError());
}
