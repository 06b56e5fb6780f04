// wkv_chunk: chunked RWKV-6 WKV, the time-mix core of every RWKV layer's
// prefill. Per row of the (BH, S, hd) inputs and per chunk of `chunk` steps,
// with the log decays lw cumulated along time inside the chunk, per column:
//
//     l_exc = cumsum(lw) - lw,  l_inc = l_exc + lw,  l_tot = l_inc[last]
//     out   = strict_lower((r e^{l_exc}) (k e^{-l_inc})^T) v
//             + (sum_d r u k) v + (r e^{l_exc}) S_in
//     S_out = e^{l_tot} . S_in + (k e^{l_tot - l_inc})^T v
//
// with the (hd, hd) state S zero at the row's first chunk.
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
