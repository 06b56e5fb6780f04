// topk: per-row top-k under the serving selection contract,
//
//     k rounds of (max over the still-active columns, LOWEST active column
//     among the maxima wins, the winner is deactivated)
//
// i.e. the first k entries of the row in the strict order (value
// descending, position ascending); -inf entries take part and drain in
// position order, and nothing is ever written into the scores.
//
// A round's value is the reference's max over the active columns, in which
// +0.0 wins over -0.0. Ties go to the lowest position, so when a zero at
// position p wins, the active zeros are exactly those at positions >= p:
// a zero-valued output is +0.0 iff the row holds a +0.0 at some position
// >= its winner's, else -0.0. Both kernels below give those bits; the
// indices do not depend on the signs.
//
// Replaces the Pallas TPU kernel repro/kernels/topk.py::topk_scores
// (pallas_call at topk.py:98), which ops.topk_padded and ops.merge_topk
// (repro/kernels/ops.py:150-203) both run.
//
// What bounds it on an H100: memory. The scores are read once from device
// memory (4 bytes per entry); the selection itself is a comparison or two
// per entry. The TPU kernel keeps one 128-row block of whole rows in VMEM;
// a block per row here would leave 124 of 132 SMs idle at B = 8.
//
// topk_stream_f32 (the kernel, k <= STREAM_MAX_K): one pass over the row.
//   * A row is cut into `splits` contiguous spans, one block each (grid
//     (splits, rows)); a block's 8 warps stream its span once, with 16-byte
//     loads from the first 16-byte aligned position (a scalar head and tail
//     around them: a row of 14,541 floats starts unaligned), two loads a
//     thread in flight.
//   * A warp keeps a bar, the k-th best of what it has kept so far: an
//     entry that does not beat it cannot be in the top k and costs one
//     comparison, which almost every entry takes once the bar has risen.
//     The entries that beat it go to the warp's buffer in shared memory (a
//     ballot and a popcount: no atomics). When the buffer fills, the warp
//     flushes it: each lane sorts its share into a list of K (the bucket of
//     k) in registers, and k rounds, each a redux max over the value keys
//     and a redux min over the positions that hold it (no block barrier),
//     pop the k best back to the buffer's front and raise the bar. Lists in
//     registers would cost each lane an insertion whenever any lane of its
//     warp inserts (divergence), at every entry early in a row.
//   * After the span, warp 0 merges the warps' k-lists the same way.
//   * Across blocks: each block writes its span's k-list and the largest
//     position of a +0.0 in its span; the last block of the row to finish
//     (an integer ticket, after a __threadfence; it resets the ticket)
//     merges the spans' lists and writes the row. The order is strict and
//     total (positions are unique), so neither the result nor its bits
//     depend on which block finishes last or on how the buffers filled.
//   * The zero rule: the largest position of a +0.0 in the row, reduced by
//     max over lanes, warps and spans, decides each zero-valued output's
//     sign at the end.
//
// topk_select_f32_v1 (the first kernel; also the kernel for k above
// STREAM_MAX_K): one launch selects the top k_out of every contiguous
// segment of `seg` positions of every row, one block per (segment, row):
//   * the segment is staged into shared memory once (coalesced) when it
//     fits, then scanned once per round;
//   * no "active" mask is kept: since the order is strict, the entries still
//     active after a round are exactly those ordered after that round's
//     winner (v < v_w, or v == v_w and p > p_w), so each round finds the best
//     entry after the previous winner with a warp-shuffle and a block
//     reduction, OR-ing in whether an active +0.0 was seen (the zero rule
//     within the segment);
//   * a segment shorter than k_out fills its remaining slots with
//     (-inf, id -1); they lie at the end of the row, after every real entry,
//     so they are never chosen while k <= C real entries remain.
// The Python wrapper reduces a long row in passes: segments first, then the
// segment winners concatenated in segment order. The two-stage result is
// exact by the argument of the shard merge (repro/serving/kge.py:19-29):
// among equal values a lower position in the concatenation is a lower
// original position. The zero rule holds across passes too: a zero winner
// of the row is preceded by fewer than k positive entries, so every later
// segment holding a +0.0 passes on at least its first zero, which carries
// +0.0 by the segment's own rule.
// Given `ids`, the output id of position p is ids[p] (the merge of per-shard
// winners and the later passes); else it is p.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NONE = 0x7fffffff;

__device__ __forceinline__ bool better(float v, int p, float bv, int bp) {
  return v > bv || (v == bv && p < bp);
}

__device__ __forceinline__ bool is_plus_zero(float v) {
  return __float_as_uint(v) == 0u;
}

// a round's value under the zero rule: `plus` says whether a +0.0 is
// active in the round, i.e. lies at or after the winner's position
__device__ __forceinline__ float rule(float v, bool plus) {
  return v == 0.0f ? (plus ? 0.0f : -0.0f) : v;
}

// ---------------------------------------------------------------------- //
// topk_select_f32_v1: the first kernel
// ---------------------------------------------------------------------- //
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_SEG = 2048;  // segments up to this length are staged

__global__ void __launch_bounds__(THREADS)
topk_select_kernel(const float* __restrict__ vals,
                   const int64_t* __restrict__ ids, int n, int seg,
                   int k_out, float* __restrict__ out_vals,
                   int64_t* __restrict__ out_ids, int64_t out_ld) {
  __shared__ float stage[SMEM_SEG];
  __shared__ float red_v[WARPS];
  __shared__ int red_p[WARPS];
  __shared__ bool red_plus[WARPS];
  __shared__ float win_v;
  __shared__ int win_p;

  const int row = blockIdx.y;
  const int lo = blockIdx.x * seg;
  const int hi = min(n, lo + seg);
  const float* rv = vals + static_cast<int64_t>(row) * n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  const float* src = rv + lo;
  if (seg <= SMEM_SEG) {
    for (int i = t; i < hi - lo; i += THREADS) stage[i] = rv[lo + i];
    __syncthreads();
    src = stage;
  }

  float pv = INFINITY;  // previous winner; (+inf, -1) leaves every entry
  int pp = -1;          // active before the first round
  float* ov = out_vals + row * out_ld + static_cast<int64_t>(blockIdx.x) * k_out;
  int64_t* oi = out_ids + row * out_ld + static_cast<int64_t>(blockIdx.x) * k_out;
  for (int r = 0; r < k_out; ++r) {
    float bv = -INFINITY;
    int bp = NONE;
    bool plus = false;
    if (pp != NONE) {
      for (int i = t; i < hi - lo; i += THREADS) {
        const float v = src[i];
        const int p = lo + i;
        const bool active = v < pv || (v == pv && p > pp);
        if (active && better(v, p, bv, bp)) { bv = v; bp = p; }
        plus |= active && is_plus_zero(v);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, bv, off);
      const int p = __shfl_down_sync(0xffffffffu, bp, off);
      if (better(v, p, bv, bp)) { bv = v; bp = p; }
    }
    plus = __any_sync(0xffffffffu, plus);
    if (lane == 0) { red_v[warp] = bv; red_p[warp] = bp; red_plus[warp] = plus; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < WARPS ? red_v[lane] : -INFINITY;
      bp = lane < WARPS ? red_p[lane] : NONE;
      plus = __any_sync(0xffffffffu, lane < WARPS && red_plus[lane]);
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, bv, off);
        const int p = __shfl_down_sync(0xffffffffu, bp, off);
        if (better(v, p, bv, bp)) { bv = v; bp = p; }
      }
      if (lane == 0) {
        win_v = bv;
        win_p = bp;
        ov[r] = bp == NONE ? -INFINITY : rule(bv, plus);
        oi[r] = bp == NONE ? -1
                : ids ? ids[static_cast<int64_t>(row) * n + bp]
                      : static_cast<int64_t>(bp);
      }
    }
    __syncthreads();
    pv = win_v;
    pp = win_p;
  }
}

// ---------------------------------------------------------------------- //
// topk_stream_f32: the kernel
// ---------------------------------------------------------------------- //
constexpr int ST_THREADS = 256;
constexpr int ST_WARPS = ST_THREADS / 32;
constexpr int ST_UNROLL = 2;   // float4 loads a thread has in flight
constexpr int CAP = 384;       // candidates a warp buffers
// a warp flushes its buffer past FLUSH_AT: one float4 a lane appends at
// most 128 candidates, so the buffer never overflows
constexpr int FLUSH_AT = CAP - 4 * 32;
constexpr unsigned FULL = 0xffffffffu;

// fp32 bits as an unsigned key in value order, -0.0 as +0.0 (they tie)
__device__ __forceinline__ unsigned okey(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_okey(unsigned m) {
  return __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
}

// A lane's best K entries (K: the bucket of k), sorted by the strict order.
// Empty slots hold (-inf, NONE), which any real entry beats. Every index is
// a constant after unrolling, so the list stays in registers: an entry is
// tested against the K-th (a threshold at a runtime index k - 1 would put
// the list in local memory), which keeps K >= k entries, all of them real
// candidates.
template <int K>
struct List {
  float v[K];
  int p[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < K; ++i) { v[i] = -INFINITY; p[i] = NONE; }
  }

  // insert (x, q) if it beats the K-th entry
  __device__ __forceinline__ void offer(float x, int q) {
    if (!better(x, q, v[K - 1], p[K - 1])) return;
    bool below = true;  // (x, q) beats entry i
#pragma unroll
    for (int i = K - 1; i > 0; --i) {
      const bool up = better(x, q, v[i - 1], p[i - 1]);
      if (up) { v[i] = v[i - 1]; p[i] = p[i - 1]; }
      else if (below) { v[i] = x; p[i] = q; }
      below = up;
    }
    if (below) { v[0] = x; p[0] = q; }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i < K - 1; ++i) { v[i] = v[i + 1]; p[i] = p[i + 1]; }
    v[K - 1] = -INFINITY;
    p[K - 1] = NONE;
  }
};

// k rounds over the warp's lists without a barrier: the best head wins (a
// redux max over the value keys, then a redux min over the positions that
// hold it: every lane gets the winner) and its lane pops. Lane 0 writes
// round r's winner to (out_v[r], out_p[r]); (kv, kp) is the last one.
// A winning zero comes out as +0.0: the zero rule sets its sign at the end.
template <int K>
__device__ __forceinline__ void warp_merge(List<K>& L, int k, int lane,
                                           float* out_v, int* out_p,
                                           float& kv, int& kp) {
  for (int r = 0; r < k; ++r) {
    const unsigned key = okey(L.v[0]);
    const unsigned m = __reduce_max_sync(FULL, key);
    const int wp = static_cast<int>(__reduce_min_sync(
        FULL, key == m ? static_cast<unsigned>(L.p[0]) : 0xffffffffu));
    if (wp != NONE && L.p[0] == wp) L.pop();  // positions are unique
    kv = wp == NONE ? -INFINITY : from_okey(m);
    kp = wp;
    if (lane == 0) { out_v[r] = kv; out_p[r] = kp; }
  }
}

struct Shared {
  float bv[ST_WARPS * CAP];  // each warp's candidate buffer
  int bp[ST_WARPS * CAP];
  float rv[32];              // the block's k-list
  int rp[32];
  int plus[ST_WARPS];
  int bplus;                 // the block's largest position of a +0.0
  int last;
};

// A warp's buffer (count entries) down to its k best, at its front, in
// order; (tv, tp) becomes the k-th, the bar a new candidate must clear.
template <int K>
__device__ __forceinline__ void warp_flush(float* bv, int* bp, int& count,
                                           int k, int lane, float& tv,
                                           int& tp) {
  __syncwarp();
  List<K> L;
  L.init();
  for (int i = lane; i < count; i += 32) L.offer(bv[i], bp[i]);
  __syncwarp();
  warp_merge(L, k, lane, bv, bp, tv, tp);
  count = k;
  __syncwarp();
}

// Warp 0 merges the warps' k-lists (warp w's at sh.bv + w * CAP) into
// (sh.rv, sh.rp) and the warps' +0.0 positions into sh.bplus. Starts and
// ends with a barrier.
template <int K>
__device__ __forceinline__ void merge_warps(int k, Shared& sh) {
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (threadIdx.x < 32) {
    List<K> L;
    L.init();
    for (int i = lane; i < ST_WARPS * k; i += 32)
      L.offer(sh.bv[(i / k) * CAP + i % k], sh.bp[(i / k) * CAP + i % k]);
    float kv;
    int kp;
    warp_merge(L, k, lane, sh.rv, sh.rp, kv, kp);
    const int bp = __reduce_max_sync(FULL, lane < ST_WARPS ? sh.plus[lane]
                                                           : -1);
    if (lane == 0) sh.bplus = bp;
  }
  __syncthreads();
}

// the row's output from the block's merged list and +0.0 position
__device__ __forceinline__ void write_row(const Shared& sh, int row, int n,
                                          int k,
                                          const int64_t* __restrict__ ids,
                                          float* __restrict__ out_vals,
                                          int64_t* __restrict__ out_ids) {
  const int t = threadIdx.x;
  if (t < k) {
    const int p = sh.rp[t];
    const int64_t o = static_cast<int64_t>(row) * k + t;
    out_vals[o] = rule(sh.rv[t], sh.bplus >= p);
    out_ids[o] = ids ? ids[static_cast<int64_t>(row) * n + p]
                     : static_cast<int64_t>(p);
  }
}

// The spans' lists of one row (part_v (splits, k), part_p (splits, k + 1),
// the last int of a span its largest +0.0 position), read through L2, into
// the row's output. Up to SMALL_MERGE entries warp 0 merges alone;
// otherwise every lane offers a share to its list, each warp merges its
// lanes' lists, then warp 0 the warps'.
constexpr int SMALL_MERGE = 4 * 32;

template <int K>
__device__ __forceinline__ void merge_spans(
    int row, int n, int k, int splits, const int64_t* __restrict__ ids,
    const float* part_v, const int* part_p, Shared& sh,
    float* __restrict__ out_vals, int64_t* __restrict__ out_ids) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* pv = part_v + static_cast<int64_t>(row) * splits * k;
  const int* pp = part_p + static_cast<int64_t>(row) * splits * (k + 1);
  const bool small = splits * k <= SMALL_MERGE;
  if (small && warp > 0) return;
  const int threads = small ? 32 : ST_THREADS;
  List<K> L;
  L.init();
  int plus = -1;
  for (int i = threadIdx.x; i < splits * k; i += threads) {
    const int s = i / k;
    L.offer(__ldcg(pv + i), __ldcg(pp + i + s));
  }
  for (int s = threadIdx.x; s < splits; s += threads)
    plus = max(plus, __ldcg(pp + s * (k + 1) + k));
  float kv;
  int kp;
  plus = __reduce_max_sync(FULL, plus);
  if (small) {
    warp_merge(L, k, lane, sh.rv, sh.rp, kv, kp);
    if (lane == 0) sh.bplus = plus;
    __syncwarp();
  } else {
    warp_merge(L, k, lane, sh.bv + warp * CAP, sh.bp + warp * CAP, kv, kp);
    if (lane == 0) sh.plus[warp] = plus;
    merge_warps<K>(k, sh);
  }
  write_row(sh, row, n, k, ids, out_vals, out_ids);
}

template <int K>
__global__ void __launch_bounds__(ST_THREADS)
topk_stream_kernel(const float* __restrict__ vals,
                   const int64_t* __restrict__ ids, int n, int k, int splits,
                   float* __restrict__ out_vals,
                   int64_t* __restrict__ out_ids, float* part_v, int* part_p,
                   int* tickets) {
  __shared__ Shared sh;
  const int row = blockIdx.y, split = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int lo = static_cast<int>(static_cast<int64_t>(split) * n / splits);
  const int hi =
      static_cast<int>(static_cast<int64_t>(split + 1) * n / splits);
  const float* rv = vals + static_cast<int64_t>(row) * n;
  const unsigned below_me = (1u << lane) - 1u;

  // Each warp appends the entries that beat its bar (tv, tp), the k-th
  // best of its buffer at its last flush, to its buffer; warp-uniform
  // loops, so every lane takes part in each ballot.
  float* bv = sh.bv + warp * CAP;
  int* bp = sh.bp + warp * CAP;
  int count = 0;
  float tv = -INFINITY;
  int tp = NONE;
  int plus = -1;  // this lane's largest position of a +0.0
  auto push = [&](float x, int q, bool ok) {
    const bool pass = ok && better(x, q, tv, tp);
    const unsigned mask = __ballot_sync(FULL, pass);
    if (pass) {
      const int o = count + __popc(mask & below_me);
      bv[o] = x;
      bp[o] = q;
    }
    count += __popc(mask);
    if (ok && is_plus_zero(x)) plus = max(plus, q);
  };
  auto flush_if_full = [&]() {
    if (count > FLUSH_AT) warp_flush<K>(bv, bp, count, k, lane, tv, tp);
  };

  // a scalar head up to the first 16-byte aligned position, float4s, tail
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(rv + lo) >> 2) & 3);
  const int head = min(hi - lo, (4 - mis) & 3);
  const int a0 = lo + head;
  const int nvec = (hi - a0) >> 2;
  const int tail = a0 + 4 * nvec;
  if (warp == 0) {
    push(lane < head ? rv[lo + lane] : 0.0f, lo + lane, lane < head);
    push(lane < hi - tail ? rv[tail + lane] : 0.0f, tail + lane,
         lane < hi - tail);
  }
  const float4* v4 = reinterpret_cast<const float4*>(rv + a0);
  for (int i0 = 0; i0 < nvec; i0 += ST_UNROLL * ST_THREADS) {
    float4 x[ST_UNROLL];
    bool ok[ST_UNROLL];
#pragma unroll
    for (int u = 0; u < ST_UNROLL; ++u) {
      const int i = i0 + u * ST_THREADS + t;
      ok[u] = i < nvec;
      x[u] = ok[u] ? __ldcs(v4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < ST_UNROLL; ++u) {
      const int q = a0 + 4 * (i0 + u * ST_THREADS + t);
      push(x[u].x, q, ok[u]);
      push(x[u].y, q + 1, ok[u]);
      push(x[u].z, q + 2, ok[u]);
      push(x[u].w, q + 3, ok[u]);
      flush_if_full();
    }
  }
  warp_flush<K>(bv, bp, count, k, lane, tv, tp);
  plus = __reduce_max_sync(FULL, plus);
  if (lane == 0) sh.plus[warp] = plus;
  merge_warps<K>(k, sh);

  if (splits == 1) {
    write_row(sh, row, n, k, ids, out_vals, out_ids);
    return;
  }
  // this span's list; the last block of the row to get here merges
  const int64_t span = static_cast<int64_t>(row) * splits + split;
  if (t < k) {
    part_v[span * k + t] = sh.rv[t];
    part_p[span * (k + 1) + t] = sh.rp[t];
  }
  if (t == 0) part_p[span * (k + 1) + k] = sh.bplus;
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const int ticket = atomicAdd(tickets + row, 1);
    sh.last = ticket == splits - 1;
    if (sh.last) tickets[row] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  merge_spans<K>(row, n, k, splits, ids, part_v, part_p, sh, out_vals,
                 out_ids);
}

template <int K>
cudaError_t launch_stream(const float* vals, const int64_t* ids, int rows,
                          int n, int k, int splits, float* out_vals,
                          int64_t* out_ids, float* part_v, int* part_p,
                          int* tickets, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(rows));
  topk_stream_kernel<K><<<grid, ST_THREADS, 0, stream>>>(
      vals, ids, n, k, splits, out_vals, out_ids, part_v, part_p, tickets);
  return cudaGetLastError();
}

}  // namespace

// The top k (1 <= k <= min(n, 32)) of each row in one pass of `splits`
// blocks a row (1 <= splits <= n). part_v holds rows * splits * k floats,
// part_p rows * splits * (k + 1) ints; tickets holds rows ints, zero on
// entry and left zero.
extern "C" int topk_stream_f32(const void* vals, const void* ids, int rows,
                               int n, int k, int splits, void* out_vals,
                               void* out_ids, void* part_v,
                               void* part_p, void* tickets, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0)
    return static_cast<int>(cudaGetLastError());
  if (k > n || k > 32 || splits < 1 || splits > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const float*>(vals);
  const auto* id = static_cast<const int64_t*>(ids);
  auto* ov = static_cast<float*>(out_vals);
  auto* oi = static_cast<int64_t*>(out_ids);
  auto* pv = static_cast<float*>(part_v);
  auto* pp = static_cast<int*>(part_p);
  auto* tk = static_cast<int*>(tickets);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k <= 4)
    e = launch_stream<4>(v, id, rows, n, k, splits, ov, oi, pv, pp, tk, s);
  else if (k <= 8)
    e = launch_stream<8>(v, id, rows, n, k, splits, ov, oi, pv, pp, tk, s);
  else if (k <= 12)
    e = launch_stream<12>(v, id, rows, n, k, splits, ov, oi, pv, pp, tk, s);
  else if (k <= 16)
    e = launch_stream<16>(v, id, rows, n, k, splits, ov, oi, pv, pp, tk, s);
  else if (k <= 24)
    e = launch_stream<24>(v, id, rows, n, k, splits, ov, oi, pv, pp, tk, s);
  else
    e = launch_stream<32>(v, id, rows, n, k, splits, ov, oi, pv, pp, tk, s);
  return static_cast<int>(e);
}

// The first kernel: the top k_out of each `seg`-position segment of each
// row, (rows, nseg * k_out) values and ids.
extern "C" int topk_select_f32_v1(const void* vals, const void* ids,
                                  int rows, int n, int seg, int k_out,
                                  void* out_vals, void* out_ids,
                                  void* stream) {
  if (rows <= 0 || n <= 0 || k_out <= 0)
    return static_cast<int>(cudaGetLastError());
  const int nseg = (n + seg - 1) / seg;
  const dim3 grid(static_cast<unsigned>(nseg), static_cast<unsigned>(rows));
  topk_select_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int64_t*>(ids), n,
      seg, k_out, static_cast<float*>(out_vals),
      static_cast<int64_t*>(out_ids), static_cast<int64_t>(nseg) * k_out);
  return static_cast<int>(cudaGetLastError());
}
