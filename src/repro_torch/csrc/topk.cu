// topk: per-row top-k under the serving selection contract,
//
//     k rounds of (max over the still-active columns, LOWEST active column
//     among the maxima wins, the winner is deactivated)
//
// i.e. the first k entries of the row in the strict order (value
// descending, position ascending); -inf entries take part and drain in
// position order, and nothing is ever written into the scores.
//
// Replaces the Pallas TPU kernel repro/kernels/topk.py::topk_scores
// (pallas_call at topk.py:98), which ops.topk_padded and ops.merge_topk
// (repro/kernels/ops.py:150-203) both run.
//
// What bounds it on an H100: memory. The scores are read once from device
// memory (4 bytes per entry); the selection itself is a few comparisons per
// entry and round. The TPU kernel keeps one 128-row block of whole rows in
// VMEM; a block per row here would leave 124 of 132 SMs idle at B = 8.
//
// Design: one launch selects the top k_out of every contiguous segment of
// `seg` positions of every row, one block per (segment, row):
//   * the segment is staged into shared memory once (coalesced) when it
//     fits, then scanned once per round;
//   * no "active" mask is kept: since the order is strict, the entries still
//     active after a round are exactly those ordered after that round's
//     winner (v < v_w, or v == v_w and p > p_w), so each round finds the best
//     entry after the previous winner with a warp-shuffle and a block
//     reduction;
//   * a segment shorter than k_out fills its remaining slots with
//     (-inf, id -1); they lie at the end of the row, after every real entry,
//     so they are never chosen while k <= C real entries remain.
// The Python wrapper reduces a long row in passes: segments first, then the
// segment winners concatenated in segment order. The two-stage result is
// exact by the argument of the shard merge (repro/serving/kge.py:19-29):
// among equal values a lower position in the concatenation is a lower
// original position. Given `ids`, the output id of position p is ids[p]
// (the merge of per-shard winners and the later passes); else it is p.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_SEG = 2048;  // segments up to this length are staged
constexpr int NONE = 0x7fffffff;

__device__ __forceinline__ bool better(float v, int p, float bv, int bp) {
  return v > bv || (v == bv && p < bp);
}

__global__ void __launch_bounds__(THREADS)
topk_select_kernel(const float* __restrict__ vals,
                   const int64_t* __restrict__ ids, int n, int seg,
                   int k_out, float* __restrict__ out_vals,
                   int64_t* __restrict__ out_ids, int64_t out_ld) {
  __shared__ float stage[SMEM_SEG];
  __shared__ float red_v[WARPS];
  __shared__ int red_p[WARPS];
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
    if (pp != NONE) {
      for (int i = t; i < hi - lo; i += THREADS) {
        const float v = src[i];
        const int p = lo + i;
        const bool active = v < pv || (v == pv && p > pp);
        if (active && better(v, p, bv, bp)) { bv = v; bp = p; }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, bv, off);
      const int p = __shfl_down_sync(0xffffffffu, bp, off);
      if (better(v, p, bv, bp)) { bv = v; bp = p; }
    }
    if (lane == 0) { red_v[warp] = bv; red_p[warp] = bp; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < WARPS ? red_v[lane] : -INFINITY;
      bp = lane < WARPS ? red_p[lane] : NONE;
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, bv, off);
        const int p = __shfl_down_sync(0xffffffffu, bp, off);
        if (better(v, p, bv, bp)) { bv = v; bp = p; }
      }
      if (lane == 0) {
        win_v = bv;
        win_p = bp;
        ov[r] = bp == NONE ? -INFINITY : bv;
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

}  // namespace

extern "C" int topk_select_f32(const void* vals, const void* ids, int rows,
                               int n, int seg, int k_out, void* out_vals,
                               void* out_ids, void* stream) {
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
