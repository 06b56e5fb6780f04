// segment_sum.cuh: the deterministic segmented row sum shared by two kernels,
//
//     out[v] = sum over the sorted rows e of segment v of src[e]
//
// in a fixed order set by the data alone, without float atomics, so two runs
// give the same bits. rgcn_message.cu uses it as the RGCN segment sum (with
// the degree count); sharded_gather.cu as scatter_add_onehot, the transpose
// of a row gather (no degree).
//
// The caller sorts the rows stably by segment (rows that belong to no
// segment go last, under a sentinel key) and passes the permutation, the
// segment offsets, and a chunk list that cuts every segment into chunks of
// CHUNK sorted rows. Every sum below is, per column: each chunk's rows added
// in ascending sorted order from 0.0f; a segment of one chunk is that sum; a
// longer segment's chunk sums are cut into COMBINE_WARPS runs of
// ceil(chunks / COMBINE_WARPS), each run added in chunk order from 0.0f,
// and the run sums added in run order, empty runs included (adding an empty
// run's +0.0 turns a -0.0 into +0.0); an empty segment is 0. Chunks and
// runs keep a hub segment (tens of thousands of rows) from serialising on
// one warp. The chunking depends only on each segment's row count, so the
// sum of a segment depends only on which rows it holds and in what order.
//
// Two implementations of that order give the same bits:
//
// launch (the first passes: segment_sum_f32_v1 and scatter_add_f32_v1,
// each kept as its kernel's bitwise yardstick): pass 1 gives each chunk one
// warp, found by a binary search of chunk_ptr, whose lanes own columns (one
// column pass of 32 at a time); a segment of one chunk is written to out, a
// longer one writes one partial row per chunk. Pass 2 gives each segment
// one block, writes the degree if asked, zeroes an empty segment, and adds
// a long segment's partial rows: COMBINE_WARPS warps each add a run, then
// warp 0 adds the run sums.
//
// launch_scatter (scatter_add_f32, and segment_sum_f32 with the degree):
// pass 1 gives each chunk a warp (as
// launch does; a grid that walked the chunks with fewer warps measured no
// faster), which finds its chunk's segment by a 32-ary search of chunk_ptr
// (3 dependent loads at 17,200 segments where a binary search takes 15);
// evict-first loads keep the once-read rows out of L2's way; a lane owns up
// to 4 columns at once, so one shuffled row id feeds up to 4 loads, and
// 16-32 loads a lane are in flight before it adds. Pass 2a gives each
// segment a warp in small blocks: a one-chunk segment costs two loads, an
// empty one is zeroed, and one of at most WARP_COMBINE_MAX chunks is
// combined in registers, its partial rows loaded Batch<NC>::rows ahead
// across the runs' boundaries. Pass 2b gives the rare longer segments (a
// hub) blocks of COMBINE_WARPS warps, through a list pass 2a makes, one run
// a warp, the run's rows prefetched into L2. Where asked, pass 2a's warp
// writes its segment's degree (its row count) before anything else, so
// every segment gets one: empty, one-chunk and listed ones alike.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// internal linkage: each library that includes this has its own copy
namespace segsum {
namespace {

constexpr int CHUNK = 32;          // sorted rows per chunk (= warp)
constexpr int SEG_WARPS = 8;       // warps per pass-1 block
constexpr int COMBINE_WARPS = 16;  // warps per segment in pass 2

// pass 1: one warp per chunk
__global__ void __launch_bounds__(SEG_WARPS * 32)
chunk_kernel(const float* __restrict__ src, const int64_t* __restrict__ perm,
             const int64_t* __restrict__ offsets,
             const int64_t* __restrict__ chunk_ptr, float* __restrict__ out,
             float* __restrict__ partial, int V, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * SEG_WARPS +
                    (threadIdx.x >> 5);
  if (c >= chunk_ptr[V]) return;
  // the segment holding chunk c: the last v with chunk_ptr[v] <= c
  int lo = 0, hi = V - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk_ptr[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int v = lo;
  const int64_t start = offsets[v] + (c - chunk_ptr[v]) * CHUNK;
  const int64_t stop = offsets[v + 1];
  const int n = static_cast<int>(stop - start < CHUNK ? stop - start : CHUNK);
  const int64_t mine = lane < n ? perm[start + lane] : 0;
  float* row = (chunk_ptr[v + 1] - chunk_ptr[v] == 1)
                   ? out + static_cast<int64_t>(v) * d
                   : partial + c * d;
  for (int col = lane; col - lane < d; col += 32) {
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const int64_t e = __shfl_sync(0xffffffffu, mine, j);
      if (col < d) acc += src[e * d + col];
    }
    if (col < d) row[col] = acc;
  }
}

// pass 2: one block per segment. A segment of several chunks is cut into
// COMBINE_WARPS contiguous runs of chunk rows; each warp adds its run in
// chunk order, then warp 0 adds the runs' sums in run order. The split
// depends only on the segment's chunk count, so the sum order is fixed.
// `deg` may be null (no degree output).
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
combine_kernel(const float* __restrict__ partial,
               const int64_t* __restrict__ offsets,
               const int64_t* __restrict__ chunk_ptr, float* __restrict__ out,
               float* __restrict__ deg, int d) {
  extern __shared__ float runs[];  // (COMBINE_WARPS, d)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v = blockIdx.x;
  if (deg != nullptr && threadIdx.x == 0)
    deg[v] = static_cast<float>(offsets[v + 1] - offsets[v]);
  const int64_t c0 = chunk_ptr[v], c1 = chunk_ptr[v + 1];
  if (c1 - c0 == 1) return;  // pass 1 wrote the whole segment
  float* row = out + static_cast<int64_t>(v) * d;
  if (c1 == c0) {            // empty segment
    for (int col = threadIdx.x; col < d; col += blockDim.x) row[col] = 0.0f;
    return;
  }
  const int64_t per = (c1 - c0 + COMBINE_WARPS - 1) / COMBINE_WARPS;
  const int64_t lo = c0 + warp * per;
  const int64_t hi = lo + per < c1 ? lo + per : c1;
  for (int col = lane; col < d; col += 32) {
    float acc = 0.0f;
#pragma unroll 8
    for (int64_t c = lo; c < hi; ++c) acc += partial[c * d + col];
    runs[warp * d + col] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    for (int col = lane; col < d; col += 32) {
      float acc = runs[col];
      for (int w = 1; w < COMBINE_WARPS; ++w) acc += runs[w * d + col];
      row[col] = acc;
    }
  }
}

// Both passes on `stream`. `max_chunks` bounds chunk_ptr[V] (the caller
// passes E / CHUNK + V); the partial buffer holds max_chunks rows of d.
cudaError_t launch(const float* src, const int64_t* perm,
                   const int64_t* offsets, const int64_t* chunk_ptr,
                   float* out, float* deg, float* partial, int V, int d,
                   int64_t max_chunks, cudaStream_t stream) {
  if (V <= 0) return cudaGetLastError();
  if (max_chunks > 0) {
    const unsigned blocks =
        static_cast<unsigned>((max_chunks + SEG_WARPS - 1) / SEG_WARPS);
    chunk_kernel<<<blocks, SEG_WARPS * 32, 0, stream>>>(
        src, perm, offsets, chunk_ptr, out, partial, V, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const size_t smem = sizeof(float) * COMBINE_WARPS * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  combine_kernel<<<static_cast<unsigned>(V), COMBINE_WARPS * 32, smem,
                   stream>>>(partial, offsets, chunk_ptr, out, deg, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------- //
// launch_scatter: the scatter-add's passes (the degree where asked)
// ---------------------------------------------------------------------- //
constexpr int SC_WARPS = 8;            // warps per pass-1 block
// rows a lane loads before it adds them, at NC columns a lane: 16 to 32
// loads in flight, in batches that divide a chunk of 32
template <int NC>
struct Batch {
  static constexpr int rows = NC <= 2 ? 16 : 8;
};
constexpr int SHORT_WARPS = 4;         // warps per pass-2a block
constexpr int LONG_BLOCKS = 132;       // pass-2b blocks, at most
constexpr int WARP_COMBINE_MAX = 64;   // chunks one warp combines alone

// The segment holding chunk c, for c < chunk_ptr[V]: the last v in [0, V)
// with chunk_ptr[v] <= c. Each round the 32 lanes probe 32 evenly spaced
// segments and a ballot keeps the one gap that holds c.
__device__ __forceinline__ int find_segment(const int64_t* chunk_ptr, int V,
                                            int64_t c, int lane) {
  int64_t lo = 0, hi = V;  // chunk_ptr[lo] <= c < chunk_ptr[hi]
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + (lane + 1) * step;
    const bool le = p < hi && chunk_ptr[p] <= c;
    const int k = __popc(__ballot_sync(0xffffffffu, le));
    hi = lo + (k + 1) * step < hi ? lo + (k + 1) * step : hi;
    lo += k * step;
  }
  return static_cast<int>(lo);
}

// The sum from 0.0f, in order, of rows lo .. hi-1 of a (rows, d) array at
// columns col0 + lane + 32 i (i < NC; 0 past d), Batch<NC>::rows rows
// loaded at once before they are added. The last, short batch loads +0.0
// past hi: adding +0.0 to a sum that began at +0.0 never changes its bits
// (only -0.0 + +0.0 would, and such a sum is never -0.0; a NaN sum is
// already the canonical NaN).
template <int NC>
__device__ __forceinline__ void sum_rows(const float* __restrict__ a,
                                         int64_t lo, int64_t hi, int d,
                                         int col0, int lane, float* acc) {
  constexpr int B = Batch<NC>::rows;
  bool ok[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    acc[i] = 0.0f;
    ok[i] = col0 + lane + 32 * i < d;
  }
  const float* p = a + lo * d + col0 + lane;
  int64_t c = lo;
  for (; c + B <= hi; c += B, p += B * d) {
    float x[B][NC];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int i = 0; i < NC; ++i)
        x[b][i] = ok[i] ? p[b * d + 32 * i] : 0.0f;
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] += x[b][i];
  }
  if (c < hi) {  // the rest as one batch, +0.0 past hi
    float x[B][NC];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int i = 0; i < NC; ++i)
        x[b][i] = ok[i] && c + b < hi ? p[b * d + 32 * i] : 0.0f;
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] += x[b][i];
  }
}

// A segment's sum from its chunk partial rows c0 .. c1-1 (c1 - c0 > 1) in
// one warp, in launch's order: runs of `per` chunks, each summed from 0.0f,
// the run sums added in run order, then the empty runs' +0.0 (one add of
// +0.0 does what several do). The loads run Batch<NC>::rows rows ahead
// across the runs' boundaries.
template <int NC>
__device__ __forceinline__ void combine_rows(const float* __restrict__ a,
                                             int64_t c0, int64_t c1, int d,
                                             int col0, int lane,
                                             float* total) {
  constexpr int B = Batch<NC>::rows;
  const int64_t per = (c1 - c0 + COMBINE_WARPS - 1) / COMBINE_WARPS;
  bool ok[NC];
  float run[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    total[i] = 0.0f;
    run[i] = 0.0f;
    ok[i] = col0 + lane + 32 * i < d;
  }
  int runs = 0;
  int64_t run_end = c0 + per;
  const float* p = a + c0 * d + col0 + lane;
  for (int64_t c = c0; c < c1; c += B, p += B * d) {
    float x[B][NC];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int i = 0; i < NC; ++i)
        x[b][i] = ok[i] && c + b < c1 ? p[b * d + 32 * i] : 0.0f;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (c + b >= c1) break;
#pragma unroll
      for (int i = 0; i < NC; ++i) run[i] += x[b][i];
      if (c + b + 1 == run_end || c + b + 1 == c1) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          total[i] = runs == 0 ? run[i] : total[i] + run[i];
          run[i] = 0.0f;
        }
        ++runs;
        run_end += per;
      }
    }
  }
  if (runs < COMBINE_WARPS)
#pragma unroll
    for (int i = 0; i < NC; ++i) total[i] += 0.0f;
}

// pass 1: chunk c's sum into out (a one-chunk segment) or partial[c]. NC:
// columns a lane owns per pass (columns lane + 32 i), NC * 32 per pass.
template <int NC>
__global__ void __launch_bounds__(SC_WARPS * 32)
scatter_chunk_kernel(const float* __restrict__ src,
                     const int64_t* __restrict__ perm,
                     const int64_t* __restrict__ offsets,
                     const int64_t* __restrict__ chunk_ptr,
                     float* __restrict__ out, float* __restrict__ partial,
                     int64_t* __restrict__ long_rows, int V, int d) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) long_rows[0] = 0;  // for pass 2a
  const int64_t c =
      static_cast<int64_t>(blockIdx.x) * SC_WARPS + (threadIdx.x >> 5);
  if (c >= chunk_ptr[V]) return;  // the whole warp
  const int v = find_segment(chunk_ptr, V, c, lane);
  const int64_t c0 = chunk_ptr[v];
  const int64_t start = offsets[v] + (c - c0) * CHUNK;
  const int64_t stop = offsets[v + 1];
  const int n = static_cast<int>(stop - start < CHUNK ? stop - start
                                                      : CHUNK);
  const int64_t mine = lane < n ? perm[start + lane] : 0;
  float* row = (chunk_ptr[v + 1] - c0 == 1)
                   ? out + static_cast<int64_t>(v) * d
                   : partial + c * d;
  bool ok[NC];
  for (int col0 = 0; col0 < d; col0 += 32 * NC) {
    float acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[i] = 0.0f;
      ok[i] = col0 + lane + 32 * i < d;
    }
    // g is read once: evict-first loads (__ldcs), so that the stream
    // does not push the partial rows pass 2 reads out of L2
    const float* s = src + col0 + lane;
    constexpr int B = Batch<NC>::rows;
    int j = 0;
    for (; j + B <= n; j += B) {
      float x[B][NC];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float* e = s + __shfl_sync(0xffffffffu, mine, j + b) * d;
#pragma unroll
        for (int i = 0; i < NC; ++i)
          x[b][i] = ok[i] ? __ldcs(e + 32 * i) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] += x[b][i];
    }
    if (j < n) {  // the rest as one batch, +0.0 past n: see sum_rows
      float x[B][NC];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float* e = s + __shfl_sync(0xffffffffu, mine, j + b) * d;
#pragma unroll
        for (int i = 0; i < NC; ++i)
          x[b][i] = ok[i] && j + b < n ? __ldcs(e + 32 * i) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] += x[b][i];
    }
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (ok[i]) row[col0 + lane + 32 * i] = acc[i];
  }
}

// pass 2a: a warp per segment: write its degree (deg may be null), zero an
// empty one, combine one of 2 to WARP_COMBINE_MAX chunks in registers (a
// one-chunk segment is done), and list a longer one in long_rows
// (long_rows[0]: how many)
template <int NC>
__global__ void __launch_bounds__(SHORT_WARPS * 32, 8)
scatter_short_kernel(const float* __restrict__ partial,
                     const int64_t* __restrict__ offsets,
                     const int64_t* __restrict__ chunk_ptr,
                     float* __restrict__ out, float* __restrict__ deg,
                     unsigned long long* __restrict__ long_rows, int V,
                     int d) {
  const int lane = threadIdx.x & 31;
  const int64_t v =
      static_cast<int64_t>(blockIdx.x) * SHORT_WARPS + (threadIdx.x >> 5);
  if (v >= V) return;
  if (deg != nullptr && lane == 0)
    deg[v] = static_cast<float>(offsets[v + 1] - offsets[v]);
  const int64_t c0 = chunk_ptr[v], c1 = chunk_ptr[v + 1];
  if (c1 - c0 > WARP_COMBINE_MAX) {  // listed for pass 2b, in any order
    if (lane == 0) long_rows[1 + atomicAdd(long_rows, 1ull)] = v;
    return;
  }
  if (c1 - c0 == 1) return;
  float* row = out + v * d;
  if (c1 == c0) {
    for (int col = lane; col < d; col += 32) row[col] = 0.0f;
    return;
  }
  for (int col0 = 0; col0 < d; col0 += 32 * NC) {
    float total[NC];
    combine_rows<NC>(partial, c0, c1, d, col0, lane, total);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (col0 + lane + 32 * i < d) row[col0 + lane + 32 * i] = total[i];
  }
}

// pass 2b: each block takes the listed long segments (more than
// WARP_COMBINE_MAX chunks: few, a hub among them) blockIdx.x, + gridDim.x,
// ...; for each, every warp adds a run, then warp 0 adds the runs in order.
// Which block takes a segment does not change its bits.
template <int NC>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
scatter_long_kernel(const float* __restrict__ partial,
                    const int64_t* __restrict__ chunk_ptr,
                    float* __restrict__ out,
                    const int64_t* __restrict__ long_rows, int d) {
  extern __shared__ float runs[];  // (COMBINE_WARPS, d)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t count = long_rows[0];
  for (int64_t k = blockIdx.x; k < count; k += gridDim.x) {
    const int64_t v = long_rows[1 + k];
    const int64_t c0 = chunk_ptr[v], c1 = chunk_ptr[v + 1];
    const int64_t per = (c1 - c0 + COMBINE_WARPS - 1) / COMBINE_WARPS;
    const int64_t lo = c0 + warp * per;
    const int64_t hi = lo + per < c1 ? lo + per : c1;
    // the run's rows into L2 first: the walk below has Batch<NC>::rows
    // rows in flight, and a hub's run is hundreds of rows long
    for (int64_t q = lane * 32; q < (hi - lo) * d; q += 32 * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(partial + lo * d + q));
    for (int col0 = 0; col0 < d; col0 += 32 * NC) {
      float acc[NC];
      sum_rows<NC>(partial, lo, hi, d, col0, lane, acc);
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (col0 + lane + 32 * i < d)
          runs[warp * d + col0 + lane + 32 * i] = acc[i];
    }
    __syncthreads();
    if (warp == 0) {
      float* row = out + v * d;
      for (int col = lane; col < d; col += 32) {
        float acc = runs[col];
        for (int w = 1; w < COMBINE_WARPS; ++w) acc += runs[w * d + col];
        row[col] = acc;
      }
    }
    __syncthreads();
  }
}

template <int NC>
cudaError_t launch_scatter_nc(const float* src, const int64_t* perm,
                              const int64_t* offsets,
                              const int64_t* chunk_ptr, float* out,
                              float* deg, float* partial, int64_t* long_rows,
                              int V, int d, int64_t max_chunks,
                              cudaStream_t stream) {
  if (max_chunks > 0) {
    scatter_chunk_kernel<NC>
        <<<static_cast<unsigned>((max_chunks + SC_WARPS - 1) / SC_WARPS),
           SC_WARPS * 32, 0, stream>>>(src, perm, offsets, chunk_ptr, out,
                                       partial, long_rows, V, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  scatter_short_kernel<NC>
      <<<static_cast<unsigned>((V + SHORT_WARPS - 1) / SHORT_WARPS),
         SHORT_WARPS * 32, 0, stream>>>(
          partial, offsets, chunk_ptr, out, deg,
          reinterpret_cast<unsigned long long*>(long_rows), V, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || max_chunks <= WARP_COMBINE_MAX) return e;
  const size_t smem = sizeof(float) * COMBINE_WARPS * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(scatter_long_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // at most max_chunks / (WARP_COMBINE_MAX + 1) segments are long
  const int64_t most = max_chunks / (WARP_COMBINE_MAX + 1);
  scatter_long_kernel<NC>
      <<<static_cast<unsigned>(most < LONG_BLOCKS ? most : LONG_BLOCKS),
         COMBINE_WARPS * 32, smem, stream>>>(partial, chunk_ptr, out,
                                             long_rows, d);
  return cudaGetLastError();
}

// The passes on `stream`, the order and the degree (deg may be null) as
// launch's: `max_chunks` bounds chunk_ptr[V], the partial buffer holds
// max_chunks rows of d, and long_rows holds V + 1 int64s.
cudaError_t launch_scatter(const float* src, const int64_t* perm,
                           const int64_t* offsets, const int64_t* chunk_ptr,
                           float* out, float* deg, float* partial,
                           int64_t* long_rows, int V, int d,
                           int64_t max_chunks, cudaStream_t stream) {
  if (V <= 0) return cudaGetLastError();
  if (d <= 32)
    return launch_scatter_nc<1>(src, perm, offsets, chunk_ptr, out, deg,
                                partial, long_rows, V, d, max_chunks,
                                stream);
  if (d <= 64)
    return launch_scatter_nc<2>(src, perm, offsets, chunk_ptr, out, deg,
                                partial, long_rows, V, d, max_chunks,
                                stream);
  if (d <= 96)
    return launch_scatter_nc<3>(src, perm, offsets, chunk_ptr, out, deg,
                                partial, long_rows, V, d, max_chunks,
                                stream);
  return launch_scatter_nc<4>(src, perm, offsets, chunk_ptr, out, deg,
                              partial, long_rows, V, d, max_chunks, stream);
}

}  // namespace
}  // namespace segsum
