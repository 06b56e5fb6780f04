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
// CHUNK sorted rows. Pass 1 gives each chunk one warp: the lanes own
// columns, and each lane adds the chunk's rows in ascending sorted order. A
// segment of one chunk is then complete and is written to out; a longer one
// writes one partial row per chunk. Pass 2 gives each segment one block,
// writes the degree if asked, zeroes an empty segment, and adds a long
// segment's partial rows: COMBINE_WARPS warps each add a contiguous run of
// them in chunk order, then the run sums are added in run order. Chunks and
// runs keep a hub segment (tens of thousands of rows) from serialising on
// one warp. The chunking depends only on each segment's row count, so the
// sum of a segment depends only on which rows it holds and in what order.
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

}  // namespace
}  // namespace segsum
