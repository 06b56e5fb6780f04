// The sharded entity table's row exchange, forward and backward.
//
// 1. fused_gather: the row exchange collapsed into one masked row gather,
//
//     out[v] = owned[v] ? table[flat[v]] : 0
//
// where flat[v] is the slot's global row in the stacked (S * rows, d) table
// (ops.flat_gather_plan) and owned[v] says whether any shard owns the slot.
//
// Replaces the Pallas TPU kernel repro/kernels/sharded_gather.py::
// fused_gather (pallas_call at sharded_gather.py:87).
//
// What bounds it on an H100: at serving sizes (a batch of 8 to 64 head rows
// of 75 floats) the bytes are a few KB, so the launch itself is the cost. A
// row is a plain copy, so the output is bitwise the table row (or +0.0).
//
// Design: one block per output row; its threads copy the row's d floats
// with consecutive threads on consecutive addresses. An unowned slot never
// reads the table. A slot whose flat id lies outside the table is a broken
// plan (the host plan never produces one; the plain version raises an
// index error on it): the kernel writes zeros for it instead of reading out
// of bounds, and stores the slot (plus one) in a flag in pinned host
// memory. The serving wrapper reads it after every gather and raises; the
// training path reads it once per step, after the loss.
//
// 2. fused_dequant_gather: the int8 table's twin of fused_gather,
//
//     out[v] = owned[v] ? (float)codes[flat[v]][j] * scales[flat[v]] : 0
//
// Replaces the Pallas TPU kernel repro/kernels/sharded_gather.py::
// fused_dequant_gather (pallas_call at sharded_gather.py:136).
//
// What bounds it on an H100: bytes. A slot reads d int8 codes, one fp32
// scale and its id, and writes 4 d bytes: at the mini-batch shape (17,200
// slots, d = 75) about 6.7 MB, 2 us at 3.35 TB/s. Serving batches (8 to 64
// heads) are launch-bound.
//
// Design: fused_gather's, one block per output row with consecutive
// threads on consecutive columns. The row's scale is read once; codes are
// read as bytes (a d = 75 row is not 4-byte aligned). The product is
// __fmul_rn, which no contraction or fast-math flag can change: it is exact
// (an int8 times a power of two, subnormal scales included, since the
// build has no flush-to-zero), so the output is bitwise the plain version
// and the reference's dequantize-then-gather. Unowned slots and the
// bad-slot flag are as in fused_gather.
//
// 3. scatter_add_onehot: the transpose of a row gather,
//
//     out[r] = sum over slots v with flat[v] == r and owned[v] of g[v]
//
// the gradient of the sharded table and of every row gather on the training
// path. Replaces the Pallas TPU kernel repro/kernels/sharded_gather.py::
// scatter_add_onehot (pallas_call at sharded_gather.py:195), whose one-hot
// matmuls stood in for the TPU's missing atomics at O(R*V*d) work.
//
// What bounds it on an H100: bytes. It must read the owned slots' g rows
// (4*V*d) and write out (4*R*d).
//
// Design: no float atomics, so the sum order is fixed by the data alone and
// two runs give the same bits. The caller sorts the slots stably by flat row
// (unowned slots go to a sentinel row past the table, so they cannot shift a
// real row's chunks) and the two passes of segment_sum.cuh add each row's
// slots in slot order, in chunks of 32, then the chunk sums in chunk order.
// A row's sum depends only on which slots hit it and in what order: a dense
// gather and a row-sharded one (whose flat row is the global id under the
// row-block layout) get the same bits, and so do a deduplicated plan and a
// plain one. Rows no owned slot hits, layout padding included, are 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum.cuh"

namespace {

__global__ void fused_gather_kernel(const float* __restrict__ table,
                                    const int64_t* __restrict__ flat,
                                    const uint8_t* __restrict__ owned,
                                    float* __restrict__ out, int64_t rows,
                                    int d, int64_t* __restrict__ bad_slot) {
  const int64_t v = blockIdx.x;
  const int64_t f = flat[v];
  const bool in_table = f >= 0 && f < rows;
  if (!in_table && threadIdx.x == 0) *bad_slot = v + 1;
  const bool take = owned[v] != 0 && in_table;
  float* dst = out + v * d;
  const float* src = table + (take ? f : 0) * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    dst[j] = take ? src[j] : 0.0f;
}

__global__ void fused_dequant_gather_kernel(
    const int8_t* __restrict__ codes, const float* __restrict__ scales,
    const int64_t* __restrict__ flat, const uint8_t* __restrict__ owned,
    float* __restrict__ out, int64_t rows, int d,
    int64_t* __restrict__ bad_slot) {
  const int64_t v = blockIdx.x;
  const int64_t f = flat[v];
  const bool in_table = f >= 0 && f < rows;
  if (!in_table && threadIdx.x == 0) *bad_slot = v + 1;
  float* dst = out + v * d;
  if (owned[v] == 0 || !in_table) {
    for (int j = threadIdx.x; j < d; j += blockDim.x) dst[j] = 0.0f;
    return;
  }
  const float scale = scales[f];
  const int8_t* src = codes + f * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    dst[j] = __fmul_rn(static_cast<float>(src[j]), scale);
}

int row_threads(int d) {
  int threads = ((d + 31) / 32) * 32;
  return threads > 256 ? 256 : threads;
}

}  // namespace

extern "C" int fused_gather_f32(const void* table, const void* flat,
                                const void* owned, void* out, int64_t rows,
                                int64_t v, int d, void* bad_slot_host,
                                void* stream) {
  if (v <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  // bad_slot_host is pinned host memory; the kernel writes it through its
  // mapped device address
  void* bad_slot = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&bad_slot, bad_slot_host, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_gather_kernel<<<static_cast<unsigned>(v), row_threads(d), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int64_t*>(flat),
      static_cast<const uint8_t*>(owned), static_cast<float*>(out), rows, d,
      static_cast<int64_t*>(bad_slot));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_dequant_gather_i8(const void* codes, const void* scales,
                                       const void* flat, const void* owned,
                                       void* out, int64_t rows, int64_t v,
                                       int d, void* bad_slot_host,
                                       void* stream) {
  if (v <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  void* bad_slot = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&bad_slot, bad_slot_host, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_dequant_gather_kernel<<<static_cast<unsigned>(v), row_threads(d), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<const int64_t*>(flat), static_cast<const uint8_t*>(owned),
      static_cast<float*>(out), rows, d, static_cast<int64_t*>(bad_slot));
  return static_cast<int>(cudaGetLastError());
}

// `max_chunks` bounds the chunk count (the caller passes V / CHUNK + R); the
// partial buffer holds max_chunks rows of d.
extern "C" int scatter_add_f32(const void* g, const void* perm,
                               const void* offsets, const void* chunk_ptr,
                               void* out, void* partial, int R, int d,
                               int64_t max_chunks, void* stream) {
  return static_cast<int>(segsum::launch(
      static_cast<const float*>(g), static_cast<const int64_t*>(perm),
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(chunk_ptr), static_cast<float*>(out),
      nullptr, static_cast<float*>(partial), R, d, max_chunks,
      static_cast<cudaStream_t>(stream)));
}
