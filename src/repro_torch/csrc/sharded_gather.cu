// fused_gather: the sharded table's row exchange collapsed into one masked
// row gather,
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
// memory, which the wrapper reads after the gather and raises on.
#include <cuda_runtime.h>
#include <stdint.h>

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
  int threads = ((d + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  fused_gather_kernel<<<static_cast<unsigned>(v), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int64_t*>(flat),
      static_cast<const uint8_t*>(owned), static_cast<float*>(out), rows, d,
      static_cast<int64_t*>(bad_slot));
  return static_cast<int>(cudaGetLastError());
}
