// rgcn_message: the edge compute of one RGCN layer with basis decomposition,
// as two kernels.
//
// 1. basis_message:  out[e, o] = mask[e] ? sum_b coef[e, b] * (h_t[e] . bases[b, :, o]) : 0
//    Replaces the Pallas TPU kernel repro/kernels/rgcn_message.py::basis_message
//    (pallas_call at rgcn_message.py:79), without its 128-edge padding.
//
//    What bounds it on an H100: operations. It does 2*E*B*d_in*d_out fp32
//    FLOP against 4*E*(d_in + B + d_out) bytes plus the bases: at the training
//    shape (E = 377,984, d = 75, B = 2) that is 8.5 GFLOP, 0.127 ms at the
//    67 TFLOP/s fp32 SIMT peak, and 0.069 ms of bytes at 3.35 TB/s.
//
//    Design: one block per tile of edges. The tile's h_t rows are staged in
//    shared memory with an odd row pitch and its coefficients beside them; the
//    bases go to shared memory too when they fit (dynamic shared memory, up to
//    the card's opt-in limit), else they are read from global memory through
//    the caches. Each thread owns one output column o and EPT edges of the
//    tile, so every basis value it loads feeds EPT FMAs. Consecutive threads
//    take consecutive columns: the basis loads hit consecutive banks and the
//    output stores of a tile are one contiguous range. Per output the
//    arithmetic is a fixed chain: p_b = fmaf over i = 0 .. d_in-1 in order,
//    then acc = fmaf(coef[e, b], p_b, acc) over b in order. A masked edge
//    writes exactly 0. IEEE fp32 throughout: no tensor cores, no fast math.
//
// 2. segment_sum:  agg[v] = sum over unmasked edges e with seg[e] == v of msg[e],
//                  deg[v] = the number of those edges (as fp32).
//    Replaces the Pallas TPU kernel repro/kernels/rgcn_message.py::segment_sum_onehot
//    (pallas_call at rgcn_message.py:152), whose one-hot matmuls stood in for
//    the TPU's missing atomics at O(V*E*d) work.
//
//    What bounds it on an H100: bytes. It must read msg (4*E*d) and write agg
//    (4*V*d): 0.036 ms at the training shape.
//
//    Design: no float atomics, so the sum is the same bits on every run: the
//    two passes of segment_sum.cuh (which scatter_add_onehot in
//    sharded_gather.cu shares) over the edges sorted stably by segment
//    (masked edges last), in chunks of 32 edges, then each segment's chunk
//    sums over 16 warps. Chunks and runs keep a hub vertex (the FB15k-237
//    training partition has a 53,149-edge segment) from serialising on one
//    warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum.cuh"

namespace {

constexpr int BM_THREADS = 256;  // threads per basis_message block
constexpr int EPT = 4;           // edges per thread in basis_message
constexpr int MAX_TILE_E = 128;  // edges per basis_message block

__global__ void __launch_bounds__(BM_THREADS)
basis_message_kernel(const float* __restrict__ h_t,
                     const float* __restrict__ coef,
                     const float* __restrict__ bases,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ out, int64_t E, int d_in, int d_out,
                     int nb, int tile_e, int pitch, int bases_in_smem) {
  extern __shared__ float smem[];
  float* hs = smem;                                         // (tile_e, pitch)
  float* cs = hs + static_cast<size_t>(tile_e) * pitch;     // (tile_e, nb)
  float* ws = cs + static_cast<size_t>(tile_e) * nb;        // (nb, d_in, d_out)

  const int t = threadIdx.x;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * tile_e;
  const int ne = static_cast<int>(E - e0 < tile_e ? E - e0 : tile_e);

  const float* hsrc = h_t + e0 * d_in;
  for (int i = t; i < ne * d_in; i += BM_THREADS) {
    const int r = i / d_in;
    hs[r * pitch + (i - r * d_in)] = hsrc[i];
  }
  for (int i = t; i < ne * nb; i += BM_THREADS) cs[i] = coef[e0 * nb + i];
  // rows past the ragged end feed only results that are never stored; zero
  // them so no uninitialised value enters the arithmetic
  const int groups = (ne + EPT - 1) / EPT;
  for (int i = ne * d_in + t; i < groups * EPT * d_in; i += BM_THREADS) {
    const int r = i / d_in;
    hs[r * pitch + (i - r * d_in)] = 0.0f;
  }
  for (int i = ne * nb + t; i < groups * EPT * nb; i += BM_THREADS)
    cs[i] = 0.0f;
  const float* w = bases;
  if (bases_in_smem) {
    const int nw = nb * d_in * d_out;
    for (int i = t; i < nw; i += BM_THREADS) ws[i] = bases[i];
    w = ws;
  }
  __syncthreads();

  const int items = groups * d_out;
  for (int it = t; it < items; it += BM_THREADS) {
    const int g = it / d_out;
    const int o = it - g * d_out;
    const int r0 = g * EPT;
    float acc[EPT];
#pragma unroll
    for (int k = 0; k < EPT; ++k) acc[k] = 0.0f;
    for (int b = 0; b < nb; ++b) {
      const float* wcol = w + static_cast<size_t>(b) * d_in * d_out + o;
      float p[EPT];
#pragma unroll
      for (int k = 0; k < EPT; ++k) p[k] = 0.0f;
      for (int i = 0; i < d_in; ++i) {
        const float wv = wcol[static_cast<size_t>(i) * d_out];
#pragma unroll
        for (int k = 0; k < EPT; ++k)
          p[k] = fmaf(hs[(r0 + k) * pitch + i], wv, p[k]);
      }
#pragma unroll
      for (int k = 0; k < EPT; ++k)
        acc[k] = fmaf(cs[(r0 + k) * nb + b], p[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if (r0 + k < ne) {
        const int64_t e = e0 + r0 + k;
        out[e * d_out + o] = mask[e] ? acc[k] : 0.0f;
      }
    }
  }
}

int max_dynamic_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      bytes = 48 * 1024;
  }
  return bytes;
}

size_t basis_smem(int tile_e, int pitch, int nb, int d_in, int d_out,
                  int bases_in_smem) {
  size_t floats = static_cast<size_t>(tile_e) * (pitch + nb);
  if (bases_in_smem) floats += static_cast<size_t>(nb) * d_in * d_out;
  return floats * sizeof(float);
}

}  // namespace

// The largest edge tile whose shared memory fits, preferring the bases in
// shared memory; 0 if even EPT edges do not fit.
extern "C" int basis_message_plan(int d_in, int d_out, int nb,
                                  int* bases_in_smem) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  const int pitch = d_in | 1;
  for (int in_smem = 1; in_smem >= 0; --in_smem) {
    for (int tile = MAX_TILE_E; tile >= (in_smem ? 16 : EPT); tile /= 2) {
      if (basis_smem(tile, pitch, nb, d_in, d_out, in_smem) <= limit) {
        *bases_in_smem = in_smem;
        return tile;
      }
    }
  }
  *bases_in_smem = 0;
  return 0;
}

extern "C" int basis_message_f32(const void* h_t, const void* coef,
                                 const void* bases, const void* mask,
                                 void* out, int64_t E, int d_in, int d_out,
                                 int nb, void* stream) {
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  int in_smem = 0;
  const int tile = basis_message_plan(d_in, d_out, nb, &in_smem);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int pitch = d_in | 1;  // odd pitch: rows r and r+4 start in other banks
  const size_t smem = basis_smem(tile, pitch, nb, d_in, d_out, in_smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        basis_message_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((E + tile - 1) / tile);
  basis_message_kernel<<<blocks, BM_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_t), static_cast<const float*>(coef),
      static_cast<const float*>(bases), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), E, d_in, d_out, nb, tile, pitch, in_smem);
  return static_cast<int>(cudaGetLastError());
}

// `max_chunks` bounds chunk_ptr[V] (the caller passes E / CHUNK + V); the
// partial buffer holds max_chunks rows.
extern "C" int segment_sum_f32(const void* msg, const void* perm,
                               const void* offsets, const void* chunk_ptr,
                               void* agg, void* deg, void* partial, int V,
                               int d, int64_t max_chunks, void* stream) {
  return static_cast<int>(segsum::launch(
      static_cast<const float*>(msg), static_cast<const int64_t*>(perm),
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(chunk_ptr), static_cast<float*>(agg),
      static_cast<float*>(deg), static_cast<float*>(partial), V, d,
      max_chunks, static_cast<cudaStream_t>(stream)));
}
