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
//    Design: no float atomics, so the sum is the same bits on every run. The
//    caller sorts the edges stably by segment (masked edges last) and passes
//    the permutation, the segment offsets, and a chunk list that cuts every
//    segment into chunks of CHUNK sorted edges. Pass 1 gives each chunk one
//    warp: the lanes own columns, and each lane adds the chunk's rows in
//    ascending edge order. A segment of one chunk is then complete and is
//    written to agg; a longer one writes one partial row per chunk. Pass 2
//    gives each segment one block, writes deg, and adds a long segment's
//    partial rows: 16 warps each add a contiguous run of them in chunk
//    order, then the 16 run sums are added in order. Chunks and runs keep a
//    hub vertex (the FB15k-237 training partition has a 53,149-edge
//    segment) from serialising on one warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM_THREADS = 256;  // threads per basis_message block
constexpr int EPT = 4;           // edges per thread in basis_message
constexpr int MAX_TILE_E = 128;  // edges per basis_message block
constexpr int CHUNK = 32;        // sorted edges per segment_sum chunk (= warp)
constexpr int SEG_WARPS = 8;     // warps per segment_sum pass-1 block
constexpr int COMBINE_WARPS = 16;  // warps per segment in pass 2

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

// pass 1: one warp per chunk
__global__ void __launch_bounds__(SEG_WARPS * 32)
segment_chunk_kernel(const float* __restrict__ msg,
                     const int64_t* __restrict__ perm,
                     const int64_t* __restrict__ offsets,
                     const int64_t* __restrict__ chunk_ptr,
                     float* __restrict__ agg, float* __restrict__ partial,
                     int V, int d) {
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
                   ? agg + static_cast<int64_t>(v) * d
                   : partial + c * d;
  for (int col = lane; col - lane < d; col += 32) {
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const int64_t e = __shfl_sync(0xffffffffu, mine, j);
      if (col < d) acc += msg[e * d + col];
    }
    if (col < d) row[col] = acc;
  }
}

// pass 2: one block per segment. A segment of several chunks is cut into
// COMBINE_WARPS contiguous runs of chunk rows; each warp adds its run in
// chunk order, then warp 0 adds the runs' sums in run order. The split
// depends only on the segment's chunk count, so the sum order is fixed.
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
segment_combine_kernel(const float* __restrict__ partial,
                       const int64_t* __restrict__ offsets,
                       const int64_t* __restrict__ chunk_ptr,
                       float* __restrict__ agg, float* __restrict__ deg,
                       int d) {
  extern __shared__ float runs[];  // (COMBINE_WARPS, d)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v = blockIdx.x;
  if (threadIdx.x == 0)
    deg[v] = static_cast<float>(offsets[v + 1] - offsets[v]);
  const int64_t c0 = chunk_ptr[v], c1 = chunk_ptr[v + 1];
  if (c1 - c0 == 1) return;  // pass 1 wrote the whole segment
  float* row = agg + static_cast<int64_t>(v) * d;
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
  if (V <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = SEG_WARPS * 32;
  if (max_chunks > 0) {
    const unsigned blocks1 =
        static_cast<unsigned>((max_chunks + SEG_WARPS - 1) / SEG_WARPS);
    segment_chunk_kernel<<<blocks1, threads, 0, s>>>(
        static_cast<const float*>(msg), static_cast<const int64_t*>(perm),
        static_cast<const int64_t*>(offsets),
        static_cast<const int64_t*>(chunk_ptr), static_cast<float*>(agg),
        static_cast<float*>(partial), V, d);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = sizeof(float) * COMBINE_WARPS * static_cast<size_t>(d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        segment_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  segment_combine_kernel<<<static_cast<unsigned>(V), COMBINE_WARPS * 32,
                           smem, s>>>(
      static_cast<const float*>(partial), static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(chunk_ptr), static_cast<float*>(agg),
      static_cast<float*>(deg), d);
  return static_cast<int>(cudaGetLastError());
}
