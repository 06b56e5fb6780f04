// kge_score: one block of candidate scores in the decoders' query form,
//
//     out[b, c] = epilogue(q[b] . cand[c] + q_bias[b] + c_bias[c]) + bias[b, c]
//
// with epilogue bilinear (identity) or neg_l2 (-sqrt(max(x, 0) + 1e-9)).
//
// Replaces the Pallas TPU kernel repro/kernels/kge_score.py::kge_score
// (pallas_call at kge_score.py:95) together with the 128-row padding of
// repro/kernels/ops.py::kge_score_padded: ragged B and C are taken directly.
//
// What bounds it on an H100: memory. Each candidate row (4d bytes) is read
// once and feeds B*d FMAs; at the serving batch B = 8 that is 2 FMAs per byte
// read, far below the card's ~20 fp32 FLOP per byte, and the (B, C) bias read
// and output write add 8 bytes per score. So the design streams every
// candidate row from device memory exactly once, coalesced, and fuses the
// rank-1 biases, the epilogue and the post-epilogue bias into that one pass.
//
// Design:
//   * one block per tile of TILE_C candidate rows and QB query rows; the
//     tile's rows are contiguous in memory and are copied into shared memory
//     by consecutive threads reading consecutive floats (coalesced), with an
//     odd row pitch so the per-row reads below hit distinct banks;
//   * the QB query rows sit in shared memory and are read as broadcasts;
//   * each thread owns one candidate row and computes its dot products in
//     the fixed order j = 0 .. d-1 with fmaf. A score's bits therefore never
//     depend on B, C, the tile or the candidate's position: a shard's block
//     is bitwise the matching columns of the dense block (sharded == dense);
//   * full fp32 throughout: no tensor cores (no TF32), and no fast math, so
//     sqrtf stays correctly rounded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_C = 128;  // candidate rows per block = threads per block
constexpr int QB = 8;        // query rows per block

__global__ void __launch_bounds__(TILE_C)
kge_score_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                 const float* __restrict__ bias,
                 const float* __restrict__ q_bias,
                 const float* __restrict__ c_bias, float* __restrict__ out,
                 int B, int64_t C, int d, int pitch, int neg_l2) {
  extern __shared__ float smem[];
  float* cs = smem;                   // (TILE_C, pitch) candidate tile
  float* qs = smem + TILE_C * pitch;  // (QB, d) query rows

  const int t = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * TILE_C;
  const int b0 = blockIdx.y * QB;
  const int nc = static_cast<int>(C - c0 < TILE_C ? C - c0 : TILE_C);
  const int nb = B - b0 < QB ? B - b0 : QB;

  const float* tile = cand + c0 * d;
  for (int i = t; i < nc * d; i += TILE_C) {
    const int r = i / d;
    cs[r * pitch + (i - r * d)] = tile[i];
  }
  for (int i = t; i < nb * d; i += TILE_C) qs[i] = q[b0 * d + i];
  __syncthreads();
  if (t >= nc) return;

  const int64_t c = c0 + t;
  const float cb = c_bias[c];
  const float* row = cs + t * pitch;
  for (int b = 0; b < nb; ++b) {
    const float* qr = qs + b * d;
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) acc = fmaf(qr[j], row[j], acc);
    float x = (acc + q_bias[b0 + b]) + cb;
    if (neg_l2) x = -sqrtf(fmaxf(x, 0.0f) + 1e-9f);
    const int64_t o = static_cast<int64_t>(b0 + b) * C + c;
    out[o] = x + bias[o];
  }
}

}  // namespace

extern "C" int kge_score_f32(const void* q, const void* cand,
                             const void* bias, const void* q_bias,
                             const void* c_bias, void* out, int B, int64_t C,
                             int d, int neg_l2, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const int pitch = d | 1;  // odd pitch: row t starts in bank (t*pitch)%32
  const size_t smem = sizeof(float) * (static_cast<size_t>(TILE_C) * pitch +
                                       static_cast<size_t>(QB) * d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kge_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((C + TILE_C - 1) / TILE_C),
                  static_cast<unsigned>((B + QB - 1) / QB));
  kge_score_kernel<<<grid, TILE_C, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cand),
      static_cast<const float*>(bias), static_cast<const float*>(q_bias),
      static_cast<const float*>(c_bias), static_cast<float*>(out), B, C, d,
      pitch, neg_l2);
  return static_cast<int>(cudaGetLastError());
}
