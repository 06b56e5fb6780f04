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
// Every score is one fixed-order fp32 sum: acc = fmaf(q[b, j], cand[c, j],
// acc) for j = 0 .. d-1 from acc = 0, then (acc + q_bias[b]) + c_bias[c],
// the epilogue with a correctly rounded sqrtf, then + bias[b, c]. A score's
// bits therefore never depend on B, C, the tile or the candidate's position:
// a shard's block is bitwise the matching columns of the dense block
// (sharded == dense), and the two kernels below give the same bits. Full
// fp32 throughout: no tensor cores (no TF32), no fast math.
//
// What bounds it on an H100. At the serving batch (B = 8) memory: each
// candidate row (4d bytes) feeds 8d FMAs, 2 per byte read, and the (B, C)
// bias read and output write add 8 bytes per score. At the training
// ranking batch (B = 256, C = 3,636 rows of a shard, d = 75) the FMAs
// (70 M) and the bias and output (7.4 MB) take about the same least time,
// 2-3 us each. Either way a kernel near its bound reads each candidate row
// from device memory about once, keeps several independent FMA chains in
// flight per thread, and fills the 132 SMs even at small B and C.
//
// kge_score_f32 (the kernel the wrapper launches): register tiling.
//   * A block covers BQ = TY * TQ queries by BC = TX * TC candidates; each
//     thread holds a TQ x TC micro-tile of independent accumulators, so one
//     operand read from shared memory feeds TQ or TC FMAs and the chains
//     overlap. Three shapes, chosen by B and C (measured on the card among
//     several): B <= 8 (serving) with C up to about 4 x 32 per SM takes
//     TQ = 2, TC = 1 and 32 x 4 threads (many short blocks: small C is a
//     matter of latency), larger C TQ = 4, TC = 1 and 64 x 2 threads (a
//     memory-bound stream); B > 8 takes TQ = 8, TC = 4, TX = 16 and an
//     even TY up to 8 (whole warps; 64 x 64 per block), so a candidate row
//     is read B / 64 times instead of B / 8.
//   * d is staged through shared memory in slices of KD = 32 with cp.async
//     (4 bytes each: a row of d floats is only 4-byte aligned; a warp copies
//     one row's slice, coalesced, with no index arithmetic) into a ring
//     of up to NSTAGE = 4 buffers: every slice of d <= 128 is in flight at
//     once (one trip to device memory, not one per slice), and a larger d
//     streams through the ring, the next slices' copies under this
//     slice's FMAs. Candidates keep their row layout at an odd pitch (a
//     warp's 32 candidates read 32 banks); queries are stored transposed,
//     (KD, BQ), so a thread reads its TQ queries as float4 broadcasts.
//   * The epilogue's operands (bias, q_bias, c_bias) are loaded into
//     registers before the FMAs, so their trip to device memory overlaps
//     the staging instead of following it query by query; the stores go
//     with consecutive threads on consecutive candidates (coalesced).
//
// kge_score_f32_v1: the first port's kernel (one thread per candidate row,
// 128-row tile, 8 queries per block, one dependent chain at a time), kept so
// that the chip smoke run can hold the register-tiled kernel against it bit
// for bit.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------------ //
// the register-tiled kernel
// ------------------------------------------------------------------------ //
constexpr int KD = 32;          // d per staged slice (a warp's width)
constexpr int CPITCH = KD + 1;  // candidate row pitch in shared memory (odd)
constexpr int NSTAGE = 4;       // slices in flight: d <= 128 is one round trip
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float score_epilogue(float acc, float qb, float cb,
                                                int neg_l2, float bias) {
  float x = (acc + qb) + cb;
  if (neg_l2) x = -sqrtf(fmaxf(x, 0.0f) + 1e-9f);
  return x + bias;
}

// floats of one stage: the (BC, CPITCH) candidate slice and the transposed
// (KD, BQ + 4) query slice
__host__ __device__ __forceinline__ int stage_floats(int bc, int bq) {
  return bc * CPITCH + KD * (bq + 4);
}

// cp.async.wait_group takes an immediate: wait until at most n groups are
// pending (0 <= n < NSTAGE)
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    default: __pipeline_wait_prior(3); break;
  }
}

// a thread's TQ consecutive queries at one k: float4 (or float2) broadcasts
template <int TQ>
__device__ __forceinline__ void load_queries(const float* p, float* qv) {
  if constexpr (TQ % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TQ; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      qv[i] = v.x;
      qv[i + 1] = v.y;
      qv[i + 2] = v.z;
      qv[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TQ; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      qv[i] = v.x;
      qv[i + 1] = v.y;
    }
  }
}

template <int TQ, int TC>
__global__ void __launch_bounds__(MAX_THREADS)
kge_score_tiled_kernel(const float* __restrict__ q,
                       const float* __restrict__ cand,
                       const float* __restrict__ bias,
                       const float* __restrict__ q_bias,
                       const float* __restrict__ c_bias,
                       float* __restrict__ out, int B, int64_t C, int d,
                       int neg_l2) {
  extern __shared__ __align__(16) float tiled_smem[];
  const int TX = blockDim.x, TY = blockDim.y;
  const int BC = TX * TC, BQ = TY * TQ;
  const int QPITCH = BQ + 4;  // keeps every float4 of a query row aligned
  const int sf = stage_floats(BC, BQ);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx, nthreads = TX * TY;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * BC;
  const int b0 = blockIdx.y * BQ;
  const int nc = static_cast<int>(C - c0 < BC ? C - c0 : BC);
  const int nb = B - b0 < BQ ? B - b0 : BQ;
  const int slices = (d + KD - 1) / KD;
  const int nst = slices < NSTAGE ? slices : NSTAGE;

  // slice k0 .. k0 + KD of the tile's candidate rows and query rows into
  // stage buffer s: coalesced 4-byte cp.async, a warp along one row's slice
  // (a row of d floats is only 4-byte aligned); columns past d are skipped
  const int lane = tid % 32, warp = tid / 32, nwarps = nthreads / 32;
  auto stage = [&](int s, int k0) {
    float* cs = tiled_smem + s * sf + lane;
    float* qs = tiled_smem + s * sf + BC * CPITCH + lane * QPITCH;
    if (lane >= d - k0) return;  // past the last column of this slice
    const float* cg = cand + (c0 + warp) * d + k0 + lane;
    for (int r = warp; r < nc; r += nwarps, cg += nwarps * d)
      __pipeline_memcpy_async(cs + r * CPITCH, cg, sizeof(float));
    const float* qg = q + static_cast<int64_t>(b0 + warp) * d + k0 + lane;
    for (int r = warp; r < nb; r += nwarps, qg += nwarps * d)
      __pipeline_memcpy_async(qs + r, qg, sizeof(float));
  };
  for (int s = 0; s < nst; ++s) {
    stage(s, s * KD);
    __pipeline_commit();
  }

  // the epilogue's operands, loaded now so that their latency runs under
  // the staging and the FMAs
  float bv[TQ][TC], qbv[TQ], cbv[TC];
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int64_t c = c0 + tx + j * TX;
    cbv[j] = c < C ? c_bias[c] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int b = b0 + ty * TQ + i;
    qbv[i] = b < B ? q_bias[b] : 0.0f;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int64_t c = c0 + tx + j * TX;
      bv[i][j] = (b < B && c < C) ? bias[static_cast<int64_t>(b) * C + c]
                                  : 0.0f;
    }
  }

  float acc[TQ][TC];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  // slice s sits in buffer s % nst; nst - 1 groups were committed after it
  for (int s = 0; s < slices; ++s) {
    wait_pending(nst - 1);
    __syncthreads();
    const int k0 = s * KD;
    const int kn = d - k0 < KD ? d - k0 : KD;
    const float* cs = tiled_smem + (s % nst) * sf;
    const float* qs = cs + BC * CPITCH + ty * TQ;
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      float cv[TC];
#pragma unroll
      for (int j = 0; j < TC; ++j) cv[j] = cs[(tx + j * TX) * CPITCH + k];
      float qv[TQ];
      load_queries<TQ>(qs + k * QPITCH, qv);
      // j ascends across slices and within one: the fixed order
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(qv[i], cv[j], acc[i][j]);
    }
    __syncthreads();  // every thread is done with buffer s % nst
    if (s + nst < slices) stage(s % nst, (s + nst) * KD);
    __pipeline_commit();  // possibly empty: one group per iteration
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int b = b0 + ty * TQ + i;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int64_t c = c0 + tx + j * TX;
      if (b < B && c < C)
        out[static_cast<int64_t>(b) * C + c] =
            score_epilogue(acc[i][j], qbv[i], cbv[j], neg_l2, bv[i][j]);
    }
  }
}

template <int TQ, int TC>
cudaError_t launch_tiled(const float* q, const float* cand, const float* bias,
                         const float* q_bias, const float* c_bias, float* out,
                         int B, int64_t C, int d, int neg_l2, int tx, int ty,
                         cudaStream_t stream) {
  // the staging copies a row per warp: whole warps only
  if ((tx * ty) % 32 != 0 || tx * ty > MAX_THREADS) return cudaErrorInvalidValue;
  const int bc = tx * TC, bq = ty * TQ;
  const int slices = (d + KD - 1) / KD;
  const int nst = slices < NSTAGE ? slices : NSTAGE;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(nst) * stage_floats(bc, bq);
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kge_score_tiled_kernel<TQ, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const dim3 grid(static_cast<unsigned>((C + bc - 1) / bc),
                  static_cast<unsigned>((B + bq - 1) / bq));
  kge_score_tiled_kernel<TQ, TC><<<grid, dim3(tx, ty), smem, stream>>>(
      q, cand, bias, q_bias, c_bias, out, B, C, d, neg_l2);
  return cudaGetLastError();
}

int sm_count() {  // of the current device
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// ------------------------------------------------------------------------ //
// the first port's kernel (kge_score_f32_v1)
// ------------------------------------------------------------------------ //
constexpr int V1_TILE_C = 128;  // candidate rows per block = threads per block
constexpr int V1_QB = 8;        // query rows per block

__global__ void __launch_bounds__(V1_TILE_C)
kge_score_v1_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                    const float* __restrict__ bias,
                    const float* __restrict__ q_bias,
                    const float* __restrict__ c_bias, float* __restrict__ out,
                    int B, int64_t C, int d, int pitch, int neg_l2) {
  extern __shared__ float v1_smem[];
  float* cs = v1_smem;                      // (V1_TILE_C, pitch) candidate tile
  float* qs = v1_smem + V1_TILE_C * pitch;  // (V1_QB, d) query rows

  const int t = threadIdx.x;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * V1_TILE_C;
  const int b0 = blockIdx.y * V1_QB;
  const int nc = static_cast<int>(C - c0 < V1_TILE_C ? C - c0 : V1_TILE_C);
  const int nb = B - b0 < V1_QB ? B - b0 : V1_QB;

  const float* tile = cand + c0 * d;
  for (int i = t; i < nc * d; i += V1_TILE_C) {
    const int r = i / d;
    cs[r * pitch + (i - r * d)] = tile[i];
  }
  for (int i = t; i < nb * d; i += V1_TILE_C) qs[i] = q[b0 * d + i];
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

// The register-tiled kernel, its shape chosen by B and C (see above).
extern "C" int kge_score_f32(const void* q, const void* cand,
                             const void* bias, const void* q_bias,
                             const void* c_bias, void* out, int B, int64_t C,
                             int d, int neg_l2, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(cand);
  const float* bf = static_cast<const float*>(bias);
  const float* qbf = static_cast<const float*>(q_bias);
  const float* cbf = static_cast<const float*>(c_bias);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 8) {
    // up to ~4 blocks of 32 candidates per SM: 2 queries per thread and
    // 4 warps per block, for latency; above, a memory-bound stream: 4
    // queries per thread, 64 candidates per block
    if (C <= 4 * 32 * static_cast<int64_t>(sm_count()))
      return static_cast<int>(launch_tiled<2, 1>(qf, cf, bf, qbf, cbf, of, B,
                                                 C, d, neg_l2, 32, 4, st));
    return static_cast<int>(launch_tiled<4, 1>(qf, cf, bf, qbf, cbf, of, B, C,
                                               d, neg_l2, 64, 2, st));
  }
  // an even TY: 16 x TY threads are whole warps (rows past B are skipped)
  int ty = (B + 7) / 8 < 8 ? (B + 7) / 8 : 8;
  ty += ty & 1;
  return static_cast<int>(launch_tiled<8, 4>(qf, cf, bf, qbf, cbf, of, B, C, d,
                                             neg_l2, 16, ty, st));
}

extern "C" int kge_score_f32_v1(const void* q, const void* cand,
                                const void* bias, const void* q_bias,
                                const void* c_bias, void* out, int B,
                                int64_t C, int d, int neg_l2, void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const int pitch = d | 1;  // odd pitch: row t starts in bank (t*pitch)%32
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(V1_TILE_C) * pitch +
                       static_cast<size_t>(V1_QB) * d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kge_score_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((C + V1_TILE_C - 1) / V1_TILE_C),
                  static_cast<unsigned>((B + V1_QB - 1) / V1_QB));
  kge_score_v1_kernel<<<grid, V1_TILE_C, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cand),
      static_cast<const float*>(bias), static_cast<const float*>(q_bias),
      static_cast<const float*>(c_bias), static_cast<float*>(out), B, C, d,
      pitch, neg_l2);
  return static_cast<int>(cudaGetLastError());
}
