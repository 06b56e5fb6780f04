// wkv_chunk: chunked RWKV-6 WKV, the time-mix core of every RWKV layer's
// prefill. Per row of the (BH, S, hd) inputs and per chunk of `chunk` steps,
// with the log decays lw cumulated along time inside the chunk, per column:
//
//     l_exc = cumsum(lw) - lw,  l_inc = l_exc + lw,  l_tot = l_inc[last]
//     out   = strict_lower((r e^{l_exc}) (k e^{-l_inc})^T) v
//             + (sum_d r u k) v + (r e^{l_exc}) S_in
//     S_out = e^{l_tot} . S_in + (k e^{l_tot - l_inc})^T v
//
// with the (hd, hd) state S zero at the row's first chunk.
//
// Replaces the Pallas TPU kernel repro/kernels/wkv_chunk.py::wkv_chunked
// (pallas_call at wkv_chunk.py:85), which kept the state of 8 rows in VMEM
// scratch across the sequential chunk axis of its grid and needed BH padded
// to 8 and S to `chunk` (repro/kernels/ops.py:383-399). This kernel takes any
// BH and any S: the last chunk of a row may be short.
//
// What bounds it on an H100: bytes. Per chunk of K steps the two products
// over the strict lower triangle take K (K - 1) hd fp32 FLOP each and the two
// with the state 2 K hd^2 each; at the rwkv6-3b prefill shape (BH = 160,
// S = 2,048, hd = chunk = 64) that is 8.0 GFLOP, 0.120 ms at the 67 TFLOP/s
// fp32 SIMT peak, against 0.125 ms for the 419 MB it must move.
//
// Design (simple first; wgmma, TMA and splitting the state's columns over
// blocks to fill the 132 SMs are later work): one block per BH row walks
// its chunks in order, so the state never leaves shared memory (the
// counterpart of the TPU's VMEM scratch). A chunk's r, k, v and lw tiles are
// staged in shared memory; k e^{-l_inc}, which the scores read down its
// rows, has an odd row pitch (hd + 1) so that consecutive threads hit
// different banks. At hd = chunk = 64 a block takes 115,200 bytes, so two
// blocks fit on an SM and the 160 rows of the prefill run in one wave.
// Every sum is a fixed-order fmaf chain or a fixed shuffle tree and there
// are no atomics, so two runs give the same bits. The build has no
// fast-math: expf is the accurate one. The e^{+-L} factors are the
// reference's own, without per-chunk renormalization.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
wkv_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, float* __restrict__ out, int S,
                 int hd, int chunk) {
  extern __shared__ float smem[];
  const int P = hd + 1;                    // odd pitch of k e^{-l_inc}
  float* st = smem;                        // (hd, hd) state, row j = key dim
  float* rs = st + hd * hd;                // (chunk, hd) r, then r e^{l_exc}
  float* ks = rs + chunk * hd;             // k, then k e^{l_tot - l_inc}
  float* vs = ks + chunk * hd;             // v
  float* ls = vs + chunk * hd;             // lw, then l_inc
  float* kt = ls + chunk * hd;             // (chunk, hd + 1) k e^{-l_inc}
  float* sc = kt + chunk * P;              // (chunk, chunk) scores
  float* bonus = sc + chunk * chunk;       // (chunk,) sum_d r u k

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * S * hd;
  const float* ur = u + static_cast<int64_t>(blockIdx.x) * hd;
  for (int i = t; i < hd * hd; i += THREADS) st[i] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int n = min(chunk, S - c0);      // steps in this chunk
    const int64_t off = base + static_cast<int64_t>(c0) * hd;
    for (int i = t; i < n * hd; i += THREADS) {
      rs[i] = r[off + i];
      ks[i] = k[off + i];
      vs[i] = v[off + i];
      ls[i] = lw[off + i];
    }
    __syncthreads();

    // the bonus from the unscaled r and k: one warp per step, each lane a
    // fixed strided chain over the columns, then a fixed shuffle tree
    for (int a = warp; a < n; a += WARPS) {
      float acc = 0.0f;
      for (int j = lane; j < hd; j += 32)
        acc = fmaf(rs[a * hd + j] * ur[j], ks[a * hd + j], acc);
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) bonus[a] = acc;
    }
    __syncthreads();

    // the cumulated decays, one thread per column, in time order
    for (int j = t; j < hd; j += THREADS) {
      float cs = 0.0f;
      for (int a = 0; a < n; ++a) {
        const float w = ls[a * hd + j];
        cs += w;
        const float lexc = cs - w;
        const float linc = lexc + w;
        rs[a * hd + j] *= expf(lexc);
        kt[a * P + j] = ks[a * hd + j] * expf(-linc);
        ls[a * hd + j] = linc;
      }
    }
    __syncthreads();

    // k e^{l_tot - l_inc} for the state update (l_tot: the last row of
    // l_inc), and the strictly lower scores (consecutive threads on
    // consecutive key steps b)
    const float* ltot = ls + (n - 1) * hd;
    for (int i = t; i < n * hd; i += THREADS)
      ks[i] *= expf(ltot[i % hd] - ls[i]);
    for (int i = t; i < n * n; i += THREADS) {
      const int a = i / n, b = i - a * n;
      float acc = 0.0f;
      if (b < a)
        for (int j = 0; j < hd; ++j)
          acc = fmaf(rs[a * hd + j], kt[b * P + j], acc);
      sc[a * chunk + b] = acc;
    }
    __syncthreads();

    // out = (intra + bonus v) + cross, consecutive threads on consecutive
    // value columns c
    for (int i = t; i < n * hd; i += THREADS) {
      const int a = i / hd, c = i - a * hd;
      float intra = 0.0f;
      for (int b = 0; b < a; ++b)
        intra = fmaf(sc[a * chunk + b], vs[b * hd + c], intra);
      float cross = 0.0f;
      for (int j = 0; j < hd; ++j)
        cross = fmaf(rs[a * hd + j], st[j * hd + c], cross);
      out[off + i] = (intra + bonus[a] * vs[i]) + cross;
    }
    __syncthreads();

    // S = e^{l_tot} S + (k e^{l_tot - l_inc})^T v
    for (int i = t; i < hd * hd; i += THREADS) {
      const int j = i / hd, c = i - j * hd;
      float delta = 0.0f;
      for (int a = 0; a < n; ++a)
        delta = fmaf(ks[a * hd + j], vs[a * hd + c], delta);
      st[i] = expf(ltot[j]) * st[i] + delta;
    }
    __syncthreads();
  }
}

// Bytes of dynamic shared memory one block needs: the (hd, hd) state, the
// r, k, v and L tiles at pitch hd, k e^{-L} at pitch hd + 1, the
// (chunk, chunk) scores and the bonus.
size_t smem_bytes(int hd, int chunk) {
  return sizeof(float) * (static_cast<size_t>(hd) * hd +
                          4 * static_cast<size_t>(chunk) * hd +
                          static_cast<size_t>(chunk) * (hd + 1) +
                          static_cast<size_t>(chunk) * chunk + chunk);
}

// The largest dynamic shared memory a block may opt in to on the current
// device.
int max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return bytes;
}

}  // namespace

// Returns a cudaError_t, or WKV_SMEM_TOO_LARGE (the Python wrapper's
// _SMEM_TOO_LARGE) when one block of hd and chunk needs more shared memory
// than the device gives a block. Checked before the empty-input return, so
// a shape is refused whatever BH and S are.
#define WKV_SMEM_TOO_LARGE (-1)

extern "C" int wkv_chunked_f32(const void* r, const void* k, const void* v,
                               const void* lw, const void* u, void* out,
                               int BH, int S, int hd, int chunk,
                               void* stream) {
  if (hd <= 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(hd, chunk);
  if (smem > static_cast<size_t>(max_smem())) return WKV_SMEM_TOO_LARGE;
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wkv_chunk_kernel<<<static_cast<unsigned>(BH), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<float*>(out), S, hd, chunk);
  return static_cast<int>(cudaGetLastError());
}
