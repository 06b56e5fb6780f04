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
//    67 TFLOP/s fp32 SIMT peak, and 0.069 ms of bytes at 3.35 TB/s. So the
//    FMA pipes must be kept busy: every other instruction, shared-memory
//    load, barrier and stall is time above the bound.
//
//    Every output is one fixed chain of fp32 operations, in every kernel
//    below: p_b = fmaf(h[i], W[b][i][o], p_b) over i = 0 .. d_in-1 from 0,
//    then acc = fmaf(coef[e, b], p_b, acc) over b = 0 .. B-1 from 0; a
//    masked edge stores exactly 0. Explicit fmaf, no tensor cores, no fast
//    math: tiling changes which outputs a thread computes, never the
//    operations of one output, so the kernels give the same bits.
//
//    What held the first kernel back (basis_message_f32_v1: a 128-edge tile
//    per block, a thread per output column and 4 edges):
//      * 5 scalar shared-memory loads (1 basis value, 4 h values) per 4
//        FMAs: shared memory, not the FMA pipes, set the pace;
//      * every 128-edge block reloaded all the bases (45 KB at d = 75):
//        about 133 MB of L2 to SM traffic per call at the training shape;
//      * 84 KB of shared memory per block, so two blocks (16 warps) per SM;
//      * the h tile was loaded with plain loads and a barrier, so nothing
//        overlapped the FMAs;
//      * a warp's 32 items wrapped across two edge groups and the last of
//        about 10 trips over a tile's items was 96/256 full.
//
//    Design (basis_message_f32):
//      * 2-D register tiles: a thread computes TE = 8 edges x TO = 4 output
//        columns. Per input index it loads its 8 h values as two float4s
//        and its 4 basis values as one float4 from shared memory: 3 loads
//        for 32 FMAs. The h tile is stored transposed, (d_in, tile_e) at a
//        pitch of tile_e + 4, so an edge group's 8 values are contiguous;
//        the bases with d_out padded to a multiple of 4 (75 -> 76), the
//        padding zero and feeding only outputs that are never stored.
//        Consecutive threads take consecutive column groups, so a warp
//        reads 2 or 3 distinct h float4s (broadcast) and 19 basis float4s.
//      * Bases once per block: blocks are persistent (the grid is the SMs
//        times the blocks that fit on one, each walking the edge tiles with
//        a stride) and load their slice of the bases into shared memory
//        once. Where all the bases do not fit beside the h tiles, the
//        output columns are split over blocks (grid.y) so that each
//        block's slice fits (bases over 48 KB and over the card's shared
//        memory alike). The plan takes the split and edge tile (up to
//        MAX_GROUPS groups of 8 edges, at most BM_THREADS threads) with the
//        most (edge group, column group) items resident per SM, from the
//        card's shared memory and registers and the kernel's registers.
//      * Asynchronous copies: the h and coefficient tiles are double
//        buffered with cp.async (4 bytes each: a row of 75 floats is only
//        4-byte aligned); the next tile's copies are issued before this
//        tile's FMAs. A warp copies 8 inputs of 4 edges at a time: four
//        32-byte runs of h_t, written to 32 distinct banks of the
//        transposed tile (the pitch is 4 times an odd number).
//      * Masked edges need no FMAs: each tile's mask bytes travel with its
//        copies (loaded into a register, stored to shared memory after the
//        current tile's FMAs), and a group of 8 edges with none unmasked
//        (a mini-batch's padding, about a fifth of its edges, all at the
//        tail) stores its zeros without computing.
//      * At d = 75, B = 2: 104-edge tiles, 247 items in 256 threads (8
//        warps), 112,272 bytes of shared memory, two blocks (16 warps) per
//        SM, a grid of 264 blocks. ptxas: 127 registers (two blocks fit up
//        to 128), no spills. Measured slower on the card: a 128-edge tile
//        (one block per SM) and 8 x 8 register tiles (one block per SM).
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
//    edges sorted stably by segment (masked edges last), added in chunks of
//    32 edges, then each segment's chunk sums in 16 runs, in the order
//    segment_sum.cuh sets out. segment_sum_f32 runs that header's
//    launch_scatter, the passes scatter_add_onehot in sharded_gather.cu
//    runs, with the degree written by pass 2a: a warp per chunk found by a
//    32-ary search, up to 4 columns a lane with 16-32 loads in flight, a
//    warp per segment to combine, a block per hub segment (the FB15k-237
//    training partition has a 53,149-edge one).
//
//    What held the first kernel back (segment_sum_f32_v1, segsum::launch,
//    kept so that the chip smoke run can hold the new passes against it bit
//    for bit; the same order, so the same bits): a chunk's segment found by
//    a binary search 14-15 loads deep, a lane walking its columns 32 at a
//    time, and a 512-thread combine block for every segment, most of which
//    return at once.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum.cuh"

namespace {

// ------------------------------------------------------------------------ //
// basis_message_f32_v1: the first port's kernel
// ------------------------------------------------------------------------ //
constexpr int V1_THREADS = 256;  // threads per block
constexpr int EPT = 4;           // edges per thread
constexpr int MAX_TILE_E = 128;  // edges per block

__global__ void __launch_bounds__(V1_THREADS)
basis_message_kernel_v1(const float* __restrict__ h_t,
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
  for (int i = t; i < ne * d_in; i += V1_THREADS) {
    const int r = i / d_in;
    hs[r * pitch + (i - r * d_in)] = hsrc[i];
  }
  for (int i = t; i < ne * nb; i += V1_THREADS) cs[i] = coef[e0 * nb + i];
  // rows past the ragged end feed only results that are never stored; zero
  // them so no uninitialised value enters the arithmetic
  const int groups = (ne + EPT - 1) / EPT;
  for (int i = ne * d_in + t; i < groups * EPT * d_in; i += V1_THREADS) {
    const int r = i / d_in;
    hs[r * pitch + (i - r * d_in)] = 0.0f;
  }
  for (int i = ne * nb + t; i < groups * EPT * nb; i += V1_THREADS)
    cs[i] = 0.0f;
  const float* w = bases;
  if (bases_in_smem) {
    const int nw = nb * d_in * d_out;
    for (int i = t; i < nw; i += V1_THREADS) ws[i] = bases[i];
    w = ws;
  }
  __syncthreads();

  const int items = groups * d_out;
  for (int it = t; it < items; it += V1_THREADS) {
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

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 1;
  }
  return n;
}

size_t basis_smem_v1(int tile_e, int pitch, int nb, int d_in, int d_out,
                     int bases_in_smem) {
  size_t floats = static_cast<size_t>(tile_e) * (pitch + nb);
  if (bases_in_smem) floats += static_cast<size_t>(nb) * d_in * d_out;
  return floats * sizeof(float);
}

// The first kernel's plan: the largest edge tile whose shared memory fits,
// preferring the bases in shared memory; 0 if even EPT edges do not fit.
int basis_plan_v1(int d_in, int d_out, int nb, int* bases_in_smem) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  const int pitch = d_in | 1;
  for (int in_smem = 1; in_smem >= 0; --in_smem) {
    for (int tile = MAX_TILE_E; tile >= (in_smem ? 16 : EPT); tile /= 2) {
      if (basis_smem_v1(tile, pitch, nb, d_in, d_out, in_smem) <= limit) {
        *bases_in_smem = in_smem;
        return tile;
      }
    }
  }
  *bases_in_smem = 0;
  return 0;
}

// ------------------------------------------------------------------------ //
// basis_message_f32: register tiles, persistent blocks, cp.async
// ------------------------------------------------------------------------ //
constexpr int TE = 8;            // edges per thread
constexpr int TO = 4;            // output columns per thread (one float4)
constexpr int MAX_GROUPS = 16;   // edge groups per tile: tile_e <= 128
constexpr int BM_THREADS = 384;  // threads per block, at most
static_assert(TE == 8, "an edge group's mask bytes are one 64-bit word");

// shared memory: the bases slice (nb, d_in, cgs * TO), two h tiles
// (d_in, tile_e + 4) and two coefficient tiles (tile_e, nb) of floats, and
// two tiles of mask bytes
size_t basis_smem(int nb, int d_in, int cgs, int tile_e) {
  return sizeof(float) *
             (static_cast<size_t>(nb) * d_in * cgs * TO +
              2 * static_cast<size_t>(d_in) * (tile_e + 4) +
              2 * static_cast<size_t>(tile_e) * nb) +
         2 * static_cast<size_t>(tile_e);
}

__global__ void __launch_bounds__(BM_THREADS, 1)
basis_message_kernel(const float* __restrict__ h_t,
                     const float* __restrict__ coef,
                     const float* __restrict__ bases,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ out, int64_t E, int d_in, int d_out,
                     int nb, int tile_e, int cgs) {
  extern __shared__ __align__(16) float smem[];
  const int wpitch = cgs * TO;   // a bases row of the slice
  const int hpitch = tile_e + 4; // a transposed h row: 4 times an odd number
  float* ws = smem;                                             // (nb, d_in, wpitch)
  float* hs = ws + static_cast<size_t>(nb) * d_in * wpitch;     // 2 x (d_in, hpitch)
  float* cs = hs + 2 * static_cast<size_t>(d_in) * hpitch;      // 2 x (tile_e, nb)
  uint8_t* ms = reinterpret_cast<uint8_t*>(cs + 2 * tile_e * nb); // 2 x tile_e

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int c0 = blockIdx.y * wpitch;  // the slice's first output column
  const int64_t ntiles = (E + tile_e - 1) / tile_e;

  // the slice of the bases, once per block; columns past d_out are zero
  const int nw = nb * d_in * wpitch;
  for (int idx = t; idx < nw; idx += nt) {
    const int bi = idx / wpitch;  // b * d_in + i
    const int c = c0 + idx - bi * wpitch;
    ws[idx] = c < d_out ? bases[static_cast<size_t>(bi) * d_out + c] : 0.0f;
  }

  // copy tile `tile` into buffer `buf`: h_t transposed, rows past the
  // ragged end zero. Patch (pi, pe) covers inputs 8 pi .. 8 pi + 7 of edges
  // 4 pe .. 4 pe + 3, a warp's 32 copies; warp k takes patches k, k +
  // warps, ... in the order pe * pi_n + pi, stepped without a division
  const int lane = t & 31;
  const int pi_n = (d_in + 7) / 8;
  const int warps = nt >> 5;
  const int pe0 = (t >> 5) / pi_n, pi0 = (t >> 5) - pe0 * pi_n;
  const int dpe = warps / pi_n, dpi = warps - dpe * pi_n;
  // the next tile's mask bytes, loaded with its copies into a register and
  // stored to shared memory after this tile's FMAs, when the load is back
  uint8_t mask_next = 0;
  auto stage = [&](int64_t tile, int buf) {
    const int64_t e0 = tile * tile_e;
    if (t < tile_e) mask_next = e0 + t < E ? mask[e0 + t] : 0;
    const int ne = static_cast<int>(E - e0 < tile_e ? E - e0 : tile_e);
    float* hb = hs + static_cast<size_t>(buf) * d_in * hpitch;
    float* cb = cs + buf * tile_e * nb;
    for (int pe = pe0, pi = pi0; pe < tile_e / 4;) {
      const int i = pi * 8 + (lane >> 2);
      const int e = pe * 4 + (lane & 3);
      if (i < d_in) {
        float* dst = hb + i * hpitch + e;
        if (e < ne)
          __pipeline_memcpy_async(dst, h_t + (e0 + e) * d_in + i,
                                  sizeof(float));
        else
          *dst = 0.0f;
      }
      pe += dpe;
      pi += dpi;
      if (pi >= pi_n) {
        pi -= pi_n;
        ++pe;
      }
    }
    for (int idx = t; idx < tile_e * nb; idx += nt) {
      if (idx < ne * nb)
        __pipeline_memcpy_async(cb + idx, coef + e0 * nb + idx,
                                sizeof(float));
      else
        cb[idx] = 0.0f;
    }
  };

  // this thread's item: edge group eg (TE edges), column group cg (TO
  // columns); consecutive threads take consecutive column groups
  const bool active = t < (tile_e / TE) * cgs;
  const int eg = active ? t / cgs : 0;
  const int cg = active ? t - eg * cgs : 0;

  int64_t tile = blockIdx.x;
  if (tile < ntiles) stage(tile, 0);
  __pipeline_commit();
  if (t < tile_e) ms[t] = mask_next;
  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x, buf ^ 1);
    __pipeline_commit();  // possibly empty: one group per iteration
    __pipeline_wait_prior(1);
    __syncthreads();
    // this edge group's mask bytes: a group with no unmasked edge (the
    // padding at the tail of a mini-batch) skips its FMAs and stores zeros
    const uint64_t on = active ? *reinterpret_cast<const uint64_t*>(
                                     ms + buf * tile_e + eg * TE)
                               : 0;
    if (active) {
      const float* hb =
          hs + static_cast<size_t>(buf) * d_in * hpitch + eg * TE;
      const float* cb = cs + (buf * tile_e + eg * TE) * nb;
      float acc[TE][TO];
#pragma unroll
      for (int k = 0; k < TE; ++k)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[k][j] = 0.0f;
      for (int b = 0; on != 0 && b < nb; ++b) {
        const float* wb = ws + static_cast<size_t>(b) * d_in * wpitch + cg * TO;
        float p[TE][TO];
#pragma unroll
        for (int k = 0; k < TE; ++k)
#pragma unroll
          for (int j = 0; j < TO; ++j) p[k][j] = 0.0f;
#pragma unroll 4
        for (int i = 0; i < d_in; ++i) {
          float hv[TE], wv[TO];
#pragma unroll
          for (int q = 0; q < TE; q += 4) {
            const float4 x =
                *reinterpret_cast<const float4*>(hb + i * hpitch + q);
            hv[q] = x.x, hv[q + 1] = x.y, hv[q + 2] = x.z, hv[q + 3] = x.w;
          }
#pragma unroll
          for (int q = 0; q < TO; q += 4) {
            const float4 x =
                *reinterpret_cast<const float4*>(wb + i * wpitch + q);
            wv[q] = x.x, wv[q + 1] = x.y, wv[q + 2] = x.z, wv[q + 3] = x.w;
          }
#pragma unroll
          for (int k = 0; k < TE; ++k)
#pragma unroll
            for (int j = 0; j < TO; ++j)
              p[k][j] = fmaf(hv[k], wv[j], p[k][j]);
        }
#pragma unroll
        for (int k = 0; k < TE; ++k) {
          const float c = cb[k * nb + b];
#pragma unroll
          for (int j = 0; j < TO; ++j) acc[k][j] = fmaf(c, p[k][j], acc[k][j]);
        }
      }
      const int64_t e_first = tile * tile_e + eg * TE;
      const int o0 = c0 + cg * TO;
#pragma unroll
      for (int k = 0; k < TE; ++k) {
        const int64_t e = e_first + k;
        if (e < E) {
          const bool edge_on = (on >> (8 * k)) & 0xff;
#pragma unroll
          for (int j = 0; j < TO; ++j)
            if (o0 + j < d_out)
              out[e * d_out + o0 + j] = edge_on ? acc[k][j] : 0.0f;
        }
      }
    }
    if (t < tile_e) ms[(buf ^ 1) * tile_e + t] = mask_next;
    __syncthreads();  // everyone is done with buf before it is refilled
  }
}

struct BasisPlan {
  int tile_e, threads, slices, cgs, blocks, per_sm;
  size_t smem;
};

struct Card {
  int smem_per_sm, smem_reserved, regs_per_sm, kernel_regs;
};

// The SM's shared memory and registers, and the kernel's registers per
// thread.
cudaError_t card(Card* c) {
  static Card cached = {0, 0, 0, 0};
  if (cached.kernel_regs == 0) {
    int dev = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached.smem_per_sm,
                                 cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached.smem_reserved,
                                 cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached.regs_per_sm,
                                 cudaDevAttrMaxRegistersPerMultiprocessor, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, basis_message_kernel);
    if (e != cudaSuccess) return e;
    cached.kernel_regs = attr.numRegs;
  }
  *c = cached;
  return cudaSuccess;
}

// Blocks of `threads` threads and `smem` bytes that fit on one SM.
int blocks_per_sm(const Card& c, int threads, size_t smem) {
  const int by_smem = static_cast<int>(
      c.smem_per_sm / (smem + static_cast<size_t>(c.smem_reserved)));
  // registers are allocated per warp in units of 256
  const int warp_regs = (c.kernel_regs * 32 + 255) / 256 * 256;
  const int by_regs = c.regs_per_sm / (warp_regs * (threads / 32));
  const int by_threads = 2048 / threads;
  int n = by_smem < by_regs ? by_smem : by_regs;
  return n < by_threads ? n : by_threads;
}

// The column split and edge tile with the most items (edge group, column
// group) resident per SM, then the fewest splits, then the widest tile;
// false if no block fits.
bool basis_plan(const Card& c, int d_in, int d_out, int nb, BasisPlan* plan) {
  const size_t limit = static_cast<size_t>(max_dynamic_smem());
  const int ncg = (d_out + TO - 1) / TO;
  int best = 0;
  for (int slices = 1; slices <= ncg; ++slices) {
    const int cgs = (ncg + slices - 1) / slices;
    if ((ncg + cgs - 1) / cgs != slices) continue;  // the same slice as fewer
    for (int groups = MAX_GROUPS; groups >= 1; --groups) {
      const int items = groups * cgs;
      const int threads = (items + 31) / 32 * 32;
      const size_t smem = basis_smem(nb, d_in, cgs, groups * TE);
      // a thread loads each of a tile's mask bytes
      if (threads > BM_THREADS || threads < groups * TE || smem > limit)
        continue;
      const int resident = items * blocks_per_sm(c, threads, smem);
      if (resident <= best) continue;
      best = resident;
      *plan = BasisPlan{groups * TE, threads, slices, cgs, 0, 0, smem};
    }
  }
  return best > 0;
}

// The plan for E edges with its persistent grid: every block that fits on
// the card, spread over the column slices, at most one per edge tile.
cudaError_t plan_for(int64_t E, int d_in, int d_out, int nb,
                     BasisPlan* plan) {
  Card c;
  cudaError_t e = card(&c);
  if (e != cudaSuccess) return e;
  if (!basis_plan(c, d_in, d_out, nb, plan)) return cudaErrorInvalidValue;
  if (plan->smem > 48 * 1024) {
    e = cudaFuncSetAttribute(basis_message_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan->smem));
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &plan->per_sm, basis_message_kernel, plan->threads, plan->smem);
  if (e != cudaSuccess) return e;
  if (plan->per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t ntiles = (E + plan->tile_e - 1) / plan->tile_e;
  const int64_t blocks = (static_cast<int64_t>(sm_count()) * plan->per_sm +
                          plan->slices - 1) / plan->slices;
  plan->blocks = static_cast<int>(blocks < ntiles ? blocks : ntiles);
  return cudaSuccess;
}

}  // namespace

// The new kernel's plan for E edges: plan[0..6] = edges per tile, threads
// per block, column slices, column groups per slice, blocks per slice,
// resident blocks per SM, shared memory bytes. Returns a cudaError_t.
extern "C" int basis_message_plan(int64_t E, int d_in, int d_out, int nb,
                                  int64_t* out) {
  BasisPlan plan;
  cudaError_t e = plan_for(E > 0 ? E : 1, d_in, d_out, nb, &plan);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t fields[7] = {plan.tile_e, plan.threads, plan.slices, plan.cgs,
                             plan.blocks, plan.per_sm,
                             static_cast<int64_t>(plan.smem)};
  for (int k = 0; k < 7; ++k) out[k] = fields[k];
  return 0;
}

extern "C" int basis_message_f32(const void* h_t, const void* coef,
                                 const void* bases, const void* mask,
                                 void* out, int64_t E, int d_in, int d_out,
                                 int nb, void* stream) {
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  BasisPlan plan;
  cudaError_t e = plan_for(E, d_in, d_out, nb, &plan);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(plan.blocks),
                  static_cast<unsigned>(plan.slices));
  basis_message_kernel<<<grid, plan.threads, plan.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_t), static_cast<const float*>(coef),
      static_cast<const float*>(bases), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), E, d_in, d_out, nb, plan.tile_e, plan.cgs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int basis_message_f32_v1(const void* h_t, const void* coef,
                                    const void* bases, const void* mask,
                                    void* out, int64_t E, int d_in, int d_out,
                                    int nb, void* stream) {
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  int in_smem = 0;
  const int tile = basis_plan_v1(d_in, d_out, nb, &in_smem);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int pitch = d_in | 1;  // odd pitch: rows r and r+4 start in other banks
  const size_t smem = basis_smem_v1(tile, pitch, nb, d_in, d_out, in_smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        basis_message_kernel_v1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((E + tile - 1) / tile);
  basis_message_kernel_v1<<<blocks, V1_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_t), static_cast<const float*>(coef),
      static_cast<const float*>(bases), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), E, d_in, d_out, nb, tile, pitch, in_smem);
  return static_cast<int>(cudaGetLastError());
}

// `max_chunks` bounds chunk_ptr[V] (the caller passes E / CHUNK + V); the
// partial buffer holds max_chunks rows and long_rows V + 1 int64s.
extern "C" int segment_sum_f32(const void* msg, const void* perm,
                               const void* offsets, const void* chunk_ptr,
                               void* agg, void* deg, void* partial,
                               void* long_rows, int V, int d,
                               int64_t max_chunks, void* stream) {
  return static_cast<int>(segsum::launch_scatter(
      static_cast<const float*>(msg), static_cast<const int64_t*>(perm),
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(chunk_ptr), static_cast<float*>(agg),
      static_cast<float*>(deg), static_cast<float*>(partial),
      static_cast<int64_t*>(long_rows), V, d, max_chunks,
      static_cast<cudaStream_t>(stream)));
}

// The first kernel's passes (segsum::launch), the same order and degree.
extern "C" int segment_sum_f32_v1(const void* msg, const void* perm,
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
