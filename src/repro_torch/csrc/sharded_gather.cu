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
// What bounds it on an H100: bytes, and the latency of two dependent trips
// to device memory (the slot's flat id, then its row). At the mini-batch
// shape (17,200 slots of d = 75 from the 4-shard table) a call moves about
// 10.5 MB, 3.1 us at 3.35 TB/s; at serving sizes (8 to 64 head rows) the
// launch itself is the cost. A row is a plain copy, so the output is
// bitwise the table row (or +0.0).
//
// Design (fused_gather_f32, gather_rows_kernel, whose body
// fused_dequant_gather shares): a warp per group of rows. A warp loads its
// group's flat ids and ownership with one coalesced load, one slot per
// lane (both loads at once), and shares each slot's source row with
// __shfl_sync. It then issues the loads of the whole group, FG_UNITS per
// lane, before it stores any: the group's rows lie back to back in the
// output, so lane l copies units l, l + 32, ... of the group, and several
// independent rows are in flight per warp for one id round trip. A unit is
// a float4 when d % 4 == 0 and the table and output are 16-byte aligned
// (ogbl-citation2, d = 32), else a float (FB15k-237, d = 75: 300-byte
// rows). A group is as many rows as 32 * FG_UNITS units hold (3 at d = 75,
// 32 at d = 32; one row, in passes, when a row is longer), but no more
// than spreads V over FG_SPREAD warps: a serving batch gets a row per
// warp, and that path is compiled on its own (ONE_ROW: every lane reads
// the id, no shuffle, the group a constant), because at 8 rows the call is
// all latency and each instruction on the chain shows. FG_UNITS = 8 and
// FG_WARPS = 4 were chosen by trial on the card (2 to 24 units, 1 to 16
// warps, at the mini-batch and serving shapes).
//
// What held the first kernel back (fused_gather_f32_v1, one block per row):
// 17,200 blocks of 96 threads, 75 of them busy, each a dependent chain of
// id load, row load and store of one 4-byte word a thread; at the SM's 32
// resident blocks about 6 KB in flight per SM, where saturating the memory
// takes about three times that. It is kept so that the chip smoke run can
// hold the new kernel against it bit for bit.
//
// An unowned slot never reads the table. A slot whose flat id lies outside
// the table is a broken plan (the host plan never produces one; the plain
// version raises an index error on it): both kernels write zeros for it
// instead of reading out of bounds, and store the slot (plus one) in a flag
// in pinned host memory. The serving wrapper reads it after every gather
// and raises; the training path reads it once per step, after the loss.
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
// Design (fused_dequant_gather_i8): fused_gather's, the same kernel body
// (gather_rows_kernel) with a load transform per unit. The lane that
// loads a slot's flat id and ownership also loads the row's scale, once,
// right after the id (it needs the id, as the row's codes do, so it adds
// no round trip). All of a lane's loads are issued before any store;
// each unit is dequantized as it is stored, with the scale shared
// by __shfl_sync only then, so that the scale's load is in flight with
// the codes' and not on the way to them. A unit is a char4 read into a
// float4 store when d % 4 == 0, the codes' base is 4-byte aligned and the
// output 16-byte aligned (ogbl-citation2, d = 32: 8 units a row), else one
// byte into one float (FB15k-237, d = 75: its 75-byte rows are not 4-byte
// aligned). A lane keeps DQ_UNITS = 4 loads in flight, not fused_gather's
// 8: a code unit is a quarter of a float unit, and in trials on the card
// (tools/gather_trials.py: 2 to 8 units, 2 to 8 warps a block) 4 beat 8
// at every shape and tied 3 as the fastest at the mini-batch gather
// (d = 75); 2 was faster at d = 32 and slower at d = 75. At d = 75 a
// group is then one row, so the mini-batch gather also takes the ONE_ROW
// path (every lane reads the id and scale, no shuffle), as serving
// batches do.
// The product is __fmul_rn, which no contraction or fast-math flag can
// change: it is exact (an int8 times a power of two, subnormal scales
// included, since the build has no flush-to-zero), so the output is
// bitwise the plain version and the reference's dequantize-then-gather.
// A null row (unowned, or outside the table) loads zero codes and a zero
// scale: +0.0. Unowned slots and the bad-slot flag are as in fused_gather.
//
// What held the first kernel back (fused_dequant_gather_i8_v1, one block
// per output row, kept as the new kernel's bitwise yardstick): what held
// fused_gather's first kernel back. At the mini-batch shape 17,200 blocks
// of 96 threads, 75 of them busy, each block one dependent chain of id,
// then scale and codes, then store, each thread moving one byte in and
// one float out: too little in flight per SM to fill the memory pipe.
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
// real row's chunks) and segment_sum.cuh's passes add each row's slots in
// slot order, in chunks of 32, then the chunk sums in runs (its header has
// the exact order). A row's sum depends only on which slots hit it and in
// what order: a dense gather and a row-sharded one (whose flat row is the
// global id under the row-block layout) get the same bits, and so do a
// deduplicated plan and a plain one. Rows no owned slot hits, layout
// padding included, are 0. scatter_add_f32 runs segsum::launch_scatter.
//
// What held the first kernel back (scatter_add_f32_v1, segsum::launch, the
// passes the RGCN segment sum first ran): at the vertex-state gradient (472,448 slots
// into 17,200 rows, one of them hit by 147,696 padded slots) its combine
// pass took most of the time: a 512-thread block for each of the 17,200
// rows, most of which return at once, and the hub's 16 runs of 289 partial
// rows each walked with 8 loads in flight, serialised on memory latency.
// Its chunk pass searched chunk_ptr 15 dependent loads deep per warp and
// had a lane walk its columns in passes of 32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_sum.cuh"

namespace {

constexpr int FG_WARPS = 4;        // warps per gather block
constexpr int FG_UNITS = 8;        // fused_gather: loads in flight per lane
constexpr int DQ_UNITS = 4;        // fused_dequant_gather: the same
constexpr int64_t FG_SPREAD = 1024;  // warps a small gather spreads over

template <typename T>
__device__ __forceinline__ T zero_unit();
template <>
__device__ __forceinline__ float zero_unit<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ float4 zero_unit<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <>
__device__ __forceinline__ int8_t zero_unit<int8_t>() {
  return 0;
}
template <>
__device__ __forceinline__ char4 zero_unit<char4>() {
  return make_char4(0, 0, 0, 0);
}

// A unit's load transform: what a loaded unit of the source (In) becomes
// in the output (Out). fused_gather copies (no scale); fused_dequant_gather
// multiplies each int8 code by its row's scale with __fmul_rn, the plain
// version's product bit for bit.
template <typename In, typename Out>
struct Unit;
template <>
struct Unit<float, float> {
  static constexpr bool SCALED = false;
  __device__ static float out(float x, float) { return x; }
};
template <>
struct Unit<float4, float4> {
  static constexpr bool SCALED = false;
  __device__ static float4 out(float4 x, float) { return x; }
};
template <>
struct Unit<int8_t, float> {
  static constexpr bool SCALED = true;
  __device__ static float out(int8_t c, float s) {
    return __fmul_rn(static_cast<float>(c), s);
  }
};
template <>
struct Unit<char4, float4> {
  static constexpr bool SCALED = true;
  __device__ static float4 out(char4 c, float s) {
    return make_float4(__fmul_rn(static_cast<float>(c.x), s),
                       __fmul_rn(static_cast<float>(c.y), s),
                       __fmul_rn(static_cast<float>(c.z), s),
                       __fmul_rn(static_cast<float>(c.w), s));
  }
};

// Rows of `w` units (In from the table, Out to the output); each warp
// gathers `group` rows. 32 units are dr rows and dc units (32 / w and
// 32 % w). A scaled gather (Unit<In, Out>::SCALED) also loads the row's
// scale, once, in the lane that loads the slot's id, and shares it at the
// store. ONE_ROW (group == 1, a small V): every lane reads the slot's id
// (and scale) itself (a broadcast) and takes columns lane, lane + 32,
// ...: no shuffle, and less code for each SM to fetch on a launch that is
// all latency.
template <typename In, typename Out, int UNITS, bool ONE_ROW>
__global__ void __launch_bounds__(FG_WARPS * 32)
gather_rows_kernel(const In* __restrict__ table,
                   const float* __restrict__ scales,
                   const int64_t* __restrict__ flat,
                   const uint8_t* __restrict__ owned, Out* __restrict__ out,
                   int64_t rows, int64_t v, int w, int group, int dr, int dc,
                   int64_t* __restrict__ bad_slot) {
  using U = Unit<In, Out>;
  const int g = ONE_ROW ? 1 : group;  // a constant on the one-row path
  const int lane = threadIdx.x & 31;
  const int64_t v0 =
      (static_cast<int64_t>(blockIdx.x) * FG_WARPS + threadIdx.x / 32) * g;
  if (v0 >= v) return;  // the whole warp
  const int nrows = static_cast<int>(v - v0 < g ? v - v0 : g);
  // slot v0 + r's table row (null: write zeros) and scale (0 for a null
  // row, so that its zero codes give +0.0), in lane r < nrows
  const int slot = ONE_ROW ? 0 : lane;
  const In* src = nullptr;
  float scale = 0.0f;
  if (slot < nrows) {
    const int64_t f = flat[v0 + slot];
    const bool own = owned[v0 + slot] != 0;  // loaded beside the id
    const bool in_table = f >= 0 && f < rows;
    if (!in_table) *bad_slot = v0 + slot + 1;
    if (in_table && own) {
      src = table + f * w;
      if (U::SCALED) scale = scales[f];  // beside the row's first loads
    }
  }
  const int n = nrows * w;
  Out* dst = out + v0 * w;
  // unit u = lane + 32 k of the group lies in row r, column c; both step by
  // 32 units without a division
  int r = 0, c = lane;
  if (!ONE_ROW && lane >= w) {
    r = lane / w;
    c = lane - r * w;
  }
  for (int base = 0; base < n; base += 32 * UNITS) {
    In val[UNITS];
    int from[UNITS];  // the lane holding unit k's row and scale
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int u = base + lane + 32 * k;
      if (base + 32 * k < n) {  // the same for the whole warp
        const In* row = src;
        if (!ONE_ROW) {
          row = reinterpret_cast<const In*>(__shfl_sync(
              0xffffffffu, reinterpret_cast<unsigned long long>(src), r));
          from[k] = r;
          r += dr;
        }
        val[k] = u < n && row ? row[ONE_ROW ? u : c] : zero_unit<In>();
        if (!ONE_ROW) {
          c += dc;
          if (c >= w) {
            c -= w;
            ++r;
          }
        }
      }
    }
    // the scales are shuffled only now, so that their loads are in flight
    // with the rows' and not on the way to them
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      float sk = scale;
      if (!ONE_ROW && U::SCALED && base + 32 * k < n)  // warp-uniform
        sk = __shfl_sync(0xffffffffu, scale, from[k]);
      const int u = base + lane + 32 * k;
      if (u < n) dst[u] = U::out(val[k], sk);
    }
  }
}

// blocks and rows per warp for V slots of w units: as many rows as fill a
// warp's loads (32 * units), fewer when V is small so that the rows spread
// over up to FG_SPREAD warps
unsigned gather_grid(int64_t v, int w, int units, int* group) {
  int64_t g = 32 * units / w;
  const int64_t spread = (v + FG_SPREAD - 1) / FG_SPREAD;
  if (spread < g) g = spread;
  g = g < 1 ? 1 : g > 32 ? 32 : g;
  *group = static_cast<int>(g);
  const int64_t warps = (v + g - 1) / g;
  return static_cast<unsigned>((warps + FG_WARPS - 1) / FG_WARPS);
}

template <typename In, typename Out, int UNITS>
void launch_gather(cudaStream_t s, const void* table, const float* scales,
                   const int64_t* flat, const uint8_t* owned, void* out,
                   int64_t rows, int64_t v, int w, int64_t* bad) {
  int group = 1;
  const unsigned blocks = gather_grid(v, w, UNITS, &group);
  const In* t = static_cast<const In*>(table);
  Out* o = static_cast<Out*>(out);
  if (group == 1)
    gather_rows_kernel<In, Out, UNITS, true><<<blocks, FG_WARPS * 32, 0, s>>>(
        t, scales, flat, owned, o, rows, v, w, 1, 32 / w, 32 % w, bad);
  else
    gather_rows_kernel<In, Out, UNITS, false><<<blocks, FG_WARPS * 32, 0, s>>>(
        t, scales, flat, owned, o, rows, v, w, group, 32 / w, 32 % w, bad);
}

__global__ void fused_gather_kernel_v1(const float* __restrict__ table,
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

__global__ void fused_dequant_gather_kernel_v1(
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
  const bool vec = d % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(table) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* f = static_cast<const int64_t*>(flat);
  const uint8_t* o = static_cast<const uint8_t*>(owned);
  int64_t* bad = static_cast<int64_t*>(bad_slot);
  if (vec)
    launch_gather<float4, float4, FG_UNITS>(s, table, nullptr, f, o, out,
                                            rows, v, d / 4, bad);
  else
    launch_gather<float, float, FG_UNITS>(s, table, nullptr, f, o, out, rows,
                                          v, d, bad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_gather_f32_v1(const void* table, const void* flat,
                                   const void* owned, void* out, int64_t rows,
                                   int64_t v, int d, void* bad_slot_host,
                                   void* stream) {
  if (v <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  void* bad_slot = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&bad_slot, bad_slot_host, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_gather_kernel_v1<<<static_cast<unsigned>(v), row_threads(d), 0,
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
  // a char4 unit needs 4-byte code rows (d % 4 == 0 and an aligned base)
  // and a 16-byte aligned output for its float4 store
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const int64_t* f = static_cast<const int64_t*>(flat);
  const uint8_t* o = static_cast<const uint8_t*>(owned);
  int64_t* bad = static_cast<int64_t*>(bad_slot);
  if (vec)
    launch_gather<char4, float4, DQ_UNITS>(s, codes, sc, f, o, out, rows, v,
                                           d / 4, bad);
  else
    launch_gather<int8_t, float, DQ_UNITS>(s, codes, sc, f, o, out, rows, v,
                                           d, bad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_dequant_gather_i8_v1(const void* codes,
                                          const void* scales,
                                          const void* flat,
                                          const void* owned, void* out,
                                          int64_t rows, int64_t v, int d,
                                          void* bad_slot_host,
                                          void* stream) {
  if (v <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  void* bad_slot = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&bad_slot, bad_slot_host, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_dequant_gather_kernel_v1<<<static_cast<unsigned>(v), row_threads(d),
                                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<const int64_t*>(flat), static_cast<const uint8_t*>(owned),
      static_cast<float*>(out), rows, d, static_cast<int64_t*>(bad_slot));
  return static_cast<int>(cudaGetLastError());
}

// `max_chunks` bounds the chunk count (the caller passes V / CHUNK + R); the
// partial buffer holds max_chunks rows of d and long_rows R + 1 int64s.
// scatter_add_f32 runs segsum::launch_scatter (the RGCN segment sum's
// passes too); scatter_add_f32_v1, the first kernel, runs segsum::launch
// and is kept so that the chip smoke run can hold the new passes against it
// bit for bit.
extern "C" int scatter_add_f32(const void* g, const void* perm,
                               const void* offsets, const void* chunk_ptr,
                               void* out, void* partial, void* long_rows,
                               int R, int d, int64_t max_chunks,
                               void* stream) {
  return static_cast<int>(segsum::launch_scatter(
      static_cast<const float*>(g), static_cast<const int64_t*>(perm),
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(chunk_ptr), static_cast<float*>(out),
      nullptr, static_cast<float*>(partial),
      static_cast<int64_t*>(long_rows), R, d, max_chunks,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int scatter_add_f32_v1(const void* g, const void* perm,
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
