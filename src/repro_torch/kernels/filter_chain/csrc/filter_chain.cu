// Fused adaptive CNF filter chain, exact-count survivor gather and zone-map
// statistics for Hopper (sm_90a), exposed through a plain C interface (loaded with ctypes).
//
// ---------------------------------------------------------------------------
// chain_kernel  replaces  _kernel (skip=False), launched by
//               filter_chain_pallas, src/repro/kernels/filter_chain/
//               filter_chain.py:156 and :300.
//
//   What it computes, per logical 2048-row tile (one CTA per tile):
//     * the CNF chain in the device-resident `perm` order: an OR
//       accumulator for the open group ANDs into the row mask when the
//       group closes; rows with gidx >= n_rows never count;
//     * active[t, k] — rows still pending before position k, an exact
//       integer block count written as f32; when it is 0 the whole block
//       skips the predicate (block-uniform short-circuit);
//     * mask i8 for every padded row of the tile;
//     * the monitor lane: every predicate, in user order, on the sampled
//       rows (row mode: (gidx + phase) % collect_rate == 0; block mode: the
//       first 128 lanes of every max(collect_rate*128/tile, 1)-th tile),
//       giving cut[t, P], gcut[t, G] and nmon[t] as exact integer counts;
//     * with `packed` != nullptr, the tile's survivors packed to the front
//       of the tile's own slot by a block-wide exclusive scan (CUB
//       BlockScan), a `fill` tail, and the survivor count cnt[t].
//
//   What bounds it on an H100: device memory. It reads C*R*4 bytes and
//   writes R bytes of mask (plus C*R*4 packed bytes when compacting), i.e.
//   ~0.25-2 flop per byte; only HASHMIX (24 rounds x ~6 flops) adds
//   arithmetic, and only on the rows still pending at its position.
//
//   What the design does about it: each thread owns kRows consecutive rows
//   of the tile in registers (16-byte vector loads of a column slice), so
//   a column is read once per predicate that touches it and the row state
//   (mask, OR accumulator) never leaves registers. A predicate is evaluated
//   only on the rows still pending at its position (row-level laziness:
//   the outputs equal the Pallas kernel's, which evaluates whole tiles),
//   and a thread none of whose rows is pending loads nothing, so settled
//   and decided rows cost no column bytes beyond their 32-byte sector.
//   Counts use warp reductions plus shared-memory integer atomics, so
//   every count is exact and independent of thread scheduling.
//
//   With skip decisions (`pass` / `fail` != nullptr), it replaces
//   _kernel (skip=True) as well (filter_chain.py:164-199, :203-204,
//   :231-235): one i32 pass flag and one fail flag per 128-row sub-tile
//   from the zone-map triage. Rows of a decided sub-tile start
//   non-pending, so `active` counts only ambiguous rows and a fully
//   decided tile takes the block-uniform short-circuit; after the chain,
//   mask |= pass & valid. The monitor lane and the pack are unchanged
//   (pass rows reach the pack through the mask).
//
// compact_gather_kernel  replaces  _gather_kernel, launched by
//               compact_gather_pallas, filter_chain.py:372 and :396.
//
//   The TPU kernel relies on its grid running in order: each step stores a
//   whole packed tile and the next step overwrites the fill tail. CUDA
//   blocks run in no order, so here block t stores exactly
//   min(cnt[t], cap - off[t]) survivors at off[t], and the slots
//   [n_kept, cap) are written with `fill` by a grid-stride loop. Every
//   output slot is written exactly once.
//
//   Bound: survivor bytes read plus C*cap*4 bytes written; coalesced
//   copies along each column row.
//
// tile_stats_kernel  replaces  _stats_kernel, launched by
//               tile_stats_pallas, filter_chain.py:75 and :92.
//
//   Per-column min and max over every 128-row sub-tile of the zero-padded
//   f32[C, Rp], written straight to [C, Rp/128] (the TPU's [T, C, sub]
//   block layout and transpose exist only for Mosaic's lane rule). Both
//   propagate NaN, as jnp.min / jnp.max do: fminf / fmaxf drop NaN, and a
//   dropped NaN would fire tile proofs the reference never fires.
//
//   Bound: device memory, C*Rp*4 bytes read and C*Rp/16 written (48 MiB +
//   0.75 MiB on the paper stream, ~15 us at 3.35 TB/s). One warp per 4
//   consecutive sub-tiles: each lane issues its four 16-byte loads before
//   any reduction (32 lanes x float4 = one sub-tile per load), then a
//   shuffle reduction per sub-tile.
//
// Exactness: HASHMIX computes y*MUL + ADD and y - floor(y/MOD)*MOD with
// separately rounded __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so no
// step is contracted into a fused multiply-add; OP_EQ rounds with rintf
// (half to even, as jnp.round). Never build this file with
// --use_fast_math.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;                 // rows per thread
constexpr int kTile = kThreads * kRows;  // 2048: the logical tile
constexpr int kMaxPreds = 32;  // predicate sets are 32-bit masks
constexpr int kStatTile = 128;           // zone-map sub-tile (STAT_TILE)
constexpr int kStatPerWarp = 4;          // sub-tiles reduced by one warp

constexpr float kMixMul = 1.0000019073486328f;
constexpr float kMixAdd = 0.31830987334251404f;
constexpr float kMixMod = 1048576.0f;

__device__ __forceinline__ float hashmix(float y, int rounds) {
  for (int r = 0; r < rounds; ++r) {
    y = __fadd_rn(__fmul_rn(y, kMixMul), kMixAdd);
    y = __fsub_rn(y, __fmul_rn(floorf(__fdiv_rn(y, kMixMod)), kMixMod));
  }
  return y;
}

__device__ __forceinline__ bool eval_pred(float x, int op, float t1, float t2,
                                          int rounds) {
  switch (op) {
    case 0: return x > t1;
    case 1: return x < t1;
    case 2: return x > t1 && x < t2;
    case 3: return rintf(x) == rintf(t1);
    default: return hashmix(x, rounds < 1 ? 1 : rounds) > t1;
  }
}

// Adds `v` of every thread into *slot. Every thread of the block must call
// it (warp-synchronous reduction), and the caller syncs before reading.
__device__ __forceinline__ void block_add(int* slot, int v) {
  unsigned s = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(v));
  if ((threadIdx.x & 31) == 0 && s != 0u) atomicAdd(slot, static_cast<int>(s));
}

// kRows consecutive floats from a 16-byte aligned address (float4 loads).
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          float (&v)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

// One CTA per logical tile of kTile rows; thread `tid` owns the
// consecutive rows [tid*kRows, tid*kRows + kRows) of its tile.
__global__ void __launch_bounds__(kThreads) chain_kernel(
    const float* __restrict__ cols, int n_cols, long long row_stride,
    const int* __restrict__ col, const int* __restrict__ op,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const int* __restrict__ rounds, const int* __restrict__ perm,
    const int* __restrict__ group, int n_preds, int n_groups,
    const int* __restrict__ meta, int8_t* __restrict__ mask_out,
    float* __restrict__ active, float* __restrict__ cut,
    float* __restrict__ gcut, float* __restrict__ nmon,
    float* __restrict__ packed, int* __restrict__ cnt, float fill,
    const int* __restrict__ pass_t, const int* __restrict__ fail_t) {
  using BlockScan = cub::BlockScan<int, kThreads>;

  __shared__ int s_col[kMaxPreds], s_op[kMaxPreds], s_rounds[kMaxPreds];
  __shared__ int s_perm[kMaxPreds], s_group[kMaxPreds];
  __shared__ float s_t1[kMaxPreds], s_t2[kMaxPreds];
  __shared__ unsigned s_members[kMaxPreds];
  __shared__ int s_alive[kMaxPreds], s_cut[kMaxPreds], s_gcut[kMaxPreds];
  __shared__ int s_nsamp;
  __shared__ typename BlockScan::TempStorage s_scan;

  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  if (tid < n_preds) {
    s_col[tid] = col[tid];
    s_op[tid] = op[tid];
    s_rounds[tid] = rounds[tid];
    s_t1[tid] = t1[tid];
    s_t2[tid] = t2[tid];
    s_perm[tid] = perm[tid];
    s_group[tid] = group[tid];
    s_alive[tid] = 0;
    s_cut[tid] = 0;
  }
  if (tid < n_groups) {
    s_gcut[tid] = 0;
    s_members[tid] = 0u;
  }
  if (tid == 0) s_nsamp = 0;
  __syncthreads();
  if (tid < n_groups) {
    unsigned m = 0u;
    for (int p = 0; p < n_preds; ++p)
      if (s_group[p] == tid) m |= 1u << p;
    s_members[tid] = m;
  }

  const long long n_rows = meta[0];
  const int collect_rate = meta[1];
  const int phase = meta[2];
  const int block_mode = meta[3];
  const long long tile_base = static_cast<long long>(t) * kTile;
  const int lane0 = tid * kRows;

  // skip decisions: a thread's kRows rows lie in one 128-row sub-tile
  bool pass = false, decided = false;
  if (pass_t != nullptr) {
    const long long sub = (tile_base + lane0) / kStatTile;
    pass = pass_t[sub] > 0;
    decided = pass || fail_t[sub] > 0;
  }
  bool valid[kRows], m[kRows], gor[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    valid[r] = tile_base + lane0 + r < n_rows;
    m[r] = valid[r] && !decided;
    gor[r] = false;
  }
  __syncthreads();

  // ----------------------------------------------------------- chain lane
  for (int k = 0; k < n_preds; ++k) {
    const int p = s_perm[k];
    const bool is_first = k == 0 || s_group[s_perm[k - 1]] != s_group[p];
    const bool closes =
        k == n_preds - 1 || s_group[s_perm[k + 1]] != s_group[p];
    bool pend[kRows];
    int local = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pend[r] = is_first ? m[r] : (m[r] && !gor[r]);
      local += pend[r];
    }
    block_add(&s_alive[k], local);
    __syncthreads();
    const int alive = s_alive[k];
    if (tid == 0) active[static_cast<long long>(t) * n_preds + k] =
        static_cast<float>(alive);
    bool res[kRows];
    if (alive > 0 && local > 0) {  // alive: block-uniform tile short-circuit;
      float x[kRows];              // local: a thread with no pending row
                                   // (settled or decided) loads nothing
      load_rows(cols + s_col[p] * row_stride + tile_base + lane0, x);
      const int o = s_op[p], rn = s_rounds[p];
      const float a = s_t1[p], b = s_t2[p];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        res[r] = pend[r] && eval_pred(x[r], o, a, b, rn);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) res[r] = false;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      gor[r] = is_first ? res[r] : (gor[r] || res[r]);
      if (closes) m[r] = m[r] && gor[r];
    }
  }

  if (pass) {  // provably passing sub-tile: its valid rows survive
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = m[r] || valid[r];
  }

  int8_t* mrow = mask_out + tile_base + lane0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) mrow[r] = m[r] ? 1 : 0;

  // ------------------------------------------------- in-tile compaction
  if (packed != nullptr) {
    int local = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) local += m[r];
    int prefix = 0, total = 0;
    BlockScan(s_scan).ExclusiveSum(local, prefix, total);
    for (int c = 0; c < n_cols; ++c) {
      const float* src = cols + c * row_stride + tile_base + lane0;
      float* dst = packed + c * row_stride + tile_base;
      int d = prefix;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (m[r]) dst[d++] = src[r];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (lane0 + r >= total) dst[lane0 + r] = fill;
    }
    if (tid == 0) cnt[t] = total;
  }

  // --------------------------------------------------------- monitor lane
  int tile_stride = collect_rate * 128 / kTile;
  if (tile_stride < 1) tile_stride = 1;
  const bool block_tile = (t + phase) % tile_stride == 0;
  bool samp[kRows];
  int ls = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lane = lane0 + r;
    const long long gidx = tile_base + lane;
    const bool row_s = (gidx + phase) % collect_rate == 0;
    const bool blk_s = block_tile && lane < 128;
    samp[r] = (block_mode == 1 ? blk_s : row_s) && valid[r];
    ls += samp[r];
  }
  block_add(&s_nsamp, ls);
  __syncthreads();
  const int n_samp = s_nsamp;
  if (n_samp > 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!samp[r]) continue;
      const long long row = tile_base + lane0 + r;
      unsigned fails = 0u;
      for (int q = 0; q < n_preds; ++q) {
        const float x = cols[s_col[q] * row_stride + row];
        if (!eval_pred(x, s_op[q], s_t1[q], s_t2[q], s_rounds[q]))
          fails |= 1u << q;
      }
      for (int q = 0; q < n_preds; ++q)
        if (fails >> q & 1u) atomicAdd(&s_cut[q], 1);
      for (int g = 0; g < n_groups; ++g)
        if ((fails & s_members[g]) == s_members[g]) atomicAdd(&s_gcut[g], 1);
    }
  }
  __syncthreads();
  if (tid == 0) nmon[t] = static_cast<float>(n_samp);
  if (tid < n_preds)
    cut[static_cast<long long>(t) * n_preds + tid] =
        static_cast<float>(s_cut[tid]);
  if (tid < n_groups)
    gcut[static_cast<long long>(t) * n_groups + tid] =
        static_cast<float>(s_gcut[tid]);
}

// NaN-propagating min / max (jnp.min / jnp.max semantics).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Sub-tile g of the flat contiguous [C, Rp] input is floats
// [g*128, g*128 + 128) (Rp % 128 == 0), and its summary lands at [C, Rp/128]
// flat index g. Warp w reduces sub-tiles [w*kStatPerWarp, +kStatPerWarp).
__global__ void __launch_bounds__(kThreads) tile_stats_kernel(
    const float* __restrict__ cols, long long n_sub, float* __restrict__ mins,
    float* __restrict__ maxs) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long first = warp * kStatPerWarp;
  if (first >= n_sub) return;  // warp-uniform; n_sub % kStatPerWarp == 0
  float4 q[kStatPerWarp];
#pragma unroll
  for (int j = 0; j < kStatPerWarp; ++j)
    q[j] = reinterpret_cast<const float4*>(cols + (first + j) * kStatTile)
        [lane];
#pragma unroll
  for (int j = 0; j < kStatPerWarp; ++j) {
    float mn = nan_min(nan_min(q[j].x, q[j].y), nan_min(q[j].z, q[j].w));
    float mx = nan_max(nan_max(q[j].x, q[j].y), nan_max(q[j].z, q[j].w));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      mins[first + j] = mn;
      maxs[first + j] = mx;
    }
  }
}

__global__ void __launch_bounds__(kThreads) compact_gather_kernel(
    const float* __restrict__ packed, int n_cols, long long row_stride,
    int tile, int n_tiles, const int* __restrict__ offsets,
    const int* __restrict__ counts, int capacity, float fill,
    float* __restrict__ out) {
  const int t = blockIdx.x;
  const long long total =
      static_cast<long long>(offsets[n_tiles - 1]) + counts[n_tiles - 1];
  const long long n_kept = total < capacity ? total : capacity;
  const int off = offsets[t];
  if (off < capacity) {
    const int room = capacity - off;
    const int n = counts[t] < room ? counts[t] : room;
    for (int c = 0; c < n_cols; ++c) {
      const float* src = packed + c * row_stride +
                         static_cast<long long>(t) * tile;
      float* dst = out + static_cast<long long>(c) * capacity + off;
      for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
    }
  }
  const long long tail = capacity - n_kept;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(t) * blockDim.x + threadIdx.x;
       i < tail * n_cols; i += step) {
    const long long c = i / tail, j = i % tail;
    out[c * capacity + n_kept + j] = fill;
  }
}

}  // namespace

extern "C" int filter_chain_launch(
    const float* cols, int n_cols, long long row_stride, int n_tiles,
    int tile, const int* col, const int* op, const float* t1, const float* t2,
    const int* rounds, const int* perm, const int* group, int n_preds,
    int n_groups, const int* meta, int8_t* mask, float* active, float* cut,
    float* gcut, float* nmon, float* packed, int* cnt, float fill,
    const int* pass_t, const int* fail_t, void* stream) {
  if (tile != kTile || n_preds < 1 || n_preds > kMaxPreds || n_groups < 1 ||
      n_groups > n_preds || n_tiles < 1 ||
      (pass_t == nullptr) != (fail_t == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles), block(kThreads);
  chain_kernel<<<grid, block, 0, s>>>(
      cols, n_cols, row_stride, col, op, t1, t2, rounds, perm, group, n_preds,
      n_groups, meta, mask, active, cut, gcut, nmon, packed, cnt, fill,
      pass_t, fail_t);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tile_stats_launch(const float* cols, long long n_sub,
                                 float* mins, float* maxs, void* stream) {
  if (n_sub < 1 || n_sub % kStatPerWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kWarps = kThreads / 32;
  const long long warps = n_sub / kStatPerWarp;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  tile_stats_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      cols, n_sub, mins, maxs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int compact_gather_launch(const float* packed, int n_cols,
                                     long long row_stride, int tile,
                                     int n_tiles, const int* offsets,
                                     const int* counts, int capacity,
                                     float fill, float* out, void* stream) {
  if (tile != kTile || n_tiles < 1 || capacity < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_gather_kernel<<<n_tiles, kThreads, 0, s>>>(
      packed, n_cols, row_stride, tile, n_tiles, offsets, counts, capacity,
      fill, out);
  return static_cast<int>(cudaGetLastError());
}
