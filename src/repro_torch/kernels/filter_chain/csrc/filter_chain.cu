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
//       integer count written as f32;
//     * mask i8 for every padded row of the tile;
//     * the monitor lane: every predicate, in user order, on the sampled
//       rows (row mode: (gidx + phase) % collect_rate == 0; block mode: the
//       first 128 lanes of every max(collect_rate*128/tile, 1)-th tile),
//       giving cut[t, P], gcut[t, G] and nmon[t] as exact integer counts;
//     * with `packed` != nullptr, the tile's survivors packed to the front
//       of the tile's own slot by a block-wide exclusive scan (CUB
//       BlockScan), a `fill` tail, and the survivor count cnt[t].
//
//   What bounds it on an H100: device memory and the latency of the
//   dependent column loads. The first column is read for every row; later
//   columns only where a row is still pending (on the paper stream ~8% of
//   rows reach the 24-round HASHMIX and ~5% the last predicate), plus the
//   1-byte mask (and C*R*4 packed bytes when compacting). Each later
//   position costs one device-memory round trip for a warp with a pending
//   row there; HASHMIX adds 24 dependent rounds of arithmetic per pending
//   value; the monitor lane adds a few scalar loads per tile.
//
//   What the design does about it:
//     * each thread owns kRows consecutive rows (16-byte vector loads of
//       a column slice), kept as bits of its row masks; a column loaded
//       for one position is reused by later positions on that column,
//       and a thread none of whose rows is pending loads nothing. The
//       first column's load is issued before the set-up;
//     * HASHMIX runs on a per-warp work list: the warp's pending values go
//       to shared memory (a shuffle prefix sum gives each lane its slots),
//       all 32 lanes evaluate them 32 at a time, the bits come back. The
//       arithmetic per value is unchanged, so the results are the same;
//       cheap predicates evaluate in place;
//     * no block barrier in the chain: a warp with no pending row at a
//       position skips it (a warp vote replaces the block short-circuit,
//       which never changed an output), and active[t, k] accumulates by
//       warp reductions and shared-memory atomics, written after the one
//       barrier at the end;
//     * the sampled rows of a tile have a closed form (first lane and
//       stride, one 32-bit modulo per thread); after the chain a warp
//       takes a sampled row, a lane a predicate, and a ballot gives the
//       row's failing set for the groups. Each warp's first row is loaded
//       before the chain, so its latency hides behind it;
//     * one 8-byte mask store per thread, and float4 fill stores in the
//       pack;
//     * 40 registers, no spill, 10.7 KB of shared memory: 6 CTAs per SM.
//       Occupancy is what hides the dependent loads, so the state lives in
//       bit masks and every modulo is taken in 32 bits.
//   Counts use warp reductions plus shared-memory integer atomics, so
//   every count is exact and independent of thread scheduling.
//
//   With skip decisions (`pass` / `fail` != nullptr), it replaces
//   _kernel (skip=True) as well (filter_chain.py:164-199, :203-204,
//   :231-235): one i32 pass flag and one fail flag per 128-row sub-tile
//   from the zone-map triage. A thread's kRows rows lie in one sub-tile,
//   so each thread reads one flag of each. Rows of a decided sub-tile
//   start non-pending, so `active` counts only ambiguous rows and warps
//   of decided sub-tiles skip every position; after the chain,
//   mask |= pass & valid. The monitor lane and the pack are unchanged
//   (pass rows reach the pack through the mask).
//
// compact_gather_kernel  replaces  _gather_kernel, launched by
//               compact_gather_pallas, filter_chain.py:372 and :396.
//
//   Stitches the per-tile packs into f32[C, cap]: tile t stores exactly
//   min(cnt[t], cap - off[t]) survivors of each column at off[t], and the
//   slots [n_kept, cap) of every column hold `fill`. The TPU kernel lets
//   each in-order grid step overwrite the previous tile's tail; CUDA
//   blocks run in no order, so here every output slot is written exactly
//   once.
//
//   Bound: device memory, the survivors read once and C*cap*4 bytes
//   written. Where the capacity is the batch width (`capacity="auto"` on
//   2^22-row batches) ~92% of those bytes are the fill, so the kernel is a
//   write stream with a small copy beside it.
//
//   What the design does about it:
//     * the fill first, per column: a 64-bit column base, a 32-bit index
//       and no division or modulo; a scalar head up to the first 16-byte
//       aligned slot (a column row starts at c*cap + n_kept), float4
//       streaming stores (__stcs: the buffer is not read back here), a
//       scalar tail;
//     * a grid of one float4 of each column's fill per thread, capped at
//       4 waves of the card (8 x 256 threads per SM): the blocks start in
//       order and write one front through each column, where a single
//       wave striding over the whole buffer was 2 us slower;
//     * then the copy, block-strided over tiles, at most 2 tiles per
//       block; a thread loads its slot of every column (kGatherCols at a
//       time) before it stores any. After the fill its latency hides
//       behind the stores still draining; with little fill, half as many
//       blocks as tiles halve the blocks waiting on a round trip.
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
// separately rounded __fmul_rn / __fadd_rn / __fsub_rn, y/MOD as the
// exact-equivalent y * 2^-20, so no step is contracted into a fused
// multiply-add and no division routine remains; OP_EQ rounds with rintf
// (half to even, as jnp.round). Never build this file with
// --use_fast_math.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // rows per thread
constexpr int kTile = kThreads * kRows;  // 2048: the logical tile
constexpr int kMaxPreds = 32;  // predicate sets are 32-bit masks
constexpr int kStatTile = 128;           // zone-map sub-tile (STAT_TILE)
constexpr int kStatPerWarp = 4;          // sub-tiles reduced by one warp
constexpr int kGatherResident = 8;       // 8 x 256 threads fill an SM
constexpr int kGatherWaves = 4;          // the gather's grid, in waves
constexpr int kGatherTilesPerBlock = 2;  // the copy's share of a block
constexpr int kGatherCols = 4;           // columns loaded before a store

constexpr float kMixMul = 1.0000019073486328f;
constexpr float kMixAdd = 0.31830987334251404f;
constexpr float kMixMod = 1048576.0f;
constexpr float kMixInvMod = 1.0f / kMixMod;   // 2^-20, exact

// y / 2^20 and y * 2^-20 are the same real number, so their correctly
// rounded f32 results are the same bits (subnormals included): the
// multiply stands in for the IEEE division the reference spells.
__device__ __forceinline__ float hashmix(float y, int rounds) {
  for (int r = 0; r < rounds; ++r) {
    y = __fadd_rn(__fmul_rn(y, kMixMul), kMixAdd);
    y = __fsub_rn(y, __fmul_rn(floorf(__fmul_rn(y, kMixInvMod)), kMixMod));
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

// kRows consecutive floats from a 16-byte aligned address (float4 loads).
__device__ __forceinline__ void load_rows(const float* __restrict__ p,
                                          float (&v)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

// Exclusive prefix sum of v over the lanes of a full warp.
__device__ __forceinline__ int warp_exclusive_sum(int v, int lane) {
  int s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += u;
  }
  return s - v;
}

// Bits 0-3 of b as the bytes 0/1 of a word: b * 0x00204081 places bit i at
// bit 8i, and the four shifted copies do not overlap.
__device__ __forceinline__ unsigned bits_to_bytes(unsigned b) {
  return ((b & 0xfu) * 0x00204081u) & 0x01010101u;
}

// (a + b) mod m in [0, m) for 0 <= a < 2^31, an i32 b and m >= 1: |a + b|
// fits 32 unsigned bits either way, so no 64-bit division is needed.
__device__ __forceinline__ int mod_nonneg(long long a, int b, int m) {
  const long long v = a + b;
  const unsigned um = static_cast<unsigned>(m);
  if (v >= 0) return static_cast<int>(static_cast<unsigned>(v) % um);
  const unsigned r = static_cast<unsigned>(-v) % um;
  return r == 0u ? 0 : static_cast<int>(um - r);
}

// One CTA per logical tile of kTile rows; thread `tid` owns the
// consecutive rows [tid*kRows, tid*kRows + kRows) of its tile, held as bit
// r of its row masks. A warp moves through the chain on its own; the
// block synchronises after the set-up and to write the tile's counts (and
// in the pack's scan).
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
  __shared__ float s_t1[kMaxPreds], s_t2[kMaxPreds];
  __shared__ int s_step[kMaxPreds];   // perm[k] | opens << 8 | closes << 9
  __shared__ unsigned s_members[kMaxPreds];
  __shared__ int s_alive[kMaxPreds], s_cut[kMaxPreds], s_gcut[kMaxPreds];
  __shared__ int s_samp[3];   // the sampled rows: first, step, count
  __shared__ float s_list[kWarps][32 * kRows];   // per-warp work list
  __shared__ typename BlockScan::TempStorage s_scan;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = blockIdx.x;
  const long long tile_base = static_cast<long long>(t) * kTile;
  const int lane0 = tid * kRows;

  // Position 0 reads its column for every undecided row: start that load
  // first, so that it is in flight during the set-up below. (Rows past
  // n_rows are padding inside the buffer and are never counted.)
  // Skip decisions: a thread's kRows rows lie in one 128-row sub-tile.
  bool pass = false, decided = false;
  if (pass_t != nullptr) {
    const long long sub = (tile_base + lane0) / kStatTile;
    pass = pass_t[sub] > 0;
    decided = pass || fail_t[sub] > 0;
  }
  float x[kRows];      // column xcol of this thread's rows, once loaded
  int xcol = -1;
  if (!decided) {
    xcol = col[perm[0]];
    load_rows(cols + xcol * row_stride + tile_base + lane0, x);
  }

  if (tid < n_preds) {
    s_col[tid] = col[tid];
    s_op[tid] = op[tid];
    s_rounds[tid] = rounds[tid];
    s_t1[tid] = t1[tid];
    s_t2[tid] = t2[tid];
    const int p = perm[tid];
    const bool opens = tid == 0 || group[perm[tid - 1]] != group[p];
    const bool closes = tid == n_preds - 1 || group[perm[tid + 1]] != group[p];
    s_step[tid] = p | (opens ? 0x100 : 0) | (closes ? 0x200 : 0);
    s_alive[tid] = 0;
    s_cut[tid] = 0;
  }
  if (tid < n_groups) {
    unsigned m = 0u;
    for (int p = 0; p < n_preds; ++p)
      if (group[p] == tid) m |= 1u << p;
    s_members[tid] = m;
    s_gcut[tid] = 0;
  }

  const long long n_rows = meta[0];
  const int collect_rate = meta[1];
  const int phase = meta[2];
  const int block_mode = meta[3];
  const long long left = n_rows - tile_base;
  const int lim = left <= 0 ? 0 : (left < kTile ? static_cast<int>(left)
                                                : kTile);

  // The monitor lane's sampled rows of this tile, in closed form: lanes
  // first, first + step, ... below lim (row mode: (gidx + phase) %
  // collect_rate == 0; block mode: the first 128 lanes of every
  // max(collect_rate*128/kTile, 1)-th tile).
  int first = 0, step = 1, n_samp = 0;
  if (lim > 0) {
    if (block_mode == 1) {
      long long stride = static_cast<long long>(collect_rate) * 128 / kTile;
      if (stride < 1) stride = 1;
      if (mod_nonneg(t, phase, static_cast<int>(stride)) == 0)
        n_samp = lim < 128 ? lim : 128;
    } else {
      const int r0 = mod_nonneg(tile_base, phase, collect_rate);
      const int f = r0 == 0 ? 0 : collect_rate - r0;
      step = collect_rate;
      if (f < lim) {
        first = static_cast<int>(f);
        n_samp = (lim - 1 - first) / step + 1;
      }
    }
  }
  // warp w evaluates sampled rows w, w + kWarps, ..., lane q predicate q;
  // its first row is loaded now and evaluated after the chain
  const int warp = tid >> 5;
  float mv = 0.0f;
  if (warp < n_samp && lane < n_preds)
    mv = cols[col[lane] * row_stride + tile_base + first + warp * step];
  if (tid == 0) {   // read back after the chain, so no register holds them
    s_samp[0] = first;
    s_samp[1] = step;
    s_samp[2] = n_samp;
  }

  unsigned valid = 0u;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (lane0 + r < lim) valid |= 1u << r;
  unsigned m = decided ? 0u : valid;   // rows still in the conjunction
  unsigned gor = 0u;                   // OR accumulator of the open group
  __syncthreads();

  // ----------------------------------------------------------- chain lane
  float* list = s_list[warp];
  for (int k = 0; k < n_preds; ++k) {
    const int sk = s_step[k];
    const int p = sk & 0xff;
    const bool is_first = sk & 0x100;
    const unsigned pend = is_first ? m : (m & ~gor);
    const int n_pend = __popc(pend);
    const int w_pend = __reduce_add_sync(0xffffffffu, n_pend);
    unsigned res = 0u;
    if (w_pend > 0) {  // warp-uniform: a warp with no pending row skips
      if (lane == 0) atomicAdd(&s_alive[k], w_pend);
      const int c = s_col[p];
      if (pend != 0u && c != xcol) {  // settled, decided rows load nothing
        load_rows(cols + c * row_stride + tile_base + lane0, x);
        xcol = c;
      }
      const int o = s_op[p];
      const float a = s_t1[p];
      if (o < 0 || o > 3) {
        // HASHMIX: the warp's pending values go to its work list and are
        // evaluated 32 at a time on all lanes, then the bits come back
        const int at = warp_exclusive_sum(n_pend, lane);
        int j = at;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (pend >> r & 1u) list[j++] = x[r];
        __syncwarp();
        const int rn = s_rounds[p] < 1 ? 1 : s_rounds[p];
        for (int i = lane; i < w_pend; i += 32)
          list[i] = hashmix(list[i], rn) > a ? 1.0f : 0.0f;
        __syncwarp();
        j = at;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (pend >> r & 1u) res |= (list[j++] != 0.0f ? 1u : 0u) << r;
        __syncwarp();
      } else if (pend != 0u) {
        const float b = s_t2[p];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if ((pend >> r & 1u) && eval_pred(x[r], o, a, b, 1))
            res |= 1u << r;
      }
    }
    gor = is_first ? res : (gor | res);
    if (sk & 0x200) m &= gor;
  }

  // --------------------------------------------------------- monitor lane
  // every predicate on every sampled row; a ballot gives the row's failing
  // set, and lane g counts group g when it holds every member
  {
    const int first = s_samp[0], step = s_samp[1], n_samp = s_samp[2];
    unsigned n_cut = 0u, n_gcut = 0u;
    for (int i = warp; i < n_samp; i += kWarps) {
      float v = mv;
      if (i != warp && lane < n_preds)
        v = cols[s_col[lane] * row_stride + tile_base + first + i * step];
      const bool fails =
          lane < n_preds &&
          !eval_pred(v, s_op[lane], s_t1[lane], s_t2[lane], s_rounds[lane]);
      const unsigned fb = __ballot_sync(0xffffffffu, fails);
      n_cut += fails;
      if (lane < n_groups && (fb & s_members[lane]) == s_members[lane])
        ++n_gcut;
    }
    if (n_cut) atomicAdd(&s_cut[lane], static_cast<int>(n_cut));
    if (n_gcut) atomicAdd(&s_gcut[lane], static_cast<int>(n_gcut));
  }

  if (pass) m |= valid;  // provably passing sub-tile: its valid rows survive

#pragma unroll
  for (int r = 0; r < kRows; r += 8)   // 8 mask bytes per store
    *reinterpret_cast<uint2*>(mask_out + tile_base + lane0 + r) =
        make_uint2(bits_to_bytes(m >> r), bits_to_bytes(m >> (r + 4)));

  // ------------------------------------------------- in-tile compaction
  if (packed != nullptr) {
    int prefix = 0, total = 0;
    BlockScan(s_scan).ExclusiveSum(__popc(m), prefix, total);
    for (int c = 0; c < n_cols; ++c) {
      float* dst = packed + c * row_stride + tile_base;
      if (m != 0u) {
        float v[kRows];
        if (c == xcol) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r] = x[r];
        } else {
          load_rows(cols + c * row_stride + tile_base + lane0, v);
        }
        int d = prefix;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (m >> r & 1u) dst[d++] = v[r];
      }
      if (lane0 >= total) {
        const float4 f4 = make_float4(fill, fill, fill, fill);
#pragma unroll
        for (int r = 0; r < kRows; r += 4)
          *reinterpret_cast<float4*>(dst + lane0 + r) = f4;
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (lane0 + r >= total) dst[lane0 + r] = fill;
      }
    }
    if (tid == 0) cnt[t] = total;
  }

  __syncthreads();
  if (tid == 0) nmon[t] = static_cast<float>(s_samp[2]);
  if (tid < n_preds) {
    active[static_cast<long long>(t) * n_preds + tid] =
        static_cast<float>(s_alive[tid]);
    cut[static_cast<long long>(t) * n_preds + tid] =
        static_cast<float>(s_cut[tid]);
  }
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

__global__ void __launch_bounds__(kThreads, kGatherResident)
    compact_gather_kernel(const float* __restrict__ packed, int n_cols,
                          long long row_stride, int n_tiles,
                          const int* __restrict__ offsets,
                          const int* __restrict__ counts, int capacity,
                          float fill, float* __restrict__ out) {
  const long long total =
      static_cast<long long>(offsets[n_tiles - 1]) + counts[n_tiles - 1];
  const int n_kept = total < capacity ? static_cast<int>(total) : capacity;

  // the fill of [n_kept, cap) in each column: a scalar head up to the
  // first 16-byte aligned slot, float4 stores, a scalar tail
  const int len = capacity - n_kept;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const float4 f4 = make_float4(fill, fill, fill, fill);
  for (int c = 0; c < n_cols; ++c) {
    float* row = out + static_cast<long long>(c) * capacity + n_kept;
    const unsigned misaligned =
        static_cast<unsigned>(reinterpret_cast<uintptr_t>(row) >> 2) & 3u;
    const int head = min(static_cast<int>((4u - misaligned) & 3u), len);
    const int n4 = (len - head) >> 2;
    if (first < head) row[first] = fill;
    float4* body = reinterpret_cast<float4*>(row + head);
    for (int i = first; i < n4; i += stride) __stcs(body + i, f4);
    const int done = head + 4 * n4;
    if (first < len - done) row[done + first] = fill;
  }

  // the copy: block b stitches tiles b, b + gridDim.x, ...; tile t stores
  // min(cnt[t], cap - off[t]) survivors of each column at off[t]
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int off = offsets[t];
    if (off >= capacity) continue;
    const int n = min(counts[t], capacity - off);
    const float* src = packed + static_cast<long long>(t) * kTile;
    float* dst = out + off;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      for (int c0 = 0; c0 < n_cols; c0 += kGatherCols) {
        float v[kGatherCols];
#pragma unroll
        for (int k = 0; k < kGatherCols; ++k)
          if (c0 + k < n_cols) v[k] = src[(c0 + k) * row_stride + j];
#pragma unroll
        for (int k = 0; k < kGatherCols; ++k)
          if (c0 + k < n_cols)
            dst[static_cast<long long>(c0 + k) * capacity + j] = v[k];
      }
    }
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
  // the SM count, read on the first launch only: the grid size paces the
  // grid-stride loops and nothing else, so it holds on any card
  static std::atomic<int> sm_count{0};
  int n_sm = sm_count.load(std::memory_order_relaxed);
  if (n_sm == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count.store(n_sm, std::memory_order_relaxed);
  }
  // kGatherTilesPerBlock tiles or one float4 of each column's fill per
  // thread, whichever needs more blocks; at most kGatherWaves waves
  const long long want = std::max<long long>(
      (n_tiles + kGatherTilesPerBlock - 1) / kGatherTilesPerBlock,
      (capacity + 4LL * kThreads - 1) / (4LL * kThreads));
  const int blocks = static_cast<int>(std::min<long long>(
      want, static_cast<long long>(n_sm) * kGatherResident * kGatherWaves));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_gather_kernel<<<blocks, kThreads, 0, s>>>(
      packed, n_cols, row_stride, n_tiles, offsets, counts, capacity, fill,
      out);
  return static_cast<int>(cudaGetLastError());
}
