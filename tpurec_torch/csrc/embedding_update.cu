// Sorted-stream embedding kernels for Hopper (sm_90a), fp32.
//
// 1. fused_scatter_add: the dense (V, D) aggregated gradient of an id-sorted
//    stream of N gradient rows,
//        G[sids[j]] += grads[j]   for j < N,   G = 0 on rows no id touches.
//    Replaces the Pallas TPU kernel tpurec/ops/pallas/embedding_update.py:
//    fused_scatter_add (_scatter_pass_k / _scatter_kernel_body). Same function
//    as scatter_add_reference, summed in fp32 (the TPU kernel's one-hot
//    matmuls round to bf16 at default MXU precision; that is not copied).
// 2. gather_rows_sorted: rows[j] = table[sids[j]] for j < N. Replaces
//    embedding_update.py:gather_rows_sorted (_gather_kernel).
//
// What bounds them on an H100: bytes. #1 reads N*D grads and N ids once and
// writes all of G once. At the FM benchmark shape (N = 212,992, V =
// 2,080,128, D = 32) the zero-fill of G is 266 MB of the ~294 MB (~88 us at
// 3.35 TB/s); it cannot be skipped, since Adam decays every row's moments
// (the dense-parity contract of the fused engine). At DIN's shape (N =
// 548,864, V = 21,504) the grads dominate (~70 MB, ~22 us). At D = 1 the
// whole call is ~10 MB (~3 us), so there latency and launches set the time.
// #2 reads N ids and N rows and writes N rows (~55 MB at the FM shape).
//
// Design of #1. The TPU kernel's packed lanes, two tile passes and one-hot
// matmuls are TPU tiling; a sorted stream is a segmented sum. One launch of
// two kinds of block, tile blocks first. A block waits only on blocks
// before it, which the card has started already, so every wait ends:
//   - a tile block sums a tile of kWarps slices of the stream, one warp a
//     slice. A lane holds VW columns of a row (VW = 4, one 16-byte load,
//     where D is a multiple of 4, else 1) and DL lanes a row (D / VW rounded
//     up to a power of two, at most 32), so a step of the warp is P = 32 /
//     DL rows: at D = 1 all 32 lanes load a row each, at D = 32 a step is 4
//     rows of 8 lanes (wider D loops over chunks of 32 VW columns). A slice
//     is one round of kUnroll steps where P >= 8, four rounds where P < 8,
//     all kUnroll steps of a round loaded before any is summed. A step's runs
//     of equal ids are summed by a segmented scan down its rows (shuffles up,
//     added where the ids agree); the open run carries from step to step; a
//     run that ends inside the slice is written to its row of G. A run that
//     crosses a slice boundary leaves a partial per slice: the first piece
//     of a slice whose run came from before in warp_head, the last piece of
//     one whose run goes on in warp_tail. When the block's warps are done,
//     warp 0 loads its tile's partials at once, folds them in slice order,
//     writes the runs that end inside the tile, leaves one partial per tile
//     for a run that crosses a tile boundary (tile_head, tile_tail) and marks
//     the tile ready. The tile where such a run ends finishes it: it finds
//     the tile where the run began (a warp probes 1, 2, 4, ... rows back,
//     then a 32-way search), waits until the tiles between are ready, and
//     adds their partials, tile by tile where they are at most kShortRun,
//     else in kWarps contiguous stripes (lanes across partials where D < 32,
//     a fixed butterfly across them) and then the stripes in warp order;
//   - a zero block owns a range of G's rows: it finds its part of the sorted
//     stream (two warp-wide 32-way searches, at once), marks the rows some
//     id touches (a scan of that part, or a binary search a row where the
//     part is long) and writes zeros on every other row, lanes across rows
//     and 16-byte columns. Each element of G is so written once, and no
//     memset or second kernel runs: at D = 1 the gap a launch leaves on the
//     card is about as long as the bytes take.
// The longest run (DIN's padding id 0, ~197k rows) is thus summed by ~1,500
// warps and then ~190 tile partials, never serialised on one warp. Every sum
// is taken in an order fixed by N and D, with no atomics: two calls give the
// same bits. Ids outside [0, V) are dropped, as a TPU/XLA scatter drops
// them: no zero block's range holds them and no run writes them. The ready
// marks are 64-bit values new to each call (the wrapper draws them at
// random), since the scratch that holds them is not cleared.
//
// Design of #2: one block per slice of kGatherRows rows; its threads copy
// (row, 16-byte vector) pairs when D is a multiple of 4 and both tables are
// 16-byte aligned, else single floats. Ids outside [0, V) give zero rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;           // steps of loads in flight per warp
constexpr int kShortRun = 8;         // tile partials one warp adds alone
constexpr int kZeroFloats = 16384;   // floats of G per zero block, at most
constexpr int kZeroIds = 2048;       // ids per zero block, on average, at most
constexpr int kScanIds = 4096;       // a zero block scans a part this long, else searches
constexpr int kGatherRows = 64;      // rows per gather block
constexpr long long kSpinLimit = 1ll << 26;  // polls before a waiting tile gives up (a fault)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool in_table(int id, int64_t V) { return id >= 0 && id < V; }

__host__ __device__ constexpr int pow2_at_least(int x) {
  int w = 1;
  while (w < x && w < 32) w <<= 1;
  return w;
}

// columns a lane of a tile block holds: 4 (a 16-byte load) where D allows
__host__ __device__ constexpr int vec_width(int D) { return D % 4 == 0 ? 4 : 1; }

// lanes a row of the stream takes in a tile block
__host__ __device__ constexpr int row_lanes(int D) {
  return pow2_at_least((D + vec_width(D) - 1) / vec_width(D));
}

// steps of a tile-block warp over its slice, at P rows a step: one round
// of loads where a step is many rows, four where it is few
__host__ __device__ constexpr int slice_steps(int P) { return P >= 8 ? kUnroll : 4 * kUnroll; }

// rows of the stream that one tile-block warp sums
__host__ __device__ constexpr int64_t slice_rows(int D) {
  return static_cast<int64_t>(slice_steps(32 / row_lanes(D))) * (32 / row_lanes(D));
}

// first index of the sorted sids[lo, hi) whose id is >= key (hi if none),
// found by the whole warp: 32 probes a round, ~log32(hi - lo) rounds
__device__ int64_t warp_lower_bound(const int* __restrict__ sids, int64_t lo, int64_t hi,
                                    int64_t key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {  // the answer lies in [lo, hi]
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + (lane + 1) * step - 1;  // the last index of lane's chunk
    const unsigned ge = __ballot_sync(kFull, p >= hi || sids[p] >= key);
    if (ge == 0) return hi;
    const int f = __ffs(ge) - 1;
    hi = lo + (f + 1) * step - 1 < hi ? lo + (f + 1) * step - 1 : hi;
    lo += f * step;
  }
  const int64_t p = lo + lane;
  const unsigned ge = __ballot_sync(kFull, p >= hi || sids[p] >= key);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

template <int VW>
struct Vec {
  float v[VW];
};

template <int VW>
__device__ __forceinline__ Vec<VW> load_vec(const float* p) {
  Vec<VW> x;
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x.v[0] = t.x;
    x.v[1] = t.y;
    x.v[2] = t.z;
    x.v[3] = t.w;
  } else {
    x.v[0] = *p;
  }
  return x;
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const Vec<VW>& x) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
    *p = x.v[0];
  }
}

// where a complete piece of the run of `id` inside a slice goes: the slice's
// first piece of a run carried in from before to warp_head, its last piece
// of a run that goes on to warp_tail, any other run to its row of G
template <int VW>
__device__ __forceinline__ void emit_piece(const Vec<VW>& v, int id, int first_id, int last_id,
                                           bool head_carried, bool tail_open, float* warp_head,
                                           float* warp_tail, float* G, int64_t slice, int D,
                                           int d, int64_t V) {
  if (head_carried && id == first_id) {
    store_vec<VW>(warp_head + slice * D + d, v);
  } else if (tail_open && id == last_id) {
    store_vec<VW>(warp_tail + slice * D + d, v);
  } else if (in_table(id, V)) {
    store_vec<VW>(G + static_cast<int64_t>(id) * D + d, v);
  }
}

// floats the ready marks of `tiles` tiles take, rounded up so that the
// partials after them stay 16-byte aligned
__host__ __device__ constexpr int64_t ready_floats(int64_t tiles) { return (2 * tiles + 3) / 4 * 4; }

struct Scratch {  // the partials of runs that cross slices and tiles
  float* warp_head;
  float* warp_tail;
  float* tile_head;
  float* tile_tail;
  unsigned long long* ready;  // ready[t] == nonce once tile t's partials are written
};

// a tile block's warps: each sums its slice (see the design note)
template <int VW, int DL>
__device__ void walk_slice(const int* __restrict__ sids, const float* __restrict__ grads,
                           float* __restrict__ G, const Scratch& sc, int64_t n, int D, int64_t V,
                           int64_t tile, int* first_ids, int* last_ids, int* flags) {
  constexpr int P = 32 / DL;  // rows a step
  constexpr int64_t W = static_cast<int64_t>(slice_steps(P)) * P;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = lane / DL, c = lane % DL;
  const int64_t slice = tile * kWarps + warp;
  const int64_t a = slice * W;
  const int64_t b = a + W < n ? a + W : n;
  if (a >= n) return;
  const int first_id = sids[a];
  const int last_id = sids[b - 1];
  // the slice's first run began in an earlier slice; its last run goes on
  const bool head_carried = a > 0 && sids[a - 1] == first_id;
  const bool tail_open = b < n && sids[b] == last_id;
  if (lane == 0) {
    first_ids[warp] = first_id;
    last_ids[warp] = last_id;
    flags[warp] = (head_carried ? 1 : 0) | (tail_open ? 2 : 0);
  }
  for (int d0 = 0; d0 < D; d0 += DL * VW) {
    const int d = d0 + c * VW;  // this lane's first column
    const bool live = d < D;
    int cur = first_id;  // the open run, and its sum so far in this lane's columns
    Vec<VW> carry;
#pragma unroll
    for (int j = 0; j < VW; ++j) carry.v[j] = 0.f;
    for (int64_t s0 = a; s0 < b; s0 += static_cast<int64_t>(kUnroll) * P) {
      int ids[kUnroll];
      Vec<VW> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = s0 + static_cast<int64_t>(u) * P + q;
        ids[u] = r < b ? sids[r] : cur;
        if (r < b && live) {
          x[u] = load_vec<VW>(grads + r * D + d);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) x[u].v[j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t base = s0 + static_cast<int64_t>(u) * P;
        if (base < b) {  // the same for the whole warp
          const int rows = b - base < P ? static_cast<int>(b - base) : P;
          const int id = ids[u];
          // the open run ends before this step
          const int id0 = P > 1 ? __shfl_sync(kFull, id, c) : id;
          if (id0 != cur) {
            if (q == 0 && live) {
              emit_piece<VW>(carry, cur, first_id, last_id, head_carried, tail_open,
                             sc.warp_head, sc.warp_tail, G, slice, D, d, V);
            }
            cur = id0;
#pragma unroll
            for (int j = 0; j < VW; ++j) carry.v[j] = 0.f;
          }
          // segmented inclusive scan down the step's rows (sorted ids: equal
          // ids at both ends mean one run in between)
#pragma unroll
          for (int k = 1; k < P; k <<= 1) {
            const int yid = __shfl_up_sync(kFull, id, k * DL);
#pragma unroll
            for (int j = 0; j < VW; ++j) {
              const float y = __shfl_up_sync(kFull, x[u].v[j], k * DL);
              if (q >= k && yid == id) x[u].v[j] += y;
            }
          }
          if (id == cur) {
#pragma unroll
            for (int j = 0; j < VW; ++j) x[u].v[j] += carry.v[j];
          }
          if constexpr (P > 1) {
            // a run that ends inside the step is complete
            const int next = __shfl_down_sync(kFull, id, DL);
            if (q + 1 < rows && next != id && live) {
              emit_piece<VW>(x[u], id, first_id, last_id, head_carried, tail_open, sc.warp_head,
                             sc.warp_tail, G, slice, D, d, V);
            }
            // the step's last row carries on
            const int src = (rows - 1) * DL + c;
#pragma unroll
            for (int j = 0; j < VW; ++j) carry.v[j] = __shfl_sync(kFull, x[u].v[j], src);
            cur = __shfl_sync(kFull, id, src);
          } else {
            carry = x[u];
            cur = id;
          }
        }
      }
    }
    if (q == 0 && live) {
      emit_piece<VW>(carry, cur, first_id, last_id, head_carried, tail_open, sc.warp_head,
                     sc.warp_tail, G, slice, D, d, V);
    }
  }
}

// warp 0 of a tile block: fold the slices' partials in slice order, write the
// runs that end inside the tile, leave one partial per tile for a run that
// crosses a tile boundary; returns whether the tile's first run came from an
// earlier tile and ends inside this one (the tile then finishes it)
__device__ bool fold_tile(float* __restrict__ G, const Scratch& sc, int64_t n, int D, int64_t V,
                          int64_t tile, int64_t W, const int* first_ids, const int* last_ids,
                          const int* flags) {
  const int lane = threadIdx.x & 31;
  const int64_t t0 = tile * kWarps;
  int slices = 0;  // live slices of the tile
  while (slices < kWarps && (t0 + slices) * W < n) ++slices;
  bool finish = false;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool live = d < D;
    float head[kWarps], tail[kWarps];  // every partial of the column, loaded at once
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const bool hc = w < slices && (flags[w] & 1), to = w < slices && (flags[w] & 2);
      const bool whole = hc && to && first_ids[w] == last_ids[w];  // one run through the slice
      head[w] = live && hc ? sc.warp_head[(t0 + w) * D + d] : 0.f;
      tail[w] = live && to && !whole ? sc.warp_tail[(t0 + w) * D + d] : 0.f;
    }
    float acc = 0.f;
    bool open = false, from_prev = false;
    int id = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < slices) {
        const bool hc = flags[w] & 1, to = flags[w] & 2;
        const bool whole = hc && to && first_ids[w] == last_ids[w];
        if (hc) {
          if (w == 0) {
            acc = head[0];
            from_prev = true;
          } else {
            acc += head[w];
          }
          open = true;
          if (!whole) {  // the run ends inside slice w
            if (from_prev) {
              if (live) sc.tile_head[tile * D + d] = acc;
              finish = true;
            } else if (live && in_table(id, V)) {
              G[static_cast<int64_t>(id) * D + d] = acc;
            }
            open = false;
          }
        }
        if (to && !whole) {
          acc = tail[w];
          open = true;
          from_prev = false;
          id = last_ids[w];
        }
      }
    }
    if (open && live) {
      if (from_prev) {
        sc.tile_head[tile * D + d] = acc;  // the run goes through the whole tile
      } else {
        sc.tile_tail[tile * D + d] = acc;
      }
    }
  }
  return finish;
}

// the first position of the run of `id` that holds pos - 1 and pos, found
// by the whole warp: lane l probes pos - 2^l, then a 32-way search
__device__ int64_t warp_run_start(const int* __restrict__ sids, int64_t pos, int id) {
  const int lane = threadIdx.x & 31;
  const int64_t p = pos - (int64_t{1} << lane);
  const unsigned before = __ballot_sync(kFull, p < 0 || sids[p] < id);
  const int f = __ffs(before) - 1;  // f >= 1, since sids[pos - 1] == id
  const int64_t lo = pos - (int64_t{1} << f) + 1 > 0 ? pos - (int64_t{1} << f) + 1 : 0;
  return warp_lower_bound(sids, lo, pos - (int64_t{1} << (f - 1)), id);
}

// a tile block that finishes a run begun in tile s: it waits until tiles
// s .. tile-1 have written their partials, then adds tile_tail[s] and
// tile_head[s+1 .. tile] (its own piece last): one warp tile by tile for at
// most kShortRun partials, else all warps in kWarps contiguous stripes
// (lanes across partials where D < 32, a fixed butterfly across them), then
// the stripes in warp order
__device__ void finish_run(float* __restrict__ G, const Scratch& sc, int D, int64_t V,
                           int64_t tile, int64_t s, int id, unsigned long long nonce,
                           float (*stripe)[32]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t k = tile - s;
  if (warp == 0) {
    const volatile unsigned long long* ready = sc.ready;
    for (int64_t j0 = s; j0 < tile; j0 += 32) {
      const int64_t j = j0 + lane;
      long long spins = 0;
      while (!__all_sync(kFull, j >= tile || ready[j] == nonce)) {
        if (++spins > kSpinLimit) __trap();
        __nanosleep(100);
      }
    }
    __threadfence();
    if (k <= kShortRun) {
      for (int d = lane; d < D; d += 32) {
        float total = __ldcg(sc.tile_tail + s * D + d);
        for (int64_t j = s + 1; j <= tile; ++j) total += __ldcg(sc.tile_head + j * D + d);
        if (in_table(id, V)) G[static_cast<int64_t>(id) * D + d] = total;
      }
    }
  }
  if (k <= kShortRun) return;  // the same for the whole block
  __syncthreads();
  const int dl = pow2_at_least(D);
  const int P = 32 / dl;
  const int q = lane / dl, c = lane % dl;
  const int64_t per = (k + kWarps - 1) / kWarps;
  const int64_t j0 = s + 1 + warp * per;
  const int64_t j1 = j0 + per < tile + 1 ? j0 + per : tile + 1;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + c;
    float acc = 0.f;
    if (d < D) {
#pragma unroll 8
      for (int64_t j = j0 + q; j < j1; j += P) acc += __ldcg(sc.tile_head + j * D + d);
    }
    // the stripe's P sub-rows, by a butterfly (every lane of a column ends
    // with the same sum)
    for (int m = dl; m < 32; m <<= 1) acc += __shfl_xor_sync(kFull, acc, m);
    if (q == 0) stripe[warp][c] = acc;
    __syncthreads();
    if (warp == 0 && q == 0 && d < D) {
      float total = __ldcg(sc.tile_tail + s * D + d);
      for (int w = 0; w < kWarps; ++w) total += stripe[w][c];
      if (in_table(id, V)) G[static_cast<int64_t>(id) * D + d] = total;
    }
    __syncthreads();
  }
}

// a zero block: zeros on the rows of [r0, r0 + zero_rows) that no id touches
__device__ void zero_rows_untouched(const int* __restrict__ sids, float* __restrict__ G,
                                    int64_t n, int D, int64_t V, int64_t r0, int zero_rows,
                                    unsigned char* touched, int64_t* range) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = static_cast<int>(V - r0 < zero_rows ? V - r0 : zero_rows);
  if (warp < 2) {  // where the stream reaches r0 and r0 + rows, at once
    const int64_t r = warp_lower_bound(sids, 0, n, warp == 0 ? r0 : r0 + rows);
    if (lane == 0) range[warp] = r;
  }
  for (int i = threadIdx.x; i < rows; i += kThreads) touched[i] = 0;
  __syncthreads();
  const int64_t lo = range[0], hi = range[1];
  if (hi - lo <= kScanIds) {
    for (int64_t j = lo + threadIdx.x; j < hi; j += kThreads) touched[sids[j] - r0] = 1;
  } else {
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      int64_t l = lo, h = hi;
      while (l < h) {
        const int64_t mid = l + (h - l) / 2;
        if (sids[mid] < r0 + i) l = mid + 1; else h = mid;
      }
      touched[i] = l < hi && sids[l] == r0 + i;
    }
  }
  __syncthreads();
  // lanes across (row, unit), a unit 16 bytes where D allows
  float* g = G + r0 * D;
  const bool vec = D % 4 == 0 && (reinterpret_cast<uintptr_t>(G) & 15) == 0;
  const int units = vec ? D / 4 : D;
  const int ul = pow2_at_least(units);  // lanes a row
  const int shift = __ffs(ul) - 1;
  const int rq = lane >> shift, uc = lane & (ul - 1);
  for (int row = warp * (32 >> shift) + rq; row < rows; row += kWarps * (32 >> shift)) {
    if (touched[row]) continue;
    if (vec) {
      float4* dst = reinterpret_cast<float4*>(g + static_cast<int64_t>(row) * D);
      for (int u = uc; u < units; u += ul) dst[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float* dst = g + static_cast<int64_t>(row) * D;
      for (int u = uc; u < units; u += ul) dst[u] = 0.f;
    }
  }
}

// blocks [0, num_tiles) are tile blocks, the rest zero blocks
template <int VW, int DL>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const int* __restrict__ sids, const float* __restrict__ grads, float* __restrict__ G,
    Scratch sc, int64_t n, int D, int64_t V, int64_t num_tiles, int zero_rows,
    unsigned long long nonce) {
  __shared__ unsigned char touched[kZeroFloats];
  __shared__ int64_t range[2];
  __shared__ int first_ids[kWarps], last_ids[kWarps], flags[kWarps];
  __shared__ int64_t run_start;  // of the run this tile finishes, or -1
  __shared__ float stripe[kWarps][32];
  const int64_t block = blockIdx.x;
  if (block >= num_tiles) {
    zero_rows_untouched(sids, G, n, D, V, (block - num_tiles) * zero_rows, zero_rows, touched,
                        range);
    return;
  }
  const int64_t tile = block;
  constexpr int64_t W = slice_steps(32 / DL) * static_cast<int64_t>(32 / DL);
  walk_slice<VW, DL>(sids, grads, G, sc, n, D, V, tile, first_ids, last_ids, flags);
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool finish = fold_tile(G, sc, n, D, V, tile, W, first_ids, last_ids, flags);
    __threadfence();  // the tile's partials, before its ready mark
    __syncwarp();
    if (threadIdx.x == 0) {
      atomicExch(sc.ready + tile, nonce);
      run_start = -1;
    }
    if (finish) {
      const int64_t start = warp_run_start(sids, tile * kWarps * W, first_ids[0]);
      if (threadIdx.x == 0) run_start = start;
    }
  }
  __syncthreads();
  if (run_start >= 0) {
    finish_run(G, sc, D, V, tile, run_start / (kWarps * W), first_ids[0], nonce, stripe);
  }
}

template <int VW, int DL>
cudaError_t launch_scatter(const int* sids, const float* grads, float* G, float* scratch,
                           int64_t n, int D, int64_t V, unsigned long long nonce,
                           cudaStream_t stream) {
  const int64_t slices = (n + slice_rows(D) - 1) / slice_rows(D);
  const int64_t tiles = (slices + kWarps - 1) / kWarps;
  Scratch sc;
  sc.ready = reinterpret_cast<unsigned long long*>(scratch);
  sc.warp_head = scratch + ready_floats(tiles);
  sc.warp_tail = sc.warp_head + slices * D;
  sc.tile_head = sc.warp_tail + slices * D;
  sc.tile_tail = sc.tile_head + tiles * D;
  // rows of G per zero block: at most kZeroFloats floats and, on average,
  // kZeroIds ids of the stream (at least 32 rows), a power of two
  int64_t zero_rows = kZeroFloats / D > 1 ? kZeroFloats / D : 1;
  if (n > 0) {
    const int64_t by_ids = V * kZeroIds / n > 32 ? V * kZeroIds / n : 32;
    zero_rows = zero_rows < by_ids ? zero_rows : by_ids;
  }
  int64_t p = 1;
  while (p * 2 <= zero_rows) p *= 2;
  zero_rows = p;
  const int64_t zero_blocks = (V + zero_rows - 1) / zero_rows;
  scatter_kernel<VW, DL><<<static_cast<unsigned>(tiles + zero_blocks), kThreads, 0, stream>>>(
      sids, grads, G, sc, n, D, V, tiles, static_cast<int>(zero_rows), nonce);
  return cudaGetLastError();
}

template <int VW>
cudaError_t launch_scatter_vw(const int* sids, const float* grads, float* G, float* scratch,
                              int64_t n, int D, int64_t V, unsigned long long nonce,
                              cudaStream_t stream) {
  switch (row_lanes(D)) {
    case 1: return launch_scatter<VW, 1>(sids, grads, G, scratch, n, D, V, nonce, stream);
    case 2: return launch_scatter<VW, 2>(sids, grads, G, scratch, n, D, V, nonce, stream);
    case 4: return launch_scatter<VW, 4>(sids, grads, G, scratch, n, D, V, nonce, stream);
    case 8: return launch_scatter<VW, 8>(sids, grads, G, scratch, n, D, V, nonce, stream);
    case 16: return launch_scatter<VW, 16>(sids, grads, G, scratch, n, D, V, nonce, stream);
    default: return launch_scatter<VW, 32>(sids, grads, G, scratch, n, D, V, nonce, stream);
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(256) gather_rows_kernel(
    const int* __restrict__ sids, const float* __restrict__ table, float* __restrict__ out,
    int64_t n, int D, int64_t V) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kGatherRows;
  const int64_t rows = n - r0 < kGatherRows ? n - r0 : kGatherRows;
  const int width = kVec4 ? D / 4 : D;  // elements copied per row
  const int64_t total = rows * width;
  for (int64_t i = threadIdx.x; i < total; i += blockDim.x) {
    const int64_t r = r0 + i / width;
    const int c = static_cast<int>(i % width);
    const int id = sids[r];
    if (kVec4) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(out)[r * width + c] =
          in_table(id, V) ? reinterpret_cast<const float4*>(table)[id * static_cast<int64_t>(width) + c]
                          : zero;
    } else {
      out[r * width + c] = in_table(id, V) ? table[id * static_cast<int64_t>(width) + c] : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Rows of the sorted stream that one warp of the tile kernel sums at width
// D: a run that crosses a multiple of it leaves partials.
int embedding_scatter_slice_rows(int D) { return static_cast<int>(slice_rows(D)); }

// Rows of the sorted stream per block of the tile kernel (kWarps slices): a
// run that crosses a multiple of it is finished by the carry kernel.
int embedding_scatter_tile_rows(int D) { return static_cast<int>(kWarps * slice_rows(D)); }

// Floats of scratch that embedding_fused_scatter_add needs for n rows at
// width D: a 64-bit ready mark and two partials of D floats a tile, two
// partials a slice.
int64_t embedding_scatter_scratch_floats(int64_t n, int D) {
  const int64_t slices = (n + slice_rows(D) - 1) / slice_rows(D);
  const int64_t tiles = (slices + kWarps - 1) / kWarps;
  return ready_floats(tiles) + 2 * (slices + tiles) * D;
}

// G (V, D) = the aggregated gradient of the sorted stream, in one launch;
// scratch holds embedding_scatter_scratch_floats(n, D) floats; grads, G and
// scratch are 16-byte aligned; nonce differs from every earlier call's (the
// ready marks are not cleared between calls). Returns a cudaError_t (0 =
// launched).
int embedding_fused_scatter_add(const int* sids, const float* grads, float* G, float* scratch,
                                int64_t n, int D, int64_t V, unsigned long long nonce,
                                cudaStream_t stream) {
  if (V == 0 || D == 0) return 0;
  const cudaError_t err =
      vec_width(D) == 4 ? launch_scatter_vw<4>(sids, grads, G, scratch, n, D, V, nonce, stream)
                        : launch_scatter_vw<1>(sids, grads, G, scratch, n, D, V, nonce, stream);
  return static_cast<int>(err);
}

// rows (n, D) = table[sids]; vec4 != 0 when D % 4 == 0 and both pointers are
// 16-byte aligned. Returns a cudaError_t (0 = launched).
int embedding_gather_rows(const int* sids, const float* table, float* rows, int64_t n, int D,
                          int64_t V, int vec4, cudaStream_t stream) {
  if (n == 0 || D == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kGatherRows - 1) / kGatherRows);
  if (vec4) {
    gather_rows_kernel<true><<<blocks, 256, 0, stream>>>(sids, table, rows, n, D, V);
  } else {
    gather_rows_kernel<false><<<blocks, 256, 0, stream>>>(sids, table, rows, n, D, V);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
