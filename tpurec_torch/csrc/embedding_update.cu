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
// 548,864, V = 21,504) the grads dominate (~70 MB, ~22 us). #2 reads N ids
// and N rows and writes N rows (~55 MB at the FM shape, ~17 us).
//
// Design of #1. The TPU kernel's packed lanes, two tile passes and one-hot
// matmuls are TPU tiling; a sorted stream is a segmented sum:
//   - zero-fill G (cudaMemsetAsync, on the caller's stream);
//   - pass 1: one warp per slice of kSliceRows consecutive rows of the
//     stream, the D columns across the lanes (a loop over 32-column chunks
//     for D > 32, so any D works, D = 1 included). The warp walks its rows
//     in order, kUnroll rows of loads in flight, and sums each run of equal
//     ids. A run that lies inside the slice is written straight to its row
//     of G. A run that crosses a slice boundary leaves one partial per
//     slice: the slice where it begins writes tail_part[slice], every later
//     slice it reaches writes head_part[slice];
//   - pass 2: for each slice that begins a crossing run (its "owner"), one
//     block finds where the run ends (a binary search of the sorted ids),
//     and its warps add the head partials of the slices it spans in
//     contiguous stripes; warp 0 then adds tail_part and the stripes in
//     warp order and writes the row of G.
// Every sum is taken in an order fixed by N and the slice size, and there
// are no atomics: two calls give the same bits. A run inside one slice is
// summed row by row in stream order, as index_add_ on the CPU sums it. The
// longest run (DIN's padding id 0, ~196k rows) is spread over ~1,500 warps
// in pass 1 and ~1,500 partials summed by eight warps in pass 2, never
// serialised on one warp. Ids outside [0, V) are dropped, as a TPU/XLA
// scatter drops them.
//
// Design of #2: one block per slice of kGatherRows rows; its threads copy
// (row, 16-byte vector) pairs when D is a multiple of 4 and both tables are
// 16-byte aligned, else single floats. Ids outside [0, V) give zero rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSliceRows = 128;  // rows of the sorted stream per pass-1 warp
constexpr int kWarps = 8;        // warps per block, both passes
constexpr int kUnroll = 8;       // rows of loads in flight per warp
constexpr int kGatherRows = 64;  // rows per gather block

__device__ __forceinline__ bool in_table(int id, int64_t V) { return id >= 0 && id < V; }

// pass 1: runs inside a slice go to G, partials of crossing runs to
// head_part / tail_part ((num_slices, D) each)
__global__ void __launch_bounds__(kWarps * 32) scatter_slices_kernel(
    const int* __restrict__ sids, const float* __restrict__ grads, float* __restrict__ G,
    float* __restrict__ head_part, float* __restrict__ tail_part, int64_t n, int D,
    int64_t V) {
  const int lane = threadIdx.x & 31;
  const int64_t slice = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t s0 = slice * kSliceRows;
  if (s0 >= n) return;
  const int64_t s1 = s0 + kSliceRows < n ? s0 + kSliceRows : n;
  const int first_id = sids[s0];
  const int last_id = sids[s1 - 1];
  // the slice's first run began in an earlier slice; its last run goes on
  const bool head_carried = s0 > 0 && sids[s0 - 1] == first_id;
  const bool tail_open = s1 < n && sids[s1] == last_id;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool live = d < D;
    // the segment [seg_start, seg_end) of id `id` is complete: route it
    auto emit = [&](int id, float acc, int64_t seg_start, int64_t seg_end) {
      if (!live) return;
      if (seg_start == s0 && head_carried) {
        head_part[slice * D + d] = acc;
      } else if (seg_end == s1 && tail_open) {
        tail_part[slice * D + d] = acc;
      } else if (in_table(id, V)) {
        G[static_cast<int64_t>(id) * D + d] = acc;
      }
    };
    int cur = first_id;
    int64_t seg_start = s0;
    float acc = 0.f;
    for (int64_t r0 = s0; r0 < s1; r0 += kUnroll) {
      int ids[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + u;
        ids[u] = r < s1 ? sids[r] : cur;
        v[u] = (r < s1 && live) ? grads[r * D + d] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u < s1) {
          if (ids[u] != cur) {
            emit(cur, acc, seg_start, r0 + u);
            cur = ids[u];
            acc = 0.f;
            seg_start = r0 + u;
          }
          acc += v[u];
        }
      }
    }
    emit(cur, acc, seg_start, s1);
  }
}

// pass 2: each block looks at kWarps consecutive slices; for every slice
// that begins a run crossing its end, all warps add that run's partials
__global__ void __launch_bounds__(kWarps * 32) scatter_carry_kernel(
    const int* __restrict__ sids, const float* __restrict__ head_part,
    const float* __restrict__ tail_part, float* __restrict__ G, int64_t n, int D, int64_t V,
    int64_t num_slices) {
  __shared__ int64_t last_slice[kWarps];  // last slice of the owned run, or -1
  __shared__ float stripe[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kWarps;
  if (lane == 0) {
    int64_t e = -1;
    const int64_t slice = base + warp;
    if (slice < num_slices) {
      const int64_t s0 = slice * kSliceRows;
      const int64_t s1 = s0 + kSliceRows < n ? s0 + kSliceRows : n;
      const int id = sids[s1 - 1];
      if (s1 < n && sids[s1] == id && !(s0 > 0 && sids[s0 - 1] == id)) {
        // the run ends before the first position past s1 whose id differs
        int64_t lo = s1, hi = n;
        while (lo < hi) {
          const int64_t mid = lo + (hi - lo) / 2;
          if (sids[mid] == id) lo = mid + 1; else hi = mid;
        }
        e = (lo - 1) / kSliceRows;
      }
    }
    last_slice[warp] = e;
  }
  __syncthreads();
  for (int o = 0; o < kWarps; ++o) {
    const int64_t e = last_slice[o];  // the same for every thread
    if (e < 0) continue;
    const int64_t s = base + o;
    const int64_t s1 = (s + 1) * kSliceRows < n ? (s + 1) * kSliceRows : n;
    const int id = sids[s1 - 1];
    // head partials of slices s+1 .. e, in kWarps contiguous stripes
    const int64_t k = e - s;
    const int64_t per = (k + kWarps - 1) / kWarps;
    const int64_t j0 = s + 1 + warp * per;
    const int64_t j1 = j0 + per < e + 1 ? j0 + per : e + 1;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.f;
      if (d < D) {
#pragma unroll 8
        for (int64_t j = j0; j < j1; ++j) acc += head_part[j * D + d];
      }
      stripe[warp][lane] = acc;
      __syncthreads();
      if (warp == 0 && d < D) {
        float total = tail_part[s * D + d];
        for (int w = 0; w < kWarps; ++w) total += stripe[w][lane];
        if (in_table(id, V)) G[static_cast<int64_t>(id) * D + d] = total;
      }
      __syncthreads();
    }
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

// Rows of the sorted stream per pass-1 slice: the wrapper sizes head_part
// and tail_part as (ceil(n / slice_rows), D).
int embedding_scatter_slice_rows() { return kSliceRows; }

// G (V, D) = the aggregated gradient of the sorted stream. head_part and
// tail_part are scratch of (ceil(n / slice_rows), D) floats. Returns a
// cudaError_t (0 = launched).
int embedding_fused_scatter_add(const int* sids, const float* grads, float* G,
                                float* head_part, float* tail_part, int64_t n, int D,
                                int64_t V, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(G, 0, static_cast<size_t>(V) * D * sizeof(float), stream);
  if (err != cudaSuccess || n == 0 || D == 0) return static_cast<int>(err);
  const int64_t num_slices = (n + kSliceRows - 1) / kSliceRows;
  const unsigned blocks = static_cast<unsigned>((num_slices + kWarps - 1) / kWarps);
  scatter_slices_kernel<<<blocks, kWarps * 32, 0, stream>>>(sids, grads, G, head_part, tail_part,
                                                            n, D, V);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_slices == 1) return static_cast<int>(err);
  scatter_carry_kernel<<<blocks, kWarps * 32, 0, stream>>>(sids, head_part, tail_part, G, n, D, V,
                                                           num_slices);
  return static_cast<int>(cudaGetLastError());
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
