// DCN vector-cross stack for Hopper (sm_90a), fp32 in and out, every layer
// in one launch:
//
//   x_0 = x0,  x_{l+1} = x0 * (x_l . w_l) + b_l + x_l,  out = x_L
//   x0 (B, D), w and b (L, D)
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:
// cross_network_stack (_cross_kernel). Same function as
// cross_network_reference.
//
// What bounds it on an H100: bytes. x0 is read once and x_L written once;
// 4 * (2*B*D + 2*L*D) bytes over 3.35 TB/s is 8.1 us at DCN's serving shape
// (B=8192, D=416 = 26 fields x 16, L=3; 27 MB), against ~5 flops an element
// a layer (16 MFLOP). What a kernel must avoid is every layer's round trip
// of x through device memory (the plain version's), a block barrier inside
// the layer chain, and w and b fetched again for every row.
//
// Design: a warp takes one row and holds its x0 and x in registers through
// all L layers. With 16-byte units where D % 4 == 0 and every pointer is on
// a 16-byte boundary (else 4-byte units), lane l owns units l, l + 32, ...:
// at D=416, 4 float4 a lane (the last on 8 lanes). A layer is a per-lane
// partial dot, a 5-step butterfly that leaves the same sum on every lane,
// and the lane's update: no barrier and no shared-memory round trip inside
// the layer loop. Blocks of 8 warps are persistent (as many as fit on the
// card at once, from an occupancy query the caller makes once a device and
// shape); each stages w and b of all L layers in shared memory once,
// with all of a thread's staging loads in flight together, and its warps
// walk rows at a stride of the whole grid's warps. A warp's first row is
// loaded before the staging, and while it has a next row, that row is
// loaded before the current one's layers, so the load overlaps the chain
// of dots (at B=8192 a warp takes ~2 rows). Measured with chip_smoke.py's
// harness (an NVIDIA H100 80GB HBM3 at 700 W), B=8192 then reads about as
// long as a device-to-device copy of x0 (`--cross`, `copy_ms`).
// Rows wider than kWarpMaxD, or w and b past kStageBytes, take the second
// kernel: a block of 8 warps a row, each thread holding a share of the row in
// registers, w and b read through the read-only path, and a layer's dot
// summed by a butterfly in each warp then the 8 warp partials in order from
// shared memory (one barrier a layer, the partials double-buffered).
// Every sum runs in a fixed order and nothing is atomic: the same bits on
// every call.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kWarpMaxD = 1024;         // the widest row a warp holds
constexpr int kStageBytes = 48 * 1024;  // w and b staged in shared memory up to this
constexpr int kStageLoads = 8;          // staging loads a thread has in flight

template <int VW>
__device__ __forceinline__ void load(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

template <int VW>
__device__ __forceinline__ void load_shared(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

// The units u = first + k * step (k < NV) of a row, all loads in flight
// together. They are not predicated: a unit past U (U >= 1) reloads unit
// U - 1 and is never used. (A predicated load with a zero for the units
// past U compiles to a zeroing of the load's register ahead of it, which
// waits for the previous load into that register.)
template <int VW, int NV>
__device__ __forceinline__ void load_row(const float* row, int first, int step, int U,
                                         float (&v)[NV][VW]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    load<VW>(row + static_cast<size_t>(min(first + k * step, U - 1)) * VW, v[k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One row through every layer on one warp: x0's units in a, w and b from
// shared memory, x_L stored at o.
template <int VW, int NV>
__device__ __forceinline__ void cross_row(const float (&a)[NV][VW], const float* w_s,
                                          const float* b_s, int lane, int U, int D, int L,
                                          float* o) {
  float x[NV][VW];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int c = 0; c < VW; ++c) x[k][c] = a[k][c];
  }
  for (int l = 0; l < L; ++l) {
    const float* wl = w_s + l * D;
    const float* bl = b_s + l * D;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int u = lane + 32 * k;
      if (u < U) {
        float wv[VW];
        load_shared<VW>(wl + u * VW, wv);
#pragma unroll
        for (int c = 0; c < VW; ++c) part = fmaf(x[k][c], wv[c], part);
      }
    }
    const float dot = warp_sum(part);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int u = lane + 32 * k;
      if (u < U) {
        float bv[VW];
        load_shared<VW>(bl + u * VW, bv);
#pragma unroll
        for (int c = 0; c < VW; ++c) x[k][c] = fmaf(a[k][c], dot, bv[c]) + x[k][c];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int u = lane + 32 * k;
    if (u < U) store<VW>(o + u * VW, x[k]);
  }
}

template <int VW, int NV>
__global__ void __launch_bounds__(kThreads) cross_warp_kernel(const float* __restrict__ x0,
                                                              const float* __restrict__ w,
                                                              const float* __restrict__ bias,
                                                              float* __restrict__ out, int B,
                                                              int D, int L) {
  extern __shared__ __align__(16) float smem[];
  if (D == 0) return;
  const int lane = threadIdx.x & 31;
  const int U = D / VW;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);

  float a[NV][VW];  // x0's units
  if (row < B) load_row<VW, NV>(x0 + static_cast<size_t>(row) * D, lane, 32, U, a);
  // w and b are one range of 2*L*D floats in shared memory; a thread's
  // loads of a round are all in flight before it stores them
  const int n = L * D;
  for (int base = threadIdx.x * VW; base < 2 * n; base += kThreads * VW * kStageLoads) {
    float v[kStageLoads][VW];
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      const int i = base + k * kThreads * VW;
      if (i < 2 * n) load<VW>(i < n ? w + i : bias + (i - n), v[k]);
    }
#pragma unroll
    for (int k = 0; k < kStageLoads; ++k) {
      const int i = base + k * kThreads * VW;
      if (i < 2 * n) {
#pragma unroll
        for (int c = 0; c < VW; ++c) smem[i + c] = v[k][c];
      }
    }
  }
  __syncthreads();

  // while the warp has a next row, it is loaded before this one's layers
  for (; row + stride < B; row += stride) {
    float next[NV][VW];
    load_row<VW, NV>(x0 + static_cast<size_t>(row + stride) * D, lane, 32, U, next);
    cross_row<VW, NV>(a, smem, smem + n, lane, U, D, L, out + static_cast<size_t>(row) * D);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int c = 0; c < VW; ++c) a[k][c] = next[k][c];
    }
  }
  if (row < B) cross_row<VW, NV>(a, smem, smem + n, lane, U, D, L, out + static_cast<size_t>(row) * D);
}

template <int VW, int NV>
__global__ void __launch_bounds__(kThreads) cross_block_kernel(const float* __restrict__ x0,
                                                               const float* __restrict__ w,
                                                               const float* __restrict__ bias,
                                                               float* __restrict__ out, int B,
                                                               int D, int L) {
  __shared__ float partial[2][kWarps];
  if (D == 0) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int U = D / VW;
  const size_t row = blockIdx.x;

  float a[NV][VW];
  load_row<VW, NV>(x0 + row * D, threadIdx.x, kThreads, U, a);
  float x[NV][VW];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int c = 0; c < VW; ++c) x[k][c] = a[k][c];
  }
  for (int l = 0; l < L; ++l) {
    const float* wl = w + static_cast<size_t>(l) * D;
    const float* bl = bias + static_cast<size_t>(l) * D;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int u = threadIdx.x + kThreads * k;
      if (u < U) {
        float wv[VW];
        load<VW>(wl + u * VW, wv);
#pragma unroll
        for (int c = 0; c < VW; ++c) part = fmaf(x[k][c], wv[c], part);
      }
    }
    part = warp_sum(part);
    if (lane == 0) partial[l & 1][warp] = part;
    __syncthreads();
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) dot += partial[l & 1][i];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int u = threadIdx.x + kThreads * k;
      if (u < U) {
        float bv[VW];
        load<VW>(bl + u * VW, bv);
#pragma unroll
        for (int c = 0; c < VW; ++c) x[k][c] = fmaf(a[k][c], dot, bv[c]) + x[k][c];
      }
    }
  }
  float* o = out + row * D;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int u = threadIdx.x + kThreads * k;
    if (u < U) store<VW>(o + u * VW, x[k]);
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, int, int, int);

// The warp kernel holding nv units a lane (every nv from 1 to MAX is built).
template <int VW, int NV, int MAX>
Kernel warp_kernel(int nv) {
  if (nv <= NV) return cross_warp_kernel<VW, NV>;
  if constexpr (NV < MAX) {
    return warp_kernel<VW, NV + 1, MAX>(nv);
  } else {
    return nullptr;
  }
}

// The block kernel holding at least nv units a thread (powers of two up to MAX).
template <int VW, int NV, int MAX>
Kernel block_kernel(int nv) {
  if (nv <= NV) return cross_block_kernel<VW, NV>;
  if constexpr (NV < MAX) {
    return block_kernel<VW, 2 * NV, MAX>(nv);
  } else {
    return nullptr;
  }
}

size_t stage_bytes(int D, int L) { return 2 * sizeof(float) * static_cast<size_t>(L) * D; }

bool warp_route(int D, int L) { return D <= kWarpMaxD && stage_bytes(D, L) <= kStageBytes; }

// The kernel for this shape and unit width (vw 4: 16-byte units, 1: floats),
// its dynamic shared memory, and whether a warp takes a row.
Kernel pick(int D, int L, int vw, size_t* smem, bool* warp) {
  const int units = vw == 4 ? D / 4 : D;
  *warp = warp_route(D, L);
  if (*warp) {
    *smem = stage_bytes(D, L);
    const int nv = units > 32 ? (units + 31) / 32 : 1;
    return vw == 4 ? warp_kernel<4, 1, kWarpMaxD / 128>(nv) : warp_kernel<1, 1, kWarpMaxD / 32>(nv);
  }
  *smem = 0;
  const int nv = (units + kThreads - 1) / kThreads;
  return vw == 4 ? block_kernel<4, 1, 8>(nv) : block_kernel<1, 1, 32>(nv);
}

}  // namespace

extern "C" {

// 1 where a warp takes a row (D <= kWarpMaxD and w, b fit kStageBytes), 0
// where a block does.
int cross_network_route(int D, int L) { return warp_route(D, L) ? 1 : 0; }

// Blocks of the warp kernel for this shape and unit width that the current
// device holds at once (the most a launch takes: they are persistent), 0
// where a block takes a row, or minus a cudaError_t. The caller finds it
// once a device and shape.
int cross_network_resident(int D, int L, int vw) {
  size_t smem = 0;
  bool warp = false;
  const Kernel kernel = pick(D, L, vw, &smem, &warp);
  if (!kernel) return -static_cast<int>(cudaErrorInvalidValue);
  if (!warp) return 0;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), kThreads, smem);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (per_sm > 0 ? per_sm : 1) * sms;
}

// out (B, D) = x_L of the cross stack; x0 (B, D), w and b (L, D) and out are
// contiguous fp32 device arrays, D at most 8192 (the block kernel's widest).
// vw 4 reads and writes 16-byte units (D % 4 == 0 and every pointer on a
// 16-byte boundary), vw 1 floats. Where a warp takes a row, resident is
// cross_network_resident's count for the shape and vw, and the launch takes
// at most that many blocks of kWarps rows; else a block takes a row.
// Returns a cudaError_t (0 = launched).
int cross_network_forward(const float* x0, const float* w, const float* b, float* out, int B,
                          int D, int L, int vw, int resident, void* stream) {
  if (B < 1 || D < 0 || D > 8192 || L < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(x0) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out)) %
                           16 ==
                       0;
  if (vw != 1 && !(vw == 4 && D % 4 == 0 && aligned)) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  bool warp = false;
  const Kernel kernel = pick(D, L, vw, &smem, &warp);
  if (!kernel || (warp && resident < 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int needed = (B + kWarps - 1) / kWarps;
  const int blocks = !warp ? B : needed < resident ? needed : resident;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x0, w, b, out, B, D, L);
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
