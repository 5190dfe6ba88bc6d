// Epoch-delta apply for Hopper (sm_90a): an out-of-place copy of a flat
// table with up to P (index, value) updates written into the copy.
//
// Replaces the TPU kernel src/repro/kernels/delta_apply.py::_apply_scatter_i32
// (body _apply_kernel) for 32-bit tables, and the reference's functional
// scatter of dtype-narrowed packed tables (delta_apply.py:169-173, jnp
// outside Pallas) for 16- and 8-bit ones: one template over the element
// type, exported as delta_apply (int32 words, uint32 bit patterns
// included), delta_apply_int16 and delta_apply_int8.
//
// What bounds it on the card: bytes, and for the small tables a launch.
// The copy reads and writes the whole table (2 x the element size per
// word); the updates are a few thousand words at most.  The TPU kernel
// turns each update into a masked select over the whole table.  Here a
// table of up to one_block_max<T>() words (int32 and int16 2^12, int8
// 2^15) is copied and updated by one block in one launch
// (copy_scatter_kernel): a packed image's narrow slot tables are a few
// hundred bytes, and two operations on the stream cost two launches.  A
// longer table takes a device-to-device copy at memory speed, then one
// thread per update (scatter_kernel): one block copies at about a 35th of
// the card's rate.
//
// Designs timed on the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md;
// scripts/ab_engine.py against the copy and the scatter alone, three
// runs, each figure tagged with its run): kept, the one-block form.  At
// 128 slots int16 -35.4 / -34.5 / -32.9 % and int8 -35.3 / -34.5 / -33.8 %
// (runs 1 / 2 / 3; run 3 0.004125 -> 0.002769 ms and 0.004098 -> 0.002713
// ms).  Its thresholds are the longest table of the sweep (128, 2^12,
// 2^15, 2^17, 2^20 elements) at which it won in every run: int32 2^12
// (-23.0 / -21.4 / -23.0 %; 2^15 +20.1 %, run 1), int16 2^12 (-30.2 /
// -29.9 / -30.3 %; 2^15 -2.5 / +0.7 / -0.6 %, a tie) and int8 2^15 (-18.7
// / -16.8 / -17.3 %).  Every width lost from 2^17 up (run 1; int32 2^20
// x15.7).
//
// Semantics: padded slots (index -1), negative indices and indices past
// the table never write.  Values arrive as int32 and are narrowed to the
// element type (the packed layout's values always fit).  The Pallas loop
// applies updates in order, so the last write wins on a duplicate index;
// a GPU scatter does not order its threads, so the caller passes indices
// that are unique (the Python wrapper deduplicates keep-last before the
// launch).  The old table is never written: it keeps serving the previous
// epoch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOneBlockThreads = 1024;
constexpr int kUnroll = 4;  // 16-byte vectors a thread loads before it stores them

// The longest table (elements) of each width that copy_scatter_kernel takes:
// one launch of one block.  Longer tables take the copy and then
// scatter_kernel.  Set from timings of both forms on the card (PERF.md).
// repro_torch.kernels.delta_apply.ONE_BLOCK_MAX holds the same numbers for
// the logs and tests; a tier-1 test reads this file to keep them equal.
constexpr long long kOneBlockMaxInt32 = 1 << 12;
constexpr long long kOneBlockMaxInt16 = 1 << 12;
constexpr long long kOneBlockMaxInt8 = 1 << 15;

template <class T>
constexpr long long one_block_max() {
  if constexpr (sizeof(T) == 4) return kOneBlockMaxInt32;
  if constexpr (sizeof(T) == 2) return kOneBlockMaxInt16;
  return kOneBlockMaxInt8;
}

// meta = [idx_0 .. idx_{pad-1}, val_0 .. val_{pad-1}], the first count live.
template <class T>
__global__ void scatter_kernel(T* __restrict__ table, int64_t length,
                               const int32_t* __restrict__ meta, int pad,
                               int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int32_t j = meta[i];
  if (j >= 0 && j < length) table[j] = static_cast<T>(meta[pad + i]);
}

// One block: dst <- src, in 16-byte vectors when both are 16-byte aligned
// (elementwise after the last whole vector; elementwise throughout when
// not), then, after a barrier, dst[meta[i]] = meta[pad + i] for the first
// count pairs whose index lies in [0, length).  The barrier orders each
// update after the copy of its word.
template <class T>
__global__ void __launch_bounds__(kOneBlockThreads)
    copy_scatter_kernel(const T* __restrict__ src, T* __restrict__ dst, int64_t length,
                        const int32_t* __restrict__ meta, int pad, int count) {
  const int t = threadIdx.x, nt = blockDim.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15u) == 0u;
  const int64_t vecs = aligned ? length * static_cast<int64_t>(sizeof(T)) / 16 : 0;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int64_t v0 = 0; v0 < vecs; v0 += static_cast<int64_t>(kUnroll) * nt) {
    int4 x[kUnroll] = {};
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t v = v0 + static_cast<int64_t>(k) * nt + t;
      if (v < vecs) x[k] = s4[v];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t v = v0 + static_cast<int64_t>(k) * nt + t;
      if (v < vecs) d4[v] = x[k];
    }
  }
  for (int64_t j = vecs * static_cast<int64_t>(16 / sizeof(T)) + t; j < length; j += nt)
    dst[j] = src[j];
  __syncthreads();
  for (int i = t; i < count; i += nt) {
    const int32_t j = meta[i];
    if (j >= 0 && j < length) dst[j] = static_cast<T>(meta[pad + i]);
  }
}

// dst <- src (length words of T), then dst[meta[i]] = meta[pad + i]: one
// block up to one_block_max<T>() words, else the copy and then the scatter.
template <class T>
int apply(const void* src, void* dst, long long length, const void* meta, int pad,
          int count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (length <= one_block_max<T>()) {
    const long long work = length * static_cast<long long>(sizeof(T)) / 16 + 1;
    const long long most = work > count ? work : count;
    const int threads = most >= kOneBlockThreads ? kOneBlockThreads
                                                 : static_cast<int>((most + 31) / 32 * 32);
    copy_scatter_kernel<T><<<1, threads, 0, s>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), length,
        static_cast<const int32_t*>(meta), pad, count);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaMemcpyAsync(dst, src, length * sizeof(T),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count > 0) {
    scatter_kernel<T><<<(count + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<T*>(dst), length, static_cast<const int32_t*>(meta), pad, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int delta_apply(const void* src, void* dst, long long length, const void* meta,
                int pad, int count, void* stream) {
  return apply<int32_t>(src, dst, length, meta, pad, count, stream);
}

int delta_apply_int16(const void* src, void* dst, long long length, const void* meta,
                      int pad, int count, void* stream) {
  return apply<int16_t>(src, dst, length, meta, pad, count, stream);
}

int delta_apply_int8(const void* src, void* dst, long long length, const void* meta,
                     int pad, int count, void* stream) {
  return apply<int8_t>(src, dst, length, meta, pad, count, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
