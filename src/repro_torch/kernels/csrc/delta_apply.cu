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
// What bounds it on the card: bytes.  The copy reads and writes the whole
// table (2 x the element size per word); the updates are a few thousand
// words at most.  The TPU kernel turns each update into a masked select
// over the whole table; here a device-to-device copy runs at memory speed
// and one thread per update writes its word.
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

// dst <- src (length words of T), then dst[meta[i]] = meta[pad + i].
template <class T>
int apply(const void* src, void* dst, long long length, const void* meta, int pad,
          int count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
