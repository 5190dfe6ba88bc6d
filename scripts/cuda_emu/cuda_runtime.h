// Stub of the CUDA runtime for running the port's csrc/*.cu on the CPU (see
// build.py): no device, every launch a loop over blocks and threads.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n, cudaMemcpyKind, cudaStream_t) { std::memmove(d, s, n); return cudaSuccess; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __int2float_rn(int a) { return (float)a; }
inline float __uint2float_rn(unsigned a) { return (float)a; }
inline int __float2int_rz(float a) { return (int)a; }
template <class K, class... A>
void emu_launch(dim3 g, dim3 b, K k, A... a) {
  gridDim = g; blockDim = b;
  for (unsigned bx = 0; bx < g.x; ++bx)
    for (unsigned tx = 0; tx < b.x; ++tx) { blockIdx = dim3(bx); threadIdx = dim3(tx); k(a...); }
}
