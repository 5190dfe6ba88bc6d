// MementoHash lookup kernels for Hopper (sm_90a): paper Alg. 4 per key.
//
// Replaces the dense Memento configurations of the TPU engine kernel
// src/repro/kernels/engine.py::_engine_pallas (body _engine_kernel_factory):
//   memento_lookup  <- EngineOp("memento"), dense table, k = 1
//   memento_diff    <- EngineOp("memento", diff=True), dense table, k = 1
//
// What bounds it on the card: integer issue.  A key costs ~ln(n) jump32
// steps (14.4 at n = 10^6), each a murmur3 mix, a correctly rounded f32
// divide and a floor, plus one hash2 and a modulo per Alg. 4 iteration.
// Memory is small beside that: 8 bytes of key and bucket per key, and
// gathers into the 4n-byte repl table, which at n = 10^6 (4 MB) stays in
// the 50 MB L2.
//
// Design: one thread per key with per-thread loops.  The Pallas kernel
// runs lane-synchronous masked while_loops over (8, 128) key blocks, so a
// block settles when its slowest lane does; here a warp waits only for its
// own 32 keys, and every lane's result is the same either way.  The table
// is read straight from global memory (through L2); it is far larger than
// a block's shared memory.  The per-key logic lives in __device__
// functions shared by both kernels, so lookup and diff cannot disagree.
//
// Arithmetic: uint32 words wrap mod 2^32 and % is unsigned, as in the
// reference.  The jump32 step uses __fdiv_rn / __fadd_rn / __fmul_rn, so
// it stays correctly rounded whatever the compiler flags.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kGolden32 = 0x9E3779B1u;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kStepSalt = 0x2545F491u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash2(uint32_t key, uint32_t seed) {
  return fmix32(key ^ fmix32(seed * kGolden32 + 1u));
}

// b <- j; j <- floor((b + 1) / r) with r = (u24 + 1) * 2^-24, while j < n.
__device__ __forceinline__ int32_t jump32(uint32_t key, int32_t n) {
  const float nf = __int2float_rn(n);
  int32_t b = 0;
  float j = 0.0f;
  for (uint32_t i = 0; j < nf; ++i) {
    b = __float2int_rz(j);  // j is a whole number below n: exact
    const uint32_t u = fmix32(key ^ (i * kGolden32 + kStepSalt)) >> 8;
    const float r = __fmul_rn(__fadd_rn(__uint2float_rn(u), 1.0f),
                              5.9604644775390625e-08f);  // 2^-24
    const float jn = floorf(__fdiv_rn(__fadd_rn(__int2float_rn(b), 1.0f), r));
    j = fminf(jn, nf);
  }
  return b;
}

// Paper Alg. 4 over the dense table: repl[b] = |W_b| if b was removed,
// else -1.  A chain is followed only while repl[d] >= w_b.
__device__ __forceinline__ int32_t memento_one(uint32_t key,
                                               const int32_t* __restrict__ repl,
                                               int32_t n) {
  int32_t b = jump32(key, n);
  int32_t c;
  while ((c = repl[b]) >= 0) {
    const int32_t wb = c > 0 ? c : 1;  // a valid image never holds 0
    int32_t d = static_cast<int32_t>(hash2(key, static_cast<uint32_t>(b)) %
                                     static_cast<uint32_t>(wb));
    int32_t u;
    while ((u = repl[d]) >= wb) d = u;
    b = d;
  }
  return b;
}

__global__ void memento_lookup_kernel(const uint32_t* __restrict__ keys,
                                      int32_t* __restrict__ out, int64_t count,
                                      const int32_t* __restrict__ repl,
                                      int32_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) out[i] = memento_one(keys[i], repl, n);
}

__global__ void memento_diff_kernel(const uint32_t* __restrict__ keys,
                                    int32_t* __restrict__ old_out,
                                    int32_t* __restrict__ new_out,
                                    int32_t* __restrict__ moved, int64_t count,
                                    const int32_t* __restrict__ repl_old,
                                    int32_t n_old,
                                    const int32_t* __restrict__ repl_new,
                                    int32_t n_new) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t key = keys[i];
  const int32_t o = memento_one(key, repl_old, n_old);
  const int32_t w = memento_one(key, repl_new, n_new);
  old_out[i] = o;
  new_out[i] = w;
  moved[i] = o != w;
}

unsigned int blocks_for(long long count) {
  return static_cast<unsigned int>((count + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// keys: uint32 [count]; out: int32 [count]; repl: int32 [>= n].
int memento_lookup(const void* keys, void* out, long long count,
                   const void* repl, int n, void* stream) {
  memento_lookup_kernel<<<blocks_for(count), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out), count,
      static_cast<const int32_t*>(repl), n);
  return static_cast<int>(cudaGetLastError());
}

// Both epochs in one launch: old, new and moved (0/1), int32 [count] each.
int memento_diff(const void* keys, void* old_out, void* new_out, void* moved,
                 long long count, const void* repl_old, int n_old,
                 const void* repl_new, int n_new, void* stream) {
  memento_diff_kernel<<<blocks_for(count), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(old_out),
      static_cast<int32_t*>(new_out), static_cast<int32_t*>(moved), count,
      static_cast<const int32_t*>(repl_old), n_old,
      static_cast<const int32_t*>(repl_new), n_new);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
