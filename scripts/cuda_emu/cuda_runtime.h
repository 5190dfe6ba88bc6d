// Stub of the CUDA runtime for running the port's csrc/*.cu on the CPU (see
// build.py): no device; every launch runs its blocks one after another, and
// a block's threads as fibers on one OS thread.  A fiber runs until it
// meets a warp collective (__ballot_sync, __any_sync, __shfl_sync,
// __reduce_*_sync), where it waits for the rest of its warp, or a
// __syncthreads, where it waits for the rest of its block.  A round in which no fiber moves is a deadlock (a
// collective or barrier that a thread never reaches, having exited or
// diverged): the process aborts with a message.  Warp collectives take the
// full-warp mask only.
#pragma once
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ucontext.h>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n, cudaMemcpyKind, cudaStream_t) { std::memmove(d, s, n); return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* d, int v, size_t n, cudaStream_t) { std::memset(d, v, n); return cudaSuccess; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __int2float_rn(int a) { return (float)a; }
inline float __uint2float_rn(unsigned a) { return (float)a; }
inline int __float2int_rz(float a) { return (int)a; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline int __ffs(int x) { return __builtin_ffs(x); }
struct alignas(16) int4 { int x, y, z, w; };

namespace emu {
constexpr size_t kStack = 128 << 10;
struct Fiber { ucontext_t uc; jmp_buf jb; bool started = false, done = false; };
struct Barrier { unsigned arrived = 0; unsigned long gen = 0; };
inline jmp_buf sched;
inline std::vector<Fiber> fibers;
inline char* stacks;  // uninitialised: only the pages a fiber touches are mapped
inline size_t stack_bytes;
inline std::vector<Barrier> warps;
inline Barrier block;  // __syncthreads
inline std::vector<unsigned long long> slots;
inline unsigned live, cur;
inline bool moved;
inline void (*entry)(void*);
inline void* entry_arg;

inline void yield() {
  if (!_setjmp(fibers[cur].jb)) _longjmp(sched, 1);
}

// Arrive at b, which opens when `need` fibers have arrived; wait for it.
inline void wait(Barrier& b, unsigned need) {
  const unsigned long gen = b.gen;
  moved = true;
  if (++b.arrived >= need) {
    b.arrived = 0;
    ++b.gen;
    return;
  }
  while (b.gen == gen) yield();
}

inline unsigned warp_size(unsigned w) {
  const unsigned end = (w + 1) * 32 < blockDim.x ? (w + 1) * 32 : blockDim.x;
  return end - w * 32;
}

// Every lane of the calling warp publishes v; out gets the warp's 32
// values (0 past a partial warp's end) once all lanes have.
inline void exchange(unsigned mask, unsigned long long v, unsigned long long* out) {
  if (mask != 0xFFFFFFFFu) {
    std::fprintf(stderr, "emu: warp collective with mask %08x (only full warps)\n", mask);
    std::abort();
  }
  const unsigned t = threadIdx.x, w = t / 32, size = warp_size(w);
  slots[t] = v;
  wait(warps[w], size);
  for (unsigned i = 0; i < 32; ++i) out[i] = i < size ? slots[w * 32 + i] : 0;
  wait(warps[w], size);
}

inline void trampoline() {
  entry(entry_arg);
  fibers[cur].done = true;
  moved = true;
  --live;
  _longjmp(sched, 1);
}

// One block: every thread a fiber, round-robin until all have finished.
inline void run_block() {
  const unsigned n = blockDim.x;
  fibers.assign(n, Fiber());
  if (stack_bytes < n * kStack) {
    std::free(stacks);
    stacks = static_cast<char*>(std::malloc(stack_bytes = n * kStack));
  }
  warps.assign((n + 31) / 32, Barrier());
  block = Barrier();
  slots.assign(n, 0);
  live = n;
  while (live) {
    moved = false;
    for (cur = 0; cur < n; ++cur) {
      Fiber& f = fibers[cur];
      if (f.done) continue;
      threadIdx = dim3(cur);
      if (_setjmp(sched)) continue;
      if (!f.started) {
        f.started = true;
        moved = true;
        getcontext(&f.uc);
        f.uc.uc_stack.ss_sp = stacks + cur * kStack;
        f.uc.uc_stack.ss_size = kStack;
        f.uc.uc_link = nullptr;
        makecontext(&f.uc, trampoline, 0);
        setcontext(&f.uc);
      }
      _longjmp(f.jb, 1);
    }
    if (live && !moved) {
      std::fprintf(stderr, "emu: deadlock in block %u: %u threads wait at a barrier or "
                   "collective that the others never reach\n", blockIdx.x, live);
      std::abort();
    }
  }
}
}  // namespace emu

inline unsigned __ballot_sync(unsigned mask, int pred) {
  unsigned long long v[32];
  emu::exchange(mask, pred != 0, v);
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i) r |= (v[i] ? 1u : 0u) << i;
  return r;
}
inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }
// __reduce_{min,max,or}_sync: the reduction of one 32-bit value over the
// warp's threads
template <class T, class F>
T emu_reduce(unsigned mask, T value, F f) {
  unsigned long long v[32];
  emu::exchange(mask, static_cast<unsigned long long>(static_cast<uint32_t>(value)), v);
  T r = static_cast<T>(static_cast<uint32_t>(v[0]));
  const unsigned size = emu::warp_size(threadIdx.x / 32);
  for (unsigned i = 1; i < size; ++i) r = f(r, static_cast<T>(static_cast<uint32_t>(v[i])));
  return r;
}
inline int __reduce_min_sync(unsigned mask, int value) {
  return emu_reduce(mask, value, [](int x, int y) { return y < x ? y : x; });
}
inline int __reduce_max_sync(unsigned mask, int value) {
  return emu_reduce(mask, value, [](int x, int y) { return y > x ? y : x; });
}
inline unsigned __reduce_or_sync(unsigned mask, unsigned value) {
  return emu_reduce(mask, value, [](unsigned x, unsigned y) { return x | y; });
}
template <class T>
T __shfl_sync(unsigned mask, T var, int src, int width = 32) {
  unsigned long long bits = 0;
  std::memcpy(&bits, &var, sizeof(T));
  const unsigned lane = threadIdx.x % 32;
  unsigned long long v[32];
  emu::exchange(mask, bits, v);
  bits = v[(lane & ~unsigned(width - 1)) + (unsigned(src) & unsigned(width - 1))];
  std::memcpy(&var, &bits, sizeof(T));
  return var;
}

inline void __syncthreads() { emu::wait(emu::block, blockDim.x); }

// A fiber runs alone until it meets a collective or a barrier, so a plain
// read-modify-write is atomic among the threads; blocks run in turn, so a
// block's shared array (static) is its own while it runs.
#define __shared__ static
inline void __threadfence() {}
template <class T> T atomicAdd(T* p, T v) { const T old = *p; *p = old + v; return old; }
template <class T> T atomicMin(T* p, T v) { const T old = *p; *p = v < old ? v : old; return old; }
template <class T> T atomicMax(T* p, T v) { const T old = *p; *p = v > old ? v : old; return old; }
template <class T> T atomicOr(T* p, T v) { const T old = *p; *p = old | v; return old; }

template <class K, class... A>
void emu_launch(dim3 g, dim3 b, K k, A... a) {
  gridDim = g; blockDim = b;
  auto run = [&] { k(a...); };
  emu::entry = [](void* p) { (*static_cast<decltype(run)*>(p))(); };
  emu::entry_arg = &run;
  for (unsigned bx = 0; bx < g.x; ++bx) {
    blockIdx = dim3(bx);
    emu::run_block();
  }
}

// cudaLaunchKernelEx runs the kernel as a plain launch: launches run one
// after another here, so a programmatic dependent launch has nothing to
// overlap.
enum cudaLaunchAttributeID { cudaLaunchAttributeProgrammaticStreamSerialization = 5 };
union cudaLaunchAttributeValue { int programmaticStreamSerializationAllowed; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(E...), A&&... a) {
  emu_launch(c->gridDim, c->blockDim, k, static_cast<E>(a)...);
  return cudaSuccess;
}
