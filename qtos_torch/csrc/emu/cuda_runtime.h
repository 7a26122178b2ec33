// A CPU stand-in for the part of the CUDA runtime and device library that
// qtos_torch/csrc/btd.cu, tick.cu and assemble.cu use, so that a kernel's own
// source compiles with a host C++ compiler and runs on the CPU
// (tests/test_torch_btd_emu.py, tests/test_torch_tick_emu.py,
// tests/test_torch_assemble_emu.py).
//
// Each CUDA thread is a std::thread; the blocks of a launch run one after
// another, all threads of a block at once.  __syncwarp and the shuffles meet
// at a barrier of the warp's 32 threads, and __syncthreads at one of all the
// block's threads, so a barrier that not every thread reaches hangs (and is
// reported after a timeout) instead of passing.
//
// A cp.async copy fills its destination with NaN when it is issued and
// copies only when __pipeline_wait_prior completes its batch, so a read of
// the destination before the wait reads NaN, and a write there before the
// wait is overwritten by the copy.  A 16-byte copy checks its alignment,
// and a thread that ends with copies not waited for aborts.
//
// The card has 2 SMs that hold 1 block each, so that small batches already
// walk the grid more than once.
//
// With QTOS_EMU_THREAD_ORDER=1 (or -1) in the environment of a launch, the
// threads of each block run one at a time, in ascending (descending) order
// of threadIdx.x, each from one __syncthreads to the next: a read that a
// missing block barrier leaves unordered then reads shared memory, in one
// of the two orders, before the thread that writes it has run.  Warp
// barriers and shuffles are not taken in that mode.
//
// A launch through the typed cudaLaunchKernel needs nothing more.  For one
// through the untyped (const void*) launch the including file defines
// EmuKernelSig, the kernel's signature, before it includes this header; a
// file that launches only by type defines EMU_TYPED_LAUNCH_ONLY instead.
// The including file also defines `emu_smem_base`, the dynamic shared
// memory.
#pragma once

#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

// A barrier of `size` threads that aborts when one of them does not come.
struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int size = 32, count = 0, gen = 0;

  void wait(int seconds, const char* what) {
    std::unique_lock<std::mutex> lk(m);
    const int g = gen;
    if (++count == size) {
      count = 0;
      ++gen;
      cv.notify_all();
      return;
    }
    if (!cv.wait_for(lk, std::chrono::seconds(seconds), [&] { return gen != g; })) {
      std::fprintf(stderr, "cuda_emu: %s timed out\n", what);
      std::abort();
    }
  }
};

// The 32 threads of one warp.
struct EmuWarp : EmuBarrier {
  float slot[32];

  void wait() { EmuBarrier::wait(60, "a warp barrier (a divergent __syncwarp or shuffle?)"); }
};
inline thread_local EmuWarp* emu_warp = nullptr;
inline thread_local EmuBarrier* emu_block = nullptr;

// The turns of a block's threads when they run one at a time
// (QTOS_EMU_THREAD_ORDER): `turn` is the thread that may run; a thread passes it
// on at each __syncthreads and when it ends.
struct EmuTurns {
  std::mutex m;
  std::unique_ptr<std::condition_variable[]> cv;  // one per thread: a pass wakes only its thread
  int size = 0, turn = -1, arrived = 0, alive = 0, step = 1;
  std::vector<char> done;

  int first() const {
    for (int i = 0; i < size; ++i) {
      const int t = step > 0 ? i : size - 1 - i;
      if (!done[t]) return t;
    }
    return -1;
  }
  int after(int t) const {
    for (int u = t + step; u >= 0 && u < size; u += step)
      if (!done[u]) return u;
    return -1;
  }
  void wait_turn(std::unique_lock<std::mutex>& lk, int t) {
    if (!cv[t].wait_for(lk, std::chrono::seconds(600), [&] { return turn == t; })) {
      std::fprintf(stderr, "cuda_emu: a block barrier timed out (a thread that missed __syncthreads?)\n");
      std::abort();
    }
  }
  void start(int t) {
    std::unique_lock<std::mutex> lk(m);
    wait_turn(lk, t);
  }
  void barrier(int t) {
    std::unique_lock<std::mutex> lk(m);
    if (++arrived == alive) {
      arrived = 0;
      turn = first();
    } else {
      turn = after(t);
    }
    if (turn >= 0) cv[turn].notify_one();
    wait_turn(lk, t);
  }
  void finish(int t) {
    std::unique_lock<std::mutex> lk(m);
    done[t] = 1;
    --alive;
    turn = arrived > 0 && arrived == alive ? (arrived = 0, first()) : after(t);
    if (turn >= 0) cv[turn].notify_one();
  }
};
inline thread_local EmuTurns* emu_turns = nullptr;

inline void emu_no_turns(const char* what) {
  if (emu_turns) {
    std::fprintf(stderr, "cuda_emu: %s is not taken when threads run one at a time\n", what);
    std::abort();
  }
}

inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_no_turns("__syncwarp");
  emu_warp->wait();
}
// The block's barrier waits longer: one warp may run a whole loop of
// shuffles while the others wait there.
inline void __syncthreads() {
  if (emu_turns)
    emu_turns->barrier((int)threadIdx.x);
  else
    emu_block->wait(600, "a block barrier (a thread that missed __syncthreads?)");
}

inline float __shfl_sync(unsigned, float v, int src) {
  emu_no_turns("__shfl_sync");
  emu_warp->wait();
  emu_warp->slot[threadIdx.x & 31] = v;
  emu_warp->wait();
  const float r = emu_warp->slot[src & 31];
  emu_warp->wait();
  return r;
}

// One thread's cp.async copies: those issued since its last commit, and
// the committed batches, oldest first.
struct EmuCopy {
  void* dst;
  const void* src;
  size_t n;
};
struct EmuPipeline {
  std::vector<EmuCopy> open;
  std::deque<std::vector<EmuCopy>> batches;
};
inline thread_local EmuPipeline emu_pipe;

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t = 0) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) % n != 0) {
    std::fprintf(stderr, "cuda_emu: misaligned %zu-byte cp.async\n", n);
    std::abort();
  }
  std::memset(dst, 0xff, n);  // NaNs until the copy is waited for
  emu_pipe.open.push_back({dst, src, n});
}
inline void __pipeline_commit() {
  emu_pipe.batches.push_back(std::move(emu_pipe.open));
  emu_pipe.open.clear();
}
// Completes all but the `prior` most recently committed batches.
inline void __pipeline_wait_prior(size_t prior) {
  while (emu_pipe.batches.size() > prior) {
    for (const EmuCopy& c : emu_pipe.batches.front()) std::memcpy(c.dst, c.src, c.n);
    emu_pipe.batches.pop_front();
  }
}

// st.global.cs: a store that is not read again soon.
inline void __stcs(float4* p, float4 v) { *p = v; }

inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline long long clock64() {  // nanoseconds where the card counts cycles
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline float __fdividef(float a, float b) { return a / b; }

constexpr size_t kEmuSmemBytes = 232448;  // the most a block may ask for on an H100
constexpr int kEmuBlocksPerSm = 1;
constexpr int kEmuSms = 2;

template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, T, int, size_t smem) {
  *blocks = smem <= kEmuSmemBytes ? kEmuBlocksPerSm : 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = kEmuSms;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

extern float* emu_smem_base;

template <class... A, size_t... I>
void emu_call(void (*f)(A...), void** args, std::index_sequence<I...>) {
  f(*static_cast<A*>(args[I])...);
}

// Runs every block of a launch of `f`, one after another, all threads of a
// block at once.
template <class... A>
cudaError_t emu_launch(void (*f)(A...), dim3 grid, dim3 block, void** args, size_t smem) {
  if (smem > kEmuSmemBytes || block.x % 32 != 0) return cudaErrorInvalidConfiguration;
  const char* env = std::getenv("QTOS_EMU_THREAD_ORDER");
  const int order = env == nullptr || env[0] == '\0' ? 0 : (std::atoi(env) < 0 ? -1 : 1);
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    if (smem) std::memset(emu_smem_base, 0xff, smem);  // NaNs, as uninitialised shared memory may hold
    std::vector<EmuWarp> warps(block.x / 32);
    EmuBarrier block_barrier;
    block_barrier.size = (int)block.x;
    EmuTurns turns;
    if (order != 0) {
      turns.size = turns.alive = (int)block.x;
      turns.step = order;
      turns.done.assign(block.x, 0);
      turns.cv.reset(new std::condition_variable[block.x]);
      turns.turn = turns.first();
    }
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t) {
      threads.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(bx);
        blockDim = block;
        gridDim = grid;
        emu_warp = &warps[t / 32];
        emu_block = &block_barrier;
        emu_turns = turns.size ? &turns : nullptr;
        if (emu_turns) emu_turns->start((int)t);
        emu_call(f, args, std::index_sequence_for<A...>{});
        if (!emu_pipe.open.empty() || !emu_pipe.batches.empty()) {
          std::fprintf(stderr, "cuda_emu: a thread ended with cp.async copies not waited for\n");
          std::abort();
        }
        if (emu_turns) emu_turns->finish((int)t);
      });
    }
    for (auto& th : threads) th.join();
  }
  return cudaSuccess;
}

// The runtime's typed launch: the kernel's own signature.
template <class... A>
cudaError_t cudaLaunchKernel(void (*f)(A...), dim3 grid, dim3 block, void** args, size_t smem,
                             cudaStream_t) {
  return emu_launch(f, grid, block, args, smem);
}

#ifndef EMU_TYPED_LAUNCH_ONLY
// The untyped launch: the including file names the kernel's signature.
inline cudaError_t cudaLaunchKernel(const void* func, dim3 grid, dim3 block, void** args,
                                    size_t smem, cudaStream_t) {
  return emu_launch(reinterpret_cast<EmuKernelSig*>(const_cast<void*>(func)), grid, block, args, smem);
}
#endif
