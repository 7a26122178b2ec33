// A CPU stand-in for the part of the CUDA runtime and device library that
// qtos_torch/csrc/btd.cu, tick.cu, assemble.cu and lm_restore.cu use, so that a
// kernel's own source compiles with a host C++ compiler and runs on the CPU
// (tests/test_torch_btd_emu.py, tests/test_torch_tick_emu.py,
// tests/test_torch_assemble_emu.py, tests/test_torch_lm_restore.py).
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
// of threadIdx.x, each from one barrier (__syncthreads, __syncwarp, a
// shuffle) to the next: a read that a missing barrier leaves unordered then
// reads shared memory, in one of the two orders, before the thread that
// writes it has run.
//
// A launch through the typed cudaLaunchKernel needs nothing more.  For one
// through the untyped (const void*) launch the including file defines
// EmuKernelSig, the kernel's signature, before it includes this header; a
// file that launches only by type defines EMU_TYPED_LAUNCH_ONLY instead.
// The including file also defines `emu_smem_base`, the dynamic shared
// memory.  Where it sets `emu_smem_guard` (a page-aligned array of
// kEmuSmemBytes + kEmuSmemGuardBytes), the pages past the launch's shared
// memory are made inaccessible while its blocks run, so a read past the
// end faults where that end falls on a page boundary.
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
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <sys/mman.h>
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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };

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
// (QTOS_EMU_THREAD_ORDER): `turn` is the thread that may run.  A thread
// passes the turn on when it waits at a barrier and when it ends; it goes to
// the next thread in the launch's order (ascending or descending
// threadIdx.x, cyclically) that is not waiting, so after the last thread of
// a block barrier arrives the first one runs again.  Every barrier is a
// group of threads keyed by what it joins: kBlockKey the block
// (__syncthreads, which counts the threads still running), kWarpKey + w the
// 32 threads of warp w (__syncwarp, and the shuffles' exchanges),
// kNamedKey + id the named barrier id (bar.sync, bar.arrive).
struct EmuTurns {
  static constexpr long kBlockKey = 0, kWarpKey = 1, kNamedKey = 1 << 20;
  enum State : char { kRun, kWait, kDone };
  struct Group {
    std::vector<int> waiting;
    int arrived = 0;
  };
  std::mutex m;
  std::unique_ptr<std::condition_variable[]> cv;  // one per thread: a pass wakes only its thread
  int size = 0, turn = -1, alive = 0, step = 1;
  std::vector<char> state;
  std::map<long, Group> groups;

  int first() const {
    for (int i = 0; i < size; ++i) {
      const int t = step > 0 ? i : size - 1 - i;
      if (state[t] == kRun) return t;
    }
    return -1;
  }
  // The next thread after t, cyclically, that may run (t itself last).
  int after(int t) const {
    for (int i = 1; i <= size; ++i) {
      const int u = ((t + step * i) % size + size) % size;
      if (state[u] == kRun) return u;
    }
    return -1;
  }
  void wait_turn(std::unique_lock<std::mutex>& lk, int t) {
    if (!cv[t].wait_for(lk, std::chrono::seconds(600), [&] { return turn == t; })) {
      std::fprintf(stderr, "cuda_emu: a barrier timed out (a thread that missed __syncthreads?)\n");
      std::abort();
    }
  }
  // Gives the turn to the next thread that may run and waits for it to come back.
  void pass(std::unique_lock<std::mutex>& lk, int t) {
    turn = after(t);
    if (turn < 0) {
      std::fprintf(stderr, "cuda_emu: every thread waits at a barrier that no thread can complete\n");
      std::abort();
    }
    if (turn != t) {
      cv[turn].notify_one();
      wait_turn(lk, t);
    }
  }
  void release(long key) {
    auto it = groups.find(key);
    for (int u : it->second.waiting) state[u] = kRun;
    groups.erase(it);
  }
  void start(int t) {
    std::unique_lock<std::mutex> lk(m);
    wait_turn(lk, t);
  }
  // Thread t arrives at the barrier `key` of `count` threads (0: every
  // thread still running) and waits until the group is complete.
  void barrier(int t, long key, int count) {
    std::unique_lock<std::mutex> lk(m);
    Group& g = groups[key];
    if (++g.arrived >= (count ? count : alive)) {
      release(key);
    } else {
      g.waiting.push_back(t);
      state[t] = kWait;
    }
    pass(lk, t);
  }
  // A thread arrives at the barrier `key` of `count` threads and goes on.
  void arrive(long key, int count) {
    std::unique_lock<std::mutex> lk(m);
    if (++groups[key].arrived >= count) release(key);
  }
  void finish(int t) {
    std::unique_lock<std::mutex> lk(m);
    state[t] = kDone;
    --alive;
    auto it = groups.find(kBlockKey);
    if (it != groups.end() && it->second.arrived >= alive) release(kBlockKey);
    turn = after(t);
    if (turn >= 0) {
      cv[turn].notify_one();
    } else {
      for (int u = 0; u < size; ++u) {
        if (state[u] == kWait) {
          std::fprintf(stderr, "cuda_emu: a thread ended while others wait at a barrier it never reaches\n");
          std::abort();
        }
      }
    }
  }
};
inline thread_local EmuTurns* emu_turns = nullptr;

// A named barrier of the block (PTX bar.sync / bar.arrive with a thread
// count) when its threads run at once.
struct EmuNamedBarrier {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0, gen = 0;

  void arrive(int count, bool wait) {
    std::unique_lock<std::mutex> lk(m);
    const int g = gen;
    if (++arrived == count) {
      arrived = 0;
      ++gen;
      cv.notify_all();
      return;
    }
    if (wait && !cv.wait_for(lk, std::chrono::seconds(60), [&] { return gen != g; })) {
      std::fprintf(stderr, "cuda_emu: a named barrier timed out (a thread that missed bar.sync or bar.arrive?)\n");
      std::abort();
    }
  }
};
constexpr int kEmuNamedBarriers = 16;
inline thread_local EmuNamedBarrier* emu_named = nullptr;

inline void emu_warp_wait() {
  if (emu_turns)
    emu_turns->barrier((int)threadIdx.x, EmuTurns::kWarpKey + threadIdx.x / 32, 32);
  else
    emu_warp->wait();
}

inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_wait(); }
// The block's barrier waits longer: one warp may run a whole loop of
// shuffles while the others wait there.
inline void __syncthreads() {
  if (emu_turns)
    emu_turns->barrier((int)threadIdx.x, EmuTurns::kBlockKey, 0);
  else
    emu_block->wait(600, "a block barrier (a thread that missed __syncthreads?)");
}

// Named barrier `id` (1..15; 0 is __syncthreads') of `count` threads:
// bar_sync waits for the others, bar_arrive counts the thread and goes on.
// On the card these are the PTX instructions of the same names.
inline void bar_sync(int id, int count) {
  if (emu_turns)
    emu_turns->barrier((int)threadIdx.x, EmuTurns::kNamedKey + id, count);
  else
    emu_named[id].arrive(count, true);
}
inline void bar_arrive(int id, int count) {
  if (emu_turns)
    emu_turns->arrive(EmuTurns::kNamedKey + id, count);
  else
    emu_named[id].arrive(count, false);
}
#define QTOS_EMU_NAMED_BARRIERS 1

inline float __shfl_sync(unsigned, float v, int src) {
  emu_warp_wait();
  emu_warp->slot[threadIdx.x & 31] = v;
  emu_warp_wait();
  const float r = emu_warp->slot[src & 31];
  emu_warp_wait();
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
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  *value = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? (int)kEmuSmemBytes : kEmuSms;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

extern float* emu_smem_base;
constexpr size_t kEmuSmemGuardBytes = 4096;
inline bool emu_smem_guard = false;

// Makes the guarded array's pages past `smem` bytes inaccessible (on) or
// accessible again (off).
inline void emu_guard_smem(size_t smem, bool on) {
  if (!emu_smem_guard) return;
  const size_t page = kEmuSmemGuardBytes;
  const size_t from = (smem + page - 1) / page * page;
  const size_t to = (kEmuSmemBytes + page) / page * page;  // the array's last whole page
  char* base = reinterpret_cast<char*>(emu_smem_base);
  if (from < to && mprotect(base + from, to - from, on ? PROT_NONE : PROT_READ | PROT_WRITE) != 0) {
    std::fprintf(stderr, "cuda_emu: mprotect of the shared memory's guard failed\n");
    std::abort();
  }
}

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
    emu_guard_smem(smem, true);
    std::vector<EmuWarp> warps(block.x / 32);
    EmuBarrier block_barrier;
    block_barrier.size = (int)block.x;
    std::unique_ptr<EmuNamedBarrier[]> named(new EmuNamedBarrier[kEmuNamedBarriers]);
    EmuTurns turns;
    if (order != 0) {
      turns.size = turns.alive = (int)block.x;
      turns.step = order;
      turns.state.assign(block.x, EmuTurns::kRun);
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
        emu_named = named.get();
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
    emu_guard_smem(smem, false);
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
