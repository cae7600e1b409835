// Device time stamps for the port's spans (diffusion_extensions_tpu_torch/obs.py).
//
// Replaces no TPU kernel: the JAX package has no spans inside a step.  It
// was added because a step replayed from a CUDA graph runs no Python, so a
// span inside it can only be timed by work that the graph itself holds.
// CUDA events cannot do it: one recorded inside a capture is overwritten by
// every replay, and the host reads it while later replays are in flight.
//
// One thread reads %globaltimer (nanoseconds, the same clock on every SM)
// and writes it into up to kMaxSlots slots of the current row of a ring of
// `rows` x `slots` int64 values in device memory.  The row is a counter in
// device memory too, so each replay of a graph writes a row of its own.
// With `advance` (the outermost span's end) the kernel zeroes the next row
// (a slot left at 0 was not stamped) and moves the counter on.  Stream
// order puts the stamp after every kernel issued before it, and before
// every kernel issued after it.
//
// Bound on this card: nothing but its launch, a few microseconds inside a
// graph; it reads one value and writes at most kMaxSlots + slots.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 4;

struct Slots {
  int n;
  int slot[kMaxSlots];
};

__global__ void obs_stamp_kernel(long long* ring, long long* row, long long rows, int slots,
                                 Slots which, int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long r = *row;
  long long* line = ring + (r % rows) * slots;
  for (int i = 0; i < which.n; ++i) line[which.slot[i]] = (long long)now;
  if (advance) {
    long long* next = ring + ((r + 1) % rows) * slots;
    for (int i = 0; i < slots; ++i) next[i] = 0;
    *row = r + 1;
  }
}

}  // namespace

extern "C" int obs_stamp_launch(void* ring, void* row, long long rows, int slots, int n,
                                int s0, int s1, int s2, int s3, int advance, void* stream) {
  if (n < 0 || n > kMaxSlots || rows <= 0 || slots <= 0) return (int)cudaErrorInvalidValue;
  Slots which{n, {s0, s1, s2, s3}};
  for (int i = 0; i < n; ++i)
    if (which.slot[i] < 0 || which.slot[i] >= slots) return (int)cudaErrorInvalidValue;
  obs_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)ring, (long long*)row, rows,
                                                      slots, which, advance);
  return (int)cudaGetLastError();
}
