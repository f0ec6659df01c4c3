// Hopscotch window lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hopscotch_lookup_pallas
// (src/repro/kernels/hopscotch/kernel.py:76, body _lookup_kernel at :39).
// Same function: for each query (home, q_lo, q_hi) the first offset in
// [0, H) at which both 32-bit halves of the table's 64-bit key equal the
// query's, else -1.  The uint32 key planes arrive as int32 bit patterns.
//
// Design.  One warp per query.  Lane l reads slots home + l + 32k for
// k < ceil(H / 32) (H from 4 to 128 and beyond), compares both halves, and
// a __ballot_sync plus __ffs give the first matching offset of each 32-slot
// step, so the scan stops at the first hit.  The TPU kernel fetched the two
// H-aligned tiles that cover a window because a BlockSpec can only address
// aligned blocks; a direct gather of the H slots replaces both fetches.
// Every slot index is checked against N (H = 4 or 8 windows have little
// pad behind them) and a slot outside the table never matches.
//
// Bound on this card.  No arithmetic to speak of: the kernel is bound by
// bytes, about 8 H bytes of key planes per query (the window's lo and hi
// words) plus 12 bytes of query and 4 of result.  Reads of a window are
// coalesced within the warp; windows of different queries are scattered
// over the table, so at large tables every query costs its own DRAM
// sectors and the achieved rate is set by sector latency, not bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
hopscotch_lookup_kernel(const int32_t* __restrict__ t_lo,
                        const int32_t* __restrict__ t_hi,
                        const int32_t* __restrict__ homes,
                        const int32_t* __restrict__ q_lo,
                        const int32_t* __restrict__ q_hi,
                        int32_t* __restrict__ out,
                        long n, int q, int window) {
  const long qi = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= q) return;  // whole warp: qi is uniform across its lanes
  const long home = homes[qi];
  const int32_t lo = q_lo[qi];
  const int32_t hi = q_hi[qi];
  int first = -1;
  for (int base = 0; base < window; base += 32) {
    const int off = base + lane;
    const long slot = home + off;
    const bool hit = off < window && slot >= 0 && slot < n &&
                     t_lo[slot] == lo && t_hi[slot] == hi;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (ballot) {
      first = base + __ffs(ballot) - 1;
      break;
    }
  }
  if (lane == 0) out[qi] = first;
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
int hopscotch_lookup_launch(const void* t_lo, const void* t_hi,
                            const void* homes, const void* q_lo,
                            const void* q_hi, void* out, long n, int q,
                            int window, void* stream) {
  if (q == 0) return 0;
  const long blocks = (static_cast<long>(q) + kWarps - 1) / kWarps;
  hopscotch_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t_lo), static_cast<const int32_t*>(t_hi),
      static_cast<const int32_t*>(homes), static_cast<const int32_t*>(q_lo),
      static_cast<const int32_t*>(q_hi), static_cast<int32_t*>(out), n, q,
      window);
  return static_cast<int>(cudaGetLastError());
}

const char* hopscotch_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
