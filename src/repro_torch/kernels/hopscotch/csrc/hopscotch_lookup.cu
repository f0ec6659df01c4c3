// Hopscotch window lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hopscotch_lookup_pallas
// (src/repro/kernels/hopscotch/kernel.py:76, body _lookup_kernel at :39).
// Same function: for each query (home, q_lo, q_hi) the first offset in
// [0, H) at which both 32-bit halves of the table's 64-bit key equal the
// query's, else -1.  The uint32 key planes arrive as int32 bit patterns, in
// the JAX package's split lo/hi layout (shared with the insert path).  A
// slot outside [0, N) never matches: homes may be negative or near N.
//
// Bound on this card.  No arithmetic to speak of, so bytes: the function
// must read t_lo over each query's window up to its first hit (the whole
// window for a miss), t_hi only where t_lo equals the query's low half, and
// 12 bytes of query and 4 of result; a slot that several windows share is
// read once.  Windows of different queries lie scattered over the table,
// so DRAM serves them in 32-byte sectors: an arbitrarily aligned 32-slot
// window of int32 touches 4 or 5 sectors of a plane.  Where the windows
// cover most of the table (2^20 queries over 2^25 slots at H = 128) the
// floor is the plane itself, read once.  At a path's table (2^17 slots,
// 8,192 queries) the grid fits on the card at once, and the launch and the
// dependent round trips bound it instead.
//
// Design.  The first version gave each query a warp: at H = 4 28 of 32
// lanes idled, and only about 8,448 queries were in flight on the card.
// Here:
//  - A group of G lanes per query, G = min(8, H rounded up to a power of
//    two), so a warp serves 32 / G queries: 4 x the old queries in flight
//    at H >= 8 and 8 x at H = 4, and no idle lanes at small H.
//  - Lane l < 32 / G loads query l's home and key halves (coalesced) and
//    __shfl_sync hands them to its group.  Then each lane loads U slots
//    (offset = step base + u G + lane in the group, so a group's lanes read
//    G adjacent slots per u): U independent loads in flight per plane.
//  - t_hi only behind a matching t_lo: a miss reads one plane, not two (a
//    t_lo match of a wrong key is rare), and the round trip a hit adds
//    hides behind other warps.  Loading both planes together, for two
//    round trips in all, measured 0.017-0.13 ms slower at 2^25 slots; at
//    the path's table its median was 0.3 us lower, inside a run-to-run
//    spread of 1.6 us, so one variant stays.
//  - A step covers G U = min(32, H rounded up) offsets; larger windows take
//    several steps, and a group stops at the first step with a hit, so a
//    hit early in a long window reads no more of it.  Each lane keeps its
//    lowest hit; an xor-shuffle minimum over the group gives the first
//    offset.  Lanes 0 .. 32 / G - 1 store their group's result (coalesced).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroupLog2 = 3;      // G <= 8 lanes per query
constexpr int kStepSlots = 32;        // offsets one step covers, at most
constexpr unsigned kFull = 0xffffffffu;

template <int U>
__global__ void __launch_bounds__(kThreads)
hopscotch_lookup_kernel(const int32_t* __restrict__ t_lo,
                        const int32_t* __restrict__ t_hi,
                        const int32_t* __restrict__ homes,
                        const int32_t* __restrict__ q_lo,
                        const int32_t* __restrict__ q_hi,
                        int32_t* __restrict__ out,
                        long n, int q, int window, int log2g) {
  const int g = 1 << log2g;
  const int per_warp = 32 >> log2g;                  // queries per warp
  const int lane = threadIdx.x & 31;
  const long qa = (static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
                  per_warp;                          // the warp's first query
  if (qa >= q) return;                               // uniform across the warp

  // Round trip 1: one lane per query, then each group takes its query.
  int home = 0, lo = 0, hi = 0;
  if (lane < per_warp && qa + lane < q) {
    home = homes[qa + lane];
    lo = q_lo[qa + lane];
    hi = q_hi[qa + lane];
  }
  const int grp = lane >> log2g;
  const int j = lane & (g - 1);
  home = __shfl_sync(kFull, home, grp);
  lo = __shfl_sync(kFull, lo, grp);
  hi = __shfl_sync(kFull, hi, grp);
  const bool real = qa + grp < q;

  // Then per step U slots of t_lo per lane, and of t_hi behind a match.
  int first = INT_MAX;
  for (int base = 0; base < window; base += g * U) {
    const bool open = real && first == INT_MAX;
    const long at = static_cast<long>(home) + base + j;   // slot of u = 0
    int32_t vlo[U], vhi[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int off = base + u * g + j;
      in[u] = open && off < window && at + u * g >= 0 && at + u * g < n;
      vlo[u] = in[u] ? __ldg(t_lo + at + u * g) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = in[u] && vlo[u] == lo;
      vhi[u] = in[u] ? __ldg(t_hi + at + u * g) : 0;
    }
    int mine = INT_MAX;
#pragma unroll
    for (int u = U - 1; u >= 0; --u)                 // lowest u wins
      if (in[u] && vhi[u] == hi) mine = base + u * g + j;
    for (int d = 1; d < g; d <<= 1)                  // minimum over the group
      mine = min(mine, __shfl_xor_sync(kFull, mine, d));
    first = min(first, mine);
    if (!__any_sync(kFull, real && first == INT_MAX && base + g * U < window))
      break;
  }
  const int res = __shfl_sync(kFull, first, (lane << log2g) & 31);
  if (lane < per_warp && qa + lane < q)
    out[qa + lane] = res == INT_MAX ? -1 : res;
}

template <int U>
void launch(long blocks, cudaStream_t st, const void* t_lo, const void* t_hi,
            const void* homes, const void* q_lo, const void* q_hi, void* out,
            long n, int q, int window, int log2g) {
  hopscotch_lookup_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(t_lo), static_cast<const int32_t*>(t_hi),
      static_cast<const int32_t*>(homes), static_cast<const int32_t*>(q_lo),
      static_cast<const int32_t*>(q_hi), static_cast<int32_t*>(out), n, q,
      window, log2g);
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
// Refuses (cudaErrorInvalidValue) a window < 1 and negative sizes.
int hopscotch_lookup_launch(const void* t_lo, const void* t_hi,
                            const void* homes, const void* q_lo,
                            const void* q_hi, void* out, long n, int q,
                            int window, void* stream) {
  if (q == 0) return 0;
  if (q < 0 || n < 0 || window < 1) return static_cast<int>(cudaErrorInvalidValue);
  int log2g = 0;                                     // G = min(8, pow2 >= H)
  while (log2g < kMaxGroupLog2 && (1 << log2g) < window) ++log2g;
  const int g = 1 << log2g;
  const int per_lane = (window + g - 1) / g;         // U = min(32 / G, pow2)
  int u = 1;
  while (u < per_lane && u * g < kStepSlots) u *= 2;
  const long warps = (static_cast<long>(q) + (32 >> log2g) - 1) / (32 >> log2g);
  const long blocks = (warps + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u == 1)
    launch<1>(blocks, st, t_lo, t_hi, homes, q_lo, q_hi, out, n, q, window, log2g);
  else if (u == 2)
    launch<2>(blocks, st, t_lo, t_hi, homes, q_lo, q_hi, out, n, q, window, log2g);
  else
    launch<4>(blocks, st, t_lo, t_hi, homes, q_lo, q_hi, out, n, q, window, log2g);
  return static_cast<int>(cudaGetLastError());
}

const char* hopscotch_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
