// Sliding exact string match for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel string_match_pallas
// (src/repro/kernels/string_match/kernel.py:38, body _make_kernel at :21).
// Same function: out[i] = 1 iff text[i : i + P] == pattern, for every i
// with i + P <= N, and 0 past N - P (all zeros when P > N).  P is a
// run-time argument from 0 to 4096; the TPU kernel unrolled P compares and
// compiled once per pattern length.
//
// Bound on this card.  On random text almost every position fails at its
// first bytes, so the work is a few operations per byte: the kernel is
// bound by bytes, N read and N written (plus P).  A text of one repeated
// byte is the worst case: every position runs its whole compare.
//
// Design.  A byte-per-thread version moved 32 bytes per warp load and
// store instruction and was bound by that, not by the memory.  Here:
//  - One block per 16 KiB text tile.  It stages the tile, its P - 1 halo
//    bytes and a few bytes of slack in shared memory with 16-byte loads of
//    16-byte-aligned chunks.  The text's base may sit at any byte offset
//    (a view such as text[3:]): chunks are aligned in memory, the tile
//    starts `off` = base % 16 bytes into the staged buffer, and only the
//    text's first and last chunks, which hold bytes outside it, are loaded
//    byte by byte.  Nothing is copied or padded by the caller.
//  - A thread tests 16 consecutive positions.  It reads them from shared
//    memory as three 16-byte chunks (consecutive threads read consecutive
//    chunks: no bank conflicts), realigns them by `off` with funnel shifts,
//    and forms each position's 4-byte window.  Against the pattern's first
//    4 bytes that window decides a position for P <= 4 (masked to P bytes)
//    and filters candidates for P > 4.  The group's candidates then compare
//    the rest of the pattern together, 4 bytes a step (the same 20-byte
//    read at offset k), and stop when none is left: at once on random
//    text, after P / 4 steps on a text of one repeated byte.
//  - The 16 flags leave as one 16-byte store; the text's last group, which
//    ends past N, stores byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16384;
constexpr int kMaxPattern = 4096;
constexpr int kThreads = 256;
constexpr int kGroups = kTile / 16;          // 16 positions per group
// Staged bytes: off (< 16) + tile + max(P - 1, 3) + 4 of slack, in chunks.
constexpr int kChunks = kTile / 16 + kMaxPattern / 16 + 4;
constexpr int kStageIters = (kChunks + kThreads - 1) / kThreads;

// Text bytes [16 * chunk + rem, 16 * chunk + rem + 20) of the staged
// buffer as 5 little-endian words, from three 16-byte shared-memory reads
// (consecutive threads read consecutive chunks: no bank conflicts).  rem
// (0 .. 15) is the same for every thread of the block.
__device__ __forceinline__ void bytes20(const uint4* s, int chunk, int rem,
                                        uint32_t x[5]) {
  const uint4 c0 = s[chunk], c1 = s[chunk + 1], c2 = s[chunk + 2];
  const uint32_t a[12] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y,
                          c1.z, c1.w, c2.x, c2.y, c2.z, c2.w};
  const int d = rem >> 2;
  const int sh = 8 * (rem & 3);
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const uint32_t lo = d == 0 ? a[m] : d == 1 ? a[m + 1]
                      : d == 2 ? a[m + 2] : a[m + 3];
    const uint32_t hi = d == 0 ? a[m + 1] : d == 1 ? a[m + 2]
                      : d == 2 ? a[m + 3] : a[m + 4];
    x[m] = __funnelshift_r(lo, hi, sh);
  }
}

// Bit t set where the 4 bytes at position t (0 .. 15) of x, masked by keep,
// differ from word.
__device__ __forceinline__ uint32_t mismatches(const uint32_t x[5],
                                               uint32_t word, uint32_t keep) {
  uint32_t bad = 0;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const uint32_t win = __funnelshift_r(x[t >> 2], x[(t >> 2) + 1], 8 * (t & 3));
    bad |= static_cast<uint32_t>(((win ^ word) & keep) != 0) << t;
  }
  return bad;
}

__global__ void __launch_bounds__(kThreads)
string_match_kernel(const uint8_t* __restrict__ text,
                    const uint8_t* __restrict__ pattern,
                    int8_t* __restrict__ out, long long n, int p) {
  __shared__ uint4 s_text[kChunks];
  __shared__ uint32_t s_pat[kMaxPattern / 4 + 1];
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(text) & 15);
  // Chunk k covers text bytes [t0 - off + 16k, t0 - off + 16k + 16).
  const long long base = t0 - off;
  const int halo = p > 4 ? p - 1 : 3;
  const int n_stage = (off + kTile + halo + 4 + 15) / 16;

  // Stage: every load of this thread is issued before any store.
  uint4 v[kStageIters];
#pragma unroll
  for (int j = 0; j < kStageIters; ++j) {
    const int k = threadIdx.x + j * kThreads;
    const long long lo = base + 16LL * k;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (k < n_stage && lo < n) {
      if (lo >= 0 && lo + 16 <= n) {
        v[j] = __ldg(reinterpret_cast<const uint4*>(text + lo));
      } else {                         // the text's first or last chunk
        uint32_t wds[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const long long pos = lo + b;
          if (pos >= 0 && pos < n)
            wds[b >> 2] |= static_cast<uint32_t>(text[pos]) << (8 * (b & 3));
        }
        v[j] = make_uint4(wds[0], wds[1], wds[2], wds[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kStageIters; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < n_stage) s_text[k] = v[j];
  }
  for (int i = threadIdx.x; i < kMaxPattern / 4 + 1; i += kThreads) {
    uint32_t w = 0;
    if (4 * i < p) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * i + b < p) w |= static_cast<uint32_t>(pattern[4 * i + b]) << (8 * b);
    }
    s_pat[i] = w;
  }
  __syncthreads();

  const long long last = n - p;        // last position a match may start at
  const uint32_t head_keep = p >= 4 ? 0xffffffffu : (1u << (8 * p)) - 1u;
#pragma unroll 2
  for (int g = threadIdx.x; g < kGroups; g += kThreads) {
    const long long pos0 = t0 + 16LL * g;
    if (pos0 >= n) break;
    // Positions pos0 .. pos0 + 15 that may start a match, then those whose
    // first 4 bytes equal the pattern's (all of it for P <= 4).
    const long long room = last - pos0 + 1;
    uint32_t alive = room >= 16 ? 0xffffu : room > 0 ? (1u << room) - 1u : 0u;
    uint32_t x[5];
    bytes20(s_text, g, off, x);
    alive &= ~mismatches(x, s_pat[0], head_keep);
    // The candidates compare the rest, 4 pattern bytes a step, all 16 at
    // once; the loop ends when none is left (at once on random text).
    for (int k = 4; alive != 0 && k < p; k += 4) {
      const uint32_t keep = p - k >= 4 ? 0xffffffffu : (1u << (8 * (p - k))) - 1u;
      bytes20(s_text, g + ((off + k) >> 4), (off + k) & 15, x);
      alive &= ~mismatches(x, s_pat[k >> 2], keep);
    }
    uint32_t flags[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t nib = alive >> (4 * w);    // positions 4w .. 4w + 3
      flags[w] = (nib & 1u) | (nib & 2u) << 7 | (nib & 4u) << 14 |
                 (nib & 8u) << 21;
    }
    if (pos0 + 16 <= n) {
      *reinterpret_cast<uint4*>(out + pos0) =
          make_uint4(flags[0], flags[1], flags[2], flags[3]);
    } else {
      for (int t = 0; pos0 + t < n; ++t)
        out[pos0 + t] = static_cast<int8_t>((flags[t >> 2] >> (8 * (t & 3))) & 1);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
// `out` must be 16-byte aligned (a fresh allocation is); `text` may sit at
// any byte offset.
int string_match_launch(const void* text, const void* pattern, void* out,
                        long n, int p, void* stream) {
  if (n == 0) return 0;
  if (p < 0 || p > kMaxPattern) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long tiles = (n + kTile - 1) / kTile;
  string_match_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const uint8_t*>(pattern),
      static_cast<int8_t*>(out), static_cast<long long>(n), p);
  return static_cast<int>(cudaGetLastError());
}

const char* string_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
