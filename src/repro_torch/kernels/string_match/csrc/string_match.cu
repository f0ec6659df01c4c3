// Sliding exact string match for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel string_match_pallas
// (src/repro/kernels/string_match/kernel.py:38, body _make_kernel at :21).
// Same function: out[i] = 1 iff text[i : i + P] == pattern, for every i
// with i + P <= N, and 0 past N - P (all zeros when P > N).
//
// Design.  One block per 4096-byte text tile, the paper's coverage of one
// search command (kernel.py:18).  The block stages its tile plus the P - 1
// halo bytes that follow it, and the pattern (P <= 4096, so at most
// 12 KiB of shared memory), then each thread tests positions
// tid, tid + 256, ... of the tile: it ANDs the P byte compares and stops at
// the first mismatch.  Interleaved (not contiguous) ownership keeps a
// warp's shared-memory reads on neighbouring bytes, free of bank
// conflicts, and its output stores coalesced.  P is a runtime argument:
// the TPU kernel unrolled P compares and compiled once per pattern length.
//
// Bound on this card.  On random text almost every position fails at its
// first or second byte, so the work is a few compares per byte: the kernel
// is bound by bytes, N read and N written (plus P).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;
constexpr int kMaxPattern = 4096;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
string_match_kernel(const uint8_t* __restrict__ text,
                    const uint8_t* __restrict__ pattern,
                    int8_t* __restrict__ out, long n, int p) {
  __shared__ uint8_t s_text[kTile + kMaxPattern - 1];
  __shared__ uint8_t s_pat[kMaxPattern];
  const long t0 = static_cast<long>(blockIdx.x) * kTile;
  const int staged = kTile + (p > 0 ? p - 1 : 0);
  for (int i = threadIdx.x; i < staged; i += kThreads) {
    const long pos = t0 + i;
    s_text[i] = pos < n ? text[pos] : 0;
  }
  for (int i = threadIdx.x; i < p; i += kThreads) s_pat[i] = pattern[i];
  __syncthreads();

  const long last = n - p;  // last position a match may start at
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long pos = t0 + i;
    if (pos >= n) break;
    bool m = pos <= last;
    for (int k = 0; m && k < p; ++k) m = s_text[i + k] == s_pat[k];
    out[pos] = m;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
int string_match_launch(const void* text, const void* pattern, void* out,
                        long n, int p, void* stream) {
  if (n == 0) return 0;
  if (p < 0 || p > kMaxPattern) return static_cast<int>(cudaErrorInvalidValue);
  const long tiles = (n + kTile - 1) / kTile;
  string_match_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), static_cast<const uint8_t*>(pattern),
      static_cast<int8_t*>(out), n, p);
  return static_cast<int>(cudaGetLastError());
}

const char* string_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
