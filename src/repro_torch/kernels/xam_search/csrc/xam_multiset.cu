// Fused multi-set XAM (CAM) search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xam_search_multiset_pallas
// (src/repro/kernels/xam_search/kernel.py:225, body _xam_multiset_kernel
// at :181).  Same function, not the same blocking: for every query q the
// kernel returns the first way of plane block_sets[q / block_q] that is
// valid and matches the key on every masked-in bit, else -1; a dead block
// (live_blocks == 0) and an all-zero mask row also give -1.  The TPU's
// +-1 int8 matmul (score == n_selected) is an exact compare in disguise;
// the bitwise test ((col ^ key) & mask) == 0 here is exact too, so the two
// "scorings" of the reference need no separate path.
//
// Bound on this card.  A few integer operations per (query, column, word),
// far below the card's operations-per-byte balance point, so the bound is
// bytes: the keys and masks (2 x Q x R), one plane and validity row per
// distinct live set, the block tables and the (Q,) int32 output.  At
// serving sizes (tens of queries, a few sets) no launch comes near that
// bound: there the kernel is bound by the launch and by its dependent round
// trips to memory -- the block's set id, then its plane -- and the goal is
// to add nothing to those two.
//
// Design.  What held the first version back was latency, not bytes: it
// built each column word from 32 single-byte loads into a shared-memory
// plane behind a barrier, then each warp scanned its queries 32 columns
// at a time with one ballot per step.  Here:
//  - Columns in registers, loaded as rows.  A thread owns 4 adjacent
//    columns; one 4-byte load of a plane row brings their bytes, and the
//    4-row __byte_perm transpose of xam_columns.cuh (shared with the flat
//    search) gives their 32-bit words for int8 and packed8 planes alike.
//    The kernel is templated on the word count (R <= 32, 64, ..., 512), so
//    every row load of a thread is independent and in flight at once.  The
//    validity row is read 4 bytes at a time too.  No shared-memory plane,
//    no barrier before the first compare.
//  - Two round trips.  Each warp loads its first kPrefetch staging steps'
//    key and mask bytes together with the block's set id and liveness; only
//    the plane and validity loads wait for the set id.  A dead block writes
//    -1 and returns without reading its plane.
//  - All columns at once, not a scan.  The block's queries are staged as
//    key and mask words with warp ballots (a warp reads 32 key bytes of a
//    query row in one coalesced load), as in the flat search.  Each thread
//    tests its 4 columns against kQUnroll queries at a time (independent
//    chains: a lone warp per scheduler otherwise waits on each compare), and
//    a ballot per query finds the warp's lowest lane with a hit, which holds
//    its first match since lanes hold increasing columns.  One atomicMin
//    per warp with a hit then lowers the result itself, which the block set
//    to -1 (0xffffffff, the unsigned maximum) before its first barrier.
//    Warps whose columns lie past C skip the compares.
//  - Every shape.  C beyond one block's 1024 columns is walked in column
//    chunks (the atomicMin keeps the running minimum); block_q beyond
//    kQChunk in staged query chunks; ragged or unaligned C takes byte loads;
//    R up to 512.  Shared memory is fixed (kQChunk x 16 key/mask words),
//    whatever C.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xam_columns.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQChunk = 64;           // queries staged in shared memory
constexpr int kPrefetch = 8;          // staging steps a warp loads up front
constexpr int kMaxWords = 16;         // key rows <= 512
constexpr unsigned kNone = 0xffffffffu;
constexpr int kQUnroll = 4;           // queries compared at once

// Bit j set: column col0 + j lies in the plane and is valid.
__device__ __forceinline__ uint32_t valid_bits(const int8_t* __restrict__ vrow,
                                               int c, long col0, bool vec) {
  uint32_t v = 0;
  if (vec) {
    const uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(vrow + col0));
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      v |= static_cast<uint32_t>(((x >> (8 * j)) & 0xffu) != 0) << j;
  } else {
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      if (col0 + j < c && __ldg(vrow + col0 + j) != 0) v |= 1u << j;
  }
  return v;
}

// One staged (query, word) step: lane k holds key and mask byte k of the
// word's 32 rows; two ballots make them the word.
__device__ __forceinline__ void stage_word(uint2* s_km, int p, int kb, int mb,
                                           int lane) {
  const uint32_t kw = __ballot_sync(0xffffffffu, kb & 1);
  const uint32_t mw = __ballot_sync(0xffffffffu, mb != 0);
  if (lane == 0) s_km[p] = make_uint2(kw, mw);
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
xam_multiset_kernel(const int8_t* __restrict__ keys,
                    const int8_t* __restrict__ masks,
                    const uint8_t* __restrict__ planes,
                    const int8_t* __restrict__ valid,
                    const int32_t* __restrict__ block_sets,
                    const int32_t* __restrict__ live_blocks,
                    int32_t* __restrict__ out,
                    int n_sets, int block_q, int r, int rp, int c,
                    int packed, int vec_ok) {
  __shared__ uint2 s_km[kQChunk * NW];   // (key, mask) words per query
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long q0 = static_cast<long>(blockIdx.x) * block_q;
  // The result doubles as the running minimum: -1 is 0xffffffff, larger
  // than any column as unsigned, and a hit lowers it with atomicMin.
  unsigned* best = reinterpret_cast<unsigned*>(out + q0);

  // The set id and liveness, and the key/mask bytes of this warp's first
  // kPrefetch staging steps: independent loads, one round trip together.
  const int s = block_sets[blockIdx.x];
  const int live_block = live_blocks[blockIdx.x];
  const int nq_first = min(kQChunk, block_q);
  int pf_k[kPrefetch], pf_m[kPrefetch];
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    const int p = warp + i * n_warps;
    const int row = 32 * (p % NW) + lane;
    pf_k[i] = pf_m[i] = 0;
    if (p < nq_first * NW && row < r) {
      const long at = (q0 + p / NW) * r + row;
      pf_k[i] = keys[at];
      pf_m[i] = masks[at];
    }
  }
  for (int i = threadIdx.x; i < block_q; i += blockDim.x) best[i] = kNone;
  // Dead block (bucket padding).  An out-of-range set id cannot come from
  // the host grouping (ops.py validates it); it is treated as dead rather
  // than read out of bounds.  Uniform across the block.
  if (live_block == 0 || s < 0 || s >= n_sets) return;

  const uint8_t* plane = planes + static_cast<size_t>(s) * rp * c;
  const int8_t* vrow = valid + static_cast<size_t>(s) * c;
  const long span = static_cast<long>(blockDim.x) * kColsPerThread;
  const bool one_q_chunk = block_q <= kQChunk;
  bool staged = false;
  for (long cbase = 0; cbase < c; cbase += span) {
    // This thread's 4 columns as words (bit k of colw[w][j] is logical row
    // 32w + k of column col0 + j) and their validity bits.  Loaded before
    // the ballots, so the loads are in flight while the warps stage keys.
    const long col0 = cbase + static_cast<long>(threadIdx.x) * kColsPerThread;
    const bool vec = vec_ok && col0 + kColsPerThread <= c;
    uint32_t colw[NW][kColsPerThread];
    load_columns<NW>(plane, r, c, col0, col0 < c, vec, packed, colw);
    const uint32_t vbits = valid_bits(vrow, c, col0, vec);

    for (int qc = 0; qc < block_q; qc += kQChunk) {
      const int nq = min(kQChunk, block_q - qc);
      if (!(staged && one_q_chunk)) {
        if (staged) __syncthreads();      // the staged chunk is consumed
        // One warp per (query, word): a coalesced 32-byte load of the key
        // and mask row, two ballots.  p is uniform across the warp; the
        // first chunk's first kPrefetch steps come from registers.
        const int steps = nq * NW;
        int p = warp;
        if (!staged) {
#pragma unroll
          for (int i = 0; i < kPrefetch; ++i, p += n_warps)
            if (p < steps) stage_word(s_km, p, pf_k[i], pf_m[i], lane);
        }
#pragma unroll 4
        for (; p < steps; p += n_warps) {
          const int row = 32 * (p % NW) + lane;
          const long at = (q0 + qc + p / NW) * r + row;
          stage_word(s_km, p, row < r ? keys[at] : 0, row < r ? masks[at] : 0,
                     lane);
        }
        __syncthreads();                  // also orders the -1s above
        staged = true;
      }
      // Warps whose columns all lie past C have nothing to compare.
      if (cbase + static_cast<long>(warp) * 32 * kColsPerThread >= c) continue;
      // kQUnroll queries at a time: independent compare chains, one branch.
      for (int qi0 = 0; qi0 < nq; qi0 += kQUnroll) {
        uint32_t hits[kQUnroll];
        unsigned lanes[kQUnroll];
        unsigned any_lanes = 0;
#pragma unroll
        for (int k = 0; k < kQUnroll; ++k) {
          const int qi = qi0 + k;         // < kQChunk: s_km stays in bounds
          uint32_t miss[kColsPerThread] = {0u, 0u, 0u, 0u};
          uint32_t any_mask = 0;
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const uint2 km = s_km[qi * NW + w];
            any_mask |= km.y;
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j)
              miss[j] |= (colw[w][j] ^ km.x) & km.y;
          }
          hits[k] = qi < nq && any_mask != 0
                        ? vbits & (static_cast<uint32_t>(miss[0] == 0) |
                                   static_cast<uint32_t>(miss[1] == 0) << 1 |
                                   static_cast<uint32_t>(miss[2] == 0) << 2 |
                                   static_cast<uint32_t>(miss[3] == 0) << 3)
                        : 0u;
          lanes[k] = __ballot_sync(0xffffffffu, hits[k] != 0);
          any_lanes |= lanes[k];
        }
        if (any_lanes == 0) continue;     // uniform across the warp
        // Lanes hold increasing columns: a query's first hit in this warp is
        // in its lowest lane with a hit.
#pragma unroll
        for (int k = 0; k < kQUnroll; ++k) {
          if (lanes[k] == 0) continue;
          const int l = __ffs(lanes[k]) - 1;
          const uint32_t h = __shfl_sync(0xffffffffu, hits[k], l);
          if (lane == 0)
            atomicMin(best + qc + qi0 + k,
                      static_cast<unsigned>(cbase + (warp * 32 + l) *
                                            kColsPerThread + __ffs(h) - 1));
        }
      }
    }
  }
}

template <int NW>
void launch(int n_blocks, cudaStream_t st, const void* keys,
            const void* masks, const void* planes, const void* valid,
            const void* block_sets, const void* live_blocks, void* out,
            int n_sets, int block_q, int r, int rp, int c, int packed,
            int vec_ok) {
  xam_multiset_kernel<NW><<<n_blocks, kThreads, 0, st>>>(
      static_cast<const int8_t*>(keys), static_cast<const int8_t*>(masks),
      static_cast<const uint8_t*>(planes), static_cast<const int8_t*>(valid),
      static_cast<const int32_t*>(block_sets),
      static_cast<const int32_t*>(live_blocks), static_cast<int32_t*>(out),
      n_sets, block_q, r, rp, c, packed, vec_ok);
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
// Refuses (cudaErrorInvalidValue) R > 512, a packed row count that is not
// R / 8 (an int8 one that is not R), and negative sizes.
int xam_multiset_launch(const void* keys, const void* masks,
                        const void* planes, const void* valid,
                        const void* block_sets, const void* live_blocks,
                        void* out, int n_blocks, int n_sets, int block_q,
                        int r, int rp, int c, int packed, void* stream) {
  if (n_blocks == 0) return 0;
  if (n_blocks < 0 || n_sets < 0 || block_q < 1 || c < 0 || r < 0 ||
      r > kMaxWords * 32 || (packed ? r != rp * 8 : r != rp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nw = r <= 32 ? 1 : (r + 31) / 32;
  const int vec_ok = r > 0 && c % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(planes) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(valid) & 3) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nw <= 1)
    launch<1>(n_blocks, st, keys, masks, planes, valid, block_sets, live_blocks, out, n_sets, block_q, r, rp, c, packed, vec_ok);
  else if (nw <= 2)
    launch<2>(n_blocks, st, keys, masks, planes, valid, block_sets, live_blocks, out, n_sets, block_q, r, rp, c, packed, vec_ok);
  else if (nw <= 4)
    launch<4>(n_blocks, st, keys, masks, planes, valid, block_sets, live_blocks, out, n_sets, block_q, r, rp, c, packed, vec_ok);
  else if (nw <= 8)
    launch<8>(n_blocks, st, keys, masks, planes, valid, block_sets, live_blocks, out, n_sets, block_q, r, rp, c, packed, vec_ok);
  else
    launch<16>(n_blocks, st, keys, masks, planes, valid, block_sets, live_blocks, out, n_sets, block_q, r, rp, c, packed, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

const char* xam_multiset_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
