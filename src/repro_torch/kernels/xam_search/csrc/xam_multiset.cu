// Fused multi-set XAM (CAM) search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xam_search_multiset_pallas
// (src/repro/kernels/xam_search/kernel.py:225, body _xam_multiset_kernel
// at :181).  Same function, not the same blocking: for every query q the
// kernel returns the first way of plane block_sets[q / block_q] that is
// valid and matches the key on every masked-in bit, else -1; a dead block
// (live_blocks == 0) and an all-zero mask row also give -1.
//
// Design.  One CUDA block per query block; the block reads its own set id
// and liveness (the TPU kernel had them scalar-prefetched).  A live block
// stages its set's plane in shared memory as 32-bit column words (bit
// r % 32 of word r / 32 is logical key row r; packed8 planes are unpacked
// LSB-first on the way in) plus the validity row.  Then each warp takes
// one query at a time: the query's key and mask rows become words with
// one __ballot_sync per 32 rows, every lane tests one column per step
// ("all masked-in bits equal" is ((col ^ key) & mask) == 0 over the words,
// ANDed with validity), and a second ballot over the 32 lanes gives the
// first matching column of the step, so the scan stops at the first hit.
// The TPU's +-1 int8 matmul (score == n_selected) is an exact-compare in
// disguise; the bitwise test here is exact too, so the two "scoring"
// modes of the reference need no separate path.
//
// Bound on this card.  The work is a few integer ops per (query, column)
// word, far below the 3.35 TB/s x ~300 op/byte balance point: the kernel
// is bound by the bytes it must move — the keys and masks (2 x Q x R
// bytes), one plane and validity row per distinct live set, the block
// tables and the (Q,) int32 output — and, at serving sizes (tens of
// queries, a few sets), by launch latency.  The design reads every plane
// byte once per block and keeps the per-query scan in shared memory.
// Faster variants (cp.async/TMA staging, several query blocks per CUDA
// block) are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 16;  // key rows <= 512

__global__ void __launch_bounds__(kThreads)
xam_multiset_kernel(const int8_t* __restrict__ keys,
                    const int8_t* __restrict__ masks,
                    const uint8_t* __restrict__ planes,
                    const int8_t* __restrict__ valid,
                    const int32_t* __restrict__ block_sets,
                    const int32_t* __restrict__ live_blocks,
                    int32_t* __restrict__ out,
                    int n_sets, int block_q, int r, int rp, int c,
                    int packed) {
  extern __shared__ uint32_t smem[];
  const int nw = (r + 31) / 32;
  uint32_t* colw = smem;                                        // [nw][c]
  uint8_t* vld = reinterpret_cast<uint8_t*>(colw + nw * c);     // [c]

  const int b = blockIdx.x;
  const long q0 = static_cast<long>(b) * block_q;
  const int s = block_sets[b];
  // Dead block (bucket padding).  An out-of-range set id cannot come from
  // the host grouping (ops.py validates it); it is treated as dead rather
  // than read out of bounds.
  if (live_blocks[b] == 0 || s < 0 || s >= n_sets) {
    for (int i = threadIdx.x; i < block_q; i += blockDim.x) out[q0 + i] = -1;
    return;
  }

  const uint8_t* plane = planes + static_cast<size_t>(s) * rp * c;
  for (int col = threadIdx.x; col < c; col += blockDim.x) {
    for (int wi = 0; wi < nw; ++wi) {
      uint32_t word = 0;
      if (packed) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pr = wi * 4 + k;
          if (pr < rp)
            word |= static_cast<uint32_t>(plane[static_cast<size_t>(pr) * c + col])
                    << (8 * k);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int row = wi * 32 + k;
          if (row < r)
            word |= static_cast<uint32_t>(plane[static_cast<size_t>(row) * c + col] & 1)
                    << k;
        }
      }
      colw[wi * c + col] = word;
    }
    vld[col] = valid[static_cast<size_t>(s) * c + col] != 0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int qi = warp; qi < block_q; qi += kWarps) {
    const long q = q0 + qi;
    const int8_t* krow = keys + q * r;
    const int8_t* mrow = masks + q * r;
    uint32_t kw[kMaxWords];
    uint32_t mw[kMaxWords];
    bool any_mask = false;
#pragma unroll
    for (int wi = 0; wi < kMaxWords; ++wi) {
      kw[wi] = 0;
      mw[wi] = 0;
      if (wi < nw) {
        const int row = wi * 32 + lane;
        const int kb = row < r ? (krow[row] & 1) : 0;
        const int mb = row < r ? (mrow[row] != 0) : 0;
        kw[wi] = __ballot_sync(0xffffffffu, kb);
        mw[wi] = __ballot_sync(0xffffffffu, mb);
        any_mask |= mw[wi] != 0;
      }
    }
    int first = -1;
    if (any_mask) {
      for (int base = 0; base < c; base += 32) {
        const int col = base + lane;
        bool hit = col < c && vld[col];
        if (hit) {
#pragma unroll
          for (int wi = 0; wi < kMaxWords; ++wi)
            if (wi < nw) hit &= ((colw[wi * c + col] ^ kw[wi]) & mw[wi]) == 0;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (ballot) {
          first = base + __ffs(ballot) - 1;
          break;
        }
      }
    }
    if (lane == 0) out[q] = first;
  }
}

// Bytes of dynamic shared memory one live block stages (kernel.py's
// smem_bytes mirrors this to validate before launching).
int smem_bytes(int r, int c) {
  const int nw = (r + 31) / 32;
  return nw * c * 4 + ((c + 3) / 4) * 4;
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
int xam_multiset_launch(const void* keys, const void* masks,
                        const void* planes, const void* valid,
                        const void* block_sets, const void* live_blocks,
                        void* out, int n_blocks, int n_sets, int block_q,
                        int r, int rp, int c, int packed, void* stream) {
  if (n_blocks == 0) return 0;
  if (r > kMaxWords * 32) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(r, c);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        xam_multiset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  xam_multiset_kernel<<<n_blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(keys), static_cast<const int8_t*>(masks),
      static_cast<const uint8_t*>(planes), static_cast<const int8_t*>(valid),
      static_cast<const int32_t*>(block_sets),
      static_cast<const int32_t*>(live_blocks), static_cast<int32_t*>(out),
      n_sets, block_q, r, rp, c, packed);
  return static_cast<int>(cudaGetLastError());
}

const char* xam_multiset_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
