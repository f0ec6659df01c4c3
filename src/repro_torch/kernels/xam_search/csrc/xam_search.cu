// Flat masked XAM (CAM) search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xam_search_pallas
// (src/repro/kernels/xam_search/kernel.py:118, body _xam_search_kernel at
// :106 and _match_bitmap at :77).  Same function: for keys/masks (Q, R)
// int8 {0,1} and one stored-bit plane (R, C) int8 -- or (Rp, C) uint8
// packed words, logical row r = bit r % 8 of packed row r / 8, Rp * 8 >= R
// -- out[q, c] = 1 iff every masked-in key bit equals the stored bit of
// column c.  An all-zero mask row matches every column (the TPU kernel's
// score >= n_selected with n_selected == 0).
//
// Design.  A grid over (column blocks, query blocks).  Each thread owns one
// column: it reads that column's bits once (neighbouring threads read
// neighbouring bytes of a plane row, so the loads coalesce) into
// ceil(R/32) 32-bit words held in registers -- a column is only ever read
// by its own thread, so staging it in shared memory would buy nothing.
// The block's queries are staged in shared memory as key and mask words.
// Then the thread loops over the block's queries and writes
// out[q, c] = AND_w (((col_w ^ key_w) & mask_w) == 0), so each query row of
// the output is written by consecutive threads, coalesced along C.  The
// TPU's +-1 matmul (int8 exact, or f32 with a 0.5 guard band) is an exact
// compare in disguise: the bitwise test serves both "scorings".  When the
// grid's y extent is capped, a block walks several query blocks and keeps
// its column words.
//
// Bound on this card.  A few integer operations per (query, column, word),
// so the kernel is bound by bytes: the (Q, C) int8 output dominates at the
// dedup shapes (4096 x 65536 = 268 MB), then the plane (R x C bytes, or
// R x C / 8 packed) and the keys and masks (2 x Q x R bytes).  Byte-wide
// stores of the output are the first thing a faster version would widen.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 256;      // threads per block, one column each
constexpr int kQBlock = 64;     // queries staged per block
constexpr int kMaxWords = 16;   // key rows <= 512
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kCols)
xam_search_kernel(const int8_t* __restrict__ keys,
                  const int8_t* __restrict__ masks,
                  const uint8_t* __restrict__ data,
                  int8_t* __restrict__ out,
                  int q, int r, int rp, int c, int packed) {
  __shared__ uint32_t s_key[kQBlock * kMaxWords];
  __shared__ uint32_t s_mask[kQBlock * kMaxWords];
  const int nw = (r + 31) / 32;
  const long col = static_cast<long>(blockIdx.x) * kCols + threadIdx.x;
  const bool live = col < c;

  // This thread's column as words: bit k of word w is logical row 32w + k.
  uint32_t colw[kMaxWords];
#pragma unroll
  for (int wi = 0; wi < kMaxWords; ++wi) {
    uint32_t word = 0;
    if (live && wi < nw) {
      if (packed) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pr = wi * 4 + k;
          if (pr < rp)
            word |= static_cast<uint32_t>(data[static_cast<long>(pr) * c + col])
                    << (8 * k);
        }
      } else {
        for (int k = 0; k < 32; ++k) {
          const int row = wi * 32 + k;
          if (row < r)
            word |= static_cast<uint32_t>(data[static_cast<long>(row) * c + col] & 1)
                    << k;
        }
      }
    }
    colw[wi] = word;
  }

  const int n_qblocks = (q + kQBlock - 1) / kQBlock;
  for (int qb = blockIdx.y; qb < n_qblocks; qb += gridDim.y) {
    const int q0 = qb * kQBlock;
    const int nq = min(kQBlock, q - q0);
    __syncthreads();  // the previous query block's words are consumed
    for (int i = threadIdx.x; i < nq * nw; i += kCols) {
      const int qi = i / nw;
      const int wi = i % nw;
      const int8_t* krow = keys + static_cast<long>(q0 + qi) * r;
      const int8_t* mrow = masks + static_cast<long>(q0 + qi) * r;
      uint32_t kw = 0, mw = 0;
      for (int k = 0; k < 32; ++k) {
        const int row = wi * 32 + k;
        if (row < r) {
          kw |= static_cast<uint32_t>(krow[row] & 1) << k;
          mw |= static_cast<uint32_t>(mrow[row] != 0) << k;
        }
      }
      s_key[qi * kMaxWords + wi] = kw;
      s_mask[qi * kMaxWords + wi] = mw;
    }
    __syncthreads();
    if (live) {
      for (int qi = 0; qi < nq; ++qi) {
        uint32_t miss = 0;
#pragma unroll
        for (int wi = 0; wi < kMaxWords; ++wi)
          if (wi < nw)
            miss |= (colw[wi] ^ s_key[qi * kMaxWords + wi]) &
                    s_mask[qi * kMaxWords + wi];
        out[static_cast<long>(q0 + qi) * c + col] = miss == 0;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
int xam_search_launch(const void* keys, const void* masks, const void* data,
                      void* out, int q, int r, int rp, int c, int packed,
                      void* stream) {
  if (q == 0 || c == 0) return 0;
  if (r > kMaxWords * 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qblocks = (q + kQBlock - 1) / kQBlock;
  const dim3 grid((c + kCols - 1) / kCols,
                  n_qblocks < kMaxGridY ? n_qblocks : kMaxGridY);
  xam_search_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(keys), static_cast<const int8_t*>(masks),
      static_cast<const uint8_t*>(data), static_cast<int8_t*>(out), q, r, rp,
      c, packed);
  return static_cast<int>(cudaGetLastError());
}

const char* xam_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
