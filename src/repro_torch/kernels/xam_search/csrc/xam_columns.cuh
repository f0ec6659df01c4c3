// Column loaders shared by the two XAM searches (xam_search.cu and
// xam_multiset.cu).
//
// A thread owns kColsPerThread = 4 adjacent columns of a stored-bit plane,
// (R, C) int8 (one logical bit per byte) or (Rp, C) uint8 packed words
// (logical row r = bit r % 8 of packed row r / 8).  One 4-byte load of a
// plane row brings the 4 columns' bytes; int8 rows are folded 8 at a time
// into packed bytes ((row & 0x01010101) << b), so both formats end in the
// same 4-row byte transpose (__byte_perm) to the columns' 32-bit words:
// bit k of colw[w][j] is logical row 32w + k of column col0 + j.  The
// loaders are templated on the number of 32-bit words NW, so the row loop
// unrolls and every row load of a column is independent and in flight at
// once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerThread = 4;

// Four bytes of one plane row, one per column col0 .. col0 + 3 (0 past C),
// byte by byte: the path of a ragged or unaligned C.
__device__ __forceinline__ uint32_t load_row4_bytes(
    const uint8_t* __restrict__ row, long col0, int c) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j)
    if (col0 + j < c) v |= static_cast<uint32_t>(__ldg(row + col0 + j)) << (8 * j);
  return v;
}

// Four packed rows (byte j of each = column j) -> each column's 32-bit
// word, byte k of word j = byte j of row k.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t out[kColsPerThread]) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The 4 columns' words from 4-byte row loads (C % 4 == 0, aligned, col0 + 4
// <= C, R >= 1).  Every load is unconditional -- rows past R re-read the
// last row and are masked off -- so the unrolled loads form one straight
// block with no branch between them.  (Predicated loads measured slower on
// the card.)
template <int NW, bool PACKED>
__device__ __forceinline__ void load_columns_vec(
    const uint8_t* __restrict__ data, int r, int c, long col0,
    uint32_t colw[NW][kColsPerThread]) {
  const int prows = (r + 7) / 8;         // packed rows that hold key rows
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint32_t rows[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pr = 4 * w + k;           // logical rows 8pr .. 8pr + 7
      uint32_t v = 0;
      if (PACKED) {
        const uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(
            data + static_cast<long>(min(pr, prows - 1)) * c + col0));
        v = pr < prows ? x : 0u;
      } else {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int row = 8 * pr + b;
          const uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(
              data + static_cast<long>(min(row, r - 1)) * c + col0));
          v |= (row < r ? x & 0x01010101u : 0u) << b;
        }
      }
      rows[k] = v;
    }
    transpose4(rows[0], rows[1], rows[2], rows[3], colw[w]);
  }
}

// The same words byte by byte: a ragged C tail, C % 4 != 0 or a plane view
// that is not 4-byte aligned.  Columns past C read as 0.
template <int NW>
__device__ __forceinline__ void load_columns_bytes(
    const uint8_t* __restrict__ data, int r, int c, long col0, bool live,
    int packed, uint32_t colw[NW][kColsPerThread]) {
  const int prows = (r + 7) / 8;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint32_t rows[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pr = 4 * w + k;
      uint32_t v = 0;
      if (live && pr < prows) {
        if (packed) {
          v = load_row4_bytes(data + static_cast<long>(pr) * c, col0, c);
        } else {
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const int row = 8 * pr + b;
            if (row < r)
              v |= (load_row4_bytes(data + static_cast<long>(row) * c, col0, c) &
                    0x01010101u) << b;
          }
        }
      }
      rows[k] = v;
    }
    transpose4(rows[0], rows[1], rows[2], rows[3], colw[w]);
  }
}

// The columns' words of either plane format, by the fastest path the
// operands allow (vec: 4-byte row loads are legal for these columns).
template <int NW>
__device__ __forceinline__ void load_columns(
    const uint8_t* __restrict__ data, int r, int c, long col0, bool live,
    bool vec, int packed, uint32_t colw[NW][kColsPerThread]) {
  if (vec && packed)
    load_columns_vec<NW, true>(data, r, c, col0, colw);
  else if (vec)
    load_columns_vec<NW, false>(data, r, c, col0, colw);
  else
    load_columns_bytes<NW>(data, r, c, col0, live, packed, colw);
}

}  // namespace
