// Flat masked XAM (CAM) search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xam_search_pallas
// (src/repro/kernels/xam_search/kernel.py:118, body _xam_search_kernel at
// :106 and _match_bitmap at :77).  Same function: for keys/masks (Q, R)
// int8 {0,1} and one stored-bit plane (R, C) int8 -- or (Rp, C) uint8
// packed words, logical row r = bit r % 8 of packed row r / 8, Rp * 8 >= R
// -- out[q, c] = 1 iff every masked-in key bit equals the stored bit of
// column c.  An all-zero mask row matches every column (the TPU kernel's
// score >= n_selected with n_selected == 0).  The TPU's +-1 matmul (int8
// exact, or f32 with a 0.5 guard band) is an exact compare in disguise:
// the bitwise test ((col ^ key) & mask) == 0 serves both "scorings".
//
// Bound on this card.  A few integer operations per (query, column, word),
// so the kernel is bound by bytes: the (Q, C) int8 output dominates at the
// dedup shape (4096 x 65536 = 268 MB), then the plane and the keys.  At
// the Fig. 6 shape (1 x 64 x 512) no launch reaches the byte bound; there
// the kernel is bound by the latency of its dependent steps, and the goal
// is to stay near an empty kernel's time.
//
// Design.  What held a thread-per-column, byte-at-a-time version back was
// load latency, not bytes: 32 dependent byte loads per column word, and one
// thread packing each query word with 64 more.  Here:
//  - A thread owns 4 adjacent columns.  One 32-bit load of a plane row
//    brings the 4 columns' bytes; the kernel is templated on the number of
//    32-bit words (1, 2, 4, 8, 16: R <= 32, 64, 128, 256, 512) so the row
//    loop unrolls and every row load of a column is independent and in
//    flight at once.  int8 rows are folded 8 at a time into packed bytes
//    ((row & 0x01010101) << b), so both plane formats end in the same
//    4-row byte transpose (__byte_perm) to the 4 columns' words.  These
//    column loaders live in xam_columns.cuh, shared with xam_multiset.cu.
//  - Keys and masks are staged with warp ballots: a warp reads 32
//    consecutive key bytes of one query row in one coalesced load and
//    __ballot_sync turns them into the row's 32-bit key (and mask) word.
//    No thread packs a word bit by bit, and no second launch is needed.
//    A warp loads its first kPrefetch steps' key bytes before the columns,
//    so a one-query search waits for one round trip to memory, not two.
//  - A thread writes its 4 columns of a query row as one 4-byte store, so a
//    warp stores 128 contiguous bytes per instruction.  Ragged C (not a
//    multiple of 4, or a plane view not 4-byte aligned) and ragged R are
//    masked inside the kernel with byte loads and stores; nothing is padded.
//  - The column words stay in registers while the block walks its queries.
//    A block covers block_c = 4 x threads columns and block_q queries, both
//    chosen at run time by the caller: the cold pair (kernel.py
//    flat_geometry) splits the queries only as finely as filling the 132
//    SMs needs (2048 blocks, over two waves), so a block re-reads its
//    columns from L2 only for that split, and gives a grid too small to
//    cover the SMs (the Fig. 6 shape: 512 columns, one query) narrower
//    blocks, down to one warp, so its plane is pulled through several SMs
//    at once; a measured pair (kernels/autotune.py search_blocks) replaces
//    it per shape bucket.  A block walks its contiguous query range in
//    chunks of kQChunk staged in shared memory, so any block_q is legal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xam_columns.cuh"

namespace {

constexpr int kThreads = 256;         // largest block (block_c 1024)
constexpr int kMinThreads = 32;       // smallest block (block_c 128)
constexpr int kQChunk = 64;           // queries staged in shared memory
constexpr int kPrefetch = 2;          // staging steps a warp loads up front
constexpr int kMaxWords = 16;         // key rows <= 512
constexpr int kMaxGridY = 65535;

template <int NW>
__global__ void __launch_bounds__(kThreads)
xam_search_kernel(const int8_t* __restrict__ keys,
                  const int8_t* __restrict__ masks,
                  const uint8_t* __restrict__ data,
                  int8_t* __restrict__ out,
                  int q, int r, int c, int packed, int vec_ok,
                  int q_per_block) {
  __shared__ uint2 s_km[kQChunk * NW];   // (key, mask) words per query
  const long col0 =
      (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) * kColsPerThread;
  const bool live = col0 < c;
  const bool vec = vec_ok && col0 + kColsPerThread <= c;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int qa = blockIdx.y * q_per_block;
  const int qz = min(q, qa + q_per_block);
  // The key/mask bytes of this warp's first kPrefetch staging steps, loaded
  // before the columns so both round trips to memory overlap.
  int pf_k[kPrefetch], pf_m[kPrefetch];
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    const int p = warp + i * n_warps;
    const int row = 32 * (p % NW) + lane;
    pf_k[i] = pf_m[i] = 0;
    if (p < min(kQChunk, qz - qa) * NW && row < r) {
      const long at = static_cast<long>(qa + p / NW) * r + row;
      pf_k[i] = keys[at];
      pf_m[i] = masks[at];
    }
  }

  // The 4 columns as words: bit k of colw[w][j] is logical row 32w + k of
  // column col0 + j.
  uint32_t colw[NW][kColsPerThread];
  load_columns<NW>(data, r, c, col0, live, vec, packed, colw);

  for (int q0 = qa; q0 < qz; q0 += kQChunk) {
    const int nq = min(kQChunk, qz - q0);
    __syncthreads();                     // the previous chunk is consumed
    // One warp per (query, word): a coalesced 32-byte load of the key and
    // mask row, two ballots.  p is uniform across the warp.
#pragma unroll 4
    for (int p = warp, i = 0; p < nq * NW; p += n_warps, ++i) {
      const int qi = p / NW;
      const int row = 32 * (p % NW) + lane;
      int kb = 0, mb = 0;
      if (q0 == qa && i < kPrefetch) {
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j) {   // registers: no dynamic index
          kb = i == j ? pf_k[j] : kb;
          mb = i == j ? pf_m[j] : mb;
        }
      } else if (row < r) {
        const long at = static_cast<long>(q0 + qi) * r + row;
        kb = keys[at];
        mb = masks[at];
      }
      const uint32_t kw = __ballot_sync(0xffffffffu, kb & 1);
      const uint32_t mw = __ballot_sync(0xffffffffu, mb != 0);
      if (lane == 0) s_km[p] = make_uint2(kw, mw);
    }
    __syncthreads();
    if (live) {
      int8_t* orow = out + static_cast<long>(q0) * c + col0;
      for (int qi = 0; qi < nq; ++qi, orow += c) {
        uint32_t miss[kColsPerThread] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const uint2 km = s_km[qi * NW + w];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            miss[j] |= (colw[w][j] ^ km.x) & km.y;
        }
        const uint32_t flags = static_cast<uint32_t>(miss[0] == 0) |
                               static_cast<uint32_t>(miss[1] == 0) << 8 |
                               static_cast<uint32_t>(miss[2] == 0) << 16 |
                               static_cast<uint32_t>(miss[3] == 0) << 24;
        if (vec) {
          *reinterpret_cast<uint32_t*>(orow) = flags;
        } else {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            if (col0 + j < c) orow[j] = static_cast<int8_t>((flags >> (8 * j)) & 1);
        }
      }
    }
  }
}

// The launch floor: one empty block of kThreads threads.
__global__ void __launch_bounds__(kThreads) floor_kernel() {}

template <int NW>
void launch(dim3 grid, int threads, cudaStream_t s, const void* keys,
            const void* masks, const void* data, void* out, int q, int r,
            int c, int packed, int vec_ok, int q_per_block) {
  xam_search_kernel<NW><<<grid, threads, 0, s>>>(
      static_cast<const int8_t*>(keys), static_cast<const int8_t*>(masks),
      static_cast<const uint8_t*>(data), static_cast<int8_t*>(out), q, r, c,
      packed, vec_ok, q_per_block);
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError().
// A block covers block_c columns (128, 256, 512 or 1024: one to eight warps
// of 4 columns a thread) and block_q >= 1 queries; any other pair, or one
// whose grid needs more than 65535 query blocks, is refused with
// cudaErrorInvalidValue and nothing is launched.  The pair never changes
// the bitmap.  rp (the packed row count) is implied by r for the search
// and is checked by the caller; it stays in the signature for the
// bindings.
int xam_search_launch(const void* keys, const void* masks, const void* data,
                      void* out, int q, int r, int rp, int c, int packed,
                      int block_q, int block_c, void* stream) {
  (void)rp;
  const int threads = block_c / kColsPerThread;
  if (block_q < 1 || block_c % kColsPerThread != 0 ||
      threads < kMinThreads || threads > kThreads ||
      (threads & (threads - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0 || c == 0) return 0;
  if (r < 0 || r > kMaxWords * 32) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = r <= 32 ? 1 : (r + 31) / 32;
  const int vec_ok = r > 0 && c % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(data) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  const int col_blocks = (c + block_c - 1) / block_c;
  const long grid_y = (static_cast<long>(q) + block_q - 1) / block_q;
  if (grid_y > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(col_blocks, static_cast<unsigned>(grid_y));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nw <= 1)
    launch<1>(grid, threads, s, keys, masks, data, out, q, r, c, packed, vec_ok, block_q);
  else if (nw <= 2)
    launch<2>(grid, threads, s, keys, masks, data, out, q, r, c, packed, vec_ok, block_q);
  else if (nw <= 4)
    launch<4>(grid, threads, s, keys, masks, data, out, q, r, c, packed, vec_ok, block_q);
  else if (nw <= 8)
    launch<8>(grid, threads, s, keys, masks, data, out, q, r, c, packed, vec_ok, block_q);
  else
    launch<16>(grid, threads, s, keys, masks, data, out, q, r, c, packed, vec_ok, block_q);
  return static_cast<int>(cudaGetLastError());
}

// One empty block on `stream`: the launch floor that chip_smoke.py holds
// the Fig. 6 time against.
int xam_search_floor_launch(void* stream) {
  floor_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* xam_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
