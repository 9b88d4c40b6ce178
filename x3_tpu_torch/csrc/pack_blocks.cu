// K5: the level-1 block pack over (frame, block) lanes.
//
// Replaces x3_tpu/ops/pack_pallas.py::pack_blocks_pallas.  For each lane
// (one X3 block of one frame), the block's I items (value, bit length) are
// written MSB-first from the lane's bit offset r2 inside its superword into
// nb4 32-bit word slots; each item gives a piece to its slot t and, when it
// straddles, one to slot t+1.  Pieces aimed at slot nb4 or later are
// dropped: that is the block-buffer (NW) rung's truncation, and the
// caller's blockfit check sends such batches to a wider rung.  Lanes are
// the minor axis: item_val / item_len [I, N], r2 [1, N], out [nb4, N].
//
// What bounds it on the card: bytes.  It reads 8 bytes of every item and 4
// of r2 and writes 4*nb4 per lane; at I=22, nb4=13 and N=384,000 lanes that
// is about 89 MB, 27 us at 3.35 TB/s.  The design, one thread per lane
// (every item row and every output row a coalesced 128-byte access per
// warp):
//
// 1. A sliding two-word window.  An item of 0..32 bits moves the offset by
//    at most 32 bits, so its slot t rises by at most one per item: the lane
//    keeps two running sums, `cur` for slot t and `nxt` for slot t+1.  When
//    t moves, `cur` is finished and goes to the lane's column of a shared
//    tile [nb4][blockDim] (a dynamic index: no select over the slots);
//    `nxt` becomes `cur`.  Slots at nb4 or later are never written.
// 2. The items are loaded kUnroll at a time before any is used, so their
//    loads are in flight together (lengths past I load as zero items, which
//    add nothing).
// 3. The tile starts zeroed, so slots a lane never reaches stay zero, and a
//    finished slot is added to it: the sum stays exact however the offset
//    moves.  Each lane reads back only its own column, so no barrier is
//    needed, and row w of the output is one coalesced store per warp.
// 4. One CTA per 256 lanes (1,500 CTAs at 384,000 lanes, so a partial
//    second wave): a grid-stride loop over only as many CTAs as are
//    resident at once measured no faster on an H100 (PERF.md).
//
// Pieces are added, as the TPU kernel adds them: a well-formed block's
// pieces are bit-disjoint, so the sum is their OR.  The sum is kept: a
// zero-length item at an in-word offset of 0 still adds v << 31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // items loaded ahead of their use

// Add x to slot s of this lane's tile column (stride kThreads), unless s is
// past the nb4 slots (the NW rung's truncation) or before slot 0.
__device__ __forceinline__ void flush(uint32_t* col, int s, uint32_t x, int nb4) {
  if ((unsigned)s < (unsigned)nb4) col[s * kThreads] += x;
}

__global__ void __launch_bounds__(kThreads, 6)
pack_blocks_kernel(const uint32_t* __restrict__ item_val, const int32_t* __restrict__ item_len,
                   const int32_t* __restrict__ r2, uint32_t* __restrict__ out, int I, int N,
                   int nb4) {
  extern __shared__ uint32_t tile[];  // [nb4][kThreads]: slot w of thread j at w * kThreads + j
  uint32_t* col = tile + threadIdx.x;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane < N) {
    for (int w = 0; w < nb4; ++w) col[w * kThreads] = 0u;
    int poff = __ldg(r2 + lane);
    int t = poff >> 5;  // the window's slot: cur sums slot t, nxt slot t+1
    uint32_t cur = 0u, nxt = 0u;
    for (int i0 = 0; i0 < I; i0 += kUnroll) {
      uint32_t v[kUnroll];
      int l[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const bool in = i0 + k < I;
        const size_t at = (size_t)(in ? i0 + k : 0) * N + lane;
        v[k] = in ? __ldg(item_val + at) : 0u;
        l[k] = in ? __ldg(item_len + at) : 0;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int tn = poff >> 5;
        if (tn != t) {  // the window slides: slot t is finished
          flush(col, t, cur, nb4);
          if (tn == t + 1) {
            cur = nxt;
          } else {  // a jump (lengths outside 0..32): both sums leave
            flush(col, t + 1, nxt, nb4);
            cur = 0u;
          }
          nxt = 0u;
          t = tn;
        }
        const int sh = 32 - (poff & 31) - l[k];  // >= 0: fits slot t; < 0: straddles
        if (sh >= 0) {
          cur += v[k] << min(sh, 31);
        } else {
          const int shr = min(-sh, 31);
          cur += v[k] >> shr;
          nxt += v[k] << (32 - shr);
        }
        poff += l[k];
      }
    }
    flush(col, t, cur, nb4);
    flush(col, t + 1, nxt, nb4);
    for (int w = 0; w < nb4; ++w) out[(size_t)w * N + lane] = col[w * kThreads];
  }
}

}  // namespace

extern "C" int x3_pack_blocks(const void* item_val, const void* item_len, const void* r2,
                              void* out, int I, int N, int nb4, void* stream) {
  if (N <= 0) return 0;
  if (nb4 < 1 || nb4 > 40) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nb4 * kThreads * sizeof(uint32_t);
  pack_blocks_kernel<<<(N + kThreads - 1) / kThreads, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)item_val, (const int32_t*)item_len, (const int32_t*)r2, (uint32_t*)out, I,
      N, nb4);
  return (int)cudaGetLastError();
}
