// K6: the pair pack, pre-merged pairs in, frame payload words out.
//
// Replaces x3_tpu/ops/pack_walk_pallas.py::pack_frames_walk.  Each block's
// P pairs (<= 32-bit items, value and bit length) are written MSB-first
// from the block's absolute bit offset block_off into the frame's W words.
// A block spans at most NB words from its first word (block_off >> 5),
// NB = max(ceil((16+6+16L)/32), ceil((31+6+16L)/32)), 12 at L=20; pieces
// past them, and pieces at word W or later, are dropped.  The second drop
// is the compact-rung contract (truncated words, exact counts, which the
// caller computes); frames that fit W get the words of
// encode_kernel._pack_pairs.
//
// What bounds it on the card: bytes.  It reads the pairs (8 bytes each) and
// the block offsets once and writes the W words once: at 768 frames, 500
// blocks, 11 pairs and W=2048, about 42 MB, 12 us at 3.35 TB/s.  The TPU
// kernel's lane tiles, window sweep, barrel and resident-VMEM DMA do not
// carry over.  The design, one CTA per frame with its W words in shared
// memory and one thread per block, the CTA's threads taking a chunk of T
// blocks at a time:
//
// 1. Each thread reads its block's P pairs from device memory.  A warp's
//    loads of pair p are 4*P bytes apart, and its 32 blocks' pairs are one
//    contiguous run that the L1 cache brings in by its first loads.
//    (Staging the run in shared memory by 16-byte cp.async copies measured
//    5-17% slower on an H100, and its slabs cost a wave at W = 4096.)
// 2. Each thread sums its block's lengths for the last word the block
//    reaches, and checks that it is at or before the next block's first
//    word.  When every block so far passes (a CTA-wide vote, sticky across
//    chunks, the chunk's one barrier), a block's words between its first
//    and its last belong to it alone and take plain shared stores; its
//    first and last word, which neighbours may share, take atomicAdd.  A
//    layout that fails the check (overlapping blocks, lengths outside
//    0..32) takes atomicAdd for every word from then on, so the sum stays
//    exact.  The votes also keep each chunk's stores apart from the next
//    chunk's, which is what makes a plain store safe.
// 3. The block's pairs go through the sliding two-word window of K5
//    (pack_blocks.cu): `cur` sums word t, `nxt` word t+1, and word t leaves
//    when the offset moves past it; no select over the NB words.
// 4. The W words leave by 16-byte stores.
//
// Pieces are added, as the TPU kernel adds them: the pieces of well-formed
// pairs are bit-disjoint, so the sum is their OR; a zero-length pair at an
// in-word offset of 0 still adds v << 31 (to the word after a block that
// ends on a word boundary, which is why that word counts as reached).
//
// A numpy model of this arithmetic is _k6_model in tests/test_torch_pack.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // most threads of a CTA (one block each)
constexpr int kSmemBytes = 232448;  // shared memory a CTA may use (227 KB on sm_90)

// Word s (relative to the block's first word w0) of one block into the
// shared words: dropped past the NB words or outside 0..W-1; a plain store
// where the block owns the word, else an atomicAdd of a non-zero sum.
struct Words {
  uint32_t* sw;
  int w0, W, nb, reach;
  bool owns;  // the layout lets the block own its words 1..reach-1

  __device__ __forceinline__ void put(int s, uint32_t x) const {
    if (s >= nb || (unsigned)(w0 + s) >= (unsigned)W) return;
    if (owns && s > 0 && s < reach)
      sw[w0 + s] = x;
    else if (x)
      atomicAdd(sw + w0 + s, x);
  }
};

__global__ void __launch_bounds__(kThreads, 6)
pack_walk_kernel(const uint32_t* __restrict__ mval, const int32_t* __restrict__ mlen,
                 const int32_t* __restrict__ block_off, uint32_t* __restrict__ words, int B, int P,
                 int W, int nb) {
  extern __shared__ __align__(16) uint32_t sw[];  // the frame's W payload words
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int W4 = (W + 3) & ~3;
  const size_t fB = (size_t)f * B;

  for (int i = tid; i < (W4 >> 2); i += T) reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);

  bool sorted = true;  // every block so far ends at or before the next one's first word
  for (int cb0 = 0; cb0 < B; cb0 += T) {
    const int b = cb0 + tid;
    const bool mine = b < B;
    const uint32_t* gv = mval + (fB + b) * P;
    const int32_t* gl = mlen + (fB + b) * P;

    // The last word the block reaches: the last pair's, offsets only rise.
    int boff = 0, reach = 0;
    bool ok = true;
    if (mine) {
      boff = __ldg(block_off + fB + b);
      int e = boff & 31;
      unsigned bad = (unsigned)boff >> 31;
      for (int p = 0; p + 1 < P; ++p) {
        const int l = __ldg(gl + p);
        bad |= (unsigned)l > 32u;
        e += l;
      }
      if (P > 0) {
        const int l = __ldg(gl + P - 1);
        bad |= (unsigned)l > 32u;
        reach = (e + max(l, 1) - 1) >> 5;
      }
      ok = !bad && (b + 1 == B || (boff >> 5) + reach <= (__ldg(block_off + fB + b + 1) >> 5));
    }
    // The chunk's barrier: every store of the chunk before is done, and the
    // words are zeroed before the first chunk's.
    sorted = __syncthreads_and(ok) && sorted;

    if (mine) {
      const Words out{sw, boff >> 5, W, nb, reach, sorted};
      int poff = boff & 31;
      int t = 0;  // the window's word: cur sums word t, nxt word t+1
      uint32_t cur = 0u, nxt = 0u;
      for (int p = 0; p < P; ++p) {
        const uint32_t v = __ldg(gv + p);
        const int l = __ldg(gl + p);
        const int tn = poff >> 5;
        if (tn != t) {  // the window slides: word t is finished
          out.put(t, cur);
          if (tn == t + 1) {
            cur = nxt;
          } else {  // a jump (lengths outside 0..32): both sums leave
            out.put(t + 1, nxt);
            cur = 0u;
          }
          nxt = 0u;
          t = tn;
        }
        const int sh = 32 - (poff & 31) - l;  // >= 0: fits word t; < 0: straddles
        if (sh >= 0) {
          cur += v << min(sh, 31);
        } else {
          const int shr = min(-sh, 31);
          cur += v >> shr;
          nxt += v << (32 - shr);
        }
        poff += l;
      }
      out.put(t, cur);
      out.put(t + 1, nxt);
    }
  }
  __syncthreads();

  uint32_t* out = words + (size_t)f * (size_t)W;
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int i = tid; i < (W >> 2); i += T) reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(sw)[i];
    i0 = W & ~3;
  }
  for (int i = i0 + tid; i < W; i += T) out[i] = sw[i];
}

}  // namespace

extern "C" int x3_pack_walk(const void* mval, const void* mlen, const void* block_off,
                            void* words, int F, int B, int P, int W, int nb, void* stream) {
  if (F <= 0) return 0;
  const size_t smem = (size_t)((W + 3) & ~3) * 4;
  if (W < 1 || smem > (size_t)kSmemBytes || B < 0 || P < 0 || nb < 1 || nb > 32)
    return (int)cudaErrorInvalidValue;
  const int T = max(32, min(kThreads, (B + 31) / 32 * 32));
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(pack_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pack_walk_kernel<<<F, T, smem, (cudaStream_t)stream>>>((const uint32_t*)mval, (const int32_t*)mlen,
                                                         (const int32_t*)block_off, (uint32_t*)words,
                                                         B, P, W, nb);
  return (int)cudaGetLastError();
}
