// K2: whole-frame encode, samples in, payload words out.
//
// Replaces x3_tpu/ops/encode_fused_pallas.py::encode_frames_fused_words
// (plus the nbytes of encode_kernel._finish_fused): diff, masked max-|diff|
// classification into Rice / BFP / literal blocks, closed-form codes, and
// the bit pack into the frame's W payload words, with exact total_bits,
// blockfit_bits (max over blocks of (block offset & 255) + block bits)
// and the six statistics counters.
//
// What bounds it on the card: not device-memory bytes (each sample is read
// once and each word written once, about 6 us for 768 frames at 3.35 TB/s)
// but integer work per sample and how the loads and stores reach memory.
// A frame is a prefix sum over its blocks' bit counts followed by
// scattered bit inserts.  The design, one CTA per frame:
//
// 1. Stage a chunk of whole X3 blocks (and the sample after them) in shared
//    memory: neighbouring threads load neighbouring 16-byte vectors, with a
//    scalar head and tail where the row is not 16-byte aligned (rows of 90
//    or 287 samples).  Chunks follow each other with the bit offset carried,
//    so the frame length is not bounded by shared memory.  The buffer takes
//    what the W words leave of the budget, up to kStageBytes; when not even
//    one block fits (very long blocks, or words near the limit), every block
//    reads its samples from device memory instead (encode_kernel<false>).
// 2. One thread per block of the chunk, one sweep over its staged samples:
//    the max |diff| classifies the block, and four sums of the diffs give a
//    Rice block's bits in closed form (BFP and literal bits already are).
// 3. The block bits are scanned with warp shuffles, then one pass over the
//    warp totals (one __syncthreads); statistics and blockfit are reduced per
//    warp (__reduce_*_sync) with one shared atomic per warp and counter.
// 4. Each thread emits its block through a 64-bit register accumulator,
//    computing each code once, two samples a step (one put of both codes
//    when they fit 32 bits): a word wholly inside the block is a plain
//    shared store, only the first and last word (shared with neighbouring
//    blocks) take an atomicOr.  Bits at or past word W are dropped (the
//    compact-rung overflow contract: truncated words, exact counts).  Then
//    the CTA writes its W words out with 16-byte stores.
//
// The shared-memory constants below are repeated in ops/encode_cuda.py; a
// CPU test (tests/test_torch_encode.py) holds the two equal and models this
// arithmetic in numpy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // most threads of a CTA (one X3 block each)
constexpr int kSmemBytes = 232448; // shared memory a CTA may use (227 KB on sm_90)
constexpr int kStaticBytes = 128;  // of it, kept for the static arrays
constexpr int kStageBytes = 12288; // most the sample staging buffer takes
constexpr int kPad = 8;            // staging slots beyond the chunk's samples
constexpr int kMaxWords = (kSmemBytes - kStaticBytes) / 16 * 4;

enum Kind { kRice = 0, kBfp = 1, kLiteral = 2 };

struct EncParams {
  int t0, t1, t2;        // classification thresholds
  int ord0, ord1, ord2;  // Rice order of each selected code
  int sl0, sl1, sl2;     // statistics slot of each selected code
};

// Entry r of a three-entry table held in registers (a run-time index into a
// local array would put it on the stack).
__device__ __forceinline__ int pick(int r, int a, int b, int c) { return r == 0 ? a : (r == 1 ? b : c); }

struct StaticShared {
  int wsum[kThreads / 32];  // a chunk's bits per warp
  int stats[6];
  int fit;
};
static_assert(sizeof(StaticShared) <= kStaticBytes, "static shared arrays outgrow their budget");

// Copy samples lo..hi (inclusive) of a frame's row into the staging buffer
// at slot j - lo + pad, pad putting the row's 16-byte boundaries on the
// buffer's; sample S (past the row) reads as 0.  Returns pad.
__device__ __forceinline__ int stage_chunk(const int16_t* __restrict__ row, int lo, int hi, int S,
                                           int16_t* st, int tid, int T) {
  const int16_t* g = row + lo;
  const int pad = (int)(((uintptr_t)g & 15) >> 1);
  const int cnt = min(hi, S - 1) - lo + 1;
  if (cnt > 0) {
    const int head = min((8 - pad) & 7, cnt);
    const int nvec = (cnt - head) >> 3;
    const int4* gv = reinterpret_cast<const int4*>(g + head);
    int4* sv = reinterpret_cast<int4*>(st + pad + head);
    for (int i = tid; i < nvec; i += T) sv[i] = __ldg(gv + i);
    const int tail0 = head + (nvec << 3);
    for (int i = tid; i < head + cnt - tail0; i += T) {
      const int j = i < head ? i : tail0 + i - head;
      st[pad + j] = g[j];
    }
  }
  if (hi == S) st[pad + S - lo] = 0;
  return pad;
}

// (value, bits) of the sample with diff d and raw value snext.
__device__ __forceinline__ void code_of(int d, int snext, int kind, int k, int nb, uint32_t& v, int& l) {
  if (kind == kRice) {
    if (k == 0) {
      v = 1u;
      l = 2 * abs(d) + (d >= 0 ? 1 : 0);
    } else {
      l = (k + 1) + ((d ^ (d >> 31)) >> (k - 1));
      const int low = (d & ((1 << (k - 1)) - 1)) << 1;
      v = (uint32_t)(d >= 0 ? ((1 << k) | low) : (((1 << (k + 1)) - 1) - low));
    }
  } else if (kind == kLiteral) {
    v = (uint32_t)snext & 0xFFFFu;
    l = 16;
  } else {
    l = nb + 1;  // nb < 15 for BFP
    v = (uint32_t)d & ((1u << l) - 1u);
  }
}

// One block's bit stream into the shared words from bit offset `start`:
// items enter a 64-bit accumulator, and each full word leaves it.  The
// first word is shared with the previous block unless the block starts on
// a word boundary, and the last partial word with the next; those take an
// atomicOr, every other word a plain store.  Words at W or later are
// dropped.
struct Emitter {
  uint32_t* sw;
  int W, w, na;  // next word; bits pending in acc
  uint64_t acc;
  bool shared_head;

  __device__ __forceinline__ Emitter(uint32_t* sw_, int W_, int start)
      : sw(sw_), W(W_), w(start >> 5), na(start & 31), acc(0), shared_head((start & 31) != 0) {}

  __device__ __forceinline__ void flush() {
    if (na >= 32) {
      na -= 32;
      const uint32_t word = (uint32_t)(acc >> na);
      if (w < W) {
        if (shared_head)
          atomicOr(sw + w, word);
        else
          sw[w] = word;
      }
      shared_head = false;
      ++w;
    }
  }

  // An l-bit item; one longer than 32 bits keeps its value in its last 32
  // bits (the leading bits are zeros).
  __device__ __forceinline__ void put(uint32_t v, int l) {
    while (l > 32) {
      const int z = min(l - 32, 32);
      acc <<= z;
      na += z;
      flush();
      l -= z;
    }
    acc = (acc << l) | v;
    na += l;
    flush();
  }

  __device__ __forceinline__ void finish() {
    if (na > 0 && w < W) atomicOr(sw + w, (uint32_t)(acc << (32 - na)));
  }
};

// kStaged: the chunk's samples come from the staging buffer; otherwise from
// the row in device memory.  CH blocks per chunk (CH <= blockDim.x).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 6)
encode_kernel(const int16_t* __restrict__ samples, const int32_t* __restrict__ n_valid,
              const int32_t* __restrict__ consts, uint32_t* __restrict__ words,
              int32_t* __restrict__ total_bits, int32_t* __restrict__ blockfit,
              int32_t* __restrict__ nbytes, int32_t* __restrict__ stats,
              int S, int B, int L, int W, int CH) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ StaticShared ss;
  const int W4 = (W + 3) & ~3;
  uint32_t* sw = smem;                                         // W payload words
  int16_t* stage = reinterpret_cast<int16_t*>(smem + W4);      // CH * L + kPad samples

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  EncParams p;
  p.t0 = consts[0];
  p.t1 = consts[1];
  p.t2 = consts[2];
  p.ord0 = consts[3];
  p.ord1 = consts[4];
  p.ord2 = consts[5];
  p.sl0 = consts[6];
  p.sl1 = consts[7];
  p.sl2 = consts[8];
  const int16_t* row = samples + (size_t)f * (size_t)S;
  const int n = n_valid[f];
  const int last = min(n - 1, S);  // the last sample a block reads (S reads as 0)

  for (int i = tid; i < (W4 >> 2); i += T) reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < 6) ss.stats[tid] = 0;
  if (tid == 0) ss.fit = 0;

  int carry = 0;  // bits of the chunks before this one
  for (int cb0 = 0; cb0 < B; cb0 += CH) {
    const int lo = cb0 * L;
    int sh = 0;  // sample j sits at stage[j + sh]
    if (kStaged) sh = stage_chunk(row, lo, min(lo + CH * L, last), S, stage, tid, T) - lo;
    __syncthreads();
    auto at = [&](int j) -> int {
      if (kStaged) return stage[j + sh];
      return j < S ? (int)__ldg(row + j) : 0;
    };

    // Step 2: this thread's block, classified and counted.
    const int b = cb0 + tid;
    const bool mine = tid < CH && b < B;
    const int base = b * L;
    const int cnt = mine ? max(0, min(n - 1 - base, L)) : 0;
    // One sweep: max |d|, and with e = d >= 0 ? d : -d - 1 the sums that
    // give a Rice block's bits in closed form (orders are 0-3, the four
    // Rice tables): order 0 codes take 2e + 1 + [d < 0] bits, order k > 0
    // codes k + 1 + (e >> (k - 1)).  (The sums are unsigned: a long BFP or
    // literal block may wrap them, and only a Rice block reads them.)
    int ma = 0, neg = 0;
    unsigned se = 0, se1 = 0, se2 = 0;
    if (cnt > 0) {
      int prev = at(base);
      for (int k = 1; k <= cnt; ++k) {
        const int cur = at(base + k);
        const int d = cur - prev;
        const int e = d ^ (d >> 31);
        ma = max(ma, abs(d));
        se += (unsigned)e;
        neg -= d >> 31;
        se1 += (unsigned)(e >> 1);
        se2 += (unsigned)(e >> 2);
        prev = cur;
      }
    }
    const int ftype = (ma > p.t0) + (ma > p.t1) + (ma > p.t2);
    const int rsel = min(ftype, 2);
    const int nb = 32 - __clz(max(ma, 1));
    const int kind = ma <= p.t2 ? kRice : (nb >= 15 ? kLiteral : kBfp);
    const int order = pick(rsel, p.ord0, p.ord1, p.ord2);
    const int hdr_len = cnt > 0 ? (kind == kRice ? 2 : 6) : 0;
    const int hdr_val = kind == kRice ? ftype + 1 : (kind == kLiteral ? 15 : nb);
    const bool first = mine && b == 0 && n > 0;
    const unsigned sek = order <= 1 ? se : (order == 2 ? se1 : se2);
    const int rice_bits = order == 0 ? (int)(2u * se) + cnt + neg : (order + 1) * cnt + (int)sek;
    const int bits = (first ? 16 : 0) + hdr_len +
                     (kind == kRice ? rice_bits : cnt * (kind == kLiteral ? 16 : nb + 1));

    // Step 3: the block's bit offset by a warp-shuffle scan over the chunk.
    int incl = bits;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) ss.wsum[warp] = incl;
    __syncthreads();
    int start = carry + incl - bits;
    for (int i = 0; i < (T >> 5); ++i) {
      const int s = ss.wsum[i];
      carry += s;
      if (i < warp) start += s;
    }

    // Step 4: emit the block.
    if (bits > 0 && start < 32 * W) {
      Emitter em(sw, W, start);
      if (first) em.put((uint32_t)at(0) & 0xFFFFu, 16);
      if (cnt > 0) {
        em.put((uint32_t)hdr_val, hdr_len);
        int prev = at(base);
        int k = 1;
        for (; k < cnt; k += 2) {  // two samples a step, one put when they fit 32 bits
          const int c1 = at(base + k), c2 = at(base + k + 1);
          uint32_t v1, v2;
          int l1, l2;
          code_of(c1 - prev, c1, kind, order, nb, v1, l1);
          code_of(c2 - c1, c2, kind, order, nb, v2, l2);
          if (l1 + l2 <= 32) {
            em.put((v1 << l2) | v2, l1 + l2);
          } else {
            em.put(v1, l1);
            em.put(v2, l2);
          }
          prev = c2;
        }
        if (k == cnt) {
          const int cur = at(base + k);
          uint32_t v;
          int l;
          code_of(cur - prev, cur, kind, order, nb, v, l);
          em.put(v, l);
        }
      }
      em.finish();
    }

    const int slot = kind == kRice ? pick(rsel, p.sl0, p.sl1, p.sl2) : (kind == kLiteral ? 5 : 4);
    for (int s = 0; s < 6; ++s) {
      const int c = __reduce_add_sync(0xffffffffu, slot == s ? cnt : 0);
      if (lane == 0 && c) atomicAdd(&ss.stats[s], c);
    }
    const int fit = __reduce_max_sync(0xffffffffu, mine ? (start & 255) + bits : 0);
    if (lane == 0) atomicMax(&ss.fit, fit);
    __syncthreads();  // the staging buffer and wsum are free again
  }

  uint32_t* out = words + (size_t)f * (size_t)W;
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int i = tid; i < (W >> 2); i += T) reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(sw)[i];
    i0 = W & ~3;
  }
  for (int i = i0 + tid; i < W; i += T) out[i] = sw[i];
  if (tid == 0) {
    total_bits[f] = carry;
    const int nb8 = (carry + 7) / 8;
    nbytes[f] = nb8 + (nb8 & 1);
    blockfit[f] = ss.fit;
    for (int j = 0; j < 6; ++j) stats[(size_t)f * 6 + j] = ss.stats[j];
  }
}

template <bool kStaged>
cudaError_t launch(const void* samples, const void* n_valid, const void* consts, void* words,
                   void* total_bits, void* blockfit, void* nbytes, void* stats, int F, int S, int B,
                   int L, int W, int T, int CH, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(encode_kernel<kStaged>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  encode_kernel<kStaged><<<F, T, smem, stream>>>(
      (const int16_t*)samples, (const int32_t*)n_valid, (const int32_t*)consts, (uint32_t*)words,
      (int32_t*)total_bits, (int32_t*)blockfit, (int32_t*)nbytes, (int32_t*)stats, S, B, L, W, CH);
  return cudaGetLastError();
}

}  // namespace

extern "C" int x3_encode_frames(const void* samples, const void* n_valid, const void* consts,
                                void* words, void* total_bits, void* blockfit, void* nbytes,
                                void* stats, int F, int S, int B, int L, int W, void* stream) {
  if (F <= 0) return 0;
  if (W < 1 || W > kMaxWords || B < 1) return (int)cudaErrorInvalidValue;
  const int T = min(kThreads, (B + 31) / 32 * 32);
  const size_t word_bytes = (size_t)((W + 3) & ~3) * 4;
  // Blocks per chunk: as many as the staging buffer holds, one per thread.
  const int room = min(kStageBytes, kSmemBytes - kStaticBytes - (int)word_bytes) / 2 - kPad;
  const int CH = L > 0 ? min(T, room / L) : T;
  const cudaStream_t st = (cudaStream_t)stream;
  if (CH >= 1) {
    const size_t stage_bytes = ((size_t)(CH * L + kPad) * 2 + 15) / 16 * 16;
    return (int)launch<true>(samples, n_valid, consts, words, total_bits, blockfit, nbytes, stats, F,
                             S, B, L, W, T, CH, word_bytes + stage_bytes, st);
  }
  return (int)launch<false>(samples, n_valid, consts, words, total_bits, blockfit, nbytes, stats, F, S,
                            B, L, W, T, T, word_bytes, st);
}
