// K3: per-frame bitstream walk of the decoder.
//
// Replaces x3_tpu/ops/decode_pallas.py::_decode_pallas_impl together with
// its wrapper decode_frames_pallas_words (sample 0 and the overrun code):
// block headers, BFP width, invalid BFP (error 1), Rice codes with unary
// runs capped at the payload end, the inverse-Rice closed form with its
// bounds check (error 2), the BFP sign fold, pass-through, at most 16 bits
// consumed per code, 16-bit wrap, and the overrun check against the
// worst-case width (error 3).  The first error of a frame wins.
//
// Reads follow the JAX walk exactly, corrupt lanes included: each block
// reads a WIN-word window that starts at word min(off >> 5, W - 1); a
// code's two words come from window slots (rel >> 5) & mask and the next
// one, where mask keeps the index bits the JAX barrel looks at for that
// sample, and slots at or past WIN read zero.  Blocks longer than 24
// samples use the JAX scan's rolling two-word register instead.
//
// What bounds it on the card: the walk is a serial chain within a frame
// (every code's start depends on the previous code's length), so it is
// latency bound per thread; the bytes read and written are small.  The
// main path's 8,192 frames are all resident at once (about one warp per
// SM sub-partition), so the time is one frame's chain: the design keeps
// one thread per frame and keeps the chain, and the instructions issued
// beside it, as short as it can.
//
// * A register bit reader for blocks that start inside the buffer
//   (off < 32 W).  Their window starts at word off >> 5, so rel <= 31 at
//   the header and rel <= 37 + 16k at code k (a code consumes at most 16
//   bits).  Since WIN = ceil((53 + 16L) / 32) and 21 + 16L is odd,
//   (37 + 16k) >> 5 <= (21 + 16L) >> 5 = WIN - 2: the stage mask keeps the
//   index and both slots lie inside the window, and the rolling register of
//   long blocks fetches slot WIN only after a block's last code.  So such a
//   block reads exactly the frame's bitstream from off, with zero bits past
//   word W.  BitReader keeps two words in registers, so a code's 32-bit view
//   is one funnel shift; each step starts the load of the word after them
//   before it decodes, and uses it only if the code crosses a word.
// * Input staged per warp.  Registers are scoreboarded per warp, so a
//   global load that one lane issues on its own schedule stalls every lane
//   that next touches the register: reading the rows themselves puts the
//   latency of global memory on every sample.  Instead each lane's frame
//   words sit in a shared-memory ring (InputRing), which the warp refills
//   once per tile of kTile samples, a tile ahead of use, with cp.async
//   copies along the rows (coalesced, zeros past word W).
// * Blocks that start past the buffer (only a corrupt lane's walk gets
//   there, and every later block of its frame is past it too) keep the
//   windowed read above, so error-lane samples stay equal.  Every lane of a
//   warp runs the same (b, k) loop; a block whose lanes all start inside
//   the buffer (the warp agrees, so the choice is uniform) runs the reader
//   alone, any other block picks the reader per lane.
// * Output staged per warp.  Each warp keeps a [32 frames x kTile samples]
//   int16 tile in shared memory, its rows padded to kPitch so that the 32
//   lanes' column writes fall on 32 banks.  The sample index is the same
//   on every lane, so every kTile samples the warp writes the tile out row
//   by row, each lane two consecutive samples of one frame: 128-byte runs
//   instead of one 2-byte store into each of 32 rows per sample.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;          // warps per CTA: the main path's 256 warps spread over the SMs
constexpr int kTile = 64;          // samples per staged tile: two per lane when written out
constexpr int kPitch = kTile + 2;  // int16 per tile row: 33 words, one bank apart per lane
constexpr int kRing = 128;         // words of a lane's input ring (a power of two)
constexpr int kRingPitch = 129;    // ring row pitch: lanes at the same slot hit 32 banks
constexpr unsigned kAll = 0xFFFFFFFFu;

// The low 16 bits, sign-extended (conversion to int16_t is modular).
__device__ __forceinline__ int wrap16(int v) { return (int)(int16_t)v; }

// Index bits a log-depth barrel over slots 0..hi looks at.
__device__ __forceinline__ int stage_mask(int hi) {
  return hi <= 0 ? 0 : (int)((1u << (32 - __clz(hi))) - 1u);
}

struct Window {
  const uint32_t* row;
  int W;    // words in the buffer
  int WIN;  // window slots
  int wb;   // window start word
  __device__ __forceinline__ uint32_t slot(int j) const {
    const int idx = wb + j;
    return (j < WIN && idx < W) ? __ldg(row + idx) : 0u;
  }
  __device__ __forceinline__ uint32_t extract32(int rel, int mask) const {
    const int j = (rel >> 5) & mask;
    const uint32_t r = (uint32_t)(rel & 31);
    return (slot(j) << r) | ((slot(j + 1) >> (31u - r)) >> 1);
  }
};

// 4-byte asynchronous copy from global to shared memory; zero-fills the
// destination when `in_row` is false (src must still be a valid address).
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, bool in_row) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in_row ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A lane's frame words in a shared-memory ring: word j at slot j % kRing.
// Once per tile (the same moment on every lane) the warp requests, for
// each of its 32 frames, the words up to `ahead` past that lane's reader,
// row by row as coalesced cp.async copies, and waits for the request of the
// tile before.  A tile consumes at most tile_words words, so with
// ahead = 2 tile_words + 4 every word a tile reads was requested a tile
// earlier, and kRing > 2 tile_words keeps unread slots intact.
struct InputRing {
  uint32_t (*ring)[kRingPitch];  // the warp's 32 rings
  const uint32_t* words;
  int W, F, fbase, lane;
  int ahead;
  int fill;  // this lane's words [0, fill) are requested
  // Request up to reader word widx + ahead; each frame's new words number at
  // most 32 * kChunks.
  template <int kChunks>
  __device__ __forceinline__ void request(int widx) {
    const int target = widx + ahead;
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int lo = __shfl_sync(kAll, fill, i);
      const int hi = __shfl_sync(kAll, target, i);
      const uint32_t* src = words + (size_t)min(fbase + i, F - 1) * (size_t)W;
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int j = lo + lane + 32 * q;
        if (j < hi) cp_async4(&ring[i][j & (kRing - 1)], src + min(j, W - 1), j < W);
      }
    }
    fill = target;
    cp_async_commit();
  }
};

// A frame's bitstream from an absolute bit offset, with zero bits past word
// W, read from the lane's ring: w0 and w1 are the words at pos >> 5 and the
// one after.  prefetch() loads the word after them; skip() uses it when the
// offset crosses into the next word.
struct BitReader {
  const uint32_t* ring;
  int pos;
  uint32_t w0, w1, nxt;

  __device__ __forceinline__ void start(const uint32_t* ring_, int off) {
    ring = ring_;
    pos = off;
    w0 = ring[(off >> 5) & (kRing - 1)];
    w1 = ring[((off >> 5) + 1) & (kRing - 1)];
  }
  __device__ __forceinline__ void prefetch() { nxt = ring[((pos >> 5) + 2) & (kRing - 1)]; }
  // The 32 bits from the current offset (the funnel shift takes pos & 31).
  __device__ __forceinline__ uint32_t peek() const { return __funnelshift_l(w1, w0, pos); }
  // Advance by n < 32 bits (after a prefetch at the current offset).
  __device__ __forceinline__ void skip(int n) {
    const int next = pos + n;
    if ((next ^ pos) & ~31) {
      w0 = w1;
      w1 = nxt;
    }
    pos = next;
  }
};

// A warp's [32 frames x kTile samples] output tile in shared memory.
struct Tile {
  int16_t (*t)[kPitch];
  int16_t* out;
  int fbase;  // first frame of the warp
  int rows;   // frames of the warp below F
  int S;
  int lane;
  __device__ __forceinline__ void put(int o, int v) { t[lane][o & (kTile - 1)] = (int16_t)v; }
  // Write columns [t0, t0 + cols) of the tile, those below S, row by row:
  // lane l writes columns 2l and 2l + 1, as one 4-byte store where the row
  // makes it aligned (t0 is even, so where frame * S is even).  A full tile
  // of 32 aligned rows loads eight rows' pairs at a time, then stores them.
  __device__ __forceinline__ void flush(int t0, int cols) {
    __syncwarp();
    const int nc = min(cols, S - t0);
    const int c = 2 * lane;
    if (nc == kTile && rows == 32 && (S & 1) == 0) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)fbase * (size_t)S + t0 + c);
      const size_t stride = (size_t)(S / 2);  // uint32 per row
#pragma unroll 1
      for (int g = 0; g < 32; g += 8) {
        uint32_t pair[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pair[i] = *reinterpret_cast<const uint32_t*>(&t[g + i][c]);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(g + i) * stride] = pair[i];
      }
    } else if (c < nc) {
      for (int i = 0; i < rows; ++i) {
        const uint32_t pair = *reinterpret_cast<const uint32_t*>(&t[i][c]);
        int16_t* dst = out + (size_t)(fbase + i) * (size_t)S + t0 + c;
        if (c + 1 < nc && ((fbase + i) & S & 1) == 0) {
          *reinterpret_cast<uint32_t*>(dst) = pair;
        } else {
          dst[0] = (int16_t)(pair & 0xFFFFu);
          if (c + 1 < nc) dst[1] = (int16_t)(pair >> 16);
        }
      }
    }
    __syncwarp();
  }
};

// A block's codes, from its header, as constants that keep the step free of
// branches.  Rice: idx = (suffix & smask) + lvl * zeros + ibias is the
// inverse-table index (ftype 1: zeros; 2 and 3: suffix + level *
// (zeros - 1)), out of bounds at or past invlen (unsigned; never for BFP,
// whose idx is 0).  The bits a code consumes are
// min(clz + cadd, max(cap, 0) + cadd, lim), lim = 0 on an invalid sample:
// Rice min(zeros + 1 or + suffix width, 16), BFP dec_nb (cadd = 32).  BFP
// reads the top dec_nb bits (bshift = 32 - dec_nb), sign-folded above neg.
struct BlockCodes {
  bool is_rice, is_pass;
  int dec_nb;
  int smask, lvl, ibias, sshift;
  unsigned invlen;
  int cadd, lim;
  int bshift, neg;
};

__device__ __forceinline__ BlockCodes block_codes(uint32_t hdr, const int* nsubs, const int* invlen) {
  BlockCodes c;
  const int ftype = (int)(hdr >> 30);
  c.dec_nb = (int)((hdr >> 26) & 0xFu) + 1;
  c.is_rice = ftype >= 1;
  c.is_pass = ftype == 0 && c.dec_nb == 16;
  const int level = 1 << (ftype == 2 ? nsubs[2] : nsubs[3]);
  const int nbsuf = ftype == 2 ? 2 : 4;  // decoder.rs:180: hardwired
  c.sshift = 32 - nbsuf;
  if (ftype == 0) {
    c.smask = c.lvl = c.ibias = 0;
    c.invlen = 0xFFFFFFFFu;
    c.cadd = 32;
    c.lim = c.dec_nb;
  } else {
    c.smask = ftype == 1 ? 0 : -1;
    c.lvl = ftype == 1 ? 1 : level;
    c.ibias = ftype == 1 ? 0 : -level;
    c.invlen = (unsigned)(ftype == 1 ? invlen[1] : (ftype == 2 ? invlen[2] : invlen[3]));
    c.cadd = ftype == 1 ? 1 : nbsuf;
    c.lim = 16;
  }
  c.bshift = 32 - min(max(c.dec_nb, 1), 31);
  c.neg = 1 << min(max(c.dec_nb - 1, 0), 30);
  return c;
}

// Decode one sample from its 32-bit view: v is the value the walk computes
// there; when `valid`, `last` becomes v.  Returns the bits to advance (0
// when not valid).
__device__ __forceinline__ int decode_one(uint32_t win32, int& last, int cap, bool valid,
                                          const BlockCodes& c, bool& oob, int& v) {
  const int capc = max(cap, 0);
  const int clz = (int)__clz(win32);
  const int step = min(clz + c.cadd, min(capc + c.cadd, valid ? c.lim : 0));
  const int zeros = min(clz, capc);
  const int suffix = (int)((win32 << min(zeros, 31)) >> c.sshift);
  const int idx = (suffix & c.smask) + c.lvl * zeros + c.ibias;
  if (valid && (unsigned)idx >= c.invlen) oob = true;
  const int ic = min(max(idx, 0), 59);
  const int delta_rice = (ic >> 1) ^ -(ic & 1);  // (ic + 1) / 2, negated for odd ic
  const int a = (int)(win32 >> c.bshift);
  const int delta_bfp = a > c.neg ? a - 2 * c.neg : a;
  v = c.is_pass ? ((int)win32 >> 16) : wrap16(last + (c.is_rice ? delta_rice : delta_bfp));
  if (valid) last = v;
  return step;
}

// The end of a tile, out of line so that the walk's loop keeps its
// registers: write the tile, request the rings' next words (up to reader
// word widx + ahead), wait for the previous request.  Returns the new fill.
__device__ __noinline__ int end_tile(Tile tile, InputRing in, int widx, int t0) {
  tile.flush(t0, kTile);
  in.request<2>(widx);
  cp_async_wait<1>();
  __syncwarp();
  return in.fill;
}

__global__ void __launch_bounds__(32 * kWarps)
    decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ n_samples,
                  const int32_t* __restrict__ payload_lens, const int32_t* __restrict__ consts,
                  int16_t* __restrict__ out, int32_t* __restrict__ err_out,
                  int32_t* __restrict__ off_out, int F, int W, int S, int B, int L, int WIN,
                  int WFULL) {
  __shared__ __align__(16) int16_t tiles[kWarps][32][kPitch];
  __shared__ __align__(16) uint32_t rings[kWarps][32][kRingPitch];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int fbase = (blockIdx.x * kWarps + warp) * 32;
  if (fbase >= F) return;  // the whole warp
  const int f = fbase + lane;
  const bool live = f < F;
  const int fl = live ? f : F - 1;  // lanes past F walk the last frame and write nothing
  Tile tile{tiles[warp], out, fbase, min(32, F - fbase), S, lane};

  int nsubs[4], invlen[4];
  for (int i = 0; i < 4; ++i) {
    nsubs[i] = consts[i];
    invlen[i] = consts[4 + i];
  }
  const uint32_t* row = words + (size_t)fl * (size_t)W;
  const int n = n_samples[fl];
  const int plen8 = payload_lens[fl] * 8;

  // Bits a tile of kTile samples can consume: kTile codes of at most 16
  // bits and the headers of at most kTile / L + 1 blocks.
  const int tile_words = (kTile * 16 + (kTile / L + 1) * 6 + 31) / 32 + 1;  // <= 46
  InputRing in{rings[warp], words, W, F, fbase, lane, 2 * tile_words + 4, 0};
  in.request<3>(0);
  cp_async_wait<0>();
  __syncwarp();
  BitReader rd;
  rd.start(rings[warp][lane], 16);
  const int first = wrap16((int)(rd.w0 >> 16));
  tile.put(0, first);
  // After sample o of every lane: at the end of a tile, write it out and
  // move the rings on.
  auto next_sample = [&](int o) {
    if ((o & (kTile - 1)) == kTile - 1) in.fill = end_tile(tile, in, rd.pos >> 5, o - (kTile - 1));
  };

  int off = 16;
  int last = first;
  int err = 0;
  const bool unrolled = L <= 24;
  const int m1 = stage_mask(WIN - 1);
  const int m2 = stage_mask(WIN);
  for (int b = 0; b < B; ++b) {
    const int block_first = 1 + b * L;
    const bool fast = (off >> 5) < W;  // the block starts inside the buffer
    const Window win{row, W, WIN, min(off >> 5, W - 1)};
    int rel = off - (win.wb << 5);  // offset of the windowed read

    uint32_t hdr;
    if (fast) {
      rd.prefetch();
      hdr = rd.peek();
    } else {
      hdr = win.extract32(rel, stage_mask(min(WIN - 1, 1)));
    }
    const BlockCodes c = block_codes(hdr, nsubs, invlen);
    const bool is_hdr0 = !c.is_rice;
    const bool bpf_err = block_first < n && is_hdr0 && c.dec_nb <= 5;
    const int hdr_len = is_hdr0 ? 6 : 2;  // the header advances even past the sample count
    if (fast) {
      rd.skip(hdr_len);
    } else {
      rel += hdr_len;
    }
    const int rel_end = plen8 - (win.wb << 5);
    bool oob = false;

    if (__all_sync(kAll, fast)) {
      // Every lane reads its bitstream: the reader alone.
      for (int o = block_first; o < block_first + L; ++o) {
        rd.prefetch();
        int v;
        rd.skip(decode_one(rd.peek(), last, plen8 - rd.pos, o < n, c, oob, v));
        tile.put(o, v);
        next_sample(o);
      }
    } else {
      // The JAX scan's rolling register, for long blocks past the buffer.
      int widx = 0, r = 0;
      uint32_t w0 = 0, w1 = 0;
      if (!fast && !unrolled) {
        widx = rel >> 5;
        r = rel & 31;
        w0 = win.slot(widx & m1);
        w1 = win.slot((widx + 1) & m1);
      }
      for (int k = 0; k < L; ++k) {
        const int o = block_first + k;
        int v;
        if (fast) {
          rd.prefetch();
          rd.skip(decode_one(rd.peek(), last, plen8 - rd.pos, o < n, c, oob, v));
        } else if (unrolled) {
          const uint32_t w32 = win.extract32(rel, stage_mask(min(WIN - 1, (37 + 16 * k) >> 5)));
          rel += decode_one(w32, last, rel_end - rel, o < n, c, oob, v);
        } else {
          const uint32_t ru = (uint32_t)r;
          const uint32_t w32 = (w0 << ru) | ((w1 >> (31u - ru)) >> 1);
          r += decode_one(w32, last, rel_end - ((widx << 5) + r), o < n, c, oob, v);
          if (r >= 32) {
            r -= 32;
            w0 = w1;
            w1 = win.slot(min(widx + 2, WIN) & m2);
            ++widx;
          }
        }
        tile.put(o, v);
        next_sample(o);
      }
      if (!fast && !unrolled) rel = (widx << 5) + r;
    }

    off = fast ? rd.pos : (win.wb << 5) + rel;
    if (err == 0) err = bpf_err ? 1 : (oob ? 2 : 0);
  }
  const int n_out = 1 + B * L;  // columns the walk produced
  if (n_out & (kTile - 1)) tile.flush(n_out & ~(kTile - 1), n_out & (kTile - 1));
  cp_async_wait<0>();
  if (err == 0 && off > WFULL * 32) err = 3;
  if (live) {
    err_out[f] = err;
    off_out[f] = off;
  }
}

}  // namespace

extern "C" int x3_decode_frames(const void* words, const void* n_samples, const void* payload_lens,
                                const void* consts, void* out, void* err, void* off, int F, int W,
                                int S, int B, int L, int WIN, int WFULL, void* stream) {
  if (F <= 0) return 0;
  const int threads = 32 * kWarps;
  const int blocks = (F + threads - 1) / threads;
  decode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)n_samples, (const int32_t*)payload_lens,
      (const int32_t*)consts, (int16_t*)out, (int32_t*)err, (int32_t*)off, F, W, S, B, L, WIN,
      WFULL);
  return (int)cudaGetLastError();
}
