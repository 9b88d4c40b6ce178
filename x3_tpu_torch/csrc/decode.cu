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
// simple design gives each frame one thread, reads words through the
// read-only cache and writes int16 samples straight to the [F, S] output.
// Staging a warp's outputs in shared memory for coalesced stores, or
// splitting a frame's walk, is left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap16(int v) { return ((v + 0x8000) & 0xFFFF) - 0x8000; }

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

struct BlockCodes {
  int ftype;
  int dec_nb;
  bool is_rice;
  bool is_pass;
  int level;
  int nbsuf;
  int invlen;
  int neg_thresh;
};

// Decode one sample from its 32-bit view; returns the bits consumed.
__device__ __forceinline__ int decode_one(uint32_t win32, int last, int cap, bool valid,
                                          const BlockCodes& c, bool& oob, int& out) {
  const int zeros = min((int)__clz(win32), max(cap, 0));
  const uint32_t zc = (uint32_t)min(max(zeros, 0), 31);
  const int suffix = (int)((win32 << zc) >> (32 - c.nbsuf));
  const int idx = c.ftype == 1 ? zeros : suffix + c.level * (zeros - 1);
  if (valid && c.is_rice && (idx < 0 || idx >= c.invlen)) oob = true;
  const int ic = min(max(idx, 0), 59);
  const int half = (ic + 1) >> 1;
  const int delta_rice = (ic & 1) ? -half : half;
  const int nbu = min(max(c.dec_nb, 1), 31);
  const int a = (int)(win32 >> (32 - nbu));
  const int delta_bfp = a - (a > c.neg_thresh ? c.neg_thresh * 2 : 0);
  const int delta = c.is_rice ? delta_rice : delta_bfp;
  out = c.is_pass ? wrap16((int)(win32 >> 16)) : wrap16(last + delta);
  const int consume = c.ftype == 1 ? zeros + 1 : (c.is_rice ? zeros + c.nbsuf : c.dec_nb);
  return min(consume, 16);
}

__global__ void decode_kernel(const uint32_t* __restrict__ words,
                              const int32_t* __restrict__ n_samples,
                              const int32_t* __restrict__ payload_lens,
                              const int32_t* __restrict__ consts,
                              int16_t* __restrict__ out, int32_t* __restrict__ err_out,
                              int32_t* __restrict__ off_out, int F, int W, int S, int B, int L,
                              int WIN, int WFULL) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  int nsubs[4], invlen[4];
  for (int i = 0; i < 4; ++i) {
    nsubs[i] = consts[i];
    invlen[i] = consts[4 + i];
  }
  const uint32_t* row = words + (size_t)f * (size_t)W;
  int16_t* orow = out + (size_t)f * (size_t)S;
  const int n = n_samples[f];
  const int plen8 = payload_lens[f] * 8;
  const int first = wrap16((int)((__ldg(row) >> 16) & 0xFFFFu));
  if (S > 0) orow[0] = (int16_t)first;

  int off = 16;
  int last = first;
  int err = 0;
  const bool unrolled = L <= 24;
  const int m1 = stage_mask(WIN - 1);
  const int m2 = stage_mask(WIN);
  for (int b = 0; b < B; ++b) {
    const int block_first = 1 + b * L;
    const bool valid_block = block_first < n;
    Window win{row, W, WIN, min(off >> 5, W - 1)};
    int rel = off - (win.wb << 5);

    const uint32_t hdr = win.extract32(rel, stage_mask(min(WIN - 1, 1)));
    BlockCodes c;
    c.ftype = (int)(hdr >> 30);
    c.dec_nb = (int)((hdr >> 26) & 0xFu) + 1;
    const bool is_hdr0 = c.ftype == 0;
    c.is_pass = is_hdr0 && c.dec_nb == 16;
    c.is_rice = c.ftype >= 1;
    const bool bpf_err = valid_block && is_hdr0 && c.dec_nb <= 5;
    rel += is_hdr0 ? 6 : 2;  // the header advances even past the sample count
    c.level = 1 << (c.ftype == 2 ? nsubs[2] : nsubs[3]);
    c.nbsuf = c.ftype == 2 ? 2 : 4;  // decoder.rs:180: hardwired
    c.invlen = c.ftype == 1 ? invlen[1] : (c.ftype == 2 ? invlen[2] : invlen[3]);
    c.neg_thresh = 1 << min(max(c.dec_nb - 1, 0), 30);
    const int rel_end = plen8 - (win.wb << 5);
    bool oob = false;

    if (unrolled) {
      for (int k = 0; k < L; ++k) {
        const bool valid = valid_block && block_first + k < n;
        const uint32_t w32 = win.extract32(rel, stage_mask(min(WIN - 1, (37 + 16 * k) >> 5)));
        int v;
        const int consume = decode_one(w32, last, rel_end - rel, valid, c, oob, v);
        if (valid) {
          rel += consume;
          last = v;
        }
        const int o = block_first + k;
        if (o < S) orow[o] = (int16_t)v;
      }
    } else {
      int widx = rel >> 5;
      int r = rel & 31;
      uint32_t w0 = win.slot(widx & m1);
      uint32_t w1 = win.slot((widx + 1) & m1);
      for (int k = 0; k < L; ++k) {
        const bool valid = valid_block && block_first + k < n;
        const uint32_t ru = (uint32_t)r;
        const uint32_t w32 = (w0 << ru) | ((w1 >> (31u - ru)) >> 1);
        int v;
        const int consume = decode_one(w32, last, rel_end - ((widx << 5) + r), valid, c, oob, v);
        if (valid) {
          r += consume;
          last = v;
        }
        if (r >= 32) {
          r -= 32;
          w0 = w1;
          w1 = win.slot(min(widx + 2, WIN) & m2);
          ++widx;
        }
        const int o = block_first + k;
        if (o < S) orow[o] = (int16_t)v;
      }
      rel = (widx << 5) + r;
    }

    off = (win.wb << 5) + rel;
    if (err == 0) err = bpf_err ? 1 : (oob ? 2 : 0);
  }
  if (err == 0 && off > WFULL * 32) err = 3;
  err_out[f] = err;
  off_out[f] = off;
}

}  // namespace

extern "C" int x3_decode_frames(const void* words, const void* n_samples, const void* payload_lens,
                                const void* consts, void* out, void* err, void* off, int F, int W,
                                int S, int B, int L, int WIN, int WFULL, void* stream) {
  if (F <= 0) return 0;
  const int threads = 32;
  const int blocks = (F + threads - 1) / threads;
  decode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)n_samples, (const int32_t*)payload_lens,
      (const int32_t*)consts, (int16_t*)out, (int32_t*)err, (int32_t*)off, F, W, S, B, L, WIN,
      WFULL);
  return (int)cudaGetLastError();
}
