// K2: whole-frame encode, samples in, payload words out.
//
// Replaces x3_tpu/ops/encode_fused_pallas.py::encode_frames_fused_words
// (plus the nbytes of encode_kernel._finish_fused): diff, masked max-|diff|
// classification into Rice / BFP / literal blocks, closed-form codes, and
// the bit pack into the frame's W payload words, with exact total_bits,
// blockfit_bits (max over blocks of (block offset & 255) + block bits)
// and the six statistics counters.
//
// What bounds it on the card: the pack is a prefix sum over each frame's
// item lengths followed by scattered bit inserts, so the cost is integer
// work and shared-memory atomics, not device-memory bytes (the samples are
// read once and the words written once).  The simple design: one CUDA
// block per frame, each thread owning a contiguous run of X3 blocks.
// Pass 1 sums each thread's block bits; a shared-memory scan over the
// threads gives every block its bit offset; pass 2 recomputes the codes and
// ORs each item into a W-word buffer in shared memory (bits are disjoint,
// so atomicOr is exact).  Bits at or past word W are dropped, which is the
// compact-rung overflow contract: truncated words, exact counts.  There are
// no per-block buffers, so the block-buffer rung truncates nothing here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

struct EncParams {
  int t0, t1, t2;  // classification thresholds
  int ord[3];      // Rice order of each selected code
  int slot[3];     // statistics slot of each selected code
};

struct BlockInfo {
  int cnt;      // samples coded in the block (0 = block absent)
  bool rice;
  bool literal;
  int nb;       // bit length of max |diff|
  int order;    // Rice order when rice
  int hdr_val;
  int hdr_len;
  int slot;
};

__device__ __forceinline__ int sample_at(const int16_t* s, int S, int j) {
  return j < S ? (int)s[j] : 0;
}

__device__ BlockInfo classify(const int16_t* s, int S, int n, int b, int L, const EncParams& p) {
  BlockInfo bi;
  const int base = b * L;
  int cnt = n - 1 - base;
  cnt = cnt < 0 ? 0 : (cnt > L ? L : cnt);
  int ma = 0;
  for (int k = 0; k < cnt; ++k) {
    const int d = sample_at(s, S, base + k + 1) - sample_at(s, S, base + k);
    ma = max(ma, abs(d));
  }
  const int ftype = (ma > p.t0) + (ma > p.t1) + (ma > p.t2);
  const int rsel = ftype < 2 ? ftype : 2;
  bi.cnt = cnt;
  bi.rice = ma <= p.t2;
  bi.nb = 32 - __clz(max(ma, 1));
  bi.literal = !bi.rice && bi.nb >= 15;
  bi.order = p.ord[rsel];
  bi.slot = bi.rice ? p.slot[rsel] : (bi.literal ? 5 : 4);
  bi.hdr_val = cnt > 0 ? (bi.rice ? ftype + 1 : (bi.literal ? 15 : bi.nb)) : 0;
  bi.hdr_len = cnt > 0 ? (bi.rice ? 2 : 6) : 0;
  return bi;
}

// (value, bits) of the sample with diff d and raw value snext.
__device__ __forceinline__ void code_of(int d, int snext, const BlockInfo& bi, uint32_t& v, int& l) {
  if (bi.rice) {
    const int k = bi.order;
    if (k == 0) {
      v = 1u;
      l = 2 * abs(d) + (d >= 0 ? 1 : 0);
    } else {
      const int e = d >= 0 ? d : -d - 1;
      l = (k + 1) + (e >> (k - 1));
      const int low = (d & ((1 << (k - 1)) - 1)) << 1;
      v = (uint32_t)(d >= 0 ? ((1 << k) | low) : (((1 << (k + 1)) - 1) - low));
    }
  } else if (bi.literal) {
    v = (uint32_t)snext & 0xFFFFu;
    l = 16;
  } else {
    l = bi.nb + 1;
    v = (uint32_t)d & ((1u << (l < 31 ? l : 31)) - 1u);
  }
}

// OR an l-bit item at bit offset off into the shared word buffer; pieces at
// word W or later are dropped.  An item longer than 32 bits keeps its value
// in its last 32 bits (the leading bits are zeros).
__device__ __forceinline__ void emit(uint32_t* sw, int W, int off, uint32_t v, int l) {
  if (l <= 0) return;
  if (l > 32) {
    off += l - 32;
    l = 32;
  }
  const int w0 = off >> 5;
  const int r = off & 31;
  const unsigned long long x = (unsigned long long)v << (64 - r - l);
  const uint32_t hi = (uint32_t)(x >> 32);
  const uint32_t lo = (uint32_t)x;
  if (hi && w0 < W) atomicOr(sw + w0, hi);
  if (lo && w0 + 1 < W) atomicOr(sw + w0 + 1, lo);
}

__device__ int block_bits(const int16_t* s, int S, int n, int b, int L, const EncParams& p) {
  const BlockInfo bi = classify(s, S, n, b, L, p);
  int bits = (b == 0 && n > 0) ? 16 : 0;
  bits += bi.hdr_len;
  const int base = b * L;
  for (int k = 0; k < bi.cnt; ++k) {
    const int sn = sample_at(s, S, base + k + 1);
    uint32_t v;
    int l;
    code_of(sn - sample_at(s, S, base + k), sn, bi, v, l);
    bits += l;
  }
  return bits;
}

__global__ void encode_kernel(const int16_t* __restrict__ samples,
                              const int32_t* __restrict__ n_valid,
                              const int32_t* __restrict__ consts,
                              uint32_t* __restrict__ words, int32_t* __restrict__ total_bits,
                              int32_t* __restrict__ blockfit, int32_t* __restrict__ nbytes,
                              int32_t* __restrict__ stats, int S, int B, int L, int W) {
  extern __shared__ uint32_t sw[];  // the frame's W payload words
  __shared__ int scan[kMaxThreads];
  __shared__ int s_stats[6];
  __shared__ int s_fit;

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  EncParams p;
  p.t0 = consts[0];
  p.t1 = consts[1];
  p.t2 = consts[2];
  for (int i = 0; i < 3; ++i) {
    p.ord[i] = consts[3 + i];
    p.slot[i] = consts[6 + i];
  }
  const int16_t* s = samples + (size_t)f * (size_t)S;
  const int n = n_valid[f];

  for (int i = tid; i < W; i += T) sw[i] = 0u;
  if (tid < 6) s_stats[tid] = 0;
  if (tid == 0) s_fit = 0;

  const int C = (B + T - 1) / T;  // blocks per thread
  const int b0 = min(B, tid * C);
  const int b1 = min(B, b0 + C);

  // Pass 1: this thread's bit count, then an inclusive scan over threads.
  int local = 0;
  for (int b = b0; b < b1; ++b) local += block_bits(s, S, n, b, L, p);
  scan[tid] = local;
  __syncthreads();
  for (int o = 1; o < T; o <<= 1) {
    const int add = tid >= o ? scan[tid - o] : 0;
    __syncthreads();
    scan[tid] += add;
    __syncthreads();
  }
  int off = scan[tid] - local;
  const int total = scan[T - 1];

  // Pass 2: place every item of this thread's blocks.
  int fit = 0;
  for (int b = b0; b < b1; ++b) {
    const BlockInfo bi = classify(s, S, n, b, L, p);
    const int start = off;
    if (b == 0 && n > 0) {
      emit(sw, W, off, (uint32_t)s[0] & 0xFFFFu, 16);
      off += 16;
    }
    if (bi.cnt > 0) {
      emit(sw, W, off, (uint32_t)bi.hdr_val, bi.hdr_len);
      off += bi.hdr_len;
      const int base = b * L;
      for (int k = 0; k < bi.cnt; ++k) {
        const int sn = sample_at(s, S, base + k + 1);
        uint32_t v;
        int l;
        code_of(sn - sample_at(s, S, base + k), sn, bi, v, l);
        emit(sw, W, off, v, l);
        off += l;
      }
      atomicAdd(&s_stats[bi.slot], bi.cnt);
    }
    fit = max(fit, (start & 255) + (off - start));
  }
  atomicMax(&s_fit, fit);
  __syncthreads();

  uint32_t* out = words + (size_t)f * (size_t)W;
  for (int i = tid; i < W; i += T) out[i] = sw[i];
  if (tid == 0) {
    total_bits[f] = total;
    int nb = (total + 7) / 8;
    nbytes[f] = nb + (nb & 1);
    blockfit[f] = s_fit;
    for (int j = 0; j < 6; ++j) stats[(size_t)f * 6 + j] = s_stats[j];
  }
}

}  // namespace

extern "C" int x3_encode_frames(const void* samples, const void* n_valid, const void* consts,
                                void* words, void* total_bits, void* blockfit, void* nbytes,
                                void* stats, int F, int S, int B, int L, int W, void* stream) {
  if (F <= 0) return 0;
  int T = ((B + 31) / 32) * 32;
  if (T > kMaxThreads) T = kMaxThreads;
  const size_t smem = (size_t)W * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  encode_kernel<<<F, T, smem, (cudaStream_t)stream>>>(
      (const int16_t*)samples, (const int32_t*)n_valid, (const int32_t*)consts,
      (uint32_t*)words, (int32_t*)total_bits, (int32_t*)blockfit, (int32_t*)nbytes,
      (int32_t*)stats, S, B, L, W);
  return (int)cudaGetLastError();
}
