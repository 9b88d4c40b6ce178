// K1: batched payload CRC16 over big-endian word rows.
//
// Replaces x3_tpu/ops/crc_pallas.py::crc_planes_pallas together with the
// S^-z un-padding of x3_tpu/ops/crc_jax.py::_crc16_finish: the TPU kernel
// computes the CRC's data part as a GF(2) matrix product on the MXU over
// the whole zero-padded buffer and un-pads afterwards.  Contract: the
// CRC-16/CCITT (init 0xffff) of the first clamp(lengths[f], 0, 4W) bytes of
// each row, whatever the bytes past the length hold.
//
// The algebra (that of crc_jax.py, in a form that fits the card).  S(r) =
// (r << 8) ^ T[r >> 8] advances the register over one zero byte; it is
// GF(2)-linear and invertible, and a byte b advances r to S(r) ^ T[b].  With
// D the CRC of zero init, D is linear in the message, leading zeros leave it
// unchanged, and trailing zeros apply S once each.
//
// The design: a warp per frame, walking the row in 128-byte stripes.  At
// step s lane j loads word 32 s + j (one coalesced 128-byte load per warp),
// masks the bytes at or past the length, and keeps the D of its own words
// with every other lane's bytes taken as zero:
//     p = A(p) ^ E0[b0] ^ E1[b1] ^ E2[b2] ^ E3[b3],  A = S^128,
// where A is two 256-entry tables (high and low byte of p) and E_k[b] is the
// D of a word whose only non-zero byte is b, at position k.  Only A's two
// lookups sit on the chain, so a frame costs ceil(n / 128) dependent steps
// instead of n dependent byte steps; the loads of the next kGroup steps are
// in flight while a group runs.  After the last step lane j's partial ends
// 4 (31 - j) bytes before the end of the stripe: it is advanced by
// S^(4 (31 - j)), the warp XOR-reduces the partials, which gives D of the
// row padded with z = 128 steps - n < 128 zero bytes, and S^-z undoes the
// padding.  Both are applied as 16 basis-image columns, one lane per column
// for S^-z.  The init needs no case of its own: lane 0 starts from
// S^-124(0xffff), which one step's A turns into the register after four
// bytes of a CRC that started at 0xffff (n = 0 gives 0xffff, n = 1 the
// one-byte CRC).  The tables (x3_tpu_torch/tables.py::crc_fold_tables_np,
// 8 KB of 16-bit entries) are copied into shared memory by each CTA, with
// 16-byte loads issued together with the first group's word loads.
//
// What bounds it on the card: each frame is a chain of dependent table
// lookups, one step per 128 bytes, so a small batch (the encoder's 768
// frames, six warps an SM) is latency bound per warp; a large one (the
// decoder's 8,192 lanes) is bound by shared-memory lookups, six per lane
// and step with random bank conflicts.  Each payload byte is read once, and
// bytes past the length are never read beyond the last word that holds one.
//
// Rejected: a tensor-core GF(2) product as on the TPU.  It needs the bits
// unpacked (8x the bytes) and a [32W, 16] matrix of up to 2 MB, where the
// tables here read each byte once.  Fusing the CRC into K2 or K3 would
// change both kernels' contracts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // frames per CTA, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;   // steps whose word loads are issued together
// Offsets into the uint16 tables and their size: the FOLD_* of
// x3_tpu_torch/tables.py, which tests/test_torch_crc.py holds equal to these.
constexpr int kAHi = 0, kALo = 256, kE = 512, kLane = 1536, kUnpad = 2048, kSeed = 4096;
constexpr int kTableSize = 4104;
constexpr int kTableVecs = kTableSize / 8;  // as 16-byte vectors
constexpr int kCopies = (kTableVecs + kThreads - 1) / kThreads;

__device__ __forceinline__ uint32_t byte_mask(int keep) {
  // The leading `keep` bytes of a big-endian word (all of it from 4 up).
  return keep >= 4 ? 0xFFFFFFFFu : keep <= 0 ? 0u : ~(0xFFFFFFFFu >> (8 * keep));
}

__global__ void __launch_bounds__(kThreads)
crc16_fold_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lengths,
                  const uint4* __restrict__ tables, int32_t* __restrict__ crc_out, int F,
                  int W) {
  __shared__ uint4 tab4[kTableVecs];
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n = f < F ? min(max(__ldg(lengths + f), 0), 4 * W) : 0;
  const int nw = (n + 3) >> 2;      // words that hold a byte of the message
  const int steps = (n + 127) >> 7;  // stripes of 128 bytes
  const uint32_t* row = words + (size_t)f * (size_t)W;

  // The first group's words and the tables are loaded together: every
  // load is issued before the first store to shared memory.
  uint32_t cur[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const int i = 32 * k + lane;
    cur[k] = i < nw ? __ldg(row + i) : 0u;
  }
  uint4 v[kCopies];
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    const int i = threadIdx.x + kThreads * k;
    if (i < kTableVecs) v[k] = __ldg(tables + i);
  }
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    const int i = threadIdx.x + kThreads * k;
    if (i < kTableVecs) tab4[i] = v[k];
  }
  __syncthreads();
  if (f >= F) return;  // the whole warp: every lane below reaches the reductions
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(tab4);

  uint32_t p = lane == 0 ? tab[kSeed] : 0u;
  for (int g = 0; g < steps; g += kGroup) {
    uint32_t nxt[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int i = 32 * (g + kGroup + k) + lane;
      nxt[k] = i < nw ? __ldg(row + i) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (g + k < steps) {  // the same on every lane
        const uint32_t x = cur[k] & byte_mask(n - 4 * (32 * (g + k) + lane));
        const uint32_t e = tab[kE + (x >> 24)] ^ tab[kE + 256 + ((x >> 16) & 0xFFu)] ^
                           tab[kE + 512 + ((x >> 8) & 0xFFu)] ^ tab[kE + 768 + (x & 0xFFu)];
        p = tab[kAHi + (p >> 8)] ^ tab[kALo + (p & 0xFFu)] ^ e;
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) cur[k] = nxt[k];
  }

  // Advance lane j's partial to the end of the stripe, XOR the warp's.
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) r ^= tab[kLane + 32 * b + lane] & (0u - ((p >> b) & 1u));
  r = __reduce_xor_sync(0xFFFFFFFFu, r);
  // Undo the z trailing zero bytes: lane b < 16 applies column b of S^-z.
  const int z = 128 * steps - n;
  const uint32_t u = lane < 16 ? tab[kUnpad + 16 * z + lane] & (0u - ((r >> lane) & 1u)) : 0u;
  const uint32_t crc = __reduce_xor_sync(0xFFFFFFFFu, u);
  if (lane == 0) crc_out[f] = (int32_t)crc;
}

}  // namespace

extern "C" int x3_crc16_words(const void* words, const void* lengths, const void* tables,
                              void* crc_out, int F, int W, void* stream) {
  if (F <= 0) return 0;
  const int blocks = (F + kWarps - 1) / kWarps;
  crc16_fold_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths, (const uint4*)tables,
      (int32_t*)crc_out, F, W);
  return (int)cudaGetLastError();
}
