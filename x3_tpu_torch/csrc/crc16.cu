// K1: batched payload CRC16 over big-endian word rows.
//
// Replaces x3_tpu/ops/crc_pallas.py::crc_planes_pallas together with the
// S^-z un-padding of x3_tpu/ops/crc_jax.py::_crc16_finish: the TPU kernel
// computes the CRC's data part as a GF(2) matrix product on the MXU over
// the whole zero-padded buffer and un-pads afterwards.  Here the CRC is
// computed directly: CRC-16/CCITT (init 0xffff, table x3_tpu.ops.crc.
// CRC_TABLE, passed in) over the first lengths[f] bytes of each row, so no
// un-padding is needed and bytes past the length are never read.
//
// What bounds it on the card: each frame is one serial byte chain (a table
// lookup per byte), so the kernel is latency bound per thread.  The simple
// design gives each frame one thread with the table in shared memory and
// reads its row one word (four bytes) at a time; a frame's row stays in L1
// across its loop.  Folding chunks of a row in parallel (CRC is linear) is
// left for a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void crc16_words_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ lengths,
                                   const int32_t* __restrict__ table,
                                   int32_t* __restrict__ crc_out, int F, int W) {
  __shared__ uint32_t t[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t[i] = (uint32_t)table[i] & 0xFFFFu;
  __syncthreads();
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  int len = lengths[f];
  len = len < 0 ? 0 : (len > 4 * W ? 4 * W : len);
  const uint32_t* row = words + (size_t)f * (size_t)W;
  uint32_t crc = 0xFFFFu;
  const int nfull = len >> 2;
  for (int i = 0; i < nfull; ++i) {
    const uint32_t w = __ldg(row + i);
#pragma unroll
    for (int sh = 24; sh >= 0; sh -= 8) {
      const uint32_t byte = (w >> sh) & 0xFFu;
      crc = ((crc << 8) ^ t[(byte ^ (crc >> 8)) & 0xFFu]) & 0xFFFFu;
    }
  }
  const int tail = len & 3;
  if (tail) {
    const uint32_t w = __ldg(row + nfull);
    for (int j = 0; j < tail; ++j) {
      const uint32_t byte = (w >> (24 - 8 * j)) & 0xFFu;
      crc = ((crc << 8) ^ t[(byte ^ (crc >> 8)) & 0xFFu]) & 0xFFFFu;
    }
  }
  crc_out[f] = (int32_t)crc;
}

}  // namespace

extern "C" int x3_crc16_words(const void* words, const void* lengths, const void* table,
                              void* crc_out, int F, int W, void* stream) {
  if (F <= 0) return 0;
  const int threads = 128;
  const int blocks = (F + threads - 1) / threads;
  crc16_words_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)lengths, (const int32_t*)table,
      (int32_t*)crc_out, F, W);
  return (int)cudaGetLastError();
}
