// The embed's u8 epilogue (K4e) for Hopper: from the unscaled inverse
// corner DFT t to the u8 stego, in one pass.
//
// Replaces what XLA fuses for the TPU at the end of
// steganosaurus_tpu/parallel/batch.py:corner_embed_core: the 1/(H*W) scale of
// steganosaurus_tpu/spectral/corner.py:ifft_corner_real, apply_center,
// floor(planes + t + 0.5), the clip to [0, 255], the u8 cast and, for
// layout "nhwc", the transpose. Per pixel (b, c, h, w):
//
//     u8 = clamp(floor((t * inv * sgn + p) + 0.5), 0, 255)
//
// inv = f32(1/(H*W)) rounded on the host, sgn = (-1)^(h+w) when `center` is
// set (else 1), p the cover's u8 value. Each step rounds as torch's eager
// ops do (built with -fmad=false, the sums as __fadd_rn), so the bytes are
// the plain version's, bit for bit.
//
// Bound on the H100 (3.35 TB/s) at the main shape, 4K B=64 (P = 192 planes
// of 2160x3840): t read once (6.37 GB f32), the cover planes (1.59 GB u8),
// the stego written once (1.59 GB u8): 9.55e9 bytes, 2.85 ms. Bytes bound.
//
// Design: one thread per (image, pixel) and PIX pixels a thread, the three
// planes of a pixel in the same thread, so the NHWC store is three
// consecutive bytes and the permute-and-copy pass of the eager version
// goes; the f32 loads of t and the u8 loads of the cover are coalesced
// along w in both layouts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIX = 4;

__global__ void __launch_bounds__(THREADS)
epilogue_kernel(const float* __restrict__ t, const uint8_t* __restrict__ planes,
                uint8_t* __restrict__ out, int W, long long HW, float inv,
                int center, int nhwc) {
  const long long b = blockIdx.y;
  const long long base = (long long)blockIdx.x * THREADS * PIX + threadIdx.x;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const long long px = base + (long long)k * THREADS;
    if (px >= HW) break;
    const long long h = px / W, w = px - h * W;
    const bool flip = center && ((h + w) & 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const long long off = (b * 3 + c) * HW + px;
      float v = __fmul_rn(t[off], inv);
      if (flip) v = -v;
      v = __fadd_rn(v, (float)planes[off]);
      v = __fadd_rn(v, 0.5f);
      v = fminf(fmaxf(floorf(v), 0.f), 255.f);
      out[nhwc ? (b * HW + px) * 3 + c : off] = (uint8_t)v;
    }
  }
}

}  // namespace

// t: (B, 3, H, W) f32, the inverse corner DFT before its 1/(H*W) scale;
// planes: (B, 3, H, W) u8 covers; out: (B, 3, H, W) u8, or (B, H, W, 3) with
// nhwc. Returns cudaGetLastError() after the launch.
extern "C" int corner_epilogue(const void* t, const void* planes, void* out,
                               int B, int H, int W, float inv, int center,
                               int nhwc, void* stream) {
  if (!t || !planes || !out || B <= 0 || H <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long HW = (long long)H * W;
  const long long per_block = (long long)THREADS * PIX;
  const dim3 grid((unsigned)((HW + per_block - 1) / per_block), B);
  epilogue_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const uint8_t*)planes, (uint8_t*)out, W, HW, inv,
      center, nhwc);
  return (int)cudaGetLastError();
}
