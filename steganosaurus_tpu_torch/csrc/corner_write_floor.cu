// The embed's dense corner write and its write floor (K3) for Hopper: one
// source, two C entry points.
//
// Replaces what XLA fuses for the TPU in
// steganosaurus_tpu/parallel/batch.py:corner_embed_core (the bit lookup
// through `pos`, then steganosaurus_tpu/spectral/corner.py:write_delta and
// :apply_write_floor). Per corner bin i of image b (N = 3*Ky*Kx bins, the
// trailing (3, Ky, Kx) axes flattened):
//
//     bit  = frame[b, pos[i]] where pos[i] < bucket, else no walk bin (mask 0)
//     D    = 2*mask*(mag*e^{i(jd + s*alpha)} - C)          (hard write)
//            or the soft write's minimal move (write_delta, soft=True)
//     V, X, Hs = per-image sums of wm*|C s|^2, Re(C s conj h), |h|^2,
//            h = 0.5*s*D, s = 1/img_pixels, wm = |h|^2 > 0
//     b    = clip(((V+X) + sqrt(max((V+X)^2 - p(V - E*), 0))) / max(p, 1e-30),
//                 1, 32), p = V + 2X + Hs, E* = 1.5*floor^2
//     D_b  = b*D + 2(b-1)*wm*C
//
// - corner_write_floor: the write and the floor, D computed here from the
//   spectrum (cr, ci), the int32 slot map pos, the u8 frame bits and, when
//   given, the cos/sin jitter maps (cjd, sjd) and the cos/sin amplitude
//   maps (cad, sad); else the scalar cos/sin of alpha as the host computed
//   them in f32 (no cosf/sinf here). use_floor == 0 writes D itself.
// - corner_floor_only: the floor alone, over a D given as (dr, di) (the QIM
//   write and the per-image-walk scatter, still eager torch).
//
// Bound on the H100 (3.35 TB/s) at the main shape, 4K B=64 (Ky = Kx =
// 1024): cr, ci read once (1.61 GB), pos int32 (12.6 MB), the frame bits
// (59 MB), dr, di written once (1.61 GB): ~3.3e9 bytes, ~0.98 ms. Bytes
// bound: a few dozen f32 operations per bin against 16 bytes.
//
// Design. Three launches on the caller's stream, no atomics:
// 1. partials (grid: blocks of CHUNK bins x images): each thread recomputes
//    D for PER_THREAD bins of one image (consecutive threads on consecutive
//    bins) and sums its three terms in order; a warp tree
//    (__shfl_down_sync 16, 8, 4, 2, 1), then thread 0 adds the 8 warps'
//    sums in order. One (V, X, Hs) triple per block into scratch.
// 2. boost (one block per image): thread t adds partials t, t + 256, ... in
//    order, the same block tree, then b in f32 as apply_write_floor writes
//    it, into a (B,) buffer the wrapper may return.
// 3. apply (the grid of 1): recomputes D (or reads the given one) and
//    writes D_b; without the floor, D.
// The sums' order depends only on N and the block size, never on B or on
// the mesh shard, so a batch split over shards boosts each image the same.
// D is computed twice rather than stored and read back: the same bytes.
// Every rounding is torch's eager one, op by op: built with -fmad=false,
// and the products and sums written as __fmul_rn / __fadd_rn, so where
// b == 1 the output is the plain version's bit for bit; where b > 1 it
// differs only through the sums' order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;  // bins of one image per block

struct Delta {
  const float* cr;
  const float* ci;
  const int32_t* pos;     // (N,) slot of each bin, `bucket` where none
  const uint8_t* frame;   // (B, bucket) frame bits
  const float* cjd;       // (N,) jitter maps, or null
  const float* sjd;
  const float* cad;       // (N,) amplitude maps, or null
  const float* sad;
  const float* dr_in;     // (B, N) a given delta (floor only), or null
  const float* di_in;
  float ca, sa;           // cos/sin(alpha) when there are no amplitude maps
  int bucket;
  int soft;
  long long N;
};

struct Floor {
  float half_s;  // 0.5 * f32(1/img_pixels)
  float s;       // f32(1/img_pixels)
  float e_star;  // f32(1.5 * floor^2)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// write_delta for bin i of image b, from its spectrum value (r, m).
__device__ __forceinline__ void delta(const Delta& a, int b, long long i,
                                      float r, float m, float& dr, float& di) {
  const long long off = (long long)b * a.N + i;
  if (a.dr_in) {
    dr = a.dr_in[off];
    di = a.di_in[off];
    return;
  }
  const int p = a.pos[i];
  const bool in = p < a.bucket;
  // the sentinel slot reads bit 0, as the plain version's zero column
  const float sign = (in && a.frame[(long long)b * a.bucket + p]) ? 1.f : -1.f;
  const float m2 = in ? 2.f : 0.f;
  const float ca = a.cad ? a.cad[i] : a.ca;
  const float sa = a.sad ? a.sad[i] : a.sa;
  float mag = __fsqrt_rn(add(mul(r, r), mul(m, m)));
  mag = fmaxf(mag, 1e-12f);
  const bool jit = a.cjd != nullptr;
  const float cj = jit ? a.cjd[i] : 1.f;
  const float sj = jit ? a.sjd[i] : 0.f;
  if (a.soft) {
    const float sigma = sa < 0.f ? -1.f : 1.f;
    const float abs_sin = fabsf(sa), abs_cos = fabsf(ca);
    float ur = r, ui = m;
    if (jit) {
      ur = add(mul(r, cj), mul(m, sj));
      ui = sub(mul(m, cj), mul(r, sj));
    }
    const float ss = sign * sigma;
    const float ms = mul(mag, abs_sin);
    const bool valid = mul(ss, ui) >= ms;
    const float tr = (ur < 0.f ? -1.f : 1.f) * mul(mag, abs_cos);
    const float ti = ss * ms;
    float nr = tr, ni = ti;
    if (jit) {
      nr = sub(mul(tr, cj), mul(ti, sj));
      ni = add(mul(tr, sj), mul(ti, cj));
    }
    dr = mul(m2, valid ? 0.f : sub(nr, r));
    di = mul(m2, valid ? 0.f : sub(ni, m));
    return;
  }
  float cos_t = ca, sin_t = sign * sa;
  if (jit) {
    cos_t = sub(mul(cj, ca), sign * mul(sj, sa));
    sin_t = add(mul(sj, ca), sign * mul(cj, sa));
  }
  dr = mul(m2, sub(mul(mag, cos_t), r));
  di = mul(m2, sub(mul(mag, sin_t), m));
}

// Sum of v over the block, in a fixed order; the result in thread 0.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // sh may still be read by an earlier call
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    s = sh[0];
    for (int w = 1; w < THREADS / 32; ++w) s = add(s, sh[w]);
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
partials_kernel(Delta a, Floor f, float* partials) {
  __shared__ float sh[THREADS / 32];
  const int b = blockIdx.y;
  const long long base = (long long)blockIdx.x * CHUNK + threadIdx.x;
  const long long img = (long long)b * a.N;
  float v = 0.f, x = 0.f, h = 0.f;
#pragma unroll 4
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = base + (long long)k * THREADS;
    if (i >= a.N) break;
    const float r = a.cr[img + i], m = a.ci[img + i];
    float dr, di;
    delta(a, b, i, r, m, dr, di);
    const float hr = mul(f.half_s, dr), hi = mul(f.half_s, di);
    const float hh = add(mul(hr, hr), mul(hi, hi));
    const float wm = hh > 0.f ? 1.f : 0.f;
    const float rs = mul(r, f.s), is = mul(m, f.s);
    v = add(v, mul(wm, add(mul(rs, rs), mul(is, is))));
    x = add(x, add(mul(rs, hr), mul(is, hi)));
    h = add(h, hh);
  }
  v = block_sum(v, sh);
  x = block_sum(x, sh);
  h = block_sum(h, sh);
  if (threadIdx.x == 0) {
    float* out = partials + ((long long)b * gridDim.x + blockIdx.x) * 3;
    out[0] = v;
    out[1] = x;
    out[2] = h;
  }
}

__global__ void __launch_bounds__(THREADS)
boost_kernel(const float* partials, int nblk, Floor f, float* boost) {
  __shared__ float sh[THREADS / 32];
  const float* p = partials + (long long)blockIdx.x * nblk * 3;
  float v = 0.f, x = 0.f, h = 0.f;
  for (int k = threadIdx.x; k < nblk; k += THREADS) {
    v = add(v, p[3 * k]);
    x = add(x, p[3 * k + 1]);
    h = add(h, p[3 * k + 2]);
  }
  const float V = block_sum(v, sh);
  const float X = block_sum(x, sh);
  const float Hs = block_sum(h, sh);
  if (threadIdx.x == 0) {
    const float vx = add(V, X);
    const float pp = add(add(V, mul(2.f, X)), Hs);
    float disc = sub(mul(vx, vx), mul(pp, sub(V, f.e_star)));
    disc = fmaxf(disc, 0.f);
    float bb = __fdiv_rn(add(vx, __fsqrt_rn(disc)), fmaxf(pp, 1e-30f));
    boost[blockIdx.x] = fminf(fmaxf(bb, 1.f), 32.f);
  }
}

__global__ void __launch_bounds__(THREADS)
apply_kernel(Delta a, Floor f, const float* boost, int use_floor,
             float* out_r, float* out_i) {
  const int b = blockIdx.y;
  const long long base = (long long)blockIdx.x * CHUNK + threadIdx.x;
  const long long img = (long long)b * a.N;
  const float bb = use_floor ? boost[b] : 1.f;
  const float q = mul(2.f, sub(bb, 1.f));
#pragma unroll 4
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = base + (long long)k * THREADS;
    if (i >= a.N) break;
    const float r = a.cr[img + i], m = a.ci[img + i];
    float dr, di;
    delta(a, b, i, r, m, dr, di);
    if (use_floor) {
      const float hr = mul(f.half_s, dr), hi = mul(f.half_s, di);
      const float wm = add(mul(hr, hr), mul(hi, hi)) > 0.f ? 1.f : 0.f;
      const float qw = mul(q, wm);
      dr = add(mul(bb, dr), mul(qw, r));
      di = add(mul(bb, di), mul(qw, m));
    }
    out_r[img + i] = dr;
    out_i[img + i] = di;
  }
}

int launch(const Delta& a, const Floor& f, int B, int nblk, float* partials,
           float* boost, int use_floor, float* out_r, float* out_i,
           cudaStream_t st) {
  if (B <= 0 || a.N <= 0 || nblk != (int)((a.N + CHUNK - 1) / CHUNK) ||
      nblk > 65535 * 64 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nblk, B);
  if (use_floor) {
    if (!partials || !boost) return (int)cudaErrorInvalidValue;
    partials_kernel<<<grid, THREADS, 0, st>>>(a, f, partials);
    boost_kernel<<<B, THREADS, 0, st>>>(partials, nblk, f, boost);
  }
  apply_kernel<<<grid, THREADS, 0, st>>>(a, f, boost, use_floor, out_r, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// The write (hard or soft; jitter and amplitude maps optional) and, with
// use_floor, the write floor. cr, ci, out_r, out_i: (B, N) f32; pos (N,)
// int32; frame (B, bucket) u8; maps (N,) f32 or null; partials (B, nblk, 3)
// and boost (B,) f32 scratch (unused without the floor). nblk must be
// ceil(N / 4096). Returns cudaGetLastError() after the launches.
extern "C" int corner_write_floor(const void* cr, const void* ci,
                                  const void* pos, const void* frame,
                                  const void* cjd, const void* sjd,
                                  const void* cad, const void* sad,
                                  void* out_r, void* out_i, void* partials,
                                  void* boost, int B, int N, int nblk,
                                  int bucket, float cos_a, float sin_a,
                                  int soft, float half_s, float s,
                                  float e_star, int use_floor, void* stream) {
  if (!cr || !ci || !pos || !frame || !out_r || !out_i || bucket <= 0 ||
      (cjd == nullptr) != (sjd == nullptr) || (cad == nullptr) != (sad == nullptr))
    return (int)cudaErrorInvalidValue;
  Delta a{(const float*)cr, (const float*)ci, (const int32_t*)pos,
          (const uint8_t*)frame, (const float*)cjd, (const float*)sjd,
          (const float*)cad, (const float*)sad, nullptr, nullptr,
          cos_a, sin_a, bucket, soft, (long long)N};
  Floor f{half_s, s, e_star};
  return launch(a, f, B, nblk, (float*)partials, (float*)boost, use_floor,
                (float*)out_r, (float*)out_i, (cudaStream_t)stream);
}

// The write floor over a given delta (dr, di): (B, N) f32 each, beside the
// spectrum (cr, ci); the rest as corner_write_floor.
extern "C" int corner_floor_only(const void* dr, const void* di,
                                 const void* cr, const void* ci, void* out_r,
                                 void* out_i, void* partials, void* boost,
                                 int B, int N, int nblk, float half_s, float s,
                                 float e_star, void* stream) {
  if (!dr || !di || !cr || !ci || !out_r || !out_i)
    return (int)cudaErrorInvalidValue;
  Delta a{(const float*)cr, (const float*)ci, nullptr, nullptr, nullptr,
          nullptr, nullptr, nullptr, (const float*)dr, (const float*)di,
          0.f, 0.f, 1, 0, (long long)N};
  Floor f{half_s, s, e_star};
  return launch(a, f, B, nblk, (float*)partials, (float*)boost, 1,
                (float*)out_r, (float*)out_i, (cudaStream_t)stream);
}
