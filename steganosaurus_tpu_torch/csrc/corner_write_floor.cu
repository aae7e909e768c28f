// The embed's dense corner write and its write floor (K3) for Hopper: one
// source, three C entry points.
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
//   spectrum (cr, ci), the int32 slot map pos, the frame bits and, when
//   given, the cos/sin jitter maps (cjd, sjd) and the cos/sin amplitude
//   maps (cad, sad); else the scalar cos/sin of alpha as the host computed
//   them in f32 (no cosf/sinf here). use_floor == 0 writes D itself. The
//   frame is the (B, bucket) u8 bits, or (resident schedule) the stream
//   words of an equal-length Rep-3/Rep-7 frame, each slot's bit computed
//   from its index. The output is D_b as f32 (dr, di), or with bf16 set
//   the inverse DFT's operands (bf16_rn(Re D_b), bf16_rn(-Im D_b)), which
//   is what spectral/corner.py's _mm_bf16 makes of the f32 pair, bit for
//   bit.
// - corner_write_floor_grid: the resident schedule's grid for a corner of
//   N bins on the current card, 0 where it does not fit (see below).
// - corner_floor_only: the floor alone, over a D given as (dr, di) (the QIM
//   write and the per-image-walk scatter, still eager torch); f32 out.
//
// Bound on the H100 (3.35 TB/s) at the main shape, 4K B=64 (Ky = Kx =
// 1024), as the main path calls it: cr, ci read once (1.61 GB), pos int32
// (12.6 MB), the stream words (4.2 MB), the bf16 operands written once
// (0.81 GB): ~2.43e9 bytes, ~0.73 ms (with the u8 frame bits, 59 MB:
// 0.74 ms; f32 out: 0.97-0.98 ms). Bytes bound: a few dozen f32 operations
// per bin against 12 bytes.
//
// Design. The boost b of image n needs the three sums over all of its bins
// before any of its outputs; the sums' order is fixed by N and the block
// size alone (CHUNK-bin chunks, THREADS threads each adding PER_THREAD bins
// k*THREADS apart in order, a warp tree, thread 0 adding the 8 warp sums in
// order; then per image thread t adds chunk partials t, t + THREADS, ... in
// order and the same tree), never by B, the schedule or the mesh shard, so
// every schedule boosts an image alike, bit for bit. Two schedules:
// 1. Resident (the floor, a corner of at most MAX_SLOTS chunks per SM, N a
//    multiple of 4): one cooperative launch, grid sized from the occupancy
//    calculator, each block owning up to MAX_SLOTS chunks of every image,
//    one shared-memory slot each. Per image:
//    - pass 1: the slots' cr and ci have arrived by bulk copies
//      (cp.async.bulk, an mbarrier per slot, L2 evict-first); the block's
//      warps compute D and the partials as warp tasks (the 32 chunk
//      threads of one chunk's warp each: the per-thread sums and the warp
//      tree are the warp's own, so the order above holds however the tasks
//      are spread), each bin's frame bit looked up once and kept with the
//      walk mask as bits in shared memory, the unwalked bins skipped (their
//      terms are exact zeros); one thread per chunk adds its 8 warp sums;
//    - a per-image grid barrier: a counter (the cooperative launch
//      guarantees every block is resident, or it fails and the wrapper
//      raises); meanwhile the next image's stream words load;
//    - every block computes b from the partials in the order above;
//    - the apply pass, slot-major: once half of the slots are done, and
//      again at the end, the finished slots take the next image's bulk
//      copies, which run under the rest of the apply pass and under pass 1
//      (which takes the lower slots first).
//    cr and ci are read from HBM once; D is computed again in the apply
//    pass, from shared memory. The main path's rule (hard write, scalar
//    alpha, no jitter) has its own instantiation with no branch in the
//    write, so the compiler can interleave bins.
// 2. Two-pass (any other corner, or forced): partials (grid of CHUNK-bin
//    blocks x images), boost (one block per image), apply (the grid of 1):
//    cr and ci read twice. A corner too large for the resident schedule
//    also has one image's spectrum above the 50 MB L2, so no image-ordered
//    variant of this keeps the second read on chip.
// Without the floor one launch of the apply pass writes D.
// Every rounding is torch's eager one, op by op: built with -fmad=false,
// and the products and sums written as __fmul_rn / __fadd_rn, so where
// b == 1 the output is the plain version's bit for bit; where b > 1 it
// differs only through the sums' order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int CHUNK = THREADS * PER_THREAD;  // bins of one image per partial
constexpr int WARPS = THREADS / 32;
// resident schedule: warps a block, chunks a block holds
constexpr int R_WARPS = 24;
constexpr int R_THREADS = R_WARPS * 32;
constexpr int MAX_SLOTS = 6;
constexpr int PHASES = 5;                       // phase_ns's columns
// the Rep frame's layout (parallel/batch.py _frame_from_words) and the most
// stream words a block keeps: a 4K corner's whole bucket (921,600 slots)
constexpr int HEADER_BITS = 304, HEADER_REP = 3, PAYLOAD_REP = 7;
constexpr int HEADER_SLOTS = HEADER_BITS * HEADER_REP;
constexpr int STREAM_WORDS_MAX = 4352;
constexpr int BIT_WORDS = CHUNK / 32;           // one bit per bin of a chunk
constexpr int SLOT_BYTES = 2 * CHUNK * 4;       // cr and ci of one chunk
constexpr int MAX_DEVICES = 64;
// L2 policy of the bulk copies (CUTLASS's CacheHintSm90::EVICT_FIRST): the
// spectrum streams through, pos and the frame rows stay
constexpr uint64_t EVICT_FIRST = 0x12F0000000000000ull;

constexpr size_t resident_smem(int slots) {
  return (size_t)slots * SLOT_BYTES + (size_t)slots * 2 * BIT_WORDS * 4 +
         (size_t)slots * 8 + (size_t)slots * WARPS * 3 * 4 + WARPS * 3 * 4 + 16 +
         STREAM_WORDS_MAX * 4;
}
static_assert(resident_smem(MAX_SLOTS) <= 232448, "resident shared memory");
static_assert(R_WARPS >= WARPS && R_WARPS <= 32,
              "the boost takes THREADS threads of a block");

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
  // resident schedule: an equal-length Rep-3/Rep-7 frame as its stream
  // words (B, nwords) int32 (MSB first) in place of `frame`, or null
  const int32_t* words;
  int nwords;
  int nbits;              // stream bits: 8 * stream_bytes
  int nmax;               // frame slots: HEADER_SLOTS + 7 * (nbits - HEADER_BITS)
};

struct Floor {
  float half_s;  // 0.5 * f32(1/img_pixels)
  float s;       // f32(1/img_pixels)
  float e_star;  // f32(1.5 * floor^2)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The write rules a resident kernel is built for: RULE_ANY reads the rule
// (soft, jitter, amplitude maps) from Delta at run time; RULE_HARD is the
// main path's hard write with a scalar alpha and no jitter, with no branch
// in the write for the compiler to schedule around.
constexpr int RULE_ANY = 0, RULE_HARD = 1;

// |C| as write_delta floors it: max(sqrt(r^2 + m^2), 1e-12).
__device__ __forceinline__ float magnitude(float r, float m) {
  return fmaxf(__fsqrt_rn(add(mul(r, r), mul(m, m))), 1e-12f);
}

// write_delta for bin i with the rule read from Delta (soft, jitter,
// amplitude maps), given its magnitude; m2 = 2 at a walk bin, else 0.
__device__ __forceinline__ void write_any(const Delta& a, long long i,
                                          float r, float m, float mag,
                                          float sign, float m2, float& dr,
                                          float& di) {
  const float ca = a.cad ? a.cad[i] : a.ca;
  const float sa = a.sad ? a.sad[i] : a.sa;
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

// write_delta for bin i, from its spectrum value (r, m) and its magnitude,
// its frame bit as a sign (+-1; the sentinel slot reads bit 0) and whether
// a walk bin lives there.
template <int kRule>
__device__ __forceinline__ void write_from_mag(const Delta& a, long long i,
                                               float r, float m, float mag,
                                               float sign, bool in, float& dr,
                                               float& di) {
  const float m2 = in ? 2.f : 0.f;
  if constexpr (kRule == RULE_HARD) {
    dr = mul(m2, sub(mul(mag, a.ca), r));
    di = mul(m2, sub(mul(mag, sign * a.sa), m));
  } else {
    write_any(a, i, r, m, mag, sign, m2, dr, di);
  }
}

__device__ __forceinline__ void write_bin(const Delta& a, long long i, float r,
                                          float m, float sign, bool in,
                                          float& dr, float& di) {
  write_from_mag<RULE_ANY>(a, i, r, m, magnitude(r, m), sign, in, dr, di);
}

// write_delta for bin i of image b, the bit looked up here; or the given
// delta (floor only).
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
  const float sign = (in && a.frame[(long long)b * a.bucket + p]) ? 1.f : -1.f;
  write_bin(a, i, r, m, sign, in, dr, di);
}

// One bin's three terms of the floor's sums, added in order.
__device__ __forceinline__ void add_terms(const Floor& f, float r, float m,
                                          float dr, float di, float& v,
                                          float& x, float& h) {
  const float hr = mul(f.half_s, dr), hi = mul(f.half_s, di);
  const float hh = add(mul(hr, hr), mul(hi, hi));
  const float wm = hh > 0.f ? 1.f : 0.f;
  const float rs = mul(r, f.s), is = mul(m, f.s);
  v = add(v, mul(wm, add(mul(rs, rs), mul(is, is))));
  x = add(x, add(mul(rs, hr), mul(is, hi)));
  h = add(h, hh);
}

// D_b = b*D + 2(b-1)*wm*C for one bin; q = 2(b-1).
__device__ __forceinline__ void boosted(const Floor& f, float bb, float q,
                                        float r, float m, float& dr,
                                        float& di) {
  const float hr = mul(f.half_s, dr), hi = mul(f.half_s, di);
  const float wm = add(mul(hr, hr), mul(hi, hi)) > 0.f ? 1.f : 0.f;
  const float qw = mul(q, wm);
  dr = add(mul(bb, dr), mul(qw, r));
  di = add(mul(bb, di), mul(qw, m));
}

// b from the closed form, in f32 as apply_write_floor writes it.
__device__ __forceinline__ float boost_from(float V, float X, float Hs,
                                            const Floor& f) {
  const float vx = add(V, X);
  const float pp = add(add(V, mul(2.f, X)), Hs);
  float disc = sub(mul(vx, vx), mul(pp, sub(V, f.e_star)));
  disc = fmaxf(disc, 0.f);
  const float bb = __fdiv_rn(add(vx, __fsqrt_rn(disc)), fmaxf(pp, 1e-30f));
  return fminf(fmaxf(bb, 1.f), 32.f);
}

// The output of one bin: f32 (dr, di), or the inverse DFT's bf16 operands
// (Re D, -Im D).
__device__ __forceinline__ void store(float* o_r, float* o_i, long long off,
                                      float dr, float di) {
  o_r[off] = dr;
  o_i[off] = di;
}
__device__ __forceinline__ void store(__nv_bfloat16* o_r, __nv_bfloat16* o_i,
                                      long long off, float dr, float di) {
  o_r[off] = __float2bfloat16_rn(dr);
  o_i[off] = __float2bfloat16_rn(-di);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four consecutive outputs (off a multiple of 4), streaming stores.
__device__ __forceinline__ void store4(float* o_r, float* o_i, long long off,
                                       const float* dr, const float* di) {
  __stcs(reinterpret_cast<float4*>(o_r + off),
         make_float4(dr[0], dr[1], dr[2], dr[3]));
  __stcs(reinterpret_cast<float4*>(o_i + off),
         make_float4(di[0], di[1], di[2], di[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* o_r, __nv_bfloat16* o_i,
                                       long long off, const float* dr,
                                       const float* di) {
  __stcs(reinterpret_cast<uint2*>(o_r + off),
         make_uint2(bf16x2(dr[0], dr[1]), bf16x2(dr[2], dr[3])));
  __stcs(reinterpret_cast<uint2*>(o_i + off),
         make_uint2(bf16x2(-di[0], -di[1]), bf16x2(-di[2], -di[3])));
}

// Barrier `id` over the THREADS threads of a group (id 0 in a block of
// THREADS threads is __syncthreads).
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

// Sums of v, x and h over a group of THREADS threads, each in a fixed
// order: a warp tree (__shfl_down_sync 16, 8, 4, 2, 1), then the group's
// thread 0 adds the WARPS warp sums in order; the results in that thread.
// sh: 3 * WARPS floats.
__device__ __forceinline__ void group_sum3(float& v, float& x, float& h,
                                           float* sh, int bar) {
  for (int o = 16; o > 0; o >>= 1) {
    v = add(v, __shfl_down_sync(0xffffffffu, v, o));
    x = add(x, __shfl_down_sync(0xffffffffu, x, o));
    h = add(h, __shfl_down_sync(0xffffffffu, h, o));
  }
  const int t = threadIdx.x & (THREADS - 1);
  const int lane = t & 31, warp = t >> 5;
  group_sync(bar);  // sh may still be read by an earlier call
  if (lane == 0) {
    sh[3 * warp] = v;
    sh[3 * warp + 1] = x;
    sh[3 * warp + 2] = h;
  }
  group_sync(bar);
  if (t == 0) {
    v = sh[0];
    x = sh[1];
    h = sh[2];
    for (int w = 1; w < WARPS; ++w) {
      v = add(v, sh[3 * w]);
      x = add(x, sh[3 * w + 1]);
      h = add(h, sh[3 * w + 2]);
    }
  }
}

// The boost of one image from its nblk chunk partials p (nblk, 3), by one
// group; the result in the group's thread 0. The partials are read through
// L2 (another SM may have written them in this launch).
__device__ __forceinline__ float image_boost(const float* p, int nblk,
                                             const Floor& f, float* sh,
                                             int bar) {
  float v = 0.f, x = 0.f, h = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x & (THREADS - 1); k < nblk; k += THREADS) {
    v = add(v, __ldcg(p + 3 * k));
    x = add(x, __ldcg(p + 3 * k + 1));
    h = add(h, __ldcg(p + 3 * k + 2));
  }
  group_sum3(v, x, h, sh, bar);
  return boost_from(v, x, h, f);
}

// --- two-pass schedule (and the floor-less single pass) ----------------------

__global__ void __launch_bounds__(THREADS)
partials_kernel(Delta a, Floor f, float* partials) {
  __shared__ float sh[3 * WARPS];
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
    add_terms(f, r, m, dr, di, v, x, h);
  }
  group_sum3(v, x, h, sh, 0);
  if (threadIdx.x == 0) {
    float* out = partials + ((long long)b * gridDim.x + blockIdx.x) * 3;
    out[0] = v;
    out[1] = x;
    out[2] = h;
  }
}

__global__ void __launch_bounds__(THREADS)
boost_kernel(const float* partials, int nblk, Floor f, float* boost) {
  __shared__ float sh[3 * WARPS];
  const float bb = image_boost(partials + (long long)blockIdx.x * nblk * 3,
                               nblk, f, sh, 0);
  if (threadIdx.x == 0) boost[blockIdx.x] = bb;
}

template <typename Out>
__global__ void __launch_bounds__(THREADS)
apply_kernel(Delta a, Floor f, const float* boost, int use_floor, Out* out_r,
             Out* out_i) {
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
    if (use_floor) boosted(f, bb, q, r, m, dr, di);
    store(out_r, out_i, img + i, dr, di);
  }
}

template <typename Out>
int launch_two_pass(const Delta& a, const Floor& f, int B, int nblk,
                    float* partials, float* boost, int use_floor, Out* out_r,
                    Out* out_i, cudaStream_t st) {
  if (nblk > 65535 * 64 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(nblk, B);
  if (use_floor) {
    if (!partials || !boost) return (int)cudaErrorInvalidValue;
    partials_kernel<<<grid, THREADS, 0, st>>>(a, f, partials);
    boost_kernel<<<B, THREADS, 0, st>>>(partials, nblk, f, boost);
  }
  apply_kernel<Out><<<grid, THREADS, 0, st>>>(a, f, boost, use_floor, out_r,
                                              out_i);
  return (int)cudaGetLastError();
}

// --- resident schedule -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)),
      "l"(EVICT_FIRST)
      : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Bins [c*CHUNK, c*CHUNK + len) of image n's cr and ci into a slot.
__device__ __forceinline__ void load_chunk(const Delta& a, int n, int c,
                                           float* slot, uint64_t* bar) {
  const long long base = (long long)n * a.N + (long long)c * CHUNK;
  const uint32_t bytes =
      (uint32_t)min((long long)CHUNK, a.N - (long long)c * CHUNK) * 4u;
  mbar_expect_tx(bar, 2u * bytes);
  bulk_load(slot, a.cr + base, bytes, bar);
  bulk_load(slot + CHUNK, a.ci + base, bytes, bar);
}

// Frame bit of walk slot p (< bucket) from the stream words sw of its
// image, as _frame_from_words lays the frame out: Rep-3 header slots, Rep-7
// payload slots, the last bit repeated past nmax.
__device__ __forceinline__ uint32_t stream_bit(const Delta& a,
                                               const uint32_t* sw, int p) {
  const int i = p < HEADER_SLOTS ? p / HEADER_REP
                : p < a.nmax     ? HEADER_BITS + (p - HEADER_SLOTS) / PAYLOAD_REP
                                 : a.nbits - 1;
  return (sw[i >> 5] >> (31 - (i & 31))) & 1u;
}

// Pass 1 of image n for the lanes of warp w of chunk c, from the slot: the
// chunk thread t = 32*w + lane's sums over its bins t + j*THREADS in order
// of j (the order above), then the warp tree; the warp's three sums into
// out3. Each bin's frame bit is looked up once and kept, with the walk
// mask, in `bits` (the bit from the frame row, or from the stream words sw
// of a Rep frame). Only walk bins are added: an unwalked bin's D is +-0,
// so its terms are +0 (V, Hs) and +-0 (X), and adding them leaves every
// sum's bits as they are (no sum is ever -0); each lane steps through its
// own walk bins, in order.
template <int kRule>
__device__ __forceinline__ void warp_partials(const Delta& a, const Floor& f,
                                              int n, int c, int w,
                                              const float* slot,
                                              const uint32_t* sw,
                                              uint32_t* bits, float* out3) {
  const int lane = threadIdx.x & 31;
  const int t = w * 32 + lane;
  const long long base = (long long)c * CHUNK;
  const int len = (int)min((long long)CHUNK, a.N - base);
  int p[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int k = j * THREADS + t;
    p[j] = k < len ? __ldg(a.pos + base + k) : a.bucket;
  }
  uint32_t ins = 0, ones = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    if (p[j] < a.bucket) ins |= 1u << j;
  if (a.words) {  // a Rep frame's bits, from the stream words
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (p[j] < a.bucket) ones |= stream_bit(a, sw, p[j]) << j;
  } else {  // the frame row's bits, gathered all at once
    const uint8_t* row = a.frame + (long long)n * a.bucket;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (p[j] < a.bucket && __ldg(row + p[j])) ones |= 1u << j;
  }
  float v = 0.f, x = 0.f, h = 0.f;
  for (uint32_t todo = ins; todo; todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const int k = j * THREADS + t;
    const float r = slot[k], m = slot[CHUNK + k];
    float dr, di;
    write_from_mag<kRule>(a, base + k, r, m, magnitude(r, m),
                          (ones >> j) & 1u ? 1.f : -1.f, true, dr, di);
    add_terms(f, r, m, dr, di, v, x, h);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const uint32_t w_one = __ballot_sync(0xffffffffu, (ones >> j) & 1u);
    const uint32_t w_in = __ballot_sync(0xffffffffu, (ins >> j) & 1u);
    if (lane == 0) {
      bits[j * WARPS + w] = w_one;
      bits[BIT_WORDS + j * WARPS + w] = w_in;
    }
  }
  __syncwarp();
  for (int o = 16; o > 0; o >>= 1) {
    v = add(v, __shfl_down_sync(0xffffffffu, v, o));
    x = add(x, __shfl_down_sync(0xffffffffu, x, o));
    h = add(h, __shfl_down_sync(0xffffffffu, h, o));
  }
  if (lane == 0) {
    out3[0] = v;
    out3[1] = x;
    out3[2] = h;
  }
}

// The boosted outputs of bins k .. k + 3 (k a multiple of 4) of chunk c of
// image n, from the slot and its bits.
template <int kRule, typename Out>
__device__ __forceinline__ void apply_quad(const Delta& a, const Floor& f,
                                           int n, int c, int k, float bb,
                                           float q, const float* slot,
                                           const uint32_t* bits, Out* out_r,
                                           Out* out_i) {
  const long long base = (long long)c * CHUNK;
  if (k >= a.N - base) return;
  const float4 r4 = *reinterpret_cast<const float4*>(slot + k);
  const float4 m4 = *reinterpret_cast<const float4*>(slot + CHUNK + k);
  const float r[4] = {r4.x, r4.y, r4.z, r4.w};
  const float m[4] = {m4.x, m4.y, m4.z, m4.w};
  const uint32_t ones = bits[k >> 5] >> (k & 31);
  const uint32_t ins = bits[BIT_WORDS + (k >> 5)] >> (k & 31);
  float mag[4], dr[4], di[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) mag[e] = magnitude(r[e], m[e]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    write_from_mag<kRule>(a, base + k + e, r[e], m[e], mag[e],
                          (ones >> e) & 1u ? 1.f : -1.f, (ins >> e) & 1u,
                          dr[e], di[e]);
    boosted(f, bb, q, r[e], m[e], dr[e], di[e]);
  }
  store4(out_r, out_i, (long long)n * a.N + base + k, dr, di);
}

// A block's share of image n's stream words (a Rep frame only): thread i
// holds words i, i + R_THREADS, ... in registers (loaded before the grid
// barrier, stored into the block's buffer after it).
constexpr int WORDS_PER_THREAD = (STREAM_WORDS_MAX + R_THREADS - 1) / R_THREADS;

__device__ __forceinline__ void load_words(const Delta& a, int n,
                                           uint32_t (&reg)[WORDS_PER_THREAD]) {
  if (!a.words) return;
  const int32_t* row = a.words + (long long)n * a.nwords;
#pragma unroll
  for (int r = 0; r < WORDS_PER_THREAD; ++r) {
    const int i = threadIdx.x + r * R_THREADS;
    if (i < a.nwords) reg[r] = (uint32_t)__ldg(row + i);
  }
}

__device__ __forceinline__ void store_words(const Delta& a, uint32_t* sw,
                                            const uint32_t (&reg)[WORDS_PER_THREAD]) {
  if (!a.words) return;
#pragma unroll
  for (int r = 0; r < WORDS_PER_THREAD; ++r) {
    const int i = threadIdx.x + r * R_THREADS;
    if (i < a.nwords) sw[i] = reg[r];
  }
}

// The resident schedule: block j owns chunks [j*slots, j*slots + slots) of
// every image (fewer in the last block), one shared-memory slot each. Pass
// 1 runs as warp tasks (slot s, warp w) spread over the block's warps, the
// lower slots first. The apply pass takes the block's quads slot-major,
// R_THREADS a round; the slots it has finished take their next image's
// bulk copies when half of them are done, and at the end, so those copies
// run under the rest of the apply pass and pass 1 takes the lower slots
// first. phase_ns (grid, PHASES) or null: each block's ns by thread 0's
// clock in pass 1 waiting for its data, the rest of pass 1, the grid
// barrier, the boost and the apply pass, summed over the images.
template <typename Out, int kRule>
__global__ void __launch_bounds__(R_THREADS, 1)
resident_kernel(Delta a, Floor f, int B, int nblk, int slots,
                float* partials, float* boost, unsigned* arrive,
                unsigned long long* phase_ns, Out* out_r, Out* out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* data = reinterpret_cast<float*>(smem);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + (size_t)slots * SLOT_BYTES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bits + slots * 2 * BIT_WORDS);
  float* wsum = reinterpret_cast<float*>(bar + slots);  // (slots, WARPS, 3)
  float* sh = wsum + slots * WARPS * 3;                 // (WARPS, 3)
  float* sb = sh + 3 * WARPS;                           // this image's boost
  uint32_t* sw = reinterpret_cast<uint32_t*>(sb + 4);   // its stream words
  const int c0 = blockIdx.x * slots;
  const int ns = min(slots, nblk - c0);
  const int quads = ns * (CHUNK / 4);
  const int warp = threadIdx.x >> 5;
  const unsigned grid = gridDim.x;
  const bool timed = phase_ns != nullptr && threadIdx.x == 0;
  unsigned long long ph[PHASES] = {}, t_mark = timed ? globaltimer() : 0;
  auto mark = [&](int k) {  // the time since the last mark, to phase k
    if (timed) {
      const unsigned long long t = globaltimer();
      ph[k] += t - t_mark;
      t_mark = t;
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < ns; ++s)
      load_chunk(a, 0, c0 + s, data + (size_t)s * 2 * CHUNK, &bar[s]);
  }
  uint32_t wreg[WORDS_PER_THREAD];
  load_words(a, 0, wreg);
  store_words(a, sw, wreg);
  __syncthreads();

  for (int n = 0; n < B; ++n) {
    for (int task = warp; task < ns * WARPS; task += R_WARPS) {
      const int s = task / WARPS, w = task % WARPS;
      mark(1);
      mbar_wait(&bar[s], n & 1);
      mark(0);
      warp_partials<kRule>(a, f, n, c0 + s, w, data + (size_t)s * 2 * CHUNK,
                           sw, bits + s * 2 * BIT_WORDS, wsum + task * 3);
    }
    __syncthreads();
    float* part = partials + (long long)n * nblk * 3;
    if (threadIdx.x < ns) {  // the chunk's partials: the 8 warp sums in order
      const float* ws = wsum + threadIdx.x * WARPS * 3;
      float v = ws[0], x = ws[1], h = ws[2];
      for (int w = 1; w < WARPS; ++w) {
        v = add(v, ws[3 * w]);
        x = add(x, ws[3 * w + 1]);
        h = add(h, ws[3 * w + 2]);
      }
      float* out = part + 3 * (c0 + threadIdx.x);
      out[0] = v;
      out[1] = x;
      out[2] = h;
    }
    // the next image's stream words come in while the block waits at the
    // barrier; they replace this image's once pass 1 is done with them
    if (n + 1 < B) load_words(a, n + 1, wreg);
    __syncthreads();
    if (threadIdx.x == 0) {  // every block's partials of image n written
      mark(1);
      __threadfence();
      atomicAdd(arrive, 1u);
      const unsigned target = (unsigned)(n + 1) * grid;
      while (*reinterpret_cast<volatile unsigned*>(arrive) < target) {
      }
      __threadfence();
      mark(2);
    }
    if (n + 1 < B) store_words(a, sw, wreg);
    __syncthreads();
    if (threadIdx.x < THREADS) {
      const float bb = image_boost(part, nblk, f, sh, 1);
      if (threadIdx.x == 0) {
        *sb = bb;
        if (blockIdx.x == 0) boost[n] = bb;
      }
    }
    __syncthreads();
    mark(3);
    const float bb = *sb;
    const float q = mul(2.f, sub(bb, 1.f));
    int released = 0;
    for (int q0 = 0; q0 < quads; q0 += R_THREADS) {
      const int qd = q0 + threadIdx.x;
      if (qd < quads) {
        const int s = qd / (CHUNK / 4);
        apply_quad<kRule>(a, f, n, c0 + s, 4 * (qd % (CHUNK / 4)), bb, q,
                   data + (size_t)s * 2 * CHUNK, bits + s * 2 * BIT_WORDS,
                   out_r, out_i);
      }
      // the slots done so far take their next image's copies at the first
      // round that finishes half of them, and at the last
      const int done = min(ns, (q0 + R_THREADS) / (CHUNK / 4));
      if (n + 1 < B && done > released &&
          ((2 * done >= ns && 2 * released < ns) || done == ns)) {
        __syncthreads();  // the block is done with slots [released, done)
        if (threadIdx.x == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          for (int s = released; s < done; ++s)
            load_chunk(a, n + 1, c0 + s, data + (size_t)s * 2 * CHUNK, &bar[s]);
        }
        released = done;
      }
    }
    mark(4);
  }
  if (timed)
    for (int k = 0; k < PHASES; ++k) phase_ns[PHASES * blockIdx.x + k] += ph[k];
}

// Blocks per SM of the resident kernels at each slot count, per card: the
// fewer of the two rules' (so both run on the same grid).
struct Occupancy {
  int sms = 0;
  int per_sm[2][MAX_SLOTS + 1];
};
Occupancy g_occ[MAX_DEVICES];

template <typename Out>
int resident_occupancy(int slots, int* per_sm) {
  int any = 0, hard = 0;
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &any, resident_kernel<Out, RULE_ANY>, R_THREADS, resident_smem(slots));
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &hard, resident_kernel<Out, RULE_HARD>, R_THREADS,
        resident_smem(slots));
  *per_sm = any < hard ? any : hard;
  return err;
}

template <typename Out>
int allow_smem() {
  const int bytes = (int)resident_smem(MAX_SLOTS);
  int err = (int)cudaFuncSetAttribute(resident_kernel<Out, RULE_ANY>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      bytes);
  if (!err)
    err = (int)cudaFuncSetAttribute(resident_kernel<Out, RULE_HARD>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    bytes);
  return err;
}

// (grid, slots) of the resident schedule for nblk chunks on the current
// card: the fewest slots a block whose grid fits at once. grid 0 where no
// slot count up to MAX_SLOTS fits; a CUDA error as a negative value.
int resident_plan(int nblk, int bf16, int* slots) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return -err;
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  Occupancy& o = g_occ[dev];
  if (o.sms == 0) {
    int sms = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int coop = 0;
    if (!err)
      err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!err) err = allow_smem<float>();
    if (!err) err = allow_smem<__nv_bfloat16>();
    for (int s = 1; s <= MAX_SLOTS && !err; ++s) {
      err = resident_occupancy<float>(s, &o.per_sm[0][s]);
      if (!err) err = resident_occupancy<__nv_bfloat16>(s, &o.per_sm[1][s]);
    }
    if (err) return -err;
    if (!coop) sms = -1;
    o.sms = sms;
  }
  if (o.sms < 0) return 0;
  for (int s = 1; s <= MAX_SLOTS; ++s) {
    const int grid = (nblk + s - 1) / s;
    if (grid <= o.sms * o.per_sm[bf16 ? 1 : 0][s]) {
      *slots = s;
      return grid;
    }
  }
  return 0;
}

template <typename Out>
int launch_resident(const Delta& a0, const Floor& f0, int B, int nblk,
                    float* partials, float* boost, unsigned* arrive,
                    unsigned long long* phase_ns, Out* out_r, Out* out_i,
                    cudaStream_t st) {
  int slots = 0;
  const int grid = resident_plan(nblk, sizeof(Out) == 2, &slots);
  if (grid < 0) return -grid;
  if (grid == 0 || !partials || !boost || !arrive || a0.N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Delta a = a0;
  Floor f = f0;
  void* args[] = {&a, &f, &B, &nblk, &slots, &partials, &boost, &arrive,
                  &phase_ns, &out_r, &out_i};
  const bool hard = !a.soft && !a.cjd && !a.cad;
  void* kernel = hard ? (void*)resident_kernel<Out, RULE_HARD>
                      : (void*)resident_kernel<Out, RULE_ANY>;
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(R_THREADS),
                                          args, resident_smem(slots), st);
}

template <typename Out>
int launch(const Delta& a, const Floor& f, int B, int nblk, float* partials,
           float* boost, unsigned* arrive, unsigned long long* phase_ns,
           int use_floor, int resident, void* out_r, void* out_i,
           cudaStream_t st) {
  Out* o_r = static_cast<Out*>(out_r);
  Out* o_i = static_cast<Out*>(out_i);
  if (use_floor && resident)
    return launch_resident<Out>(a, f, B, nblk, partials, boost, arrive,
                                phase_ns,
                                o_r, o_i, st);
  return launch_two_pass<Out>(a, f, B, nblk, partials, boost, use_floor, o_r,
                              o_i, st);
}

}  // namespace

// The resident schedule's grid for a corner of N bins (B any) on the current
// card with f32 (bf16 == 0) or bf16 outputs: > 0 where it fits, 0 where it
// does not (the wrapper then takes the two-pass schedule), a negative CUDA
// error code on failure.
extern "C" int corner_write_floor_grid(int N, int bf16) {
  if (N <= 0) return 0;
  int slots = 0;
  return resident_plan((N + CHUNK - 1) / CHUNK, bf16, &slots);
}

// The write (hard or soft; jitter and amplitude maps optional) and, with
// use_floor, the write floor. cr, ci: (B, N) f32; out_r, out_i: (B, N) f32,
// or with bf16 the inverse DFT's operands (Re D_b, -Im D_b) in bf16; pos
// (N,) int32; frame (B, bucket) u8, or (resident schedule with the floor
// only) words (B, nwords) int32, the stream words of an equal-length
// Rep-3/Rep-7 frame of stream_bytes bytes; maps (N,) f32 or null; partials (B,
// nblk, 3) and boost (B,) f32 scratch (unused without the floor); with
// resident (and the floor) the resident schedule, arrive a zeroed u32 and
// phase_ns null or (grid, 5) zeroed u64 that gets each block's ns in its
// phases (see resident_kernel); else the two-pass schedule. nblk must be ceil(N / 4096).
// Returns the launch's CUDA error (0 on success).
extern "C" int corner_write_floor(const void* cr, const void* ci,
                                  const void* pos, const void* frame,
                                  const void* words, const void* cjd,
                                  const void* sjd, const void* cad,
                                  const void* sad, void* out_r, void* out_i,
                                  void* partials, void* boost, void* arrive,
                                  void* phase_ns, int B, int N, int nblk,
                                  int bucket, int nwords, int stream_bytes,
                                  float cos_a, float sin_a, int soft,
                                  float half_s, float s, float e_star,
                                  int use_floor, int bf16, int resident,
                                  void* stream) {
  const int nbits = 8 * stream_bytes;
  const int nmax = HEADER_SLOTS + PAYLOAD_REP * (nbits - HEADER_BITS);
  if (!cr || !ci || !pos || !out_r || !out_i || bucket <= 0 || B <= 0 ||
      N <= 0 || nblk != (N + CHUNK - 1) / CHUNK ||
      (cjd == nullptr) != (sjd == nullptr) || (cad == nullptr) != (sad == nullptr) ||
      (frame == nullptr) == (words == nullptr) ||
      (words && (!resident || !use_floor || nwords <= 0 ||
                 nwords > STREAM_WORDS_MAX || nbits <= HEADER_BITS ||
                 nbits > 32 * nwords || nmax > bucket)))
    return (int)cudaErrorInvalidValue;
  Delta a{(const float*)cr, (const float*)ci, (const int32_t*)pos,
          (const uint8_t*)frame, (const float*)cjd, (const float*)sjd,
          (const float*)cad, (const float*)sad, nullptr, nullptr,
          cos_a, sin_a, bucket, soft, (long long)N,
          (const int32_t*)words, nwords, nbits, nmax};
  Floor f{half_s, s, e_star};
  cudaStream_t st = (cudaStream_t)stream;
  float* p = (float*)partials;
  float* b = (float*)boost;
  unsigned* arr = (unsigned*)arrive;
  unsigned long long* w = (unsigned long long*)phase_ns;
  return bf16 ? launch<__nv_bfloat16>(a, f, B, nblk, p, b, arr, w, use_floor,
                                      resident, out_r, out_i, st)
              : launch<float>(a, f, B, nblk, p, b, arr, w, use_floor,
                              resident, out_r, out_i, st);
}

// The write floor over a given delta (dr, di): (B, N) f32 each, beside the
// spectrum (cr, ci); the rest as corner_write_floor's two-pass schedule.
extern "C" int corner_floor_only(const void* dr, const void* di,
                                 const void* cr, const void* ci, void* out_r,
                                 void* out_i, void* partials, void* boost,
                                 int B, int N, int nblk, float half_s, float s,
                                 float e_star, void* stream) {
  if (!dr || !di || !cr || !ci || !out_r || !out_i || B <= 0 || N <= 0 ||
      nblk != (N + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  Delta a{(const float*)cr, (const float*)ci, nullptr, nullptr, nullptr,
          nullptr, nullptr, nullptr, (const float*)dr, (const float*)di,
          0.f, 0.f, 1, 0, (long long)N, nullptr, 0, 0, 0};
  Floor f{half_s, s, e_star};
  return launch_two_pass<float>(a, f, B, nblk, (float*)partials, (float*)boost,
                                1, (float*)out_r, (float*)out_i,
                                (cudaStream_t)stream);
}
