// The extract's walk read and repetition decode (K5) for Hopper: from the
// forward corner spectrum to the decoded words, in one pass.
//
// Replaces what XLA fuses for the TPU after the forward DFT in
// steganosaurus_tpu/parallel/batch.py:corner_extract_fused_core (:738), its
// soft-retry twin corner_soft_extract_core (:878) and the channel report's
// corner_bits_core + corner_gather_raw_core: the phase read at the walk
// bins, spectral/corner.py read_bits_dense, then _decode_sections and
// _decode_sections_soft (:238-260). There is no TPU kernel to translate:
// eager torch ran this stage as some twenty launches (a gather, the
// decision values, eight reductions, a dozen copies), each a pass through
// HBM. For image b and walk slot s at corner bin (plane, y, x):
//
//     d = (ci * cjd[s] - cr * sjd[s]) * ssa,  or  d = ci * ssa
//
// (ssa = sign(sin alpha), a multiply, never a branch), each product and the
// difference rounded as torch's eager ops round them (built with
// -fmad=false). Hard bit: d >= 0 (a value compare, so -0.0 reads 1). The
// header's groups of 3 slots take a majority (>= 2 of 3), the payload's
// groups of 7 (>= 4 of 7), or under the RS wire (rep 1) the raw bits; a
// trailing partial group is dropped; each section is packed MSB first into
// int32 words, its last word zero-padded: a row [header words | payload
// words]. The soft row sums each group's values left to right in f32 (the
// fused pass first rounds each d to bf16, round to nearest even, and back)
// and reads sum >= 0; under the RS wire it holds the payload's sign bits,
// then each coded byte's confidence, min |d| over its 8 bits (NaN
// propagates, as torch.amin does), as f32 bits.
//
// Bound on the H100 (3.35 TB/s) at the main shape, 4K B=64 (Ky = Kx =
// 1024, a 921,600-slot walk): the gather reads whole 32-byte sectors. The
// main path's walk touches 66.5% of the Im plane's sectors (it stays in a
// quarter disc of the corner): ~535 MB over the batch, with the walk (22
// MB) and the words (2 MB): ~0.17 ms, bound by its bytes. A uniform walk of
// the same length would touch 1 - (1 - 0.293)^8 = 94% (utils/cost.py's
// model of the stage): ~0.23 ms.
//
// Design: a gather, not a GEMM. One warp makes one output word, one lane
// one group: the lane computes its slots' corner offsets once, from the
// walk's int64 plane/y/x, and keeps them (and the jitter's cos and sin) in
// registers for the whole batch. A block holds WARPS consecutive words of
// one section (the header's words a block of their own) and loops over the
// images; grid.y interleaves the batch in groups, as many as give the card
// about two blocks an SM (read_kernels.GRID_FILL), so the grid moves
// through the batch in step and the planes of the few images in flight
// (12.6 MB each at 4K) stay in the 50 MB L2. A lane issues its loads for
// U images before it decodes any (U = 1 for a Rep-7 group's seven slots, 2
// for a header group's three, 4 for an RS slot). The gather's loads are
// cached in L2 only (L2_ONLY): L1 holds few repeats of a random walk.
// __ballot_sync then __brev gives the word MSB first; lane 0 stores it.
// What bounds it on the card is the SMs' rate of scattered 32-byte sector
// requests (about one every two cycles an SM, measured with the whole
// batch in L2: 0.46 ms at 4K B=64) and the random sectors' HBM reads
// (tools/k5_ablation_torch.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 32;
constexpr int THREADS = WARPS * 32;
constexpr bool L2_ONLY = true;  // the gather's loads bypass L1
constexpr int HEADER_REP = 3;

struct Args {
  const float* ci;
  const float* cr;         // under jitter only
  const long long* plane;  // (n,) walk
  const long long* y;
  const long long* x;
  const float* cjd;        // (n,) cos / sin of the slots' jitter angles
  const float* sjd;
  int* hard;               // (B, hard_cols) or null
  int* soft;               // (B, soft_cols) or null
  long long img_stride;    // 3 * Ky * Kx
  int Ky, Kx, B;
  int hdr, rep, soft_mode;  // soft_mode: 0 none, 1 bf16 values, 2 f32
  int hdr_words, hdr_blocks, pay_groups, pay_words;
  int hard_cols, soft_cols;
  float ssa;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// min that propagates NaN from either side, as torch.amin does
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float gather(const float* p) {
  return L2_ONLY ? __ldcg(p) : __ldg(p);
}

// One warp's word `word` of a section whose groups of REP slots start at
// slot `slot0`, `groups` of them; its hard word goes to column col0 + word,
// its soft word too, and (REP == 1 with soft values) its confidences to
// columns conf0 + group / 8.
template <int REP, int U, bool JIT>
__device__ __forceinline__ void section(const Args& a, int word, int slot0,
                                        int groups, int col0, int conf0) {
  const int lane = threadIdx.x & 31;
  const int g = word * 32 + lane;
  const bool valid = g < groups;
  int off[REP];
  float cj[REP], sj[REP];
#pragma unroll
  for (int k = 0; k < REP; ++k) {
    off[k] = 0;
    cj[k] = 1.f;
    sj[k] = 0.f;
    if (valid) {
      const long long s = (long long)slot0 + (long long)g * REP + k;
      off[k] = (int)((a.plane[s] * a.Ky + a.y[s]) * a.Kx + a.x[s]);
      if (JIT) {
        cj[k] = a.cjd[s];
        sj[k] = a.sjd[s];
      }
    }
  }
  const int step = gridDim.y;
  for (int b0 = blockIdx.y; b0 < a.B; b0 += U * step) {
    float vi[U][REP], vr[U][REP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = b0 + u * step;
      if (b < a.B) {
        const long long base = (long long)b * a.img_stride;
#pragma unroll
        for (int k = 0; k < REP; ++k) {
          vi[u][k] = gather(a.ci + base + off[k]);
          if (JIT) vr[u][k] = gather(a.cr + base + off[k]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = b0 + u * step;
      if (b >= a.B) break;  // the same b for every lane of the block
      float d[REP];
      int ones = 0;
#pragma unroll
      for (int k = 0; k < REP; ++k) {
        float v = vi[u][k];
        if (JIT) v = __fsub_rn(__fmul_rn(v, cj[k]), __fmul_rn(vr[u][k], sj[k]));
        d[k] = __fmul_rn(v, a.ssa);
        ones += d[k] >= 0.f;
      }
      if (a.hard) {
        const unsigned bits = __ballot_sync(0xffffffffu,
                                            valid && 2 * ones >= REP + 1);
        if (lane == 0)
          a.hard[(long long)b * a.hard_cols + col0 + word] = (int)__brev(bits);
      }
      if (a.soft_mode) {
        float sum = 0.f, conf = 0.f;
#pragma unroll
        for (int k = 0; k < REP; ++k) {
          const float v = a.soft_mode == 1 ? bf16_round(d[k]) : d[k];
          sum = k ? __fadd_rn(sum, v) : v;
          conf = fabsf(v);
        }
        const unsigned bits = __ballot_sync(0xffffffffu, valid && sum >= 0.f);
        int* row = a.soft + (long long)b * a.soft_cols;
        if (lane == 0) row[col0 + word] = (int)__brev(bits);
        if (REP == 1 && conf0 >= 0) {
          // groups == payload slots, a multiple of 8: the 8 lanes of a
          // coded byte are all valid or all not
#pragma unroll
          for (int m = 1; m < 8; m <<= 1)
            conf = min_nan(conf, __shfl_xor_sync(0xffffffffu, conf, m));
          if (valid && (lane & 7) == 0) row[conf0 + g / 8] = __float_as_int(conf);
        }
      }
    }
  }
}

template <bool JIT>
__global__ void __launch_bounds__(THREADS)
corner_read_decode_kernel(const Args a) {
  const int warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < a.hdr_blocks) {
    const int word = blockIdx.x * WARPS + warp;
    if (word < a.hdr_words)
      section<HEADER_REP, 2, JIT>(a, word, 0, a.hdr / HEADER_REP, 0, -1);
    return;
  }
  const int word = (blockIdx.x - a.hdr_blocks) * WARPS + warp;
  if (word >= a.pay_words) return;
  if (a.rep == 7)
    section<7, 1, JIT>(a, word, a.hdr, a.pay_groups, a.hdr_words, -1);
  else
    section<1, 4, JIT>(a, word, a.hdr, a.pay_groups, a.hdr_words,
                       a.soft_mode ? a.hdr_words + a.pay_words : -1);
}

}  // namespace

// ci (and cr under jitter): (B, 3, Ky, Kx) f32; plane/y/x: the walk's (n,)
// int64 corner indices; cjd/sjd: (n,) f32 or both null (no jitter, cr
// unused); hard: (B, hdr_words + pay_words) int32 or null; soft: (B,
// hdr_words + pay_words [+ (n - hdr) / 8 under rep 1]) int32 or null, with
// soft_mode 1 (bf16 values) or 2 (f32) when given, else 0. hdr: the
// header's slots (Rep-3), 0 for none; rep: the payload's, 7 or 1;
// img_groups: grid.y, the batch's interleaved image groups. Returns
// cudaGetLastError() after the launch.
extern "C" int corner_read_decode(const void* ci, const void* cr,
                                  const void* plane, const void* y,
                                  const void* x, const void* cjd,
                                  const void* sjd, void* hard, void* soft,
                                  int B, int Ky, int Kx, int n, int hdr,
                                  int rep, int soft_mode, int img_groups,
                                  float ssa, void* stream) {
  const bool jit = cjd != nullptr;
  if (!ci || !plane || !y || !x || B <= 0 || Ky <= 0 || Kx <= 0 ||
      hdr < 0 || n < hdr || (rep != 7 && rep != 1) || soft_mode < 0 ||
      soft_mode > 2 || (soft_mode != 0) != (soft != nullptr) ||
      (!hard && !soft) || jit != (sjd != nullptr) || (jit && !cr) ||
      img_groups <= 0 || img_groups > 65535 ||
      3LL * Ky * Kx > 0x7fffffffLL ||
      (rep == 1 && soft_mode && (n - hdr) % 8 != 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.ci = (const float*)ci;
  a.cr = (const float*)cr;
  a.plane = (const long long*)plane;
  a.y = (const long long*)y;
  a.x = (const long long*)x;
  a.cjd = (const float*)cjd;
  a.sjd = (const float*)sjd;
  a.hard = (int*)hard;
  a.soft = (int*)soft;
  a.img_stride = 3LL * Ky * Kx;
  a.Ky = Ky;
  a.Kx = Kx;
  a.B = B;
  a.hdr = hdr;
  a.rep = rep;
  a.soft_mode = soft_mode;
  a.hdr_words = (hdr / HEADER_REP + 31) / 32;
  a.hdr_blocks = (a.hdr_words + WARPS - 1) / WARPS;
  a.pay_groups = (n - hdr) / rep;
  a.pay_words = (a.pay_groups + 31) / 32;
  a.hard_cols = a.hdr_words + a.pay_words;
  a.soft_cols = a.hard_cols + (rep == 1 && soft_mode ? (n - hdr) / 8 : 0);
  a.ssa = ssa;
  const int blocks = a.hdr_blocks + (a.pay_words + WARPS - 1) / WARPS;
  if (blocks == 0) return (int)cudaSuccess;
  const dim3 grid(blocks, img_groups);
  if (jit)
    corner_read_decode_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    corner_read_decode_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
