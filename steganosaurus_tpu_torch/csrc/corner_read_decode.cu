// The extract's walk read and repetition decode (K5) for Hopper: from the
// forward corner spectrum to the decoded words.
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
// 1024, a 921,600-slot walk): every 32-byte sector the walk touches read
// once. The main path's walk touches 66.5% of the Im plane's sectors (it
// stays in a quarter disc of the corner): ~535 MB over the batch, with the
// read plan (5.5 MB) and the words (2 MB): ~0.16 ms, bound by its bytes.
//
// Design. A gather of 4-byte values costs one 32-byte sector request each,
// ~59 M at 4K B=64, and the SMs' rate of scattered requests (about one
// every two cycles an SM) held such a gather at 0.46 ms even with the
// batch in L2. This kernel makes fewer requests. A read plan, built once
// per walk (read_kernels.read_plan), sorts the slots by flat corner offset
// and cuts them into rows: the slots of one tile of TILE floats, at most
// ROW_SLOTS of them (the tail padding's repeated bin fills rows of its
// own), each row with its range and a mask of the 32-byte units its slots
// touch; each slot's offset within its tile is an int16. The batch goes in
// chunks of CHUNK images:
//   A. the stream: blocks take rows in turn and copy the row's touched
//      units of the chunk's images (ci, and cr under jitter) by 16-byte
//      cp.async, with the row's slot ids and offsets, into a STAGES-deep
//      shared-memory ring, the spectrum marked L2 evict-first: each byte
//      is read once, whole sectors coalesced, and nothing the row's work
//      needs waits on a load issued in its own turn; then for each slot of
//      the row two threads compute d for the chunk's 8 images and write
//      them as one 32-byte sector, scratch[slot][0..7], marked evict-last
//      (the scratch, 8 x n x 4 B, 29.5 MB at 4K, stays in the 50 MB L2
//      chunk after chunk);
//   B. the decode: a warp copies its word's slots' scratch sectors (in slot
//      order: a Rep-7 lane's 7 slots are 224 contiguous bytes) coalesced
//      into shared memory, each lane takes its group's values and emits
//      the chunk's images' words (emit: a warp a word, a lane a group, the
//      majorities, the left-to-right sums, the bf16 round, the
//      NaN-propagating min, __ballot_sync then __brev, lane 0 stores).
// ~7.4 M sector writes and coalesced streams in place of ~59 M scattered
// requests. One cooperative launch runs every chunk, a grid barrier
// between the phases and between chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HEADER_REP = 3;
constexpr int MAX_DEVICES = 16;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = THREADS <= 256 ? 2 : 1;  // an SM, at least
constexpr int TILE = 1024;             // floats of a plan tile
constexpr int UNITS = TILE / 8;        // its 32-byte units: the mask's bits
constexpr int MASK_WORDS = UNITS / 32;
constexpr int ROW_COLS = 3 + MASK_WORDS;  // a plan row: tile, start, end, mask
constexpr int CHUNK = 8;               // images of a chunk: a scratch entry
constexpr int PARTS = CHUNK / 4;       // 16-byte parts of a scratch entry
constexpr int STAGES = 2;              // the stream's shared-memory ring
constexpr int ROW_SLOTS = 512;         // slots of a plan row, at most
// 32-bit words of a row's int16 offsets in a stage (their copy starts at
// an even position)
constexpr int OFF_WORDS = ROW_SLOTS / 2 + 1;
// a warp's staging in phase B: 32 lanes of a Rep-7 group's entries, the
// lane stride odd in 16-byte units so the lanes' reads miss each other's
// banks
__host__ __device__ constexpr int lane_stride(int rep) {
  return (rep * PARTS) | 1;
}
static_assert(THREADS * 4 == TILE, "a tile is one 16-byte piece a thread");
static_assert(CHUNK % 4 == 0 && CHUNK <= 8, "a scratch entry is 16-byte parts");
static_assert(TILE <= 32768, "a slot's offset in its tile is an int16");

struct Args {
  const float* ci;
  const float* cr;         // under jitter only
  const int* order;        // the read plan: slots by offset,
  const int* offs;         // their offsets in their tiles (int16 pairs),
  const int* rows;         // the rows
  const float* cjd;        // (n,) cos / sin of the slots' jitter angles
  const float* sjd;
  float* scratch;          // (n, CHUNK) d values of a chunk
  unsigned* arrive;        // the grid barrier's counter (zeroed)
  int* hard;               // (B, hard_cols) or null
  int* soft;               // (B, soft_cols) or null
  long long img_stride;    // 3 * Ky * Kx
  int B, n_rows;
  int hdr, rep, soft_mode;  // soft_mode: 0 none, 1 bf16 values, 2 f32
  int hdr_words, pay_groups, pay_words;
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

// Image b's words `word` of a section from the lane's group g's values d
// (its REP slots; `valid` false past the section's groups): the hard word
// to column col0 + word, the soft word too, and (REP == 1 with soft
// values) the confidences to columns conf0 + g / 8. Every lane of the warp
// calls it.
template <int REP>
__device__ __forceinline__ void emit(const Args& a, const float (&d)[REP],
                                     bool valid, int b, int word, int g,
                                     int col0, int conf0) {
  const int lane = threadIdx.x & 31;
  if (a.hard) {
    int ones = 0;
#pragma unroll
    for (int k = 0; k < REP; ++k) ones += d[k] >= 0.f;
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
      // groups == payload slots, a multiple of 8: the 8 lanes of a coded
      // byte are all valid or all not
#pragma unroll
      for (int m = 1; m < 8; m <<= 1)
        conf = min_nan(conf, __shfl_xor_sync(0xffffffffu, conf, m));
      if (valid && (lane & 7) == 0) row[conf0 + g / 8] = __float_as_int(conf);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the ring's oldest group done: NS - 1 newer ones may still be in flight
template <int NS>
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 1) : "memory");
}

__device__ __forceinline__ void store16(float* p, float4 v, uint64_t pol) {
  asm volatile(
      "st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol)
      : "memory");
}

// A ring stage: the tile's (plane, image) rows of TILE floats, then the
// plan row itself (tile, start, end and a pad), its slots' ids and their
// int16 offsets from the 32-bit word that holds the row's first one.
template <bool JIT>
struct Stage {
  static constexpr int DATA = (JIT ? 2 : 1) * CHUNK * TILE;
  static constexpr int IDS = 4;
  static constexpr int OFFS = IDS + ROW_SLOTS;
  static constexpr int FLOATS = DATA + (OFFS + OFF_WORDS + 3) / 4 * 4;
  __device__ static const int* head(const float* st) {
    return reinterpret_cast<const int*>(st + DATA);
  }
};

// Stages of the ring of an instantiation: STAGES, fewer where the jitter's
// two planes would not fit a block's shared memory.
template <bool JIT>
__host__ __device__ constexpr int ring_stages() {
  constexpr int stage = Stage<JIT>::FLOATS * 4;
  return STAGES * stage <= 227 * 1024 ? STAGES : 227 * 1024 / stage;
}

// Issue the copies of plan row r into one ring stage: its touched units of
// images [img0, img0 + nb) (ci, and cr under JIT), the row and its slots,
// all to the caller's commit group.
template <bool JIT, bool VEC>
__device__ __forceinline__ void load_row(const Args& a, int r, long long img0,
                                         int nb, float* stage, uint64_t pol) {
  constexpr int PLANES = JIT ? 2 : 1;
  const int* row = a.rows + (long long)r * ROW_COLS;
  int* head = const_cast<int*>(Stage<JIT>::head(stage));
  if (threadIdx.x < 3) copy4(head + threadIdx.x, row + threadIdx.x);
  const int i0 = __ldg(row + 1), cnt = __ldg(row + 2) - i0;
  const int w0 = i0 >> 1, words = ((i0 + cnt + 1) >> 1) - w0;
  for (int k = threadIdx.x; k < cnt + words; k += THREADS) {
    if (k < cnt)
      copy4(head + Stage<JIT>::IDS + k, a.order + i0 + k);
    else
      copy4(head + Stage<JIT>::OFFS + k - cnt, a.offs + w0 + k - cnt);
  }
  const long long tb = (long long)__ldg(row) * TILE;
  const long long N = a.img_stride;
  const int p = threadIdx.x;  // the tile's 16-byte piece
  const unsigned m = (unsigned)__ldg(row + 3 + (p >> 6));
  const long long o = tb + 4 * p;
  if (!((m >> ((p >> 1) & 31)) & 1u) || o >= N) return;
  for (int b = 0; b < nb; ++b) {
#pragma unroll
    for (int q = 0; q < PLANES; ++q) {
      const float* src = (q ? a.cr : a.ci) + (img0 + b) * N + o;
      float* dst = stage + (q * CHUNK + b) * TILE + 4 * p;
      if (VEC) {
        copy16(dst, src, pol);
      } else {
        for (int e = 0; e < 4 && o + e < N; ++e) copy4(dst + e, src + e);
      }
    }
  }
}

// Slot s's d of the chunk's images part*4 .. part*4 + 3 from the ring
// stage `cur` (its value at offset o of each image's tile row) into its
// scratch entry.
template <bool JIT>
__device__ __forceinline__ void slot_values(const Args& a, const float* cur,
                                            int s, int o, int part,
                                            uint64_t pol) {
  float cj = 1.f, sj = 0.f;
  if (JIT) {
    cj = __ldg(a.cjd + s);
    sj = __ldg(a.sjd + s);
  }
  float d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int b = part * 4 + e;
    float v = cur[b * TILE + o];
    if (JIT)
      v = __fsub_rn(__fmul_rn(v, cj),
                    __fmul_rn(cur[(CHUNK + b) * TILE + o], sj));
    d[e] = __fmul_rn(v, a.ssa);
  }
  store16(a.scratch + (long long)s * CHUNK + part * 4,
          make_float4(d[0], d[1], d[2], d[3]), pol);
}

// Phase A of chunk c: the block's plan rows streamed through the ring (NS
// - 1 rows ahead), each slot's d of the chunk's images into its scratch
// entry.
template <bool JIT, bool VEC>
__device__ void stream_chunk(const Args& a, int c, float* smem) {
  constexpr int STAGE = Stage<JIT>::FLOATS;
  constexpr int NS = ring_stages<JIT>();
  const int R = a.n_rows, G = gridDim.x;
  if ((int)blockIdx.x >= R) return;
  const long long img0 = (long long)c * CHUNK;
  const int nb = min(CHUNK, a.B - c * CHUNK);
  const uint64_t first = evict_first(), last = evict_last();
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    const int rj = blockIdx.x + j * G;
    if (rj < R) load_row<JIT, VEC>(a, rj, img0, nb, smem + j * STAGE, first);
    commit();
  }
  const int part = threadIdx.x % PARTS;
  for (int i = 0, r = blockIdx.x; r < R; ++i, r += G) {
    const int st = i % NS;
    const int ahead = r + (NS - 1) * G;
    if (ahead < R)
      load_row<JIT, VEC>(a, ahead, img0, nb,
                         smem + (i + NS - 1) % NS * STAGE, first);
    commit();
    wait_ring<NS>();
    __syncthreads();
    const float* cur = smem + st * STAGE;
    const int* head = Stage<JIT>::head(cur);
    const int cnt = head[2] - head[1];
    const unsigned short* off =
        reinterpret_cast<const unsigned short*>(head + Stage<JIT>::OFFS) +
        (head[1] & 1);
    for (int k = threadIdx.x / PARTS; k < cnt; k += THREADS / PARTS)
      slot_values<JIT>(a, cur, head[Stage<JIT>::IDS + k], off[k], part, last);
    __syncthreads();
  }
}

// Phase B's word `word` of a section whose groups of REP slots start at
// slot `slot0`, `groups` of them, for chunk c's nb images, its values from
// the scratch through the warp's staging wsm.
template <int REP>
__device__ __forceinline__ void decode_word(const Args& a, int c, int nb,
                                            int word, int slot0, int groups,
                                            int col0, int conf0,
                                            float4* wsm) {
  constexpr int ENTRY = REP * PARTS;  // 16-byte parts of a lane's group
  constexpr int LS = lane_stride(REP);
  const int lane = threadIdx.x & 31;
  const int g0 = word * 32;
  const int cnt = min(32, groups - g0);
  const float4* src = reinterpret_cast<const float4*>(a.scratch) +
                      ((long long)slot0 + (long long)g0 * REP) * PARTS;
  for (int q = lane; q < cnt * ENTRY; q += 32) {
    const int l = q / ENTRY;
    wsm[l * LS + q - l * ENTRY] = __ldcg(src + q);
  }
  __syncwarp();
  const bool valid = lane < cnt;
  float4 v[ENTRY];
#pragma unroll
  for (int r = 0; r < ENTRY; ++r)
    v[r] = valid ? wsm[lane * LS + r] : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
#pragma unroll
  for (int b = 0; b < CHUNK; ++b) {
    if (b >= nb) break;  // the same nb for every lane
    float d[REP];
#pragma unroll
    for (int k = 0; k < REP; ++k) {
      const float4 q = v[k * PARTS + b / 4];
      d[k] = (b & 3) == 0 ? q.x : (b & 3) == 1 ? q.y : (b & 3) == 2 ? q.z : q.w;
    }
    emit<REP>(a, d, valid, c * CHUNK + b, word, g0 + lane, col0, conf0);
  }
}

// Phase B of chunk c: the warps of the grid take the row's words in turn.
__device__ void decode_chunk(const Args& a, int c, float4* smem) {
  const int warp = threadIdx.x >> 5;
  float4* wsm = smem + warp * 32 * lane_stride(7);
  const int nb = min(CHUNK, a.B - c * CHUNK);
  const int tasks = a.hdr_words + a.pay_words;
  for (int t = blockIdx.x * WARPS + warp; t < tasks; t += gridDim.x * WARPS) {
    if (t < a.hdr_words)
      decode_word<HEADER_REP>(a, c, nb, t, 0, a.hdr / HEADER_REP, 0, -1, wsm);
    else if (a.rep == 7)
      decode_word<7>(a, c, nb, t - a.hdr_words, a.hdr, a.pay_groups,
                     a.hdr_words, -1, wsm);
    else
      decode_word<1>(a, c, nb, t - a.hdr_words, a.hdr, a.pay_groups,
                     a.hdr_words, a.soft_mode ? a.hdr_words + a.pay_words : -1,
                     wsm);
  }
}

// Every block of the (co-resident) grid arrives; the counter only grows.
__device__ __forceinline__ void grid_barrier(unsigned* arrive,
                                             unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrive, 1u);
    while (*reinterpret_cast<volatile unsigned*>(arrive) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <bool JIT>
constexpr size_t kernel_smem() {
  constexpr size_t ring =
      (size_t)ring_stages<JIT>() * Stage<JIT>::FLOATS * 4;
  constexpr size_t stage = (size_t)WARPS * 32 * lane_stride(7) * 16;
  return ring > stage ? ring : stage;
}
static_assert(ring_stages<true>() >= 1 && kernel_smem<true>() <= 232448,
              "the jitter ring fits a block");

// Every chunk: phase A, a grid barrier, phase B (whose staging shares the
// ring's shared memory), a grid barrier before the next chunk's phase A.
template <bool JIT, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
corner_read_decode_kernel(const Args a, int chunks) {
  extern __shared__ __align__(128) float smem[];
  unsigned target = 0;
  for (int c = 0; c < chunks; ++c) {
    stream_chunk<JIT, VEC>(a, c, smem);
    grid_barrier(a.arrive, target);
    decode_chunk(a, c, reinterpret_cast<float4*>(smem));
    if (c + 1 < chunks) grid_barrier(a.arrive, target);
  }
}

// Blocks per SM of each instantiation [JIT][VEC], per card.
struct Occupancy {
  int sms = 0;  // -1: no cooperative launch
  int per_sm[2][2];
};
Occupancy g_occ[MAX_DEVICES];

template <bool JIT, bool VEC>
int occupancy(int* per_sm) {
  const void* k = (const void*)corner_read_decode_kernel<JIT, VEC>;
  int err = (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kernel_smem<JIT>());
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, k, THREADS, kernel_smem<JIT>());
  return err;
}

// The grid on the current card (all blocks resident), or a CUDA error as a
// negative value; 0 where the card has no cooperative launch.
int resident_grid(bool jit, bool vec) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return -err;
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  Occupancy& o = g_occ[dev];
  if (o.sms == 0) {
    int sms = 0, coop = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err)
      err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!err) err = occupancy<false, false>(&o.per_sm[0][0]);
    if (!err) err = occupancy<false, true>(&o.per_sm[0][1]);
    if (!err) err = occupancy<true, false>(&o.per_sm[1][0]);
    if (!err) err = occupancy<true, true>(&o.per_sm[1][1]);
    if (err) return -err;
    o.sms = coop ? sms : -1;
  }
  return o.sms < 0 ? 0 : o.sms * o.per_sm[jit][vec];
}

}  // namespace

// ci (and cr under jitter): (B, 3, Ky, Kx) f32; the read plan of the walk
// (read_kernels.read_plan): order (n,) int32, offs the slots' offsets in
// their tiles, (n rounded up to even,) int16 on a 4-byte boundary, rows
// (n_rows, ROW_COLS) int32; cjd/sjd: (n,) f32 or both null (no jitter, cr
// unused); scratch: (n, CHUNK) f32; arrive: one zeroed unsigned; hard:
// (B, hdr_words + pay_words) int32 or null; soft: (B, hdr_words +
// pay_words [+ (n - hdr) / 8 under rep 1]) int32 or null, with soft_mode 1
// (bf16 values) or 2 (f32) when given, else 0. hdr: the header's slots
// (Rep-3), 0 for none; rep: the payload's, 7 or 1. One cooperative launch.
// Returns the launch's CUDA error, 0 on success.
extern "C" int corner_read_decode(const void* ci, const void* cr,
                                  const void* order, const void* offs,
                                  const void* rows, const void* cjd,
                                  const void* sjd, void* scratch, void* arrive,
                                  void* hard, void* soft, int B, int Ky,
                                  int Kx, int n, int n_rows, int hdr, int rep,
                                  int soft_mode, float ssa, void* stream) {
  const bool jit = cjd != nullptr;
  if (!ci || !order || !offs || (uintptr_t)offs % 4 || !rows || !scratch ||
      !arrive || B <= 0 || Ky <= 0 || Kx <= 0 || hdr < 0 || n < hdr ||
      n_rows < 0 || (n > 0 && n_rows == 0) || (rep != 7 && rep != 1) ||
      soft_mode < 0 || soft_mode > 2 ||
      (soft_mode != 0) != (soft != nullptr) || (!hard && !soft) ||
      jit != (sjd != nullptr) || (jit && !cr) ||
      3LL * Ky * Kx > 0x7fffffffLL ||
      (rep == 1 && soft_mode && (n - hdr) % 8 != 0))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.ci = (const float*)ci;
  a.cr = jit ? (const float*)cr : nullptr;
  a.order = (const int*)order;
  a.offs = (const int*)offs;
  a.rows = (const int*)rows;
  a.cjd = (const float*)cjd;
  a.sjd = (const float*)sjd;
  a.scratch = (float*)scratch;
  a.arrive = (unsigned*)arrive;
  a.hard = (int*)hard;
  a.soft = (int*)soft;
  a.img_stride = 3LL * Ky * Kx;
  a.B = B;
  a.n_rows = n_rows;
  a.hdr = hdr;
  a.rep = rep;
  a.soft_mode = soft_mode;
  a.hdr_words = (hdr / HEADER_REP + 31) / 32;
  a.pay_groups = (n - hdr) / rep;
  a.pay_words = (a.pay_groups + 31) / 32;
  a.hard_cols = a.hdr_words + a.pay_words;
  a.soft_cols = a.hard_cols + (rep == 1 && soft_mode ? (n - hdr) / 8 : 0);
  a.ssa = ssa;
  if (a.hdr_words + a.pay_words == 0) return (int)cudaSuccess;
  const bool vec = a.img_stride % 4 == 0 && (uintptr_t)ci % 16 == 0 &&
                   (!jit || (uintptr_t)cr % 16 == 0);
  const int grid = resident_grid(jit, vec);
  if (grid < 0) return -grid;
  if (grid == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  int chunks = (B + CHUNK - 1) / CHUNK;
  const void* kernel =
      jit ? (vec ? (const void*)corner_read_decode_kernel<true, true>
                 : (const void*)corner_read_decode_kernel<true, false>)
          : (vec ? (const void*)corner_read_decode_kernel<false, true>
                 : (const void*)corner_read_decode_kernel<false, false>);
  const size_t smem = jit ? kernel_smem<true>() : kernel_smem<false>();
  void* args[] = {&a, &chunks};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS),
                                          args, smem, (cudaStream_t)stream);
}
