// The forward corner DFT's stage 2, for Hopper: a prep pass (the stage-1
// output's bf16 copies and column energies), a band pass (the band columns'
// bf16 terms and the column mask) and K2, a persistent, warp-specialised
// wgmma GEMM whose band tiles run in split bf16. The band is nb groups of
// 64 columns, nb given at run time: one group under mix_adaptive and
// mix_split (the top-64 energy columns, or the static [0, 64)), every
// column under the modes that run the whole stage at HIGH (mix, mix2,
// mix_conservative, high: no bulk tile), none under bf16 (no band tile).
//
// Replaces steganosaurus_tpu/spectral/corner.py:430 _fwd_y_split with
// adaptive=True, which XLA fuses for the TPU (its energy, casts and
// one-hot gathers and scatters go into the dots). With the stage-1 output
// (ar, ai) (P, H, Kx) f32 and the y tables (eyr, eyi) (Ky, H), per plane
//
//     cr = eyr . ar - eyi . ai,   ci = eyr . ai + eyi . ar     (contract h)
//
// with bf16 operands and f32 accumulation for every column, except the
// BAND = 64 columns of highest energy sum_h(ar^2 + ai^2) per plane, which
// run at higher precision: here split bf16 with three terms a value, x =
// x0 + x1 + x2, and the six products T_i.a_j with i + j <= 2 summed in f32
// (how the TPU emulates Precision.HIGHEST; its Precision.HIGH, two terms
// and three products, moved a Rep-7 group of the 4K benchmark stego to a
// wrong bit on an H100, tools/band_ber_torch.py).
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s) at the main shape,
// 4K B=64 (P = 192, H = 2160, Ky = Kx = 1024):
// - prep: reads ar and ai (3.40 GB), writes ar16 and ai16 (1.70 GB) and
//   the energies: 5.1 GB, 1.52 ms of HBM time. Bytes-bound.
// - band: reads the 64 band columns of ar and ai (0.21 GB, gathered: each
//   4-byte value costs a 32-byte sector) and writes their bf16 terms (0.32
//   GB): 0.16 ms of HBM time. Bytes-bound. It replaces the one-hot gather
//   of corner.py:480-485 and the mask of :506.
// - K2: the bulk over the columns it keeps, 8 P Ky H (Kx - 64) = 3.26e12
//   FLOPs, plus the band 6 x 8 P 64 H Ky = 1.30e12: 4.62 ms of tensor-core
//   time (utils/cost.py k2_cost). The bulk tiles compute the band columns
//   too and their epilogue drops them (0.22 ms of the kernel's work that
//   the function does not need). Against 1.70 GB of bf16
//   operands, 0.32 GB of band operand and 1.61 GB of f32 output, ~1.08 ms
//   of HBM time. Operations-bound. The eager chain it replaces ran the band
//   as f32 products on the CUDA cores (67 TFLOP/s: 3.2 ms for the band
//   alone) and made the energy, the casts and four f32 products in
//   separate passes through HBM.
//
// Design:
// 1. Prep: one block of 256 threads per (64 columns, plane); thread (r, c)
//    reads four consecutive columns of the rows h = r mod 16 (16-byte
//    loads), stores their bf16 values (__float2bfloat16_rn: bit-equal to
//    .to(torch.bfloat16)) and sums ar*ar + ai*ai (rounded in f32 as eager
//    torch rounds it; built with -fmad=false) in f64, then the block adds
//    the 16 row lanes in order and rounds once to f32. The order depends
//    on H alone and uses no atomics, so every run and every shard of a
//    batch gives the same energies, within an f32 rounding of the exact
//    sum of the f32 terms (torch.sum's f32 sum is no closer).
//    Where stage 1 runs through K1 (bf16), K1's epilogue does this pass's
//    work from its registers (corner_stage1_wgmma.cu, 7.) and
//    corner_stage2_prep_kernel_reduce adds its per-tile f64 partials; this
//    pass stays for an f32 stage 1.
// 2. Band pass: one block of 256 threads per (32 rows, plane); thread
//    (r, j) loads ar and ai at column idx[p][j] of its rows and stores
//    their three bf16 terms (the differences exact in f32, as the plain
//    version's f32 subtractions), 64 consecutive values a row; the
//    plane's first block also writes its mask words, each from the 64
//    indices (no atomics).
// 3. K2 computes each plane's [cr; ci] (2Ky x Kx) = T (2Ky x 2H) .
//    [ar16; ai16] (2H x Kx) as one real GEMM, T = [[eyr, -eyi], [eyi,
//    eyr]] cached as its three bf16 terms T0, T1, T2 with H and Ky padded
//    to 64 (zeros), rows [0, Ky) cr, [Kyp, Kyp + Ky) ci (A: 128 x 64 tiles
//    by TMA, K-major, 128-byte swizzle, as in K1 and K4).
// 4. B is the plane's bf16 stage-1 rows as the prep stored them: N-major
//    (x contiguous), so the wgmma takes B transposed (MN-major descriptor:
//    64-column atoms 8 KB apart, 8-row groups 1 KB apart). Two 3-D TMA
//    descriptors (x, h, p), ar16 and ai16, switched by k-block, load two
//    64 x 64 boxes a k-block; rows past H and columns past Kx load as
//    zeros, so no plane reads its neighbour's rows.
// 5. Bulk tiles (128 x 128) run every column
//    and store f32 cr / ci from registers, skipping the plane's band
//    columns through a per-plane bit mask (32-bit words, built from idx).
// 6. Band tiles run first (they are six times as long): one tile covers
//    128 rows of T and two planes' 64 band columns (N = 128, the same
//    wgmma), B one 4-D TMA box of the band operand (6, P, H, 64) =
//    [ar0, ai0, ar1, ai1, ar2, ai2], the terms of the gathered f32
//    columns. Its k-loop runs six segments of 2Hp, T_i x a_j, the
//    lowest-order products first (T2 a0, T1 a1, T0 a2, T1 a0, T0 a1, T0
//    a0), so they are summed before the accumulator grows; its epilogue
//    writes each column at idx[p][j], into the holes the bulk tiles left.
//    Every output element is written once: no race, no atomics.
// 7. Accuracy: every PROMOTE = 4 k-blocks of 64 (256 products) the
//    consumer waits for its wgmmas and adds their sum into an f32 register
//    sum rounded to nearest (a promotion), and the next k-block starts the
//    tensor cores' sum from zero, so that sum spans 256 products, not 2H.
//    Summed on the tensor cores over the whole contraction (256-wide
//    tiles, the first version), the bulk's error against the exact sum of
//    the same bf16 products was 2.1x cuBLAS's bf16 GEMM's (RMS at 4K B=64
//    on an H100), and the benchmark's stego took one Rep-7 group to a
//    wrong bit. The f32 sum needs 64 more registers a thread, hence
//    128-wide tiles.
// 8. Each output element is summed over its k-blocks in one order, fixed by
//    Hp: a plane gives the same bits whatever P, its neighbour in a band
//    tile, the cluster, or the shard it sits in.
// 9. What held the 128-wide version back (tools/k2_ablation_torch.py on an
//    H100, 4K B=64): not the promotion's arithmetic (no promotion: -0.1 ms
//    of ~10) nor the epilogue (-0.2 ms); the operand loads (skipped after
//    the first ring: -2 to -3 ms) and the small steps, one mbarrier wait,
//    commit and wait_group for every four m64n128k16 wgmmas. Two levers
//    against those small steps were measured against the 64-deep ring of 6
//    in turns and not taken: stages 128 deep (two k-blocks under one pair
//    of barriers, eight wgmmas a commit, a ring of 3 for lack of room):
//    +1.2 ms, the ring then running one stage ahead of the consumers where
//    it ran four; and two stages of 64 under one commit (eight wgmmas a
//    round trip in the ring of 6): no gain.
// 10. A 2-CTA cluster shares B: its two blocks take row blocks mt = 2 mp
//    and 2 mp + 1 of T for the same plane (or band plane pair) and column
//    block, and each loads half of the B boxes (bulk: the 64-column atom
//    j = its rank of every stage; band: the one box, both planes, of every
//    k-block kb with kb % 2 = its rank) with .multicast::cluster into both
//    blocks' rings. A
//    stage is refilled only when the consumer warps of both blocks have
//    freed it (each empty barrier counts 2 x 8 warps; arrivals through
//    mapa and mbarrier.arrive.shared::cluster, CTA scope: with .release
//    .cluster every arrival cost a fence and K2 ran 17 ms). Where Kyp/64
//    row blocks are odd the last pair's second block has no rows: it loads
//    its half of B for its partner and computes nothing. Band units come
//    first (pairs of band tiles of one plane pair), then bulk units (nt
//    fastest, then mp, then p); the grid is as many clusters as
//    cudaOccupancyMaxActiveClusters finds room for (cudaLaunchKernelEx).
//    Measured, the multicast moves K2's time by no more than the noise
//    (each block still takes in a whole stage; "multicast off").
// 11. The ring: 6 stages of (A 16 KB, B 16 KB), full/empty mbarriers, one
//    producer thread; two consumer warpgroups (setmaxnreg 232) of 64 rows,
//    each keeping one stage's wgmmas in flight (wait_group 1) between
//    promotions. The epilogue stores from registers and does not overlap
//    the next tile's main loop.
// 12. The band width at run time: the band operand is (6, P, H, 64 nb) and
//    idx (P, 64 nb); a band unit is (plane pair, group, row-block pair),
//    its B box the group's 64 columns of the two planes. A width that is
//    not a multiple of 64 is padded by the caller with copies of the row's
//    last index: such a column is computed twice from the same operand and
//    stored twice with the same value. With nb = 1 the units, their order
//    and every tile's sums are the fixed-width kernel's (bit-equal).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- the prep pass --------------------------------------------------------

constexpr int PREP_COLS = 64;     // columns per block
constexpr int PREP_LANES = 16;    // row lanes: lane r sums rows h = r mod 16
constexpr int PREP_THREADS = PREP_LANES * PREP_COLS / 4;

__device__ __forceinline__ float sq2(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

__global__ void __launch_bounds__(PREP_THREADS)
corner_stage2_prep_kernel(const float* __restrict__ ar,
                          const float* __restrict__ ai,
                          __nv_bfloat16* __restrict__ ar16,
                          __nv_bfloat16* __restrict__ ai16,
                          float* __restrict__ energy, int H, int X, int ldk,
                          int vec) {
  __shared__ double part[PREP_LANES][PREP_COLS];
  const int p = blockIdx.y;
  const int x0 = blockIdx.x * PREP_COLS;
  const int r = threadIdx.x / (PREP_COLS / 4);
  const int c = threadIdx.x % (PREP_COLS / 4);
  const int xc = x0 + 4 * c;  // the first of this thread's four columns
  const float* pr = ar + (size_t)p * H * X;
  const float* pi = ai + (size_t)p * H * X;
  __nv_bfloat16* qr = ar16 + (size_t)p * H * ldk;
  __nv_bfloat16* qi = ai16 + (size_t)p * H * ldk;
  double e[4] = {0.0, 0.0, 0.0, 0.0};
  if (vec) {  // X % 4 == 0, 16-byte-aligned rows: four columns or none
    if (xc < X) {
#pragma unroll 4
      for (int h = r; h < H; h += PREP_LANES) {
        const float4 a = *reinterpret_cast<const float4*>(pr + (size_t)h * X + xc);
        const float4 b = *reinterpret_cast<const float4*>(pi + (size_t)h * X + xc);
        e[0] += (double)sq2(a.x, b.x);
        e[1] += (double)sq2(a.y, b.y);
        e[2] += (double)sq2(a.z, b.z);
        e[3] += (double)sq2(a.w, b.w);
        __nv_bfloat162 r01 = __floats2bfloat162_rn(a.x, a.y);
        __nv_bfloat162 r23 = __floats2bfloat162_rn(a.z, a.w);
        __nv_bfloat162 i01 = __floats2bfloat162_rn(b.x, b.y);
        __nv_bfloat162 i23 = __floats2bfloat162_rn(b.z, b.w);
        uint2 vr, vi;
        vr.x = *reinterpret_cast<uint32_t*>(&r01);
        vr.y = *reinterpret_cast<uint32_t*>(&r23);
        vi.x = *reinterpret_cast<uint32_t*>(&i01);
        vi.y = *reinterpret_cast<uint32_t*>(&i23);
        *reinterpret_cast<uint2*>(qr + (size_t)h * ldk + xc) = vr;
        *reinterpret_cast<uint2*>(qi + (size_t)h * ldk + xc) = vi;
      }
    }
  } else {
    for (int h = r; h < H; h += PREP_LANES) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = xc + j;
        if (x >= X) continue;
        const float a = pr[(size_t)h * X + x], b = pi[(size_t)h * X + x];
        e[j] += (double)sq2(a, b);
        qr[(size_t)h * ldk + x] = __float2bfloat16_rn(a);
        qi[(size_t)h * ldk + x] = __float2bfloat16_rn(b);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[r][4 * c + j] = e[j];
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (threadIdx.x < PREP_COLS && x < X) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < PREP_LANES; ++k) s += part[k][threadIdx.x];
    energy[(size_t)p * X + x] = (float)s;
  }
}

// The prep's energies where K1's epilogue made the rest of it
// (corner_stage1_wgmma.cu, 7.): part (ceil(P*H / K1_ROWS) + P - 1, X) f64
// holds, at row t + p, the sum of plane p's rows in K1's row tile t. One
// thread a (column, plane) adds the plane's slots in tile order and
// rounds once to f32. Named after the prep, whose energy pass it is.
constexpr int K1_ROWS = 128;      // K1's row tile (its BM)
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(REDUCE_THREADS)
corner_stage2_prep_kernel_reduce(const double* __restrict__ part,
                                 float* __restrict__ energy, int H, int X) {
  const int p = blockIdx.y;
  const int x = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (x >= X) return;
  const long long r0 = (long long)p * H;
  const int t0 = (int)(r0 / K1_ROWS), t1 = (int)((r0 + H - 1) / K1_ROWS);
  double s = 0.0;
  for (int t = t0; t <= t1; ++t) s += part[(size_t)(t + p) * X + x];
  energy[(size_t)p * X + x] = (float)s;
}

// ---- the band operand ------------------------------------------------------

constexpr int BAND_COLS = 64;     // band columns per block (K2's BAND)
constexpr int BAND_ROWS = 32;     // rows h per block
constexpr int BAND_THREADS = 256; // 4 rows x 64 columns at a time

// bf16 terms x0 + x1 + x2 of x, each the rounding of what the earlier ones
// leave (the differences are exact in f32)
__device__ __forceinline__ void split3(float x, __nv_bfloat16* t) {
  t[0] = __float2bfloat16_rn(x);
  const float r = __fsub_rn(x, __bfloat162float(t[0]));
  t[1] = __float2bfloat16_rn(r);
  t[2] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(t[1])));
}

// g (6, P, H, bw) = the split3 terms of ar and ai at the band columns idx
// (P, bw), [ar0, ai0, ar1, ai1, ar2, ai2], bw = 64 nb; block (., p, k)
// takes the columns of group k (64k..64k+63); the first block of each
// plane also writes its band bits, mask (P, nw) (word w: columns
// 32w..32w+31), from all bw indices (a column given twice sets its bit
// twice)
__global__ void __launch_bounds__(BAND_THREADS)
corner_stage2_band_kernel(const float* __restrict__ ar,
                          const float* __restrict__ ai,
                          const long long* __restrict__ idx,
                          __nv_bfloat16* __restrict__ g,
                          uint32_t* __restrict__ mask, int P, int H, int X,
                          int nw, int bw) {
  const int p = blockIdx.y;
  const long long* ip = idx + (size_t)p * bw;
  if (blockIdx.x == 0 && blockIdx.z == 0)
    for (int w = threadIdx.x; w < nw; w += BAND_THREADS) {
      uint32_t bits = 0;
      for (int j = 0; j < bw; ++j) {
        const long long x = ip[j];
        if (x >> 5 == w) bits |= 1u << (x & 31);
      }
      mask[(size_t)p * nw + w] = bits;
    }
  const int j = blockIdx.z * BAND_COLS + threadIdx.x % BAND_COLS;
  const long long x = ip[j];
  const size_t plane = (size_t)P * H * bw;  // one term's stride in g
  for (int h = blockIdx.x * BAND_ROWS + threadIdx.x / BAND_COLS;
       h < min(H, (blockIdx.x + 1) * BAND_ROWS);
       h += BAND_THREADS / BAND_COLS) {
    const size_t src = ((size_t)p * H + h) * X + x;
    const size_t dst = ((size_t)p * H + h) * bw + j;
    __nv_bfloat16 t[3];
    split3(ar[src], t);
#pragma unroll
    for (int k = 0; k < 3; ++k) g[2 * k * plane + dst] = t[k];
    split3(ai[src], t);
#pragma unroll
    for (int k = 0; k < 3; ++k) g[(2 * k + 1) * plane + dst] = t[k];
  }
}

// ---- K2 --------------------------------------------------------------------

constexpr int BAND = 64;                // band columns per group
constexpr int LEVELS = 3;               // bf16 terms of a band value
constexpr int SEGS = 6;                 // band products T_i a_j, in order:
constexpr uint32_t SEG_T = 0x001012;    // i of segment s: nibble s
constexpr uint32_t SEG_A = 0x010210;    // j of segment s: nibble s
constexpr int BAND_PLANES = 2;          // planes per band tile (2 x 64 = BN)
constexpr int BM = 128;                 // rows of T per tile (two consumer warpgroups)
constexpr int BN = 128;                 // output columns per tile
constexpr int BK = 64;                  // a k-block (a stage): 128 bytes of bf16
constexpr int STAGES = 6;
constexpr int PROMOTE = 4;              // k-blocks a tensor-core sum spans
constexpr int CLUSTER = 2;              // blocks sharing B
constexpr bool MULTICAST = true;        // B by TMA multicast (else each block loads its own)
constexpr int A_BYTES = BM * BK * 2;    // bf16: one k-block of T's 128 rows
constexpr int BOX_BYTES = 64 * BK * 2;  // one 64-column atom of B, one k-block
constexpr int B_BYTES = BN / 64 * BOX_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int NTHREADS = 384;           // 2 consumer + 1 producer warpgroup
constexpr int EMPTY_ARRIVALS = 8 * (MULTICAST ? CLUSTER : 1);  // consumer warps
constexpr int BAR_BYTES = 2 * STAGES * 8;
constexpr int SMEM = STAGES * STAGE_BYTES + BAR_BYTES + 1024;
static_assert(SMEM <= 232448, "shared memory");
static_assert(BAND * BAND_PLANES == BN, "a band tile is one N tile");
static_assert(BAND == BAND_COLS, "the band operand's width");
static_assert(CLUSTER == 2 && BN / 64 == CLUSTER, "a block loads one atom");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return (int)r;
}
// every thread of both blocks: what either block did before is seen after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// one arrival on the barrier at bar's offset in block `cta` of the cluster
// (the default .release.cta semantics: the arrival orders this thread's
// earlier reads of the stage, and its wgmmas have completed)
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// the box into dst and onto bar at the same offsets in every block of
// `mask`
__device__ __forceinline__ void tma_load_3d_mc(void* dst, const CUtensorMap* map,
                                               int c0, int c1, int c2,
                                               uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d_mc(void* dst, const CUtensorMap* map,
                                               int c0, int c1, int c2, int c3,
                                               uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// K-major operand (A, T) in 128-byte-swizzled shared memory: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), leading offset unused.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// MN-major operand (B: x contiguous) in 128-byte-swizzled shared memory, as
// two TMA boxes of 64 rows h x 64 columns x: a row of 128 bytes holds 64
// columns of one h; 8-row groups of h 1024 bytes apart (SBO); the 64-column
// atoms BOX_BYTES apart (LBO).
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(BOX_BYTES >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, f32) += A (64 x 16, bf16, K-major) * B (16 x 128, bf16,
// MN-major: the transpose bit set); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_tb(float* d, uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue/wait points.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A cluster's unit of work: band units first (mp fastest, then the band
// group grp of 64 columns, then p, the first of its BAND_PLANES planes),
// then bulk units (nt fastest, then mp, then p); mp a pair of 128-row
// blocks of T. Block `rank` of the cluster takes row block mt = 2 mp +
// rank, which lies past the last (a "ghost": it loads, computes nothing)
// where Kyp/64 is odd. nkb: the tile's k-blocks of 64. With one group
// (nb = 1) the units and their order are the fixed-width kernel's.
struct Tile {
  bool band, ghost;
  int p, mt, nt, grp, nkb;
};

__device__ __forceinline__ Tile tile_of(int unit, int rank, int n_band,
                                        int n_mt, int n_mp, int n_nt, int nh,
                                        int nb) {
  Tile t;
  int mp;
  t.grp = 0;
  if (unit < n_band) {
    t.band = true;
    mp = unit % n_mp;
    const int u = unit / n_mp;
    t.grp = u % nb;
    t.p = (u / nb) * BAND_PLANES;
    t.nt = 0;
    t.nkb = SEGS * 2 * nh;  // segments of [ar part; ai part]
  } else {
    int u = unit - n_band;
    t.band = false;
    t.nt = u % n_nt;
    u /= n_nt;
    mp = u % n_mp;
    t.p = u / n_mp;
    t.nkb = 2 * nh;
  }
  t.mt = 2 * mp + rank;
  t.ghost = t.mt >= n_mt;
  return t;
}

struct Args {
  const uint32_t* mask;   // (P, nw) band column bits; null: no band
  const long long* idx;   // (P, bw) band columns, bw = BAND nb
  float* cr;              // (P, Ky, X)
  float* ci;
  int P, Ky, Kyp, X, nw, nh, n_mt, n_mp, n_nt, n_band, n_units, vec2, nb, bw;
};

// a consumer warp frees a stage in every block whose ring its block's
// stages fed (both blocks' under multicast)
__device__ __forceinline__ void release(uint64_t* bar, int rank) {
  mbar_arrive(bar);
  if (MULTICAST) mbar_arrive_at(bar, rank ^ 1);
}

__global__ void __launch_bounds__(NTHREADS, 1)
corner_stage2_kernel(const __grid_constant__ CUtensorMap tm_t,
                     const __grid_constant__ CUtensorMap tm_ar,
                     const __grid_constant__ CUtensorMap tm_ai,
                     const __grid_constant__ CUtensorMap tm_g,
                     const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* smem_b = smem;                       // STAGES x 16 KB
  uint8_t* smem_a = smem + STAGES * B_BYTES;    // STAGES x 16 KB
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_a + STAGES * A_BYTES);
  uint64_t* empty = full + STAGES;

  const int rank = (int)cluster_ctarank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                 // the producer's expect_tx arrival
      mbar_init(&empty[s], EMPTY_ARRIVALS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the partner's barriers exist before any load or arrival reaches them
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      const int nh = a.nh;
      int stage = 0;
      uint32_t phase = 0;
      for (int unit = cluster_id(); unit < a.n_units; unit += cluster_count()) {
        const Tile t = tile_of(unit, rank, a.n_band, a.n_mt, a.n_mp, a.n_nt,
                               nh, a.nb);
        const uint32_t bytes = (t.ghost ? 0 : A_BYTES) + B_BYTES;
        for (int kb = 0; kb < t.nkb; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], bytes);
          uint8_t* sa = smem_a + stage * A_BYTES;
          uint8_t* sb = smem_b + stage * B_BYTES;
          if (t.band) {
            // segment s: T_i x a_j (SEG_T, SEG_A); each runs the ar part
            // (T's columns [0, Hp)), then the ai part
            const int seg = kb / (2 * nh), rem = kb - seg * 2 * nh;
            const int part = rem / nh, hb = rem - part * nh;
            const int ti = (SEG_T >> (4 * seg)) & 0xF;
            const int aj = (SEG_A >> (4 * seg)) & 0xF;
            if (!t.ghost)
              tma_load_3d(sa, &tm_t, rem * BK, t.mt * BM, ti, &full[stage]);
            // both planes' 64 band columns of group grp, one box: block
            // kb % 2 loads it
            if (!MULTICAST)
              tma_load_4d(sb, &tm_g, BAND * t.grp, hb * BK, t.p,
                          2 * aj + part, &full[stage]);
            else if (kb % CLUSTER == rank)
              tma_load_4d_mc(sb, &tm_g, BAND * t.grp, hb * BK, t.p,
                             2 * aj + part, &full[stage],
                             (1u << CLUSTER) - 1);
          } else {
            const int part = kb / nh, hb = kb - part * nh;
            if (!t.ghost)
              tma_load_3d(sa, &tm_t, kb * BK, t.mt * BM, 0, &full[stage]);
            const CUtensorMap* tm = part ? &tm_ai : &tm_ar;
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) {
              // the 64-column atom j: block j loads it
              if (!MULTICAST)
                tma_load_3d(sb + j * BOX_BYTES, tm, t.nt * BN + 64 * j,
                            hb * BK, t.p, &full[stage]);
              else if (j == rank)
                tma_load_3d_mc(sb + j * BOX_BYTES, tm, t.nt * BN + 64 * j,
                               hb * BK, t.p, &full[stage],
                               (1u << CLUSTER) - 1);
            }
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups: 64 rows x 128 columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int q = lane & 3;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);  // tile row; r0 + 8 too
    // d: the products of the k-blocks since the last promotion, on the
    // tensor cores; acc: the tile's sum of them, rounded to nearest
    float d[64], acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int unit = cluster_id(); unit < a.n_units; unit += cluster_count()) {
      const Tile t = tile_of(unit, rank, a.n_band, a.n_mt, a.n_mp, a.n_nt,
                             a.nh, a.nb);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      int prev = -1;
      // the accumulators are touched by nothing but wgmma from here to each
      // promotion's wait_group 0 (a read in between would make ptxas
      // serialise the wgmmas)
      fence_acc(d);
      for (int kb = 0; kb < t.nkb; ++kb) {
        mbar_wait(&full[stage], phase);
        if (t.ghost) {
          // nothing reads the stage: free it at once
          __syncwarp();
          if (lane == 0) release(&empty[stage], rank);
        } else {
          const uint64_t da =
              kmajor_desc(smem_a + stage * A_BYTES + wg * 64 * 128);
          const uint64_t db = mnmajor_desc(smem_b + stage * B_BYTES);
          const bool fresh = kb % PROMOTE == 0;
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)  // k16 step s: 32 bytes on along A's
                                       // rows, 16 rows (2 KB) on down B's
            wgmma_m64n128k16_tb(d, da + 2 * s, db + 128 * s,
                                (!fresh || s > 0) ? 1u : 0u);
          wgmma_commit();
          if (kb % PROMOTE == PROMOTE - 1 || kb == t.nkb - 1) {
            // promote: add the last PROMOTE k-blocks' sum into acc (f32, to
            // nearest; built with -fmad=false)
            wgmma_wait0();
            fence_acc(d);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
            fence_acc(d);
            // every wgmma is done: free this stage and the one before
            __syncwarp();
            if (lane == 0) {
              if (prev >= 0) release(&empty[prev], rank);
              release(&empty[stage], rank);
            }
            prev = -1;
          } else {
            wgmma_wait1();  // the stage before this one is done: free it
            __syncwarp();
            if (lane == 0 && prev >= 0) release(&empty[prev], rank);
            prev = stage;
          }
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (t.ghost) continue;

      // ---- epilogue: f32 cr / ci from registers ----
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = t.mt * BM + r0 + 8 * half;  // row of [cr; ci]
        const bool is_ci = m >= a.Kyp;
        const int y = is_ci ? m - a.Kyp : m;
        if (y >= a.Ky) continue;
        float* out = is_ci ? a.ci : a.cr;
        if (t.band) {
          // column n = 8g + 2q (+1) of the tile: plane t.p + g / 8, band
          // column j = 64 grp + n % 64 of it, written at x = idx[plane][j]
          // (a column given twice in idx is computed twice, the same value
          // from the same operand, and stored twice)
#pragma unroll
          for (int g = 0; g < BN / 8; ++g) {
            const int pl = t.p + (g >> 3);
            if (pl >= a.P) continue;
            const long long* ip = a.idx + (size_t)pl * a.bw + BAND * t.grp +
                                  8 * (g & 7) + 2 * q;
            float* row = out + ((size_t)pl * a.Ky + y) * a.X;
            row[ip[0]] = acc[4 * g + 2 * half];
            row[ip[1]] = acc[4 * g + 2 * half + 1];
          }
        } else {
          const int n0 = t.nt * BN;
          uint32_t mw[BN / 32];  // the tile's band bits, word i: columns n0 + 32i..
#pragma unroll
          for (int i = 0; i < BN / 32; ++i) {
            const int w = n0 / 32 + i;
            mw[i] = a.mask && w < a.nw ? a.mask[(size_t)t.p * a.nw + w] : 0u;
          }
          float* row = out + ((size_t)t.p * a.Ky + y) * a.X;
#pragma unroll
          for (int g = 0; g < BN / 8; ++g) {
            const int x = n0 + 8 * g + 2 * q;
            const uint32_t bits = mw[g >> 2] >> (8 * (g & 3) + 2 * q);
            const bool ok0 = x < a.X && !(bits & 1u);
            const bool ok1 = x + 1 < a.X && !(bits & 2u);
            const float v0 = acc[4 * g + 2 * half];
            const float v1 = acc[4 * g + 2 * half + 1];
            if (ok0 && ok1 && a.vec2) {
              *reinterpret_cast<float2*>(row + x) = make_float2(v0, v1);
            } else {
              if (ok0) row[x] = v0;
              if (ok1) row[x + 1] = v1;
            }
          }
        }
      }
    }
  }
  // neither block leaves while its partner may still arrive on its
  // barriers
  cluster_sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (dims[0] contiguous; strides in values
// for dims 1..), boxes of `box`, 128-byte swizzle; out-of-bounds reads as 0
bool encode_bf16(EncodeTiled enc, CUtensorMap* map, const void* base,
                 int rank, const long long* dims, const long long* strides,
                 const int* box) {
  cuuint64_t gd[4], gs[3];
  cuuint32_t bx[4], el[4];
  for (int i = 0; i < rank; ++i) {
    gd[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    el[i] = 1;
    if (i > 0) gs[i - 1] = (cuuint64_t)strides[i - 1] * 2;
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), gd, gs, bx, el,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// K2's units: band units (pairs of 128-row blocks of T x the nb band
// groups x plane pairs), then, with `bulk`, bulk units (the pairs x planes
// x 128-column blocks); n_band receives the band units' count
long long stage2_units(int P, int X, int Kyp, int nb, int bulk,
                       long long* n_band) {
  const int n_mp = (2 * Kyp / BM + 1) / 2;
  *n_band = (long long)((P + BAND_PLANES - 1) / BAND_PLANES) * nb * n_mp;
  return *n_band +
         (bulk ? (long long)P * n_mp * ((X + BN - 1) / BN) : 0LL);
}

// The launch: clusters of CLUSTER blocks, as many as fit on the card at
// once (cudaOccupancyMaxActiveClusters) and no more than n_units.
// clusters_out (if given) receives that count; the kernel is not launched
// where args is null.
cudaError_t launch_stage2(int n_units, int* clusters_out, cudaStream_t stream,
                          const CUtensorMap* maps, const Args* args) {
  cudaError_t err = cudaFuncSetAttribute(
      corner_stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * (sms / CLUSTER));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)corner_stage2_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorInvalidConfiguration;
  if (clusters > n_units) clusters = n_units;
  if (clusters_out) *clusters_out = clusters;
  if (!args) return cudaSuccess;
  cfg.gridDim = dim3(CLUSTER * clusters);
  err = cudaLaunchKernelEx(&cfg, corner_stage2_kernel, maps[0], maps[1],
                           maps[2], maps[3], *args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes (steganosaurus_tpu_torch/_build.py). All
// pointers on the device that owns `stream`; each entry launches on
// `stream`, does not synchronise, and returns a CUDA error code (0 on
// success; cudaErrorInvalidValue for shapes it does not take).

// The prep: ar, ai (P, H, X) f32 contiguous -> ar16, ai16 (P, H, X) bf16
// rows ldk values apart (ldk >= X, ldk % 8 == 0, 16-byte-aligned bases;
// columns [X, ldk) are not written) and energy (P, X) f32.
extern "C" int corner_stage2_prep(const void* ar, const void* ai, void* ar16,
                                  void* ai16, void* energy, int P, int H,
                                  int X, int ldk, void* stream) {
  if (!ar || !ai || !ar16 || !ai16 || !energy || P <= 0 || P > 65535 ||
      H <= 0 || X <= 0 || ldk < X || ldk % 8 != 0 || !aligned16(ar16) ||
      !aligned16(ai16))
    return (int)cudaErrorInvalidValue;
  const int vec = X % 4 == 0 && aligned16(ar) && aligned16(ai);
  const dim3 grid((X + PREP_COLS - 1) / PREP_COLS, P);
  corner_stage2_prep_kernel<<<grid, PREP_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ar, (const float*)ai, (__nv_bfloat16*)ar16,
      (__nv_bfloat16*)ai16, (float*)energy, H, X, ldk, vec);
  return (int)cudaGetLastError();
}

// The prep's energies from K1's partials: part (ceil(P*H / 128) + P - 1, X)
// f64 (corner_stage1_wgmma with prep = 2) -> energy (P, X) f32.
extern "C" int corner_stage2_prep_reduce(const void* part, void* energy,
                                         int P, int H, int X, void* stream) {
  if (!part || !energy || P <= 0 || P > 65535 || H <= 0 || X <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((X + REDUCE_THREADS - 1) / REDUCE_THREADS, P);
  corner_stage2_prep_kernel_reduce<<<grid, REDUCE_THREADS, 0,
                                     (cudaStream_t)stream>>>(
      (const double*)part, (float*)energy, H, X);
  return (int)cudaGetLastError();
}

// The band operand of nb groups of 64 columns: ar, ai (P, H, X) f32
// contiguous, idx (P, 64 nb) int64 (each in [0, X)) -> g (6, P, H, 64 nb)
// bf16 and mask (P, ceil(X/32)) int32. nb >= 1.
extern "C" int corner_stage2_band(const void* ar, const void* ai,
                                  const void* idx, void* g, void* mask, int P,
                                  int H, int X, int nb, void* stream) {
  if (!ar || !ai || !idx || !g || !mask || P <= 0 || P > 65535 || H <= 0 ||
      X <= 0 || nb <= 0 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + BAND_ROWS - 1) / BAND_ROWS, P, nb);
  corner_stage2_band_kernel<<<grid, BAND_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ar, (const float*)ai, (const long long*)idx,
      (__nv_bfloat16*)g, (uint32_t*)mask, P, H, X, (X + 31) / 32, BAND * nb);
  return (int)cudaGetLastError();
}

// K2: t2 (3, 2Kyp, 2Hp) bf16 [T0, T1, T2] (corner_kernels.stage2_tables;
// Kyp, Hp multiples of 64, Kyp >= Ky, Hp >= H); ar16, ai16 (P, H, X) bf16,
// rows ldr / ldi values apart (multiples of 8, >= X), planes H rows apart;
// g (6, P, H, 64 nb) bf16 the band operand (corner_kernels.band_operand);
// mask (P, ceil(X/32)) int32 the band bits (band_mask); idx (P, 64 nb)
// int64 the band columns; cr, ci (P, Ky, X) f32 out. nb >= 0 groups of 64
// band columns: nb = 0 runs the bulk alone (g, mask and idx unused, may be
// null). bulk = 0 runs no bulk tile (ar16, ai16, ldr, ldi and mask unused,
// may be null): the caller's idx then holds every column. Where the card
// refuses the cluster launch, its error.
extern "C" int corner_stage2(const void* t2, const void* ar16, const void* ai16,
                             const void* g, const void* mask, const void* idx,
                             void* cr, void* ci, int P, int H, int X, int Ky,
                             int Kyp, int Hp, int ldr, int ldi, int nb,
                             int bulk, void* stream) {
  if (!t2 || !cr || !ci || P <= 0 || H <= 0 || X <= 0 || Ky <= 0 ||
      Kyp % 64 != 0 || Kyp < Ky || Hp % 64 != 0 || Hp < H || nb < 0 ||
      nb > 65535 || (bulk != 0 && bulk != 1) || (nb == 0 && !bulk) ||
      !aligned16(t2))
    return (int)cudaErrorInvalidValue;
  if (nb && (!g || !idx || !aligned16(g) || (bulk && !mask)))
    return (int)cudaErrorInvalidValue;
  if (bulk && (!ar16 || !ai16 || ldr < X || ldr % 8 != 0 || ldi < X ||
               ldi % 8 != 0 || !aligned16(ar16) || !aligned16(ai16)))
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;

  // T, ar16, ai16, the band operand; the maps of what a launch does not
  // read stay zero
  CUtensorMap maps[4] = {};
  const long long td[3] = {2LL * Hp, 2LL * Kyp, LEVELS};
  const long long ts[2] = {2LL * Hp, 4LL * Hp * Kyp};
  const int tbox[3] = {BK, BM, 1};
  const long long ad[3] = {X, H, P};
  const long long rs[2] = {ldr, (long long)H * ldr};
  const long long is[2] = {ldi, (long long)H * ldi};
  const int abox[3] = {64, BK, 1};
  const long long bw = (long long)BAND * nb;
  const long long gd[4] = {bw, H, P, 2 * LEVELS};
  const long long gs[3] = {bw, (long long)H * bw, (long long)P * H * bw};
  const int gbox[4] = {BAND, BK, BAND_PLANES, 1};
  if (!encode_bf16(enc, &maps[0], t2, 3, td, ts, tbox) ||
      (bulk && (!encode_bf16(enc, &maps[1], ar16, 3, ad, rs, abox) ||
                !encode_bf16(enc, &maps[2], ai16, 3, ad, is, abox))) ||
      (nb && !encode_bf16(enc, &maps[3], g, 4, gd, gs, gbox)))
    return (int)cudaErrorInvalidValue;

  Args a;
  a.mask = nb && bulk ? (const uint32_t*)mask : nullptr;
  a.idx = (const long long*)idx;
  a.cr = (float*)cr;
  a.ci = (float*)ci;
  a.P = P;
  a.Ky = Ky;
  a.Kyp = Kyp;
  a.X = X;
  a.nw = (X + 31) / 32;
  a.nh = Hp / BK;
  a.n_mt = 2 * Kyp / BM;
  a.n_mp = (a.n_mt + 1) / 2;
  a.n_nt = (X + BN - 1) / BN;
  a.nb = nb;
  a.bw = (int)bw;
  long long n_band = 0;
  const long long n_units = stage2_units(P, X, Kyp, nb, bulk, &n_band);
  if (n_units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.n_band = (int)n_band;
  a.n_units = (int)n_units;
  a.vec2 = X % 2 == 0 && (uintptr_t)cr % 8 == 0 && (uintptr_t)ci % 8 == 0;
  return (int)launch_stage2(a.n_units, nullptr, (cudaStream_t)stream, maps, &a);
}

// The grid corner_stage2 launches for these sizes, band groups and bulk, in
// blocks (clusters of 2), or minus a CUDA error code.
extern "C" int corner_stage2_grid(int P, int X, int Kyp, int nb, int bulk) {
  if (P <= 0 || X <= 0 || Kyp <= 0 || Kyp % 64 != 0 || nb < 0 ||
      (bulk != 0 && bulk != 1) || (nb == 0 && !bulk))
    return -(int)cudaErrorInvalidValue;
  long long n_band = 0;
  const long long n_units = stage2_units(P, X, Kyp, nb, bulk, &n_band);
  if (n_units > 0x7fffffffLL) return -(int)cudaErrorInvalidValue;
  int clusters = 0;
  const cudaError_t err =
      launch_stage2((int)n_units, &clusters, 0, nullptr, nullptr);
  return err == cudaSuccess ? CLUSTER * clusters : -(int)err;
}
