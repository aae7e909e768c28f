// The inverse corner DFT's x-stage with the u8 epilogue fused in (K4), for
// Hopper: a persistent, warp-specialised wgmma GEMM whose output is the u8
// stego itself.
//
// Replaces what XLA fuses for the TPU at the end of
// steganosaurus_tpu/parallel/batch.py:corner_embed_core: the x-stage of
// steganosaurus_tpu/spectral/corner.py:ifft_corner_real (its two dots and
// their difference, :545-546), its 1/(H*W) scale (:547), apply_center,
// floor(planes + t + 0.5), the clip to [0, 255], the u8 cast and, for layout
// "nhwc", the transpose (parallel/batch.py:622-627). For every row
// r = (p, h) of the P*H rows (p = 3b + c) and every column w < W:
//
//     acc = sum_k bf16(mr)[r,k] * exr[k,w] + sum_k bf16(mi)[r,k] * (-exi[k,w])
//     v   = (acc * inv) * ((-1)^(h+w) if center)       (inv = f32(1/(H*W)))
//     u8  = clamp(floor((v + planes[b,c,h,w]) + 0.5), 0, 255)
//
// with f32 accumulation of exact bf16 x bf16 products over K = 2*Kx. The
// epilogue rounds op by op as the plain version's eager ops do (built with
// -fmad=false, __fmul_rn / __fadd_rn), so the one difference from the plain
// version (two cuBLAS products, their difference, then K4e's arithmetic) is
// the order of the K-sum. A check mode stores the f32 v in place of u8.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s) at the main shape,
// 4K B=64 (P*H = 192*2160 rows, Kx = 1024, W = 3840): 2 * P*H * 2Kx * W =
// 6.52 TFLOP, 6.60 ms of tensor-core time, against 1.70 GB of bf16 A, 15.7
// MB of table, 1.59 GB of u8 planes read and 1.59 GB of u8 stego written,
// ~1.46 ms of HBM time. Compute-bound: 6.60 ms (6.714 with the epilogue's
// elementwise work, utils/cost.py), as K1. The unfused chain it replaced
// also wrote the f32 product t (6.37 GB) twice and read it three times.
//
// What held the first version back (11.1-11.7 ms at 4K B=64 on an H100
// at 700 W, tools/k4_ablation_torch.py): its epilogue ran in the consumer
// warpgroups after the tile's last wgmma, with nothing to overlap it
// (9.9-10.3 ms without it), each thread storing 4-byte words from
// registers; the cover words it needed sat in 32 registers a thread
// through the k-loop; and every 128 x 256 tile pulled its 1 MiB of table
// through L2 (~51 GB at 4K B=64). This design hands the stores to a store
// warp (6), brings the cover in by TMA (7), shares the table between two
// blocks (4) and takes the epilogue's conversions at one quarter-rate
// instruction an element in place of three (5): 9.5-9.8 ms against the
// first version's 11.3-11.5 in the same turns, bit-equal to it; one
// torch.mm of [mr, mi] with [exr; -exi] into f32 took 9.0-9.2.
//
// Design (the template is K1, csrc/corner_stage1_wgmma.cu; the store warp
// is K6's, csrc/corner_ifft_y.cu; the cluster K2's, csrc/corner_stage2.cu):
// 1. B is the cached table [exr; -exi] (2*Kxp x Wp, Kxp = Kx and Wp = W
//    rounded up to 64, zero padding; negating bf16 is exact), stored
//    transposed, (Wp, 2*Kxp), so that the contraction is the contiguous
//    axis: wgmma's K-major B, as K1's table, needing no transpose bit. Its
//    row stride is a multiple of 128 bytes at every W, 3839 included. A
//    stage's 256 table rows come as two 128-row TMA boxes.
// 2. A is read through two TMA descriptors, mr and mi (P*H, Kx) bf16, the
//    y-stage's output as it is: k-blocks below Kxp come from mr, the rest
//    from mi, so the concatenation [mr, mi] is never made. Columns past Kx
//    and rows past P*H load as zeros.
// 3. A ring of (A: 128 x 64 bf16, B: 256 x 64 bf16), both by TMA into
//    128-byte-swizzled shared memory, full/empty mbarriers; one producer
//    thread. Both operands of wgmma.m64n256k16 come from shared memory by
//    descriptor, so the consumers run no conversion: each keeps one
//    k-block's wgmmas in flight (wait_group 1) and frees the stage before
//    it. Two consumer warpgroups (setmaxnreg.inc 232) own 64 rows each of a
//    128 x 256 tile, 128 f32 accumulators a thread. 4 stages where the
//    tile is staged (3 ran no faster); 3 and no staging where it is not
//    (6), which leaves more of the SM's shared memory to the L1 that those
//    tiles' cover bytes go through (15.9 ms at 3839 against 19.9 with 4
//    stages and the staging reserved).
// 4. 2-CTA clusters share the table: the two blocks of a cluster take row
//    blocks 2m and 2m + 1 of one column block, and each loads one of a
//    stage's two table boxes with .multicast::cluster into both rings; a
//    stage is refilled only when both blocks' consumer warps have freed it
//    (each empty barrier counts 2 x 8 warps, the partner's arrivals by
//    mapa and mbarrier.arrive.shared::cluster). Where the row blocks are
//    odd, the last cluster's second block (a "ghost") loads its box for its
//    partner and computes nothing. Units (clusters' pairs of row blocks)
//    walk N-fastest, so A comes from HBM about once and the table stays in
//    L2; the grid is as many clusters as cudaOccupancyMaxActiveClusters
//    finds room for (132 blocks on an H100), launched by cudaLaunchKernelEx.
//    Without the cluster: 10.2-10.3 ms at 4K B=64, 12.8-13.5 NHWC, 17.7
//    at 3839.
// 5. The epilogue: each row's (p, h) is computed per row (a 128-row tile
//    spans two planes where H % 128 != 0), the sign (-1)^(h+w) folded into
//    the scale, the cover byte added, the u8 rounded. Lane pairs (q, q ^ 1)
//    swap halves with one shuffle, so that a thread holds four consecutive
//    columns of one row (the even lane row r, the odd lane row r + 8): one
//    4-byte cover word and one 4-byte u8 word. The odd lane takes the
//    column group g ^ 1 where the even lane takes g, so the 32 lanes' words
//    land in 32 distinct banks of the swizzled staging (rows r and r + 8
//    share their swizzle). Other widths (W % 4 != 0, or covers or output
//    off 4-byte alignment) take byte by byte.
// 6. NCHW u8 tiles whose rows TMA maps (W % 16 == 0, covers and output
//    16-byte aligned) are staged in shared memory and stored by a store
//    warp (the producer warpgroup's second warp) while the consumers go on
//    to their next tile's k-loop. Each consumer warpgroup writes its 64 x
//    256 u8 into its own 16 KB staging buffer (two 64 x 128 TMA boxes,
//    128-byte swizzled) and arrives on the buffer's FULL named barrier; the
//    store warp waits on it, stores the boxes by TMA (a 2-D u8 map over
//    (P*H, W): NCHW's planes flattened in A's row order; the map clips rows
//    >= P*H and columns >= W), waits until the stores have read the buffer
//    (cp.async.bulk.wait_group.read) and arrives on the buffer's EMPTY
//    mbarrier. The same TMA stores issued by the consumers themselves ran
//    no faster (-0.1 to +1.1 ms at 4K in four runs); a store warp's
//    plain stores and loads, where TMA cannot map the rows, ran slower than
//    the consumers' own stores (one warp's copies are latency-bound: 99 ms
//    at 3839), so those tiles keep the first version's stores from
//    registers, and their cover words come into 32 registers a thread
//    before the tile's k-loop (or bytes in the epilogue where W % 4 != 0).
// 7. The cover of a staged tile comes in by TMA through the same 2-D map
//    (over the planes) into the same staging buffer: the producer thread,
//    halfway through a tile's k-blocks, waits on the buffer's EMPTY (the
//    last tile's stores have read it), loads the tile's cover boxes and
//    signals a COVER mbarrier; the consumers wait on it before their
//    epilogue, read each cover word from the staging and write the u8 word
//    in its place. Loaded by the store warp after its stores instead, the
//    kernel took 41 ms at 4K.
// 8. NHWC: a pixel's three channels are rows H apart in A, so 128-row
//    tiles would leave each 3-byte pixel of the output to three blocks.
//    NHWC tiles instead load the three channel planes of 42 image rows as
//    one 4-D TMA box (126 rows; the last two of the 128 are neither loaded
//    nor stored), the consumers write the tile's u8 pixels into a 32 KB
//    staging tile and store its 42 rows of 768 contiguous bytes with
//    16-byte stores (two named barriers a tile order the staging between
//    the consumer warpgroups), as in the first version.
// 9. The f32 check mode stores from registers.
// 10. The ring, the cluster, the staging and the stores move data only:
//    each output element is one tile's sum over its k-blocks in the order
//    fixed by Kxp, the same wgmmas as the first version's, and the same
//    roundings in the epilogue, so the stego bytes and the check values
//    are bit-equal to it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;                 // rows per tile (two consumer warpgroups)
constexpr int BN = 256;                 // output columns per tile
constexpr int BK = 64;                  // contraction per stage (128 bytes of bf16)
constexpr int STAGES = 4;
// the NCHW tiles TMA does not map stage nothing, and a smaller ring leaves
// more of the SM's 256 KB of shared memory and L1 to the L1 that their
// cover's byte loads go through
constexpr int STAGES_PLAIN = 3;
constexpr int CLUSTER = 2;              // blocks sharing the table by multicast
constexpr int A_BYTES = BM * BK * 2;    // bf16
constexpr int B_BYTES = BN * BK * 2;    // bf16
constexpr int B_BOX_ROWS = BN / 2;      // a table box: 128 rows of the stage's 256
static_assert(CLUSTER == 1 || CLUSTER * B_BOX_ROWS == BN, "a block loads a box");
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr bool COVER_TMA = true;        // the staged cover by TMA (else in registers)
constexpr int U8_BOX = 128;             // a staging box: 64 rows x 128 u8 columns
constexpr int U8_BOX_BYTES = 64 * U8_BOX;
constexpr int STG_WG = 2 * U8_BOX_BYTES;     // a consumer warpgroup's staging
constexpr int STG_BYTES = 2 * STG_WG;        // both, or the NHWC tile
constexpr int EMPTY_ARRIVALS = 8 * CLUSTER;  // consumer warps of the cluster
constexpr int NTHREADS = 384;           // 2 consumer + 1 producer warpgroup
constexpr int PRODUCER = 256;           // the producer thread
constexpr int STORER = 288;             // the store warp: the producer warpgroup's second
constexpr int BAR_BYTES = (2 * STAGES + 4) * 8;
// the ring's depth and the staging of an instantiation, and its shared
// memory
__host__ __device__ constexpr int stages_of(bool staged) {
  return staged ? STAGES : STAGES_PLAIN;
}
__host__ __device__ constexpr int smem_of(bool staged) {
  return stages_of(staged) * STAGE_BYTES + (staged ? STG_BYTES : 0) +
         BAR_BYTES + 1024;
}
static_assert(smem_of(true) <= 232448 && smem_of(false) <= 232448,
              "shared memory");

// what the kernel stores
constexpr int OUT_NCHW = 0;    // u8 (B, 3, H, W)
constexpr int OUT_NHWC = 1;    // u8 (B, H, W, 3)
constexpr int OUT_VALUES = 2;  // f32 v (B, 3, H, W), the check mode

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
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
// every thread of the cluster's blocks: what any of them did before is
// seen after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Named barriers between the consumers and the store warp: FULL of
// consumer warpgroup wg's staging buffer (its 128 threads and the store
// warp's 32)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ int full_bar(int wg) { return 1 + wg; }
constexpr int HANDOFF = 128 + 32;

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

// a consumer warp frees a stage in every block of the cluster (each
// block's table boxes fill both blocks' rings)
__device__ __forceinline__ void release(uint64_t* bar, int rank) {
  mbar_arrive(bar);
  if (CLUSTER > 1) mbar_arrive_at(bar, rank ^ 1);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
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
__device__ __forceinline__ void tma_load_2d_mc(void* dst, const CUtensorMap* map,
                                               int c0, int c1, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// the box at shared address src into the map's box at (c0, c1)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// this thread's bulk stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, seen by the async proxy (TMA)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major operand in 128-byte-swizzled shared memory: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO), leading offset unused (LBO = 1).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// D (64 x 256, f32) += A (64 x 16, bf16, by descriptor) * B (16 x 256, bf16,
// by descriptor), both K-major; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k16_ss(float* d, uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The epilogue's arithmetic, as the plain version's eager ops round it:
// v = t * inv, negated where the centering sign is -1, then floor((v +
// p) + 0.5) clamped to [0, 255]. The sign is folded into the factor
// (round(t * -inv) = -round(t * inv) to nearest); p comes to f32 as 2^23 + p
// less 2^23, and floor, clamp and the cast are one cvt.rmi.u8 (it clamps
// to [0, 255] and takes NaN to 0, as fmin(fmax(NaN, 0), 255) does): the
// same bits with one quarter-rate conversion an element in place of three.

// the centering factor of a value in row h, column w
__device__ __forceinline__ float factor(float inv, bool center, int hw) {
  return center && (hw & 1) ? -inv : inv;
}

// byte j of the cover word w as an f32
__device__ __forceinline__ float cover_f32(uint32_t w, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + j)),
                   8388608.f);
}

// floor((v + p) + 0.5) clamped to [0, 255]
__device__ __forceinline__ uint32_t to_u8(float v, float p) {
  float x = __fadd_rn(v, p);
  x = __fadd_rn(x, 0.5f);
  uint16_t u;
  asm("cvt.rmi.u8.f32 %0, %1;\n" : "=h"(u) : "f"(x));
  return u;
}

// four u8 values (each in [0, 255]) as one little-endian word
__device__ __forceinline__ uint32_t pack4(uint32_t u0, uint32_t u1,
                                          uint32_t u2, uint32_t u3) {
  return __byte_perm(__byte_perm(u0, u1, 0x0040), __byte_perm(u2, u3, 0x0040),
                     0x5410);
}

// The byte of row lr (0..63), column c (0..255) of a consumer warpgroup's
// staging: box c / 128 (64 x 128 bytes), in it 16-byte chunk (c % 128) / 16
// of the row at chunk ((c % 128) / 16) ^ (lr % 8), the 128-byte swizzle of
// a TMA box
__device__ __forceinline__ uint32_t stg_offset(int lr, int c) {
  return (uint32_t)((c >> 7) * U8_BOX_BYTES + lr * U8_BOX +
                    ((((c & 127) >> 4) ^ (lr & 7)) << 4) + (c & 15));
}

// NHWC tiles (the layout's store goes through shared memory): the three
// channel planes of NH consecutive rows h of one image, one 4-D TMA box
// of 3 x NH rows (tile row r = c * NH + h - h0; rows 3NH..BM - 1 are not
// loaded and not stored), so every pixel of the tile has its three
// channels in the same block
constexpr int NH = 42;
static_assert(3 * NH <= BM, "an NHWC tile's rows");
static_assert(NH * BN * 3 <= STG_BYTES, "the NHWC staging tile");
constexpr int A_BYTES_NHWC = 3 * NH * BK * 2;

struct Args {
  const uint8_t* planes;
  void* out;
  int M, H, W, nkb, n_nt, n_mt, hblocks, n_units;
  float inv;
  int center, mode, vec;
};

// Where a block's tile lies: m0, its first flat row (p, h) of the P*H rows
// (NCHW tiles); b and h0, its image and first row (NHWC tiles); n0, its
// first column. A cluster's unit of work is CLUSTER row blocks of one
// column block (units N-fastest); block `rank` takes row block mt =
// CLUSTER * mp + rank, which lies past the last (a "ghost": it loads its
// boxes of the table for its partner and computes nothing) where the row
// blocks do not divide evenly.
struct Tile {
  bool ghost;
  int m0, b, h0, n0;
};

template <bool kNhwc>
__device__ __forceinline__ Tile tile_of(int unit, int rank, const Args& a) {
  Tile t;
  const int mp = unit / a.n_nt;
  t.n0 = (unit - mp * a.n_nt) * BN;
  const int mt = CLUSTER * mp + rank;
  t.ghost = mt >= a.n_mt;
  if (kNhwc) {
    t.b = mt / a.hblocks;
    t.h0 = (mt - t.b * a.hblocks) * NH;
    t.m0 = 0;
  } else {
    t.m0 = mt * BM;
    t.b = t.h0 = 0;
  }
  return t;
}

// One output row of a tile: whether it is stored, its image row h, the
// NCHW offset of its first pixel ((3b + c) * H + h) * W, and for NHWC
// tiles its channel c and its row in the tile's staging hl = h - h0.
struct Row {
  bool live;
  int h, c, hl;
  long long nchw;
};

template <bool kNhwc>
__device__ __forceinline__ Row row_of(const Tile& t, int r, const Args& a) {
  Row row;
  if (kNhwc) {
    row.c = r / NH;
    row.hl = r - row.c * NH;
    row.h = t.h0 + row.hl;
    row.live = row.c < 3 && row.h < a.H;
    row.nchw = ((long long)(3 * t.b + row.c) * a.H + row.h) * a.W;
  } else {
    const long long m = (long long)t.m0 + r;
    const int p = (int)(m / a.H);
    row.live = m < a.M;
    row.h = (int)(m - (long long)p * a.H);
    row.c = row.hl = 0;
    row.nchw = m * a.W;
  }
  return row;
}

// The vector epilogue's four values of column group g: lane pairs (q,
// q^1) swap halves, so that the even lane holds row r0's columns
// 8g+2q..+3 and the odd lane row r0+8's columns 8g'+2(q-1)..+3 of group
// g' = g ^ 1, each times its centering factor (fe for the even columns,
// fo for the odd ones)
__device__ __forceinline__ void pair4(const float* d, int g, int odd,
                                      float fe, float fo, float* v) {
  const int gx = g ^ 1;
  const float x0 = odd ? d[4 * g] : d[4 * gx + 2];
  const float x1 = odd ? d[4 * g + 1] : d[4 * gx + 3];
  const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
  const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
  v[0] = __fmul_rn(odd ? y0 : d[4 * g], fe);
  v[1] = __fmul_rn(odd ? y1 : d[4 * g + 1], fo);
  v[2] = __fmul_rn(odd ? d[4 * gx + 2] : y0, fe);
  v[3] = __fmul_rn(odd ? d[4 * gx + 3] : y1, fo);
}

// the scalar epilogue of one value at column w of row r: the f32 check
// value or the NCHW u8 to global memory, or the u8 into the NHWC staging
// tile
template <bool kNhwc>
__device__ __forceinline__ void store_one(const Row& r, int w, int n0,
                                          float acc, const Args& a,
                                          uint8_t* stg) {
  if (!r.live || w >= a.W) return;
  const float v = __fmul_rn(acc, factor(a.inv, a.center, r.h + w));
  if (a.mode == OUT_VALUES) {
    reinterpret_cast<float*>(a.out)[r.nchw + w] = v;
    return;
  }
  const uint8_t u = (uint8_t)to_u8(v, cover_f32(a.planes[r.nchw + w], 0));
  if (kNhwc)
    stg[(r.hl * BN + (w - n0)) * 3 + r.c] = u;
  else
    reinterpret_cast<uint8_t*>(a.out)[r.nchw + w] = u;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The NHWC staging tile of tile t to global memory by the consumers: NH
// rows of up to BN * 3 contiguous bytes, 16 bytes a thread at a time: one
// 16-byte store where whole and aligned (W % 16 == 0), 4-byte stores where
// the row is 4-byte aligned (W % 4 == 0), else byte stores
__device__ __forceinline__ void store_staged(const Tile& t, const uint8_t* stg,
                                             const Args& a) {
  constexpr int CHUNKS = BN * 3 / 16;
  const int row_bytes = min(BN, a.W - t.n0) * 3;
  uint8_t* out = reinterpret_cast<uint8_t*>(a.out);
  for (int i = threadIdx.x; i < NH * CHUNKS; i += 256) {
    const int hl = i / CHUNKS, off = (i - hl * CHUNKS) * 16;
    const int h = t.h0 + hl;
    if (h >= a.H || off >= row_bytes) continue;
    uint8_t* dst = out + ((long long)t.b * a.H + h) * a.W * 3 + t.n0 * 3 + off;
    const uint8_t* src = stg + hl * BN * 3 + off;
    const int n = min(16, row_bytes - off);
    const uintptr_t ad = reinterpret_cast<uintptr_t>(dst);
    if (n == 16 && (ad & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      int j = 0;
      if ((ad & 3) == 0)
        for (; j + 4 <= n; j += 4)
          *reinterpret_cast<uint32_t*>(dst + j) =
              *reinterpret_cast<const uint32_t*>(src + j);
      for (; j < n; ++j) dst[j] = src[j];
    }
  }
}

// kNhwc: NHWC tiles; kTma: NCHW u8 tiles whose cover and stego rows TMA
// maps (tm_p, tm_o: 2-D u8 maps over (P*H, W)), staged in shared memory
// and stored by the store warp; else NCHW tiles stored from registers (u8
// or the f32 check values)
template <bool kNhwc, bool kTma>
__device__ __forceinline__ void ifft_epilogue_body(
    const CUtensorMap* tm_r, const CUtensorMap* tm_i, const CUtensorMap* tm_b,
    const CUtensorMap* tm_p, const CUtensorMap* tm_o, const Args& a) {
  // 1024-byte aligned by an offset into the shared array, so that every
  // pointer below is known to address shared memory
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr int S = stages_of(kNhwc || kTma);
  uint8_t* smem_b = smem;                       // S x 32 KB
  uint8_t* smem_a = smem + S * B_BYTES;         // S x 16 KB
  uint8_t* stg = smem_a + S * A_BYTES;          // 32 KB staging (NHWC, kTma)
  uint64_t* full = reinterpret_cast<uint64_t*>(
      stg + (kNhwc || kTma ? STG_BYTES : 0));
  uint64_t* empty = full + S;
  uint64_t* cover_full = empty + S;  // [2]: the cover is in staging wg
  uint64_t* stg_empty = cover_full + 2;   // [2]: staging wg's stores read it

  const int rank = cluster_ctarank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                // the producer's expect_tx arrival
      mbar_init(&empty[s], EMPTY_ARRIVALS);  // one arrival per consumer warp
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&cover_full[w], 1);  // the producer's expect_tx arrival
      mbar_init(&stg_empty[w], 1);   // the store warp's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the partner's barriers exist before any load or arrival reaches them
  cluster_sync();

  // kTma: the cover comes into each consumer warpgroup's staging by the
  // producer's TMA loads (with COVER_TMA off, into registers as where TMA
  // does not map the rows), the stego leaves it by the store warp's TMA
  // stores
  constexpr bool cover_tma = kTma && COVER_TMA;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == PRODUCER) {
      // ---- producer: one thread keeps the ring full (and, cover_tma,
      // loads each tile's cover into the staging halfway through its
      // k-blocks) ----
      const int half = a.nkb / 2;  // k-blocks of mr, then as many of mi
      int stage = 0, n = 0;
      uint32_t phase = 0;
      for (int unit = cluster_id(); unit < a.n_units;
           unit += cluster_count()) {
        const Tile t = tile_of<kNhwc>(unit, rank, a);
        const uint32_t bytes =
            (t.ghost ? 0 : kNhwc ? A_BYTES_NHWC : A_BYTES) + B_BYTES;
        for (int kb = 0; kb < a.nkb; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], bytes);
          uint8_t* sb = smem_b + stage * B_BYTES;
          if (CLUSTER > 1)  // box `rank` of the table, into both rings
            tma_load_2d_mc(sb + rank * (B_BYTES / 2), tm_b, kb * BK,
                           t.n0 + rank * B_BOX_ROWS, &full[stage],
                           (1u << CLUSTER) - 1);
          else
            for (int j = 0; j < BN / B_BOX_ROWS; ++j)
              tma_load_2d(sb + j * (B_BYTES / 2), tm_b, kb * BK,
                          t.n0 + j * B_BOX_ROWS, &full[stage]);
          const CUtensorMap* tm = kb < half ? tm_r : tm_i;
          const int k0 = (kb < half ? kb : kb - half) * BK;
          if (t.ghost) {
          } else if (kNhwc) {
            tma_load_4d(smem_a + stage * A_BYTES, tm, k0, t.h0, 0, t.b,
                        &full[stage]);
          } else {
            tma_load_2d(smem_a + stage * A_BYTES, tm, k0, t.m0, &full[stage]);
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
          if (cover_tma && !t.ghost && kb == half) {
            for (int w = 0; w < 2; ++w) {
              // the boxes that hold a row below P*H (each a column below W)
              const int m0 = t.m0 + 64 * w;
              const int boxes =
                  m0 >= a.M ? 0 : (t.n0 + U8_BOX < a.W ? 2 : 1);
              mbar_wait(&stg_empty[w], (n & 1) ^ 1);
              mbar_expect_tx(&cover_full[w], boxes * U8_BOX_BYTES);
              for (int j = 0; j < boxes; ++j)
                tma_load_2d(stg + w * STG_WG + j * U8_BOX_BYTES, tm_p,
                            t.n0 + U8_BOX * j, m0, &cover_full[w]);
            }
          }
        }
        if (!t.ghost) ++n;
      }
    } else if (kTma && threadIdx.x / 32 == STORER / 32) {
      // ---- the store warp: each staged tile half to the output by TMA ----
      const int lane = threadIdx.x & 31;
      for (int unit = cluster_id(); unit < a.n_units;
           unit += cluster_count()) {
        const Tile t = tile_of<kNhwc>(unit, rank, a);
        if (t.ghost) continue;
        for (int w = 0; w < 2; ++w) {
          named_sync(full_bar(w), HANDOFF);
          const int m0 = t.m0 + 64 * w;
          if (lane == 0) {
            const uint32_t sw = smem_u32(stg) + w * STG_WG;
            for (int j = 0; j < 2 && m0 < a.M && t.n0 + U8_BOX * j < a.W;
                 ++j)
              tma_store_2d(tm_o, sw + j * U8_BOX_BYTES, t.n0 + U8_BOX * j,
                           m0);
            bulk_commit();
            bulk_wait_read();
            mbar_arrive(&stg_empty[w]);
          }
        }
      }
      if (lane == 0) bulk_wait();
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups: 64 rows x 256 columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int q = lane & 3;
    const int odd = q & 1;  // the vector epilogue's row: r0 + 8 if odd
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);  // tile row; r0 + 8 too
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0, n = 0;
    uint32_t phase = 0;
    // the cover words in registers (the tiles whose cover is not staged)
    const bool prefetch = !cover_tma && a.vec && a.mode != OUT_VALUES;
    for (int unit = cluster_id(); unit < a.n_units; unit += cluster_count()) {
      const Tile t = tile_of<kNhwc>(unit, rank, a);
      if (t.ghost) {
        // nothing reads the stages: free each once it has landed
        for (int kb = 0; kb < a.nkb; ++kb) {
          mbar_wait(&full[stage], phase);
          __syncwarp();
          if (lane == 0) release(&empty[stage], rank);
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
        continue;
      }
      const int n0 = t.n0;
      // the vector epilogue's row; and its cover words where they are not
      // staged, loaded before the k-loop so that their latency hides
      // behind it (32 registers a thread): word g holds the columns
      // 8 (g ^ odd) + 4 (q / 2).. of the lane's row
      const Row rv = row_of<kNhwc>(t, r0 + 8 * odd, a);
      uint32_t cover[32];
#pragma unroll
      for (int g = 0; g < 32; ++g) {
        const int w = n0 + 8 * (g ^ odd) + 4 * (q >> 1);
        cover[g] = prefetch && rv.live && w < a.W
                       ? *reinterpret_cast<const uint32_t*>(a.planes +
                                                            rv.nchw + w)
                       : 0u;
      }
      int prev = -1;
      // the accumulators are touched by nothing but wgmma from here to the
      // wait_group 0 below (a read in between would make ptxas serialise
      // the wgmmas)
      fence_acc(d);
      for (int kb = 0; kb < a.nkb; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint64_t da =
            sw128_desc(smem_a + stage * A_BYTES + wg * 64 * 128);
        const uint64_t db = sw128_desc(smem_b + stage * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)  // k16 step s: 32 bytes on along each row
          wgmma_m64n256k16_ss(d, da + 2 * s, db + 2 * s,
                              (kb > 0 || s > 0) ? 1u : 0u);
        wgmma_commit();
        wgmma_wait1();  // the k-block before this one is done: free its stage
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) release(&empty[prev], rank);
        }
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait0();
      fence_acc(d);
      __syncwarp();
      if (lane == 0) release(&empty[prev], rank);

      // ---- epilogue: scale, sign, + cover, round, clamp; w is even (n0
      // is), so the centering sign of w and w + 2 is (-1)^h, of w + 1 and
      // w + 3 its opposite ----
      const float fe = factor(a.inv, a.center, rv.h);
      const float fo = factor(a.inv, a.center, rv.h + 1);
      if (kTma) {
        // each word of the warpgroup's staging: the cover in, the stego
        // out (rows past P*H and columns past W are computed and not
        // stored)
        if (cover_tma)
          mbar_wait(&cover_full[wg], n & 1);  // the cover, in the staging
        else  // the store warp has read the last tile's staging
          mbar_wait(&stg_empty[wg], (n & 1) ^ 1);
        uint8_t* my_stg = stg + wg * STG_WG;
        const int lv = r0 - wg * 64 + 8 * odd;  // the lane's staged row
        // all 32 cover words first (their loads in flight together), then
        // the stego words in their places
        uint32_t cw[32];
#pragma unroll
        for (int g = 0; g < 32; ++g)
          cw[g] = cover_tma ? *reinterpret_cast<const uint32_t*>(
                                  my_stg + stg_offset(lv, 8 * (g ^ odd) +
                                                              4 * (q >> 1)))
                            : cover[g];
#pragma unroll
        for (int g = 0; g < 32; ++g) {
          float v[4];
          pair4(d, g, odd, fe, fo, v);
          *reinterpret_cast<uint32_t*>(my_stg + stg_offset(
              lv, 8 * (g ^ odd) + 4 * (q >> 1))) =
              pack4(to_u8(v[0], cover_f32(cw[g], 0)),
                    to_u8(v[1], cover_f32(cw[g], 1)),
                    to_u8(v[2], cover_f32(cw[g], 2)),
                    to_u8(v[3], cover_f32(cw[g], 3)));
        }
        // the staging is whole: the store warp takes it from here
        fence_async_shared();
        named_arrive(full_bar(wg), HANDOFF);
        ++n;
        continue;
      }
      if (kNhwc) consumers_sync();  // the last tile's staging is stored
      if (a.vec) {
#pragma unroll
        for (int g = 0; g < 32; ++g) {
          float v[4];
          pair4(d, g, odd, fe, fo, v);
          const int c = 8 * (g ^ odd) + 4 * (q >> 1);  // tile column
          const int w = n0 + c;
          if (!rv.live || w >= a.W) continue;  // W % 4 == 0: all four or none
          if (a.mode == OUT_VALUES) {
            *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.out) +
                                       rv.nchw + w) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else if (kNhwc) {
            uint8_t* s = stg + (rv.hl * BN + c) * 3 + rv.c;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              s[3 * j] = (uint8_t)to_u8(v[j], cover_f32(cover[g], j));
          } else {
            *reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(a.out) +
                                         rv.nchw + w) =
                pack4(to_u8(v[0], cover_f32(cover[g], 0)),
                      to_u8(v[1], cover_f32(cover[g], 1)),
                      to_u8(v[2], cover_f32(cover[g], 2)),
                      to_u8(v[3], cover_f32(cover[g], 3)));
          }
        }
      } else {
        const Row rA = row_of<kNhwc>(t, r0, a);
        const Row rB = row_of<kNhwc>(t, r0 + 8, a);
#pragma unroll
        for (int g = 0; g < 32; ++g) {
          const int w = n0 + 8 * g + 2 * q;
          store_one<kNhwc>(rA, w, n0, d[4 * g], a, stg);
          store_one<kNhwc>(rA, w + 1, n0, d[4 * g + 1], a, stg);
          store_one<kNhwc>(rB, w, n0, d[4 * g + 2], a, stg);
          store_one<kNhwc>(rB, w + 1, n0, d[4 * g + 3], a, stg);
        }
      }
      if (kNhwc) {
        consumers_sync();  // the staging tile is whole
        store_staged(t, stg, a);
      }
      ++n;
    }
  }
  // no block leaves while its partner may still arrive on its barriers or
  // multicast into its ring
  cluster_sync();
}

// The three instantiations, under names of their own: NCHW tiles (kTma:
// cover and stego by TMA through the staging; else stored from
// registers, or the f32 check values), and NHWC tiles
template <bool kTma>
__global__ void __launch_bounds__(NTHREADS, 1)
corner_ifft_nchw_kernel(const __grid_constant__ CUtensorMap tm_r,
                        const __grid_constant__ CUtensorMap tm_i,
                        const __grid_constant__ CUtensorMap tm_b,
                        const __grid_constant__ CUtensorMap tm_p,
                        const __grid_constant__ CUtensorMap tm_o,
                        const Args a) {
  ifft_epilogue_body<false, kTma>(&tm_r, &tm_i, &tm_b, &tm_p, &tm_o, a);
}

__global__ void __launch_bounds__(NTHREADS, 1)
corner_ifft_nhwc_kernel(const __grid_constant__ CUtensorMap tm_r,
                        const __grid_constant__ CUtensorMap tm_i,
                        const __grid_constant__ CUtensorMap tm_b,
                        const __grid_constant__ CUtensorMap tm_p,
                        const __grid_constant__ CUtensorMap tm_o,
                        const Args a) {
  ifft_epilogue_body<true, false>(&tm_r, &tm_i, &tm_b, &tm_p, &tm_o, a);
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

// A tensor map of `rank` dims of `bytes`-byte elements (dims[0]
// contiguous; strides in elements for dims 1..), boxes of `box`, 128-byte
// swizzle; out-of-bounds reads as 0, out-of-bounds stores are dropped
bool encode(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type,
            int bytes, const void* base, int rank, const long long* dims,
            const long long* strides, const int* box) {
  cuuint64_t gd[4], gs[3];
  cuuint32_t bx[4], el[4];
  for (int i = 0; i < rank; ++i) {
    gd[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    el[i] = 1;
    if (i > 0) gs[i - 1] = (cuuint64_t)strides[i - 1] * bytes;
  }
  return enc(map, type, rank, const_cast<void*>(base), gd, gs, bx, el,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

typedef void (*Kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                       const CUtensorMap, const CUtensorMap, const Args);

// The row blocks of B images of H x W in the layout's tiles, and the units
// of work (clusters of CLUSTER row blocks by the column blocks)
void walk(int B, int H, int W, bool nhwc, Args* a, long long* n_units) {
  a->n_nt = (W + BN - 1) / BN;
  a->hblocks = (H + NH - 1) / NH;
  const long long n_mt =
      nhwc ? (long long)B * a->hblocks : (3LL * B * H + BM - 1) / BM;
  a->n_mt = n_mt > 0x7fffffffLL ? 0 : (int)n_mt;
  *n_units = (n_mt + CLUSTER - 1) / CLUSTER * a->n_nt;
}

// The launch: clusters of CLUSTER blocks, as many as fit on the card at
// once (cudaOccupancyMaxActiveClusters) and no more than n_units.
// clusters_out (if given) receives that count; the kernel is not launched
// where args is null.
cudaError_t launch_k4(Kernel kernel, int smem, int n_units, int* clusters_out,
                      cudaStream_t stream, const CUtensorMap* maps,
                      const Args* args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorInvalidConfiguration;
  if (clusters > n_units) clusters = n_units;
  if (clusters_out) *clusters_out = clusters;
  if (!args) return cudaSuccess;
  cfg.gridDim = dim3(CLUSTER * clusters);
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3],
                           maps[4], *args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes (steganosaurus_tpu_torch/_build.py).
// mr, mi: (P*H, Kx) bf16 rows `lda` values apart (lda >= Kx, lda % 8 == 0,
// 16-byte-aligned bases), the y-stage's output; tab: (Wp, 2*Kxp) bf16, the
// transposed table [exr; -exi] of write_kernels.ifft_x_table (Kxp and Wp
// multiples of 64, Kxp >= Kx, Wp >= W); planes: (B, 3, H, W) u8 covers, P =
// 3B; out: u8 (B, 3, H, W) for mode 0, u8 (B, H, W, 3) for mode 1, f32
// (B, 3, H, W) v for mode 2 (the check mode). inv = f32(1/(H*W)). All
// contiguous, on the device that owns `stream`. Launches on `stream`, does
// not synchronise, and returns a CUDA error code (0 on success;
// cudaErrorInvalidValue for shapes it does not take).
extern "C" int corner_ifft_epilogue(const void* mr, const void* mi,
                                    const void* tab, const void* planes,
                                    void* out, int B, int H, int W, int Kx,
                                    int lda, int Kxp, int Wp, float inv,
                                    int center, int mode, void* stream) {
  if (!mr || !mi || !tab || !planes || !out || B <= 0 || H <= 0 || W <= 0 ||
      Kx <= 0 || lda < Kx || lda % 8 != 0 || Kxp % 64 != 0 || Kxp < Kx ||
      Wp % 64 != 0 || Wp < W || mode < 0 || mode > 2 || !aligned16(mr) ||
      !aligned16(mi) || !aligned16(tab))
    return (int)cudaErrorInvalidValue;
  const long long M = 3LL * B * H;
  if (M > 0x7fffffffLL - BM) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;

  // A: NCHW tiles read 128 flat rows of (P*H, Kx); NHWC tiles the box
  // (64, NH, 3, 1) of (Kx, H, 3, B); B: 128-row boxes of (Wp, 2Kxp); the
  // cover and the stego (kTma): 64 x 128 boxes of (P*H, W) u8
  const bool nhwc = mode == OUT_NHWC;
  const bool tma = mode == OUT_NCHW && W % 16 == 0 && aligned16(planes) &&
                   aligned16(out);
  const CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long a2[2] = {Kx, M}, s2[1] = {lda};
  const long long a4[4] = {Kx, H, 3, B};
  const long long s4[3] = {lda, (long long)H * lda, 3LL * H * lda};
  const int box2[2] = {BK, BM}, box4[4] = {BK, NH, 3, 1};
  const long long bd[2] = {2LL * Kxp, Wp}, bs[1] = {2LL * Kxp};
  const int bbox[2] = {BK, B_BOX_ROWS};
  const long long ud[2] = {W, M}, us[1] = {W};
  const int ubox[2] = {U8_BOX, 64};
  CUtensorMap maps[5] = {};  // mr, mi, the table, the cover, the stego
  bool ok = nhwc ? encode(enc, &maps[0], BF16, 2, mr, 4, a4, s4, box4) &&
                       encode(enc, &maps[1], BF16, 2, mi, 4, a4, s4, box4)
                 : encode(enc, &maps[0], BF16, 2, mr, 2, a2, s2, box2) &&
                       encode(enc, &maps[1], BF16, 2, mi, 2, a2, s2, box2);
  ok = ok && encode(enc, &maps[2], BF16, 2, tab, 2, bd, bs, bbox);
  if (tma)
    ok = ok &&
         encode(enc, &maps[3], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, planes, 2, ud,
                us, ubox) &&
         encode(enc, &maps[4], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, out, 2, ud,
                us, ubox);
  if (!ok) return (int)cudaErrorInvalidValue;

  Args a;
  a.planes = (const uint8_t*)planes;
  a.out = out;
  a.M = (int)M;
  a.H = H;
  a.W = W;
  a.nkb = 2 * (Kxp / BK);
  long long n_units = 0;
  walk(B, H, W, nhwc, &a, &n_units);
  if (a.n_mt == 0 || n_units > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.n_units = (int)n_units;
  a.inv = inv;
  a.center = center ? 1 : 0;
  a.mode = mode;
  const int align = mode == OUT_VALUES ? 16 : 4;
  a.vec = (W % 4 == 0) && ((uintptr_t)out % align == 0) &&
          ((uintptr_t)planes % 4 == 0);
  Kernel kernel = corner_ifft_nhwc_kernel;
  if (!nhwc)
    kernel = tma ? &corner_ifft_nchw_kernel<true>
                 : &corner_ifft_nchw_kernel<false>;
  return (int)launch_k4(kernel, smem_of(nhwc || tma), a.n_units, nullptr,
                        (cudaStream_t)stream, maps, &a);
}

// The grid corner_ifft_epilogue launches for B images of H x W in `mode`,
// in blocks (clusters of CLUSTER), or minus a CUDA error code.
extern "C" int corner_ifft_epilogue_grid(int B, int H, int W, int mode) {
  if (B <= 0 || H <= 0 || W <= 0 || mode < 0 || mode > 2 ||
      3LL * B * H > 0x7fffffffLL - BM)
    return -(int)cudaErrorInvalidValue;
  Args a;
  long long n_units = 0;
  walk(B, H, W, mode == OUT_NHWC, &a, &n_units);
  if (n_units > 0x7fffffffLL) return -(int)cudaErrorInvalidValue;
  int clusters = 0;
  const Kernel kernel = mode == OUT_NHWC
                            ? (Kernel)corner_ifft_nhwc_kernel
                            : (Kernel)&corner_ifft_nchw_kernel<true>;
  const cudaError_t err = launch_k4(kernel, smem_of(true), (int)n_units,
                                    &clusters, 0, nullptr, nullptr);
  return err == cudaSuccess ? CLUSTER * clusters : -(int)err;
}
