// The inverse corner DFT's y-stage under mix_adaptive (K6), for Hopper: a
// persistent, warp-specialised wgmma GEMM that writes the bf16 operands of
// the x-stage (K4, csrc/corner_ifft_epilogue.cu) directly.
//
// Replaces the y-stage of steganosaurus_tpu/spectral/corner.py:514
// ifft_corner_real (its four dots, their difference and sum, :532-539),
// which XLA fuses for the TPU. With the conjugated delta (dcr, dci) =
// (Re D, -Im D), each (Ky, Kx) bf16 per plane p (K3 stores exactly these
// under mix_adaptive), and the bf16 y tables (eyr, eyi) (Ky, H):
//
//     mr = eyr^T . dcr - eyi^T . dci,   mi = eyr^T . dci + eyi^T . dcr
//
// (contract y), written as one real GEMM per plane,
//
//     [mr; mi] (2H x Kx) = A (2H x 2Ky) . [dcr; dci] (2Ky x Kx),
//     A = [[eyr^T, -eyi^T], [eyi^T, eyr^T]],
//
// the exact bf16 x bf16 products summed in f32 and rounded to bf16 to
// nearest even (__float2bfloat16_rn, bit-equal to .to(torch.bfloat16)).
// The outputs mr16, mi16, each (P*H, Kx) bf16, are what K4 reads. A check
// mode stores the f32 sums in place of the bf16 values.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s) at the main shape,
// 4K B=64 (P = 192, H = 2160, Ky = Kx = 1024): 2 * P * 2H * 2Ky * Kx =
// 3.48 TFLOP, 3.52 ms of tensor-core time, against 0.81 GB of bf16 delta,
// 17.8 MB of table and 1.70 GB of bf16 output, ~0.75 ms of HBM time.
// Operations-bound. The eager chain it replaces (four cuBLAS products into
// f32, a difference, a sum, two casts) wrote four f32 (P, H, Kx) products
// of 1.70 GB each and read them back.
//
// What held the first version back (tools/k6_ablation_torch.py on an H100):
// its epilogue stored from registers after the last k-block's wait, with
// nothing to overlap it, each warp's bf16x2 stores filling half of every
// 32-byte sector (~1.4 ms of ~5.9 at 4K B=64); and each 128 x 256 x 2Kyp
// tile pulled its table rows and its plane's delta through L2 (~39 GB at
// 4K B=64, ~1 ms). This design overlaps the epilogue (6); the operand
// traffic stays (3).
//
// Design (the mainloop is K4's; B's layout is K2's, csrc/corner_stage2.cu):
// 1. A is the cached table (corner.ifft_y_table), (2Hp, 2Kyp) bf16 with Hp
//    and Kyp rounded up to 64 and zeros in the padding: rows [0, H) give
//    mr, rows [Hp, Hp + H) mi; columns [0, Ky) meet dcr's rows y, columns
//    [Kyp, Kyp + Ky) dci's. Negating bf16 is exact, so its terms are the
//    very values of the eager chain's products. K-major (the contraction
//    contiguous): 128 x 64 boxes by TMA into 128-byte-swizzled shared
//    memory, as K4's operands. 2Hp is a multiple of the 128-row tile, so a
//    tile never spans two planes' outputs; Hp is a multiple of 64, so each
//    consumer warpgroup's 64 rows lie wholly in mr or in mi.
// 2. B is the plane's (dcr, dci), x contiguous: an MN-major wgmma operand
//    (the transpose bit; 64-column atoms 8 KB apart as LBO, 8-row groups
//    1 KB apart as SBO), four 64 x 64 boxes a stage from one of two 3-D
//    TMA maps (x, y, p), dcr for k-blocks below Kyp/64 and dci above. Rows
//    past Ky load as zeros, so no plane reads its neighbour's rows; boxes
//    wholly past Kx are not loaded (they meet only output columns that are
//    not stored).
// 3. As many persistent blocks as the card has SMs (no more than tiles)
//    walk the (nt, mt, p) tiles nt fastest, then mt, then p: plane by
//    plane, so a plane's 4 MB of delta stays in L2 with the table. Pairs
//    of blocks in 2-CTA clusters, each loading half of the delta boxes
//    for both by TMA multicast (B is 2/3 of a stage's bytes), ran no
//    faster in turns with this grid (median 4.82 ms against 4.56 at 4K
//    B=64 on an H100, tools/k6_ablation_torch.py), so they are not used.
// 4. A 3-stage ring of (A 16 KB, B 32 KB), full/empty mbarriers, one
//    producer thread; two consumer warpgroups (setmaxnreg.inc 232) issue
//    wgmma.m64n256k16 over 64 rows each of the 128 x 256 tile, keep one
//    k-block's wgmmas in flight (wait_group 1) and free the stage before
//    it. Three stages ran as fast as four; the fourth's 48 KB hold the
//    epilogue's staging.
// 5. No promotion sum (K2 has one): the result is rounded to bf16 at once,
//    and K4 sums the same contraction length (2Kxp = 2048 at 4K) on the
//    tensor cores within 3.5e-6 of max|plain| of its plain version.
// 6. The epilogue overlaps the next tile's main loop. Each consumer
//    warpgroup rounds its 64 x 256 f32 sums to bf16 (__float2bfloat16_rn,
//    bit-equal to .to(torch.bfloat16)) into its own 32 KB staging buffer
//    (four 64 x 64 boxes, 128-byte swizzled, so a warp's 4-byte stores hit
//    32 banks), arrives on the buffer's FULL named barrier and goes on to
//    its next tile's k-loop. The store warp (the producer warpgroup's
//    second warp) waits on FULL, and one of its threads stores the boxes
//    by TMA (cp.async.bulk.tensor, a 3-D map (x, h, p) of mr16 or mi16,
//    which clips rows h >= H and columns x >= Kx), waits until the stores
//    have read the buffer (cp.async.bulk.wait_group.read) and arrives on
//    its EMPTY barrier, on which the warpgroup waits before it writes the
//    buffer again, a tile later. Issued by the consumer warpgroup itself,
//    the same TMA stores ran no faster than stores from registers: the
//    warpgroup's next k-loop waited behind them. The f32 check mode
//    (values), and outputs whose rows are not whole 16-byte words (Kx % 8
//    != 0) or not 16-byte aligned, keep the first version's stores from
//    registers (an instantiation without the store warp: two consecutive
//    columns a thread, padding rows and columns past Kx skipped).
// 7. The ring and the stores move data only: each output
//    element is one tile's sum over its k-blocks in an order fixed by Kyp,
//    the same wgmmas as the first version's, so outputs are bit-equal to
//    it, and shards and runs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // rows of A per tile (two consumer warpgroups)
constexpr int BN = 256;                 // output columns per tile
constexpr int BK = 64;                  // contraction per stage (128 bytes of bf16)
constexpr int STAGES = 3;
constexpr int BOX = 64;                 // one B box: 64 columns x BK rows
constexpr int BOXES = BN / BOX;
constexpr int A_BYTES = BM * BK * 2;    // bf16
constexpr int BOX_BYTES = BOX * BK * 2; // bf16
constexpr int B_BYTES = BOXES * BOX_BYTES;
constexpr bool STAGED = true;           // bf16 stores staged in shared memory, stored by TMA
constexpr int OUT_BOX_BYTES = 64 * 64 * 2;   // one 64 x 64 bf16 TMA store box
constexpr int C_BYTES = STAGED ? BOXES * OUT_BOX_BYTES : 0;  // per consumer warpgroup
constexpr int NTHREADS = 384;           // 2 consumer + 1 producer warpgroup
constexpr int STORER = 288;             // the store warp: the producer warpgroup's second
constexpr int HANDOFF = 128 + 32;       // threads at a staging buffer's named barriers
constexpr int BAR_BYTES = 2 * STAGES * 8;
constexpr int SMEM =
    STAGES * (A_BYTES + B_BYTES) + 2 * C_BYTES + BAR_BYTES + 1024;
static_assert(SMEM <= 232448, "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Named barriers of consumer warpgroup wg's staging buffer, each between
// its 128 threads and the store warp: FULL (the tile's values are in it)
// and EMPTY (the store warp's TMA stores have read them)
__device__ __forceinline__ int full_bar(int wg) { return 1 + wg; }
__device__ __forceinline__ int empty_bar(int wg) { return 3 + wg; }
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(HANDOFF) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(HANDOFF) : "memory");
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

// the box at shared address src into the map's box at (c0, c1, c2)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, __nv_bfloat162 v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&v))
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

// K-major operand (A) in 128-byte-swizzled shared memory: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), leading offset unused.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// MN-major operand (B: x contiguous) in 128-byte-swizzled shared memory, as
// BOXES TMA boxes of BK rows y x 64 columns x: a row of 128 bytes holds 64
// columns of one y; 8-row groups of y 1024 bytes apart (SBO); the 64-column
// atoms BOX_BYTES apart (LBO).
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(BOX_BYTES >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

// D (64 x 256, f32) += A (64 x 16, bf16, K-major) * B (16 x 256, bf16,
// MN-major: the transpose bit set); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k16_tb(float* d, uint64_t desc_a,
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
      "%128, %129, p, 1, 1, 0, 1;\n"
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

// Where a tile lies: plane p, row block mt of A's 2Hp rows, column block
// nt of the Kx columns (nt fastest, then mt, then p).
struct Tile {
  int p, mt, nt;
};

__device__ __forceinline__ Tile tile_of(int tile, int n_mt, int n_nt) {
  Tile t;
  t.nt = tile % n_nt;
  const int u = tile / n_nt;
  t.mt = u % n_mt;
  t.p = u / n_mt;
  return t;
}

struct Args {
  void* mr;    // (P*H, Kx): bf16, or f32 in the check mode
  void* mi;
  int P, H, Hp, Kx, nky, n_mt, n_nt, n_tiles, values, vec2;
};

// the f32 sums v0, v1 of columns x, x + 1 of output row `row` (P*H rows of
// Kx), stored as bf16 (rounded to nearest even) or, in the check mode, f32
__device__ __forceinline__ void store_pair(const Args& a, void* out,
                                           long long row, int x, float v0,
                                           float v1) {
  const long long o = row * a.Kx + x;
  const bool ok1 = x + 1 < a.Kx;
  if (a.values) {
    float* f = reinterpret_cast<float*>(out) + o;
    if (ok1 && a.vec2) {
      *reinterpret_cast<float2*>(f) = make_float2(v0, v1);
    } else {
      f[0] = v0;
      if (ok1) f[1] = v1;
    }
    return;
  }
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(out) + o;
  if (ok1 && a.vec2) {
    *reinterpret_cast<__nv_bfloat162*>(h) = __floats2bfloat162_rn(v0, v1);
  } else {
    h[0] = __float2bfloat16_rn(v0);
    if (ok1) h[1] = __float2bfloat16_rn(v1);
  }
}

// kStaged: the bf16 stores through shared memory and TMA (the main path);
// else the stores from registers (the check mode, unaligned outputs)
template <bool kStaged>
__global__ void __launch_bounds__(NTHREADS, 1)
corner_ifft_y_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_r,
                     const __grid_constant__ CUtensorMap tm_i,
                     const __grid_constant__ CUtensorMap tm_mr,
                     const __grid_constant__ CUtensorMap tm_mi,
                     const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* smem_b = smem;                       // STAGES x 32 KB
  uint8_t* smem_a = smem + STAGES * B_BYTES;    // STAGES x 16 KB
  uint8_t* smem_c = smem_a + STAGES * A_BYTES;  // 2 x 32 KB staging
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_c + 2 * C_BYTES);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nkb = 2 * a.nky;  // k-blocks of dcr, then as many of dci
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const Tile t = tile_of(tile, a.n_mt, a.n_nt);
        const int n0 = t.nt * BN;
        // the B boxes that hold a column below Kx (the others meet only
        // output columns that are not stored)
        const int boxes = min(BOXES, (a.Kx - n0 + BOX - 1) / BOX);
        const uint32_t bytes = A_BYTES + boxes * BOX_BYTES;
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], bytes);
          tma_load_2d(smem_a + stage * A_BYTES, &tm_a, kb * BK, t.mt * BM,
                      &full[stage]);
          const CUtensorMap* tm = kb < a.nky ? &tm_r : &tm_i;
          const int y0 = (kb < a.nky ? kb : kb - a.nky) * BK;
          uint8_t* sb = smem_b + stage * B_BYTES;
          for (int j = 0; j < boxes; ++j)
            tma_load_3d(sb + j * BOX_BYTES, tm, n0 + BOX * j, y0, t.p,
                        &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (kStaged && threadIdx.x / 32 == STORER / 32) {
      // ---- the store warp: each staged 64 x 256 tile half to mr16 / mi16
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const Tile t = tile_of(tile, a.n_mt, a.n_nt);
        const int n0 = t.nt * BN;
        const int boxes = min(BOXES, (a.Kx - n0 + BOX - 1) / BOX);
        for (int w = 0; w < 2; ++w) {
          named_sync(full_bar(w));
          if (threadIdx.x == STORER) {
            // warpgroup w's 64 rows of A: rows h0.. of mr, or of mi
            const int m0 = t.mt * BM + w * 64;
            const bool is_mi = m0 >= a.Hp;
            const int h0 = is_mi ? m0 - a.Hp : m0;
            const uint32_t sc = smem_u32(smem_c) + w * C_BYTES;
            const CUtensorMap* tm = is_mi ? &tm_mi : &tm_mr;
            for (int j = 0; j < boxes; ++j)
              tma_store_3d(tm, sc + j * OUT_BOX_BYTES, n0 + BOX * j, h0, t.p);
            bulk_commit();
            bulk_wait_read();
          }
          __syncwarp();
          named_arrive(empty_bar(w));
        }
      }
      if (threadIdx.x == STORER) bulk_wait();
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups: 64 rows x 256 columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int q = lane & 3;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);  // tile row; r0 + 8 too
    bool staged_before = false;  // a tile of this warpgroup is in the staging
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
      const Tile t = tile_of(tile, a.n_mt, a.n_nt);
      int prev = -1;
      // the accumulators are touched by nothing but wgmma from here to the
      // wait_group 0 below (a read in between would make ptxas serialise the
      // wgmmas)
      fence_acc(d);
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint64_t da =
            kmajor_desc(smem_a + stage * A_BYTES + wg * 64 * 128);
        const uint64_t db = mnmajor_desc(smem_b + stage * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)  // k16 step s: 32 bytes on along A's
                                     // rows, 16 rows (2 KB) on down B's
          wgmma_m64n256k16_tb(d, da + 2 * s, db + 128 * s,
                              (kb > 0 || s > 0) ? 1u : 0u);
        wgmma_commit();
        wgmma_wait1();  // the k-block before this one is done: free its stage
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait0();
      fence_acc(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);

      // ---- epilogue: round to bf16 (or keep f32) and store ----
      const int n0 = t.nt * BN;
      if constexpr (kStaged) {
        // this thread's word of box 0: row r = r0 - 64 wg (its r + 8 a
        // kilobyte on), bytes 4q of a 16-byte chunk; chunk c of row r lies
        // at chunk c ^ (r % 8) (the 128-byte swizzle of a TMA box, which
        // spreads a warp's stores over the 32 banks), and r % 8 is lane / 4
        const uint32_t word = smem_u32(smem_c) + wg * C_BYTES +
                              (r0 - wg * 64) * 128 + 4 * q;
        const uint32_t swz = (uint32_t)(lane >> 2) << 4;
        // the store warp has read this warpgroup's last tile
        if (staged_before) named_sync(empty_bar(wg));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int g = 0; g < BN / 8; ++g)  // columns 8g + 2q, 8g + 2q + 1
            st_shared(word + half * 1024 + (g >> 3) * OUT_BOX_BYTES +
                          ((uint32_t)((g & 7) << 4) ^ swz),
                      __floats2bfloat162_rn(d[4 * g + 2 * half],
                                            d[4 * g + 2 * half + 1]));
        }
        fence_async_shared();
        named_arrive(full_bar(wg));
        staged_before = true;
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = t.mt * BM + r0 + 8 * half;  // row of A: [0, 2Hp)
          const bool is_mi = m >= a.Hp;
          const int h = is_mi ? m - a.Hp : m;
          if (h >= a.H) continue;
          void* out = is_mi ? a.mi : a.mr;
          const long long row = (long long)t.p * a.H + h;
#pragma unroll
          for (int g = 0; g < BN / 8; ++g) {
            const int x = n0 + 8 * g + 2 * q;
            if (x < a.Kx)
              store_pair(a, out, row, x, d[4 * g + 2 * half],
                         d[4 * g + 2 * half + 1]);
          }
        }
      }
    }
    // the store warp's TMA stores have read the last tile
    if (kStaged && staged_before) named_sync(empty_bar(wg));
  }
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
  cuuint64_t gd[3], gs[2];
  cuuint32_t bx[3], el[3];
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

}  // namespace

// C interface, loaded with ctypes (steganosaurus_tpu_torch/_build.py).
// tab: (2Hp, 2Kyp) bf16, the table of corner.ifft_y_table (Hp, Kyp
// multiples of 64, Hp >= H, Kyp >= Ky); dcr, dci: (P, Ky, Kx) bf16, rows
// ldd values apart (ldd >= Kx, ldd % 8 == 0), planes Ky rows apart,
// 16-byte-aligned bases; mr, mi: (P*H, Kx) contiguous, bf16, or f32 where
// `values` (the check mode). All on the device that owns `stream`.
// Launches on `stream`, does not synchronise, and returns a CUDA error code
// (0 on success; cudaErrorInvalidValue for shapes it does not take).
extern "C" int corner_ifft_y(const void* tab, const void* dcr, const void* dci,
                             void* mr, void* mi, int P, int H, int Ky, int Kx,
                             int Hp, int Kyp, int ldd, int values,
                             void* stream) {
  if (!tab || !dcr || !dci || !mr || !mi || P <= 0 || H <= 0 || Ky <= 0 ||
      Kx <= 0 || Hp % 64 != 0 || Hp < H || Kyp % 64 != 0 || Kyp < Ky ||
      ldd < Kx || ldd % 8 != 0 || !aligned16(tab) || !aligned16(dcr) ||
      !aligned16(dci))
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;

  // maps: the table, dcr, dci, and (staged stores) mr16, mi16
  CUtensorMap maps[5] = {};
  const long long ad[2] = {2LL * Kyp, 2LL * Hp}, as[1] = {2LL * Kyp};
  const int abox[2] = {BK, BM};
  const long long bd[3] = {Kx, Ky, P};
  const long long bs[2] = {ldd, (long long)Ky * ldd};
  const int bbox[3] = {BOX, BK, 1};
  if (!encode_bf16(enc, &maps[0], tab, 2, ad, as, abox) ||
      !encode_bf16(enc, &maps[1], dcr, 3, bd, bs, bbox) ||
      !encode_bf16(enc, &maps[2], dci, 3, bd, bs, bbox))
    return (int)cudaErrorInvalidValue;

  Args a;
  a.mr = mr;
  a.mi = mi;
  a.P = P;
  a.H = H;
  a.Hp = Hp;
  a.Kx = Kx;
  a.nky = Kyp / BK;
  a.n_mt = 2 * Hp / BM;
  a.n_nt = (Kx + BN - 1) / BN;
  a.values = values ? 1 : 0;
  const int align = values ? 8 : 4;
  a.vec2 = Kx % 2 == 0 && (uintptr_t)mr % align == 0 &&
           (uintptr_t)mi % align == 0;
  // TMA stores take rows of whole 16-byte words from 16-byte-aligned bases
  const bool staged =
      STAGED && !values && Kx % 8 == 0 && aligned16(mr) && aligned16(mi);
  if (staged) {
    const long long od[3] = {Kx, H, P};
    const long long os[2] = {Kx, (long long)H * Kx};
    const int obox[3] = {BOX, 64, 1};
    if (!encode_bf16(enc, &maps[3], mr, 3, od, os, obox) ||
        !encode_bf16(enc, &maps[4], mi, 3, od, os, obox))
      return (int)cudaErrorInvalidValue;
  }
  const long long n_tiles = (long long)P * a.n_mt * a.n_nt;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)n_tiles;
  auto kernel =
      staged ? corner_ifft_y_kernel<true> : corner_ifft_y_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, NTHREADS, SMEM, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a);
  return (int)cudaGetLastError();
}
