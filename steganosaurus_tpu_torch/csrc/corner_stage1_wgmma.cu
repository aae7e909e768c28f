// Corner DFT forward stage 1 (K1) for Hopper: wgmma with A from registers,
// a persistent warp-specialised schedule, B by TMA, and A by TMA or by the
// producer warpgroup's own loads. One source for every image width.
//
// Replaces the TPU kernel steganosaurus_tpu/spectral/corner_pallas.py:fwd_stage1
// (kernel body _s1_kernel): for every plane p and row h, and both DFT tables,
//
//     ar[p,h,k] = sum_w bf16(c(h,w) x[p,h,w]) * bf16(exr[k,w])
//     ai[p,h,k] = sum_w bf16(c(h,w) x[p,h,w]) * bf16(exi[k,w])   (f32 accumulation)
//
// with x the u8 image batch and c = (-1)^(h+w) when `center` is set, else 1.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s) at the main shape,
// 4K B=64 (P=192 planes of 2160x3840, Kx=1024): 2*P*H*W*2Kx = 6.52 TFLOP,
// 6.60 ms of tensor-core time, against 1.59 GB of u8 read + 15.7 MB of
// tables + 3.40 GB of f32 written, ~1.5 ms of HBM time. Compute-bound:
// 6.60 ms, at any width. With stage 2's prep in the epilogue (7. below)
// 1.70 GB of bf16 copies and 28 MB of f64 partials more: ~2.0 ms of HBM
// time, still compute-bound.
//
// What the first kernel of this function (nvcuda::wmma, since removed) lost:
// 1. nvcuda::wmma 16x16x16 compiles to mma.sync, which does not reach
//    Hopper's tensor-core rate; only wgmma does.
// 2. The same warps that issue the MMAs did synchronous ld.global (one byte
//    at a time when W % 16 != 0), the u8 -> bf16 conversion with a
//    per-element centering sign, and st.shared.
// 3. Two shared-memory stages with BK = 32: 120 __syncthreads over W = 3840,
//    latency hidden only by two resident blocks per SM.
// 4. A 128 x (64 + 64) tile: 51,840 short-lived blocks, each A row-block
//    fetched 16 times, no overlap of an epilogue with the next tile.
// 5. An epilogue through a per-warp 16x16 scratch with eight masked 4-byte
//    stores per lane, for 3.4 GB of f32 output.
//
// What this kernel does about it:
// 1. One GEMM over the concatenated table T (N = 2*Kxh rows, Kxh = Kx
//    rounded up to 128), issued as wgmma.m64n256k16 with B from
//    128-byte-swizzled shared memory and A from registers. T is laid out
//    in groups of 256 rows, each 128 rows of exr followed by the same 128
//    rows of exi (zero rows past Kx), so that a tile's accumulator columns
//    n and n + 128, which the m64n256 layout gives one thread, are ar and
//    ai of one output column. Each output is still the sum over w of one
//    table row's products, in the same order.
// 2. Centering leaves the A operand: (-1)^w is folded into a second cached
//    copy of T and (-1)^h is a row sign applied in the epilogue. Every
//    bf16 x bf16 product is exact in f32, so flipping the sign of whole
//    terms and of a whole row sum changes no bit in any fixed summation
//    order. A is then the plain u8 image rows, at any row stride.
// 3. A 5-stage ring of (A: 128 x 64 u8, row-major, unswizzled; B: 256 x 64
//    bf16 of T, 128-byte swizzle) with full/empty mbarriers. B always comes
//    by TMA: T is padded to Wp, a multiple of 64, so its row stride is a
//    multiple of 128 bytes. The tensor maps are encoded on the host with
//    cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint.
//    A comes one of two ways, a template flag of one kernel body:
//    - TMA route (W % 16 == 0, 16-byte-aligned base; TMA needs 16-byte row
//      strides): one thread loads A as 128 x 64 boxes of the (P*H, W) rows.
//      Out-of-bounds rows and columns load as zeros.
//    - Load route (any other W, or an unaligned view): all 128 threads of
//      the producer warpgroup write the same 128 x 64 bytes into the slot,
//      so the consumers, the K order, the row-sign epilogue and the tables
//      are those of the TMA route. Each warp owns 32 rows of the tile, a
//      lane one row. It copies, with 16-byte cp.async one k-block ahead
//      into a 2-deep staging ring, the 5 aligned 16-byte chunks that hold
//      its row's 64 bytes (80 bytes a row). A chunk is read only up to the
//      row's pixel W - 1 (cp.async's source size; the rest stores as
//      zeros), and only if its first byte is a pixel of the row or the
//      chunk holds pixel c, so no copy reads a byte past the row, and none
//      a chunk that holds no byte of the tensor; rows past P*H stage as
//      zeros. Then each lane
//      realigns 16 bytes of a row (two 16-byte shared loads, a word shift
//      by selects, four __funnelshift_r) into one 16-byte shared store.
//      Rows 32 apart are 32W bytes apart, a multiple of 16, so each lane's
//      byte offset is one constant. full[stage] then takes the B TMA's
//      expect_tx plus one arrival per producer warp after its stores
//      (count 1 + 4): shared stores, __syncwarp, mbarrier.arrive
//      (release), the consumers' try_wait (acquire). Consumers read A with
//      ld.shared, so no proxy fence.
//      What bounds it: fetching A this way costs more than the TMA route's
//      one box a stage; chip_smoke.py times this route forced onto the
//      TMA route's shape (4K B=64) beside it. Slower ways of filling the
//      slot: loads into registers (16 in flight a thread spill out of the
//      producer's registers, which serialises them), 4-byte cp.async, and
//      TMA boxes into the staging ring (a box must start 16-byte aligned,
//      so the rows, W bytes apart, need one box per group row of 16: the
//      TMA unit's time per box then costs more than these copies).
// 4. Each consumer thread reads its A slice with two 16-byte shared loads
//    per stage and converts u8 -> bf16 in registers (exact: every u8 is a
//    bf16) with byte permutes and one f32 add, already in the wgmma
//    A-fragment layout. The K order inside each 64-wide block is permuted
//    to make that possible: logical k = 16s + r (s = k16 step, r in 0..15)
//    reads pixel 16q + 4s + e with q = (r % 8) / 2, e = r % 2 + 2 (r / 8),
//    and the host stores T with its columns in the same order
//    (corner_kernels.stage1_tables). The sum over k is the sum over w.
// 5. One producer warpgroup (setmaxnreg.dec to 40); two consumer warpgroups
//    (setmaxnreg.inc to 232) own 64 rows each of a 128 x 256 tile, 128 f32
//    accumulators a thread. 132 persistent blocks (one per SM) walk the
//    tiles N-fastest, so the 2Kx/256 tiles of one row-block run side by
//    side: A comes from HBM about once, the re-reads hit L2, and T (15.7 MB
//    at 4K) stays in L2. Nothing orders the two consumer warpgroups: each
//    waits for its own k-block's wgmmas (wait_group 0) before it converts
//    the next A slice, so the tensor cores stay busy through a convert only
//    while the other warpgroup's wgmmas are in flight.
// 6. The epilogue applies the row sign, pairs lanes with one shuffle so
//    each thread holds four consecutive columns of one row, and writes them
//    with 16-byte stores straight from registers (scalar masked stores when
//    Kx % 4 != 0). Both consumer warpgroups store their halves of the same
//    tile before either starts the next tile's k-loop; only the producer's
//    ring (up to STAGES k-blocks of the next tile) runs ahead meanwhile.
//    The epilogue does not overlap the next tile's main loop: neither a
//    shared-memory + TMA store nor consumer warpgroups on alternate tiles
//    is done yet.
// 7. Forward stage 2's prep, from registers (template flag kPrep). Stage 2
//    needs bf16 copies of ar and ai and, under mix_adaptive, the column
//    energies sum_h(ar^2 + ai^2) that pick its band; a separate pass
//    (corner_stage2.cu's prep) read the 3.40 GB of f32 that this kernel
//    had just written to make them (1.76 ms a side at 4K B=64). Here the
//    epilogue makes them from the values it stores, on a kernel with HBM
//    time to spare:
//    - kPrep >= 1: the bf16 copies (__float2bfloat16_rn of the signed
//      values, bit-equal to .to(torch.bfloat16)) into rows ldk values
//      apart (columns [Kx, ldk) not written), the layout K2's TMA reads.
//      The two lanes that hold a row's 8-column group swap halves over a
//      pair of groups, so each stores 16 bytes and a store covers one
//      32-byte sector a row (8 bytes a lane, half a sector a row, cost
//      four times as much: 1.29 against 0.32 ms a side at 4K B=64).
//    - kPrep == 2: each value's energy e = fl(fl(ar*ar) + fl(ai*ai)) (as
//      eager torch rounds it), summed in f64 over the tile's rows of each
//      plane the tile touches (a 128-row tile can straddle planes: 2160 =
//      16 * 128 + 112) into the slot of row t + p of `part` (t the row
//      tile, p the plane; slots nobody writes are never read). The order
//      is fixed by the shape, with no atomics: a lane adds its two rows,
//      a warp's 8 row lanes reduce-scatter by shuffles (xor 16, 8, 4),
//      each lane keeping 2 of a round's 64 columns, and after a named
//      barrier of the 256 consumer threads 64 of them add the 8 warps'
//      sums in warp order through a 4 KB shared buffer, two rounds a
//      plane. corner_stage2.cu's prep reduce then adds each plane's slots
//      in order and rounds once to f32; corner_kernels.stage1_energy_plain
//      is the same order in plain torch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;          // rows per tile (two consumer warpgroups)
constexpr int BN = 256;          // table rows per tile: 128 of exr, 128 of exi
constexpr int BX = BN / 2;       // output columns per tile
constexpr int BK = 64;           // contraction per stage
constexpr int STAGES = 5;
constexpr int A_BYTES = BM * BK;          // u8
constexpr int B_BYTES = BN * BK * 2;      // bf16
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int NTHREADS = 384;             // 2 consumer + 1 producer warpgroup
constexpr int BAR_BYTES = 2 * STAGES * 8;
constexpr int SMEM_TMA = STAGES * STAGE_BYTES + BAR_BYTES + 1024;
// Load route: a ring of LD_DEPTH staged copies of A's rows, each row the 5
// aligned 16-byte chunks that hold its 64 bytes
constexpr int PRODUCER_WARPS = 4;
constexpr int LD_DEPTH = 2;
constexpr int STG_ROW = BK + 16;
constexpr int STG_BYTES = BM * STG_ROW;
constexpr int SMEM_LDG = SMEM_TMA + LD_DEPTH * STG_BYTES;
// The energies' cross-warp sum: 8 consumer warps x 64 columns of f64
constexpr int CONSUMER_WARPS = 8;
constexpr int RED_COLS = 64;
constexpr int RED_BYTES = CONSUMER_WARPS * RED_COLS * 8;
static_assert(SMEM_LDG + RED_BYTES <= 232448, "the load route's shared memory");

// kPrep: what the epilogue writes besides ar and ai
constexpr int PREP_NONE = 0;
constexpr int PREP_COPIES = 1;    // the bf16 copies
constexpr int PREP_ENERGIES = 2;  // the copies and the energies' partials

// Where the epilogue writes: ar, ai (M, Kx) f32; with kPrep >= 1 ar16, ai16
// (M, ldk) bf16; with kPrep == 2 part (n_row_tiles + P - 1, Kx) f64.
struct Out {
  float* ar;
  float* ai;
  __nv_bfloat16* ar16;
  __nv_bfloat16* ai16;
  double* part;
  int ldk;
};

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

// 16 bytes global -> shared, asynchronously, bypassing L1: the first n
// bytes are read, the rest of the 16 stored as zeros (n = 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(LD_DEPTH - 1) : "memory");
}

// K-major operand in 128-byte-swizzled shared memory: rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO), leading offset unused (LBO = 1).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// Two u8 (bytes b and b+1 of w) -> one bf16x2 register, exactly: each byte
// becomes the float 2^23 + u, minus 2^23 gives u, whose top 16 bits are
// its bf16.
__device__ __forceinline__ uint32_t u8x2_bf16x2(uint32_t w, uint32_t sel_lo,
                                                uint32_t sel_hi) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, sel_lo)) - 8388608.0f;
  const float hi = __uint_as_float(__byte_perm(w, 0x4B000000u, sel_hi)) - 8388608.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t desc_b,
                                                 uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
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
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
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

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue/wait points.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// fl(fl(a*a) + fl(b*b)): the intrinsics round each step, as eager torch
// does (this file is built without -fmad=false)
__device__ __forceinline__ float sq2(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

__device__ __forceinline__ uint2 bf16x4(float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                    *reinterpret_cast<uint32_t*>(&hi));
}

// the 256 consumer threads (warpgroups 0 and 1); the producer never joins
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One output element from registers: its f32 value, and with kPrep its
// bf16 copy
template <int kPrep>
__device__ __forceinline__ void store_one(const Out& o, long long m, int c,
                                          int Kx, float vr, float vi) {
  o.ar[m * Kx + c] = vr;
  o.ai[m * Kx + c] = vi;
  if constexpr (kPrep != PREP_NONE) {
    o.ar16[m * o.ldk + c] = __float2bfloat16_rn(vr);
    o.ai16[m * o.ldk + c] = __float2bfloat16_rn(vi);
  }
}

// Load route: the producer warpgroup (threads 256..383) fills the A slot of
// every stage from the (M, W) u8 rows at x; thread 256 also issues B's TMA.
// Producer warp pw owns the 32 tile rows 8i + 2pw + h (i < 16, h < 2): it
// stages, realigns and signals only those, so __syncwarp orders its lanes.
__device__ __forceinline__ void produce_by_loads(
    const CUtensorMap* tm_b, const uint8_t* __restrict__ x, int W, int M,
    int nkb, int n_tiles_n, int n_tiles, uint8_t* smem_a, uint8_t* smem_b,
    uint8_t* stg, uint64_t* full, uint64_t* empty) {
  const int t = threadIdx.x - 2 * 128;
  const int lane = t & 31;
  const int pw = t >> 5;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uint8_t* x16 = x - (xa & 15);  // the aligned chunk that holds x[0]

  // copies of the stage at the load cursor (lt, lkb) into staging buffer
  // `buf`; one commit group per call, empty past the last stage. Lane l
  // copies the 5 chunks of the warp's row l, tile row cr, each read up to
  // the row's pixel W - 1 and no further, so the bytes past W stage as
  // zeros, and a row past P*H stages as zeros. Rows 128 apart are 128W
  // bytes apart, so the row's byte offset co is one constant for the lane.
  const int cr = 8 * (lane >> 1) + 2 * pw + (lane & 1);
  const int co = (int)((xa + (uintptr_t)cr * (uintptr_t)W) & 15);
  int lt = blockIdx.x, lkb = 0;
  auto issue = [&](int buf) {
    if (lt < n_tiles) {
      const int m0 = (lt / n_tiles_n) * BM;
      const int c = lkb * BK;
      const bool row = m0 + cr < M;
      const uint8_t* src = x + ((long long)(m0 + cr) * W + c - co);
      uint8_t* dst = stg + buf * STG_BYTES + cr * STG_ROW;
      const int left = W - c + co;  // bytes of the row from src on
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int n = min(max(left - 16 * j, 0), 16);
        const bool live = row && n > 0 && (j < 4 || co != 0);
        cp_async16(dst + 16 * j, live ? src + 16 * j : x16, live ? n : 0u);
      }
      if (++lkb == nkb) {
        lkb = 0;
        lt += gridDim.x;
      }
    }
    cp_async_commit();
  };
  for (int b = 0; b < LD_DEPTH - 1; ++b) issue(b);

  // realign: lane task q (q < 4) writes bytes 16k..16k+15, k = lane % 4, of
  // tile row 32q + rl, from staged bytes ro + 16k.. of that row; rows 32
  // apart are 32W bytes apart, so ro is one constant for the lane
  const int rl = 8 * (lane >> 3) + 2 * pw + ((lane >> 2) & 1);
  const int k = lane & 3;
  const int ro = (int)((xa + (uintptr_t)rl * (uintptr_t)W) & 15);
  const bool ws2 = ro & 8, ws1 = ro & 4;  // word shift ro / 4, by 2 and 1
  const int bs = 8 * (ro & 3);            // then a byte shift
  int stage = 0, sb = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = (tile % n_tiles_n) * BN;
    for (int kb = 0; kb < nkb; ++kb) {
      // buffer sb - 1 was read by every lane of the warp last iteration
      issue(sb == 0 ? LD_DEPTH - 1 : sb - 1);
      cp_async_wait_ring();  // this thread's copies into buffer sb landed
      __syncwarp();          // and those of the warp's other lanes
      mbar_wait(&empty[stage], phase ^ 1);
      if (t == 0) {
        mbar_expect_tx(&full[stage], B_BYTES);
        tma_load_2d(smem_b + stage * B_BYTES, tm_b, kb * BK, n0, &full[stage]);
      }
      const uint8_t* sr = stg + sb * STG_BYTES + rl * STG_ROW + 16 * k;
      uint8_t* a = smem_a + stage * A_BYTES + rl * BK + 16 * k;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 c0 = *reinterpret_cast<const uint4*>(sr + 32 * q * STG_ROW);
        const uint4 c1 =
            *reinterpret_cast<const uint4*>(sr + 32 * q * STG_ROW + 16);
        const uint32_t v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        uint32_t u[6], w[5];
#pragma unroll
        for (int i = 0; i < 6; ++i) u[i] = ws2 ? v[i + 2] : v[i];
#pragma unroll
        for (int i = 0; i < 5; ++i) w[i] = ws1 ? u[i + 1] : u[i];
        *reinterpret_cast<uint4*>(a + 32 * q * BK) = make_uint4(
            __funnelshift_r(w[0], w[1], bs), __funnelshift_r(w[1], w[2], bs),
            __funnelshift_r(w[2], w[3], bs), __funnelshift_r(w[3], w[4], bs));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      if (++sb == LD_DEPTH) sb = 0;
    }
  }
}

// kPrep == 2: the tile's column energies into `part` (7. above). d holds
// rows r0 and r0 + 8 (tile rows; global mA, mB) of the tile's columns
// k0 + 8g + 2q + {0, 1} (g < 16), ar at d[4g..] and ai at d[4g + 64..].
// Row indices fit in an int: the C entry refuses P*H > 2^31 - 1 - BM.
__device__ __forceinline__ void energy_partials(
    const float* d, double* red, double* __restrict__ part, int m0, int mA,
    int mB, int M, int H, int Kx, int k0) {
  const int lane = threadIdx.x & 31;
  const int gw = threadIdx.x >> 5;  // consumer warp 0..7: tile rows 16 gw..
  const int slot0 = m0 / BM;
  const int mL = min(m0 + BM, M) - 1;
  const int pA = mA < M ? mA / H : -1;
  const int pB = mB < M ? mB / H : -1;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  for (int p = m0 / H; p <= mL / H; ++p) {
    const bool inA = pA == p, inB = pB == p;
    double* out = part + (size_t)(slot0 + p) * Kx;
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the tile's columns [64r, 64r + 64)
      // v[2i + e]: this lane's two rows of column 64r + 8i + 2q + e
      double v[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * (8 * r + i) + e;
          const double ea = inA ? (double)sq2(d[j], d[j + 64]) : 0.0;
          const double eb = inB ? (double)sq2(d[j + 2], d[j + 66]) : 0.0;
          v[2 * i + e] = ea + eb;
        }
      }
      // reduce-scatter over the 8 row lanes: lane bit 4 keeps i bit 2,
      // bit 3 i bit 1, bit 2 i bit 0, so the lane ends with i = lane / 4
      double w[8], y[4], z[2];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = (b4 ? v[8 + k] : v[k]) +
               __shfl_xor_sync(0xffffffffu, b4 ? v[k] : v[8 + k], 16);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        y[k] = (b3 ? w[4 + k] : w[k]) +
               __shfl_xor_sync(0xffffffffu, b3 ? w[k] : w[4 + k], 8);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        z[k] = (b2 ? y[2 + k] : y[k]) +
               __shfl_xor_sync(0xffffffffu, b2 ? y[k] : y[2 + k], 4);
      // column 64r + 8(lane / 4) + 2(lane % 4) + e = 64r + 2 lane + e
      *reinterpret_cast<double2*>(red + gw * RED_COLS + 2 * lane) =
          make_double2(z[0], z[1]);
      consumer_sync();
      const int c = k0 + 64 * r + (int)threadIdx.x;
      if (threadIdx.x < RED_COLS && c < Kx) {
        double s = red[threadIdx.x];
#pragma unroll
        for (int k = 1; k < CONSUMER_WARPS; ++k)
          s += red[k * RED_COLS + threadIdx.x];
        out[c] = s;
      }
      consumer_sync();
    }
  }
}

template <bool kTma, int kPrep>
__device__ __forceinline__ void stage1_body(
    const CUtensorMap* tm_a, const CUtensorMap* tm_b,
    const uint8_t* __restrict__ x, int W, const Out o, int M, int H,
    int Kx, int nkb, int n_tiles_n, int n_tiles, int center, int vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* smem_b = smem;                           // STAGES x 32 KB, 1024-aligned
  uint8_t* smem_a = smem + STAGES * B_BYTES;        // STAGES x 8 KB
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_a + STAGES * A_BYTES);
  uint64_t* empty = full + STAGES;
  uint8_t* stg = smem_a + STAGES * A_BYTES + BAR_BYTES;  // load route only
  // kPrep == 2: the energies' cross-warp buffer, after the staging ring
  double* red = reinterpret_cast<double*>(stg + (kTma ? 0 : LD_DEPTH * STG_BYTES));

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // TMA route: one expect_tx arrival; load route: that one plus one per
      // producer warp after its stores
      mbar_init(&full[s], kTma ? 1 : 1 + PRODUCER_WARPS);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (kTma) {
      // ---- producer: one thread keeps the ring full ----
      if (threadIdx.x == 256) {
        int stage = 0;
        uint32_t phase = 0;
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
          const int m0 = (tile / n_tiles_n) * BM;
          const int n0 = (tile % n_tiles_n) * BN;
          for (int kb = 0; kb < nkb; ++kb) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], STAGE_BYTES);
            tma_load_2d(smem_b + stage * B_BYTES, tm_b, kb * BK, n0, &full[stage]);
            tma_load_2d(smem_a + stage * A_BYTES, tm_a, kb * BK, m0, &full[stage]);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else {
      produce_by_loads(tm_b, x, W, M, nkb, n_tiles_n, n_tiles, smem_a, smem_b,
                       stg, full, empty);
    }
  } else {
    // ---- consumer warpgroups: 64 rows x 256 columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int q = lane & 3;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);  // tile row; r0 + 8 too
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles_n) * BM;
      const int n0 = (tile % n_tiles_n) * BN;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint8_t* a = smem_a + stage * A_BYTES;
        const uint4 u0 = *reinterpret_cast<const uint4*>(a + r0 * BK + 16 * q);
        const uint4 u1 = *reinterpret_cast<const uint4*>(a + (r0 + 8) * BK + 16 * q);
        const uint32_t w0[4] = {u0.x, u0.y, u0.z, u0.w};
        const uint32_t w1[4] = {u1.x, u1.y, u1.z, u1.w};
        uint32_t fr[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // A fragment of k16 step s: rows r0 / r0+8, logical columns
          // (2q, 2q+1) and (2q+8, 2q+9) = pixels 16q+4s+{0,1} and {2,3}
          fr[s][0] = u8x2_bf16x2(w0[s], 0x7540, 0x7541);
          fr[s][1] = u8x2_bf16x2(w1[s], 0x7540, 0x7541);
          fr[s][2] = u8x2_bf16x2(w0[s], 0x7542, 0x7543);
          fr[s][3] = u8x2_bf16x2(w1[s], 0x7542, 0x7543);
        }
        const uint64_t desc = sw128_desc(smem_b + stage * B_BYTES);
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n256k16(d, fr[s][0], fr[s][1], fr[s][2], fr[s][3],
                           desc + 2 * s, (kb > 0 || s > 0) ? 1u : 0u);
        wgmma_commit();
        wgmma_wait0();
        fence_acc(d);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // ---- epilogue: row sign, then 16-byte (or masked scalar) stores ----
      // accumulator columns 8g + 2q + {0, 1}: g < 16 ar, g >= 16 ai, of
      // output column k0 + 8(g % 16) + 2q + {0, 1}
      const int k0 = (n0 / BN) * BX;
      const long long mA = (long long)m0 + r0;
      const long long mB = mA + 8;
      const float sA = (center && ((mA % H) & 1)) ? -1.0f : 1.0f;
      const float sB = (center && ((mB % H) & 1)) ? -1.0f : 1.0f;
      const bool odd = q & 1;
      if (vec) {
        // lane pairs (q, q^1): the even lane takes row r0, columns
        // 8g+2q..+3; the odd lane row r0+8, columns 8g+2(q-1)..+3
        const long long m = odd ? mB : mA;
        const float sg = odd ? sB : sA;
        const bool live = m < M;
        const bool lo = !(q & 2);  // columns 8g..8g+3 of its row, else +4..
#pragma unroll
        for (int g = 0; g < 16; g += 2) {
          float4 v[2][2];  // [group g, g + 1][ar, ai]
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* dg = d + 4 * (g + u) + 64 * h;
              const float x0 = odd ? dg[0] : dg[2];
              const float x1 = odd ? dg[1] : dg[3];
              const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
              const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
              float4 w = odd ? make_float4(y0, y1, dg[2], dg[3])
                             : make_float4(dg[0], dg[1], y0, y1);
              w.x *= sg;
              w.y *= sg;
              w.z *= sg;
              w.w *= sg;
              v[u][h] = w;
            }
            const int c = k0 + 8 * (g + u) + 2 * (q & 2);
            if (live && c < Kx) {
              *reinterpret_cast<float4*>(o.ar + m * Kx + c) = v[u][0];
              *reinterpret_cast<float4*>(o.ai + m * Kx + c) = v[u][1];
            }
          }
          if constexpr (kPrep != PREP_NONE) {
            // the bf16 copies 16 bytes a lane: the lane pair (q, q^2) of a
            // row swaps halves, so the lo lane holds columns 8g..8g+7 and
            // the hi lane 8g+8..8g+15, one 32-byte sector a row
            const int c = k0 + 8 * g + 8 * !lo;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint2 a = bf16x4(v[0][h]), b = bf16x4(v[1][h]);
              const uint2 send = lo ? b : a;
              const uint32_t rx = __shfl_xor_sync(0xffffffffu, send.x, 2);
              const uint32_t ry = __shfl_xor_sync(0xffffffffu, send.y, 2);
              const uint4 row = lo ? make_uint4(a.x, a.y, rx, ry)
                                   : make_uint4(rx, ry, b.x, b.y);
              __nv_bfloat16* dst = (h ? o.ai16 : o.ar16) + m * o.ldk + c;
              if (live && c + 8 <= Kx) {
                *reinterpret_cast<uint4*>(dst) = row;
              } else if (live && c + 4 <= Kx) {  // Kx % 8 == 4
                *reinterpret_cast<uint2*>(dst) = make_uint2(row.x, row.y);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < 16; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + 8 * g + 2 * q + e;
            if (c >= Kx) continue;
            if (mA < M)
              store_one<kPrep>(o, mA, c, Kx, sA * d[4 * g + e],
                               sA * d[4 * g + 64 + e]);
            if (mB < M)
              store_one<kPrep>(o, mB, c, Kx, sB * d[4 * g + 2 + e],
                               sB * d[4 * g + 66 + e]);
          }
        }
      }
      if constexpr (kPrep == PREP_ENERGIES)
        energy_partials(d, red, o.part, m0, (int)mA, (int)mB, M, H, Kx, k0);
    }
  }
}

// The two routes, under names of their own so that the SASS of each can be
// found (corner_kernels' sass check), each instantiated for every kPrep.
template <int kPrep>
__global__ void __launch_bounds__(NTHREADS, 1)
corner_stage1_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b,
                         const uint8_t* __restrict__ x, int W, const Out o,
                         int M, int H, int Kx, int nkb, int n_tiles_n,
                         int n_tiles, int center, int vec) {
  stage1_body<true, kPrep>(&tm_a, &tm_b, x, W, o, M, H, Kx, nkb, n_tiles_n,
                           n_tiles, center, vec);
}

template <int kPrep>
__global__ void __launch_bounds__(NTHREADS, 1)
corner_stage1_ldg_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b,
                         const uint8_t* __restrict__ x, int W, const Out o,
                         int M, int H, int Kx, int nkb, int n_tiles_n,
                         int n_tiles, int center, int vec) {
  stage1_body<false, kPrep>(&tm_a, &tm_b, x, W, o, M, H, Kx, nkb, n_tiles_n,
                            n_tiles, center, vec);
}

using Stage1Kernel = decltype(&corner_stage1_tma_kernel<PREP_NONE>);

template <int kPrep>
Stage1Kernel stage1_kernel(bool tma) {
  return tma ? corner_stage1_tma_kernel<kPrep> : corner_stage1_ldg_kernel<kPrep>;
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

}  // namespace

// C interface, loaded with ctypes (steganosaurus_tpu_torch/_build.py).
// x: (P*H, W) u8 rows, any W >= 1 and any base address; t: (2*Kxh, Wp)
// bf16, 16-byte aligned, the paired, K-permuted table of
// corner_kernels.stage1_tables (the (-1)^w-folded copy when center is set),
// Kxh a multiple of 128 and Wp of 64; ar/ai: (P*H, Kx) f32. All contiguous,
// on the device that owns `stream`. tma != 0 takes the TMA route for A,
// which needs W % 16 == 0 and a 16-byte-aligned x; tma == 0 the load route.
// prep (kPrep): 0 ar and ai alone; 1 also their bf16 copies ar16/ai16,
// (P*H, ldk) bf16 rows, ldk >= Kx a multiple of 8, 16-byte-aligned bases
// (columns [Kx, ldk) not written); 2 also the energies' f64 partials,
// part (ceil(P*H / 128) + P - 1, Kx), 8-byte aligned, which
// corner_stage2_prep_reduce sums. Pointers prep does not use may be null.
// Launches on `stream`, does not synchronise, and returns a CUDA error code
// (0 on success; cudaErrorInvalidValue for shapes it does not take).
extern "C" int corner_stage1_wgmma(const void* x, const void* t, void* ar,
                                   void* ai, void* ar16, void* ai16,
                                   void* part, int P, int H, int W, int Kx,
                                   int Kxh, int Wp, int ldk, int center,
                                   int tma, int prep, void* stream) {
  if (P <= 0 || H <= 0 || W <= 0 || Kx <= 0 || Kxh % BX != 0 || Kxh < Kx ||
      Wp % BK != 0 || Wp < W || (uintptr_t)t % 16 != 0 || prep < PREP_NONE ||
      prep > PREP_ENERGIES)
    return (int)cudaErrorInvalidValue;
  if (tma && (W % 16 != 0 || (uintptr_t)x % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (prep != PREP_NONE &&
      (!ar16 || !ai16 || (uintptr_t)ar16 % 16 != 0 ||
       (uintptr_t)ai16 % 16 != 0 || ldk < Kx || ldk % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (prep == PREP_ENERGIES && (!part || (uintptr_t)part % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)P * H;
  if (M > 0x7fffffffLL - BM) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;

  CUtensorMap tm_a, tm_b;
  memset(&tm_a, 0, sizeof(tm_a));  // the load route never reads it
  if (tma) {
    const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)W};
    const cuuint32_t box[2] = {BK, BM};
    const cuuint32_t el[2] = {1, 1};
    if (enc(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x), dims,
            strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)Wp, (cuuint64_t)(2 * Kxh)};
    const cuuint64_t strides[1] = {(cuuint64_t)Wp * 2};
    const cuuint32_t box[2] = {BK, BN};
    const cuuint32_t el[2] = {1, 1};
    if (enc(&tm_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(t),
            dims, strides, box, el, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }

  const Stage1Kernel kernel = prep == PREP_ENERGIES ? stage1_kernel<PREP_ENERGIES>(tma)
                              : prep == PREP_COPIES ? stage1_kernel<PREP_COPIES>(tma)
                                                    : stage1_kernel<PREP_NONE>(tma);
  const int smem = (tma ? SMEM_TMA : SMEM_LDG) +
                   (prep == PREP_ENERGIES ? RED_BYTES : 0);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  const int n_tiles_n = Kxh / BX;
  const long long n_tiles = ((M + BM - 1) / BM) * n_tiles_n;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  const int vec = (Kx % 4 == 0) && ((uintptr_t)ar % 16 == 0) &&
                  ((uintptr_t)ai % 16 == 0);
  const Out o = {(float*)ar, (float*)ai, (__nv_bfloat16*)ar16,
                 (__nv_bfloat16*)ai16, (double*)part, ldk};
  kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      tm_a, tm_b, (const uint8_t*)x, W, o, (int)M, H, Kx, Wp / BK, n_tiles_n,
      (int)n_tiles, center ? 1 : 0, vec);
  return (int)cudaGetLastError();
}
