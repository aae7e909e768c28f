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
// ~1.46 ms of HBM time. Compute-bound: 6.60 ms, as K1. The unfused chain it
// replaces also wrote the f32 product t (6.37 GB) twice and read it three
// times.
//
// Design (the template is K1, csrc/corner_stage1_wgmma.cu):
// 1. B is the cached table [exr; -exi] (2*Kxp x Wp, Kxp = Kx and Wp = W
//    rounded up to 64, zero padding; negating bf16 is exact), stored
//    transposed, (Wp, 2*Kxp), so that the contraction is the contiguous
//    axis: wgmma's K-major B, as K1's table, needing no transpose bit. Its
//    row stride is a multiple of 128 bytes at every W, 3839 included.
// 2. A is read through two TMA descriptors, mr and mi (P*H, Kx) bf16, the
//    y-stage's output as it is: k-blocks below Kxp come from mr, the rest
//    from mi, so the concatenation [mr, mi] is never made. Columns past Kx
//    and rows past P*H load as zeros.
// 3. A 4-stage ring of (A: 128 x 64 bf16, B: 256 x 64 bf16), both by TMA
//    into 128-byte-swizzled shared memory, full/empty mbarriers; one
//    producer thread. Both operands of wgmma.m64n256k16 come from shared
//    memory by descriptor, so the consumers run no conversion: each keeps
//    one k-block's wgmmas in flight (wait_group 1) and frees the stage
//    before it.
// 4. Two consumer warpgroups (setmaxnreg.inc 232) own 64 rows each of a
//    128 x 256 tile, 128 f32 accumulators a thread. 132 persistent blocks
//    walk the tiles N-fastest: the W/256 tiles of one row-block run side by
//    side, so A comes from HBM about once and the table stays in L2.
// 5. The epilogue works in registers: each row's (p, h) is computed per row
//    (a 128-row tile spans two planes where H % 128 != 0), the sign
//    (-1)^(h+w) applied, the cover byte added, and the u8 stored; rows past
//    P*H and columns past W are masked. With W % 4 == 0 lane pairs swap
//    halves (one shuffle) so a thread holds four consecutive columns of one
//    row: one 4-byte cover word, loaded into registers before the tile's
//    k-loop so that its latency hides behind the wgmmas, and one 4-byte
//    store. Other widths take masked byte loads and stores. The epilogue
//    does not overlap the next tile's main loop. On an H100 at 4K B=64
//    (tools/k4_ablation_torch.py): the kernel 11.1-11.7 ms, 12.0-12.2 with
//    the cover loaded in the epilogue, 9.9-10.3 with no epilogue.
// 6. NHWC: a pixel's three channels are rows H apart in A, so 128-row
//    tiles would leave each 3-byte pixel of the output to three blocks
//    (direct byte stores took 25 ms at 4K B=64 on an H100, against 13
//    for this design). NHWC tiles instead load
//    the three channel planes of 42 image rows as one 4-D TMA box (126
//    rows; the last two of the 128 are neither loaded nor stored), the
//    epilogue writes the tile's u8 pixels into a 32 KB staging tile in
//    shared memory, and the consumers store its 42 rows of 768 contiguous
//    bytes with 16-byte stores. Two named barriers a tile order the
//    staging between the consumer warpgroups.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;                 // rows per tile (two consumer warpgroups)
constexpr int BN = 256;                 // output columns per tile
constexpr int BK = 64;                  // contraction per stage (128 bytes of bf16)
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;    // bf16
constexpr int B_BYTES = BN * BK * 2;    // bf16
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int NTHREADS = 384;           // 2 consumer + 1 producer warpgroup
constexpr int BAR_BYTES = 2 * STAGES * 8;
constexpr int SMEM = STAGES * STAGE_BYTES + BAR_BYTES + 1024;
static_assert(SMEM <= 232448, "shared memory");

// what the kernel stores
constexpr int OUT_NCHW = 0;    // u8 (B, 3, H, W)
constexpr int OUT_NHWC = 1;    // u8 (B, H, W, 3)
constexpr int OUT_VALUES = 2;  // f32 v (B, 3, H, W), the check mode

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

// v = (acc * inv), negated where the centering sign is -1: the plain
// version's t * inv, then apply_center's multiply by -1 (exact)
__device__ __forceinline__ float scaled(float acc, float inv, bool flip) {
  const float v = __fmul_rn(acc, inv);
  return flip ? -v : v;
}

// floor((v + p) + 0.5) clamped to [0, 255], as eager torch rounds it
__device__ __forceinline__ uint32_t to_u8(float v, uint32_t p) {
  float x = __fadd_rn(v, (float)p);
  x = __fadd_rn(x, 0.5f);
  return (uint32_t)fminf(fmaxf(floorf(x), 0.f), 255.f);
}

// NHWC tiles (the layout's store goes through shared memory): the three
// channel planes of NH consecutive rows h of one image, one 4-D TMA box
// of 3 x NH rows (tile row r = c * NH + h - h0; rows 3NH..BM - 1 are not
// loaded and not stored), so every pixel of the tile has its three
// channels in the same block
constexpr int NH = 42;
static_assert(3 * NH <= BM, "an NHWC tile's rows");
constexpr int A_BYTES_NHWC = 3 * NH * BK * 2;
constexpr int STG_BYTES = NH * BN * 3;  // the u8 NHWC tile, staged
constexpr int SMEM_NHWC = SMEM + STG_BYTES;
static_assert(SMEM_NHWC <= 232448, "shared memory with the NHWC staging");

// Where a tile lies: m0, its first flat row (p, h) of the P*H rows (NCHW
// tiles); b and h0, its image and first row (NHWC tiles); n0, its first
// column
struct Tile {
  int m0, b, h0, n0;
};

template <bool kNhwc>
__device__ __forceinline__ Tile tile_of(int tile, int n_tiles_n,
                                        int hblocks) {
  Tile t;
  const int mt = tile / n_tiles_n;
  t.n0 = (tile - mt * n_tiles_n) * BN;
  if (kNhwc) {
    t.b = mt / hblocks;
    t.h0 = (mt - t.b * hblocks) * NH;
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
__device__ __forceinline__ Row row_of(const Tile& t, int r, int M, int H,
                                      int W) {
  Row row;
  if (kNhwc) {
    row.c = r / NH;
    row.hl = r - row.c * NH;
    row.h = t.h0 + row.hl;
    row.live = row.c < 3 && row.h < H;
    row.nchw = ((long long)(3 * t.b + row.c) * H + row.h) * W;
  } else {
    const long long m = (long long)t.m0 + r;
    const int p = (int)(m / H);
    row.live = m < M;
    row.h = (int)(m - (long long)p * H);
    row.c = row.hl = 0;
    row.nchw = m * W;
  }
  return row;
}

// the scalar epilogue of one value at column w of row r: to global memory
// (NCHW u8 or the f32 check values), or into the NHWC staging tile
template <bool kNhwc>
__device__ __forceinline__ void store_one(const Row& r, int w, int n0,
                                          float acc,
                                          const uint8_t* __restrict__ planes,
                                          void* out, uint8_t* stg, int W,
                                          float inv, int center, int mode) {
  if (!r.live || w >= W) return;
  const float v = scaled(acc, inv, center && ((r.h + w) & 1));
  if (mode == OUT_VALUES) {
    reinterpret_cast<float*>(out)[r.nchw + w] = v;
    return;
  }
  const uint8_t u = (uint8_t)to_u8(v, planes[r.nchw + w]);
  if (kNhwc)
    stg[(r.hl * BN + (w - n0)) * 3 + r.c] = u;
  else
    reinterpret_cast<uint8_t*>(out)[r.nchw + w] = u;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The NHWC staging tile of tile t to global memory: NH rows of up to
// BN * 3 contiguous bytes, 16 bytes a thread at a time: one 16-byte store
// where whole and aligned (W % 16 == 0), 4-byte stores where the row is
// 4-byte aligned (W % 4 == 0), else byte stores
__device__ __forceinline__ void store_staged(const Tile& t, const uint8_t* stg,
                                             uint8_t* out, int H, int W) {
  constexpr int CHUNKS = BN * 3 / 16;
  const int row_bytes = min(BN, W - t.n0) * 3;
  for (int i = threadIdx.x; i < NH * CHUNKS; i += 256) {
    const int hl = i / CHUNKS, off = (i - hl * CHUNKS) * 16;
    const int h = t.h0 + hl;
    if (h >= H || off >= row_bytes) continue;
    uint8_t* dst = out + ((long long)t.b * H + h) * W * 3 + t.n0 * 3 + off;
    const uint8_t* src = stg + hl * BN * 3 + off;
    const int n = min(16, row_bytes - off);
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
    if (n == 16 && (a & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      int j = 0;
      if ((a & 3) == 0)
        for (; j + 4 <= n; j += 4)
          *reinterpret_cast<uint32_t*>(dst + j) =
              *reinterpret_cast<const uint32_t*>(src + j);
      for (; j < n; ++j) dst[j] = src[j];
    }
  }
}

template <bool kNhwc>
__device__ __forceinline__ void ifft_epilogue_body(
    const CUtensorMap* tm_r, const CUtensorMap* tm_i, const CUtensorMap* tm_b,
    const uint8_t* __restrict__ planes, void* __restrict__ out, int M, int H,
    int W, int nkb, int n_tiles_n, int hblocks, int n_tiles, float inv,
    int center, int mode, int vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* smem_b = smem;                       // STAGES x 32 KB
  uint8_t* smem_a = smem + STAGES * B_BYTES;    // STAGES x 16 KB
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_a + STAGES * A_BYTES);
  uint64_t* empty = full + STAGES;
  uint8_t* stg = reinterpret_cast<uint8_t*>(empty + STAGES);  // NHWC only

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      const int half = nkb / 2;  // k-blocks of mr, then as many of mi
      const uint32_t bytes = (kNhwc ? A_BYTES_NHWC : A_BYTES) + B_BYTES;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const Tile t = tile_of<kNhwc>(tile, n_tiles_n, hblocks);
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], bytes);
          tma_load_2d(smem_b + stage * B_BYTES, tm_b, kb * BK, t.n0,
                      &full[stage]);
          const CUtensorMap* tm = kb < half ? tm_r : tm_i;
          const int k0 = (kb < half ? kb : kb - half) * BK;
          if (kNhwc)
            tma_load_4d(smem_a + stage * A_BYTES, tm, k0, t.h0, 0, t.b,
                        &full[stage]);
          else
            tma_load_2d(smem_a + stage * A_BYTES, tm, k0, t.m0, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

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
  const bool odd = q & 1;  // the vector epilogue's row: r0 + 8 if odd
  const bool prefetch = vec && mode != OUT_VALUES;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile t = tile_of<kNhwc>(tile, n_tiles_n, hblocks);
    const int n0 = t.n0;
    // the vector epilogue's cover words, loaded before the k-loop so that
    // their latency hides behind it (32 registers a thread)
    const Row rv = row_of<kNhwc>(t, r0 + (odd ? 8 : 0), M, H, W);
    uint32_t cover[32];
#pragma unroll
    for (int g = 0; g < 32; ++g) {
      const int w = n0 + 8 * g + 2 * (q & 2);
      cover[g] = prefetch && rv.live && w < W
                     ? *reinterpret_cast<const uint32_t*>(planes + rv.nchw + w)
                     : 0u;
    }
    int prev = -1;
    // the accumulators are touched by nothing but wgmma from here to the
    // wait_group 0 below (a read in between would make ptxas serialise the
    // wgmmas)
    fence_acc(d);
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint64_t da = sw128_desc(smem_a + stage * A_BYTES + wg * 64 * 128);
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

    // ---- epilogue: scale, sign, + cover, round, clamp, store ----
    if (kNhwc) consumers_sync();  // the last tile's staging is stored
    if (vec) {
      // lane pairs (q, q^1): the even lane takes row r0, columns
      // 8g+2q..+3; the odd lane row r0+8, columns 8g+2(q-1)..+3
      const Row& r = rv;
#pragma unroll
      for (int g = 0; g < 32; ++g) {
        const float x0 = odd ? d[4 * g] : d[4 * g + 2];
        const float x1 = odd ? d[4 * g + 1] : d[4 * g + 3];
        const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
        const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
        float a[4];
        if (odd) {
          a[0] = y0; a[1] = y1; a[2] = d[4 * g + 2]; a[3] = d[4 * g + 3];
        } else {
          a[0] = d[4 * g]; a[1] = d[4 * g + 1]; a[2] = y0; a[3] = y1;
        }
        const int w = n0 + 8 * g + 2 * (q & 2);
        if (!r.live || w >= W) continue;  // W % 4 == 0: all four or none
        // (-1)^(h+w) for w, w+2 is f0, for w+1, w+3 its opposite
        const bool f0 = center && ((r.h + w) & 1);
        const bool f1 = center && !f0;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = scaled(a[j], inv, (j & 1) ? f1 : f0);
        if (mode == OUT_VALUES) {
          *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + r.nchw +
                                     w) = make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
        uint32_t u[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          u[j] = to_u8(v[j], (cover[g] >> (8 * j)) & 0xff);
        if (kNhwc) {
          uint8_t* s = stg + (r.hl * BN + (w - n0)) * 3 + r.c;
#pragma unroll
          for (int j = 0; j < 4; ++j) s[3 * j] = (uint8_t)u[j];
        } else {
          *reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(out) +
                                       r.nchw + w) =
              u[0] | (u[1] << 8) | (u[2] << 16) | (u[3] << 24);
        }
      }
    } else {
      const Row rA = row_of<kNhwc>(t, r0, M, H, W);
      const Row rB = row_of<kNhwc>(t, r0 + 8, M, H, W);
#pragma unroll
      for (int g = 0; g < 32; ++g) {
        const int w = n0 + 8 * g + 2 * q;
        store_one<kNhwc>(rA, w, n0, d[4 * g], planes, out, stg, W, inv,
                         center, mode);
        store_one<kNhwc>(rA, w + 1, n0, d[4 * g + 1], planes, out, stg, W,
                         inv, center, mode);
        store_one<kNhwc>(rB, w, n0, d[4 * g + 2], planes, out, stg, W, inv,
                         center, mode);
        store_one<kNhwc>(rB, w + 1, n0, d[4 * g + 3], planes, out, stg, W,
                         inv, center, mode);
      }
    }
    if (kNhwc) {
      consumers_sync();  // the staging tile is whole
      store_staged(t, stg, reinterpret_cast<uint8_t*>(out), H, W);
    }
  }
}

// The two instantiations, under names of their own: NCHW tiles (the u8
// NCHW stego, or the f32 check values), and NHWC tiles
__global__ void __launch_bounds__(NTHREADS, 1)
corner_ifft_nchw_kernel(const __grid_constant__ CUtensorMap tm_r,
                        const __grid_constant__ CUtensorMap tm_i,
                        const __grid_constant__ CUtensorMap tm_b,
                        const uint8_t* __restrict__ planes,
                        void* __restrict__ out, int M, int H, int W, int nkb,
                        int n_tiles_n, int hblocks, int n_tiles, float inv,
                        int center, int mode, int vec) {
  ifft_epilogue_body<false>(&tm_r, &tm_i, &tm_b, planes, out, M, H, W, nkb,
                            n_tiles_n, hblocks, n_tiles, inv, center, mode,
                            vec);
}

__global__ void __launch_bounds__(NTHREADS, 1)
corner_ifft_nhwc_kernel(const __grid_constant__ CUtensorMap tm_r,
                        const __grid_constant__ CUtensorMap tm_i,
                        const __grid_constant__ CUtensorMap tm_b,
                        const uint8_t* __restrict__ planes,
                        void* __restrict__ out, int M, int H, int W, int nkb,
                        int n_tiles_n, int hblocks, int n_tiles, float inv,
                        int center, int mode, int vec) {
  ifft_epilogue_body<true>(&tm_r, &tm_i, &tm_b, planes, out, M, H, W, nkb,
                           n_tiles_n, hblocks, n_tiles, inv, center, mode,
                           vec);
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
      Wp % 64 != 0 || Wp < W || mode < 0 || mode > 2 ||
      (uintptr_t)mr % 16 != 0 || (uintptr_t)mi % 16 != 0 ||
      (uintptr_t)tab % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long M = 3LL * B * H;
  if (M > 0x7fffffffLL - BM) return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;

  // A: NCHW tiles read 128 flat rows of (P*H, Kx); NHWC tiles the box
  // (64, NH, 3, 1) of (Kx, H, 3, B); B: (Wp, 2Kxp)
  const bool nhwc = mode == OUT_NHWC;
  const long long a2[2] = {Kx, M}, s2[1] = {lda};
  const long long a4[4] = {Kx, H, 3, B};
  const long long s4[3] = {lda, (long long)H * lda, 3LL * H * lda};
  const int box2[2] = {BK, BM}, box4[4] = {BK, NH, 3, 1};
  const long long bd[2] = {2LL * Kxp, Wp}, bs[1] = {2LL * Kxp};
  const int bbox[2] = {BK, BN};
  CUtensorMap tm_r, tm_i, tm_b;
  const bool ok =
      nhwc ? encode_bf16(enc, &tm_r, mr, 4, a4, s4, box4) &&
                 encode_bf16(enc, &tm_i, mi, 4, a4, s4, box4)
           : encode_bf16(enc, &tm_r, mr, 2, a2, s2, box2) &&
                 encode_bf16(enc, &tm_i, mi, 2, a2, s2, box2);
  if (!ok || !encode_bf16(enc, &tm_b, tab, 2, bd, bs, bbox))
    return (int)cudaErrorInvalidValue;

  auto kernel = nhwc ? corner_ifft_nhwc_kernel : corner_ifft_nchw_kernel;
  const int smem = nhwc ? SMEM_NHWC : SMEM;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  const int n_tiles_n = (W + BN - 1) / BN;
  const int hblocks = (H + NH - 1) / NH;
  const long long n_tiles =
      (nhwc ? (long long)B * hblocks : (M + BM - 1) / BM) * n_tiles_n;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  const int align = mode == OUT_VALUES ? 16 : 4;
  const int vec = (W % 4 == 0) && ((uintptr_t)out % align == 0) &&
                  ((uintptr_t)planes % 4 == 0);
  kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      tm_r, tm_i, tm_b, (const uint8_t*)planes, out, (int)M, H, W,
      2 * (Kxp / BK), n_tiles_n, hblocks, (int)n_tiles, inv, center ? 1 : 0,
      mode, vec);
  return (int)cudaGetLastError();
}
