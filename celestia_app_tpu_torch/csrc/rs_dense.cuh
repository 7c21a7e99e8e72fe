// The dense GF(2) product's main loop for Hopper (sm_90a), shared by
// rs_dense.cu (parity planes out through TMA stores) and rs_dense_leaf.cu
// (parity shares out in share byte order, then their NMT leaf digests);
// rs_xor.cu builds its binary main loop from the same barriers, TMA maps,
// descriptors, raster and parity bytes.
//
// The product is parity = (G_bits x bits(x)) mod 2 with
//   G   (Pm, nm) int8 in {0,1}: the bit-expanded generator, Pm = P*m, nm = n*m;
//   x   the data: contraction index 8q + t is bit t (LSB first) of byte row
//       q of the byte planes (gf/field.expand_bit_matrix order).
// It runs transposed, out^T = bits(x)^T G^T, so that the 8x inflated data
// bits are the wgmma A operand, which may live in registers, and the
// generator is the B operand, read K-major from shared memory (integer
// wgmma has no transposed operands; G is row-major, i.e. K-major, as it
// is).  One persistent block per SM walks work items; an item is
// Epi::kTilesPerItem consecutive tiles of 256 generator bit-rows by 128
// data columns, and the contraction runs in stages of BK = 128 bits.
// Three warpgroups with fixed roles:
//  * two consumer warpgroups, 64 data columns each: per stage each thread
//    reads the 16 packed bytes its fragments need straight from the TMA
//    tile (for each k32 step and each of its two columns, the two byte
//    rows whose nibble q & 1 its lane holds), expands each nibble to the
//    four {0,1} bytes of an A fragment register with one multiply and two
//    masks, and issues four wgmma.mma_async m64n256k32 s32.s8.s8 with A
//    from registers.  The bits never exist outside registers.  The 64x256
//    int32 accumulator is 128 registers a thread; the launch gives every
//    thread 168, and setmaxnreg moves the producer's spare ones over;
//  * one producer warpgroup: one thread keeps TMA loads up to STAGES ahead
//    (the generator tile, 256 rows x 128 B in the 128-byte swizzle that the
//    wgmma descriptor reads, and the packed data tile, 16 byte rows x 128
//    columns); warps 1-3 are left to the epilogue (Epi::extra).
// Why A in registers: a first draft unpacked the bits into a shared-memory
// B operand (G as A), one st.shared.v4 per 16 bits and 32 KB of stores a
// stage on top of wgmma's own operand reads; those stores, not the tensor
// cores, set its pace.  Here the expansion is register arithmetic that the
// consumers do while the other consumer warpgroup's wgmma runs.
// Why no transpose: the earlier loop had the producer's 128 threads
// transpose each packed tile to [column][16 bytes] so that a consumer's
// bytes were one 16-byte load, behind a second barrier per stage.  That
// hop sat on the ring's critical path (a stage's loads land little before
// the consumers need them): reading the tile directly made the k=512 row
// phase 15 % faster (kernels/sweep_rs_dense.py, PERF.md).
//
// The data operand comes in one of two row layouts (Epi::kXBps): byte
// planes (1: row q holds byte row q of every column), or shares in their
// own byte order with m = 16 (2: row j holds share j, the two bytes of a
// column's symbol side by side, so byte row q = 2j + b is byte b of each
// symbol of row j).  The consumers' reads de-interleave the second, so the
// caller's (k, 2k, 512) half square is read as it lies, uncopied.
//
// The ring has STAGES = 4 slots of 32 KB generator + 2 KB packed data
// (136 KB in all); the epilogue's shared memory follows it, then the
// barriers.  Per slot a `tma` barrier (the loads landed) and an `empty`
// barrier (one arrival per consumer warpgroup once its wgmma of the stage
// completed); each stage waits for its own wgmma.  Measured on an H100
// (kernels/sweep_rs_dense.py): 3 to 6 slots run within 3 % of each other.
//
// L2 and raster: G_bits at k=512 is 64 MB, more than the 50 MB L2, and a
// tile pulls 34 KB (32 KB of G, 2 KB packed) from L2 per 8.4 M operations:
// ~7.7 TB/s across the card at the int8 peak, ~3.9 TB/s at half of it.
// Items are walked in groups of GROUP_M = 8 generator bands (2 MB each at
// k=512) item by item, so the 132 concurrent items share 8 bands and a few
// dozen data panels, all resident in L2 (groups of 4 and 16 measured within
// 2 %).  The next lever if the loads stall is a 2-block cluster along
// columns that multicasts the G tile.
//
// Edges: TMA fills loads past Pm, nm or the columns with zeros (a zero bit
// adds nothing to a parity), so the main loop has no masks.
//
// The epilogue interface (a struct whose functions the loop calls):
//   kTilesPerItem, kXBps, kSmemBytes      compile-time shape of an item
//   kProducerRegs, kConsumerRegs          the roles' setmaxnreg counts
//   init()                                all threads, before the barriers' init
//   extra(tid, m_tiles, n_items)          producer warps 1-3 (tid 0..95)
//   tile(d, wg, wtid, q, c0, mb, nb, j)   consumers, each tile's accumulator
//                                         (q: the lane's quad index, c0: its
//                                         first data column in the tile)
//   item(wg, wtid, mb, ib)                consumers, after an item's last tile
//   finish(wg, wtid)                      consumers, after the last item
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace rs_dense {

constexpr int TM = 256;      // generator bit-rows per tile (wgmma n256)
constexpr int TN = 128;      // data columns per tile (two m64 halves)
constexpr int BK = 128;      // contraction bits per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int GROUP_M = 8;   // generator bands walked together (L2 reuse)
constexpr int kThreads = 384;
constexpr int kProducerRegs = 40;   // the dense kernel's split: 128*40 + 256*232 <= 65,536
constexpr int kConsumerRegs = 232;

constexpr int G_BYTES = TM * BK;            // generator tile, 32 KB
constexpr int P_BYTES = (BK / 8) * TN;      // packed data tile [16][128], 2 KB
constexpr int G_OFF = 0;
constexpr int P_OFF = G_OFF + STAGES * G_BYTES;
constexpr int EPI_OFF = P_OFF + STAGES * P_BYTES;

// Dynamic shared memory of a kernel whose epilogue takes `epi_bytes`:
// ring, epilogue, barriers, + 1024 since the base is rounded up to the
// swizzle atom.
constexpr int smem_bytes(int epi_bytes) { return EPI_OFF + epi_bytes + 2 * STAGES * 8 + 1024; }

// Error codes beside cudaError_t's (which end below 1000).
constexpr int kNoEncodeEntry = 1999;
constexpr int kEncodeFailed = 2000;  // + CUresult

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// True once the phase of the given parity has completed (non-blocking).
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0u;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (ok == 0u);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over `threads` threads (multiples of 32).
__device__ __forceinline__ void named_sync(int id, int threads = 128) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms of 1024 bytes (SBO); LBO is unused for a
// swizzled K-major operand whose k32 step fits in one swizzle row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256 s32, the wgmma accumulator fragment) += A (64 x 32 s8, the
// register fragment a) * B (32 x 256 s8, shared memory); d is overwritten
// instead when scale_d is 0.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The binary form, for rs_xor.cu: d (64 x 256 s32) = scale_d * d +
// popcount(A & B) over 256 bits, A 64 x 256 bits in the registers a (per
// warp, the fragment of mma.m16n8k256: word q and q + 4 of rows r, r + 8),
// B 256 x 256 (N x K) bits, K-major in shared memory.
__device__ __forceinline__ void wgmma_b1(int (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Four bits of a nibble to four bytes in {0,1}, bit t to byte t.
__device__ __forceinline__ uint32_t nibble_bits(uint32_t v) {
  return ((v & 0xFu) * 0x00204081u) & 0x01010101u;
}

// One parity byte of a consumer's accumulator.  Accumulator register
// i = 4g + 2h + e holds generator row 8g + 2q + e of data column c0 + 8h
// (lane 4r + q); the quad's bit pairs of four groups g = 4*a4 + j go into
// one word, two xor-shuffles across the quad OR them into four whole
// bytes, and lane q keeps byte q: generator rows 8g..8g+7 of g = 4*a4 + q,
// bit t = row 8g + t, for column c0 + 8h.  All 32 lanes must call it.
__device__ __forceinline__ uint32_t parity_byte(const int (&d)[128], int h, int a4, int q) {
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * (4 * a4 + j) + 2 * h;
    v |= ((static_cast<uint32_t>(d[i]) & 1u) | ((static_cast<uint32_t>(d[i + 1]) & 1u) << 1)) << (8 * j);
  }
  v <<= 2 * q;
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  v |= __shfl_xor_sync(0xffffffffu, v, 2);
  return (v >> (8 * q)) & 0xFFu;
}

// Item t of the grouped raster: GROUP_M generator bands, item by item.
__device__ __forceinline__ void item_coords(int t, int m_tiles, int n_items, int& mb, int& ib) {
  const int group = GROUP_M * n_items;
  const int first = (t / group) * GROUP_M;
  const int gm = min(GROUP_M, m_tiles - first);
  const int r = t % group;
  mb = first + r % gm;
  ib = r / gm;
}

// The whole kernel body but the epilogue.  m_tiles generator bands by
// n_items items of Epi::kTilesPerItem column tiles; k_blocks stages each.
template <class Epi>
__device__ __forceinline__ void mod2_main(const CUtensorMap* g_map, const CUtensorMap* x_map,
                                          Epi& epi, uint8_t* smem, uint32_t base, int m_tiles,
                                          int n_items, int k_blocks) {
  constexpr int TPI = Epi::kTilesPerItem;
  constexpr int XB = Epi::kXBps;
  static_assert(XB == 1 || XB == 2, "byte planes or 16-bit symbols");
  const uint32_t empty_bar = base + EPI_OFF + Epi::kSmemBytes;
  const uint32_t tma_bar = empty_bar + 8 * STAGES;

  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: producer
  const int wtid = threadIdx.x % 128;
  const int items = m_tiles * n_items;

  epi.init();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(empty_bar + 8 * s, 2);  // one arrival per consumer warpgroup
      mbar_init(tma_bar + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: TMA issue (one thread); warps 1-3 to the epilogue ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Epi::kProducerRegs));
    if (wtid >= 32) {
      epi.extra(wtid - 32, m_tiles, n_items);
    } else if (wtid == 0) {
      const int my_items = (items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
      const uint32_t total = static_cast<uint32_t>(my_items) * TPI * k_blocks;
      int ld_item = blockIdx.x, ld_j = 0, ld_kb = 0, ld_mb = 0, ld_ib = 0;
      if (ld_item < items) item_coords(ld_item, m_tiles, n_items, ld_mb, ld_ib);
      for (uint32_t it = 0; it < total; ++it) {
        const uint32_t s = it % STAGES;
        mbar_wait(empty_bar + 8 * s, ((it / STAGES) & 1u) ^ 1u);
        const uint32_t tb = tma_bar + 8 * s;
        const int nb = ld_ib * TPI + ld_j;
        mbar_expect_tx(tb, G_BYTES + P_BYTES);
        tma_load_2d(base + G_OFF + s * G_BYTES, g_map, tb, ld_kb * BK, ld_mb * TM);
        tma_load_2d(base + P_OFF + s * P_BYTES, x_map, tb, nb * TN * XB, ld_kb * (BK / (8 * XB)));
        if (++ld_kb == k_blocks) {
          ld_kb = 0;
          if (++ld_j == TPI) {
            ld_j = 0;
            ld_item += gridDim.x;
            if (ld_item < items) item_coords(ld_item, m_tiles, n_items, ld_mb, ld_ib);
          }
        }
      }
    }
  } else {
    // ---- consumers: bits into A fragments, wgmma over the ring, epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Epi::kConsumerRegs));
    const int warp = wtid / 32;
    const int lane = wtid % 32;
    const int q = lane & 3;
    const int r = lane >> 2;
    // This thread's A rows: data columns c0 and c0 + 8 of the tile.
    const int c0 = wg * (TN / 2) + warp * 16 + r;
    int d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    uint32_t it = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      int mb, ib;
      item_coords(t, m_tiles, n_items, mb, ib);
      for (int j = 0; j < TPI; ++j) {
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const uint32_t s = it % STAGES;
          // k32 step kk holds contraction bits 32kk..32kk+31 = byte rows
          // 4kk..4kk+3.  Fragment register 0 (1) is elements 4q..4q+3 of
          // column c0 (c0 + 8), registers 2 and 3 elements 16+4q..16+4q+3:
          // nibble q & 1 of byte row 4kk + q/2, resp. 4kk + 2 + q/2.
          uint32_t a[BK / 32][4];
          mbar_wait(tma_bar + 8 * s, (it / STAGES) & 1u);
          const uint8_t* P = smem + P_OFF + s * P_BYTES;
          const int sh = 4 * (q & 1);
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk) {
            // Byte row 4kk + 2e + q/2 of column c0 + 8h: in the planes at
            // row 4kk + 2e + q/2 (XB = 1), else byte q/2 of the symbol in
            // share row 2kk + e.
            uint32_t v[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                v[e][h] = XB == 1 ? P[(4 * kk + 2 * e + (q >> 1)) * TN + c0 + 8 * h]
                                  : P[(2 * kk + e) * (2 * TN) + 2 * (c0 + 8 * h) + (q >> 1)];
            a[kk][0] = nibble_bits(v[0][0] >> sh);
            a[kk][1] = nibble_bits(v[0][1] >> sh);
            a[kk][2] = nibble_bits(v[1][0] >> sh);
            a[kk][3] = nibble_bits(v[1][1] >> sh);
          }
          const uint64_t db = smem_desc(base + G_OFF + s * G_BYTES);
          fence_acc(d);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)  // k32 step: +32 bytes = +2 in the descriptor
            wgmma_s8(d, a[kk], db + 2 * kk, (kb > 0 || kk > 0) ? 1 : 0);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_acc(d);
          // The A registers are read asynchronously: keep them live (and
          // their registers unused) until the wait above.
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
          if (wtid == 0) mbar_arrive(empty_bar + 8 * s);
        }
        epi.tile(d, wg, wtid, q, c0, mb, ib * TPI + j, j);
      }
      epi.item(wg, wtid, mb, ib);
    }
    epi.finish(wg, wtid);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of `rows` rows of `width` elements (uint8 unless `type` says
// otherwise), `stride` bytes apart, read or written in boxes of box_h rows
// x box_w elements; out of bounds reads give zeros.
inline int make_map(CUtensorMap* map, const void* ptr, uint64_t width, uint64_t rows, uint64_t stride,
                    uint32_t box_w, uint32_t box_h, CUtensorMapSwizzle swizzle,
                    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_UINT8) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncodeEntry;
  const cuuint64_t dims[2] = {width, rows};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_w, box_h};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(map, type, 2, const_cast<void*>(ptr), dims, strides,
                             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(rc);
}

// The generator's map: (Pm, nm) int8 read in 128-byte-swizzled tiles of
// TM rows x BK bytes.
inline int make_g_map(CUtensorMap* map, const void* G, long long g_stride, int Pm, int nm) {
  return make_map(map, G, nm, Pm, g_stride, BK, TM, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Sets the kernel's dynamic shared memory attribute on the current device
// the first time the kernel launches there, and gives that device's SM
// count.  The attribute is per device (cudaFuncSetAttribute applies to the
// current one), so the set-up is kept per (kernel, device ordinal), under a
// lock: launches on several cards, from several threads, each find their
// own device prepared.  Returns a cudaError_t.
inline int prepare(const void* kernel, int smem, int* sms) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> prepared;  // -> SM count
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, dev);
  const auto it = prepared.find(key);
  if (it != prepared.end()) {
    *sms = it->second;
    return 0;
  }
  int count = 0;
  err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prepared.emplace(key, count);
  *sms = count;
  return 0;
}

}  // namespace rs_dense
