// Bitsliced XOR RS encode for Hopper (sm_90a): the same linear map as
// rs_dense.cu with the contraction packed 32 bits to a word.
//
// Replaces celestia_app_tpu/kernels/rs_xor.py:159 mod2_matmul_planes_xor
// (body _xor_kernel): out[r/8, c] bit r%8 = parity(XOR_w Gw[w, r] & Bw[w, c])
// over the generator words Gw (NW, Pm) of convert.pack_generator_words and
// the data words Bw (NW, cols) of kernels/rs_xor.pack_data_words.  The
// kernel takes (kernels/rs_xor.kernel_operands):
//   G   (Pm, 4*NW) uint8: Gw transposed, generator row r's contraction bits
//       LSB first, K-major as a wgmma B operand must be
//   B   (NW, cols) uint32: the data words as they are
//   out (Pm/8, cols) uint8: output bit-row r is bit r%8 of byte row r/8
// each row-major with a row stride (bytes) that is a multiple of 16 and a
// 16-byte aligned base, as TMA requires.
//
// The route: the binary tensor cores.  The parity of the AND over the
// contraction is the low bit of its popcount, which the binary mma sums
// into int32.  csrc/rs_xor_probe.cu measures the pipes on an H100
// (chip_smoke.py prints them; PERF.md): mma.sync m16n8k256 .b1 5.2e15
// bit-products/s and LOP3 on the int32 pipes (acc ^= g & b) 5.3e14, so the
// rule (the binary mma where it gives at least twice LOP3's rate) takes the
// binary pipe; wgmma m64n256k256 .b1 gives 7.9e15 of it, and this kernel
// issues it through wgmma.
//
// Bound on an H100: operations at the probe's wgmma rate.  Pm * 32*NW *
// cols bit-products, 2.6e13 at k=512 over both phases (3.3 ms), while the
// bytes moved are the size of the shares (under 1 GB, 0.25 ms).
//
// Design: rs_dense.cuh's warp-specialised TMA ring and rs_dense.cu's
// epilogue.  A work item is one tile of 256 generator rows x 128 data
// columns; the contraction runs in stages of 1024 bits through a STAGES = 4
// slot ring: one producer thread loads the generator tile [256][128 B] in
// the 128-byte swizzle and the data tile [32 words][128 columns], and each
// of two consumer warpgroups reads its A fragments from the data tile (one
// word a register: word q, q + 4 of columns c0, c0 + 8) and issues four
// wgmma m64n256k256 .b1.and.popc per stage with the generator tile as B by
// descriptor (out^T = B^T G^T, as rs_dense runs it).  The accumulator is
// rs_dense's (64 x 256 int32, 128 registers a thread), so its epilogue is
// too: bit 0 of each sum into bytes (rs_dense::parity_byte), [32][64]
// bytes through shared memory to a TMA store.  Items run in rs_dense's
// grouped raster (GROUP_M generator bands together, sharing each data tile
// from L2), one persistent block per SM.  Against the first kernel (one
// column and 64 rows a thread, LOP3, at half of its int32 bound): the AND
// and the parity run on the tensor cores, the generator reaches them from
// shared memory without the load/store pipe, and the loads run STAGES - 1
// stages ahead of them.
// Why A from registers: with both operands by descriptor the data would
// have to be K-major, a byte transpose of the planes that costs more than
// the product; the word-major data of pack_data_words is a cheaper copy,
// and costs the consumers four 4-byte loads a thread per k256 step.
// Measured (kernels/sweep_rs_dense.py; H100 80GB HBM3, 700 W): 72 % of the
// bound at k=512, and the same with the wgmma removed, so the loads, not
// the tensor cores, set its pace: 48 KB from L2 per 3.4e7 bit-products.
// The next lever is rs_dense's: a 2-block cluster that multicasts the
// generator tile.
//
// Edges: TMA fills loads past Pm, NW or the columns with zeros (a zero bit
// adds nothing to a parity) and clips the stores.

#include "rs_dense.cuh"

namespace {

using namespace rs_dense;

static_assert(TM == 256 && TN == 128, "one wgmma n256 band, two m64 consumer halves");

constexpr int KB = 128;                  // contraction bytes per stage: one swizzle row
constexpr int KW = KB / 4;               // the same in words
constexpr int GX_BYTES = TM * KB;        // generator tile [256][128 B], 32 KB
constexpr int DX_BYTES = KW * TN * 4;    // data tile [32 words][128 columns], 16 KB
constexpr int GX_OFF = 0;
constexpr int DX_OFF = GX_OFF + STAGES * GX_BYTES;
constexpr int OUT_OFF = DX_OFF + STAGES * DX_BYTES;
constexpr int O_BYTES = (TM / 8) * (TN / 2);   // one consumer's output bytes [32][64]
constexpr int BAR_OFF = OUT_OFF + 2 * O_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + the 1024-byte alignment

__global__ void __launch_bounds__(kThreads, 1)
rs_xor_kernel(__grid_constant__ const CUtensorMap g_map, __grid_constant__ const CUtensorMap x_map,
              __grid_constant__ const CUtensorMap out_map, int m_tiles, int n_tiles, int k_blocks,
              int out_rows, long long cols) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t empty_bar = base + BAR_OFF;
  const uint32_t full_bar = empty_bar + 8 * STAGES;
  const int wg = threadIdx.x / 128;  // 0, 1: consumers; 2: producer
  const int wtid = threadIdx.x % 128;
  const int items = m_tiles * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(empty_bar + 8 * s, 2);  // one arrival per consumer warpgroup
      mbar_init(full_bar + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues the TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (wtid != 0) return;
    const int my_items = (items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
    const uint32_t total = static_cast<uint32_t>(my_items) * k_blocks;
    int item = blockIdx.x, kb = 0, mb = 0, nb = 0;
    if (item < items) item_coords(item, m_tiles, n_tiles, mb, nb);
    for (uint32_t it = 0; it < total; ++it) {
      const uint32_t s = it % STAGES;
      mbar_wait(empty_bar + 8 * s, ((it / STAGES) & 1u) ^ 1u);
      const uint32_t fb = full_bar + 8 * s;
      mbar_expect_tx(fb, GX_BYTES + DX_BYTES);
      tma_load_2d(base + GX_OFF + s * GX_BYTES, &g_map, fb, kb * KB, mb * TM);
      tma_load_2d(base + DX_OFF + s * DX_BYTES, &x_map, fb, nb * TN, kb * KW);
      if (++kb == k_blocks) {
        kb = 0;
        item += gridDim.x;
        if (item < items) item_coords(item, m_tiles, n_tiles, mb, nb);
      }
    }
    return;
  }

  // ---- consumers: wgmma over the ring, then the tile's parity bytes ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = wtid % 32;
  const int q = lane & 3;
  // This thread's accumulator rows: data columns c0 and c0 + 8 of the tile.
  const int c0 = wg * (TN / 2) + (wtid / 32) * 16 + (lane >> 2);
  uint8_t* O = smem + OUT_OFF + wg * O_BYTES;  // [32 byte rows][64 columns]
  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  uint32_t it = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    int mb, nb;
    item_coords(t, m_tiles, n_tiles, mb, nb);
    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const uint32_t s = it % STAGES;
      mbar_wait(full_bar + 8 * s, (it / STAGES) & 1u);
      // k256 step kk is words 8kk..8kk+7 of the stage; fragment register 0
      // (1) is word 8kk + q of column c0 (c0 + 8), registers 2 and 3 word
      // 8kk + 4 + q.
      const uint32_t* W = reinterpret_cast<const uint32_t*>(smem + DX_OFF + s * DX_BYTES);
      uint32_t a[KW / 8][4];
#pragma unroll
      for (int kk = 0; kk < KW / 8; ++kk) {
        const uint32_t* w = W + (8 * kk + q) * TN + c0;
        a[kk][0] = w[0];
        a[kk][1] = w[8];
        a[kk][2] = w[4 * TN];
        a[kk][3] = w[4 * TN + 8];
      }
      const uint64_t db = smem_desc(base + GX_OFF + s * GX_BYTES);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KW / 8; ++kk)  // k256 step: +32 bytes = +2 in the descriptor
        wgmma_b1(d, a[kk], db + 2 * kk, (kb > 0 || kk > 0) ? 1 : 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
      // The A registers are read asynchronously: keep them live (and their
      // registers unused) until the wait above.
#pragma unroll
      for (int kk = 0; kk < KW / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
      if (wtid == 0) mbar_arrive(empty_bar + 8 * s);
    }
    // The epilogue of rs_dense.cu: the store of the previous tile must have
    // read O before it is overwritten.
    const int row_byte = mb * (TM / 8);
    const long long col0 = static_cast<long long>(nb) * TN + wg * (TN / 2);
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync(1 + wg);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int a4 = 0; a4 < TM / 32; ++a4)
        O[(4 * a4 + q) * (TN / 2) + (c0 - wg * (TN / 2)) + 8 * h] =
            static_cast<uint8_t>(parity_byte(d, h, a4, q));
    fence_proxy_async();
    named_sync(1 + wg);
    if (wtid == 0 && row_byte < out_rows && col0 < cols)
      tma_store_2d(&out_map, base + OUT_OFF + wg * O_BYTES, static_cast<int>(col0), row_byte);
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// G (Pm, 4*nw) uint8, B (nw, cols) uint32 and out (Pm/8, cols) uint8,
// row-major with the given row strides in bytes (multiples of 16, bases
// 16-byte aligned); Pm a multiple of 8, cols >= 1.  Returns a cudaError_t,
// or 1999 / 2000 + CUresult when a tensor map cannot be made.
extern "C" int rs_xor_mod2(const void* G, long long g_stride, const void* B, long long b_stride,
                           void* out, long long out_stride, int Pm, int nw, long long cols,
                           void* stream) {
  CUtensorMap g_map, x_map, out_map;
  int rc = make_map(&g_map, G, 4LL * nw, Pm, g_stride, KB, TM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map(&x_map, B, cols, nw, b_stride, TN, KW, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_DATA_TYPE_UINT32);
  if (rc == 0)
    rc = make_map(&out_map, out, cols, Pm / 8, out_stride, TN / 2, TM / 8, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;

  int sms = 0;
  const int err = prepare(reinterpret_cast<const void*>(rs_xor_kernel), SMEM_BYTES, &sms);
  if (err != 0) return err;
  const int m_tiles = (Pm + TM - 1) / TM;
  const int n_tiles = static_cast<int>((cols + TN - 1) / TN);
  const long long tiles = static_cast<long long>(m_tiles) * n_tiles;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  rs_xor_kernel<<<grid, kThreads, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      g_map, x_map, out_map, m_tiles, n_tiles, (nw + KW - 1) / KW, Pm / 8, cols);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's build-time configuration, for reports: generator rows and
// data columns per tile, contraction bytes per stage, ring slots,
// producer and consumer registers (setmaxnreg), dynamic shared memory
// bytes, threads per block.
extern "C" int rs_xor_info(int* values) {
  const int v[8] = {TM, TN, KB, STAGES, kProducerRegs, kConsumerRegs, SMEM_BYTES, kThreads};
  for (int i = 0; i < 8; ++i) values[i] = v[i];
  return 0;
}
