// Dense RS encode for Hopper (sm_90a): parity = (G_bits x bits(x)) mod 2.
//
// Replaces celestia_app_tpu/kernels/rs_pallas.py::mod2_matmul_planes_pallas
// (body _kernel) and its XLA twin kernels/rs.py::_mod2_matmul_planes.
//   G   (Pm, nm) int8 in {0,1}: the bit-expanded generator, Pm = P*m, nm = n*m
//   x   (nm/8, cols) uint8: byte planes; contraction index 8q + t is bit t
//       (LSB first) of byte row q (gf/field.expand_bit_matrix order)
//   out (Pm/8, cols) uint8: output bit-row r is bit r%8 of byte row r/8
// Each of the three is row-major with a row stride (in bytes) that is a
// multiple of 16 and a 16-byte aligned base, as TMA requires; the wrapper
// (kernels/rs_dense.py) pads strides where a caller's are not.
//
// Bound on an H100: operations.  2*Pm*nm*cols int8 operations against
// nm/8 + Pm/8 bytes per column: at k=512 the two phases are 5.3e13
// operations (27 ms at the 1,979 TOP/s int8 dense peak) and move under
// 1 GB (0.3 ms at 3.35 TB/s).
//
// Design: the warp-specialised TMA ring and register-A int8 wgmma main
// loop of rs_dense.cuh, one tile per work item.  Epilogue: each consumer's
// 32 x 64 parity bytes (rs_dense::parity_byte) go through shared memory to
// a TMA store, which the next tile's first stages (already loaded by the
// producer) overlap.  TMA clips the stores, so every Pm, nm that is a
// multiple of 8 and every cols is served, from the 8x8 generator of k=1 to
// k=512.

#include "rs_dense.cuh"

namespace {

using namespace rs_dense;

constexpr int O_BYTES = (TM / 8) * (TN / 2);  // one consumer's output bytes [32][64], 2 KB
constexpr int SMEM_BYTES = smem_bytes(2 * O_BYTES);

struct PlanesOut {
  static constexpr int kTilesPerItem = 1;
  static constexpr int kXBps = 1;
  static constexpr int kSmemBytes = 2 * O_BYTES;
  static constexpr int kProducerRegs = rs_dense::kProducerRegs;
  static constexpr int kConsumerRegs = rs_dense::kConsumerRegs;

  const CUtensorMap* out_map;
  uint8_t* smem;
  uint32_t base;
  int out_rows;
  long long cols;

  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ void extra(int, int, int) {}
  __device__ __forceinline__ void item(int, int, int, int) {}

  __device__ __forceinline__ void tile(const int (&d)[128], int wg, int wtid, int q, int c0, int mb,
                                       int nb, int) {
    const int row_byte = mb * (TM / 8);
    const long long col0 = static_cast<long long>(nb) * TN + wg * (TN / 2);
    uint8_t* O = smem + EPI_OFF + wg * O_BYTES;  // [32 byte rows][64 columns]
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync(1 + wg);  // the previous tile's store has read O
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int a4 = 0; a4 < TM / 32; ++a4)
        O[(4 * a4 + q) * (TN / 2) + (c0 - wg * (TN / 2)) + 8 * h] =
            static_cast<uint8_t>(parity_byte(d, h, a4, q));
    fence_proxy_async();
    named_sync(1 + wg);
    if (wtid == 0 && row_byte < out_rows && col0 < cols)
      tma_store_2d(out_map, base + EPI_OFF + wg * O_BYTES, static_cast<int>(col0), row_byte);
  }

  __device__ __forceinline__ void finish(int, int wtid) {
    if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
};

__global__ void __launch_bounds__(kThreads, 1)
rs_dense_kernel(__grid_constant__ const CUtensorMap g_map, __grid_constant__ const CUtensorMap x_map,
                __grid_constant__ const CUtensorMap out_map, int m_tiles, int n_tiles, int k_blocks,
                int out_rows, long long cols) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  PlanesOut epi{&out_map, smem, base, out_rows, cols};
  mod2_main(&g_map, &x_map, epi, smem, base, m_tiles, n_tiles, k_blocks);
}

}  // namespace

// G (Pm, nm) int8, x (nm/8, cols) uint8, out (Pm/8, cols) uint8, row-major
// with the given row strides in bytes (multiples of 16, bases 16-byte
// aligned); Pm and nm multiples of 8, cols >= 1.  Returns a cudaError_t, or
// 1999 / 2000 + CUresult when a tensor map cannot be made.
extern "C" int rs_dense_mod2(const void* G, long long g_stride, const void* x, long long x_stride,
                             void* out, long long out_stride, int Pm, int nm, long long cols,
                             void* stream) {
  CUtensorMap g_map, x_map, out_map;
  int rc = make_g_map(&g_map, G, g_stride, Pm, nm);
  if (rc == 0) rc = make_map(&x_map, x, cols, nm / 8, x_stride, TN, BK / 8, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = make_map(&out_map, out, cols, Pm / 8, out_stride, TN / 2, TM / 8, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;

  int sms = 0;
  const int err = prepare(reinterpret_cast<const void*>(rs_dense_kernel), SMEM_BYTES, &sms);
  if (err != 0) return err;
  const int m_tiles = (Pm + TM - 1) / TM;
  const int n_tiles = static_cast<int>((cols + TN - 1) / TN);
  const long long tiles = static_cast<long long>(m_tiles) * n_tiles;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  rs_dense_kernel<<<grid, kThreads, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      g_map, x_map, out_map, m_tiles, n_tiles, (nm + BK - 1) / BK, Pm / 8, cols);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's build-time configuration, for reports: generator rows and
// data columns per tile, BK, stages,
// producer and consumer registers (setmaxnreg), dynamic shared memory bytes,
// threads per block.
extern "C" int rs_dense_info(int* values) {
  const int v[8] = {TM, TN, BK, STAGES, kProducerRegs, kConsumerRegs, SMEM_BYTES, kThreads};
  for (int i = 0; i < 8; ++i) values[i] = v[i];
  return 0;
}
