// Fused column-phase RS extend + NMT leaf digests for Hopper (sm_90a): the
// leaf-hash epilogue of the fused_epi pipeline.
//
// Replaces celestia_app_tpu/kernels/rs_xor.py::extend_leaf_digests (body
// _epi_kernel).  For the row-extended top half x (n, n2, 512) and the
// bit-expanded generator G (P*m, n*m) it computes
//   bottom[p, b, :] = parity share p of batch column b: the column-phase
//                     encode, contraction over x's first axis, byte for
//                     byte the dense kernel's (rs_dense.cu) result;
//   hashes[p, b, :] = sha256(0x00 || 0xFF^29 || bottom[p, b, :]), the NMT
//                     leaf digest under the parity namespace every bottom
//                     leaf carries.
//
// Bound on an H100: int8 tensor operations.  2*Pm*nm*cols of them on the
// unpacked bits (cols = n2 * 4096/m): 3.5e13 at k=512 (m=16), 17.8 ms at
// the 1,979 TOP/s int8 dense peak, while the hash half is 9 compressions
// per leaf (0.4 ms on the int32 pipes, which run beside the tensor cores)
// and the bytes moved are about 0.6 GB (0.2 ms).
//
// Design: rs_dense.cuh's main loop (TMA ring, register-A wgmma against the
// generator) with a work item of one generator band and one batch column.
// Share p of batch column b is output bit-rows [p*m, (p+1)*m) over the
// nsym = 4096/m symbol columns of b, so a band of 256 bit-rows is 16 whole
// shares at m=16 (32 at m=8) and an item is the nsym/128 column tiles of
// one batch column.  Each tile's parity bytes go from the accumulator into
// a shared share tile already in share byte order (byte t of symbol s at
// offset s*bps + t); once the item's last tile has landed, the share tile
// leaves as the final (P, n2, 512) layout with coalesced stores and no
// plane regroup, and one thread per share hashes it straight from the
// tile: the 30-byte prefix is constant, every later message word is one
// __byte_perm of two tile words (the share starts at message byte 30, two
// bytes into a word), and the word after the share holds the 0x80 padding
// byte.  Rows are 129 words apart, so the threads reading the same word of
// their rows hit distinct banks.
//
// Where the hash runs (kHashMode).  A share's digest is 9 dependent
// compressions, 1.5 us or so of one warp; on the consumers after each item
// (mode 0) that stalls the tensor cores for about a sixth of an item's
// time at k=512 (kernels/sweep_rs_dense.py times both modes and a build
// without the hash).  Mode 1, built in: producer warps 1-3, which the main
// loop leaves free (rs_dense.cuh), store and hash each item's share tile
// while the consumers compute the next item into a second tile; a
// full/empty mbarrier pair per tile hands it over.  Hashing needs ~50
// registers, so the producer warpgroup runs at 64 (the consumers' code is
// compiled to the launch's 168 registers a thread either way).
//
// Input: x is read as it lies.  At m=8 the half square's rows are already
// byte planes; at m=16 the main loop's share-order layout de-interleaves a
// symbol's two bytes in the consumers' reads (kShareOrder; the build
// with it off reads (2n, n2*256) byte planes instead).  Edges: TMA
// zero-fills loads past Pm, nm and the columns; the epilogue stores and
// hashes only the P shares that exist, so k = 1 (an 8x8 generator, one
// share per band) to k = 512 and any P != n run.

#include "rs_dense.cuh"
#include "sha256.cuh"

namespace {

using namespace rs_dense;

constexpr bool kShareOrder = true;  // m=16 data in share byte order (else byte planes)
constexpr int kHashMode = 1;        // 0: consumers, after each item; 1: producer warps 1-3
constexpr int kTileBufs = kHashMode == 0 ? 1 : 2;
constexpr int kRowWords = 129;      // share tile row: 128 share words + the padding word
constexpr int kSha = 9;             // compressions per leaf message (542 bytes)
constexpr uint32_t kLeafBits = (1 + 29 + 512) * 8;  // message length in bits

// Compression `blk` of sha256(0x00 || 0xFF^29 || share) for the share in
// tile row `row` (words 0..127, word 128 = 0x80).
__device__ __forceinline__ void leaf_block(uint32_t (&st)[8], const uint32_t* row, int blk) {
  uint32_t w[16];
  if (blk == 0) {
    // 0x00, 0xFF x 29, then share bytes 0..33.
    w[0] = 0x00FFFFFFu;
#pragma unroll
    for (int j = 1; j < 7; ++j) w[j] = 0xFFFFFFFFu;
    w[7] = __byte_perm(0xFFFFFFFFu, row[0], 0x2345);
#pragma unroll
    for (int j = 8; j < 16; ++j) w[j] = __byte_perm(row[j - 8], row[j - 7], 0x2345);
  } else {
    // Message word g >= 8 is share bytes 4(g-8)+2 .. 4(g-8)+5: the upper
    // two bytes of tile word g-8 and the lower two of word g-7.
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int g = blk * 16 + j;
      w[j] = g <= 135 ? __byte_perm(row[g - 8], row[g - 7], 0x2345) : (g == 143 ? kLeafBits : 0u);
    }
  }
  sha256_compress(st, w);
}

__device__ __forceinline__ void store_digest(const uint32_t (&st)[8], uint8_t* dst) {
  uint4* out = reinterpret_cast<uint4*>(dst);
  out[0] = make_uint4(__byte_perm(st[0], 0, 0x0123), __byte_perm(st[1], 0, 0x0123),
                      __byte_perm(st[2], 0, 0x0123), __byte_perm(st[3], 0, 0x0123));
  out[1] = make_uint4(__byte_perm(st[4], 0, 0x0123), __byte_perm(st[5], 0, 0x0123),
                      __byte_perm(st[6], 0, 0x0123), __byte_perm(st[7], 0, 0x0123));
}

// The whole leaf digest of the share in tile row `row`, to dst (32 bytes).
__device__ __forceinline__ void hash_leaf(const uint32_t* row, uint8_t* dst) {
  uint32_t st[8];
  sha256_init(st);
#pragma unroll 1
  for (int blk = 0; blk < kSha; ++blk) leaf_block(st, row, blk);
  store_digest(st, dst);
}

template <int M>
struct LeafOut {
  static constexpr int kBps = M / 8;
  static constexpr int kNsym = 512 / kBps;          // symbols per share
  static constexpr int kTilesPerItem = kNsym / TN;  // 2 at m=16, 4 at m=8
  static constexpr int kXBps = kShareOrder ? kBps : 1;
  static constexpr int kShares = TM / M;            // shares per band: 16 or 32
  static constexpr int kTileWords = kShares * kRowWords;
  // Mode 1's full[2] and empty[2] barriers, then the share tiles.
  static constexpr int kBarBytes = 32;
  static constexpr int kSmemBytes = kBarBytes + kTileBufs * kTileWords * 4;
  static constexpr int kProducerRegs = kHashMode == 1 ? 64 : rs_dense::kProducerRegs;
  static constexpr int kConsumerRegs = kHashMode == 1 ? 216 : rs_dense::kConsumerRegs;

  uint32_t bars;    // shared address of full[2], empty[2]
  uint32_t* tiles;  // [kTileBufs][kShares][kRowWords]
  uint32_t* bottom;
  uint8_t* hashes;
  int P, n2;
  int items_done;  // consumers: this block's items so far, the share tile in use

  __device__ __forceinline__ void init() {
    for (int i = threadIdx.x; i < kTileBufs * kShares; i += blockDim.x) tiles[i * kRowWords + 128] = 0x80u;
    if (kHashMode == 1 && threadIdx.x == 0) {
      for (int b = 0; b < 2; ++b) {
        mbar_init(bars + 8 * b, 256);     // full: every consumer thread scattered its bytes
        mbar_init(bars + 16 + 8 * b, 1);  // empty: the hashing warps are done with the tile
      }
    }
    items_done = 0;
  }

  __device__ __forceinline__ uint8_t* digest(int p0, int p, int ib) const {
    return hashes + ((static_cast<long long>(p0 + p) * n2 + ib) * 32);
  }

  // The bottom shares and their digests of the item in share tile T.
  __device__ __forceinline__ void store_and_hash(const uint32_t* T, int mb, int ib, int tid,
                                                 int threads) {
    const int p0 = mb * kShares;
    const int nsh = min(kShares, P - p0);
    for (int i = tid; i < nsh * 128; i += threads) {
      const int p = i >> 7;
      bottom[(static_cast<long long>(p0 + p) * n2 + ib) * 128 + (i & 127)] = T[p * kRowWords + (i & 127)];
    }
    if (tid < nsh) hash_leaf(T + tid * kRowWords, digest(p0, tid, ib));
  }

  // Mode 1: producer warps 1-3, item by item as the consumers fill them.
  __device__ __forceinline__ void extra(int tid, int m_tiles, int n_items) {
    if (kHashMode != 1) return;
    int u = 0;
    for (int t = blockIdx.x; t < m_tiles * n_items; t += gridDim.x, ++u) {
      int mb, ib;
      item_coords(t, m_tiles, n_items, mb, ib);
      const int buf = u & 1;
      mbar_wait(bars + 8 * buf, (u >> 1) & 1);
      store_and_hash(tiles + buf * kTileWords, mb, ib, tid, 96);
      named_sync(4, 96);
      if (tid == 0) mbar_arrive(bars + 16 + 8 * buf);
    }
  }

  __device__ __forceinline__ void tile(const int (&d)[128], int, int, int q, int c0, int, int, int j) {
    const int buf = items_done % kTileBufs;
    if (kHashMode == 1 && j == 0) mbar_wait(bars + 16 + 8 * buf, ((items_done >> 1) & 1) ^ 1);
    uint8_t* T = reinterpret_cast<uint8_t*>(tiles + buf * kTileWords);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int a4 = 0; a4 < TM / 32; ++a4) {
        // Byte row g of the band is byte g % bps of share g / bps.
        const int g = 4 * a4 + q;
        const int s = j * TN + c0 + 8 * h;
        T[(g / kBps) * (kRowWords * 4) + s * kBps + g % kBps] =
            static_cast<uint8_t>(parity_byte(d, h, a4, q));
      }
  }

  __device__ __forceinline__ void item(int wg, int wtid, int mb, int ib) {
    const int buf = items_done % kTileBufs;
    ++items_done;
    if (kHashMode == 1) {
      mbar_arrive(bars + 8 * buf);
      return;
    }
    named_sync(3, 256);  // every tile of this item has landed
    store_and_hash(tiles + buf * kTileWords, mb, ib, wg * 128 + wtid, 256);
    named_sync(3, 256);  // the hash has read the tile before the next item writes it
  }

  __device__ __forceinline__ void finish(int, int) {}
};

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
rs_dense_leaf_kernel(__grid_constant__ const CUtensorMap g_map, __grid_constant__ const CUtensorMap x_map,
                     uint32_t* bottom, uint8_t* hashes, int P, int n2, int m_tiles, int k_blocks) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  LeafOut<M> epi;
  epi.bars = base + EPI_OFF;
  epi.tiles = reinterpret_cast<uint32_t*>(smem + EPI_OFF + LeafOut<M>::kBarBytes);
  epi.bottom = bottom;
  epi.hashes = hashes;
  epi.P = P;
  epi.n2 = n2;
  mod2_main(&g_map, &x_map, epi, smem, base, m_tiles, n2, k_blocks);
}

template <int M>
int launch(const void* G, long long g_stride, const void* x, long long x_stride, void* bottom,
           void* hashes, int Pm, int nm, int n2, cudaStream_t stream) {
  using Epi = LeafOut<M>;
  constexpr int XB = Epi::kXBps;
  constexpr int SMEM = smem_bytes(Epi::kSmemBytes);
  CUtensorMap g_map, x_map;
  int rc = make_g_map(&g_map, G, g_stride, Pm, nm);
  if (rc == 0)
    rc = make_map(&x_map, x, static_cast<uint64_t>(n2) * Epi::kNsym * XB, nm / (8 * XB), x_stride,
                  TN * XB, BK / (8 * XB), CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  int sms = 0;
  const int err = prepare(reinterpret_cast<const void*>(rs_dense_leaf_kernel<M>), SMEM, &sms);
  if (err != 0) return err;
  const int m_tiles = (Pm + TM - 1) / TM;
  const long long items = static_cast<long long>(m_tiles) * n2;
  const int grid = static_cast<int>(items < sms ? items : sms);
  rs_dense_leaf_kernel<M><<<grid, kThreads, SMEM, stream>>>(
      g_map, x_map, static_cast<uint32_t*>(bottom), static_cast<uint8_t*>(hashes), Pm / M, n2, m_tiles,
      (nm + BK - 1) / BK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G (Pm, nm) int8 {0,1} with row stride g_stride; x the half square
// (nm/m, n2, 512) uint8 as (nm/m) rows of n2*512 bytes, x_stride apart
// (with kShareOrder off and m=16: byte planes, (nm/8) rows of n2*256);
// bottom (Pm/m, n2, 512) and hashes (Pm/m, n2, 32) uint8, contiguous.
// Strides multiples of 16 and bases 16-byte aligned; m is 8 or 16, Pm and
// nm multiples of m.  Returns a cudaError_t, or 1999 / 2000 + CUresult
// when a tensor map cannot be made.
extern "C" int rs_dense_leaf(const void* G, long long g_stride, const void* x, long long x_stride,
                             void* bottom, void* hashes, int Pm, int nm, int n2, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 8) return launch<8>(G, g_stride, x, x_stride, bottom, hashes, Pm, nm, n2, s);
  if (m == 16) return launch<16>(G, g_stride, x, x_stride, bottom, hashes, Pm, nm, n2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's build-time configuration at symbol width m, for reports:
// generator rows and data columns per tile, BK, stages, producer and
// consumer registers (setmaxnreg), dynamic shared memory bytes, threads
// per block, shares per band, column tiles per item, share-order input,
// hash mode.
extern "C" int rs_dense_leaf_info(int m, int* values) {
  if (m != 8 && m != 16) return static_cast<int>(cudaErrorInvalidValue);
  using Epi = LeafOut<8>;
  const int smem = m == 8 ? smem_bytes(LeafOut<8>::kSmemBytes) : smem_bytes(LeafOut<16>::kSmemBytes);
  const int v[12] = {TM, TN, BK, STAGES, Epi::kProducerRegs, Epi::kConsumerRegs, smem, kThreads,
                     TM / m, 512 / (m / 8) / TN, kShareOrder ? 1 : 0, kHashMode};
  for (int i = 0; i < 12; ++i) values[i] = v[i];
  return 0;
}
