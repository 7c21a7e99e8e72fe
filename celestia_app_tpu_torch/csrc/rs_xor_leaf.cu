// Fused column-phase RS extend + NMT leaf digests for Hopper (sm_90a): the
// leaf-hash epilogue of the fused_epi pipeline.
//
// Replaces celestia_app_tpu/kernels/rs_xor.py::extend_leaf_digests (body
// _epi_kernel).  For the row-extended top half (k, 2k, 512) it computes
//   bottom[p, b, :] = the column-phase parity share p of batch column b
//                     (the XOR schedule of rs_xor.cu, contraction over the
//                     top half's row axis);
//   hashes[p, b, :] = sha256(0x00 || 0xFF^29 || bottom[p, b, :]), the NMT
//                     leaf digest under the parity namespace every bottom
//                     leaf carries.
// Inputs:
//   Gw (NW, Pm) uint32: generator rows, Pm = P*m (convert.pack_generator_words)
//   Bw (NW, 2k*nsym) uint32: the top half's byte planes, column b*nsym + sym
//                     (kernels/rs_xor.pack_data_words of _top_planes)
//
// Bound on an H100: operations.  Pm*NW*2k*nsym steps acc ^= g & b, one
// LOP3 each on the int32 pipes: 5.5e11 at k=512 (m=16), about 33 ms, while
// the SHA-256 half is 9 compressions per leaf (~1 % of the work) and the
// bytes moved are about 0.55 GB (0.16 ms).
//
// What the design does about it, and why it is not rs_xor.cu's tiling:
// share p of batch column b is output bit-rows [p*m, (p+1)*m) over the
// nsym symbol columns of b, so one block owns one batch column and a tile
// of T whole shares, and its nsym threads are those columns (512 threads
// for m=8, 256 for m=16).  Each thread walks the tile's bit-rows in passes
// of RT register accumulators, each data word (coalesced across the block)
// feeding RT AND-XOR steps against generator words broadcast from shared
// memory, as in rs_xor.cu.  Folded parity bytes land in a shared tile of T
// share rows, already in share byte order (symbol sym's byte b at offset
// sym*bps + b), so the tile leaves as the final (k, 2k, 512) layout with
// coalesced stores and no plane regroup.  Then T threads hash one share
// each straight from the tile: the 30-byte prefix is constant, every later
// message word is one __byte_perm of two tile words (the share starts at
// message byte 30, two bytes into a word), and the word after the share
// holds the 0x80 padding byte.  Rows are 129 words apart, so the T threads
// reading the same word of their rows hit distinct banks.  Every edge is
// masked: k = 1 (one 8-row pass) to k = 4096 all run.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kShares = 64;      // T: shares per block
constexpr int kRows = 64;        // RT: output bit-rows per pass (accumulators)
constexpr int kWords = 32;       // generator words staged per pass
constexpr int kRowWords = 129;   // tile row: 128 share words + the padding word
constexpr uint32_t kLeafBits = (1 + 29 + 512) * 8;  // message length in bits

template <int M>
__global__ void __launch_bounds__(4096 / M)
rs_xor_leaf_kernel(const uint32_t* __restrict__ Gw, const uint32_t* __restrict__ Bw,
                   uint32_t* __restrict__ bottom, uint8_t* __restrict__ hashes,
                   int nw, int Pm, int n2) {
  constexpr int kBps = M / 8;
  constexpr int kNsym = 512 / kBps;  // threads: one per symbol column
  __shared__ __align__(16) uint32_t Gs[kWords][kRows];
  __shared__ uint32_t tile[kShares][kRowWords];
  uint8_t* tile_bytes = reinterpret_cast<uint8_t*>(&tile[0][0]);

  const int b = blockIdx.x;
  const int p0 = blockIdx.y * kShares;
  const int nt = min(kShares, Pm / M - p0);  // shares in this tile
  const int row_begin = p0 * M;
  const int row_end = row_begin + nt * M;
  const long long cols = static_cast<long long>(n2) * kNsym;
  const long long c = static_cast<long long>(b) * kNsym + threadIdx.x;

  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    uint32_t acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0u;
    for (int w0 = 0; w0 < nw; w0 += kWords) {
      __syncthreads();
      for (int i = threadIdx.x; i < kWords * kRows; i += kNsym) {
        const int w = i / kRows;
        const int r = i % kRows;
        const int gw = w0 + w;
        const int gr = r0 + r;
        Gs[w][r] = (gw < nw && gr < row_end) ? Gw[static_cast<long long>(gw) * Pm + gr] : 0u;
      }
      __syncthreads();
      const int wend = min(kWords, nw - w0);
      for (int w = 0; w < wend; ++w) {
        const uint32_t bw = Bw[static_cast<long long>(w0 + w) * cols + c];
        const uint4* g = reinterpret_cast<const uint4*>(Gs[w]);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const uint4 gv = g[q];
          acc[4 * q + 0] ^= gv.x & bw;
          acc[4 * q + 1] ^= gv.y & bw;
          acc[4 * q + 2] ^= gv.z & bw;
          acc[4 * q + 3] ^= gv.w & bw;
        }
      }
    }
    // Bit-rows 8q..8q+7 of the pass are byte row (r0 + 8q) / 8 = p*bps + bb:
    // byte bb of symbol threadIdx.x of share p.
#pragma unroll
    for (int q = 0; q < kRows / 8; ++q) {
      const int row = r0 + 8 * q;
      if (row < row_end) {
        uint32_t byte = 0u;
#pragma unroll
        for (int t = 0; t < 8; ++t) byte |= (__popc(acc[8 * q + t]) & 1u) << t;
        const int brow = row / 8;
        const int p = brow / kBps - p0;
        tile_bytes[p * (kRowWords * 4) + threadIdx.x * kBps + brow % kBps] =
            static_cast<uint8_t>(byte);
      }
    }
  }
  __syncthreads();

  // The tile's shares to bottom[p0 + p, b, :], 128 words each.
  for (int i = threadIdx.x; i < nt * 128; i += kNsym) {
    const int p = i >> 7;
    bottom[(static_cast<long long>(p0 + p) * n2 + b) * 128 + (i & 127)] = tile[p][i & 127];
  }

  if (threadIdx.x < nt) {
    const int p = threadIdx.x;
    const uint32_t* row = tile[p];
    tile[p][128] = 0x80u;  // message byte 542: the SHA padding byte
    uint32_t st[8];
    uint32_t w[16];
    sha256_init(st);
    // Block 0: 0x00, 0xFF x 29, then share bytes 0..33.
    w[0] = 0x00FFFFFFu;
#pragma unroll
    for (int j = 1; j < 7; ++j) w[j] = 0xFFFFFFFFu;
    w[7] = __byte_perm(0xFFFFFFFFu, row[0], 0x2345);
#pragma unroll
    for (int j = 8; j < 16; ++j) w[j] = __byte_perm(row[j - 8], row[j - 7], 0x2345);
    sha256_compress(st, w);
    // Message word g >= 8 is share bytes 4(g-8)+2 .. 4(g-8)+5: the upper two
    // bytes of tile word g-8 and the lower two of word g-7.
    for (int blk = 1; blk < 9; ++blk) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int g = blk * 16 + j;
        w[j] = g <= 135 ? __byte_perm(row[g - 8], row[g - 7], 0x2345)
                        : (g == 143 ? kLeafBits : 0u);
      }
      sha256_compress(st, w);
    }
    uint4* dst = reinterpret_cast<uint4*>(hashes + (static_cast<long long>(p0 + p) * n2 + b) * 32);
    dst[0] = make_uint4(__byte_perm(st[0], 0, 0x0123), __byte_perm(st[1], 0, 0x0123),
                        __byte_perm(st[2], 0, 0x0123), __byte_perm(st[3], 0, 0x0123));
    dst[1] = make_uint4(__byte_perm(st[4], 0, 0x0123), __byte_perm(st[5], 0, 0x0123),
                        __byte_perm(st[6], 0, 0x0123), __byte_perm(st[7], 0, 0x0123));
  }
}

}  // namespace

// Gw (nw, Pm) and Bw (nw, n2 * 4096/m) 32-bit words; bottom (Pm/m, n2, 512)
// and hashes (Pm/m, n2, 32) uint8, all row-major; m is 8 or 16.
extern "C" int rs_xor_leaf(const void* Gw, const void* Bw, void* bottom, void* hashes,
                           int nw, int Pm, int n2, int m, void* stream) {
  const int P = Pm / m;
  const dim3 grid(static_cast<unsigned int>(n2),
                  static_cast<unsigned int>((P + kShares - 1) / kShares));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* g = static_cast<const uint32_t*>(Gw);
  const uint32_t* d = static_cast<const uint32_t*>(Bw);
  uint32_t* out = static_cast<uint32_t*>(bottom);
  uint8_t* dig = static_cast<uint8_t*>(hashes);
  if (m == 8) {
    rs_xor_leaf_kernel<8><<<grid, 512, 0, s>>>(g, d, out, dig, nw, Pm, n2);
  } else if (m == 16) {
    rs_xor_leaf_kernel<16><<<grid, 256, 0, s>>>(g, d, out, dig, nw, Pm, n2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
