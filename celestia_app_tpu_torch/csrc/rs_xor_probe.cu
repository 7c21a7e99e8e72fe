// The pipes of the card that rs_xor.cu's inner product could run on,
// measured for its choice.  It replaces no TPU kernel, and nothing on the
// main path calls it: chip_smoke.py phase_kernels runs it and prints the
// rates.
//
//   mode 0, the binary tensor cores through mma.sync: each warp issues a
//     loop of independent mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32
//     .and.popc, each 16 x 8 x 256 = 32,768 bit-products (AND, then
//     popcount into int32);
//   mode 1, the int32 pipes: each thread runs a loop of acc ^= g & b on
//     registers, one LOP3 of 32 bit-products each;
//   mode 2, the binary tensor cores through wgmma: each warpgroup issues
//     rs_dense::wgmma_b1 (wgmma.mma_async m64n256k256 .s32.b1.b1.and.popc,
//     A from registers, B from a 32 KB shared tile by descriptor), four at
//     a time, 4,194,304 bit-products each.
//
// Each runs on every SM at once.  The operands come from the thread index,
// the mma chains feed their accumulators back and the LOP3 chains read one
// another's accumulators (acc[i] ^= g[i] & acc[i + 5]), so the compiler can
// neither fold a loop nor drop one, and each launch writes one word per
// thread so that no chain is dead.

#include <cstdint>
#include <cuda_runtime.h>

#include "rs_dense.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMmaChains = 8;    // independent mma accumulators per warp
constexpr int kLopChains = 16;   // independent LOP3 accumulators per thread

__global__ void __launch_bounds__(kThreads) probe_mma(int iters, uint32_t* out) {
  const uint32_t t = threadIdx.x + blockIdx.x * kThreads;
  const uint32_t a0 = t * 0x9e3779b9u, a1 = a0 ^ 0x85ebca6bu, a2 = a0 + 0xc2b2ae35u, a3 = ~a0;
  const uint32_t b0 = t * 0x27d4eb2fu, b1 = b0 ^ 0x165667b1u;
  int d[kMmaChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kMmaChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kMmaChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[t] = static_cast<uint32_t>(s);
}

__global__ void __launch_bounds__(kThreads) probe_lop3(int iters, uint32_t* out) {
  const uint32_t t = threadIdx.x + blockIdx.x * kThreads;
  uint32_t g[kLopChains], acc[kLopChains];
#pragma unroll
  for (int i = 0; i < kLopChains; ++i) {
    g[i] = (t + 1) * (2u * i + 1u) * 0x9e3779b9u;
    acc[i] = t ^ (0x85ebca6bu * (i + 1));
  }
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kLopChains; ++i) acc[i] ^= g[i] & acc[(i + 5) % kLopChains];
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kLopChains; ++i) s ^= acc[i];
  out[t] = s;
}

__global__ void __launch_bounds__(kThreads, 1) probe_wgmma(int iters, uint32_t* out) {
  __shared__ __align__(1024) uint8_t tile[256 * 128];
  const uint32_t t = threadIdx.x + blockIdx.x * kThreads;
  for (int i = threadIdx.x; i < 256 * 128 / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(tile)[i] = (i + blockIdx.x) * 0x9e3779b9u;
  rs_dense::fence_proxy_async();
  __syncthreads();
  const uint64_t db = rs_dense::smem_desc(rs_dense::smem_u32(tile));
  const uint32_t a[4] = {t * 0x9e3779b9u, t ^ 0x85ebca6bu, t + 0xc2b2ae35u, ~t};
  int d[128] = {};
  for (int i = 0; i < iters; ++i) {
    rs_dense::fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) rs_dense::wgmma_b1(d, a, db + 2 * k, 1);  // k256: +32 bytes
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    rs_dense::fence_acc(d);
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += d[i];
  out[t] = static_cast<uint32_t>(s);
}

}  // namespace

// mode 0 (binary mma.sync), 1 (LOP3) or 2 (binary wgmma); `blocks` blocks
// of 256 threads, each thread `iters` loop trips; out holds blocks * 256
// words.  Bit-products per launch: mode 0 blocks * 8 warps * iters * 8 *
// 32768, mode 1 blocks * 256 * iters * 16 * 32, mode 2 blocks * 2
// warpgroups * iters * 4 * 4194304.  Returns a cudaError_t.
extern "C" int rs_xor_probe(int mode, int blocks, int iters, void* out, void* stream) {
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    probe_mma<<<blocks, kThreads, 0, s>>>(iters, o);
  else if (mode == 1)
    probe_lop3<<<blocks, kThreads, 0, s>>>(iters, o);
  else if (mode == 2)
    probe_wgmma<<<blocks, kThreads, 0, s>>>(iters, o);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The probe's constants, for the rates: threads per block, mma chains per
// warp, bit-products per mma, LOP3 chains per thread, bit-products per
// LOP3, wgmma per warpgroup and loop trip, bit-products per wgmma.
extern "C" int rs_xor_probe_info(int* values) {
  const int v[7] = {kThreads, kMmaChains, 16 * 8 * 256, kLopChains, 32, 4, 64 * 256 * 256};
  for (int i = 0; i < 7; ++i) values[i] = v[i];
  return 0;
}
