// K1: one INT8 dense layer with the fused epilogue,
//   y = sat8(round_half_away(relu(x @ w + b) >> shift))   (int8 out)
//   y = relu(x @ w + b)                                   (raw int32 out)
// x (M, K) int8, w (K, N) int8, bias (N,) int32 or null.
//
// Replaces: src/repro/kernels/mm_int8/mm_int8.py, mm_int8_pallas (the
// per-layer baseline that ops.mlp_unfused chains, one launch per layer).
//
// What bounds it here: at the jet models' widths (K, N <= 128, M a few
// thousand rows) a layer moves a few hundred kilobytes and does some ten
// million int8 operations, so its bound (from bytes at 3.35 TB/s; the 1979
// TOPS bound is far lower) is under 200 nanoseconds, and the launch itself
// (microseconds) dominates. The design is the simple tiled product: one
// 256-thread block per 64x64 output tile, x and w staged over K in 32-byte
// slabs of shared memory (w transposed, both zero-padded at ragged edges, so
// no word read crosses a row end), and each thread accumulating a 4x4
// sub-tile with __dp4a on packed int8x4 words. Tensor-core paths (mma.sync,
// wgmma) are later work.
#include "int8_chain.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int SK = BK + 4;  // 36 bytes = 9 words a row: odd, conflict-free

__global__ void __launch_bounds__(REPRO_THREADS)
mm_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int* __restrict__ bias, void* __restrict__ out, int m,
               int k, int n, int shift, int relu, int out_int8) {
  __shared__ __align__(16) int8_t xs[BM][SK];
  __shared__ __align__(16) int8_t ws[BN][SK];  // w^T: ws[col][k]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += REPRO_THREADS) {
      const int r = i / BK, kk = i % BK, gm = m0 + r, gk = k0 + kk;
      xs[r][kk] = (gm < m && gk < k) ? x[static_cast<size_t>(gm) * k + gk] : 0;
    }
    for (int i = threadIdx.x; i < BK * BN; i += REPRO_THREADS) {
      const int kk = i / BN, c = i % BN, gk = k0 + kk, gn = n0 + c;
      ws[c][kk] = (gk < k && gn < n) ? w[static_cast<size_t>(gk) * n + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BK / 4; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(&xs[ty + 16 * i][4 * kw]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&ws[tx + 16 * j][4 * kw]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= n) continue;
      int v = acc[i][j];
      if (bias != nullptr) v = wrap_add(v, bias[gn]);
      if (relu) v = max(v, 0);
      const size_t o = static_cast<size_t>(gm) * n + gn;
      if (out_int8)
        static_cast<int8_t*>(out)[o] = requant_sat8(v, shift);
      else
        static_cast<int*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" int mm_int8_launch(const void* x, const void* w, const void* bias,
                              void* out, int m, int k, int n, int shift,
                              int relu, int out_int8, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  mm_int8_kernel<<<grid, REPRO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), out, m, k, n, shift, relu, out_int8);
  return static_cast<int>(cudaGetLastError());
}
