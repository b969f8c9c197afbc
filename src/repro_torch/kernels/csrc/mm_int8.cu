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
// TOPS bound is far lower) is under 200 nanoseconds, and the launch and one
// round trip to device memory (microseconds) dominate: the layer is bound
// by latency. The design therefore keeps each block's path short and puts
// a block on every SM:
// - 32-row tiles, so a 4096-row layer gives 128 blocks (one wave on 132
//   SMs), each of 4 warps, with every 64-column tile of the output in its
//   own block;
// - x staged one 16-byte load a thread per 64-byte slab of K, where the row
//   stride and base are 16-byte aligned (every jsc-m layer); a masked byte
//   path takes the rest;
// - w (K x N, N contiguous) transposed once a block into shared memory,
//   K-contiguous per column as the B fragment wants, four k packed into a
//   word per thread; where w's rows are 16-byte aligned, four rows arrive
//   in 16-byte loads and a __byte_perm transpose, else a byte gather (the
//   gather alone took the five jsc-m layers from 15.1 to 20.1 us on an
//   H100 80GB HBM3 at 700 W, chip_smoke.py);
// - the products on the tensor cores, mma.sync m16n8k32 s8.s8.s32 without
//   .satfinite, so the int32 sums wrap as the plain version's do, with K
//   zero-padded to a multiple of 32 and N masked in 8-column tiles;
// - bias, ReLU and the requant straight from the accumulator fragments,
//   with masked stores for ragged M and N.
// Rows of both slabs are 80 bytes (20 words) apart, so the 8 rows x 4 words
// a fragment load reads fall on 32 distinct banks. wgmma is not used: at
// K <= 130 and N <= 200 its 64-row warpgroup tiles and asynchronous
// pipeline have nothing to hide, and the layer is bound by latency, not by
// the tensor cores' rate.
#include "int8_chain.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 64;  // rows, columns, K bytes a slab
constexpr int kThreads = 128;
constexpr int SK = BK + 16;  // 80-byte rows: conflict-free fragment loads

__device__ __forceinline__ int lane_of(const int4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Fragments: see mma_s8 in int8_chain.cuh.
// kWvec: w's rows are 16-byte aligned (n % 16 == 0 and an aligned base).
template <bool kWvec>
__global__ void __launch_bounds__(kThreads)
mm_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int* __restrict__ bias, void* __restrict__ out, int m,
               int k, int n, int shift, int relu, int out_int8, int xvec) {
  constexpr int kWords = BN * BK / 4 / kThreads;  // w^T words a thread packs
  constexpr int kQuads = BK / 4 * (BN / 16);      // 4-row x 16-column blocks
  __shared__ __align__(16) int8_t xs[BM][SK];
  __shared__ __align__(16) int8_t ws[BN][SK];  // w^T: ws[col][k]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int mt = 16 * (warp % 2);  // the warp's 16 rows of the tile
  const int nb = 4 * (warp / 2);   // its first 8-column tile of four
  int acc[4][4] = {};
  int bv[4][2] = {};               // the bias of the thread's columns
  if (bias != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gn = n0 + 8 * (nb + j) + 2 * t + e;
        if (gn < n) bv[j][e] = __ldg(bias + gn);
      }
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    // Every global load of the slab is issued before the first store.
    int4 xv = make_int4(0, 0, 0, 0);
    const int xr = threadIdx.x / 4, xc = 16 * (threadIdx.x % 4);
    if (xvec && m0 + xr < m && k0 + xc < k)
      xv = __ldg(reinterpret_cast<const int4*>(
          x + static_cast<size_t>(m0 + xr) * k + k0 + xc));
    // w: where rows are 16-byte aligned, thread i < kQuads reads rows
    // kq..kq+3, columns c16..c16+15 in four 16-byte loads; else every thread
    // gathers kWords words of w^T byte by byte.
    const int kq = 4 * (threadIdx.x / (BN / 16));
    const int c16 = 16 * (threadIdx.x % (BN / 16));
    int4 wr[4];
    unsigned wv[kWords];
    if (kWvec) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + kq + e;
        wr[e] = make_int4(0, 0, 0, 0);
        if (threadIdx.x < kQuads && gk < k && n0 + c16 < n)
          wr[e] = __ldg(reinterpret_cast<const int4*>(
              w + static_cast<size_t>(gk) * n + n0 + c16));
      }
    } else {
#pragma unroll
      for (int it = 0; it < kWords; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int gn = n0 + i % BN, kk = k0 + 4 * (i / BN);
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kk + e < k && gn < n)
            word |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(
                        w + static_cast<size_t>(kk + e) * n + gn)))
                    << (8 * e);
        wv[it] = word;
      }
    }
    if (xvec) {
      *reinterpret_cast<int4*>(&xs[xr][xc]) = xv;
    } else {
      for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
        const int r = i / BK, kk = i % BK, gm = m0 + r, gk = k0 + kk;
        xs[r][kk] = (gm < m && gk < k) ? x[static_cast<size_t>(gm) * k + gk] : 0;
      }
    }
    if (kWvec) {
      // A 4 x 4 byte transpose per word: column c of the four rows becomes
      // one word of w^T.
      if (threadIdx.x < kQuads) {
#pragma unroll
        for (int qw = 0; qw < 4; ++qw) {
          const int r0 = lane_of(wr[0], qw), r1 = lane_of(wr[1], qw);
          const int r2 = lane_of(wr[2], qw), r3 = lane_of(wr[3], qw);
          const unsigned lo01 = __byte_perm(r0, r1, 0x5140);
          const unsigned lo23 = __byte_perm(r2, r3, 0x5140);
          const unsigned hi01 = __byte_perm(r0, r1, 0x7362);
          const unsigned hi23 = __byte_perm(r2, r3, 0x7362);
          const int c = c16 + 4 * qw;
          *reinterpret_cast<unsigned*>(&ws[c][kq]) = __byte_perm(lo01, lo23, 0x5410);
          *reinterpret_cast<unsigned*>(&ws[c + 1][kq]) = __byte_perm(lo01, lo23, 0x7632);
          *reinterpret_cast<unsigned*>(&ws[c + 2][kq]) = __byte_perm(hi01, hi23, 0x5410);
          *reinterpret_cast<unsigned*>(&ws[c + 3][kq]) = __byte_perm(hi01, hi23, 0x7632);
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < kWords; ++it) {
        const int i = threadIdx.x + it * kThreads;
        *reinterpret_cast<unsigned*>(&ws[i % BN][4 * (i / BN)]) = wv[it];
      }
    }
    __syncthreads();
    const int steps = (min(BK, k - k0) + 31) / 32;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      if (s >= steps) break;
      const int kb = 32 * s + 4 * t;
      const int a[4] = {word_at(&xs[mt + g][kb]), word_at(&xs[mt + g + 8][kb]),
                        word_at(&xs[mt + g][kb + 16]),
                        word_at(&xs[mt + g + 8][kb + 16])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * (nb + j);
        if (n0 + col >= n) break;
        const int b[2] = {word_at(&ws[col + g][kb]), word_at(&ws[col + g][kb + 16])};
        mma_s8(acc[j], a, b);
      }
    }
    if (k0 + BK < k) __syncthreads();  // the next slab overwrites xs, ws
  }

  // Each thread holds two neighbouring columns of two rows per 8-column
  // tile; where n is even both fit one 2-byte (int8) or 8-byte (int32) store.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + 8 * (nb + j) + 2 * t;
    if (gn >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + mt + g + 8 * h;
      if (gm >= m) continue;
      int v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = bias != nullptr ? wrap_add(acc[j][2 * h + e], bv[j][e])
                               : acc[j][2 * h + e];
        if (relu) v[e] = max(v[e], 0);
      }
      const size_t o = static_cast<size_t>(gm) * n + gn;
      const bool pair = n % 2 == 0;   // then gn + 1 < n as well
      if (out_int8) {
        int8_t* y = static_cast<int8_t*>(out) + o;
        const int8_t y0 = requant_sat8(v[0], shift);
        const int8_t y1 = requant_sat8(v[1], shift);
        if (pair) {
          *reinterpret_cast<char2*>(y) = make_char2(y0, y1);
        } else {
          y[0] = y0;
          if (gn + 1 < n) y[1] = y1;
        }
      } else {
        int* y = static_cast<int*>(out) + o;
        if (pair) {
          *reinterpret_cast<int2*>(y) = make_int2(v[0], v[1]);
        } else {
          y[0] = v[0];
          if (gn + 1 < n) y[1] = v[1];
        }
      }
    }
  }
}

}  // namespace

extern "C" int mm_int8_launch(const void* x, const void* w, const void* bias,
                              void* out, int m, int k, int n, int shift,
                              int relu, int out_int8, void* stream) {
  const int xvec = k % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = n % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const auto kernel = wvec ? mm_int8_kernel<true> : mm_int8_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), out, m, k, n, shift, relu, out_int8, xvec);
  return static_cast<int>(cudaGetLastError());
}
