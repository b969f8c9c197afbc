// K2 (cascade_mlp) and K3 (deepsets): a whole INT8 layer chain in one launch,
// with every layer's weights resident in shared memory and no intermediate
// activation written to device memory.
//
// Replaces: src/repro/kernels/cascade_mlp/cascade_mlp.py, cascade_mlp_pallas
// (K2) and deepsets_pallas (K3), the paper's cascade analogue.
//
// What bounds them here: the jet models are tiny (19 KB of weights for
// jsc-xl, about 4 KB for deepsets-32), so a served batch of 64 events reads
// some 50-100 KB and does 10-50 M int8 operations: the bound from bytes
// (the larger one) is tens of nanoseconds (27 ns for a 4096-row jsc-m
// batch), and the launch and the chain of dependent steps inside it
// (microseconds) dominate. Each layer needs the whole previous one, so the
// time is latency: one round trip to device memory for the input and the
// weights, then per layer a few dependent shared-memory reads, products
// and an epilogue.
//  * K2 (cascade_mlp_kernel): the products on the tensor cores, mma.sync
//    m16n8k32 s8.s8.s32 without .satfinite (the int32 sums wrap as the plain
//    version's do). A warp carries 16 rows through every layer: A fragments
//    from its own slice of shared memory, B fragments from the weights
//    (packed by the host in the mma layout of int8_chain.cuh, K zero-padded
//    to 32 and N to 8), bias by wrap_add, ReLU and requant_sat8 straight
//    from the accumulator fragments, the int8 result stored back to the
//    warp's other activation buffer (rows 16*odd bytes apart, so a fragment
//    load hits 32 distinct banks) under __syncwarp() only; the last layer
//    stores to device memory with masks for ragged rows and N. Two warps a
//    block, so a 4096-row batch is 128 blocks, one wave on 132 SMs. The
//    weights, the biases and the x rows (16-byte copies where K0 % 16 == 0
//    and x is aligned, else bytes) arrive by cp.async in one round trip,
//    and the block's one barrier follows them. wgmma would not pay: at
//    K <= 130 and N <= 200 a layer is one to five k-steps of at most 25
//    n-tiles, and a 64-row warpgroup tile would idle three quarters of a
//    block of jsc-m rows while adding an asynchronous pipeline with nothing
//    to hide. The legality rule is that weights, biases and the activation
//    slices fit one block's 227 KB; the wrapper checks it.
//  * K3 (deepsets_kernel): one block per event, 256 threads. phi runs over
//    the Mp rows of the event padded with zero rows to a power of two (the
//    padded rows contribute phi(0), as in the JAX wrapper), the set is
//    summed per column in int32 in shared memory (the ones-row MAC of the
//    TPU kernel), requantized by log2(Mp) for 'mean' and 'sum' alike, and
//    rho runs on the one aggregated row; each layer is __dp4a over int8x4
//    words (dense_layer), the int8 activation ping-ponging between two
//    shared buffers.
#include "int8_chain.cuh"

namespace {

constexpr int kWarpRows = 16;  // rows a warp carries through the chain

__global__ void __launch_bounds__(128)
cascade_mlp_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wpk,
                   const int* __restrict__ bpk, const __grid_constant__ Chain c,
                   int8_t* __restrict__ out, int rows, int k0, int stride,
                   int xvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int8_t* ws = reinterpret_cast<const int8_t*>(smem);
  const int* bs = reinterpret_cast<const int*>(smem + c.w_bytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * (blockDim.x / 32) + warp) * kWarpRows;
  int8_t* in = reinterpret_cast<int8_t*>(smem + c.w_bytes + 4 * c.b_count) +
               warp * 2 * kWarpRows * stride;
  int8_t* nxt = in + kWarpRows * stride;

  for (int i = threadIdx.x; i < c.w_bytes / 16; i += blockDim.x)
    cp_async16(smem + 16 * i, wpk + 16 * i, 16);
  for (int i = threadIdx.x; i < c.b_count / 4; i += blockDim.x)
    cp_async16(smem + c.w_bytes + 16 * i, bpk + 4 * i, 16);
  // The warp's 16 rows of x, zero past the batch: lane r % 16 takes row r,
  // the two half-warps alternate over its 16-byte chunks (or bytes).
  {
    const int r = lane % kWarpRows, half = lane / kWarpRows;
    const bool ok = r0 + r < rows;
    const int8_t* xr = x + static_cast<size_t>(ok ? r0 + r : 0) * k0;
    int8_t* dst = in + r * stride;
    if (xvec) {
      for (int cc = 16 * half; cc < k0; cc += 32)
        cp_async16(dst + cc, xr + cc, ok ? 16 : 0);
    } else {
      for (int kk = half; kk < k0; kk += 2) dst[kk] = ok ? xr[kk] : 0;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (r0 >= rows) return;

  // Columns past K of the activations may hold anything: the packed
  // weights are zero there, and an integer product with 0 is 0.
  const int g = lane / 4, t = lane % 4;
  for (int l = 0; l < c.n_layers; ++l) {
    const ChainLayer L = c.layer[l];  // one copy a layer, its loads at once
    const bool last = l + 1 == c.n_layers;
    const int8_t* wt = ws + L.w_off;
    const int* bias = bs + L.b_off;
    for (int n0 = 0; n0 < L.np; n0 += 64) {  // eight n-tiles a pass
      int acc[8][4] = {};
      for (int kb = 4 * t; kb < L.kp; kb += 32) {
        const int a[4] = {word_at(in + g * stride + kb),
                          word_at(in + (g + 8) * stride + kb),
                          word_at(in + g * stride + kb + 16),
                          word_at(in + (g + 8) * stride + kb + 16)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n0 + 8 * j >= L.np) break;
          const int8_t* wc = wt + (n0 + 8 * j + g) * L.ks + kb;
          const int b[2] = {word_at(wc), word_at(wc + 16)};
          mma_s8(acc[j], a, b);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (n0 + 8 * j >= L.np) break;
        // Biases are zero-padded to np, so col + 1 is always readable.
        const int b0 = L.has_bias ? bias[col] : 0;
        const int b1 = L.has_bias ? bias[col + 1] : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v0 = wrap_add(acc[j][2 * h], b0);
          int v1 = wrap_add(acc[j][2 * h + 1], b1);
          if (L.relu) {
            v0 = max(v0, 0);
            v1 = max(v1, 0);
          }
          const int8_t y0 = requant_sat8(v0, L.shift);
          const int8_t y1 = requant_sat8(v1, L.shift);
          const int row = g + 8 * h;
          if (!last) {
            *reinterpret_cast<char2*>(nxt + row * stride + col) =
                make_char2(y0, y1);
          } else if (r0 + row < rows) {
            int8_t* y = out + static_cast<size_t>(r0 + row) * L.n + col;
            if (col < L.n) y[0] = y0;
            if (col + 1 < L.n) y[1] = y1;
          }
        }
      }
    }
    __syncwarp();  // the layer's output is written; its input is read
    int8_t* tmp = in;
    in = nxt;
    nxt = tmp;
  }
}

__global__ void __launch_bounds__(REPRO_THREADS)
deepsets_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ phi_w,
                const int* __restrict__ phi_b, const __grid_constant__ Chain phi,
                const int8_t* __restrict__ rho_w, const int* __restrict__ rho_b,
                const __grid_constant__ Chain rho, int8_t* __restrict__ out,
                int m, int mp, int k0, int agg_shift, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* pw = reinterpret_cast<int8_t*>(smem);
  int8_t* rw = pw + phi.w_bytes;
  int* pb = reinterpret_cast<int*>(rw + rho.w_bytes);
  int* rb = pb + phi.b_count;
  int8_t* a = reinterpret_cast<int8_t*>(rb + rho.b_count);
  int8_t* b = a + mp * stride;
  copy16(pw, phi_w, phi.w_bytes);
  copy16(rw, rho_w, rho.w_bytes);
  copy16(pb, phi_b, phi.b_count * 4);
  copy16(rb, rho_b, rho.b_count * 4);

  // The event's m rows, then zero rows up to mp and zero columns up to stride.
  const int8_t* xe = x + static_cast<size_t>(blockIdx.x) * m * k0;
  for (int i = threadIdx.x; i < mp * stride; i += blockDim.x) {
    const int r = i / stride, kk = i - r * stride;
    a[i] = (r < m && kk < k0) ? xe[r * k0 + kk] : 0;
  }
  __syncthreads();

  int8_t* h = run_chain(phi, pw, pb, a, b, mp, stride);
  int8_t* g = h == a ? b : a;
  const int nh = phi.layer[phi.n_layers - 1].n;
  for (int col = threadIdx.x; col < stride; col += blockDim.x) {
    int8_t v = 0;
    if (col < nh) {
      int s = 0;
      for (int r = 0; r < mp; ++r) s += h[r * stride + col];
      v = requant_sat8(s, agg_shift);
    }
    g[col] = v;
  }
  __syncthreads();

  const int8_t* y = run_chain(rho, rw, rb, g, h, 1, stride);
  const int n_out = rho.layer[rho.n_layers - 1].n;
  for (int col = threadIdx.x; col < n_out; col += blockDim.x)
    out[static_cast<size_t>(blockIdx.x) * n_out + col] = y[col];
}

cudaError_t allow_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace

extern "C" int cascade_mlp_launch(const void* x, const void* w, const void* b,
                                  const void* meta, void* out, int rows, int k0,
                                  int block_rows, int stride, int smem_bytes,
                                  void* stream) {
  const Chain c = chain_from_meta(static_cast<const int*>(meta));
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(cascade_mlp_kernel),
                               smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (block_rows % kWarpRows != 0 || block_rows > 4 * kWarpRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int xvec = k0 % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int grid = (rows + block_rows - 1) / block_rows;
  cascade_mlp_kernel<<<grid, 32 * (block_rows / kWarpRows), smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(b), c, static_cast<int8_t*>(out), rows, k0,
      stride, xvec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int deepsets_launch(const void* x, const void* phi_w,
                               const void* phi_b, const void* phi_meta,
                               const void* rho_w, const void* rho_b,
                               const void* rho_meta, void* out, int batch,
                               int m, int mp, int k0, int agg_shift, int stride,
                               int smem_bytes, void* stream) {
  const Chain phi = chain_from_meta(static_cast<const int*>(phi_meta));
  const Chain rho = chain_from_meta(static_cast<const int*>(rho_meta));
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(deepsets_kernel),
                               smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  deepsets_kernel<<<batch, REPRO_THREADS, smem_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(phi_w),
      static_cast<const int*>(phi_b), phi, static_cast<const int8_t*>(rho_w),
      static_cast<const int*>(rho_b), rho, static_cast<int8_t*>(out), m, mp, k0,
      agg_shift, stride);
  return static_cast<int>(cudaGetLastError());
}
