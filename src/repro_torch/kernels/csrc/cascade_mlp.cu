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
// (the larger one) is tens of nanoseconds, and the launch (microseconds)
// dominates. The design therefore spends nothing on tensor cores or
// pipelining and puts the whole chain into one launch for the whole batch:
//  * K2: the grid runs over blocks of 64 rows of the (B*M, K0) input. Each
//    block copies all packed weights and biases into dynamic shared memory
//    once, then carries its rows through every layer: an int32 accumulator
//    in registers (__dp4a over int8x4 words), the int8 activation
//    ping-ponging between two shared buffers. The legality rule is that this
//    working set fits one block's 227 KB; the wrapper checks it.
//  * K3: one block per event. phi runs over the Mp rows of the event padded
//    with zero rows to a power of two (the padded rows contribute phi(0), as
//    in the JAX wrapper), the set is summed per column in int32 in shared
//    memory (the ones-row MAC of the TPU kernel), requantized by log2(Mp)
//    for 'mean' and 'sum' alike, and rho runs on the one aggregated row.
#include "int8_chain.cuh"

namespace {

__global__ void __launch_bounds__(REPRO_THREADS)
cascade_mlp_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wpk,
                   const int* __restrict__ bpk, const __grid_constant__ Chain c,
                   int8_t* __restrict__ out, int rows, int k0, int block_rows,
                   int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ws = reinterpret_cast<int8_t*>(smem);
  int* bs = reinterpret_cast<int*>(smem + c.w_bytes);
  int8_t* a = reinterpret_cast<int8_t*>(bs + c.b_count);
  int8_t* b = a + block_rows * stride;
  copy16(ws, wpk, c.w_bytes);
  copy16(bs, bpk, c.b_count * 4);

  const int r0 = blockIdx.x * block_rows;
  const int nr = min(block_rows, rows - r0);
  const int8_t* xb = x + static_cast<size_t>(r0) * k0;
  for (int i = threadIdx.x; i < nr * stride; i += blockDim.x) {
    const int r = i / stride, kk = i - r * stride;
    a[i] = kk < k0 ? xb[r * k0 + kk] : 0;
  }
  __syncthreads();

  const int8_t* y = run_chain(c, ws, bs, a, b, nr, stride);
  const int n_out = c.layer[c.n_layers - 1].n;
  int8_t* ob = out + static_cast<size_t>(r0) * n_out;
  for (int i = threadIdx.x; i < nr * n_out; i += blockDim.x) {
    const int r = i / n_out;
    ob[i] = y[r * stride + (i - r * n_out)];
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
  const int grid = (rows + block_rows - 1) / block_rows;
  cascade_mlp_kernel<<<grid, REPRO_THREADS, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(b), c, static_cast<int8_t*>(out), rows, k0,
      block_rows, stride);
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
