// K4 (global_agg): the sum or mean of an (M, F) int8 matrix over its M rows,
// (1, F) int32 for 'sum' and int8 for 'mean' (the int32 sum requantized by
// the shift log2 M). Two kernels that give the same bits, because the paper's
// Table 4 (§4.3.1) compares the two ways of reducing:
//
//  * mac: the reduction as a multiply-accumulate against a constant ones
//    operand. A thread owns four neighbouring columns; it reads one int8x4
//    word from each of four rows, transposes the 4x4 bytes with __byte_perm
//    so that each word holds four rows of one column, and adds the word's
//    bytes into that column's int32 sum with one __dp4a against 0x01010101.
//    One dp4a does four of the row adds.
//  * extract_add: the baseline, a serial loop over the rows in which a
//    thread sign-extends its column's byte and adds it to an int32.
//
// Replaces: src/repro/kernels/global_agg/global_agg.py, global_agg_pallas
// (_mac_kernel, the ones-row matmul on the MXU, and _extract_add_kernel, the
// row-by-row VPU adds).
//
// What bounds it here: it reads M*F bytes once and does one add per byte, so
// it is bound by bytes; at the paper's shapes (32..64 x 32..64, 1-4 KB) the
// bound is about a nanosecond and the launch (microseconds) is what a call
// costs. The design keeps to the TPU kernel's grid, one block per 128
// columns, with each row's 128 bytes read as one coalesced segment; it does
// nothing more for speed. Both kernels requantize with requant_sat8 from
// int8_chain.cuh, as K2 and K3 do.
#include "int8_chain.cuh"

namespace {

constexpr int kBlockF = 128;    // columns per block, the JAX DEFAULT_BLOCK_F

__device__ __forceinline__ void store(void* out, int col, int acc, int shift,
                                      int mean) {
  if (mean)
    static_cast<int8_t*>(out)[col] = requant_sat8(acc, shift);
  else
    static_cast<int*>(out)[col] = acc;
}

// 32 threads a block, each owning columns 4c..4c+3 of the block's 128.
__global__ void __launch_bounds__(kBlockF / 4)
global_agg_mac_kernel(const int8_t* __restrict__ x, void* __restrict__ out,
                      int m, int f, int shift, int mean) {
  const int fw = f >> 2;                                 // words in a row
  const int cw = blockIdx.x * (kBlockF / 4) + threadIdx.x;
  const int* xw = reinterpret_cast<const int*>(x) + cw;
  constexpr int kOnes = 0x01010101;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int r = 0; r < m; r += 4) {
    const int w0 = xw[static_cast<size_t>(r) * fw];
    const int w1 = r + 1 < m ? xw[static_cast<size_t>(r + 1) * fw] : 0;
    const int w2 = r + 2 < m ? xw[static_cast<size_t>(r + 2) * fw] : 0;
    const int w3 = r + 3 < m ? xw[static_cast<size_t>(r + 3) * fw] : 0;
    // Byte j of word wi is x[r+i, 4cw+j]; gather byte j of every row.
    const unsigned lo01 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
    const unsigned lo23 = __byte_perm(w2, w3, 0x5140);
    const unsigned hi01 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
    const unsigned hi23 = __byte_perm(w2, w3, 0x7362);
    // The signed dp4a: each byte is sign-extended before the add.
    a0 = __dp4a(static_cast<int>(__byte_perm(lo01, lo23, 0x5410)), kOnes, a0);
    a1 = __dp4a(static_cast<int>(__byte_perm(lo01, lo23, 0x7632)), kOnes, a1);
    a2 = __dp4a(static_cast<int>(__byte_perm(hi01, hi23, 0x5410)), kOnes, a2);
    a3 = __dp4a(static_cast<int>(__byte_perm(hi01, hi23, 0x7632)), kOnes, a3);
  }
  const int c = 4 * cw;
  store(out, c, a0, shift, mean);
  store(out, c + 1, a1, shift, mean);
  store(out, c + 2, a2, shift, mean);
  store(out, c + 3, a3, shift, mean);
}

// 128 threads a block, one column each.
__global__ void __launch_bounds__(kBlockF)
global_agg_extract_add_kernel(const int8_t* __restrict__ x,
                              void* __restrict__ out, int m, int f, int shift,
                              int mean) {
  const int c = blockIdx.x * kBlockF + threadIdx.x;
  int acc = 0;
  for (int r = 0; r < m; ++r)
    acc += static_cast<int>(x[static_cast<size_t>(r) * f + c]);
  store(out, c, acc, shift, mean);
}

}  // namespace

// x: (m, f) int8, contiguous and 4-byte aligned, f a multiple of 128.
// impl: 0 mac, 1 extract_add. out: (1, f) int32, or int8 when mean != 0.
extern "C" int global_agg_launch(const void* x, void* out, int m, int f,
                                 int shift, int mean, int impl, void* stream) {
  if (f % kBlockF != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(f / kBlockF);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xb = static_cast<const int8_t*>(x);
  if (impl == 0)
    global_agg_mac_kernel<<<grid, kBlockF / 4, 0, s>>>(xb, out, m, f, shift,
                                                       mean);
  else
    global_agg_extract_add_kernel<<<grid, kBlockF, 0, s>>>(xb, out, m, f,
                                                           shift, mean);
  return static_cast<int>(cudaGetLastError());
}
