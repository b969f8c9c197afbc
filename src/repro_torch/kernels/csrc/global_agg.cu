// K4 (global_agg): the sum or mean of an (M, F) int8 matrix over its M rows,
// (1, F) int32 for 'sum' and int8 for 'mean' (the int32 sum requantized by
// the shift the wrapper passes, log2 of M padded to a power of two: zero
// rows change no sum, so none are added). Two kernels that give the same
// bits, because the paper's Table 4 (§4.3.1) compares the two ways of
// reducing:
//
//  * mac: the reduction as a multiply-accumulate against a constant ones
//    operand. A lane owns four neighbouring columns; it reads one int8x4
//    word from each of four rows, transposes the 4x4 bytes with __byte_perm
//    so that each word holds four rows of one column, and adds the word's
//    bytes into that column's int32 sum with one signed __dp4a against
//    0x01010101. One dp4a does four of the row adds.
//  * extract_add: the baseline, serial adds in which a thread sign-extends
//    its column's byte of each of its rows into an int32.
//
// Replaces: src/repro/kernels/global_agg/global_agg.py, global_agg_pallas
// (_mac_kernel, the ones-row matmul on the MXU, and _extract_add_kernel, the
// row-by-row VPU adds).
//
// What bounds it here: it reads M*F bytes once and does one add per byte; at
// the paper's shapes (32..64 x 32..64, 1-4 KB) the bound from bytes is about
// a nanosecond, and what a call costs is its launch and the dependent chain
// inside it (a load round trip, the adds, one barrier, the store). So the
// design keeps both short and adds nothing around them: one launch on the
// caller's matrix as it stands (any M and F, ragged columns masked, any row
// stride, any alignment: 4-byte words where F % 4, the address and the row
// stride allow them, else bytes), no padding and no copy. A block's eight
// warps each take an eighth of the rows (mac: quads of rows 4w, 4w + 32, ..;
// extract_add: rows w, w + 8, ..), so no thread walks more than about M/8
// rows, and the eight partial sums of a column meet in shared memory. A mac
// block covers 128 columns (a word a lane), an extract_add block 32 (a byte
// a lane). Both requantize with requant_sat8 from int8_chain.cuh, as K2 and
// K3 do.
#include "int8_chain.cuh"

namespace {

constexpr int kSlices = 8;      // warps a block, each a slice of the rows
constexpr int kMacCols = 128;   // columns a mac block covers
constexpr int kAddCols = 32;    // columns an extract_add block covers

__device__ __forceinline__ void store(void* out, int col, int acc, int shift,
                                      int mean) {
  if (mean)
    static_cast<int8_t*>(out)[col] = requant_sat8(acc, shift);
  else
    static_cast<int*>(out)[col] = acc;
}

// Columns c..c+3 of a row as one word, zero past f: one 4-byte load on the
// word path (kWords: f % 4 == 0 and every row 4-byte aligned), else four
// byte loads packed into a word.
template <bool kWords>
__device__ __forceinline__ int row_word(const int8_t* row, int c, int f) {
  if (kWords) return *reinterpret_cast<const int*>(row + c);
  const int b0 = c < f ? row[c] : 0, b1 = c + 1 < f ? row[c + 1] : 0;
  const int b2 = c + 2 < f ? row[c + 2] : 0, b3 = c + 3 < f ? row[c + 3] : 0;
  return static_cast<int>(__byte_perm(__byte_perm(b0, b1, 0x0040),
                                      __byte_perm(b2, b3, 0x0040), 0x5410));
}

template <bool kWords>
__global__ void __launch_bounds__(32 * kSlices)
global_agg_mac_kernel(const int8_t* __restrict__ x, void* __restrict__ out,
                      int m, int f, long long ld, int shift, int mean) {
  __shared__ int4 part[kSlices][kMacCols / 4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * kMacCols + 4 * lane;  // the lane's first column
  constexpr int kOnes = 0x01010101;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (c < f) {
    for (int r = 4 * warp; r < m; r += 4 * kSlices) {
      const int8_t* xr = x + r * ld;
      const int w0 = row_word<kWords>(xr, c, f);
      const int w1 = r + 1 < m ? row_word<kWords>(xr + ld, c, f) : 0;
      const int w2 = r + 2 < m ? row_word<kWords>(xr + 2 * ld, c, f) : 0;
      const int w3 = r + 3 < m ? row_word<kWords>(xr + 3 * ld, c, f) : 0;
      // Byte j of word wi is x[r+i, c+j]; gather byte j of every row.
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
  }
  part[warp][lane] = make_int4(a0, a1, a2, a3);
  __syncthreads();
  const int col = blockIdx.x * kMacCols + threadIdx.x;
  if (threadIdx.x < kMacCols && col < f) {
    const int* p = reinterpret_cast<const int*>(part) + threadIdx.x;
    int acc = 0;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) acc += p[s * kMacCols];
    store(out, col, acc, shift, mean);
  }
}

__global__ void __launch_bounds__(32 * kSlices)
global_agg_extract_add_kernel(const int8_t* __restrict__ x,
                              void* __restrict__ out, int m, int f,
                              long long ld, int shift, int mean) {
  __shared__ int part[kSlices][kAddCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * kAddCols + lane;
  int acc = 0;
  if (c < f)
    for (int r = warp; r < m; r += kSlices)
      acc += static_cast<int>(x[r * ld + c]);
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < f) {
    acc = 0;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) acc += part[s][lane];
    store(out, c, acc, shift, mean);
  }
}

}  // namespace

// x: (m, f) int8 with unit column stride and row stride ld bytes, any
// alignment. impl: 0 mac, 1 extract_add. out: (1, f) int32, or int8 when
// mean != 0 (requantized by shift).
extern "C" int global_agg_launch(const void* x, void* out, int m, int f,
                                 long long ld, int shift, int mean, int impl,
                                 void* stream) {
  if (m < 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xb = static_cast<const int8_t*>(x);
  const dim3 block(32 * kSlices);
  if (impl == 0) {
    const dim3 grid((f + kMacCols - 1) / kMacCols);
    const bool words = f % 4 == 0 && ld % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 4 == 0;
    if (words)
      global_agg_mac_kernel<true><<<grid, block, 0, s>>>(xb, out, m, f, ld,
                                                         shift, mean);
    else
      global_agg_mac_kernel<false><<<grid, block, 0, s>>>(xb, out, m, f, ld,
                                                          shift, mean);
  } else {
    const dim3 grid((f + kAddCols - 1) / kAddCols);
    global_agg_extract_add_kernel<<<grid, block, 0, s>>>(xb, out, m, f, ld,
                                                         shift, mean);
  }
  return static_cast<int>(cudaGetLastError());
}
