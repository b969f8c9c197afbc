// Shared device code of the INT8 kernels: the layer chain as the host packs
// it, the power-of-two requantization, cp.async, and the tensor cores' int8
// product.
//
// Integer semantics follow the JAX package bit for bit: int8 x int8 products
// accumulate in int32 (two's-complement wrap), the optional int32 bias is
// added, ReLU clamps at 0, and the shift rounds half away from zero before
// saturating to int8.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_MAX_LAYERS 16

// One layer as the host packs it (cascade_mlp/ops.py) for K2 and K3. The
// weight is stored transposed, w^T of shape (np, ks) int8: kp = K rounded up
// to 32 (an mma k-step), np = N rounded up to 8 (an mma n-tile) with zero
// rows and zero biases past N, and ks = kp + 16, so ks / 4 = 4 (mod 8) and
// the 8 columns x 4 words of a B fragment fall on 32 distinct banks. Zero
// weights past K mean an activation's columns past K may hold anything.
struct ChainLayer {
  int k;         // input width
  int kp;        // input width as the kernel reads it (see above)
  int ks;        // row stride of w^T in bytes
  int n;         // output width
  int np;        // output width as the kernel writes it (see above)
  int shift;     // requantization shift, 0..30
  int relu;
  int has_bias;
  int w_off;     // byte offset of w^T in the packed weights (16-aligned)
  int b_off;     // int32 offset of the bias in the packed biases
};

#define REPRO_LAYER_INTS 10
#define REPRO_CHAIN_HEADER_INTS 3

struct Chain {
  int n_layers;
  int w_bytes;   // packed weight bytes, a multiple of 16
  int b_count;   // packed bias entries, a multiple of 4
  ChainLayer layer[REPRO_MAX_LAYERS];
};

// Reads a chain from the host array the Python wrapper packs:
// [n_layers, w_bytes, b_count, then REPRO_LAYER_INTS ints per layer].
inline Chain chain_from_meta(const int* meta) {
  Chain c;
  c.n_layers = meta[0];
  c.w_bytes = meta[1];
  c.b_count = meta[2];
  for (int l = 0; l < c.n_layers && l < REPRO_MAX_LAYERS; ++l) {
    const int* m = meta + REPRO_CHAIN_HEADER_INTS + l * REPRO_LAYER_INTS;
    c.layer[l] = ChainLayer{m[0], m[1], m[2], m[3], m[4],
                            m[5], m[6], m[7], m[8], m[9]};
  }
  return c;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// sat8(round_half_away(acc >> shift)); CUDA's >> on int is arithmetic.
__device__ __forceinline__ int8_t requant_sat8(int acc, int shift) {
  if (shift > 0) {
    const int half = 1 << (shift - 1);
    acc = wrap_add(acc, acc >= 0 ? half : half - 1) >> shift;
  }
  return static_cast<int8_t>(min(max(acc, -128), 127));
}

// 16 bytes from global to shared memory without a register round trip,
// zero-filled past `src_bytes`; complete after cp_async_wait_all().
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tensor cores' int8 product (K1, K2, K3): c (16 x 8, int32) += a
// (16 x 32, row-major) b (32 x 8, column-major), without .satfinite, so the
// int32 sums wrap as the plain versions' do. Fragments (g = lane / 4, t = lane % 4): A
// rows g and g + 8 of the warp's 16-row tile, k 4t..4t+3 and 16+4t..; B
// column g of an 8-column tile, the same k; the accumulator c[e] at row
// g + 8*(e/2), column 2t + e%2.
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four int8 at a 4-byte aligned address as one word.
__device__ __forceinline__ int word_at(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}
