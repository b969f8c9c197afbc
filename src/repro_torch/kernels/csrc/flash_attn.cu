// K5 (flash_attn): blocked attention with an online softmax, forward only.
// q (BH, S, d), k and v (BH, T, d), in f32 or bf16, with an optional causal
// mask (key t is visible to query s where t <= s) and, on a causal mask, an
// optional window W (t visible where s - W < t <= s: sliding-window
// attention, src/repro/models/attention.py:116-123); the output (BH, S, d) is
// written in q's type. Both kernels compute what the Pallas kernel computes:
// scores dot * scale, masked entries weighing exactly 0, the running
// (m, l, acc) updated per key tile, and the output acc / max(l, 1e-30),
// rounded to bf16 with __float2bfloat16_rn where q is bf16. No TF32; the
// f32 kernel uses no approximate math.
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py, flash_attention
// (_flash_kernel), whose grid (BH, S/bq, T/bk) runs its kv axis in order and
// carries (m, l, acc) in VMEM from one kv step to the next. Hopper's
// grid runs in no order, so in both kernels here the kv loop moves inside
// the block, which keeps (m, l, acc) in registers. Causal key tiles wholly
// above the diagonal are skipped (exp(-1e30 - m) is exactly 0 in f32, so
// this changes no bit), and so are the key tiles wholly below a window's
// lower edge: a block starts at the tile that holds key q0 - W + 1 of its
// first row q0, and a warp (warpgroup) skips a tile that none of its rows
// sees. Only the diagonal tile, the window's edge tile and a ragged last
// tile pay for the mask, and the query tiles with the most key tiles start
// first. A masked score is -inf while the running max starts at -1e30, so a
// masked key's p is exactly 0 even in a row that has seen no key yet (the
// reference's where(ok, exp(s - m), 0)), and a row that sees no key at all
// writes 0. For a row that has seen a key this is the Pallas kernel's
// exp(-1e30 - m), exactly 0 as well. Both kernels take the window as a
// template flag too, so that the window-free instantiation compiles to the
// code without it (the window's terms in the bf16 key loop slowed the
// causal call); the bf16 kernel's windowed instantiation runs the tiles
// below the window's edge with the edge's tests and the rest with the
// window-free step.
// The head dim is a template parameter, 64, 128 or 256; a narrower head is
// zero-padded in shared memory, which adds exact zeros to the scores. Both
// kernels load with 16-byte granules, so the wrapper (flash_attn/ops.py)
// pads d to a multiple of 4 (f32) or 8 (bf16) and copies a misaligned view.
//
// What bounds it: 4*d operations for every visible (query, key) pair
// against 16*d bytes a row for q, k, v and o (8*d in bf16), so at the
// sequence lengths served (S = T in the thousands) it is bound by
// operations: the FP32 units (67 TFLOP/s) for f32, the bf16 tensor cores
// (989 TFLOP/s) for bf16.
//
// f32 (flash_attn_kernel). Everything in f32 FMA on the FP32 units, as the
// Pallas kernel computes it after casting up. What holds an FP32 product
// back is the shared-memory traffic and the instructions beside the FMAs,
// so the design is a register-blocked SIMT GEMM twice over:
//  * One block of 8 warps per (bh, query tile), one block an SM, so a
//    thread may hold 255 registers: the largest register patches pay most
//    (a ninth, loading warp, which caps them at 168, spilled; 12 or 16 warps
//    of 8 rows, with smaller patches, ran 10-13% slower at hd = 128). A
//    warp owns R query rows through both products; a thread owns 8 of
//    them (rows ty + WR*i), an 8 x TN patch of the score tile (keys
//    tx + WC*j) and the 8 x TC patch of the output with the same rows
//    (columns 4*tx + 4*WC*h ...). Per float4 step of d the score product
//    reads 8 + TN float4 words for 32*TN FMAs, and per 4 keys the value
//    product 8 + TC float4 words for 32*TC FMAs (8 x 4 and 8 x 8 patches,
//    12 and 16 words, at hd = 128).
//  * Q, then K_0, V_0, K_1, V_1, ... arrive by 16-byte cp.async (zero-filled
//    past the sequence and past d), each thread copying its share, through
//    a ring of three tile buffers: a thread done with tile n copies tile
//    n + 2 into the buffer of tile n - 1, so each copy has the time of a
//    whole product to land. A tile's copies complete on its buffer's
//    "full" mbarrier (cp.async.mbarrier.arrive); every thread arrives on
//    the buffer's "empty" mbarrier when it is done with the tile and waits
//    on it before it refills the buffer, one tile later than it could.
//    The block has one block-wide barrier, after the mbarriers are set up.
//  * P passes from the score product to the value product through a slice
//    of shared memory private to its warp, under __syncwarp() only; the
//    row max is reduced over the WC threads of a row with shuffles, the
//    row sum is kept per thread and reduced once at the end.
//  * Rows of Q, K and V are HD + 4 floats apart and rows of P BK + 16, so
//    the float4 reads of a warp hit distinct banks (or one word, broadcast).
//  * Tiles (R rows a warp, BQ = 8R query rows a block, BK keys a tile):
//    R = 16, BK = 64 at HD = 64 and 128 (125 / 205 KB of shared memory);
//    R = 8, BK = 32 at HD = 256 (175 KB), where a thread scores one key
//    and keeps four partial sums of its 256-term dot. 227 KB is the limit.
//  A warp whose rows all lie above a key tile (causal) or past S skips its
//  products but still copies, waits and arrives on the tile's mbarriers.
//
// bf16 (flash_attn_bf16_kernel). Both products on the tensor cores with
// Hopper's warpgroup MMA (wgmma.mma_async m64n64k16, bf16 in, f32
// accumulation). One block of two warpgroups per (bh, 128-query tile); each
// warpgroup owns 64 query rows. Two blocks share an SM up to hd = 128 (at
// most 128 registers a thread, 97 KB of shared memory a block), so one
// block's softmax runs while the other's products occupy the tensor cores;
// hd = 256 takes one block an SM (193 KB). Q, K and V stay bf16 in shared
// memory, in 128-byte-swizzled panels of 64 columns (the layout wgmma's
// descriptors name, so a tensor-core operand read hits distinct banks). One
// thread asks the tensor memory accelerator (TMA) for each tile, a box of a
// 3-D tensor map (d, rows, bh) that zero-fills past d and past the sequence's
// end, and the copy completes on an mbarrier that the other threads wait on;
// K and V tiles of 64 keys move through a ring of two stages, so the next
// tile loads while the current one is computed, and a step needs one
// block-wide barrier (before its stage is refilled). A tensor map needs d a
// multiple of 8 and 16-byte aligned pointers; the wrapper pads d and copies
// a misaligned input for it. S = Q K^T reads both operands from shared
// memory (K-major). The softmax stays in registers: a thread holds two rows
// of the score fragment, their max and sum are reduced over the four
// threads of a row with shuffles, and the scores are scaled by
// scale * log2(e) before the mask (m is kept in those units), so p is one
// subtraction and one ex2.approx. l is
// summed from the f32 p; only the value product's operand is rounded to bf16,
// and it goes from the score fragment straight into wgmma's register A
// operand, so P never touches shared memory. O += P V reads V from shared
// memory as an MN-major B operand (wgmma's transpose), in 64-column chunks.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;              // the running max's start
constexpr float kMasked = -__builtin_inff();    // a masked score

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Hopper's tensor memory accelerator: one thread asks for a box of a 3-D
// tensor map (d, rows, bh) to be copied into shared memory, swizzled as the
// map says; the copy counts its bytes off an mbarrier in shared memory.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// Asynchronous copies into shared memory: 16 bytes a thread with cp.async,
// zero-filled past `src_bytes` and counted off an mbarrier when they land.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// The mbarrier's arrival count includes this thread, which arrives once all
// of its earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// ---- f32 on the FP32 units -------------------------------------------------

constexpr int kRing = 3;  // K/V tile buffers

template <int HD>
struct F32Tiles {
  static constexpr int W = 8;                   // warps a block
  static constexpr int kThreads = 32 * W;
  static constexpr int R = HD <= 128 ? 16 : 8;  // query rows a warp owns
  static constexpr int BQ = W * R;              // query rows a block
  static constexpr int BK = HD <= 128 ? 64 : 32;  // keys a tile
  static constexpr int WR = R / 8;              // row groups of a warp
  static constexpr int WC = 32 / WR;            // threads along keys, columns
  static constexpr int TN = BK / WC;            // keys a thread scores
  static constexpr int TC = HD / WC;            // output columns a thread owns
  static constexpr int LD = HD + 4;             // Q, K, V row stride (floats)
  static constexpr int LDP = BK + 16;           // P row stride (floats)
  static constexpr int kQ = BQ * LD;            // floats of the Q tile
  static constexpr int kTile = BK * LD;         // floats of a K or V tile
  static constexpr int kP = R * LDP;            // floats of a warp's P
  static constexpr int smem_bytes = 4 * (kQ + kRing * kTile + W * kP);
  static_assert(TC % 4 == 0 && TN >= 1, "a thread owns float4 columns");
  static_assert(smem_bytes <= 227 * 1024, "one block's shared memory");
};

// Rows row0 .. row0 + kRows - 1 of an (n, d) f32 matrix into shared memory at
// `dst` (rows LD floats apart), zero past row n and past column d, in
// 16-byte copies shared out over `kLanes` threads (this one is `lane`); then
// `bar` counts this thread's copies.
template <int HD, int LD, int kRows, int kLanes>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src,
                                          int row0, int n, int d, int lane,
                                          uint32_t bar) {
  constexpr int kChunks = HD / 4;  // 16-byte chunks a row, a power of two
  static_assert(kRows * kChunks % kLanes == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kLanes; ++it) {
    const int i = lane + it * kLanes;
    const int r = i / kChunks, c = 4 * (i % kChunks), g = row0 + r;
    const bool in = g < n && c < d;
    cp_async16(dst + 4 * (r * LD + c),
               in ? src + static_cast<size_t>(g) * d + c : src, in ? 16 : 0);
  }
  cp_async_arrive(bar);
}

template <int HD, bool kWindow>
__global__ void __launch_bounds__(F32Tiles<HD>::kThreads, 1)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int s_len, int t_len, int d, int causal, int window_arg,
                  float scale) {
  const int window = kWindow ? window_arg : 0;  // 0 folds the window away
  using F = F32Tiles<HD>;
  constexpr int R = F::R, BK = F::BK, WR = F::WR, WC = F::WC, TN = F::TN,
                TC = F::TC, LD = F::LD, LDP = F::LDP;
  extern __shared__ __align__(16) float smem[];
  // The Q tile's mbarrier, then a "full" and an "empty" one a ring buffer.
  __shared__ __align__(8) uint64_t bars[1 + 2 * kRing];
  float* qs = smem;
  float* ring = qs + F::kQ;
  const uint32_t bar_q = smem_addr(bars), bar_full = bar_q + 8,
                 bar_empty = bar_full + 8 * kRing;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F::BQ;  // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = static_cast<size_t>(bh) * s_len * d;
  const size_t koff = static_cast<size_t>(bh) * t_len * d;
  int n_tiles = (t_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + F::BQ, s_len) - 1) / BK + 1);
  // The window hides every key below q0 - window + 1 from all of the
  // block's rows: it starts at the tile that holds that key.
  const int j0 = kWindow ? max(0, q0 - window + 1) / BK : 0;
  const int n_ring = 2 * max(0, n_tiles - j0);  // K_j0, V_j0, K_j0+1, ...

  if (threadIdx.x == 0) {
    mbar_init(bar_q, F::kThreads);
    for (int b = 0; b < kRing; ++b) {
      mbar_init(bar_full + 8 * b, F::kThreads);
      mbar_init(bar_empty + 8 * b, F::kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile n of the sequence K_j0, V_j0, K_j0+1, V_j0+1, ... goes to ring
  // buffer n % kRing; every thread copies its share of it. Tiles 0 and 1 go
  // now, and a thread that is done with tile n copies tile n + 2, into the
  // buffer of tile n - 1, once every thread is done with that one.
  const uint32_t ring_addr = smem_addr(ring);
  const auto load_tile = [&](int n) {
    const int b = n % kRing;
    if (n >= kRing) mbar_wait(bar_empty + 8 * b, (n / kRing - 1) & 1);
    load_rows<HD, LD, BK, F::kThreads>(
        ring_addr + 4 * b * F::kTile, ((n & 1) ? v : k) + koff,
        (j0 + (n >> 1)) * BK, t_len, d, threadIdx.x, bar_full + 8 * b);
  };
  load_rows<HD, LD, F::BQ, F::kThreads>(smem_addr(qs), q + qoff, q0, s_len, d,
                                     threadIdx.x, bar_q);
  for (int n = 0; n < 2 && n < n_ring; ++n) load_tile(n);

  const int ty = lane / WC, tx = lane % WC;
  const int wrow0 = q0 + R * warp;              // the warp's first row
  const float* qw = qs + (R * warp + ty) * LD;  // + WR*i*LD: row i
  float* pw = ring + kRing * F::kTile + warp * F::kP;
  float m[8], l[8], acc[8][TC];                 // l: this thread's part
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  }
  mbar_wait(bar_q, 0);

  for (int j = j0, b = 0, use = 0; j < n_tiles; ++j) {
    const int k0 = j * BK, n = 2 * (j - j0);  // n: K_j's place in the ring
    // The warp's rows see the tile if its first row sees the tile's last
    // key (the window's lower edge) and its last row the tile's first key.
    const bool live = wrow0 < s_len && (!causal || k0 <= wrow0 + R - 1) &&
                      (!kWindow || k0 + BK - 1 > wrow0 - window);
    float sc[8][TN];

    // S = Q K_j^T for rows ty + WR*i, keys tx + WC*jn.
    mbar_wait(bar_full + 8 * b, use & 1);
    if (live) {
      const float* kt = ring + b * F::kTile + tx * LD;
      if constexpr (TN == 1) {
        // One key a thread (hd = 256): the registers allow a partial sum a
        // float4 lane, which shortens each 256-term chain of roundings to
        // 64 (and the error against the exact dot by about half).
        float4 sp[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) sp[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = 0; c < HD; c += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qw + WR * i * LD + c);
            sp[i].x = fmaf(qv.x, kv.x, sp[i].x);
            sp[i].y = fmaf(qv.y, kv.y, sp[i].y);
            sp[i].z = fmaf(qv.z, kv.z, sp[i].z);
            sp[i].w = fmaf(qv.w, kv.w, sp[i].w);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sc[i][0] = (sp[i].x + sp[i].y) + (sp[i].z + sp[i].w);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jn = 0; jn < TN; ++jn) sc[i][jn] = 0.f;
#pragma unroll 8
        for (int c = 0; c < HD; c += 4) {
          float4 kv[TN];
#pragma unroll
          for (int jn = 0; jn < TN; ++jn)
            kv[jn] = *reinterpret_cast<const float4*>(kt + WC * jn * LD + c);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qw + WR * i * LD + c);
#pragma unroll
            for (int jn = 0; jn < TN; ++jn) {
              sc[i][jn] = fmaf(qv.x, kv[jn].x, sc[i][jn]);
              sc[i][jn] = fmaf(qv.y, kv[jn].y, sc[i][jn]);
              sc[i][jn] = fmaf(qv.z, kv[jn].z, sc[i][jn]);
              sc[i][jn] = fmaf(qv.w, kv[jn].w, sc[i][jn]);
            }
          }
        }
      }
    }
    mbar_arrive(bar_empty + 8 * b);
    if (++b == kRing) b = 0, ++use;
    if (n + 2 < n_ring) load_tile(n + 2);

    if (live) {
      // Online softmax; scores are scaled before the mask, so any sign of
      // scale holds.
      const bool mask = (causal && k0 + BK - 1 > wrow0) || k0 + BK > t_len ||
                        (kWindow && k0 <= wrow0 + R - 1 - window);
      float corr[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qpos = wrow0 + ty + WR * i;
        float mx = kNegInf;
#pragma unroll
        for (int jn = 0; jn < TN; ++jn) {
          float x = sc[i][jn] * scale;
          if (mask) {
            const int kpos = k0 + tx + WC * jn;
            if (kpos >= t_len || (causal && kpos > qpos) ||
                (kWindow && kpos <= qpos - window))
              x = kMasked;
          }
          sc[i][jn] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = WC / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        corr[i] = expf(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < TN; ++jn) {
          sc[i][jn] = expf(sc[i][jn] - m_new);
          sum += sc[i][jn];
        }
        l[i] = corr[i] * l[i] + sum;
      }
      __syncwarp();                  // every lane is done with the last P
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jn = 0; jn < TN; ++jn)
          pw[(ty + WR * i) * LDP + tx + WC * jn] = sc[i][jn];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][c] *= corr[i];
    }

    // acc += P V_j for rows ty + WR*i, columns 4*tx + 4*WC*h + e.
    mbar_wait(bar_full + 8 * b, use & 1);
    if (live) {
      const float* vt = ring + b * F::kTile + 4 * tx;
      const float* pr = pw + ty * LDP;
#pragma unroll 2
      for (int jk = 0; jk < BK; jk += 4) {
        float4 p4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          p4[i] = *reinterpret_cast<const float4*>(pr + WR * i * LDP + jk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4 vv[TC / 4];
#pragma unroll
          for (int h = 0; h < TC / 4; ++h)
            vv[h] = *reinterpret_cast<const float4*>(vt + (jk + e) * LD +
                                                     4 * WC * h);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p = e == 0 ? p4[i].x
                          : e == 1 ? p4[i].y
                          : e == 2 ? p4[i].z
                                   : p4[i].w;
#pragma unroll
            for (int h = 0; h < TC / 4; ++h) {
              acc[i][4 * h] = fmaf(p, vv[h].x, acc[i][4 * h]);
              acc[i][4 * h + 1] = fmaf(p, vv[h].y, acc[i][4 * h + 1]);
              acc[i][4 * h + 2] = fmaf(p, vv[h].z, acc[i][4 * h + 2]);
              acc[i][4 * h + 3] = fmaf(p, vv[h].w, acc[i][4 * h + 3]);
            }
          }
        }
      }
    }
    mbar_arrive(bar_empty + 8 * b);
    if (++b == kRing) b = 0, ++use;
    if (n + 3 < n_ring) load_tile(n + 3);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = WC / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = wrow0 + ty + WR * i;
    if (row >= s_len) continue;
    const float den = fmaxf(lt, 1e-30f);
    float* orow = o + qoff + static_cast<size_t>(row) * d;
#pragma unroll
    for (int h = 0; h < TC / 4; ++h) {
      const int col = 4 * tx + 4 * WC * h;  // d is a multiple of 4
      if (col < d)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * h] / den, acc[i][4 * h + 1] / den,
                        acc[i][4 * h + 2] / den, acc[i][4 * h + 3] / den);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s_len, int t_len, int d, int causal, int window,
                   float scale, cudaStream_t stream) {
  using F = F32Tiles<HD>;
  const auto kernel = window > 0 ? flash_attn_kernel<HD, true>
                                 : flash_attn_kernel<HD, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::smem_bytes);
  if (err != cudaSuccess) return err;
  // 16-byte copies need rows a multiple of 16 bytes apart and 16-byte
  // aligned bases, which the wrapper (flash_attn/ops.py) pads and copies for.
  if (d % 4 != 0 || ((reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) |
                      reinterpret_cast<uintptr_t>(o)) % 16) != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(bh, (s_len + F::BQ - 1) / F::BQ);
  kernel<<<grid, F::kThreads, F::smem_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s_len, t_len, d,
      causal, window, scale);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores --------------------------------------------

constexpr int kTcWarpGroups = 2;
constexpr int kTcBlockQ = 64 * kTcWarpGroups;   // query rows a block carries
constexpr int kTcBlockK = 64;                   // keys in one K or V tile
constexpr int kTcThreads = 128 * kTcWarpGroups;
constexpr int kTcStages = 2;                    // the K/V ring

// Bytes of a tile of `rows` rows and HD bf16 columns, and the block's
// dynamic shared memory: Q, the ring of K and V tiles, and 1 KB of slack to
// align the swizzle atoms (8 rows x 128 bytes) to 1024 bytes.
template <int HD>
__host__ __device__ constexpr int tc_tile_bytes(int rows) {
  return rows * HD * 2;
}
template <int HD>
constexpr int tc_smem_bytes() {
  return tc_tile_bytes<HD>(kTcBlockQ) +
         2 * kTcStages * tc_tile_bytes<HD>(kTcBlockK) + 1024;
}

// Byte offset of 16-byte chunk `chunk` (columns 8*chunk ..) of row r in a
// tile of `rows` rows: panels of 64 columns, rows 128 bytes apart within a
// panel, chunks XOR-swizzled by r % 8 (CU_TENSOR_MAP_SWIZZLE_128B's layout).
__device__ __forceinline__ uint32_t swizzled(int r, int chunk, int rows) {
  return static_cast<uint32_t>((chunk >> 3) * rows * 128 + r * 128 +
                               (((chunk & 7) ^ (r & 7)) << 4));
}

// Rows row0 .. row0 + kRows - 1 of head bh into a swizzled tile, one
// 64-column panel a box.
template <int HD, int kRows>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int bh) {
#pragma unroll
  for (int p = 0; p < HD / 64; ++p)
    tma_load(dst + p * kRows * 128, map, bar, 64 * p, row0, bh);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// 8-row groups 1024 bytes apart (the stride byte offset, and the leading
// byte offset, which a K-major swizzled operand and an MN-major one 64
// columns wide do not read).
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TC_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_D32 TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24)
#define TC_D32_LIST                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B K-major in shared
// memory; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) B (16 x 64), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x on the special-function unit; relative error below 2^-22, and a
// result below 2^-126 flushes to 0 (a weight under 1e-38 next to the row's
// largest, 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// The m64nNk16 accumulator fragment: in warp w of a warpgroup, lane `lane`
// holds d[4j + e] at row 16w + lane/4 + 8*(e/2), column 8j + 2*(lane%4) +
// e%2. A thread thus owns two rows of the score tile (16 values each) and
// the same two rows of the output.
template <int HD, bool kWindow>
__global__ void __launch_bounds__(kTcThreads, HD <= 128 ? 2 : 1)
flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int s_len, int t_len,
                       int d, int causal, int window_arg, float scale_log2) {
  const int window = kWindow ? window_arg : 0;  // 0 folds the window away
  constexpr int NC = HD / 64;                  // 64-column output chunks
  constexpr int kKV = tc_tile_bytes<HD>(kTcBlockK);
  extern __shared__ uint8_t tc_smem[];
  __shared__ __align__(8) uint64_t bars[1 + kTcStages];  // Q, then a stage
  const uint32_t qs = (smem_addr(tc_smem) + 1023) & ~1023u;
  const uint32_t ring = qs + tc_tile_bytes<HD>(kTcBlockQ);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBlockQ;  // longest first
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wg_row0 = q0 + 64 * wg;            // this warpgroup's first row
  const int r0 = wg_row0 + 16 * warp + lane / 4;  // the thread's rows: r0, r0 + 8
  const size_t qoff = static_cast<size_t>(bh) * s_len * d;

  int n_tiles = (t_len + kTcBlockK - 1) / kTcBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kTcBlockQ - 1) / kTcBlockK + 1);
  // The window hides every key below q0 - window + 1 from all of the
  // block's rows: it starts at the tile that holds that key. Tile j uses
  // stage (j - j0) % kTcStages.
  const int j0 = kWindow ? max(0, q0 - window + 1) / kTcBlockK : 0;
  const uint32_t bar0 = smem_addr(bars);
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kTcStages; ++i) mbar_init(bar0 + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // No key tile to visit (t_len 0, or every key below the window): no
  // copies, and every row writes 0.
  if (threadIdx.x == 0 && n_tiles > j0) {
    mbar_expect(bar0, tc_tile_bytes<HD>(kTcBlockQ));
    tma_tile<HD, kTcBlockQ>(qs, &tm_q, bar0, q0, bh);
    mbar_expect(bar0 + 8, 2 * kKV);
    tma_tile<HD, kTcBlockK>(ring, &tm_k, bar0 + 8, j0 * kTcBlockK, bh);
    tma_tile<HD, kTcBlockK>(ring + kKV, &tm_v, bar0 + 8, j0 * kTcBlockK, bh);
  }

  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part

  // One step of the key loop, for tile j. The tiles that hold a key below
  // the window's edge for some row of the block (an edge tile) test it; the
  // tiles above the edge run the window-free kernel's step as it is, so the
  // window costs the steady state nothing.
  const auto step = [&](int j, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    const int jj = j - j0;                    // steps done before this one
    const uint32_t ks = ring + (jj % kTcStages) * 2 * kKV, vs = ks + kKV;
    // Tile j + 1 goes to the other stage, which the barrier at the end of
    // step j - 1 freed.
    const uint32_t nks = ring + ((jj + 1) % kTcStages) * 2 * kKV;
    const uint32_t nbar = bar0 + 8 * (1 + (jj + 1) % kTcStages);
    if (threadIdx.x == 0 && j + 1 < n_tiles) {
      const int k1 = (j + 1) * kTcBlockK;
      mbar_expect(nbar, 2 * kKV);
      tma_tile<HD, kTcBlockK>(nks, &tm_k, nbar, k1, bh);
      tma_tile<HD, kTcBlockK>(nks + kKV, &tm_v, nbar, k1, bh);
    }
    if (jj == 0) mbar_wait(bar0, 0);
    mbar_wait(bar0 + 8 * (1 + jj % kTcStages), (jj / kTcStages) & 1);

    const int k0 = j * kTcBlockK;
    // A warpgroup whose rows all lie above the tile's first key, all past
    // the window of its last key, or below the sequence's end, skips it
    // (every weight would be exactly 0).
    const bool live = wg_row0 < s_len && (!causal || k0 <= wg_row0 + 63) &&
                      (!kEdge || k0 + kTcBlockK - 1 > wg_row0 - window);
    if (live) {
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(s,
                 tc_desc(qs + (kk / 4) * kTcBlockQ * 128 + wg * 64 * 128 + col),
                 tc_desc(ks + (kk / 4) * kTcBlockK * 128 + col), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(s);

      const bool mask = (causal && k0 + kTcBlockK - 1 > wg_row0) ||
                        k0 + kTcBlockK > t_len ||
                        (kEdge && k0 <= wg_row0 + 63 - window);
      // Scores are scaled by scale * log2(e) before the mask, as the plain
      // version scales before it masks (so any sign of scale holds), and m
      // is kept in those units: p = 2^(s - m) is one subtraction and ex2.
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] *= scale_log2;
        if (mask) {
          const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          const int qpos = r0 + 8 * ((i / 2) % 2);
          if (kpos >= t_len || (causal && kpos > qpos) ||
              (kEdge && kpos <= qpos - window))
            s[i] = kMasked;
        }
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
      uint32_t pa[4][4];                      // P as four k16 A fragments
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i / 2) % 2;
        const float p0 = ex2(s[i] - m[h]);
        const float p1 = ex2(s[i + 1] - m[h]);
        l[h] += p0 + p1;
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i / 2) % 2];
        reg_fence(acc[c]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < kTcBlockK / 16; ++kk)
          wgmma_rs(acc[c], pa[kk],
                   tc_desc(vs + c * kTcBlockK * 128 + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
    }
    __syncthreads();                          // this stage may be refilled
  };
  int j = j0;
  if constexpr (kWindow) {
    // Tiles with k0 <= q0 + kTcBlockQ - 1 - window: a row of the block has
    // its window's edge in or above them.
    const int j_edge =
        min(n_tiles, max(j0, (q0 + kTcBlockQ - 1 - window) / kTcBlockK + 1));
    for (; j < j_edge; ++j) step(j, Flag<true>{});
  }
  for (; j < n_tiles; ++j) step(j, Flag<false>{});

  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    den[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 8 * ((i / 2) % 2);
      const int col = 64 * c + 8 * (i / 4) + 2 * (lane % 4);
      if (row >= s_len || col >= d) continue;
      const float a0 = acc[c][i] / den[(i / 2) % 2];
      const float a1 = acc[c][i + 1] / den[(i / 2) % 2];
      // d is even (a multiple of 8), so col + 1 < d as well.
      *reinterpret_cast<__nv_bfloat162*>(o + qoff +
                                         static_cast<size_t>(row) * d + col) =
          __floats2bfloat162_rn(a0, a1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query (so the library needs no link against libcuda); null where absent.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (d, rows, bh) bf16 tensor at `base` in boxes of 64 columns x box_rows
// rows, 128-byte swizzled; reads past d or rows fill zeros.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int d, int bh,
                int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int bh, int s_len, int t_len, int d, int causal,
                        int window, float scale, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<HD>();
  const auto kernel = window > 0 ? flash_attn_bf16_kernel<HD, true>
                                 : flash_attn_bf16_kernel<HD, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // Tensor maps need rows a multiple of 16 bytes apart and 16-byte aligned
  // bases, which the wrapper (flash_attn/ops.py) pads and copies for. With
  // no keys the kernel copies nothing and the maps stay empty.
  if (d % 8 != 0 || ((reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v)) % 16) != 0)
    return cudaErrorInvalidValue;
  CUtensorMap tm[3] = {};
  if (t_len > 0 && !(tensor_map(&tm[0], q, s_len, d, bh, kTcBlockQ) &&
                     tensor_map(&tm[1], k, t_len, d, bh, kTcBlockK) &&
                     tensor_map(&tm[2], v, t_len, d, bh, kTcBlockK)))
    return cudaErrorInvalidValue;
  const dim3 grid(bh, (s_len + kTcBlockQ - 1) / kTcBlockQ);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      tm[0], tm[1], tm[2], static_cast<__nv_bfloat16*>(o), s_len, t_len, d,
      causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                          int bh, int s_len, int t_len, int d, int causal,
                          int window, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch_bf16<64>(q, k, v, o, bh, s_len, t_len, d, causal, window,
                           scale, stream);
  if (d <= 128)
    return launch_bf16<128>(q, k, v, o, bh, s_len, t_len, d, causal, window,
                            scale, stream);
  if (d <= 256)
    return launch_bf16<256>(q, k, v, o, bh, s_len, t_len, d, causal, window,
                            scale, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         int bh, int s_len, int t_len, int d, int causal,
                         int window, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<64>(q, k, v, o, bh, s_len, t_len, d, causal, window, scale,
                      stream);
  if (d <= 128)
    return launch<128>(q, k, v, o, bh, s_len, t_len, d, causal, window, scale,
                       stream);
  if (d <= 256)
    return launch<256>(q, k, v, o, bh, s_len, t_len, d, causal, window, scale,
                       stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (bh, s, d), k and v (bh, t, d), o (bh, s, d), all contiguous and
// 16-byte aligned, f32 (d a multiple of 4) or (bf16 != 0) bf16 (d a multiple
// of 8); 0 < d <= 256. window > 0 (causal only) bounds what a query sees to
// its last `window` keys; 0 is no window.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int bh, int s, int t, int d,
                                 int causal, int window, float scale, int bf16,
                                 void* stream) {
  if (window < 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_bf16(q, k, v, o, bh, s, t, d, causal, window, scale, st)
           : dispatch_f32(q, k, v, o, bh, s, t, d, causal, window, scale, st);
  return static_cast<int>(err);
}
