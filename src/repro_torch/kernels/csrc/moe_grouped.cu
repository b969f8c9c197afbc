// K6: the held experts of a MoE layer in one grouped launch, bf16 on the
// tensor cores (models/moe.py, the grouped path).
//
// Replaces no TPU kernel: the JAX package leaves its expert einsums to XLA
// (src/repro/models/moe.py), and the port ran them as a host loop over the
// held experts (`_experts_loop` in models/moe.py, K6's plain version), which
// needs each expert's row count on the host: one sync a layer, after which
// the device waits while the host enqueues the loop. Here the row counts stay
// on the device. `moe.dispatch` sorts the (token, choice) rows by held expert
// and builds, with torch operations on the device, each held expert's first
// sorted row (`offsets`, n + 1 entries), a tile table (per tile of kRows
// sorted rows: its expert and first row; the tiles in use at `n_tiles`) and
// the inverse of the sort (the sorted row of each (token, choice)). Three
// launches follow, none sized from the host:
//
//  1. gate/up: per (tile, 128 columns of f), x's rows gathered through the
//     sorted token list times wg[e] and wu[e] into two f32 accumulators;
//     writes h = silu(g) * u in bf16 at the sorted rows, each product rounded
//     to bf16 before the SiLU and the multiply, as the loop's bf16 GEMMs and
//     elementwise ops round.
//  2. down: per (tile, 256 columns of d), h's rows times wd[e] in f32, times
//     the row's combine weight (the gate rounded to bf16, read as f32), into
//     an f32 row buffer y at the sorted rows. (The loop rounds this product
//     to bf16 first; K6 keeps it in f32.)
//  3. combine: per token, its held choices' rows of y summed in f32 in
//     choice order through the inverse permutation, rounded to bf16 once,
//     then (where given) the shared expert's output added in bf16. A fixed
//     order, so the result is the same bit for bit run to run; no atomics.
//
// What bounds it: the products' operations, 2 * rows * d * f * 3 (at
// DeepSeek-V2-Lite's 16k-token prefill about 12,000 rows a layer, 0.21
// TFLOP, 0.21 ms at 989 TFLOP/s), or where few rows meet many experts
// (llama4's 128) the stacks' bytes, each read once. Beneath that, L2's
// bandwidth: a stage brings 56 KB (A's 192 rows and B's four panels) for
// 6.3 MFLOP, so the tile is as large as three warpgroups' registers allow.
//
// Design. One persistent block an SM walks the work items (tile, column
// block) of the device-side table, expert by expert, column block by column
// block with the expert's tiles fastest (`item_at`), so a block is tied to
// no expert however uneven the load (the busiest held expert has 2-2.6
// times the mean rows), and the blocks in flight share weight panels. Three
// warpgroups, 64 of a tile's 192 rows each, issue
// wgmma.mma_async (bf16 in, f32 accumulate, 128 f32 accumulators a thread)
// from a ring of kStages shared-memory stages of depth 64: A is gathered row
// by row with cp.async (16 bytes a thread, zero past the tile's last row)
// into the 128-byte-swizzled K-major layout, B comes by TMA as 64 x 64
// panels of the (experts x rows, columns) weight stack, 128-byte swizzled and
// read MN-major (wgmma's transposed B). The ring runs on across work items,
// so the next item's loads are in flight during an item's epilogue. A stage
// completes on an mbarrier (every thread's cp.async and the TMA's bytes);
// one block-wide barrier a step, after the previous step's products are
// done, frees the stage that the next load refills.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kGroups = 3;        // warpgroups a block, 64 rows of a tile each
constexpr int kRows = 64 * kGroups;  // sorted rows a tile
constexpr int kDepth = 64;        // depth of a stage: one 128-byte panel
constexpr int kStages = 4;        // the ring
constexpr int kThreads = 128 * kGroups;
constexpr int kPass = kThreads / 8;  // A rows a pass of 16-byte copies
constexpr int kPanel = kDepth * 128;           // a 64 x 64 B panel, bytes
constexpr int kATile = kRows * 128;            // the tile's A rows, bytes
constexpr int kPanels = 4;                     // B panels a stage
constexpr int kStage = kATile + kPanels * kPanel;
constexpr int kSmem = kStages * kStage + 1024;  // + alignment to 1024
// Columns of an item: f for gate/up (wg's and wu's, so 256 B columns a
// stage), d for down. An instruction's width (CW) is 128 or 256.
constexpr int kColsGateUp = 128;
constexpr int kColsDown = 256;
static_assert(kSmem <= 232448, "one block's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
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
// A box of a 2-D tensor map (columns, rows) into shared memory, its bytes
// counted off `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}
// 16 bytes with cp.async, zero-filled past `src_bytes`.
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

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `addr`:
// 8-row groups 1024 bytes apart (the stride byte offset); `lbo`, the leading
// byte offset, is the distance between 64-column panels of an MN-major
// operand wider than one panel (a K-major swizzled operand does not read it;
// it gets 1024, as K5's descriptors).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define K6_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define K6_D32 K6_D8(0), K6_D8(8), K6_D8(16), K6_D8(24)
#define K6_D64 K6_D32, K6_D8(32), K6_D8(40), K6_D8(48), K6_D8(56)
#define K6_D128                                                        \
  K6_D64, K6_D8(64), K6_D8(72), K6_D8(80), K6_D8(88), K6_D8(96),       \
      K6_D8(104), K6_D8(112), K6_D8(120)
#define K6_L64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define K6_L128                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"

// d (64 x N, f32) (+)= A (64 x 16, K-major) B (16 x N, MN-major), both in
// shared memory; `accumulate` 0 overwrites d.
template <int N>
struct Mma;
template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " K6_L64
        ", %64, %65, p, 1, 1, 0, 1;\n}\n"
        : K6_D64
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct Mma<256> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " K6_L128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : K6_D128
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Args {
  const __nv_bfloat16* a;  // A's rows: x (tokens, d), or h (rows, f)
  const int64_t* a_row;    // gate/up: each sorted row's token; down: null
  const int64_t* tiles;    // (max_tiles, 2): a tile's expert, first row
  const int64_t* offsets;  // (n + 1): each held expert's first sorted row
  const int64_t* n_tiles;  // the tiles in use
  const float* weight;     // down: each sorted row's combine weight
  void* out;               // gate/up: h (rows, f) bf16; down: y (rows, d) f32
  int k_dim;               // d (gate/up) or f (down)
  int n_dim;               // f (gate/up) or d (down)
};

// Work item w of `nb` column blocks a tile: (its expert, first sorted row,
// rows end, column block). An expert's tiles are its items' tiles, and its
// items run column block by column block, its tiles fastest: the blocks in
// flight share each weight panel, read from memory once and then from L2
// (an expert's wg and wu outgrow L2 at mixtral's widths). Item w's tile
// w / nb lies in its expert's run of tiles, which gives the expert.
struct Item {
  int e, j;
  int64_t r0, end;
};
__device__ __forceinline__ Item item_at(const Args& args, int w, int nb) {
  const int t0 = w / nb;
  Item it;
  it.e = static_cast<int>(args.tiles[2 * t0]);
  const int64_t base = args.offsets[it.e], stop = args.offsets[it.e + 1];
  const int first = t0 - static_cast<int>((args.tiles[2 * t0 + 1] - base) /
                                          kRows);
  const int n_e = static_cast<int>((stop - base + kRows - 1) / kRows);
  const int local = w - first * nb;
  it.j = local / n_e;
  it.r0 = base + static_cast<int64_t>(local % n_e) * kRows;
  it.end = min(it.r0 + kRows, stop);
  return it;
}

// kDown false: gate/up; true: down. The fragment of an m64nNk16 product: in
// warp w of a warpgroup, lane `lane` holds d[4j + e] at row 16w + lane/4 +
// 8*(e/2), column 8j + 2*(lane%4) + e%2.
template <bool kDown>
__global__ void __launch_bounds__(kThreads, 1)
moe_grouped_kernel(const __grid_constant__ CUtensorMap tm_b0,
                   const __grid_constant__ CUtensorMap tm_b1, Args args) {
  constexpr int CW = kDown ? 256 : 128;   // an instruction's columns
  constexpr int NCH = 256 / CW;           // accumulators: chunks of CW
  constexpr int kCols = kDown ? kColsDown : kColsGateUp;
  extern __shared__ uint8_t k6_smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  const uint32_t base = (smem_addr(k6_smem) + 1023) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int nb = args.n_dim / kCols, ks = args.k_dim / kDepth;
  const int items = static_cast<int>(*args.n_tiles) * nb;
  const int mine = items > static_cast<int>(blockIdx.x)
                       ? (items - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int steps = mine * ks;
  const uint32_t bar0 = smem_addr(full);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, kThreads + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The load side, kStages - 1 steps ahead: this thread copies 16-byte
  // chunk tid % 8 of rows tid / 8 + kPass i of the A tile.
  int ld_item = -1, ld_e = 0, ld_j = 0;
  const __nv_bfloat16* ld_src[kRows / kPass];
  bool ld_in[kRows / kPass];
  const auto load = [&](int q) {
    const int item = q / ks, k = q % ks;
    if (item != ld_item) {
      ld_item = item;
      const Item it = item_at(args, blockIdx.x + item * gridDim.x, nb);
      ld_e = it.e;
      ld_j = it.j;
#pragma unroll
      for (int i = 0; i < kRows / kPass; ++i) {
        const int64_t g = it.r0 + tid / 8 + kPass * i;
        ld_in[i] = g < it.end;
        const int64_t row = !ld_in[i] ? 0 : kDown ? g : args.a_row[g];
        ld_src[i] = args.a + row * args.k_dim + (tid % 8) * 8;
      }
    }
    const uint32_t st = base + (q % kStages) * kStage;
    const uint32_t bar = bar0 + 8 * (q % kStages);
    if (tid == 0) {
      mbar_expect(bar, kPanels * kPanel);
      const uint32_t bs = st + kATile;
      const int brow = ld_e * args.k_dim + k * kDepth;
      if constexpr (kDown) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          tma_load(bs + p * kPanel, &tm_b0, bar, ld_j * kCols + 64 * p, brow);
      } else {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          tma_load(bs + p * kPanel, &tm_b0, bar, ld_j * kCols + 64 * p, brow);
          tma_load(bs + (2 + p) * kPanel, &tm_b1, bar, ld_j * kCols + 64 * p,
                   brow);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows / kPass; ++i) {
      const int r = tid / 8 + kPass * i, c = tid % 8;
      cp_async16(st + r * 128 + (((c ^ (r & 7))) << 4),
                 ld_in[i] ? ld_src[i] + k * kDepth : args.a,
                 ld_in[i] ? 16 : 0);
    }
    cp_async_arrive(bar);
  };

  float acc[NCH][CW / 2];
  for (int q = 0; q < kStages - 1 && q < steps; ++q) load(q);
  for (int item = 0, q = 0; item < mine; ++item) {
    for (int k = 0; k < ks; ++k, ++q) {
      const uint32_t st = base + (q % kStages) * kStage;
      mbar_wait(bar0 + 8 * (q % kStages), (q / kStages) & 1);
      // cp.async wrote A through the generic proxy; wgmma reads it through
      // the async one.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk) {
        const uint64_t a = desc(st + wg * 64 * 128 + kk * 32, 1024);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          Mma<CW>::run(acc[c], a,
                       desc(st + kATile + c * (CW / 64) * kPanel +
                                kk * 16 * 128,
                            kPanel),
                       k > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();            // step q - 1's products are done
      __syncthreads();            // in both warpgroups: its stage is free
      if (q + kStages - 1 < steps) load(q + kStages - 1);
    }

    // The item's epilogue.
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NCH; ++c) reg_fence(acc[c]);
    const Item it = item_at(args, blockIdx.x + item * gridDim.x, nb);
    const int j = it.j;
    const int64_t r0 = it.r0, end = it.end;
    const int row = 64 * wg + 16 * warp + lane / 4;  // and row + 8
    if constexpr (kDown) {
      float* y = static_cast<float*>(args.out);
      float wt[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        wt[hh] = r0 + row + 8 * hh < end ? args.weight[r0 + row + 8 * hh] : 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < CW / 2; i += 2) {
          const int hh = (i / 2) % 2;
          const int64_t g = r0 + row + 8 * hh;
          if (g >= end) continue;
          const int col = j * kCols + c * CW + 8 * (i / 4) + 2 * (lane % 4);
          *reinterpret_cast<float2*>(y + g * args.n_dim + col) =
              make_float2(acc[c][i] * wt[hh], acc[c][i + 1] * wt[hh]);
        }
    } else {
      __nv_bfloat16* h = static_cast<__nv_bfloat16*>(args.out);
#pragma unroll
      for (int c = 0; c < NCH / 2; ++c)
#pragma unroll
        for (int i = 0; i < CW / 2; i += 2) {
          const int64_t g = r0 + row + 8 * ((i / 2) % 2);
          if (g >= end) continue;
          const int col = j * kCols + c * CW + 8 * (i / 4) + 2 * (lane % 4);
          float v[2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float gv = round_bf16(acc[c][i + e2]);
            const float sg = round_bf16(gv / (1.f + expf(-gv)));
            v[e2] = sg * round_bf16(acc[c + NCH / 2][i + e2]);
          }
          *reinterpret_cast<__nv_bfloat162*>(h + g * args.n_dim + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
    }
  }
}

// out[s] = bf16(sum over the held choices k of s, in choice order, of
// y[inverse[s * top_k + k]]) (+ add[s] in bf16); a choice is held where its
// sorted row lies before offsets[n]. Four columns a thread (d % 4 == 0).
__global__ void moe_combine_kernel(const float* __restrict__ y,
                                   const int64_t* __restrict__ inverse,
                                   const int64_t* __restrict__ offsets,
                                   const __nv_bfloat16* __restrict__ add,
                                   __nv_bfloat16* __restrict__ out, int n,
                                   int top_k, int d) {
  const int64_t s = blockIdx.x;
  const int64_t held = offsets[n];
  for (int c = 4 * threadIdx.x; c < d; c += 4 * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < top_k; ++k) {
      const int64_t p = inverse[s * top_k + k];
      if (p >= held) continue;
      const float4 v = *reinterpret_cast<const float4*>(y + p * d + c);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    float r[4] = {round_bf16(acc.x), round_bf16(acc.y), round_bf16(acc.z),
                  round_bf16(acc.w)};
    if (add != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] += __bfloat162float(add[s * d + c + i]);
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + s * d + c);
    o[0] = __floats2bfloat162_rn(r[0], r[1]);
    o[1] = __floats2bfloat162_rn(r[2], r[3]);
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

// A (rows, cols) bf16 matrix in 64 x 64 boxes, 128-byte swizzled.
bool tensor_map(CUtensorMap* map, const void* base, int64_t rows, int cols) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, kDepth};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

template <bool kDown>
cudaError_t launch_gemm(const CUtensorMap& b0, const CUtensorMap& b1,
                        const Args& args, int max_tiles, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_grouped_kernel<kDown>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  const int items = max_tiles * (args.n_dim / (kDown ? kColsDown
                                                     : kColsGateUp));
  const int grid = items < sm_count() ? items : sm_count();
  if (grid > 0)
    moe_grouped_kernel<kDown><<<grid, kThreads, kSmem, stream>>>(b0, b1, args);
  return cudaGetLastError();
}

}  // namespace

// x (tokens, d) bf16; wg, wu (n, d, f), wd (n, f, d) bf16, the held experts'
// stacks; token, weight, inverse (rows = tokens * top_k): each sorted row's
// token and combine weight (f32), each (token, choice)'s sorted row; offsets
// (n + 1), tiles (max_tiles, 2), n_tiles (1) int64 from `moe.dispatch`; add
// (tokens, d) bf16 or null; h (rows, f) bf16 and y (rows, d) f32 scratch;
// out (tokens, d) bf16. All contiguous, 16-byte aligned; d % 256 == 0 and
// f % 128 == 0. Three launches: gate/up, down, combine.
extern "C" int moe_grouped_launch(
    const void* x, const void* wg, const void* wu, const void* wd,
    const void* token, const void* weight, const void* offsets,
    const void* tiles, const void* n_tiles, const void* inverse,
    const void* add, void* h, void* y, void* out, int tokens, int top_k,
    int n, int d, int f, int max_tiles, void* stream) {
  if (d % kColsDown != 0 || f % kColsGateUp != 0 || n <= 0 || top_k <= 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wg) |
        reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
        reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(out)) %
       16) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tokens == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap tm[3] = {};
  if (!(tensor_map(&tm[0], wg, static_cast<int64_t>(n) * d, f) &&
        tensor_map(&tm[1], wu, static_cast<int64_t>(n) * d, f) &&
        tensor_map(&tm[2], wd, static_cast<int64_t>(n) * f, d)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* tl = static_cast<const int64_t*>(tiles);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int64_t* nt = static_cast<const int64_t*>(n_tiles);
  Args up{static_cast<const __nv_bfloat16*>(x),
          static_cast<const int64_t*>(token), tl, off, nt, nullptr, h, d, f};
  cudaError_t err = launch_gemm<false>(tm[0], tm[1], up, max_tiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args down{static_cast<const __nv_bfloat16*>(h), nullptr, tl, off, nt,
            static_cast<const float*>(weight), y, f, d};
  err = launch_gemm<true>(tm[2], tm[2], down, max_tiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_combine_kernel<<<tokens, 256, 0, st>>>(
      static_cast<const float*>(y), static_cast<const int64_t*>(inverse), off,
      static_cast<const __nv_bfloat16*>(add),
      static_cast<__nv_bfloat16*>(out), n, top_k, d);
  return static_cast<int>(cudaGetLastError());
}
