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
//  * K3 (deepsets_kernel, replaces deepsets_pallas: phi, the set sum as a
//    ones-row MAC, a requant by log2 M, rho, in one pallas_call). A served
//    deepsets-32 batch (64 events x 32 x 21) moves 48 KB, so its bound from
//    bytes is 14 ns; what a launch costs is the launch itself and the
//    dependent chain of one event: the load round trip, three phi layers,
//    the sum and two rho layers. On this card the chain is bound by what
//    one warp issues: a tile's epilogue takes several integer instructions
//    an output on half-rate pipes, far more issue slots than its mma.sync.
//    So an event spans two warps, each carrying one 16-row tile of
//    every 32 set rows through phi under __syncwarp() alone (the mma layout
//    and products of K2); they meet once, at the set sum, by a named
//    barrier of 64 threads. Each pass of a layer covers 4, 2 or 1
//    n-tiles fixed at compile time, so its loads, products and epilogue
//    carry no branch and overlap; the bias starts the accumulators, and
//    cvt.pack.sat saturates and packs two outputs at once. x's zero rows
//    (m..mp-1) are zero A fragments. Layer 0 reads x as the contiguous
//    bytes an event is, staged by cp.async (16-byte copies when every event
//    starts 16-byte aligned, else bytes) and read back as words with a
//    funnel shift, so x needs no repacking; for sets above 32 rows the next
//    rows are staged while phi runs on these, so shared memory does not
//    grow with the set. The set sum adds phi's requantized int8 outputs in
//    int32 from the fragments: rows g and g + 8 (masked to rows < mp), two
//    columns packed in a word across g by __shfl_xor, across passes and
//    the two warps in shared memory; the first warp requantizes it by
//    log2(mp) into row 0 of a tile and runs rho on that tile, whose other
//    rows are never stored. The wrapper packs phi's and rho's weights,
//    biases and layer records into one contiguous buffer, brought in by one
//    cp.async loop with the first rows of x before the block's one barrier
//    (six loops over six buffers were slower to issue on an H100); each
//    layer then reads its record from shared memory, one layer ahead.
//    On an H100 the 16-byte x staging was 0.6 us faster a launch than the
//    byte path.
#include <climits>

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

// ---- K3 ---------------------------------------------------------------------

constexpr int kGroupRows = 32;   // set rows an event takes a pass of phi
constexpr int kEventWarps = 2;   // warps an event spans, a 16-row tile each
constexpr int kWarpTiles = kGroupRows / kWarpRows / kEventWarps;
constexpr int kMaxWarps = 8;     // warps a block
static_assert(sizeof(ChainLayer) == 4 * REPRO_LAYER_INTS, "ChainLayer is ints");

// The shapes of a K3 launch, passed by value (fixed parameter offsets).
struct DsShape {
  int batch, m, mp, k0, agg_shift;
  int stride;       // activation row, bytes
  int xraw;         // a warp's staged rows of x, bytes
  int warp_bytes;   // a warp's share of shared memory
  int n_phi, n_rho, phi_w_bytes, rho_w_bytes, phi_b_count, rho_b_count;
  int pack_bytes;   // the packed model (see deepsets_kernel), bytes
  int xvec;         // x staged in 16-byte copies
};

// What a pass of a layer does with its results.
enum PassKind { kToTiles, kSetSum, kToRow0, kToOut };

// What a warp's passes read besides the layer itself.
struct DsCtx {
  const int* xr;      // the warp's staged rows of x (phi's first layer)
  int8_t* in;         // the activation buffer a layer reads
  int8_t* dst;        // the one it writes
  int8_t* out;        // the event's output row in device memory
  int* agg;           // the warp's share of the set sum, int32
  int g, t, k0, stride, r0, m, mp;
  bool first_group;
};

// The four bytes of staged x at byte offset o, from the two aligned words
// that hold them.
__device__ __forceinline__ int x_word(const int* raw, int o) {
  const unsigned lo = raw[o >> 2], hi = raw[(o >> 2) + 1];
  return static_cast<int>(__funnelshift_r(lo, hi, 8 * (o & 3)));
}

// requant_sat8 of ReLU (floor 0) or of nothing (floor INT_MIN), without the
// saturation, which pack_sat8 or sat8 applies.
__device__ __forceinline__ int round_shift(int v, int floor, int shift) {
  v = max(v, floor);
  if (shift > 0) {
    const int half = 1 << (shift - 1);
    v = wrap_add(v, v >= 0 ? half : half - 1) >> shift;
  }
  return v;
}
__device__ __forceinline__ int sat8(int v) { return min(max(v, -128), 127); }
// Two ints saturated to int8 and packed, lo in the low byte.
__device__ __forceinline__ unsigned short pack_sat8(int lo, int hi) {
  unsigned d;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(hi), "r"(lo), "r"(0));
  return static_cast<unsigned short>(d);
}

// One pass of a layer: NT n-tiles (8*NT columns from n0) over T 16-row
// tiles, with no branch between its loads, products and epilogue, so that
// they overlap. The bias starts the accumulators (int32 sums wrap either
// way). Rows from FROM_X ? the staged x : c.in.
template <int T, int NT, int KIND, bool FROM_X>
__device__ __forceinline__ void ds_pass(const DsCtx& c, const ChainLayer& L,
                                        const int8_t* wt, const int* bias,
                                        int n0) {
  const int g = c.g, t = c.t;
  int acc[T][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + 8 * j + 2 * t;  // biases are zero-padded to np
    const int b0 = L.has_bias ? bias[col] : 0;
    const int b1 = L.has_bias ? bias[col + 1] : 0;
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      acc[tt][j][0] = acc[tt][j][2] = b0;
      acc[tt][j][1] = acc[tt][j][3] = b1;
    }
  }
#pragma unroll 1
  for (int kb = 4 * t; kb < L.kp; kb += 32) {
    int a[T][4];
#pragma unroll
    for (int tt = 0; tt < T; ++tt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = 16 * tt + g + 8 * h;
        if (FROM_X) {  // rows at or past m are x's zero padding
          const bool ok = c.r0 + rr < c.m;
          a[tt][h] = ok ? x_word(c.xr, rr * c.k0 + kb) : 0;
          a[tt][h + 2] = ok ? x_word(c.xr, rr * c.k0 + kb + 16) : 0;
        } else {
          a[tt][h] = word_at(c.in + rr * c.stride + kb);
          a[tt][h + 2] = word_at(c.in + rr * c.stride + kb + 16);
        }
      }
    int b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* wc = wt + (n0 + 8 * j + g) * L.ks + kb;
      b[j][0] = word_at(wc);
      b[j][1] = word_at(wc + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int tt = 0; tt < T; ++tt) mma_s8(acc[tt][j], a[tt], b[j]);
  }
  const int floor = L.relu ? 0 : INT_MIN;
  if (KIND == kToTiles) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int tt = 0; tt < T; ++tt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<unsigned short*>(
              c.dst + (16 * tt + g + 8 * h) * c.stride + n0 + 8 * j + 2 * t) =
              pack_sat8(round_shift(acc[tt][j][2 * h], floor, L.shift),
                        round_shift(acc[tt][j][2 * h + 1], floor, L.shift));
  } else if (KIND == kSetSum) {
    // Columns col, col + 1 summed over this lane's rows below mp (a zero
    // mask past it), the two sums packed in one word (each is at most
    // 32 * 128 in magnitude, so the halves stay apart), then across g.
    int p[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      int s0 = 0, s1 = 0;
#pragma unroll
      for (int tt = 0; tt < T; ++tt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int keep = c.r0 + 16 * tt + g + 8 * h < c.mp ? -1 : 0;
          s0 += sat8(round_shift(acc[tt][j][2 * h], floor, L.shift)) & keep;
          s1 += sat8(round_shift(acc[tt][j][2 * h + 1], floor, L.shift)) & keep;
        }
      p[j] = s0 + s1 * 65536;
    }
#pragma unroll
    for (int d = 4; d < 32; d *= 2)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        p[j] += __shfl_xor_sync(0xffffffffu, p[j], d);
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        int s0 = static_cast<int16_t>(p[j] & 0xffff);
        int s1 = (p[j] - s0) >> 16;
        if (!c.first_group) {
          s0 += c.agg[col];
          s1 += c.agg[col + 1];
        }
        c.agg[col] = s0;
        c.agg[col + 1] = s1;
      }
    }
  } else if (g == 0) {  // kToRow0, kToOut: row 0 only
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const int y0 = round_shift(acc[0][j][0], floor, L.shift);
      const int y1 = round_shift(acc[0][j][1], floor, L.shift);
      if (KIND == kToRow0) {
        *reinterpret_cast<unsigned short*>(c.dst + col) = pack_sat8(y0, y1);
      } else {
        if (col < L.n) c.out[col] = static_cast<int8_t>(sat8(y0));
        if (col + 1 < L.n) c.out[col + 1] = static_cast<int8_t>(sat8(y1));
      }
    }
  }
}

// A whole layer: passes of 4 n-tiles, then 2 and 1. (Passes of 8 were
// slower on deepsets-32 for the code and registers they add.)
template <int T, int KIND, bool FROM_X>
__device__ __forceinline__ void ds_layer(const DsCtx& c, const ChainLayer& L,
                                         const int8_t* wt, const int* bias) {
  int n0 = 0;
  for (; n0 + 32 <= L.np; n0 += 32)
    ds_pass<T, 4, KIND, FROM_X>(c, L, wt, bias, n0);
  if (n0 + 16 <= L.np) {
    ds_pass<T, 2, KIND, FROM_X>(c, L, wt, bias, n0);
    n0 += 16;
  }
  if (n0 < L.np) ds_pass<T, 1, KIND, FROM_X>(c, L, wt, bias, n0);
}

// Shared memory: the packed model as the wrapper lays it out in device
// memory (phi's and rho's weights, their biases, their layer records, each
// a multiple of 16 bytes), then per warp two activation buffers of
// kWarpTiles tiles, two staged copies of its rows of x (xraw bytes each)
// and its share of the set sum (np of phi's last layer, int32). The
// wrapper sizes it the same way.
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
deepsets_kernel(const int8_t* __restrict__ x,
                const unsigned char* __restrict__ pack,
                int8_t* __restrict__ out, const DsShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* pw = reinterpret_cast<int8_t*>(smem);
  int8_t* rw = pw + s.phi_w_bytes;
  int* pb = reinterpret_cast<int*>(rw + s.rho_w_bytes);
  int* rb = pb + s.phi_b_count;
  int* pl = rb + s.rho_b_count;
  int* rl = pl + ((s.n_phi * REPRO_LAYER_INTS + 3) & ~3);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp % kEventWarps;  // the warp's tiles of each pass
  int8_t* act = reinterpret_cast<int8_t*>(smem) + s.pack_bytes +
                warp * s.warp_bytes;
  int8_t* raw = act + 2 * kWarpTiles * kWarpRows * s.stride;
  int* agg = reinterpret_cast<int*>(raw + 2 * s.xraw);

  // Everything the warps share, one contiguous copy in one round trip of
  // cp.async (one loop, so its few parameters are read once).
  for (int i = threadIdx.x; i < s.pack_bytes / 16; i += blockDim.x)
    cp_async16(smem + 16 * i, pack + 16 * i, 16);
  // The warp's rows of pass gi, the ones below m, as the contiguous bytes
  // they are, into staging buffer gi % 2: 16-byte copies when every event
  // starts 16-byte aligned, else bytes.
  const int e =
      blockIdx.x * (blockDim.x / 32 / kEventWarps) + warp / kEventWarps;
  const int8_t* xe = x + static_cast<size_t>(e) * s.m * s.k0;
  auto first_row = [&](int gi) {
    return gi * kGroupRows + w * kWarpTiles * kWarpRows;
  };
  auto stage = [&](int gi) {
    int8_t* dst = raw + (gi & 1) * s.xraw;
    const int r0 = first_row(gi);
    const int nb = max(0, min(kWarpTiles * kWarpRows, s.m - r0)) * s.k0;
    const int8_t* src = xe + static_cast<size_t>(r0) * s.k0;
    if (s.xvec) {
      for (int i = 16 * lane; i < nb; i += 16 * 32)
        cp_async16(dst + i, src + i, min(16, nb - i));
    } else {
      for (int i = lane; i < nb; i += 32) dst[i] = src[i];
    }
  };
  if (e < s.batch) stage(0);
  cp_async_wait_all();
  __syncthreads();  // the block's one barrier
  if (e >= s.batch) return;

  const ChainLayer* lp = reinterpret_cast<const ChainLayer*>(pl);
  const ChainLayer* lr = reinterpret_cast<const ChainLayer*>(rl);
  DsCtx c;
  c.g = lane / 4;
  c.t = lane % 4;
  c.k0 = s.k0;
  c.stride = s.stride;
  c.m = s.m;
  c.mp = s.mp;
  c.agg = agg;
  c.in = act;
  c.dst = act + kWarpTiles * kWarpRows * s.stride;

  // phi over kGroupRows set rows a pass, this warp's tiles of them, and the
  // warp's share of the set sum. Each layer's record is read a layer ahead.
  const int n_groups = (s.mp + kGroupRows - 1) / kGroupRows;
  ChainLayer L = lp[0];
  for (int gi = 0; gi < n_groups; ++gi) {
    if (gi > 0) {
      cp_async_wait_all();
      __syncwarp();
    }
    if (gi + 1 < n_groups) stage(gi + 1);  // lands while this pass runs
    c.r0 = first_row(gi);
    c.xr = reinterpret_cast<const int*>(raw + (gi & 1) * s.xraw);
    c.first_group = gi == 0;
    for (int l = 0; l < s.n_phi; ++l) {
      const ChainLayer Ln = l + 1 < s.n_phi      ? lp[l + 1]
                            : gi + 1 == n_groups ? lr[0]
                                                 : lp[0];
      const int8_t* wt = pw + L.w_off;
      const int* bias = pb + L.b_off;
      if (l + 1 < s.n_phi) {
        if (l == 0)
          ds_layer<kWarpTiles, kToTiles, true>(c, L, wt, bias);
        else
          ds_layer<kWarpTiles, kToTiles, false>(c, L, wt, bias);
      } else {
        if (l == 0)
          ds_layer<kWarpTiles, kSetSum, true>(c, L, wt, bias);
        else
          ds_layer<kWarpTiles, kSetSum, false>(c, L, wt, bias);
      }
      __syncwarp();  // the layer's output is written; its input is read
      int8_t* tmp = c.in;
      c.in = c.dst;
      c.dst = tmp;
      L = Ln;
    }
  }

  // The event's warps meet once: the first adds up their shares of the set
  // sum and requantizes it by log2(mp) into row 0 of the buffer rho reads.
  const int np_h = lp[s.n_phi - 1].np;
  if (kEventWarps > 1) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / kEventWarps),
                 "r"(32 * kEventWarps)
                 : "memory");
    if (w != 0) return;
  }
  for (int col = lane; col < np_h; col += 32) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kEventWarps; ++i)
      sum += *reinterpret_cast<const int*>(
          reinterpret_cast<const int8_t*>(agg + col) + i * s.warp_bytes);
    c.in[col] = requant_sat8(sum, s.agg_shift);
  }
  __syncwarp();

  // rho on the aggregated row: row 0 of one tile (the other rows carry
  // whatever the buffer held and are never stored).
  c.out = out + static_cast<size_t>(e) * lr[s.n_rho - 1].n;
  for (int l = 0; l < s.n_rho; ++l) {
    const ChainLayer Ln = lr[l + 1 < s.n_rho ? l + 1 : l];
    const int8_t* wt = rw + L.w_off;
    const int* bias = rb + L.b_off;
    if (l + 1 < s.n_rho)
      ds_layer<1, kToRow0, false>(c, L, wt, bias);
    else
      ds_layer<1, kToOut, false>(c, L, wt, bias);
    __syncwarp();
    int8_t* tmp = c.in;
    c.in = c.dst;
    c.dst = tmp;
    L = Ln;
  }
}

// Raises `kernel`'s limit of dynamic shared memory on `device` to at least
// smem_bytes, never lowering it: every plan of the kernel on the device
// launches under the one limit, the largest any of them asked for.
cudaError_t allow_smem(const void* kernel, int smem_bytes, int device) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && attr.maxDynamicSharedSizeBytes < smem_bytes)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

// A K2 launch plan: what a launch needs that depends only on the model and
// its device, made once a model by the wrapper, which keeps w and b alive
// while the plan lives.
struct CascadePlan {
  Chain c;
  const int8_t* w;
  const int* b;
  int k0, block_rows, stride, smem_bytes;
};

// A K3 launch plan, the same for a (phi, rho) pair: every field of the
// launch's DsShape but those of x (batch, m, mp, agg_shift, xvec), and the
// events a block holds at most.
struct DeepsetsPlan {
  const unsigned char* pack;
  DsShape s;
  int events;
};

}  // namespace

// w, b, meta: the packed chain (cascade_mlp/ops.py PackedChain); smem_bytes:
// the weights, biases and each warp's two activation buffers. Writes the
// plan's handle to *plan.
extern "C" int cascade_mlp_plan_new(const void* w, const void* b,
                                    const void* meta, int k0, int block_rows,
                                    int stride, int smem_bytes, int device,
                                    void** plan) {
  if (block_rows % kWarpRows != 0 || block_rows > 4 * kWarpRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(cascade_mlp_kernel), smem_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *plan = new CascadePlan{chain_from_meta(static_cast<const int*>(meta)),
                          static_cast<const int8_t*>(w),
                          static_cast<const int*>(b), k0, block_rows, stride,
                          smem_bytes};
  return static_cast<int>(cudaSuccess);
}

extern "C" int cascade_mlp_plan_launch(const void* plan, const void* x,
                                       void* out, int rows, void* stream) {
  const CascadePlan& p = *static_cast<const CascadePlan*>(plan);
  const int xvec = p.k0 % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int grid = (rows + p.block_rows - 1) / p.block_rows;
  cascade_mlp_kernel<<<grid, 32 * (p.block_rows / kWarpRows), p.smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), p.w, p.b, p.c, static_cast<int8_t*>(out),
      rows, p.k0, p.stride, xvec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cascade_mlp_plan_free(void* plan) {
  delete static_cast<CascadePlan*>(plan);
  return static_cast<int>(cudaSuccess);
}

// pack: phi's and rho's weights, biases and layer records back to back, as
// deepsets_kernel copies them into shared memory (pack_bytes, a multiple of
// 16); phi_meta, rho_meta: the same chains as chain_from_meta reads them;
// warp_bytes: a warp's share of shared memory; events: the most a block
// holds. Writes the plan's handle to *plan.
extern "C" int deepsets_plan_new(const void* pack, int pack_bytes,
                                 const void* phi_meta, const void* rho_meta,
                                 int k0, int stride, int xraw, int warp_bytes,
                                 int events, int device, void** plan) {
  const int* pm = static_cast<const int*>(phi_meta);
  const int* rm = static_cast<const int*>(rho_meta);
  if (events < 1 || events * kEventWarps > kMaxWarps || pm[0] < 1 ||
      pm[0] > REPRO_MAX_LAYERS || rm[0] < 1 || rm[0] > REPRO_MAX_LAYERS ||
      pack_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(deepsets_kernel),
                 pack_bytes + events * kEventWarps * warp_bytes, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  DsShape s = {};
  s.k0 = k0;
  s.stride = stride;
  s.xraw = xraw;
  s.warp_bytes = warp_bytes;
  s.n_phi = pm[0];
  s.phi_w_bytes = pm[1];
  s.phi_b_count = pm[2];
  s.n_rho = rm[0];
  s.rho_w_bytes = rm[1];
  s.rho_b_count = rm[2];
  s.pack_bytes = pack_bytes;
  *plan = new DeepsetsPlan{static_cast<const unsigned char*>(pack), s, events};
  return static_cast<int>(cudaSuccess);
}

// batch >= 1 events of m >= 1 set rows each. The set is padded to mp, the
// power of two at or above m, and the set sum requantized by log2(mp).
extern "C" int deepsets_plan_launch(const void* plan, const void* x, void* out,
                                    int batch, int m, void* stream) {
  const DeepsetsPlan& p = *static_cast<const DeepsetsPlan*>(plan);
  if (batch < 1 || m < 1 || m > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  DsShape s = p.s;
  s.batch = batch;
  s.m = m;
  s.mp = 1;
  s.agg_shift = 0;
  while (s.mp < m) {
    s.mp <<= 1;
    ++s.agg_shift;
  }
  s.xvec = static_cast<long long>(m) * s.k0 % 16 == 0 &&
           reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int events = batch < p.events ? batch : p.events;
  const int grid = (batch + events - 1) / events;
  deepsets_kernel<<<grid, 32 * kEventWarps * events,
                    s.pack_bytes + events * kEventWarps * s.warp_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), p.pack, static_cast<int8_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int deepsets_plan_free(void* plan) {
  delete static_cast<DeepsetsPlan*>(plan);
  return static_cast<int>(cudaSuccess);
}
