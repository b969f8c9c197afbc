// K5 (flash_attn): blocked attention with an online softmax, forward only.
// q (BH, S, d), k and v (BH, T, d), in f32 or bf16 (one template), with an
// optional causal mask (key t is visible to query s where t <= s); the output
// (BH, S, d) is written in q's type. Everything is computed in f32, as the
// Pallas kernel computes it: the inputs are cast up, the scores are
// dot * scale, masked entries are -1e30, the running (m, l, acc) are updated
// per key tile with expf, and the output is acc / max(l, 1e-30), rounded to
// bf16 with __float2bfloat16_rn where q is bf16. No TF32, no fast math.
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py, flash_attention
// (_flash_kernel), whose grid (BH, S/bq, T/bk) runs its kv axis in order and
// carries (m, l, acc) in VMEM scratch from one kv step to the next.
//
// What bounds it here: 4*d f32 operations for every visible (query, key)
// pair against 16*d bytes a row for q, k, v and o, so at the sequence
// lengths served (S = T in the thousands) it is bound by operations: the
// FP32 units (67 TFLOP/s) for f32, and for bf16 the tensor cores, which this
// kernel does not use.
//
// Design. Hopper's grid runs in no order, so the kv loop moves inside the
// block: one block of 256 threads per (bh, 64-query tile), with the query
// tile resident in shared memory and each 64-key tile of K and V loaded into
// shared memory as f32 in turn (dynamic shared memory, above 48 KB, so
// cudaFuncSetAttribute). A thread owns a 4x4 patch of the score tile and the
// same 4 query rows of the output, so its rows' (m, l) stay in registers and
// the row max and sum need only shuffles across the 16 threads of a row.
// Both products are register-blocked on the FP32 FMA units, reading float4
// words from shared memory with row strides chosen so that a warp hits
// distinct banks. The probabilities pass from the score product to the
// value product through shared memory, in the buffer of the K tile, which is
// dead by then. Causal key tiles wholly above the diagonal are skipped
// (exp(-1e30 - m) is exactly 0 in f32, so this changes no bit), and the
// query tiles with the most key tiles are scheduled first. The head dim is a
// template parameter, 64, 128 or 256; a narrower head is zero-padded in
// shared memory, which adds exact zeros to the scores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;      // query rows a block carries
constexpr int kBlockK = 64;      // keys in one tile of K and V
constexpr int kThreads = 256;    // 16 x 16: tx over keys / columns, ty over rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows row0 .. row0 + kRows - 1 of an (n, d) matrix into shared memory as
// f32 with row stride ld; zero for rows >= n and for columns d .. HD - 1.
template <typename T, int HD, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int n, int d) {
  for (int i = threadIdx.x; i < kRows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, g = row0 + r;
    dst[r * ld + c] =
        (g < n && c < d) ? to_f32(src[static_cast<size_t>(g) * d + c]) : 0.f;
  }
}

template <int HD>
constexpr int smem_bytes() {
  // Q tile, K tile (later the probabilities), V tile; rows of Q and K are
  // HD + 4 floats apart, 16-byte aligned and four banks apart.
  return 4 * (kBlockQ * (HD + 4) + kBlockK * (HD + 4) + kBlockK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int s_len,
                  int t_len, int d, int causal, float scale) {
  constexpr int LDQ = HD + 4;
  constexpr int LDP = kBlockK + 4;
  constexpr int NH = HD / 64;    // float4 column groups a thread owns in O
  static_assert(kBlockQ * LDP <= kBlockK * LDQ, "P must fit in the K tile");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * LDQ;
  float* vs = ks + kBlockK * LDQ;
  float* ps = ks;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qoff = static_cast<size_t>(bh) * s_len * d;
  const size_t koff = static_cast<size_t>(bh) * t_len * d;
  load_tile<T, HD, kBlockQ>(qs, LDQ, q + qoff, q0, s_len, d);

  float m[4], l[4], acc[4][NH][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][h][c] = 0.f;
  }

  int n_tiles = (t_len + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                 // the last tile's P and V are consumed
    load_tile<T, HD, kBlockK>(ks, LDQ, k + koff, k0, t_len, d);
    load_tile<T, HD, kBlockK>(vs, HD, v + koff, k0, t_len, d);
    __syncthreads();

    // Scores of rows ty*4 + i against keys tx + 16*j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LDQ + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LDQ + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }

    // Online softmax: the row's max and sum over its 16 threads.
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (kpos >= t_len || (causal && kpos > qpos)) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = corr[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();                 // every thread is done with the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * LDP + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // acc = acc * corr + P V for rows ty*4 + i, columns 64*h + 4*tx + c.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][h][c] *= corr[i];
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * LDP + j);
        pv[i][0] = p4.x;
        pv[i][1] = p4.y;
        pv[i][2] = p4.z;
        pv[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (j + jj) * HD + 64 * h + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][h][0] = fmaf(pv[i][jj], vv.x, acc[i][h][0]);
            acc[i][h][1] = fmaf(pv[i][jj], vv.y, acc[i][h][1]);
            acc[i][h][2] = fmaf(pv[i][jj], vv.z, acc[i][h][2]);
            acc[i][h][3] = fmaf(pv[i][jj], vv.w, acc[i][h][3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + qoff + static_cast<size_t>(row) * d;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * h + 4 * tx + c;
        if (col < d) store_f32(orow + col, acc[i][h][c] / den);
      }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s_len, int t_len, int d, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  const auto kernel = flash_attn_kernel<T, HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s_len + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, t_len, d, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int s_len, int t_len, int d, int causal,
                     float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, bh, s_len, t_len, d, causal, scale,
                         stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, bh, s_len, t_len, d, causal, scale,
                          stream);
  if (d <= 256)
    return launch<T, 256>(q, k, v, o, bh, s_len, t_len, d, causal, scale,
                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (bh, s, d), k and v (bh, t, d), o (bh, s, d), all contiguous, f32 or
// (bf16 != 0) bf16; 0 < d <= 256.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int bh, int s, int t, int d,
                                 int causal, float scale, int bf16,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, bh, s, t, d, causal, scale, st)
           : dispatch<float>(q, k, v, o, bh, s, t, d, causal, scale, st);
  return static_cast<int>(err);
}
