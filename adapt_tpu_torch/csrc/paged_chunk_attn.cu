// K4: chunk-query attention over a paged KV pool for Hopper (sm_90a), over
// native, int8 or packed-int4 pools (K4q).
//
// Replaces the TPU kernel adapt_tpu/ops/paged_attention.py:_chunk_kernel
// (via _chunk_impl), every branch: the query rows of one prefill CHUNK,
// positions [pos0, pos0 + C) with the GQA group folded in (row r = member *
// C + p, q of shape (1, kv_h, g * C, hd)), attend the pages listed in
// `pages` (n,) - the slot's window [0, pos0 + C), padded to a power of two
// with trash page 0 - each row up to its own position: col <= pos0 + r % C,
// and with a sliding window also col > pos0 + r % C - window. It serves the
// prefix-hit suffix pass and every chunked-prefill pass; the caller has
// already written the chunk's own K/V into its pages. A quantized pool is an
// int8 value pool (head_dim wide, or head_dim / 2 packed int4) plus an f32
// scale pool (num_pages, kv_h, page, 1) per K and V; its bytes are staged
// and unpacked in the kernel, with the scales applied as in
// _attend_tile: score = (q . k_int) * k_scale * sm_scale, and p * v_scale in
// the PV product only (the denominator sums the unscaled p).
//
// Design. A CUDA grid has no sequential axis to carry softmax state, so
// one block per (kv head, tile of 64 folded query rows) walks the window
// inside the block: each 64-key tile is staged in shared memory as f32 with
// its page looked up per key (any page size) through common.cuh's
// cache-element policy, the block computes the 64x64 score tile, four
// threads per row reduce it, (m, l) live in shared memory and the 64 x hd
// accumulator in registers - K1's structure (flash_attn_fwd.cu) with the
// page walk and the row-dependent diagonal. Dead key tiles are skipped by
// POSITION, never by page id: tiles wholly past the block's last row
// position (the pow2 trash pages among them, and the causal upper triangle)
// and, with a window, tiles wholly below the block's lowest band. pos0 and
// the page list come from the caller; nothing is gathered into a strip.
//
// Bound. A pass reads the live window once and does 4 * rows * live * hd
// operations: at C = 256 it is operations bound on paper. This first version
// computes both products on the CUDA cores in f32 from shared memory (no
// tensor cores); wgmma + TMA are later work (PERF.md has its numbers).
#include "common.cuh"

namespace {

using adapt::from_f;
using adapt::kNegInf;
using adapt::to_f;

constexpr int BQ = 64;   // folded query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BK + 3 * BQ;
}

template <typename T, int D, typename KV>
__global__ void __launch_bounds__(NT)
    chunk_kernel(const T* __restrict__ q, KV kv, const int* __restrict__ pages,
                 T* __restrict__ out, int kvh, int gc, int chunk, int n_pages,
                 int page, int pos0, int window, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int LS = BK + 1;
  constexpr int DJ = D / 16;
  constexpr int TPR = NT / BK;  // staging threads per key row
  constexpr int CPT = D / TPR;  // columns each of them stages
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ss = vs + BK * LD;
  float* ksc = ss + BQ * LS;  // BK key scales (quantized pools)
  float* vsc = ksc + BK;       // BK value scales
  float* m_s = vsc + BK;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int h = blockIdx.x;
  const int r0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t qbase = (size_t)h * gc * D;
  const int n_keys = n_pages * page;

  // Position range of this block's rows (r % chunk over [r0, r0 + nrows)).
  const int nrows = min(BQ, gc - r0);
  int lo = 0, hi = chunk - 1;
  if (nrows < chunk) {
    const int a = r0 % chunk, z = (r0 + nrows - 1) % chunk;
    if (a <= z) {
      lo = a;
      hi = z;
    }
  }
  const int p_lo = pos0 + lo, p_hi = pos0 + hi;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int gr = r0 + r;
    qs[r * LD + c] = gr < gc ? to_f(q[qbase + (size_t)gr * D + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int num_kv = (n_keys + BK - 1) / BK;
  for (int j = 0; j < num_kv; ++j) {
    const int k0 = j * BK;
    // Dead tiles (block-uniform): past every row's position - the causal
    // triangle and the pow2 trash pages - or, under a window, wholly below
    // every row's band.
    if (k0 > p_hi) break;
    if (window > 0 && k0 + BK - 1 <= p_lo - window) continue;

    __syncthreads();  // the previous tile's readers are done with ks/vs/ss
    {
      // NT / BK threads stage each key row, each CPT contiguous columns:
      // one page lookup per thread per tile, in registers before any load.
      const int r = tid / TPR, c0 = (tid % TPR) * CPT;
      const int col = k0 + r;
      const bool in = col < n_keys;
      const size_t vec =
          in ? ((size_t)pages[col / page] * kvh + h) * page + col % page : 0;
      kv.template stage<CPT>(in, vec, c0, ks + r * LD + c0, vs + r * LD + c0);
      if (KV::kScaled && tid % TPR == 0) {
        ksc[r] = kv.k_scale(in, vec);
        vsc[r] = kv.v_scale(in, vec);
      }
    }
    __syncthreads();

    // Scores: thread (ty, tx) owns rows ty + 16 i and keys tx + 16 jj.
    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) dot[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kk[jj] = ks[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dot[i][jj] += qv[i] * kk[jj];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int pos = pos0 + (r0 + r) % chunk;  // this row's position
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const int col = k0 + c;
        bool live = col <= pos && col < n_keys;
        if (window > 0) live = live && col > pos - window;
        // (q . k_int) * k_scale * sm_scale for a quantized pool.
        const float sdot = KV::kScaled ? dot[i][jj] * ksc[c] : dot[i][jj];
        ss[r * LS + c] = live ? sdot * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: four neighbouring lanes per row, 16 keys each.
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float* srow = ss + r * LS + part * 16;
      float tmax = srow[0];
#pragma unroll
      for (int c = 1; c < 16; ++c) tmax = fmaxf(tmax, srow[c]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v; a quantized pool weights p by the value
    // scale here, after l summed the unscaled p.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
      const float vscale = KV::kScaled ? vsc[c] : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = KV::kScaled ? ss[(ty + 16 * i) * LS + c] * vscale
                            : ss[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = vs[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] += pv[i] * vv[jj];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = r0 + r;
    if (row >= gc) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      out[qbase + (size_t)row * D + tx + 16 * jj] = from_f<T>(acc[i][jj] / l);
  }
}

template <typename T, int D, typename KV>
int launch(const void* q, KV kv, const int* pages, void* out, int kvh,
           int gc, int chunk, int n_pages, int page, int pos0, int window,
           float sm_scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kernel<T, D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kvh, (gc + BQ - 1) / BQ);
  chunk_kernel<T, D, KV><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), kv, pages, static_cast<T*>(out), kvh, gc,
      chunk, n_pages, page, pos0, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_kv(int kvc, const void* q, const void* kp, const void* vp,
          const float* ks, const float* vs, const int* pages, void* out,
          int kvh, int gc, int chunk, int n_pages, int page, int pos0,
          int window, float sm_scale, cudaStream_t stream) {
  return adapt::with_kv<T, D>(kvc, kp, vp, ks, vs, [&](auto kv) {
    return launch<T, D>(q, kv, pages, out, kvh, gc, chunk, n_pages, page,
                        pos0, window, sm_scale, stream);
  });
}

template <typename T>
int by_dim(int d, int kvc, const void* q, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* pages, void* out,
           int kvh, int gc, int chunk, int n_pages, int page, int pos0,
           int window, float sm_scale, cudaStream_t stream) {
  if (d == 64)
    return by_kv<T, 64>(kvc, q, kp, vp, ks, vs, pages, out, kvh, gc, chunk,
                        n_pages, page, pos0, window, sm_scale, stream);
  if (d == 128)
    return by_kv<T, 128>(kvc, q, kp, vp, ks, vs, pages, out, kvh, gc, chunk,
                         n_pages, page, pos0, window, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q and out (kv_h, g * chunk, hd) contiguous (batch 1); pools (num_pages,
// kv_h, page, w) with w = hd (native, int8) or hd / 2 (int4); scale pools
// (num_pages, kv_h, page, 1) f32 or nullptr (native); pages (n_pages,)
// int32. `kv` is the pool's KVCode; window <= 0 means none.
extern "C" int paged_chunk_attn(const void* q, const void* k_pool,
                                const void* v_pool, const float* k_scale,
                                const float* v_scale, const int* pages,
                                void* out, int kvh, int gc, int chunk,
                                int n_pages, int page, int pos0, int window,
                                int hd, int dtype, int kv, float sm_scale,
                                void* stream) {
  if (gc < 1 || chunk < 1 || n_pages < 1 || page < 1 || pos0 < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case adapt::kF32:
      return by_dim<float>(hd, kv, q, k_pool, v_pool, k_scale, v_scale, pages,
                           out, kvh, gc, chunk, n_pages, page, pos0, window,
                           sm_scale, st);
    case adapt::kBF16:
      return by_dim<__nv_bfloat16>(hd, kv, q, k_pool, v_pool, k_scale,
                                   v_scale, pages, out, kvh, gc, chunk,
                                   n_pages, page, pos0, window, sm_scale, st);
    case adapt::kF16:
      return by_dim<__half>(hd, kv, q, k_pool, v_pool, k_scale, v_scale,
                            pages, out, kvh, gc, chunk, n_pages, page, pos0,
                            window, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
