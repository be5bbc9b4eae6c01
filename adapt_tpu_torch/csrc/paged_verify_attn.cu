// K5 and K5-split: the batched speculative VERIFY attention over a paged KV
// pool for Hopper (sm_90a), over native, int8 or packed-int4 pools (K5q).
//
// Replaces the TPU kernel adapt_tpu/ops/paged_attention.py:_verify_kernel
// (via _verify_impl), every branch: each slot b carries `chunk` verify rows
// (the last committed token, the draft's proposals and, with a tree draft,
// `tree_tail` leaf candidates) for each of its g GQA members, folded into
// q (b, kv_h, g * chunk, hd) with row = member * chunk + t. Row t attends
// the slot's pages of the shared pool (num_pages, kv_h, page, w), walked in
// the order of its page-table row table[b], up to its OWN diagonal
//   col <= index[b] + depth(t),  depth(t) = min(t, chunk - 1 - tree_tail),
// banded below by col > index[b] + depth(t) - window when window > 0; a tree
// leaf (t > chunk - 1 - tree_tail) additionally attends its own slot
// col == index[b] + t, which lies past the chain edge, and nothing of its
// siblings. `index` is a device value per slot (no host sync). A slot whose
// last chunk position is negative (index[b] + chunk - 1 < 0: an idle or
// mid-prefill row parked at the batcher's sentinel) skips every tile and
// emits zeros. The split variant cuts the slot's pages into `split` runs of
// ceil(pps / split) pages, masks the ragged last run, and emits partials
// (acc, m, l) for ops/decode_attention._combine_splits.
//
// Design. Of the two shapes at hand - K4's 64-row query tiles given a slot
// axis, or K3's (slot, kv head) block given a per-row diagonal - this is the
// second: at the widths the models verify (g * chunk = 5 .. 8 rows at GPT-2
// widths, 20 .. 32 for a GQA model) a 64-row tile would run mostly empty,
// while K3's 16-row tile fits, and the folded rows tile over the grid's
// third axis when g * chunk passes 16 (each row tile re-streams the pages;
// the rows of a tile share every staged key). The body is a copy of
// decode_tile.cuh's with the diagonal mask - the shared header stays
// untouched, so K3 == K2 bit for bit is not at stake - and it reuses that
// header's tile sizes, shared-memory plan, paged address functor and the
// cache-element policies of common.cuh. Scale order as in K2q-K4q: score =
// (q . k_int) * k_scale * sm_scale, l sums the unscaled p, the PV product
// takes p * v_scale. With split == 1 the key range, the tile order and the
// arithmetic are the unsplit kernel's, so its combined partials equal the
// unsplit output bit for bit. Any page size is served (the TPU gates
// page % 128 and, quantized, page % 1024, its pad of g * chunk to 8 rows and
// its (rows, hd)-broadcast m / l partials are not carried over).
//
// Bound. One pass reads each slot's live pages once per row tile and does
// ~4 * g * chunk * live * hd operations: bytes bound. Plain loads through
// shared memory, one block per (slot, kv head, split, row tile);
// cp.async/TMA staging is later work (PERF.md has its numbers).
#include "decode_tile.cuh"

namespace adapt {
namespace verify {

using decode::MAX_G;
using decode::NT;
using decode::TK;

// Grid (b * kv_h, split, row tiles). `gc` = g * chunk folded rows per
// (slot, kv head); this block serves rows [z * MAX_G, z * MAX_G + g_here).
template <typename T, int HD, typename KV>
__global__ void __launch_bounds__(NT)
    verify_kernel(const T* __restrict__ q, KV kv, decode::PagedAddr addr,
                  const int* __restrict__ index, T* __restrict__ out,
                  float* __restrict__ o_part, float* __restrict__ m_part,
                  float* __restrict__ l_part, int gc, int chunk, int window,
                  int tree_tail, int L, int keys_per_split, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  constexpr int NACC = MAX_G * HD / NT;
  constexpr int TPR = NT / TK;
  constexpr int CPT = HD / TPR;
  float* qs = smem;
  float* ks = qs + MAX_G * HD;
  float* vs = ks + TK * LD;
  float* ss = vs + TK * LD;
  float* ksc = ss + MAX_G * TK;
  float* vsc = ksc + TK;
  float* m_s = vsc + TK;
  float* l_s = m_s + MAX_G;
  float* a_s = l_s + MAX_G;

  const int row = blockIdx.x;  // b * kvh + kv head
  const int sp = blockIdx.y;
  const int nsplit = gridDim.y;
  const int row0 = blockIdx.z * MAX_G;
  const int g = min(MAX_G, gc - row0);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int idx = index[row / addr.kvh];
  const int nq = g * HD;
  const int chain = chunk - 1 - tree_tail;  // deepest chain row

  const T* qrow = q + ((size_t)row * gc + row0) * HD;
  for (int i = tid; i < nq; i += NT) qs[i] = to_f(qrow[i]);
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  __syncthreads();

  const int lo = sp * keys_per_split;
  const int hi = min(L, lo + keys_per_split);
  for (int k0 = lo; k0 < hi; k0 += TK) {
    // Dead tiles: wholly past the slot's last chunk position (every tile of
    // a dead row), or wholly below row 0's window.
    if (k0 > idx + chunk - 1) break;
    if (window > 0 && k0 + TK - 1 <= idx - window) continue;

    __syncthreads();  // previous tile's readers are done
    {
      const int r = tid / TPR, c0 = (tid % TPR) * CPT;
      const int gk = k0 + r;
      const bool in = gk < hi;
      const size_t vec = in ? addr(row, gk) : 0;
      kv.template stage<CPT>(in, vec, c0, ks + r * LD + c0, vs + r * LD + c0);
      if (KV::kScaled && tid % TPR == 0) {
        ksc[r] = kv.k_scale(in, vec);
        vsc[r] = kv.v_scale(in, vec);
      }
    }
    __syncthreads();

    for (int p = tid; p < g * TK; p += NT) {
      const int r = p / TK, c = p % TK;
      const int col = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qs[r * HD + d] * ks[c * LD + d];
      if (KV::kScaled) dot *= ksc[c];
      const int t = (row0 + r) % chunk;
      const int edge = idx + min(t, chain);
      bool live = col <= edge;
      if (window > 0) live = live && col > edge - window;
      if (tree_tail > 0) live = live || col == idx + t;  // a leaf's own slot
      live = live && col < hi;
      ss[p] = live ? dot * sm_scale : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < g; r += NT / 32) {
      float* srow = ss + r * TK;
      const float x0 = srow[lane], x1 = srow[lane + 32];
      float tmax = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = tid + i * NT;
      if (o < nq) {
        const int r = o / HD, d = o % HD;
        float a = acc[i] * a_s[r];
        const float* prow = ss + r * TK;
        if (KV::kScaled) {
#pragma unroll 8
          for (int c = 0; c < TK; ++c)
            a += (prow[c] * vsc[c]) * vs[c * LD + d];
        } else {
#pragma unroll 8
          for (int c = 0; c < TK; ++c) a += prow[c] * vs[c * LD + d];
        }
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  if (o_part != nullptr) {
    const size_t pbase = ((size_t)row * nsplit + sp) * gc + row0;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = tid + i * NT;
      if (o < nq) o_part[pbase * HD + o] = acc[i];
    }
    if (tid < g) {
      m_part[pbase + tid] = m_s[tid];
      l_part[pbase + tid] = l_s[tid];
    }
  } else {
    T* orow = out + ((size_t)row * gc + row0) * HD;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = tid + i * NT;
      if (o < nq) orow[o] = from_f<T>(acc[i] / fmaxf(l_s[o / HD], 1e-30f));
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* index;
  void* out;
  float* o_part;
  float* m_part;
  float* l_part;
  int b, kvh, gc, chunk, window, tree_tail, pps, page, split;
  float sm_scale;
  cudaStream_t st;
};

template <typename T, int HD>
int launch(int kvc, const Args& a) {
  return with_kv<T, HD>(kvc, a.k, a.v, a.ks, a.vs, [&](auto kv) {
    using KV = decltype(kv);
    const int bytes = decode::smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        verify_kernel<T, HD, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    const int pages_per_split = (a.pps + a.split - 1) / a.split;
    dim3 grid(a.b * a.kvh, a.split, (a.gc + MAX_G - 1) / MAX_G);
    verify_kernel<T, HD, KV><<<grid, NT, bytes, a.st>>>(
        static_cast<const T*>(a.q), kv,
        decode::PagedAddr{a.table, a.kvh, a.pps, a.page}, a.index,
        static_cast<T*>(a.out), a.o_part, a.m_part, a.l_part, a.gc, a.chunk,
        a.window, a.tree_tail, a.pps * a.page, pages_per_split * a.page,
        a.sm_scale);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int by_dim(int hd, int kvc, const Args& a) {
  if (hd == 64) return launch<T, 64>(kvc, a);
  if (hd == 128) return launch<T, 128>(kvc, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace verify
}  // namespace adapt

// o_part == nullptr writes the normalised output (K5, split must be 1);
// otherwise each (row, split, row tile) block writes its partials
// (K5-split): o_part (b * kv_h, split, gc, hd), m_part / l_part
// (b * kv_h, split, gc). `window` 0 means none. `kv` is the pool's KVCode;
// k_scale / v_scale are nullptr for a native pool.
extern "C" int paged_verify_attn(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* index, void* out, float* o_part, float* m_part, float* l_part,
    int b, int kvh, int gc, int chunk, int window, int tree_tail, int pps,
    int page, int hd, int split, int dtype, int kv, float sm_scale,
    void* stream) {
  using namespace adapt;
  if (pps < 1 || page < 1 || split < 1 || chunk < 1 || gc < 1 ||
      gc % chunk != 0 || tree_tail < 0 || tree_tail >= chunk || window < 0 ||
      (o_part == nullptr && split != 1))
    return (int)cudaErrorInvalidValue;
  const verify::Args a{q,      k_pool, v_pool,    k_scale, v_scale, table,
                       index,  out,    o_part,    m_part,  l_part,  b,
                       kvh,    gc,     chunk,     window,  tree_tail, pps,
                       page,   split,  sm_scale,
                       static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32:
      return verify::by_dim<float>(hd, kv, a);
    case kBF16:
      return verify::by_dim<__nv_bfloat16>(hd, kv, a);
    case kF16:
      return verify::by_dim<__half>(hd, kv, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
