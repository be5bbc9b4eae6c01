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
// mid-prefill row parked at the batcher's sentinel) walks no tile and
// emits zeros. The split variant cuts the slot's pages into `split` runs of
// ceil(pps / split) pages and emits partials (acc, m, l) for
// ops/decode_attention._combine_splits.
//
// Design: K3's partition (decode_cluster.cuh). A cluster of 8 blocks per
// (slot, kv head, split, row tile); 64-key tile t of the slot's live span
// (the union of its rows' masks, VerifyRows) on rank t mod 8; the span's
// keys staged by cp.async from their pages (the page table read once per
// page a tile touches), the rest zero-filled; each rank's online softmax
// over its tiles with the per-row diagonal, the leaf's own slot and the
// window band applied as a mask at the scores; the ranks combined in rank
// order in rank 0's shared memory, their slots overlaid on its staging
// once every rank has left its walk. The rows of a tile share every
// staged key.
//  - 16-bit q (every main path): the g * chunk folded rows (5-8 at GPT-2
//    widths, 20-28 for a GQA draft) are one m16 tile per block (16-row
//    tiles over the grid past 16), and each tile's products run on the
//    tensor cores (mma.sync.m16n8k16, f32 sums): warp w scores and
//    weights keys [16 w, 16 w + 16) of the tile, the four warps share each
//    row's max through shared memory, keep their own l and P V under it,
//    and are summed in warp order after the walk; p enters P V as hi + lo
//    (tc.cuh). K and V land as padded 16-bit tiles (quantized bytes and
//    scales raw, then widened: int8 / int4 values are exact in 16 bits).
//    The CUDA-core body at 8 padded rows spent ~5x K3's instructions a
//    tile and took 0.022 ms a launch where K3 takes 0.009 (PERF.md).
//    Registers set the blocks an SM holds (shared memory is ~22 KB): at
//    128 registers four, so a step's 96 clusters of 8 took two waves; Q's
//    fragments are read from shared memory each tile and the kernel is
//    held to six blocks an SM (80 registers, a few bytes spilled), which
//    measured faster than four or eight.
//  - f32 q: decode_cluster.cuh's CUDA-core body under VerifyRows, rows
//    padded to G in {4, 16}, 16-row tiles past 16.
// Scale order as in K2q-K4q: score = (q . k_int) * k_scale * sm_scale, l
// sums the unscaled p, the PV product takes p * v_scale. With split == 1
// the span, the tile -> rank map and the combine are the unsplit kernel's,
// and rank 0 writes the combined (acc, m, l) where the unsplit kernel
// writes acc / max(l, 1e-30): _combine_splits of one split divides the
// same acc by the same l, so split 1 equals the unsplit output bit for bit
// (no fast math, ops/_build.py). Any page size is served (the TPU gates
// page % 128 and, quantized, page % 1024, its pad of g * chunk to 8 rows
// and its (rows, hd)-broadcast m / l partials are not carried over).
//
// Bound. One pass reads each slot's live keys once per row tile and does
// ~4 * g * chunk * live * hd operations: bytes bound. At verify sizes the
// launch and one block's chain of dependent latencies (index, table,
// copies, barriers, two cluster barriers) set the time, as for K3
// (PERF.md has the numbers).
#include "decode_cluster.cuh"
#include "tc.cuh"

namespace adapt {
namespace verify {

namespace cg = cooperative_groups;
using cluster::C;
using cluster::TK;

constexpr int NT = 128;  // 4 warps; warp w owns keys [16 w, 16 w + 16)
constexpr int GQ = 16;   // folded rows per block: one m16 tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the tensor-core body (bytes). QS: the 16-row Q tile;
// the staging: K and V tiles of 64 keys as padded 16-bit rows (native), or
// raw rows + scales and the 16-bit tiles they are turned into (int8 /
// int4); after the walk the staging takes the warps' P V partials and
// then, for rank 0, the cluster's combine slots (C x gh x HD acc, C x GQ
// m and l; gh, the block's real rows, sizes them at launch); the two
// vector-index tables; the warps' row maxima; the block's m and l.
template <typename T, int HD, typename KV>
struct Plan {
  static constexpr int P = tc::pitch<HD>();
  static constexpr int RB = KV::kRowBytes;
  static constexpr int QS = GQ * P * 2;
  static constexpr int TILE = TK * P * 2;
  static constexpr int RAW = TK * RB + TK * 4;
  static constexpr int STG = KV::kScaled ? 2 * RAW + 2 * TILE : 2 * TILE;
  static constexpr int RED = 4 * GQ * HD * 4 + 4 * GQ * 4;
  static constexpr int FIX = STG > RED ? STG : RED;
  static constexpr int SLOTS = 2 * C * GQ * 4;  // m, l (acc: by gh)
  // Offsets past the body (whose size is set at launch).
  static constexpr int TAIL = 2 * TK * 8 + 4 * GQ * 4 + 2 * GQ * 4;
  static constexpr int body(int gh) {
    const int comb = C * gh * HD * 4 + SLOTS;
    return ((FIX > comb ? FIX : comb) + 15) / 16 * 16;
  }
};

// K5 / K5-split for 16-bit q (bf16, f16): the cluster partition of
// decode_cluster.cuh (VerifyRows' span, tile t on rank t mod C, the page
// table walked once per page a tile touches, keys outside the span
// zero-filled, ranks combined in rank order in rank 0's shared memory)
// with each tile's two products on the tensor cores.
template <typename T, int HD, typename KV>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(NT, 6)
    verify_tc_kernel(const T* __restrict__ q, KV kv,
                     const int* __restrict__ index, T* __restrict__ out,
                     float* __restrict__ o_part, float* __restrict__ m_part,
                     float* __restrict__ l_part, int kvh, int gc, int L,
                     float sm_scale, cluster::PagedWalk walk,
                     cluster::VerifyRows rows, int body) {
  using M = tc::Mma<T>;
  using Pl = Plan<T, HD, KV>;
  constexpr int P = Pl::P, RB = KV::kRowBytes, CPK = RB / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  unsigned char* stg = smem + Pl::QS;
  long long* vidx = reinterpret_cast<long long*>(stg + body);
  float* xm = reinterpret_cast<float*>(vidx + 2 * TK);  // [warp][row]
  float* m_s = xm + 4 * GQ;
  float* l_s = m_s + GQ;
  // Staging slots: 16-bit K and V tiles, and for a quantized pool the raw
  // K and V stages (values, then scales) behind them.
  T* kt = reinterpret_cast<T*>(stg);
  T* vt = kt + TK * P;
  unsigned char* kraw = stg + 2 * Pl::TILE;
  unsigned char* vraw = kraw + Pl::RAW;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;  // b * kvh + kv head
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * GQ;
  const int gh = min(GQ, gc - row0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int idx = index[row / kvh];
  const cluster::Span sp = rows.span(idx, 0, L, split, rank);
  const cluster::VerifyRows::Row rm[2] = {rows.row(row0 + g, idx),
                                          rows.row(row0 + g + 8, idx)};

  // Stage the 64 keys of vidx[] (K or V) into their slot: 16-bit values
  // straight into the padded tile, quantized bytes and scales raw.
  auto issue = [&](const long long* vx, bool v) {
    const unsigned char* base =
        static_cast<const unsigned char*>(v ? kv.v_raw() : kv.k_raw());
    unsigned char* dst = KV::kScaled ? (v ? vraw : kraw)
                                     : reinterpret_cast<unsigned char*>(
                                           v ? vt : kt);
    constexpr int DP = KV::kScaled ? RB : P * 2;
    for (int x = tid; x < TK * CPK; x += NT) {
      const long long e = vx[x / CPK];
      const bool in = e >= 0;
      tc::cp_async16(tc::smem_addr(dst + (x / CPK) * DP + (x % CPK) * 16),
                     base + (in ? e * RB + (x % CPK) * 16 : 0), in);
    }
    if constexpr (KV::kScaled) {
      for (int r = tid; r < TK; r += NT) {
        const long long e = vx[r];
        tc::cp_async4(tc::smem_addr(dst + TK * RB + r * 4),
                      (v ? kv.vs : kv.ks) + (e >= 0 ? e : 0), e >= 0);
      }
    }
    tc::cp_commit();
  };
  // A raw quantized stage -> its 16-bit tile (the values are exact).
  auto widen = [&](const unsigned char* raw, T* dst) {
    for (int x = tid; x < TK * (HD / 8); x += NT) {
      const int r = x / (HD / 8), li = x % (HD / 8);
      float e[8];
      KV::unpack8(raw + r * RB, li, e);
      uint4 u;
      u.x = M::pack(e[0], e[1]);
      u.y = M::pack(e[2], e[3]);
      u.z = M::pack(e[4], e[5]);
      u.w = M::pack(e[6], e[7]);
      *reinterpret_cast<uint4*>(dst + r * P + li * 8) = u;
    }
  };

  // Q: rows [row0, row0 + gh) of this (slot, kv head), the rest zero.
  tc::stage<T, GQ, HD, NT>(qs, q + (size_t)row * gc * HD, HD, row0,
                           row0 + gh);
  tc::cp_commit();
  if (sp.n > 0) {
    if (warp == 0) walk.tile(row, sp.t0 * TK, sp.lo, sp.hi, lane, vidx);
    if (sp.n > 1 && warp == 3)
      walk.tile(row, (sp.t0 + C) * TK, sp.lo, sp.hi, lane, vidx + TK);
    __syncthreads();
    issue(vidx, false);
    issue(vidx, true);
  } else {
    tc::cp_commit();
    tc::cp_commit();
  }
  tc::cp_wait<2>();  // Q landed; K0, V0 may be in flight
  __syncthreads();

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int kw = warp * 16;  // this warp's keys in a tile

  for (int i = 0; i < sp.n; ++i) {
    const int k0 = (sp.t0 + i * C) * TK;
    tc::cp_wait<1>();  // K_i landed; V_i may be in flight
    __syncthreads();
    if constexpr (KV::kScaled) {
      widen(kraw, kt);
      __syncthreads();
    }
    // S = Q K^T over this warp's 16 keys, two n8 fragments (Q's fragments
    // read from shared memory each tile: registers are what limit the
    // blocks an SM holds).
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], bb[4];
      tc::load_a<HD>(qa, qs, 0, kk * 16);
      tc::load_b<HD>(bb, kt, kw, kk * 16);
      M::run(s[0], qa, bb[0], bb[1]);
      M::run(s[1], qa, bb[2], bb[3]);
    }
    // (q . k_int) * k_scale * sm_scale; each row's own mask.
    const float* ksc = reinterpret_cast<const float*>(kraw + TK * RB);
    float tmx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kw + n * 8 + 2 * t + (e & 1), p = k0 + c;
        float x = s[n][e];
        if constexpr (KV::kScaled) x *= ksc[c];
        const bool ok = p >= sp.lo && p <= sp.hi && rows.live(rm[e >> 1], p);
        x = ok ? x * sm_scale : kNegInf;
        s[n][e] = x;
        tmx[e >> 1] = fmaxf(tmx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmx[r] = fmaxf(tmx[r], __shfl_xor_sync(0xffffffffu, tmx[r], 1));
      tmx[r] = fmaxf(tmx[r], __shfl_xor_sync(0xffffffffu, tmx[r], 2));
      if (t == 0) xm[warp * GQ + g + 8 * r] = tmx[r];
    }
    __syncthreads();  // row maxima out; every warp's reads of K_i done
    if (i + 1 < sp.n) {
      issue(vidx + ((i + 1) % 2) * TK, false);  // K_{i+1} into K's slot
    } else {
      tc::cp_commit();
    }
    if (i + 2 < sp.n && warp == 3)  // the walk of the tile after next
      walk.tile(row, (sp.t0 + (i + 2) * C) * TK, sp.lo, sp.hi, lane,
                vidx + (i % 2) * TK);
    // Online softmax: the tile's row max from the four warps, in order;
    // each warp keeps l and P V over its own keys, all under one m.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = g + 8 * r;
      float mx = fmaxf(m[r], xm[rr]);
#pragma unroll
      for (int w = 1; w < 4; ++w) mx = fmaxf(mx, xm[w * GQ + rr]);
      alpha[r] = exp2f((m[r] - mx) * kLog2e);
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - m[e >> 1]) * kLog2e);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    tc::cp_wait<1>();  // V_i landed; K_{i+1} may be in flight
    __syncthreads();
    if constexpr (KV::kScaled) {
      widen(vraw, vt);
      __syncthreads();
      // p * v_scale into P V; l summed the unscaled p.
      const float* vsc = reinterpret_cast<const float*>(vraw + TK * RB);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] *= vsc[kw + n * 8 + 2 * t + (e & 1)];
    }
    // O += P V over this warp's 16 keys: p as two T terms, hi + lo.
    uint32_t ph[4], pl[4];
    tc::c_to_a_split<T>(ph, pl, s[0], s[1]);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      uint32_t bb[4];
      tc::load_bt<HD>(bb, vt, kw, n * 16);
      M::run(o[2 * n], ph, bb[0], bb[1]);
      M::run(o[2 * n + 1], ph, bb[2], bb[3]);
      M::run(o[2 * n], pl, bb[0], bb[1]);
      M::run(o[2 * n + 1], pl, bb[2], bb[3]);
    }
    __syncthreads();  // every warp's reads of V_i done
    if (i + 1 < sp.n) {
      issue(vidx + ((i + 1) % 2) * TK, true);  // V_{i+1}
    } else {
      tc::cp_commit();
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // The warps' partials summed in warp order: acc, l per row; m is every
  // warp's. Then the ranks, as decode_cluster.cuh's late combine.
  __syncthreads();
  float* red = reinterpret_cast<float*>(stg);  // [warp][row][HD]
  float* redl = red + 4 * GQ * HD;             // [warp][row]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = g + 8 * r;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(red + (warp * GQ + rr) * HD + n * 8 +
                                 2 * t) = make_float2(o[n][2 * r],
                                                      o[n][2 * r + 1]);
    if (t == 0) {
      redl[warp * GQ + rr] = l[r];
      if (warp == 0) m_s[rr] = m[r];
    }
  }
  __syncthreads();
  constexpr int NO = GQ * HD / NT;
  float mine[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int x = tid + i * NT;
    float a = red[x];
#pragma unroll
    for (int w = 1; w < 4; ++w) a += red[w * GQ * HD + x];
    mine[i] = a;
  }
  if (tid < GQ) {
    float a = redl[tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) a += redl[w * GQ + tid];
    l_s[tid] = a;
  }
  cluster.sync();  // every rank's walk and partials are done
  float* o_slot = reinterpret_cast<float*>(stg);  // [rank][gh][HD]
  float* m_slot = o_slot + C * gh * HD;           // [rank][GQ]
  float* l_slot = m_slot + C * GQ;
  if (sp.n > 0) {
    float* dst = cluster.map_shared_rank(o_slot, 0) + rank * gh * HD;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int x = tid + i * NT;
      if (x < gh * HD) dst[x] = mine[i];
    }
  }
  if (tid < GQ) {
    cluster.map_shared_rank(m_slot, 0)[rank * GQ + tid] =
        sp.n > 0 ? m_s[tid] : kNegInf;
    cluster.map_shared_rank(l_slot, 0)[rank * GQ + tid] =
        sp.n > 0 ? l_s[tid] : 0.f;
  }
  cluster.sync();  // rank 0's slots are full; the other blocks may leave
  if (rank != 0) return;

  const size_t obase = ((size_t)row * gridDim.y + split) * gc + row0;
  for (int x = tid; x < gh * HD; x += NT) {
    const int r = x / HD;
    float mj[C];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      mj[j] = m_slot[j * GQ + r];
      mx = fmaxf(mx, mj[j]);
    }
    float a = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (mj[j] > kNegInf) {
        const float w = expf(mj[j] - mx);
        a += o_slot[j * gh * HD + x] * w;
        den += l_slot[j * GQ + r] * w;
      }
    }
    if (o_part != nullptr) {
      o_part[obase * HD + x] = a;
      if (x % HD == 0) {
        m_part[obase + r] = mx;
        l_part[obase + r] = den;
      }
    } else {  // one split: obase is the row's
      out[obase * HD + x] = from_f<T>(a / fmaxf(den, 1e-30f));
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

// f32 q: the CUDA-core cluster body under its verify row policy, folded
// rows padded to G in {4, 16}; past 16, row tiles of 16.
template <int HD, int G, typename KV>
int launch_f32(const Args& a, KV kv) {
  const int kps = (a.pps + a.split - 1) / a.split * a.page;
  const dim3 grid(a.b * a.kvh * C, a.split, (a.gc + G - 1) / G);
  return cluster::launch_grid<float, HD, G>(
      grid, a.q, kv, a.index, a.out, a.o_part, a.m_part, a.l_part, a.kvh,
      a.gc, a.pps * a.page, a.sm_scale,
      cluster::PagedWalk{a.table, a.kvh, a.pps, a.page},
      cluster::VerifyRows{a.chunk, a.window, a.tree_tail, kps}, a.st);
}

// 16-bit q: the tensor-core body, one block per 16 folded rows. The
// shared-memory opt-in (for the largest body) is set once per
// instantiation; `static` keeps it this library's.
template <typename T, int HD, typename KV>
static int launch_tc(const Args& a, KV kv) {
  using Pl = Plan<T, HD, KV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      verify_tc_kernel<T, HD, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Pl::QS + Pl::body(GQ) + Pl::TAIL);
  if (attr != cudaSuccess) return (int)attr;
  const int kps = (a.pps + a.split - 1) / a.split * a.page;
  const int body = Pl::body(a.gc < GQ ? a.gc : GQ);
  const dim3 grid(a.b * a.kvh * C, a.split, (a.gc + GQ - 1) / GQ);
  verify_tc_kernel<T, HD, KV><<<grid, NT, Pl::QS + body + Pl::TAIL, a.st>>>(
      static_cast<const T*>(a.q), kv, a.index, static_cast<T*>(a.out),
      a.o_part, a.m_part, a.l_part, a.kvh, a.gc, a.pps * a.page, a.sm_scale,
      cluster::PagedWalk{a.table, a.kvh, a.pps, a.page},
      cluster::VerifyRows{a.chunk, a.window, a.tree_tail, kps}, body);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_kv(int kvc, const Args& a) {
  return with_kv<T, HD>(kvc, a.k, a.v, a.ks, a.vs, [&](auto kv) {
    if constexpr (std::is_same<T, float>::value) {
      if (a.gc <= 4) return launch_f32<HD, 4>(a, kv);
      return launch_f32<HD, 16>(a, kv);
    } else {
      return launch_tc<T, HD>(a, kv);
    }
  });
}

template <typename T>
int by_dim(int hd, int kvc, const Args& a) {
  if (hd == 64) return by_kv<T, 64>(kvc, a);
  if (hd == 128) return by_kv<T, 128>(kvc, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace verify
}  // namespace adapt

// o_part == nullptr writes the normalised output (K5, split must be 1);
// otherwise each (slot, kv head, split, row tile) cluster writes its
// partials (K5-split): o_part (b * kv_h, split, gc, hd), m_part / l_part
// (b * kv_h, split, gc). `window` 0 means none. `kv` is the pool's KVCode;
// k_scale / v_scale are nullptr for a native pool. The value pools are
// 16-byte aligned (whole 16-byte chunks a vector).
extern "C" int paged_verify_attn(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* table,
    const int* index, void* out, float* o_part, float* m_part, float* l_part,
    int b, int kvh, int gc, int chunk, int window, int tree_tail, int pps,
    int page, int hd, int split, int dtype, int kv, float sm_scale,
    void* stream) {
  using namespace adapt;
  if (b < 1 || kvh < 1 || pps < 1 || page < 1 || split < 1 || chunk < 1 ||
      gc < 1 || gc % chunk != 0 || tree_tail < 0 || tree_tail >= chunk ||
      window < 0 || (o_part == nullptr && split != 1))
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
