// The decode-attention body of K2 / K2-split (dense strips, decode_attn.cu)
// and K3 / K3-split (paged pools, paged_attn.cu), native and quantized (K2q,
// K3q): one decode step spread over thread-block clusters.
//
// What it computes (the TPU kernels
// adapt_tpu/ops/decode_attention.py:_decode_kernel and
// adapt_tpu/ops/paged_attention.py:_paged_kernel; with a split axis
// _decode_split_kernel / _paged_split_kernel and _combine_splits): the
// group-folded q (b, kv_h, g, hd) attends its row's live keys
// [max(valid_from, 0), min(index, L - 1)] with an f32 online softmax; a
// quantized cache scores (q . k_int) * k_scale * sm_scale, sums l over the
// unscaled p and weights V by p * v_scale; a row with no live key (index <
// 0, or valid_from past index) writes zeros.
//
// Why a new body. One block per (b * kv_h) row walking the row's 64-key
// tiles in series left 96 blocks on 132 SMs, each waiting on one tile's
// plain loads at a time: ~5 us a tile, latency-bound far above the bytes'
// bound. Here:
//  - Cluster. C = 8 blocks per row, a thread-block cluster. Tile t (64 keys
//    from 64 t) belongs to rank t mod C: each rank runs the online softmax
//    over its own tiles, writes its (acc, m, l) into rank 0's shared memory
//    (distributed shared memory), and after one cluster barrier rank 0
//    combines them in rank order and writes the normalised output. No
//    global partials, no second launch, no atomics: a second run gives the
//    same bits. Every sum depends only on the keys' absolute positions
//    (the tile -> rank map, the lane and key-subset split inside a tile,
//    the rank order of the combine), never on b, L, the page size or the
//    pool, so K3 == K2 bit for bit whenever the live keys hold the same
//    K/V, a row gives the same bits alone and in a batch, and a strip of
//    1025 equals one of 1024 or 1031. A rank with no live tile (m = -1e30,
//    l = 0, acc = 0) is skipped by the combine: exactly the 0 it would add.
//  - Raw async staging. The live keys' bytes as the cache holds them
//    (16-bit values, int8 values, packed int4 bytes, f32 scales) go by
//    cp.async (common.cuh stage_raw) into a ring of three half-tile slots:
//    K of tile i, V of tile i, K of tile i + 1, V of tile i + 1 ... Each
//    slot is refilled as soon as it is read (K after the scores, V after
//    P V), so two half-tiles are in flight behind the one being computed,
//    and a block needs 1.5 tiles of shared memory, not 2: at hd 64 in 16
//    bits 8 blocks fit an SM, so the 96 clusters of 8 of an 8-slot GPT-2
//    step are resident at once (with two full-tile stages 6 fit an SM and
//    only 92 clusters). Keys outside the live range are zero-filled, never
//    read. Values are converted in registers at use.
//  - The address walk once per tile. A per-tile table of the 64 keys'
//    vector indices is filled by one warp a tile ahead; on a paged pool
//    the page table is read once per page the tile touches (lane j loads
//    page j, the keys take it by shuffle).
//  - Every thread busy at g = 1. q lives in registers. HD / 8 lanes share
//    one key's dot product, 8 columns each, reduced by shuffles; the P V
//    product splits the head dim into 8-column groups and the tile's keys
//    into KS subsets, summed after the last tile in subset order. Up to 4
//    folded rows share each staged K/V read; g is padded to G in {1, 4,
//    16} (padded rows are computed and never written).
// The CUDA cores, not the tensor cores: at g <= 16 the work is ~2g
// operations per byte staged, far below the card's ~295.
//
// The splits (K2-split, K3-split and their q branches; flash decoding). The
// row's 64-key tiles are cut into `split` runs of tps = ceil(ceil(L / 64) /
// split) tiles, run sp owning tiles [sp tps, (sp + 1) tps): the plain
// version's boundaries (ops/decode_attention._split_partials), set by L and
// split only. Each (row, split) is a cluster of its own over grid y, with
// the unsplit partition inside its run (tile t on rank t mod C, the ranks
// combined in rank order), so split fans a long row over split x C blocks.
// Rank 0 writes the split's (acc, m, l) to an f32 workspace and one thread
// arrives on the row's counter (fence, atomic add, fence); the cluster that
// arrives last combines every split of the row in split order with the
// reference's rescale (m* = max m_s, a_s = exp(m_s - m*), out = sum acc_s
// a_s / max(sum l_s a_s, 1e-30)), writes the output and resets the counter
// to 0, so the counters need no clearing between launches. The sums never
// depend on which cluster arrives last; a split with no live tile arrives
// too, with m = -1e30, l = 0, acc = 0, and adds exactly 0. With one split,
// a_0 = exp(0) = 1 and the division sees the unsplit kernel's acc and l:
// split 1 equals the unsplit output bit for bit (no fast math,
// ops/_build.py). A counter buffer serves one stream: the wrappers keep one
// for each (device, stream) they launch on.
//
// K5's f32 instantiations (paged_verify_attn.cu; its 16-bit ones keep
// this partition with the products on the tensor cores) run the same body
// under another row policy (`Rows`, below): each folded row attends keys
// up to its own diagonal, the folded rows tile over the grid's z axis in
// tiles of G in {4, 16}, splits over its y axis (each split a cluster
// over its key run, rank 0 writing the combined (acc, m, l) as the split's
// partials), and the combine slots live in the staging ring, filled once
// every rank has left its walk (two cluster barriers). K2 / K3's row
// policy keeps the slots of their own and the early arrive: their
// arithmetic and shared-memory plan are unchanged.
//
// Bound. One step reads the live cache once (2 * live * (value bytes +
// scale bytes) per kv head, plus q and the indices) and does ~4 g live hd
// operations: bytes bound. At decode sizes the kernel is far from it:
// the launch, one chain of dependent latencies per block (index, table,
// copies, barriers) and, at 8 blocks an SM, the instructions of the
// staging, scores and P V set its time (PERF.md has the breakdown). The
// combine costs each live rank G * HD + 2 G remote stores (a rank with no
// live tile 2 G) and one cluster barrier.
#pragma once

#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace adapt {
namespace cluster {

namespace cg = cooperative_groups;

constexpr int TK = 64;       // keys per tile, the dead-tile skip's unit
constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int C = 8;         // blocks per (b * kv_h) row: the cluster
constexpr int PS = TK + 1;   // score row pitch (floats): rows on other banks

// The live keys [lo, hi] of one row (lo >= 0; none when lo > hi), and
// which 64-key tiles rank `rank` walks: t0, t0 + C, ... (n of them).
// Depends on positions only.
struct Span {
  int lo, hi, t0, n;
  __device__ __forceinline__ Span(int lo_, int hi_, int rank) {
    lo = lo_;
    hi = hi_;
    t0 = 0;
    n = 0;
    if (lo <= hi) {
      const int tf = lo / TK, tl = hi / TK;
      t0 = tf + ((rank - tf % C) + C) % C;
      n = t0 > tl ? 0 : (tl - t0) / C + 1;
    }
  }
};

// Row policies: which keys the folded rows of one (b * kv_h) row attend.
// K2 / K3: every row attends [max(valid_from, 0), min(index, L - 1)]; a
// row with index < 0 (or valid_from past index) has none.
struct DecodeRows {
  static constexpr bool kVerify = false;
  static constexpr bool kSplit = false;
  struct Row {};
  const int* valid_from;
  __device__ __forceinline__ Span span(int idx, int bi, int L, int,
                                       int rank) const {
    return Span(max(valid_from ? valid_from[bi] : 0, 0), min(idx, L - 1),
                rank);
  }
  __device__ __forceinline__ Row row(int, int) const { return {}; }
  __device__ __forceinline__ bool live(const Row&, int) const {
    return true;
  }
};

// K2-split / K3-split: DecodeRows' keys cut to split sp's run of `kps` keys
// (a whole number of tiles), the splits combined in the launch through the
// rows' arrival counters (combine_splits). Its own policy, so the unsplit
// kernels keep their code.
struct SplitRows : DecodeRows {
  static constexpr bool kSplit = true;
  int kps;
  unsigned* counter;  // one arrival counter per row, 0 between launches
  __device__ __forceinline__ Span span(int idx, int bi, int L, int sp,
                                       int rank) const {
    const int lo = max(valid_from ? valid_from[bi] : 0, 0);
    return Span(max(lo, sp * kps), min(min(idx, L - 1), sp * kps + kps - 1),
                rank);
  }
};

// K5 / K5-split: folded row r is chunk position t = r % chunk; it attends
// p <= edge = idx + min(t, chunk - 1 - tree_tail), banded below by
// p > edge - window when window > 0, and a tree leaf also its own slot
// p == idx + t. The span is the union over rows, cut to split sp's run of
// `kps` keys; a slot with idx + chunk - 1 < 0 has none. Keys are >= 0, so
// own = -1 (no leaf) and floor = INT_MIN (no window) never match.
struct VerifyRows {
  static constexpr bool kVerify = true;
  static constexpr bool kSplit = false;
  int chunk, window, tree_tail, kps;
  __device__ __forceinline__ Span span(int idx, int, int L, int sp,
                                       int rank) const {
    const int lo = window > 0 ? max(idx - window + 1, 0) : 0;
    const int hi = min(idx + chunk - 1, L - 1);
    return Span(max(lo, sp * kps), min(hi, sp * kps + kps - 1), rank);
  }
  // Folded row r's edge, band floor and own slot (-1: none), once a block.
  struct Row {
    int edge, floor, own;
  };
  __device__ __forceinline__ Row row(int r, int idx) const {
    const int t = r % chunk;
    const int edge = idx + min(t, chunk - 1 - tree_tail);
    return {edge, window > 0 ? edge - window : INT_MIN,
            tree_tail > 0 ? idx + t : -1};
  }
  __device__ __forceinline__ bool live(const Row& w, int p) const {
    return (p <= w.edge && p > w.floor) || p == w.own;
  }
};

// Dense strips (b, kv_h, L, w): key p of row r is vector r * L + p. Called
// by one warp: vidx[r] for the tile's 64 keys, -1 outside [lo, hi].
struct DenseWalk {
  int L;
  __device__ __forceinline__ void tile(int row, int k0, int lo, int hi,
                                       int lane, long long* vidx) const {
#pragma unroll
    for (int r = lane; r < TK; r += 32) {
      const int p = k0 + r;
      vidx[r] = (p >= lo && p <= hi) ? (long long)row * L + p : -1;
    }
  }
};

// Paged pools (num_pages, kv_h, page, w) with a (b, pps) table: key p of
// row (b, h) is at offset p % page of physical page table[b, p / page]. The
// tile's live keys touch at most 64 pages; lane j loads the table entries
// of the tile's pages j and j + 32, once each, and every key takes its
// page's entry by shuffle. Any page size.
struct PagedWalk {
  const int* table;
  int kvh, pps, page;
  __device__ __forceinline__ void tile(int row, int k0, int lo, int hi,
                                       int lane, long long* vidx) const {
    const int bi = row / kvh, h = row % kvh;
    const int a = max(k0, lo), z = min(k0 + TK - 1, hi);
    const int pa = a / page, pz = z / page;
    const int* trow = table + (size_t)bi * pps;
    const int ph0 = pa + lane <= pz ? trow[pa + lane] : 0;
    const int ph1 = pa + 32 + lane <= pz ? trow[pa + 32 + lane] : 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane + 32 * half, p = k0 + r;
      const bool in = p >= a && p <= z;
      const int j = in ? p / page - pa : 0;
      const int x0 = __shfl_sync(0xffffffffu, ph0, j & 31);
      const int x1 = __shfl_sync(0xffffffffu, ph1, j & 31);
      const long long phys = j < 32 ? x0 : x1;
      vidx[r] = in ? (phys * kvh + h) * page + p % page : -1;
    }
  }
};

// Thread maps of one instantiation (G padded folded rows, head dim HD).
template <int G, int HD>
struct Map {
  static constexpr int LPK = HD / 8;      // lanes per key, 8 columns each
  static constexpr int KPP = 32 / LPK;    // keys per warp and pass
  static constexpr int RW = G < 4 ? G : 4;  // rows a thread carries
  static constexpr int NRG = G / RW;      // row groups
  static constexpr int WPG = NW / NRG;    // QK: warps per row group
  static constexpr int PASSES = TK / (WPG * KPP);
  static constexpr int KS = NT / (LPK * NRG);  // PV: key subsets
  static_assert(G % RW == 0 && NW % NRG == 0 && TK % (WPG * KPP) == 0 &&
                    NT % (LPK * NRG) == 0 && TK % KS == 0,
                "thread maps");
};

// Shared memory of one block, in bytes: the staging ring (SLOTS x [rows |
// scales] of K or V half-tiles), reused after the last tile for the P V
// partials of the KS key subsets; the two vector-index tables; the combine
// slots (C ranks x (acc, m, l), filled through distributed shared memory:
// m and l by every rank, acc by the live ones; only rank 0's are read);
// scores / probabilities; m, l and the rescale factor per row. With LATE
// (K5) the combine slots take the ring's place at offset 0 instead.
template <int G, int HD, typename KV, bool LATE = false>
struct Smem {
  static constexpr int SLOTS = 3;
  static constexpr int SB = TK * KV::kRowBytes + (KV::kScaled ? TK * 4 : 0);
  static constexpr int RING = SLOTS * SB;
  static constexpr int RED = Map<G, HD>::KS * G * HD * 4;
  static constexpr int COMB = C * G * HD * 4 + 2 * C * G * 4;
  static constexpr int R0 = RING > RED ? RING : RED;
  static constexpr int R1 = LATE && COMB > R0 ? COMB : R0;
  static constexpr int VIDX = (R1 + 15) / 16 * 16;
  static constexpr int OS = VIDX + 2 * TK * 8;  // C x G x HD acc
  static constexpr int MLS = OS + (LATE ? 0 : C * G * HD * 4);  // m, l
  static constexpr int SS = MLS + (LATE ? 0 : 2 * C * G * 4);
  static constexpr int MS = SS + G * PS * 4;
  static constexpr int BYTES = MS + 3 * G * 4;
};

// Arrival on a split counter, by one thread of a block whose partial
// stores a barrier has ordered before it: a fence (cumulative, so it
// releases those stores with the add), a relaxed atomic add, and a fence
// (so the last arriver acquires every earlier arriver's stores; a barrier
// then carries that order to the block). Returns the count before the add.
__device__ __forceinline__ unsigned arrive(unsigned* p) {
  __threadfence();
  const unsigned old = atomicAdd(p, 1u);
  __threadfence();
  return old;
}

// A strong (relaxed, GPU-scope) load of another cluster's partial, kept
// after the arrival by asm volatile + "memory" (a plain __ldcg is neither).
__device__ __forceinline__ float ld_relaxed_gpu(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];"
               : "=f"(v) : "l"(p) : "memory");
  return v;
}

// The splits' cross-split combine, by rank 0 of each (row, split) cluster
// once its split's (acc, m, l) are in o_part (rows, split, g, HD) and m_part
// / l_part (rows, split, g): a barrier, thread 0's arrival on the row's
// counter (arrive), a barrier, and if this cluster arrived last, read
// every split's partials with strong loads and combine them in split
// order. `flag` is one word of shared memory.
template <typename T, int HD>
__device__ __forceinline__ void combine_splits(
    const float* o_part, const float* m_part, const float* l_part,
    unsigned* counter, T* out, int row, int nsplit, int g, int* flag) {
  __syncthreads();  // the block's partials are stored
  if (threadIdx.x == 0)
    *flag = arrive(counter + row) == (unsigned)nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  const size_t base = (size_t)row * nsplit * g;
  for (int o = threadIdx.x; o < g * HD; o += NT) {
    const int r = o / HD;
    float mx = ld_relaxed_gpu(m_part + base + r);
    for (int s = 1; s < nsplit; ++s)
      mx = fmaxf(mx, ld_relaxed_gpu(m_part + base + (size_t)s * g + r));
    float a = 0.f, l = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t ps = base + (size_t)s * g;
      const float w = expf(ld_relaxed_gpu(m_part + ps + r) - mx);
      a += ld_relaxed_gpu(o_part + ps * HD + o) * w;
      l += ld_relaxed_gpu(l_part + ps + r) * w;
    }
    out[(size_t)row * g * HD + o] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
  if (threadIdx.x == 0) counter[row] = 0;  // every split has arrived
}

// Grid (rows * C, split, row tiles): blockIdx.x / C is the (b * kv_h)
// row, blockIdx.y the split; a verify Rows policy takes its folded rows
// [blockIdx.z * G, + G) of the row's g, K2 / K3's all g <= G rows.
// Output: `out` (normalised), or with o_part rank 0 writes the combined
// (acc, m, l) of the split: o_part (rows, split, g, HD), m_part / l_part
// (rows, split, g); K5-split leaves them to the caller, K2-split /
// K3-split combine them here (combine_splits).
template <typename T, int HD, int G, typename KV, typename Walk,
          typename Rows>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(NT)
    decode_cluster_kernel(const T* __restrict__ q, KV kv,
                          const int* __restrict__ index, T* __restrict__ out,
                          float* __restrict__ o_part,
                          float* __restrict__ m_part,
                          float* __restrict__ l_part, int kvh, int g, int L,
                          float sm_scale, Walk walk, Rows rows) {
  constexpr bool LATE = Rows::kVerify;
  using Mp = Map<G, HD>;
  using Sm = Smem<G, HD, KV, LATE>;
  constexpr int RB = KV::kRowBytes;
  constexpr int RW = Mp::RW, LPK = Mp::LPK, KS = Mp::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* vidx = reinterpret_cast<long long*>(smem + Sm::VIDX);
  float* o_slot = reinterpret_cast<float*>(smem + (LATE ? 0 : Sm::OS));
  float* m_slot = LATE ? o_slot + C * G * HD
                       : reinterpret_cast<float*>(smem + Sm::MLS);
  float* l_slot = m_slot + C * G;
  float* s_s = reinterpret_cast<float*>(smem + Sm::SS);
  float* m_s = reinterpret_cast<float*>(smem + Sm::MS);
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // First half of a split cluster barrier: its wait, before the writes into
  // rank 0's slots, guarantees every block of the cluster has started.
  if constexpr (!LATE)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int row = blockIdx.x / C;  // b * kvh + kv head
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bi = row / kvh;
  constexpr bool PARTS = LATE || Rows::kSplit;  // a split over grid y
  const int split = PARTS ? (int)blockIdx.y : 0;
  const int row0 = LATE ? (int)blockIdx.z * G : 0;  // first folded row
  const int gh = LATE ? min(G, g - row0) : g;       // folded rows here
  const int idx = index[bi];
  const Span sp = rows.span(idx, bi, L, split, rank);

  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // QK map: warp -> (row group, key slot); lane -> (key, 8 columns).
  const int li = lane % LPK, kg = lane / LPK;
  const int qrg = warp / Mp::WPG, qwk = warp % Mp::WPG;
  float qr[RW][8];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = qrg * RW + rr;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[rr][e] = r < gh ? to_f(q[((size_t)row * g + row0 + r) * HD +
                                  KV::col8(li, e)])
                         : 0.f;
  }
  // PV map: thread -> (8-column group, row group, key subset).
  const int dg = tid % LPK, prg = (tid / LPK) % Mp::NRG;
  const int ks = tid / (LPK * Mp::NRG);
  typename Rows::Row rmask[RW];  // each QK row's mask, once a block
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
    rmask[rr] = rows.row(row0 + qrg * RW + rr, idx);
  float acc[RW][8];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[rr][e] = 0.f;

  // The ring's half-tiles in issue order: K0 V0 K1 | V1 | K2 V2 | K3 V3 ...
  // (tile i's K at the top of iteration i - 1, its V after iteration
  // i - 1's scores), half-tile h in slot h % 3; every issue point commits a
  // group, empty past the last tile, so the waits count uniformly.
  auto slot = [&](int h) { return smem + (h % Sm::SLOTS) * Sm::SB; };
  auto issue = [&](int t, bool v) {  // half-tile of this rank's tile t
    if (t < sp.n) {
      const long long* vt = vidx + (t % 2) * TK;
      if (v)
        stage_raw<NT, TK, true>(kv, vt, slot(2 * t + 1));
      else
        stage_raw<NT, TK, false>(kv, vt, slot(2 * t));
    }
    cp_commit();
  };
  if (sp.n > 0) {
    if (warp == 0) walk.tile(row, sp.t0 * TK, sp.lo, sp.hi, lane, vidx);
    if (sp.n > 1 && warp == NW - 1)
      walk.tile(row, (sp.t0 + C) * TK, sp.lo, sp.hi, lane, vidx + TK);
    __syncthreads();
    issue(0, false);
    issue(0, true);
    issue(1, false);
  }
  for (int i = 0; i < sp.n; ++i) {
    const int k0 = (sp.t0 + i * C) * TK;
    const unsigned char* kst = slot(2 * i);
    const unsigned char* vst = slot(2 * i + 1);
    const float* ksc = reinterpret_cast<const float*>(kst + TK * RB);
    const float* vsc = reinterpret_cast<const float*>(vst + TK * RB);
    if (i == 0)
      cp_wait<2>();  // K0 landed; V0, K1 may be in flight
    else
      cp_wait<1>();  // K_i landed; V_i may be in flight
    __syncthreads();  // K_i visible; tile i - 1's P V is done
    if (i >= 1) issue(i + 1, false);  // into V_{i-1}'s slot

    // Scores: HD / 8 lanes per key, a shuffle tree over them.
#pragma unroll
    for (int ps = 0; ps < Mp::PASSES; ++ps) {
      const int c = (ps * Mp::WPG + qwk) * Mp::KPP + kg;
      float kx[8];
      KV::unpack8(kst + c * RB, li, kx);
      float dot[RW];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d += qr[rr][e] * kx[e];
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        dot[rr] = d;
      }
      if (li == 0) {
        const int p = k0 + c;
        const bool live = p >= sp.lo && p <= sp.hi;
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          float d = dot[rr];  // (q . k_int) * k_scale * sm_scale
          if constexpr (KV::kScaled) d *= ksc[c];
          bool ok = live;
          if constexpr (Rows::kVerify) ok = ok && rows.live(rmask[rr], p);
          s_s[(qrg * RW + rr) * PS + c] = ok ? d * sm_scale : kNegInf;
        }
      }
    }
    __syncthreads();  // scores written; K_i's slot is free
    issue(i + 1, true);  // V_{i+1} into K_i's slot

    // The walk of the tile after next, by the last warp (idle in the
    // softmax below at g < 4); its table loads overlap the softmax.
    if (i + 2 < sp.n && warp == NW - 1)
      walk.tile(row, (sp.t0 + (i + 2) * C) * TK, sp.lo, sp.hi, lane,
                vidx + (i % 2) * TK);

    // Online softmax: one warp per folded row, two keys per lane.
    for (int r = warp; r < G; r += NW) {
      float* srow = s_s + r * PS;
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
    cp_wait<2>();  // V_i landed; K_{i+1}, V_{i+1} may be in flight
    __syncthreads();

    // acc = acc * alpha + p v over this thread's keys c = ks + KS j; a
    // quantized cache weights p by the value scale here, after l summed
    // the unscaled p.
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const float al = a_s[prg * RW + rr];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[rr][e] *= al;
    }
#pragma unroll 4
    for (int j = 0; j < TK / KS; ++j) {
      const int c = ks + j * KS;
      float vx[8];
      KV::unpack8(vst + c * RB, dg, vx);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        float p = s_s[(prg * RW + rr) * PS + c];
        if constexpr (KV::kScaled) p *= vsc[c];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[rr][e] += p * vx[e];
      }
    }
  }
  __syncthreads();  // the ring is free: it takes the key subsets' partials

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int rr = 0; rr < RW; ++rr)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      red[((size_t)ks * G + prg * RW + rr) * HD + KV::col8(dg, e)] =
          acc[rr][e];
  __syncthreads();
  // This rank's (acc, m, l) into its slots in rank 0's shared memory. A
  // rank with no live tile (m = -1e30, l = 0, acc = 0) would add exactly 0
  // to every sum of the combine: it writes only its m, and the combine
  // skips it.
  if constexpr (!LATE) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (sp.n > 0) {
      float* o_dst = cluster.map_shared_rank(o_slot, 0) + rank * G * HD;
      for (int o = tid; o < G * HD; o += NT) {
        float a = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) a += red[k * G * HD + o];
        o_dst[o] = a;
      }
    }
  } else {
    // The slots overlay rank 0's ring: each rank sums its key subsets into
    // registers, and writes once every rank has left its walk.
    constexpr int NO = (G * HD + NT - 1) / NT;
    float mine[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int o = tid + i * NT;
      float a = 0.f;
      if (o < G * HD) {
#pragma unroll
        for (int k = 0; k < KS; ++k) a += red[k * G * HD + o];
      }
      mine[i] = a;
    }
    cluster.sync();  // every rank's walk and reads of its ring are done
    if (sp.n > 0) {
      float* o_dst = cluster.map_shared_rank(o_slot, 0) + rank * G * HD;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int o = tid + i * NT;
        if (o < G * HD) o_dst[o] = mine[i];
      }
    }
  }
  if (tid < G) {
    cluster.map_shared_rank(m_slot, 0)[rank * G + tid] = m_s[tid];
    cluster.map_shared_rank(l_slot, 0)[rank * G + tid] = l_s[tid];
  }
  cluster.sync();  // rank 0's slots are full; the other blocks may leave
  if (rank != 0) return;

  // Rank 0 combines the live ranks in rank order and writes the output
  // (or the split's partials).
  const size_t obase = PARTS ? ((size_t)row * gridDim.y + split) * g + row0
                             : (size_t)row * g;
  for (int o = tid; o < gh * HD; o += NT) {
    const int r = o / HD;
    float mj[C];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      mj[j] = m_slot[j * G + r];
      mx = fmaxf(mx, mj[j]);
    }
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (mj[j] > kNegInf) {
        const float w = expf(mj[j] - mx);
        a += o_slot[j * G * HD + o] * w;
        l += l_slot[j * G + r] * w;
      }
    }
    if (PARTS && o_part != nullptr) {
      o_part[obase * HD + o] = a;
      if (o % HD == 0) {
        m_part[obase + r] = mx;
        l_part[obase + r] = l;
      }
    } else {  // one split: obase is the row's
      out[obase * HD + o] = from_f<T>(a / fmaxf(l, 1e-30f));
    }
  }
  if constexpr (Rows::kSplit)
    combine_splits<T, HD>(o_part, m_part, l_part, rows.counter, out, row,
                          (int)gridDim.y, g, reinterpret_cast<int*>(a_s));
}

// One launch of `grid` blocks of NT threads (grid.x = rows * C). The
// shared-memory opt-in is set once per instantiation (a function-local
// static), not per launch; `static` keeps that flag this library's when
// another build of it is loaded into the same process.
template <typename T, int HD, int G, typename KV, typename Walk,
          typename Rows>
static int launch_grid(dim3 grid, const void* q, KV kv, const int* index,
                       void* out, float* o_part, float* m_part,
                       float* l_part, int kvh, int g, int L, float sm_scale,
                       Walk walk, Rows rows, cudaStream_t stream) {
  constexpr int bytes = Smem<G, HD, KV, Rows::kVerify>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_cluster_kernel<T, HD, G, KV, Walk, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  decode_cluster_kernel<T, HD, G, KV, Walk, Rows><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), kv, index, static_cast<T*>(out), o_part,
      m_part, l_part, kvh, g, L, sm_scale, walk, rows);
  return (int)cudaGetLastError();
}

// K2 / K3's launch arguments past q and the cache. `ws` (rows x split x g
// x (HD + 2) floats: acc, then m, then l) and `counter` (rows words, all 0)
// are the splits' workspace; nullptr for the unsplit kernel (split 1).
struct DecodeArgs {
  const int* index;
  const int* vf;
  void* out;
  float* ws;
  unsigned* counter;
  int rows, kvh, g, L, split;
  float sm_scale;
  cudaStream_t st;
};

template <typename T, int HD, int G, typename KV, typename Walk>
int launch(const void* q, KV kv, const DecodeArgs& a, Walk walk) {
  if (a.ws == nullptr)
    return launch_grid<T, HD, G>(dim3(a.rows * C), q, kv, a.index, a.out,
                                 nullptr, nullptr, nullptr, a.kvh, a.g, a.L,
                                 a.sm_scale, walk, DecodeRows{a.vf}, a.st);
  const int tps = ((a.L + TK - 1) / TK + a.split - 1) / a.split;
  float* m_part = a.ws + (size_t)a.rows * a.split * a.g * HD;
  float* l_part = m_part + (size_t)a.rows * a.split * a.g;
  SplitRows rows;
  rows.valid_from = a.vf;
  rows.kps = tps * TK;
  rows.counter = a.counter;
  return launch_grid<T, HD, G>(dim3(a.rows * C, a.split), q, kv, a.index,
                               a.out, a.ws, m_part, l_part, a.kvh, a.g, a.L,
                               a.sm_scale, walk, rows, a.st);
}

// Folded rows g padded to G in {1, 4, 16}.
template <typename T, int HD, typename KV, typename Walk>
int by_g(const void* q, KV kv, const DecodeArgs& a, Walk walk) {
  if (a.g == 1) return launch<T, HD, 1>(q, kv, a, walk);
  if (a.g <= 4) return launch<T, HD, 4>(q, kv, a, walk);
  return launch<T, HD, 16>(q, kv, a, walk);
}

template <typename T, typename Walk>
int by_dim(int hd, int kvc, const void* q, const void* k, const void* v,
           const float* ks, const float* vs, const DecodeArgs& a, Walk walk) {
  auto go = [&](auto kv) {
    return by_g<T, decltype(kv)::kHeadDim>(q, kv, a, walk);
  };
  if (hd == 64) return with_kv<T, 64>(kvc, k, v, ks, vs, go);
  if (hd == 128) return with_kv<T, 128>(kvc, k, v, ks, vs, go);
  return (int)cudaErrorInvalidValue;
}

// `dtype` is q's (and the output's) dtype code, `kvc` the cache's KVCode;
// k / v the value buffers (16-byte aligned), ks / vs the scale planes
// (nullptr for a native cache); `a.L` the key range (strip length, or pps
// * page). Any L >= 1, head dims 64 and 128, 1 <= g <= 16, split >= 1 (> 1
// only with the workspace).
template <typename Walk>
int dispatch(int dtype, int kvc, int hd, const void* q, const void* k,
             const void* v, const float* ks, const float* vs,
             const DecodeArgs& a, Walk walk) {
  if (a.g < 1 || a.g > 16 || a.rows < 1 || a.L < 1 || a.split < 1 ||
      a.split > 65535 || (a.ws == nullptr) != (a.counter == nullptr) ||
      (a.ws == nullptr && a.split != 1))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return by_dim<float>(hd, kvc, q, k, v, ks, vs, a, walk);
    case kBF16:
      return by_dim<__nv_bfloat16>(hd, kvc, q, k, v, ks, vs, a, walk);
    case kF16:
      return by_dim<__half>(hd, kvc, q, k, v, ks, vs, a, walk);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cluster
}  // namespace adapt
