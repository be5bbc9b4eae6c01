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
// Design, bf16 / f16 q (every main path): K1's tensor-core body
// (flash_attn_fwd.cu, tc.cuh) with the page walk.
//  - Tiles. A block of 4 warps owns 64 folded query rows (16 a warp, Q
//    fragments in registers); S = Q K^T and O += P V run as
//    mma.sync.m16n8k16 with f32 sums; the online softmax runs on the
//    fragments; p enters P V as two 16-bit terms hi + lo (tc.cuh
//    c_to_a_split), never one rounding: one bf16 rounding of p moved the
//    prompts' K/V far enough from the f32-p passes that serve the same
//    prompts to flip greedy near-ties of native paged streams (PR 6's
//    finding, flash_attn_fwd.cu).
//  - Page walk. 64-key tiles go by cp.async, 16 bytes a copy, from each
//    key's page pages[col / page] (any page size) into a two-stage ring,
//    the next tile loading while this one computes.
//    Native K/V land as padded 16-bit tiles that ldmatrix reads; int8 /
//    int4 bytes and their f32 scales land raw and are turned into a 16-bit
//    tile in shared memory (the values are exact in bf16 and f16), so the
//    quantized branches run the same products; the key scale multiplies
//    the score column, the value scale p before its split.
//  - One walk a row, K1's. Each block walks its rows' live key tiles in
//    order with one online softmax, exactly K1's sequence of products,
//    roundings and rescales: a chunk's row equals the same row of a
//    whole-prompt K1 pass over the same K/V bit for bit, so a chunked or
//    prefix-hit admission differs from generate() only by its matmuls'
//    shapes. Spreading a row tile's key tiles over a cluster of 4 blocks
//    (rank j mod 4, ranks combined in rank order) measured 0.0166 ms
//    against this walk's 0.0248 at C = 256, pos0 = 512, but its sums in
//    another order flipped a third native paged stream at a near tie (3
//    exemptions, the cap is 2; PERF.md).
//  - Position only. Keys outside the block's live range [klo, khi] are
//    zero-filled, never read (the pow2 trash pages among them); dead tiles
//    are skipped by position; a row's tiles past its own position add
//    exact zeros (alpha 1, p 0). So a row's result depends on its own q and
//    the keys' positions only, and a second run gives the same bits.
// f32 q keeps the CUDA-core kernel below (chunk_kernel): each K/V tile
// staged as f32 with plain loads, both products as scalar FMAs; no main
// path runs f32 attention.
//
// Bound. A pass reads the live window once and does 4 * rows * live * hd
// operations: at C = 256, pos0 = 512 about 0.5 GFLOP against 1.2 MB, a
// bytes bound of ~0.9 us. The last row tiles' chain of 12 key tiles (copy,
// two products, softmax each) and the launch set the time (PERF.md has
// the numbers).
#include "tc.cuh"

// ---- f32: CUDA cores --------------------------------------------------------

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

template <int D>
int by_kv_f32(int kvc, const void* q, const void* kp, const void* vp,
              const float* ks, const float* vs, const int* pages, void* out,
              int kvh, int gc, int chunk, int n_pages, int page, int pos0,
              int window, float sm_scale, cudaStream_t stream) {
  return adapt::with_kv<float, D>(kvc, kp, vp, ks, vs, [&](auto kv) {
    return launch<float, D>(q, kv, pages, out, kvh, gc, chunk, n_pages, page,
                            pos0, window, sm_scale, stream);
  });
}

}  // namespace

// ---- bf16 / f16: tensor cores ---------------------------------------------

// Internal linkage (an unnamed namespace): the function-local static of
// launch() stays this library's even when another build of it is loaded
// into the same process (scripts/decode_ab.py loads two trees).
namespace {
namespace tck {

namespace tc = adapt::tc;
using adapt::kNegInf;

constexpr int BQ = 64;    // folded query rows per block (16 per warp)
constexpr int BK = 64;    // keys per tile
constexpr int NTH = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const int* pages;
  void* out;
  int kvh, gc, chunk, n_pages, page, pos0, window;
  float sm_scale;
};

// Shared memory of one block, in bytes: the Q tile; then the staging ring
// (native: two stages of 16-bit K and V tiles; quantized: two stages of
// raw K and V rows + scales, and one 16-bit K and V tile they are turned
// into).
template <int D, typename KV>
struct Plan {
  static constexpr int P = tc::pitch<D>();
  static constexpr int QB = BQ * P * 2;
  static constexpr int TILE = BK * P * 2;  // one 16-bit K or V tile
  static constexpr int RB = KV::kRowBytes;
  static constexpr int RAW = BK * RB + BK * 4;  // raw rows, then scales
  static constexpr int STAGES = KV::kScaled ? 4 * RAW + 2 * TILE : 4 * TILE;
  static constexpr int BYTES = QB + STAGES;
};

// Grid (kv_h, row tiles).
template <typename T, int D, typename KV>
__global__ void __launch_bounds__(NTH) chunk_tc_kernel(KV kv, Args a) {
  using M = tc::Mma<T>;
  using Pl = Plan<D, KV>;
  constexpr int P = Pl::P;
  constexpr int RB = KV::kRowBytes;
  constexpr int CPK = RB / 16;  // 16-byte chunks per cached vector
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  unsigned char* body = smem + Pl::QB;

  const int h = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int gc = a.gc, chunk = a.chunk, page = a.page, kvh = a.kvh;
  const int window = a.window;
  const int n_keys = a.n_pages * page;

  // Positions of this block's rows (r % chunk over [r0, r0 + nrows)), the
  // keys any of them attends [klo, khi], and its key tiles j0 .. j0 + nt.
  const int nrows = min(BQ, gc - r0);
  int plo = 0, phi = chunk - 1;
  if (nrows < chunk) {
    const int x = r0 % chunk, z = (r0 + nrows - 1) % chunk;
    if (x <= z) {
      plo = x;
      phi = z;
    }
  }
  plo += a.pos0;
  phi += a.pos0;
  const int khi = min(phi, n_keys - 1);
  const int klo = window > 0 ? max(plo - window + 1, 0) : 0;
  const int j0 = klo / BK, nt = klo <= khi ? khi / BK - j0 + 1 : 0;

  // Stage the block's tile i into ring stage st: each live key's bytes
  // from its page, 16 bytes a copy (and its scales); keys outside
  // [klo, khi] zero-filled.
  auto issue = [&](int i, int st) {
    const int k0 = (j0 + i) * BK;
    const unsigned char* kb = static_cast<const unsigned char*>(kv.k_raw());
    const unsigned char* vb = static_cast<const unsigned char*>(kv.v_raw());
    unsigned char* kd = body + (KV::kScaled ? 2 * st * Pl::RAW
                                            : st * Pl::TILE);
    unsigned char* vd = body + (KV::kScaled ? (2 * st + 1) * Pl::RAW
                                            : (2 + st) * Pl::TILE);
    constexpr int DP = KV::kScaled ? RB : P * 2;  // staged row pitch
    for (int x = threadIdx.x; x < BK * CPK; x += NTH) {
      const int r = x / CPK, c = x % CPK;
      const int col = k0 + r;
      const bool in = col >= klo && col <= khi;
      const long long vec =
          in ? ((long long)a.pages[col / page] * kvh + h) * page + col % page
             : 0;
      const long long off = vec * RB + c * 16;
      tc::cp_async16(tc::smem_addr(kd + r * DP + c * 16), kb + off, in);
      tc::cp_async16(tc::smem_addr(vd + r * DP + c * 16), vb + off, in);
    }
    if constexpr (KV::kScaled) {
      for (int r = threadIdx.x; r < BK; r += NTH) {
        const int col = k0 + r;
        const bool in = col >= klo && col <= khi;
        const long long vec =
            in ? ((long long)a.pages[col / page] * kvh + h) * page +
                     col % page
               : 0;
        tc::cp_async4(tc::smem_addr(kd + BK * RB + r * 4), kv.ks + vec, in);
        tc::cp_async4(tc::smem_addr(vd + BK * RB + r * 4), kv.vs + vec, in);
      }
    }
  };

  const T* qg = static_cast<const T*>(a.q) + (size_t)h * gc * D;
  tc::stage<T, BQ, D, NTH>(qs, qg, D, r0, gc);
  if (nt > 0) issue(0, 0);
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    tc::load_a<D>(qf[kk], qs, warp * 16, kk * 16);

  const int rowa = r0 + warp * 16 + g;  // this thread's rows: rowa, + 8
  const int pos[2] = {a.pos0 + rowa % chunk, a.pos0 + (rowa + 8) % chunk};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  T* k16 = reinterpret_cast<T*>(body + 4 * Pl::RAW);  // quantized only
  T* v16 = k16 + BK * P;

  for (int i = 0; i < nt; ++i) {
    const int st = i & 1;
    if (i + 1 < nt) {  // the next tile loads while this one computes
      issue(i + 1, st ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    const T* kt;
    const T* vt;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (KV::kScaled) {
      // The raw stage -> 16-bit K and V tiles (int8 / int4 values are
      // exact in bf16 and f16); the scales stay in the raw stage.
      const unsigned char* kr = body + 2 * st * Pl::RAW;
      const unsigned char* vr = kr + Pl::RAW;
      for (int x = threadIdx.x; x < BK * (D / 8); x += NTH) {
        const int r = x / (D / 8), li = x % (D / 8);
        float e[8];
        uint4 u;
        KV::unpack8(kr + r * RB, li, e);
        u.x = M::pack(e[0], e[1]);
        u.y = M::pack(e[2], e[3]);
        u.z = M::pack(e[4], e[5]);
        u.w = M::pack(e[6], e[7]);
        *reinterpret_cast<uint4*>(k16 + r * P + li * 8) = u;
        KV::unpack8(vr + r * RB, li, e);
        u.x = M::pack(e[0], e[1]);
        u.y = M::pack(e[2], e[3]);
        u.z = M::pack(e[4], e[5]);
        u.w = M::pack(e[6], e[7]);
        *reinterpret_cast<uint4*>(v16 + r * P + li * 8) = u;
      }
      __syncthreads();
      kt = k16;
      vt = v16;
      ksc = reinterpret_cast<const float*>(kr + BK * RB);
      vsc = reinterpret_cast<const float*>(vr + BK * RB);
    } else {
      kt = reinterpret_cast<const T*>(body + st * Pl::TILE);
      vt = reinterpret_cast<const T*>(body + (2 + st) * Pl::TILE);
    }

    // S = Q K^T: 16 rows x 64 keys a warp, in 8 n8 fragments.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        uint32_t bb[4];
        tc::load_b<D>(bb, kt, n * 16, kk * 16);
        M::run(s[2 * n], qf[kk], bb[0], bb[1]);
        M::run(s[2 * n + 1], qf[kk], bb[2], bb[3]);
      }

    // (q . k_int) * k_scale * sm_scale, masked by position where a mask
    // reaches this tile.
    const int k0 = (j0 + i) * BK;
    const bool full = k0 + BK - 1 <= plo && k0 + BK <= n_keys &&
                      (window <= 0 || k0 > phi - window);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float x = s[n][e];
        if constexpr (KV::kScaled) x *= ksc[c];
        x *= a.sm_scale;
        if (!full) {
          const int col = k0 + c, p = pos[e >> 1];
          const bool ok = col <= p && col < n_keys &&
                          (window <= 0 || col > p - window);
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
      }

    // Online softmax on the fragments: a row lives in one quad of lanes.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - m[e >> 1]) * kLog2e);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: p (times the value scale, after l summed the unscaled p)
    // is the A operand straight from registers, as two T terms hi + lo.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (KV::kScaled) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * kk][e] *= vsc[kk * 16 + 2 * t + (e & 1)];
          s[2 * kk + 1][e] *= vsc[kk * 16 + 8 + 2 * t + (e & 1)];
        }
      }
      uint32_t ph[4], pl[4];
      tc::c_to_a_split<T>(ph, pl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bb[4];
        tc::load_bt<D>(bb, vt, kk * 16, n * 16);
        M::run(o[2 * n], ph, bb[0], bb[1]);
        M::run(o[2 * n + 1], ph, bb[2], bb[3]);
        M::run(o[2 * n], pl, bb[0], bb[1]);
        M::run(o[2 * n + 1], pl, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it reloads
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  tc::store_rows<T, D>(static_cast<T*>(a.out) + (size_t)h * gc * D, o,
                       r0 + warp * 16, gc, 1.f / l[0], 1.f / l[1]);
}

template <typename T, int D, typename KV>
int launch(KV kv, const Args& a, cudaStream_t stream) {
  constexpr int bytes = Plan<D, KV>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      chunk_tc_kernel<T, D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(a.kvh, (a.gc + BQ - 1) / BQ);
  chunk_tc_kernel<T, D, KV><<<grid, NTH, bytes, stream>>>(kv, a);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int d, int kvc, const void* kp, const void* vp, const float* ks,
           const float* vs, const Args& a, cudaStream_t stream) {
  auto go = [&](auto kv) {
    return launch<T, decltype(kv)::kHeadDim>(kv, a, stream);
  };
  if (d == 64) return adapt::with_kv<T, 64>(kvc, kp, vp, ks, vs, go);
  if (d == 128) return adapt::with_kv<T, 128>(kvc, kp, vp, ks, vs, go);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tck
}  // namespace

// q and out (kv_h, g * chunk, hd) contiguous (batch 1); pools (num_pages,
// kv_h, page, w) with w = hd (native, int8) or hd / 2 (int4), 16-byte
// aligned; scale pools (num_pages, kv_h, page, 1) f32 or nullptr (native);
// pages (n_pages,) int32. `kv` is the pool's KVCode; window <= 0 means none.
extern "C" int paged_chunk_attn(const void* q, const void* k_pool,
                                const void* v_pool, const float* k_scale,
                                const float* v_scale, const int* pages,
                                void* out, int kvh, int gc, int chunk,
                                int n_pages, int page, int pos0, int window,
                                int hd, int dtype, int kv, float sm_scale,
                                void* stream) {
  if (gc < 1 || chunk < 1 || n_pages < 1 || page < 1 || pos0 < 0 || kvh < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  window = window > 0 ? window : 0;
  if (dtype == adapt::kF32) {
    if (hd == 64)
      return by_kv_f32<64>(kv, q, k_pool, v_pool, k_scale, v_scale, pages,
                           out, kvh, gc, chunk, n_pages, page, pos0, window,
                           sm_scale, st);
    if (hd == 128)
      return by_kv_f32<128>(kv, q, k_pool, v_pool, k_scale, v_scale, pages,
                            out, kvh, gc, chunk, n_pages, page, pos0, window,
                            sm_scale, st);
    return (int)cudaErrorInvalidValue;
  }
  const tck::Args a{q, pages, out, kvh, gc, chunk, n_pages, page, pos0,
                    window, sm_scale};
  switch (dtype) {
    case adapt::kBF16:
      return tck::by_dim<__nv_bfloat16>(hd, kv, k_pool, v_pool, k_scale,
                                        v_scale, a, st);
    case adapt::kF16:
      return tck::by_dim<__half>(hd, kv, k_pool, v_pool, k_scale, v_scale, a,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
