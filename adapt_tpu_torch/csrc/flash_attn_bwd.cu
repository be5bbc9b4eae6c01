// K7: streaming flash-attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels adapt_tpu/ops/attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel (the two pallas_calls of _flash_bwd_impl): given q, k, v
// (b, h, s, d), the forward's out and per-row logsumexp, and the cotangent
// do, it computes dq, dk and dv in the inputs' dtype, recomputing each score
// tile against the saved lse so nothing s_q x s_k ever reaches device
// memory. Masks are those of the forward (K1): causal, a sliding window, a
// ragged s_q / s_k tail and a per-batch-row valid_from left pad (with the
// lse clamped at -1e20, so a fully padded row adds nothing to dk / dv).
//
// Design. Two passes, as in the JAX package, so that no sum crosses thread
// blocks: no atomics, and the result is the same bit for bit on every run.
//  - dQ pass: one block per (b*h, 64-row query tile), the key loop inside
//    the block (a CUDA grid has no sequential axis, as in K1). Its prologue
//    computes delta = rowsum(do * out) for the tile's rows and writes it for
//    the second pass. Per live key tile: S = q k^T and dP = do v^T, then
//    ds = p (dp - delta) sm_scale with p = exp(s - lse), then dq += ds k.
//  - dK/dV pass: one block per (b*h, 64-key tile), the query loop inside.
//    Per live query tile: S^T = k q^T and dP^T = v do^T, then p^T, ds^T,
//    dv += p^T do and dk += ds^T q.
//
// bf16 / f16 (the ViT train step's attention): 4 warps a block, each owning
// 16 rows of the block's tile (queries in the dQ pass, keys in the dK/dV
// pass). The dQ pass loads its q and do A fragments into registers once;
// the dK/dV pass reads its k and v fragments from shared memory per use,
// which with 32-query streamed tiles keeps both passes within 168
// registers at d 64: three blocks an SM, so the ViT shape's 384 blocks a
// pass run in one wave (two an SM, at 175 and 253 registers with k / v held
// and 64-query tiles, took 1.55x as long). The
// streamed tiles (k and v, or q, do, lse and delta) go through a two-stage
// cp.async ring in shared memory as 16-bit values (rows padded by 16 bytes:
// conflict-free ldmatrix), so the next tile loads while this one computes.
// All five kinds of product run on the tensor cores (mma.sync m16n8k16,
// f32 accumulation). Computing S^T and dP^T directly in the dK/dV pass makes
// p^T and ds^T, in their accumulator fragments, the A operands of dv and dk;
// in the dQ pass ds is the A operand of ds k. p and ds never go through
// shared memory: they are rounded to the input type only as operands of
// the second product. k in ds k, and q and do in the dK/dV sums, reduce
// over their tile's rows: ldmatrix.trans. Masks apply by index on the
// fragments, only on tiles a mask reaches; dead tiles are skipped with the
// JAX kernels' predicates. q, k, v, out and do are read through their batch
// / head / row strides (the transposed views of the qkv projection, no
// copy); dq, dk and dv are written contiguous. The dQ pass streams 64-key
// tiles at d 64 and 32-key tiles at d 128, to bound its accumulators.
//
// f32 keeps the CUDA-core passes below (flash_bwd_dq_kernel /
// flash_bwd_dkv_kernel, f32 tiles in shared memory, scalar FMAs): the f32
// gates (2e-4 against the plain version, 1e-3 relative L2 on a ViT step's
// gradients) rule out TF32 products, and no main path runs f32 attention.
//
// Bound. Five products of s_q x s_k x d per (b, h) (S, dP, dV, dQ, dK; two
// passes recompute S and dP, seven in all) against 8 s d 16-bit values and
// 2 s f32 of bytes: at the ViT shape (b8 h12 s197 d64) ~6 us of bytes and
// ~5.7 us of tensor-core operations, far below what the passes' per-tile
// latency (loads, two chained products, the exponentials) and 384 blocks a
// pass on 132 SMs cost (PERF.md has its numbers).
#include "tc.cuh"

namespace {

// A fully padded query row (valid_from) saved lse ~= -1e30; clamped, its
// masked scores give exp(-1e30 + 1e20) = 0 (_flash_bwd_impl :856-862).
constexpr float kLseFloor = -1e20f;

// The masks of _bwd_dq_kernel / _bwd_dkv_kernel, plus the ragged tails by
// index, for both the f32 and the 16-bit passes.
struct Masks {
  int s_q, s_k, vfrom, has_vf, causal, window;

  // The score (row, col) is live.
  __device__ __forceinline__ bool live(int row, int col) const {
    if (row >= s_q || col >= s_k) return false;
    if (has_vf && col < vfrom) return false;
    if (causal) {
      if (row < col) return false;
      if (window > 0 && !(col > row - window)) return false;
    }
    return true;
  }

  // Every score of rows [r0, r0 + nr) x cols [c0, c0 + nc) is live.
  __device__ __forceinline__ bool full(int r0, int nr, int c0,
                                       int nc) const {
    bool ok = r0 + nr <= s_q && c0 + nc <= s_k && (!has_vf || c0 >= vfrom);
    if (causal)
      ok = ok && r0 >= c0 + nc - 1 &&
           (window <= 0 || c0 > r0 + nr - 1 - window);
    return ok;
  }
};

// ---- f32: CUDA cores, contiguous operands ---------------------------------

using adapt::from_f;
using adapt::kNegInf;
using adapt::to_f;

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)
constexpr int LS = BK + 1;

template <int D>
constexpr int dq_smem_floats() {  // qs, dos, ks, vs; ds; lse, delta
  return 4 * 64 * (D + 1) + BQ * LS + 2 * BQ;
}

template <int D>
constexpr int dkv_smem_floats() {  // ks, vs, qs, dos; p, ds; lse, delta
  return 4 * 64 * (D + 1) + 2 * BQ * LS + 2 * BQ;
}

// Stage rows [r0, r0 + 64) of a (rows, D) matrix into shared memory as f32,
// zeros past `rows`.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int rows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    const int g = r0 + r;
    dst[r * LD + c] = g < rows ? to_f(src[(size_t)g * D + c]) : 0.f;
  }
}

// S = q k^T and dP = do v^T for the thread's 4 x 4 piece: query rows
// ty + 16 i, keys tx + 16 j.
template <int D>
__device__ __forceinline__ void score_tiles(const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            int ty, int tx, float s[4][4],
                                            float dp[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * LD + d];
      dov[i] = dos[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * LD + d];
      vv[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += dov[i] * vv[j];
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ out,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq,
                        const int* __restrict__ valid_from, int h, int s_q,
                        int s_k, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;
  float* lse_s = dss + BQ * LS;
  float* del_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t qbase = (size_t)bh * s_q * D;
  const size_t kbase = (size_t)bh * s_k * D;
  const int has_vf = valid_from != nullptr;
  const Masks m{s_q, s_k, has_vf ? valid_from[bh / h] : 0, has_vf, causal,
                window};

  stage<T, D>(qs, q + qbase, q0, s_q);
  stage<T, D>(dos, dout + qbase, q0, s_q);
  __syncthreads();
  // Prologue: delta = rowsum(do * out), four neighbouring lanes per row.
  {
    const int r = tid / 4;
    const int part = tid % 4;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < s_q)
      for (int c = part; c < D; c += 4)
        acc += dos[r * LD + c] * to_f(out[qbase + (size_t)row * D + c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      float l = 0.f;
      if (row < s_q) {
        l = lse[(size_t)bh * s_q + row];
        if (has_vf) l = fmaxf(l, kLseFloor);
        delta[(size_t)bh * s_q + row] = acc;
      }
      lse_s[r] = l;
      del_s[r] = acc;
    }
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int num_kv = (s_k + BK - 1) / BK;
  for (int j = 0; j < num_kv; ++j) {
    const int k0 = j * BK;
    // Dead-tile skip, the predicates of _bwd_dq_kernel (block-uniform).
    bool live = true;
    if (causal) {
      live = k0 <= q0 + BQ - 1;
      if (window > 0) live = live && (k0 + BK - 1 > q0 - window);
    }
    if (has_vf) live = live && (k0 + BK > m.vfrom);
    if (!live) continue;

    __syncthreads();  // the prologue / previous tile's readers are done
    stage<T, D>(ks, k + kbase, k0, s_k);
    stage<T, D>(vs, v + kbase, k0, s_k);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<D>(qs, dos, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float sc = m.live(q0 + r, k0 + c) ? s[i][jj] * sm_scale
                                                : kNegInf;
        const float p = expf(sc - lse_s[r]);
        dss[r * LS + c] = p * (dp[i][jj] - del_s[r]) * sm_scale;
      }
    }
    __syncthreads();

    // dq += ds k
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kv[jj] = ks[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] += dsv[i] * kv[jj];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_q) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      dq[qbase + (size_t)row * D + tx + 16 * jj] = from_f<T>(acc[i][jj]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv,
                         const int* __restrict__ valid_from, int h, int s_q,
                         int s_k, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;
  float* dss = ps + BQ * LS;
  float* lse_s = dss + BQ * LS;
  float* del_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t qbase = (size_t)bh * s_q * D;
  const size_t kbase = (size_t)bh * s_k * D;
  const size_t rbase = (size_t)bh * s_q;
  const int has_vf = valid_from != nullptr;
  const Masks m{s_q, s_k, has_vf ? valid_from[bh / h] : 0, has_vf, causal,
                window};

  stage<T, D>(ks, k + kbase, k0, s_k);
  stage<T, D>(vs, v + kbase, k0, s_k);

  // Key rows ty + 16 i, columns tx + 16 jj.
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // A key tile entirely inside the left padding gets zero gradient.
  const bool kv_live = !has_vf || (k0 + BK > m.vfrom);
  const int num_q = kv_live ? (s_q + BQ - 1) / BQ : 0;
  for (int i = 0; i < num_q; ++i) {
    const int q0 = i * BQ;
    // Dead-tile skip, the predicates of _bwd_dkv_kernel (block-uniform).
    bool live = true;
    if (causal) {
      live = q0 + BQ - 1 >= k0;  // query tiles before this key tile
      if (window > 0) live = live && (q0 < k0 + BK + window - 1);
    }
    if (!live) continue;

    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(qs, q + qbase, q0, s_q);
    stage<T, D>(dos, dout + qbase, q0, s_q);
    if (tid < BQ) {
      const int row = q0 + tid;
      float l = 0.f, dl = 0.f;
      if (row < s_q) {
        l = lse[rbase + row];
        if (has_vf) l = fmaxf(l, kLseFloor);
        dl = delta[rbase + row];
      }
      lse_s[tid] = l;
      del_s[tid] = dl;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<D>(qs, dos, ks, vs, ty, tx, s, dp);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = ty + 16 * ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const float sc = m.live(q0 + r, k0 + c) ? s[ii][jj] * sm_scale
                                                : kNegInf;
        const float p = expf(sc - lse_s[r]);
        ps[r * LS + c] = p;
        dss[r * LS + c] = p * (dp[ii][jj] - del_s[r]) * sm_scale;
      }
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        pv[ii] = ps[r * LS + ty + 16 * ii];
        dsv[ii] = dss[r * LS + ty + 16 * ii];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        dov[jj] = dos[r * LD + tx + 16 * jj];
        qv[jj] = qs[r * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          dv_acc[ii][jj] += pv[ii] * dov[jj];
          dk_acc[ii][jj] += dsv[ii] * qv[jj];
        }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int key = k0 + ty + 16 * ii;
    if (key >= s_k) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const size_t o = kbase + (size_t)key * D + tx + 16 * jj;
      dk[o] = from_f<T>(dk_acc[ii][jj]);
      dv[o] = from_f<T>(dv_acc[ii][jj]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, const int* valid_from, int b, int h, int s_q,
           int s_k, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  const int dq_bytes = dq_smem_floats<D>() * (int)sizeof(float);
  const int dkv_bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, D><<<dim3(b * h, (s_q + BQ - 1) / BQ), NT, dq_bytes,
                              stream>>>(
      qt, kt, vt, static_cast<const T*>(out), dot, lse, delta,
      static_cast<T*>(dq), valid_from, h, s_q, s_k, causal, window, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, D><<<dim3(b * h, (s_k + BK - 1) / BK), NT,
                               dkv_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      valid_from, h, s_q, s_k, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- bf16 / f16: tensor cores -------------------------------------------

namespace tcb {

using adapt::kNegInf;
using adapt::to_f;
namespace tc = adapt::tc;

constexpr int BR = 64;    // rows a block owns (16 per warp)
constexpr int NTH = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  const int* valid_from;
  long long qs[3], ks[3], vs[3], os[3], ds[3];  // batch, head, row strides
  int h, s_q, s_k, causal, window;
  float sm_scale;
};

constexpr int BQ = 32;  // queries per streamed tile of the dK/dV pass

// Keys per streamed tile of the dQ pass.
template <int D>
__host__ __device__ constexpr int dq_keys() {
  return D == 64 ? 64 : 32;
}

template <int D>
constexpr int dq_smem_bytes() {  // q, do; two k and two v stages; delta
  return (2 * BR + 4 * dq_keys<D>()) * tc::pitch<D>() * 2 + BR * 4;
}

template <int D>
constexpr int dkv_smem_bytes() {  // k, v; two q, do, lse and delta stages
  return (2 * BR + 4 * BQ) * tc::pitch<D>() * 2 + 4 * BQ * 4;
}

template <typename T>
__device__ __forceinline__ const T* head(const void* p, const long long* st,
                                         int b, int hh) {
  return static_cast<const T*>(p) + b * st[0] + hh * st[1];
}

// Both passes ask for three blocks an SM at d 64 (registers capped at 168
// a thread), so that the ViT shape's 384 blocks a pass run in one wave.
template <typename T, int D>
__global__ void __launch_bounds__(NTH, D == 64 ? 3 : 1)
    flash_bwd_dq_tc_kernel(Args a) {
  using M = tc::Mma<T>;
  constexpr int P = tc::pitch<D>();
  constexpr int BK = dq_keys<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + BR * P;
  T* ks = dos + BR * P;
  T* vs = ks + 2 * BK * P;
  float* del_s = reinterpret_cast<float*>(vs + 2 * BK * P);

  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* q = head<T>(a.q, a.qs, b, hh);
  const T* k = head<T>(a.k, a.ks, b, hh);
  const T* v = head<T>(a.v, a.vs, b, hh);
  const T* out = head<T>(a.out, a.os, b, hh);
  const T* dout = head<T>(a.dout, a.ds, b, hh);
  const int s_q = a.s_q, s_k = a.s_k;
  const bool has_vf = a.valid_from != nullptr;
  const Masks mk{s_q, s_k, has_vf ? a.valid_from[b] : 0, has_vf, a.causal,
                 a.window};

  // Dead-tile skip, the predicates of _bwd_dq_kernel (block-uniform,
  // monotone in the tile index: the live tiles are one range).
  auto live = [&](int j) {
    const int k0 = j * BK;
    bool ok = true;
    if (mk.causal) {
      ok = k0 <= q0 + BR - 1;
      if (mk.window > 0) ok = ok && (k0 + BK - 1 > q0 - mk.window);
    }
    if (has_vf) ok = ok && (k0 + BK > mk.vfrom);
    return ok;
  };
  const int num_kv = (s_k + BK - 1) / BK;
  int jlo = 0;
  while (jlo < num_kv && !live(jlo)) ++jlo;
  int jhi = num_kv - 1;
  while (jhi >= jlo && !live(jhi)) --jhi;

  tc::stage<T, BR, D, NTH>(qs, q, a.qs[2], q0, s_q);
  tc::stage<T, BR, D, NTH>(dos, dout, a.ds[2], q0, s_q);
  if (jlo <= jhi) {
    tc::stage<T, BK, D, NTH>(ks, k, a.ks[2], jlo * BK, s_k);
    tc::stage<T, BK, D, NTH>(vs, v, a.vs[2], jlo * BK, s_k);
  }
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();

  // Prologue: delta = rowsum(do * out), two neighbouring lanes per row.
  {
    const int r = threadIdx.x / 2, part = threadIdx.x % 2;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < s_q) {
      const T* orow = out + row * a.os[2];
      const T* drow = dos + r * P;
#pragma unroll 8
      for (int c = part * (D / 2); c < (part + 1) * (D / 2); ++c)
        acc += to_f(drow[c]) * to_f(orow[c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      del_s[r] = acc;
      if (row < s_q) a.delta[(size_t)bh * s_q + row] = acc;
    }
  }
  __syncthreads();

  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    tc::load_a<D>(qf[kk], qs, warp * 16, kk * 16);
    tc::load_a<D>(df[kk], dos, warp * 16, kk * 16);
  }
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float l = row < s_q ? a.lse[(size_t)bh * s_q + row] : 0.f;
    if (has_vf) l = fmaxf(l, kLseFloor);
    lse_r[r] = l;
    del_r[r] = del_s[warp * 16 + g + 8 * r];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = jlo; j <= jhi; ++j) {
    const int st = (j - jlo) & 1;
    const T* kt = ks + st * BK * P;
    const T* vt = vs + st * BK * P;
    if (j < jhi) {  // the next tile loads while this one computes
      tc::stage<T, BK, D, NTH>(ks + (st ^ 1) * BK * P, k, a.ks[2],
                               (j + 1) * BK, s_k);
      tc::stage<T, BK, D, NTH>(vs + (st ^ 1) * BK * P, v, a.vs[2],
                               (j + 1) * BK, s_k);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();

    // S = q k^T and dP = do v^T: 16 rows x BK keys a warp.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        uint32_t bb[4];
        tc::load_b<D>(bb, kt, n * 16, kk * 16);
        M::run(s[2 * n], qf[kk], bb[0], bb[1]);
        M::run(s[2 * n + 1], qf[kk], bb[2], bb[3]);
        tc::load_b<D>(bb, vt, n * 16, kk * 16);
        M::run(dp[2 * n], df[kk], bb[0], bb[1]);
        M::run(dp[2 * n + 1], df[kk], bb[2], bb[3]);
      }

    // ds = p (dp - delta) sm_scale, p = exp(s sm_scale - lse), in place.
    const int k0 = j * BK;
    const bool full = mk.full(q0, BR, k0, BK);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float sc = s[n][e] * a.sm_scale;
        if (!full && !mk.live(row0 + 8 * r, k0 + n * 8 + 2 * t + (e & 1)))
          sc = kNegInf;
        const float p = exp2f((sc - lse_r[r]) * kLog2e);
        s[n][e] = p * (dp[n][e] - del_r[r]) * a.sm_scale;
      }

    // dq += ds k: ds (rounded to T) is the A operand from registers; k
    // reduces over its rows (ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      tc::c_to_a<T>(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bb[4];
        tc::load_bt<D>(bb, kt, kk * 16, n * 16);
        M::run(acc[2 * n], da, bb[0], bb[1]);
        M::run(acc[2 * n + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it reloads
  }

  tc::store_rows<T, D>(static_cast<T*>(a.dq) + (size_t)bh * s_q * D, acc,
                       q0 + warp * 16, s_q, 1.f, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTH, D == 64 ? 3 : 1)
    flash_bwd_dkv_tc_kernel(Args a) {
  using M = tc::Mma<T>;
  constexpr int P = tc::pitch<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BR * P;
  T* qs = vs + BR * P;
  T* dos = qs + 2 * BQ * P;
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * P);
  float* del_s = lse_s + 2 * BQ;

  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const int k0 = blockIdx.y * BR;  // causal: the first key tiles are heaviest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* q = head<T>(a.q, a.qs, b, hh);
  const T* k = head<T>(a.k, a.ks, b, hh);
  const T* v = head<T>(a.v, a.vs, b, hh);
  const T* dout = head<T>(a.dout, a.ds, b, hh);
  const size_t rbase = (size_t)bh * a.s_q;
  const int s_q = a.s_q, s_k = a.s_k;
  const bool has_vf = a.valid_from != nullptr;
  const Masks mk{s_q, s_k, has_vf ? a.valid_from[b] : 0, has_vf, a.causal,
                 a.window};

  // A key tile entirely inside the left padding gets zero gradient; else
  // the dead-tile predicates of _bwd_dkv_kernel (block-uniform, monotone).
  auto live = [&](int i) {
    const int q0 = i * BQ;
    bool ok = true;
    if (mk.causal) {
      ok = q0 + BQ - 1 >= k0;
      if (mk.window > 0) ok = ok && (q0 < k0 + BR + mk.window - 1);
    }
    return ok;
  };
  const bool kv_live = !has_vf || (k0 + BR > mk.vfrom);
  const int num_q = kv_live ? (s_q + BQ - 1) / BQ : 0;
  int ilo = 0;
  while (ilo < num_q && !live(ilo)) ++ilo;
  int ihi = num_q - 1;
  while (ihi >= ilo && !live(ihi)) --ihi;

  // Stage query tile i (q, do, lse, delta) into ring slot `st`.
  auto stage_q = [&](int i, int st) {
    const int q0 = i * BQ;
    tc::stage<T, BQ, D, NTH>(qs + st * BQ * P, q, a.qs[2], q0, s_q);
    tc::stage<T, BQ, D, NTH>(dos + st * BQ * P, dout, a.ds[2], q0, s_q);
    const int x = threadIdx.x % BQ;
    const bool in = q0 + x < s_q;
    const size_t src = rbase + (in ? q0 + x : 0);
    if (threadIdx.x < BQ)
      tc::cp_async4(tc::smem_addr(lse_s + st * BQ + x), a.lse + src, in);
    else if (threadIdx.x < 2 * BQ)
      tc::cp_async4(tc::smem_addr(del_s + st * BQ + x), a.delta + src, in);
  };

  tc::stage<T, BR, D, NTH>(ks, k, a.ks[2], k0, s_k);
  tc::stage<T, BR, D, NTH>(vs, v, a.vs[2], k0, s_k);
  if (ilo <= ihi) stage_q(ilo, 0);
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();

  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = ilo; i <= ihi; ++i) {
    const int st = (i - ilo) & 1;
    const T* qt = qs + st * BQ * P;
    const T* dot = dos + st * BQ * P;
    const float* lse_t = lse_s + st * BQ;
    const float* del_t = del_s + st * BQ;
    if (i < ihi) {  // the next tile loads while this one computes
      stage_q(i + 1, st ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();

    // S^T = k q^T and dP^T = v do^T: 16 keys x BQ queries a warp.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      tc::load_a<D>(ka, ks, warp * 16, kk * 16);
      tc::load_a<D>(va, vs, warp * 16, kk * 16);
#pragma unroll
      for (int n = 0; n < BQ / 16; ++n) {
        uint32_t bb[4];
        tc::load_b<D>(bb, qt, n * 16, kk * 16);
        M::run(s[2 * n], ka, bb[0], bb[1]);
        M::run(s[2 * n + 1], ka, bb[2], bb[3]);
        tc::load_b<D>(bb, dot, n * 16, kk * 16);
        M::run(dp[2 * n], va, bb[0], bb[1]);
        M::run(dp[2 * n + 1], va, bb[2], bb[3]);
      }
    }

    // p^T and ds^T in place (rows are keys, columns queries).
    const int q0 = i * BQ;
    const bool full = mk.full(q0, BQ, k0, BR);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float sc = s[n][e] * a.sm_scale;
        if (!full && !mk.live(q0 + c, key0 + 8 * (e >> 1))) sc = kNegInf;
        float l = lse_t[c];
        if (has_vf) l = fmaxf(l, kLseFloor);
        const float p = exp2f((sc - l) * kLog2e);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - del_t[c]) * a.sm_scale;
      }

    // dv += p^T do and dk += ds^T q: p^T and ds^T (rounded to T) are the A
    // operands from registers; do and q reduce over their rows
    // (ldmatrix.trans).
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      tc::c_to_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
      tc::c_to_a<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bb[4];
        tc::load_bt<D>(bb, dot, kk * 16, n * 16);
        M::run(dv[2 * n], pa, bb[0], bb[1]);
        M::run(dv[2 * n + 1], pa, bb[2], bb[3]);
        tc::load_bt<D>(bb, qt, kk * 16, n * 16);
        M::run(dk[2 * n], da, bb[0], bb[1]);
        M::run(dk[2 * n + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it reloads
  }

  const size_t kbase = (size_t)bh * s_k * D;
  tc::store_rows<T, D>(static_cast<T*>(a.dk) + kbase, dk, k0 + warp * 16,
                       s_k, 1.f, 1.f);
  tc::store_rows<T, D>(static_cast<T*>(a.dv) + kbase, dv, k0 + warp * 16,
                       s_k, 1.f, 1.f);
}

template <typename T, int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  const int dq_bytes = dq_smem_bytes<D>();
  const int dkv_bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_tc_kernel<T, D>
      <<<dim3(b * a.h, (a.s_q + BR - 1) / BR), NTH, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_tc_kernel<T, D>
      <<<dim3(b * a.h, (a.s_k + BR - 1) / BR), NTH, dkv_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int d, const Args& a, int b, cudaStream_t stream) {
  if (d == 64) return launch<T, 64>(a, b, stream);
  if (d == 128) return launch<T, 128>(a, b, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tcb

// strides: the batch, head and row element strides of q, k, v, out and do
// (fifteen values, host memory); each operand's last dim is contiguous and
// its rows 16-byte aligned. f32 operands are contiguous and ignore them.
// dq, dk, dv (b, h, s, d) and delta (b, h, s_q) are written contiguous.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, const int* valid_from,
                              const long long* strides, int b, int h,
                              int s_q, int s_k, int d, int dtype, int causal,
                              int window, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == adapt::kF32) {
    if (d == 64)
      return launch<float, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                               valid_from, b, h, s_q, s_k, causal, window,
                               sm_scale, st);
    if (d == 128)
      return launch<float, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                valid_from, b, h, s_q, s_k, causal, window,
                                sm_scale, st);
    return (int)cudaErrorInvalidValue;
  }
  tcb::Args a{q,  k,  v,          out, dout, lse, delta, dq,
              dk, dv, valid_from, {},  {},   {},  {},    {},
              h,  s_q, s_k,       causal, window, sm_scale};
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
    a.ds[i] = strides[12 + i];
  }
  switch (dtype) {
    case adapt::kBF16:
      return tcb::by_dim<__nv_bfloat16>(d, a, b, st);
    case adapt::kF16:
      return tcb::by_dim<__half>(d, a, b, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
