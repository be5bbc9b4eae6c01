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
//  - dQ pass: one thread block per (b*h, 64-row query tile), the key loop
//    inside the block (a CUDA grid has no sequential axis, as in K1). Its
//    prologue computes delta = rowsum(do * out) for the tile's rows and
//    writes it for the second pass. Per live 64-key tile: S = q k^T and
//    dP = do v^T into registers, ds = p (dp - delta) sm_scale into shared
//    memory, dq += ds k in registers (f32).
//  - dK/dV pass: one thread block per (b*h, 64-key tile), the query loop
//    inside. Per live query tile: the same S and dP, p and ds into shared
//    memory, dv += p^T do and dk += ds^T q in registers (f32).
// Every tile is staged in shared memory as f32 with a +1 row pad
// (conflict-free column walks); 256 threads as 16 x 16, each owning a 4 x 4
// piece of a score tile and a 4 x d/16 piece of an accumulator. Ragged
// edges are masked by index: nothing is zero-padded in device memory. Tiles
// that no live score reaches are skipped with the JAX kernels' predicates.
//
// Bound. Five products of s_q x s_k x d per (b, h) (S, dP, dV, dQ, dK; this
// kernel recomputes S and dP in both passes, seven in all) against
// 8 s d + 2 s values of bytes: operations bound on paper at s >= 128. This
// first version runs the products on the CUDA cores in f32 from shared
// memory (no tensor cores): right first and slow; wgmma + TMA are later
// work (PERF.md has its numbers).
#include "common.cuh"

namespace {

using adapt::from_f;
using adapt::kNegInf;
using adapt::to_f;

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)
constexpr int LS = BK + 1;
// A fully padded query row (valid_from) saved lse ~= -1e30; clamped, its
// masked scores give exp(-1e30 + 1e20) = 0 (_flash_bwd_impl :856-862).
constexpr float kLseFloor = -1e20f;

template <int D>
constexpr int dq_smem_floats() {  // qs, dos, ks, vs; ds; lse, delta
  return 4 * 64 * (D + 1) + BQ * LS + 2 * BQ;
}

template <int D>
constexpr int dkv_smem_floats() {  // ks, vs, qs, dos; p, ds; lse, delta
  return 4 * 64 * (D + 1) + 2 * BQ * LS + 2 * BQ;
}

struct Masks {
  int s_q, s_k, vfrom, has_vf, causal, window;

  // The score (row, col) is live: the masks of _bwd_dq_kernel /
  // _bwd_dkv_kernel, plus the ragged query tail by index.
  __device__ __forceinline__ bool live(int row, int col) const {
    if (row >= s_q || col >= s_k) return false;
    if (has_vf && col < vfrom) return false;
    if (causal) {
      if (row < col) return false;
      if (window > 0 && !(col > row - window)) return false;
    }
    return true;
  }
};

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

template <typename T>
int by_dim(int d, const void* q, const void* k, const void* v,
           const void* out, const void* dout, const float* lse, float* delta,
           void* dq, void* dk, void* dv, const int* vf, int b, int h, int s_q,
           int s_k, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, vf, b, h,
                         s_q, s_k, causal, window, sm_scale, stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, vf, b,
                          h, s_q, s_k, causal, window, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, const int* valid_from,
                              int b, int h, int s_q, int s_k, int d,
                              int dtype, int causal, int window,
                              float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case adapt::kF32:
      return by_dim<float>(d, q, k, v, out, dout, lse, delta, dq, dk, dv,
                           valid_from, b, h, s_q, s_k, causal, window,
                           sm_scale, st);
    case adapt::kBF16:
      return by_dim<__nv_bfloat16>(d, q, k, v, out, dout, lse, delta, dq, dk,
                                   dv, valid_from, b, h, s_q, s_k, causal,
                                   window, sm_scale, st);
    case adapt::kF16:
      return by_dim<__half>(d, q, k, v, out, dout, lse, delta, dq, dk, dv,
                            valid_from, b, h, s_q, s_k, causal, window,
                            sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
