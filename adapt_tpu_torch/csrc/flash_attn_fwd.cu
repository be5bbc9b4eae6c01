// K1: forward flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel adapt_tpu/ops/attention.py:_attn_kernel (reached
// through _flash_impl): softmax(q k^T * sm_scale) v over (b, h, s, d)
// tensors with an f32 online softmax, the masks of that kernel (causal with
// a traced diagonal shift, a sliding window, a ragged key tail valid_k = s_k
// and a per-batch-row valid_from left-pad mask), skipping of dead key tiles,
// and a per-row logsumexp output.
//
// Design, bf16 / f16 (every main path: LM prefill, the ViT train step).
// One block of 4 warps per (b*h, 64-row query tile), the key loop inside the
// block (a CUDA grid has no sequential axis to carry softmax state across).
// Each warp owns 16 query rows: their Q fragments are loaded into registers
// once. 64-key K/V tiles stream through a two-stage cp.async ring in shared
// memory as 16-bit values (rows padded by 16 bytes: conflict-free ldmatrix),
// so the next tile loads while this one computes. S = Q K^T runs on the
// tensor cores (mma.sync m16n8k16, f32 accumulation); the online softmax
// runs on S's accumulator fragments in registers, with quad shuffles for
// the row max, and no shared memory or barrier between the two products;
// p enters P V (V through ldmatrix.trans) as the A operand straight from
// S's fragments, split into two input-type terms, hi = T(p) and lo =
// T(p - hi), both multiplied against the same V fragments, while l sums the
// f32 p. One bf16 rounding of p (8 bits) moved each prompt's K/V far enough
// from the f32-p arithmetic of the kernels that serve the same prompts by
// other paths (K4's chunked and prefix-hit passes) to flip greedy near-ties
// in the paged batcher; hi + lo carries ~16 bits, for one more mma per P V
// product. Masks are applied by index on
// the fragments, and only on tiles that a mask reaches. q, k and v are read
// through their batch / head / row strides (the transposed views of the
// qkv projection, no copy); out and lse are contiguous. Query tiles launch
// heaviest first (the causal diagonal's last tiles lead the grid).
//
// Row invariance (the batcher's token equality rests on it): a row's out
// and lse depend only on its own q row and the keys, in a fixed tile order,
// never on b, on s_q or on extra key tiles that the row's mask removes
// (their p is exactly 0, their V rows add exact zeros).
//
// f32 keeps the CUDA-core kernel below (flash_fwd_kernel): each K/V tile
// staged as f32, both products as scalar FMAs. Its gate (2e-5 against the
// plain version) rules out TF32 products; no main path runs f32 attention.
//
// Bound. At the prefill shapes of the main path (s <= 1024, d = 64) the
// work is 4 s_q s_k d operations per (b, h) (halved under causal) against
// 4 s d 16-bit values of q/k/v/out: some 3 us of bytes at the ViT shape,
// below the bf16 tensor-core rate's time only for s >~ 600. At these sizes
// the tiles' latency (load, two products, softmax, per 64-key tile) and
// the grid's 96-384 blocks on 132 SMs set the time, not either roof
// (PERF.md has its numbers).
#include "tc.cuh"

// ---- f32: CUDA cores, contiguous operands ---------------------------------

namespace {

using adapt::from_f;
using adapt::kNegInf;
using adapt::to_f;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse,
                     const int* __restrict__ valid_from,
                     const int* __restrict__ shift_ptr, int h, int s_q,
                     int s_k, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;  // +1 pad: conflict-free column walks
  constexpr int LS = BK + 1;
  constexpr int DJ = D / 16;
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ss = vs + BK * LD;
  float* m_s = ss + BQ * LS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t qbase = (size_t)bh * s_q * D;
  const size_t kbase = (size_t)bh * s_k * D;
  const int vfrom = valid_from ? valid_from[bh / h] : 0;
  const int shift = shift_ptr ? *shift_ptr : 0;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int gr = q0 + r;
    qs[r * LD + c] = gr < s_q ? to_f(q[qbase + (size_t)gr * D + c]) : 0.f;
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

  const int num_kv = (s_k + BK - 1) / BK;
  for (int j = 0; j < num_kv; ++j) {
    const int k0 = j * BK;
    // Dead-tile skip, the same predicates as _attn_kernel (block-uniform).
    bool live = true;
    if (causal) {
      live = k0 + shift <= q0 + BQ - 1;
      if (window > 0) live = live && (k0 + BK - 1 > q0 - window);
    }
    if (valid_from) live = live && (k0 + BK > vfrom);
    if (!live) continue;

    __syncthreads();  // the previous tile's readers are done with ks/vs/ss
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int gk = k0 + r;
      const bool in = gk < s_k;
      ks[r * LD + c] = in ? to_f(k[kbase + (size_t)gk * D + c]) : 0.f;
      vs[r * LD + c] = in ? to_f(v[kbase + (size_t)gk * D + c]) : 0.f;
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
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = ks[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dot[i][jj] += qv[i] * kv[jj];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const int col = k0 + c;
        float s = dot[i][jj] * sm_scale;
        if (col >= s_k) s = kNegInf;
        if (valid_from && col < vfrom) s = kNegInf;
        if (causal) {
          if (!(row >= col + shift)) s = kNegInf;
          if (window > 0 && !(col > row - window)) s = kNegInf;
        }
        ss[r * LS + c] = s;
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

    // acc = acc * alpha + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty + 16 * i) * LS + c];
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
    const int row = q0 + r;
    if (row >= s_q) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      out[qbase + (size_t)row * D + tx + 16 * jj] = from_f<T>(acc[i][jj] / l);
  }
  if (lse != nullptr && tid < BQ && q0 + tid < s_q)
    lse[(size_t)bh * s_q + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const int* valid_from, const int* shift, int b, int h, int s_q,
           int s_k, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * h, (s_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, valid_from, shift,
      h, s_q, s_k, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- bf16 / f16: tensor cores -------------------------------------------

namespace tcf {

using adapt::kNegInf;
namespace tc = adapt::tc;

constexpr int BQ = 64;    // query rows per block (16 per warp)
constexpr int BK = 64;    // keys per tile
constexpr int NTH = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const int* valid_from;
  const int* shift;
  long long qs[3], ks[3], vs[3];  // batch, head, row strides (elements)
  int h, s_q, s_k, causal, window;
  float sm_scale;
};

template <int D>
constexpr int smem_bytes() {  // Q tile + two K and two V stages
  return (BQ + 4 * BK) * tc::pitch<D>() * 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTH) flash_fwd_tc_kernel(Args a) {
  using M = tc::Mma<T>;
  constexpr int P = tc::pitch<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BQ * P;
  T* vs = ks + 2 * BK * P;

  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + hh * a.qs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hh * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hh * a.vs[1];
  const int s_q = a.s_q, s_k = a.s_k, causal = a.causal, window = a.window;
  const bool has_vf = a.valid_from != nullptr;
  const int vfrom = has_vf ? a.valid_from[b] : 0;
  const int shift = a.shift ? *a.shift : 0;

  // Dead-tile skip, the predicates of _attn_kernel (block-uniform). Each is
  // monotone in the tile index, so the live tiles are one range.
  auto live = [&](int j) {
    const int k0 = j * BK;
    bool ok = true;
    if (causal) {
      ok = k0 + shift <= q0 + BQ - 1;
      if (window > 0) ok = ok && (k0 + BK - 1 > q0 - window);
    }
    if (has_vf) ok = ok && (k0 + BK > vfrom);
    return ok;
  };
  const int num_kv = (s_k + BK - 1) / BK;
  int jlo = 0;
  while (jlo < num_kv && !live(jlo)) ++jlo;
  int jhi = num_kv - 1;
  while (jhi >= jlo && !live(jhi)) --jhi;

  tc::stage<T, BQ, D, NTH>(qs, q, a.qs[2], q0, s_q);
  if (jlo <= jhi) {
    tc::stage<T, BK, D, NTH>(ks, k, a.ks[2], jlo * BK, s_k);
    tc::stage<T, BK, D, NTH>(vs, v, a.vs[2], jlo * BK, s_k);
  }
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    tc::load_a<D>(qf[kk], qs, warp * 16, kk * 16);

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

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

    // S = Q K^T: 16 rows x 64 keys a warp, in 8 n8 fragments.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        uint32_t bb[4];
        tc::load_b<D>(bb, kt, n * 16, kk * 16);
        M::run(s[2 * n], qf[kk], bb[0], bb[1]);
        M::run(s[2 * n + 1], qf[kk], bb[2], bb[3]);
      }

    // Scale and mask by index (only where a mask reaches this tile).
    const int k0 = j * BK;
    bool full = k0 + BK <= s_k && (!has_vf || k0 >= vfrom);
    if (causal)
      full = full && q0 >= k0 + BK - 1 + shift &&
             (window <= 0 || k0 > q0 + BQ - 1 - window);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.sm_scale;
        if (!full) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          bool ok = col < s_k && (!has_vf || col >= vfrom);
          if (causal) {
            ok = ok && row >= col + shift;
            if (window > 0) ok = ok && col > row - window;
          }
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

    // O += P V: p is the A operand straight from registers, as two T terms
    // (hi + lo) against the same V fragments.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
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
  const size_t obase = (size_t)bh * s_q;
  tc::store_rows<T, D>(static_cast<T*>(a.out) + obase * D, o,
                       q0 + warp * 16, s_q, 1.f / l[0], 1.f / l[1]);
  if (a.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < s_q) a.lse[obase + row] = m[r] + logf(l[r]);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int b, cudaStream_t stream) {
  const int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * a.h, (a.s_q + BQ - 1) / BQ);
  flash_fwd_tc_kernel<T, D><<<grid, NTH, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int d, const Args& a, int b, cudaStream_t stream) {
  if (d == 64) return launch<T, 64>(a, b, stream);
  if (d == 128) return launch<T, 128>(a, b, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tcf


// strides: the batch, head and row element strides of q, k and v (nine
// values, host memory); each operand's last dim is contiguous and its rows
// 16-byte aligned. f32 operands are contiguous and ignore them. out
// (b, h, s_q, d) and lse (b, h, s_q) are written contiguous.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, float* lse, const int* valid_from,
                              const int* shift, const long long* strides,
                              int b, int h, int s_q, int s_k, int d,
                              int dtype, int causal, int window,
                              float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == adapt::kF32) {
    if (d == 64)
      return launch<float, 64>(q, k, v, out, lse, valid_from, shift, b, h,
                               s_q, s_k, causal, window, sm_scale, st);
    if (d == 128)
      return launch<float, 128>(q, k, v, out, lse, valid_from, shift, b, h,
                                s_q, s_k, causal, window, sm_scale, st);
    return (int)cudaErrorInvalidValue;
  }
  tcf::Args a{q, k, v, out, lse, valid_from, shift, {}, {}, {}, h, s_q, s_k,
              causal, window, sm_scale};
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
  }
  switch (dtype) {
    case adapt::kBF16:
      return tcf::by_dim<__nv_bfloat16>(d, a, b, st);
    case adapt::kF16:
      return tcf::by_dim<__half>(d, a, b, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
