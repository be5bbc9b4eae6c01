// Tensor-core building blocks shared by the 16-bit flash kernels (K1's and
// K7's bf16 / f16 instantiations): cp.async staging of 16-bit tiles into a
// padded shared-memory layout, ldmatrix fragment loads, and the
// mma.sync.m16n8k16 product with f32 accumulation.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane l,
// g = l / 4, t = l % 4:
//  - A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//    a[2] = (g, 2t + 8..), a[3] = (g + 8, 2t + 8..);
//  - B (16 x 8, k x n): b[0] = (k 2t..2t+1, n g), b[1] = (k 2t + 8.., n g);
//  - C / D (16 x 8, f32): c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..).
// So the C fragments of two neighbouring n8 tiles, rounded to 16 bits in
// pairs, are exactly the A fragment of one k16 step of the next product:
// a score tile never leaves registers between its two products.
//
// Tiles live in shared memory as rows of D 16-bit values padded by 8
// (16 bytes): eight consecutive rows then start in eight different 16-byte
// bank groups, so every ldmatrix phase is conflict-free, and every row stays
// 16-byte aligned for cp.async.
#pragma once

#include "common.cuh"

namespace adapt {
namespace tc {

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
  __device__ __forceinline__ static void run(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
  __device__ __forceinline__ static void run(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// The cp.async helpers live in common.cuh (the decode kernels stage with
// them too).
using adapt::cp_async16;
using adapt::cp_async4;
using adapt::cp_commit;
using adapt::cp_wait;
using adapt::smem_addr;

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Shared-memory row pitch of a D-wide 16-bit tile, in elements.
template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 8;
}

// Stage rows [r0, r0 + R) of a (rows, D) 16-bit matrix whose rows are
// `stride` elements apart into a shared tile, 16 bytes a copy; rows past
// `rows` are zero-filled (the copy reads nothing). All NT threads call it.
template <typename T, int R, int D, int NT>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      long long stride, int r0, int rows) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool in = r0 + r < rows;
    const T* g = in ? src + (r0 + r) * stride + c : src;
    cp_async16(smem_addr(dst + r * pitch<D>() + c), g, in);
  }
}

// The A fragment of rows [row0, row0 + 16) x columns [k0, k0 + 16) of a
// shared tile (an operand whose reduction runs along the tile's rows' D).
template <int D, typename T>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* tile, int row0,
                                       int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, smem_addr(tile + (row0 + (l & 15)) * pitch<D>() + k0 +
                       (l >> 4) * 8));
}

// B fragments of two neighbouring n8 tiles when the tile's rows are n and
// its D columns are k (S = Q K^T: K rows are keys): b[0..1] for rows
// [n0, n0 + 8), b[2..3] for [n0 + 8, n0 + 16), columns [k0, k0 + 16).
template <int D, typename T>
__device__ __forceinline__ void load_b(uint32_t b[4], const T* tile, int n0,
                                       int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(b, smem_addr(tile + (n0 + (l & 7) + (l >> 4) * 8) * pitch<D>() +
                       k0 + ((l >> 3) & 1) * 8));
}

// B fragments of two neighbouring n8 tiles when the reduction runs along
// the tile's rows (P V: V rows are keys, its D columns are n): rows
// [k0, k0 + 16), b[0..1] for columns [n0, n0 + 8), b[2..3] for
// [n0 + 8, n0 + 16). ldmatrix.trans turns the row-major tile into the
// column pairs B wants.
template <int D, typename T>
__device__ __forceinline__ void load_bt(uint32_t b[4], const T* tile, int k0,
                                        int n0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(b, smem_addr(tile + (k0 + (l & 15)) * pitch<D>() + n0 +
                         (l >> 4) * 8));
}

// The A fragment of a k16 step from the C fragments of n8 tiles 2kk and
// 2kk + 1, each value first rounded to T (K7's only rounding of p and ds).
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = Mma<T>::pack(c0[0], c0[1]);
  a[1] = Mma<T>::pack(c0[2], c0[3]);
  a[2] = Mma<T>::pack(c1[0], c1[1]);
  a[3] = Mma<T>::pack(c1[2], c1[3]);
}

// The same A fragment as two T terms, hi = T(c) and lo = T(c - hi): used
// as two operands against the same B, the product carries ~16 bits of c
// (8 + 8 for bf16) instead of one rounding's 8.
template <typename T>
__device__ __forceinline__ void c_to_a_split(uint32_t hi[4], uint32_t lo[4],
                                             const float c0[4],
                                             const float c1[4]) {
  c_to_a<T>(hi, c0, c1);
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 h = Mma<T>::unpack(hi[i]);
    lo[i] = Mma<T>::pack(x[2 * i] - h.x, x[2 * i + 1] - h.y);
  }
}

// Store a 16-row warp tile of C fragments (acc[n][4], n over D / 8 tiles)
// scaled by one factor per row half, as T pairs, to rows row0 + g and
// row0 + g + 8 of a contiguous (rows, D) matrix; rows past `rows` are
// skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float acc[][4], int row0,
                                           int rows, float f0, float f1) {
  const int l = threadIdx.x % 32;
  const int g = l / 4, t = l % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    if (r >= rows) continue;
    const float f = h ? f1 : f0;
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + (size_t)r * D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      out[n * 4 + t] = Mma<T>::pack(acc[n][2 * h] * f, acc[n][2 * h + 1] * f);
  }
}

}  // namespace tc
}  // namespace adapt
