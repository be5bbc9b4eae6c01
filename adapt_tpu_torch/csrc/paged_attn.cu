// K3 and K3-split: one decode step of attention over a paged KV pool for
// Hopper (sm_90a), over native, int8 or packed-int4 pools (K3q).
//
// Replaces the TPU kernels adapt_tpu/ops/paged_attention.py:_paged_kernel
// and _paged_split_kernel (via _paged_impl, with _combine_splits), every
// branch: the group-folded query q (b, kv_h, g, hd) attends the slot's
// pages of a shared pool (num_pages, kv_h, page, w), walked in the order of
// its page-table row table[b] (b, pps), up to each row's `index` and from
// `valid_from`. A quantized pool is an int8 value pool (w = hd, or hd / 2
// packed int4) plus an f32 scale pool (num_pages, kv_h, page, 1) per K and
// V, addressed by the same table, so prefix-shared and forked pages carry
// their scales. The split variant cuts the slot's pps * page key range into
// `split` runs of 64-key tiles (K2-split's runs over the same L) and
// combines their partials in the same launch.
//
// Design. On the TPU the table rides as a scalar-prefetch operand and the
// K/V index_map fetches each grid step's physical page; the kernel body is
// K2's. Here the body is K2's too: decode_cluster.cuh over a paged walk,
// which reads the table row from device memory once per page a 64-key tile
// touches and hands the keys' vector indices to the cp.async staging. No
// gather of pages into a strip, no host sync, any page size (the TPU gate
// page % 128, and its quantized page % 1024, are not carried over). The
// walk yields the key's vector index; the cache-element policy scales it by
// the value width for the values and uses it as is for the scales. K2 and
// K3 therefore run the same arithmetic on the same 64-key tiles, and a
// paged decode equals a dense decode bit for bit on the same K/V, quantized
// or not, split or not (for the splits, on the same key range L). A
// negative `index` (an idle or mid-prefill row) walks no tile and writes
// zeros; an all-dead split carries m = -1e30 and l = 0.
//
// Bound. As K2: one step reads the live pages once, bytes bound; the table
// adds 4 bytes a touched page.
#include "decode_cluster.cuh"

// ws == nullptr (split must be 1) runs K3; otherwise K3-split, with `ws`
// and `counter` as decode_attn.cu's. `kv` is the pool's KVCode; k_scale /
// v_scale are nullptr for a native pool.
extern "C" int paged_attn(const void* q, const void* k_pool,
                          const void* v_pool, const float* k_scale,
                          const float* v_scale, const int* table,
                          const int* index, const int* valid_from, void* out,
                          float* ws, unsigned* counter, int b, int kvh, int g,
                          int pps, int page, int hd, int split, int dtype,
                          int kv, float sm_scale, void* stream) {
  if (pps < 1 || page < 1) return (int)cudaErrorInvalidValue;
  const adapt::cluster::DecodeArgs a{index, valid_from, out, ws, counter,
                                     b * kvh, kvh, g, pps * page, split,
                                     sm_scale,
                                     static_cast<cudaStream_t>(stream)};
  return adapt::cluster::dispatch(
      dtype, kv, hd, q, k_pool, v_pool, k_scale, v_scale, a,
      adapt::cluster::PagedWalk{table, kvh, pps, page});
}
