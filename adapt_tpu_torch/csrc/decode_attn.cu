// K2 and K2-split: one decode step of cached attention for Hopper (sm_90a),
// over native, int8 or packed-int4 caches (K2q).
//
// Replaces the TPU kernels adapt_tpu/ops/decode_attention.py:_decode_kernel
// (step body _attend_tile) and _decode_split_kernel with _combine_splits,
// every branch: the group-folded query q (b, kv_h, g, hd) attends a dense
// per-slot cache (b, kv_h, L, w) up to each row's `index`, masked below by
// `valid_from`, with an f32 online softmax. A native cache has w = hd
// values of q's type; a quantized one has int8 values (w = hd, or w = hd /
// 2 packed int4) and an f32 scale plane (b, kv_h, L, 1) per K and V,
// consumed as bytes in the kernel - the cache is never dequantized in
// device memory. The split variant (flash decoding) cuts the key range into
// `split` runs of 64-key tiles and combines their partials (acc, m, l).
//
// Design: decode_cluster.cuh's body over a dense-strip address walk. A
// cluster of 8 blocks per (b * kv_h) row, or per (row, split) for the
// split variant; tile t of the row's 64-key tiles on rank t mod 8, raw
// cache bytes staged by cp.async through a ring of three half-tile slots,
// the ranks' (acc, m, l) combined through distributed shared memory, and
// the splits combined in split order by the cluster that arrives last on
// the row's counter: one launch either way. K3 (paged_attn.cu) runs the
// same body through a paged walk, so a paged decode equals a dense one bit
// for bit. All g folded query rows share each staged cache tile, so the
// cache is read once per kv head: that is the point of the GQA fold.
// `index` and `valid_from` are read from device memory (no host sync). Any
// L is served: the ragged last tile is masked by index, so the dense strip
// of length max_len + 1 (the batcher's trash slot) runs here, where the TPU
// path refused it (and, for quantized caches, its L % 1024 scale-tile
// rule). Keys outside [valid_from, index] are never read.
//
// Bound. One step reads the live cache once (2 * live * (w * value bytes +
// scale bytes) per kv head) and does ~4 * g * live * hd operations: bytes
// bound at every g the models use; int8 streams 0.53x and int4 0.28x of
// bf16's bytes at hd 64. The splits add 4 (hd + 2) bytes a folded row and
// split, written once and read once. PERF.md has the kernels' device times
// against it.
#include "decode_cluster.cuh"

// ws == nullptr (split must be 1) runs K2; otherwise K2-split: `ws` holds
// b * kvh * split * g * (hd + 2) floats of partials and `counter` b * kvh
// words, 0 on entry and on exit. Both write the normalised `out`. `kv` is
// the cache's KVCode; k_scale / v_scale are nullptr for a native cache.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const float* k_scale, const float* v_scale,
                           const int* index, const int* valid_from, void* out,
                           float* ws, unsigned* counter, int b, int kvh,
                           int g, int L, int hd, int split, int dtype, int kv,
                           float sm_scale, void* stream) {
  const adapt::cluster::DecodeArgs a{index, valid_from, out, ws, counter,
                                     b * kvh, kvh, g, L, split, sm_scale,
                                     static_cast<cudaStream_t>(stream)};
  return adapt::cluster::dispatch(dtype, kv, hd, q, k, v, k_scale, v_scale,
                                  a, adapt::cluster::DenseWalk{L});
}
