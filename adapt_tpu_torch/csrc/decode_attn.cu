// K2 and K2-split: one decode step of cached attention for Hopper (sm_90a),
// over native, int8 or packed-int4 caches (K2q).
//
// Replaces the TPU kernels adapt_tpu/ops/decode_attention.py:_decode_kernel
// (step body _attend_tile) and _decode_split_kernel, every branch: the
// group-folded query q (b, kv_h, g, hd) attends a dense per-slot cache
// (b, kv_h, L, w) up to each row's `index`, masked below by `valid_from`,
// with an f32 online softmax. A native cache has w = hd values of q's type;
// a quantized one has int8 values (w = hd, or w = hd / 2 packed int4) and an
// f32 scale plane (b, kv_h, L, 1) per K and V, consumed as bytes in the
// kernel - the cache is never dequantized in device memory. The split
// variant (flash decoding) cuts the key range into `split` parts, each
// emitting unnormalised partials (acc, m, l) that
// ops/decode_attention._combine_splits reduces.
//
// Design. The unsplit kernel (K2, K2q) is decode_cluster.cuh's body over a
// dense-strip address walk: a cluster of 8 blocks per (b * kv_h) row, tile
// t of the row's 64-key tiles on rank t mod 8, raw cache bytes staged by
// cp.async into a two-stage ring, the ranks' (acc, m, l) combined through
// distributed shared memory in one launch. The split variant keeps
// decode_tile.cuh's body (one block per (row, split), partials in device
// memory). Both share K3's code (paged_attn.cu) through an address functor,
// so a paged decode equals a dense one bit for bit. All g folded query rows
// share each staged cache tile, so the cache is read once per kv head: that
// is the point of the GQA fold. `index` and `valid_from` are read from
// device memory (no host sync). Any L is served: the ragged last tile is
// masked by index, so the dense strip of length max_len + 1 (the batcher's
// trash slot) runs here, where the TPU path refused it (and, for quantized
// caches, its L % 1024 scale-tile rule). Tiles wholly past `index` or
// wholly inside the left padding are skipped, as there.
//
// Bound. One step reads the live cache once (2 * live * (w * value bytes +
// scale bytes) per kv head) and does ~4 * g * live * hd operations: bytes
// bound at every g the models use; int8 streams 0.53x and int4 0.28x of
// bf16's bytes at hd 64. PERF.md has the kernels' device times against it.
#include "decode_cluster.cuh"
#include "decode_tile.cuh"

// split == 1 with o_part == nullptr writes the normalised output (K2);
// otherwise each (row, split) block writes its partials (K2-split). `kv` is
// the cache's KVCode; k_scale / v_scale are nullptr for a native cache.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const float* k_scale, const float* v_scale,
                           const int* index, const int* valid_from, void* out,
                           float* o_part, float* m_part, float* l_part, int b,
                           int kvh, int g, int L, int hd, int split, int dtype,
                           int kv, float sm_scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (split == 1 && o_part == nullptr)
    return adapt::cluster::dispatch(dtype, kv, hd, q, k, v, k_scale, v_scale,
                                    index, valid_from, out, b * kvh, kvh, g,
                                    L, sm_scale,
                                    adapt::cluster::DenseWalk{L}, st);
  return adapt::decode::dispatch(
      dtype, kv, hd, q, k, v, k_scale, v_scale, index, valid_from, out,
      o_part, m_part, l_part, b * kvh, kvh, g, L, split, sm_scale,
      adapt::decode::DenseAddr{L}, st);
}
