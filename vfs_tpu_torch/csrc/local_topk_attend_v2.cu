// Masked top-k local attention of one query frame against a frame bank,
// without the epilogue (the v2 per-step attention's selection).
//
// Replaces the TPU kernel pallas_local_topk_attend_v2
// (vfs_tpu/ops/pallas_attention_v2.py:130, body _make_kernel :40). Its
// epilogue (gather, softmax, weighted sum of the selected values) ran in
// XLA (:203-219); in the port it is plain PyTorch after this kernel
// (vfs_tpu_torch/ops/local_attention_v2.py).
//
// What it computes: the selection of local_topk_attend.cu (row 3). query
// (h, w, C) and bank (F, h, w, C) fp32, contiguous, L2-normalised; valid
// (F,) int32. For every query cell, the exact top-k of dot(q, key) *
// inv_tau over the slots f with valid[f] != 0 and the keys inside the
// circle and the map; ties to the lowest (f, ky, kx). scores (h, w, k) fp32
// and src (h, w, k) int64 = f*h*w + ky*w + kx; fillers score -1e30 with src
// the query's own cell in slot 0 (the TPU kernel's fillers point at flat
// index 0 with weight 0; neither reaches the logits).
//
// Design. Two launches on the caller's stream, from one C entry point: row
// 3's two stages (local_topk_attend.cu) without its epilogue.
// 1. Per slot: the core's slot_kernel (window_topk.cuh), one block per
//    (tile of 8 x 32 query cells, slot f) with register blocks of 4 query
//    rows x 4 columns x 4 dx, key rows sharing each staged query chunk, a
//    2-stage cp.async ring and passes outside the circle's band skipped. It
//    writes the tile's lists over its slot to scratch; a block of an
//    invalid slot returns at once.
// 2. Merge: one thread per query merges the valid slots' lists in slot
//    order under the full comparator and decodes them (the core's
//    merge_parts and decode_list, row 3's merge stage).
// v2's TPU kernel merges its slots into one running list. A block that
// walks several slots would keep its lists warm over them, but a step has
// only 32 tiles at 60 x 107 cells: fewer blocks than the (tile, slot)
// grid's 672 leave the 132 SMs unbalanced, one block of 16 (r18) or 12
// (r50) warps running per SM and edge tiles doing less work. Slot groups
// of that kind were timed on the card and lost to this grid at r50 and
// tied at r18 (PERF.md §6), so the grid stays.
//
// Bound (an H100 SXM). With a full bank (21 valid distinct slots) at the
// DAVIS-480p shapes (60x107 cells, top-10) one step needs 26.34 GFLOP at
// r18 (C = 256, radius 12) and 224.84 GFLOP at r50 (C = 1024, radius 18):
// 0.393 ms and 3.356 ms on the fp32 CUDA cores at 67 TFLOP/s, against 138
// / 552 MB of bank read once: bound by operations. The earlier per-frame
// design (one block per tile: 210 / 405 blocks of 8 warps on 132 SMs, the
// whole key-window score block in shared memory, extraction by passes)
// reached 9.0% / 13.4% of it; this one reaches row 3's shares, about 10%
// / 17% (chip_smoke.py on the card above), and what holds row 3 holds it
// (the inner loop's FFMA rate and wasted pairs, the exposed stage copies,
// the merges of lists that fill from empty in every block; PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (vfs_tpu_torch/ops/_build.py does this at first
// use). Interface: one extern "C" function, launched on the caller's
// stream; it allocates nothing and returns cudaGetLastError().

#include "window_topk.cuh"

namespace {

using wtk::KMAX;
constexpr int MT = 128;  // merge threads per block

// Stage 2: one thread per query merges the valid slots' lists and decodes
// them.
__global__ void __launch_bounds__(MT)
    local_v2_merge_kernel(const int* __restrict__ valid, int F,
                          const float* __restrict__ part_s,
                          const int* __restrict__ part_o,
                          float* __restrict__ out_s,
                          long long* __restrict__ out_i, int h, int w, int r,
                          int topk) {
  const int hw = h * w;
  const int q = blockIdx.x * MT + threadIdx.x;
  if (q >= hw) return;
  float ls[KMAX];
  int lo[KMAX];
  wtk::merge_parts(part_s, part_o, F, [&](int f) { return valid[f] != 0; },
                   hw, q, topk, ls, lo);
  wtk::decode_list(ls, lo, topk, q, q / w, q % w, w, hw, r, out_s, out_i);
}

}  // namespace

extern "C" {

// part_s (F*h*w*topk floats) and part_o (as many ints) are scratch for the
// per-slot lists. r and band: the wrapper's plan
// (window_geometry.window_plan); band holds r + 1 host ints. merge_count
// (one unsigned 64-bit integer, or null: no atomics) accumulates the
// (query, key row) merges the blocks ran.
int vfs_local_topk_attend_v2(const void* query, const void* bank,
                             const void* valid, void* scores, void* src,
                             void* part_s, void* part_o, int F, int h, int w,
                             int C, int r, const int* band, float inv_tau,
                             int topk, void* merge_count, void* stream) {
  if (F < 1 || F > 65535 || h < 1 || w < 1 || C < 4 || C % 4 != 0 ||
      !wtk::check_band(r, band, topk) || (long long)h * w >= INT_MAX ||
      (long long)F * (2 * r + 1) * (2 * r + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const wtk::Geometry g = wtk::make_geometry(h, w, C, r, band, inv_tau, topk);
  const float* q = static_cast<const float*>(query);
  const float* b = static_cast<const float*>(bank);
  const int* ok = static_cast<const int*>(valid);
  float* ps = static_cast<float*>(part_s);
  int* po = static_cast<int*>(part_o);
  unsigned long long* count = static_cast<unsigned long long*>(merge_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      count != nullptr
          ? wtk::launch_slots<true>(q, b, ok, ps, po, F, g, count, st)
          : wtk::launch_slots<false>(q, b, ok, ps, po, F, g, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  local_v2_merge_kernel<<<(h * w + MT - 1) / MT, MT, 0, st>>>(
      ok, F, ps, po, static_cast<float*>(scores),
      static_cast<long long*>(src), h, w, r, topk);
  return (int)cudaGetLastError();
}

}  // extern "C"
