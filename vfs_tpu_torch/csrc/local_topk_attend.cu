// Masked top-k local attention of one query frame against a frame bank: the
// per-step kernel of the scan-tier label propagation (backend='pallas', an
// opt-in of test_cfg; the configs' default is the whole-video engine).
//
// Replaces the TPU kernel pallas_local_topk_attend
// (vfs_tpu/ops/pallas_attention.py:357; kernel bodies _make_kernel :228 and
// _make_kernel_batched :144, top-k tail _topk_tail :53) and its XLA epilogue
// (:542-574: value gather, softmax, weighted sum), fused here.
//
// What it computes. query (h, w, C) and bank (F, h, w, C) are fp32,
// contiguous and L2-normalised; vals (F, h, w, K) fp32; valid (F,) int32.
// For every query cell (y, x), the exact top-k of
//   score = dot(query[y, x], bank[f, ky, kx]) * inv_tau
// over the slots f with valid[f] != 0 and the keys with (dy, dx) = (ky - y,
// kx - x) inside the circle float(dy^2 + dx^2) < radius^2 and inside the
// map. Ties go to the lowest (f, ky, kx): for one query that is the order of
// the TPU kernel's flat index f * kb_pad + block row * kbw + block col. Then
//   out[y, x, :] = sum_i softmax(scores)_i * vals[f_i, ky_i, kx_i, :].
// Outputs: out (h, w, K) fp32, scores (h, w, k) fp32 and src (h, w, k)
// int64, src = f*h*w + ky*w + kx. Where a query has fewer than k valid keys,
// the remaining entries are filler: score -1e30 (softmax weight 0) and src =
// the query's own cell in slot 0. vfs_local_topk_attend_bf16 takes a bf16
// query and bank (pallas_precision='bfloat16': the JAX scan keeps its bank
// ring in bf16, vfs_tpu/ops/propagation.py:319-322, and the kernel scores
// bf16 x bf16 in fp32, pallas_attention.py:430); vals and the epilogue
// stay fp32. Stage 1 stages bf16 cells and widens them in registers, so
// its lists equal the fp32 entry's on the widened features bit for bit.
//
// Inexact modes (pallas_attention.py's scores_dtype and extract_mode).
// vfs_local_topk_attend_scores_bf16[_bf16] select by, and take the softmax
// over, the scores rounded to bf16 (round to nearest even, :329-340,
// :79-83), and return the rounded scores. vfs_local_topk_attend_packed
// [_bf16] select by the scores quantised to rint(clip(s, -15, 15) *
// 65536 / 30) (:314-328; ties to the lowest (f, ky, kx), as JAX's packed
// int (qs << 16) | (0xFFFF - flat column) orders them), then re-score the
// k picks exactly (:553-568) and take the softmax over the exact scores,
// which they return. The lists hold the key (window_topk.cuh's score_key),
// so the stages are the exact mode's. The port does not pack: it has no
// 16-bit index limit (JAX raises at total_k > 65536, a count of its TPU
// tile). Where a query has fewer than k valid keys, JAX's packed mode
// picks masked keys and weighs them at clipped coordinates that depend on
// its tile; the port keeps its filler (score -1e30, weight 0).
//
// Design. Two stages, launched together by the one C entry point.
// 1. Per slot. One block per (tile of 8 x 32 query cells, slot f) runs the
//    windowed top-k core of window_topk.cuh on its one frame (the core's
//    slot_kernel, which row 4 shares: register
//    blocks of 4 query rows x 4 columns x 4 dx, 8.5 FFMA per shared-memory
//    wavefront, key rows sharing each staged query chunk, a 2-stage
//    cp.async ring, passes outside the circle's band skipped) and writes
//    the tile's lists to a scratch buffer. The slot stays a grid axis: a
//    step has only 32 tiles of 8 x 32 at 60 x 107 cells, while 32 x 21 =
//    672 blocks at one block per SM (16 warps at r18, 12 at r50) fill the
//    132 SMs 5.1 times over. Walking the slots inside a block would fill
//    its lists from empty once instead of 21 times, but leaves 100 SMs
//    idle. A block of an invalid slot returns at once. The core is row
//    1's, so the scan path and the decoupled path give a key the same
//    score bit for bit.
// 2. Merge. One thread per query merges the valid slots' lists in slot
//    order under the same full comparator (an order key encodes (f, dy,
//    dx), so the merged list is exact whatever the visiting order), then
//    runs the epilogue: the softmax over its list and the weighted sum of
//    the k gathered value rows, in list order. Packed first re-scores the
//    k picks: the core's fmaf chain in ascending channel order, times
//    inv_tau (bf16 features widened first), so a pick's score equals the
//    exact entry's bit for bit. Its blocks are a warp: h*w threads, each
//    reading its k key rows (C channels each) 4 channels a load, 8 picks
//    at a time; 61 MMAC at r50's shapes.
//
// Bound (an H100 SXM; window_topk.cuh's note has the design's figures).
// Work is 2*C multiply-adds per (query, valid in-map key) pair, plus a
// k*K-term epilogue. At the DAVIS shapes with a full bank (60x107 cells,
// 21 valid slots) that is 26.34 GFLOP per step at r18 (C=256, radius 12)
// and 224.84 GFLOP per step at r50 (C=1024, radius 18), against 138 MB /
// 552 MB of bank read once: the kernel is bound by fp32 operations on the
// CUDA cores, 0.393 ms and 3.356 ms per step at 67 TFLOP/s (chip_smoke.py's
// step_work and bound_ms). Stage 1 reads 8.5 FFMA per shared-memory
// wavefront and about 15.8 FLOP per byte of L2, and 47.9% (r18) / 51.5%
// (r50) of the pairs it computes count. Each block fills its lists from
// empty, so more of its scores reach the lists than in row 1's blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (vfs_tpu_torch/ops/_build.py does this at first
// use). Interface: six extern "C" functions (exact, bf16 scores and
// packed, each with fp32 and bf16 features), launched on the caller's
// stream; they allocate nothing and return cudaGetLastError().

#include "window_topk.cuh"

namespace {

using wtk::Geometry;
using wtk::KMAX;
using wtk::Sel;
constexpr int MT = 128;  // merge threads per block
constexpr int RESCORE_PICKS = 8;  // picks a packed re-score pass reads

// Merge threads per block: a warp for packed, whose threads run long
// re-scores, so that its h*w threads spread over the SMs.
__host__ __device__ constexpr int merge_threads(Sel s) { return s == Sel::Packed ? 32 : MT; }

// Packed: the exact score of each pick (cell lo[i] of the bank), the
// core's fmaf chain over ascending channels from 0, times inv_tau; fillers
// (NEG_INF) stay.
template <class T>
__device__ void rescore(const T* __restrict__ qrow, const T* __restrict__ bank,
                        int C, const int* lo, float* ls, int topk,
                        float inv_tau) {
  for (int i0 = 0; i0 < topk; i0 += RESCORE_PICKS) {
    const T* key[RESCORE_PICKS];
    float acc[RESCORE_PICKS];
#pragma unroll
    for (int j = 0; j < RESCORE_PICKS; ++j) {
      key[j] = bank + (size_t)lo[min(i0 + j, topk - 1)] * C;
      acc[j] = 0.f;
    }
    for (int c = 0; c < C; c += 4) {
      const float4 qv = wtk::load_global4(qrow + c);
#pragma unroll
      for (int j = 0; j < RESCORE_PICKS; ++j)
        acc[j] = wtk::dot4(qv, wtk::load_global4(key[j] + c), acc[j]);
    }
#pragma unroll
    for (int j = 0; j < RESCORE_PICKS; ++j)
      if (i0 + j < topk && ls[i0 + j] != wtk::NEG_INF)
        ls[i0 + j] = acc[j] * inv_tau;
  }
}

// Stage 2: one thread per query merges the valid slots' lists and runs the
// epilogue (packed: after re-scoring its picks).
template <Sel S, class T>
__global__ void __launch_bounds__(merge_threads(S))
    local_topk_merge_kernel(const T* __restrict__ query,
                            const T* __restrict__ bank,
                            const float* __restrict__ vals,
                            const int* __restrict__ valid,
                            const float* __restrict__ part_s,
                            const int* __restrict__ part_o,
                            float* __restrict__ out, float* __restrict__ out_s,
                            long long* __restrict__ out_i, int F, int h,
                            int w, int C, int K, int r, int topk,
                            float inv_tau) {
  const int hw = h * w;
  const int q = blockIdx.x * merge_threads(S) + threadIdx.x;
  if (q >= hw) return;
  const int y = q / w;
  const int x = q - y * w;

  float ls[KMAX];
  int lo[KMAX];
  wtk::merge_parts(part_s, part_o, F, [&](int f) { return valid[f] != 0; },
                   hw, q, topk, ls, lo);
  // scores and sources out; lo[i] becomes entry i's cell index, ls[i] its
  // score and then its softmax weight
  wtk::decode_list(ls, lo, topk, q, y, x, w, hw, r, out_s, out_i);
  // the list is sorted by its key: for the exact and bf16 keys its first
  // entry is the max
  float m = ls[0];
  if constexpr (S == Sel::Packed) {
    rescore(query + (size_t)q * C, bank, C, lo, ls, topk, inv_tau);
    for (int i = 0; i < topk; ++i) {
      m = i == 0 ? ls[0] : fmaxf(m, ls[i]);
      out_s[(size_t)q * topk + i] = ls[i];
    }
  }
  wtk::softmax_weights(ls, topk, m);
  float* dst = out + (size_t)q * K;
  for (int c = 0; c < K; ++c)
    dst[c] = wtk::weighted_value(ls, lo, topk, vals, K, c);
}

// Every entry: S the selection's score key, T the feature type of query
// and bank, whose C must be a multiple of a 16-byte quad's channels (4
// fp32, 8 bf16).
template <Sel S, class T>
int entry(const void* query, const void* bank, const void* vals,
          const void* valid, void* out, void* scores, void* src,
          void* part_s, void* part_o, int F, int h, int w, int C, int K,
          int r, const int* band, float inv_tau, int topk, void* stream) {
  if (F < 1 || F > 65535 || h < 1 || w < 1 || C < wtk::Feat<T>::QUAD ||
      C % wtk::Feat<T>::QUAD != 0 || K < 1 ||
      !wtk::check_band(r, band, topk) ||
      (long long)F * h * w >= INT_MAX ||
      (long long)F * (2 * r + 1) * (2 * r + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Geometry g =
      wtk::make_geometry(h, w, C, r, band, inv_tau, topk);
  const T* q = static_cast<const T*>(query);
  const T* b = static_cast<const T*>(bank);
  const int* ok = static_cast<const int*>(valid);
  float* ps = static_cast<float*>(part_s);
  int* po = static_cast<int*>(part_o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      wtk::launch_slots<false, S>(q, b, ok, ps, po, F, g, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  constexpr int mt = merge_threads(S);
  local_topk_merge_kernel<S, T><<<(h * w + mt - 1) / mt, mt, 0, st>>>(
      q, b, static_cast<const float*>(vals), ok, ps, po,
      static_cast<float*>(out), static_cast<float*>(scores),
      static_cast<long long*>(src), F, h, w, C, K, r, topk, inv_tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part_s (F*h*w*topk floats) and part_o (as many ints) are scratch for the
// per-slot lists. r and band: the wrapper's plan
// (vfs_tpu_torch/ops/window_geometry.py::window_plan); band holds r + 1
// host ints. The core derives the rest of the launch from r. Every entry
// takes these arguments.
#define VFS_LOCAL_ENTRY(NAME, SEL, TYPE)                                    \
  int NAME(const void* query, const void* bank, const void* vals,          \
           const void* valid, void* out, void* scores, void* src,          \
           void* part_s, void* part_o, int F, int h, int w, int C, int K,  \
           int r, const int* band, float inv_tau, int topk, void* stream) { \
    return entry<SEL, TYPE>(query, bank, vals, valid, out, scores, src,    \
                            part_s, part_o, F, h, w, C, K, r, band,        \
                            inv_tau, topk, stream);                        \
  }

// Exact selection; fp32, then bf16 features (C a multiple of 8); vals fp32.
VFS_LOCAL_ENTRY(vfs_local_topk_attend, Sel::Exact, float)
VFS_LOCAL_ENTRY(vfs_local_topk_attend_bf16, Sel::Exact, __nv_bfloat16)
// scores_dtype='bfloat16'
VFS_LOCAL_ENTRY(vfs_local_topk_attend_scores_bf16, Sel::Bf16, float)
VFS_LOCAL_ENTRY(vfs_local_topk_attend_scores_bf16_bf16, Sel::Bf16,
                __nv_bfloat16)
// extract_mode='packed'
VFS_LOCAL_ENTRY(vfs_local_topk_attend_packed, Sel::Packed, float)
VFS_LOCAL_ENTRY(vfs_local_topk_attend_packed_bf16, Sel::Packed,
                __nv_bfloat16)

#undef VFS_LOCAL_ENTRY

}  // extern "C"
