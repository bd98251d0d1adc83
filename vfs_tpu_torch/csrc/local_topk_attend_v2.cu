// Masked top-k local attention of one query frame against a frame bank, by
// per-frame extraction and a running merge (the v2 per-step attention).
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
// Design (perframe_topk.cuh holds the shared device code). One block per
// query tile walks the valid slots in order, as frame_body does (:73-115):
// it scores the tile's key window of the slot into shared memory, then each
// query's warp runs that slot's passes and merges them into its running
// list. Invalid slots are skipped, not scored (the TPU kernel scores them
// -1e30, :88). The passes stop at the list's k-th score (the tau exit of
// the v1 video kernel; exact, and the TPU kernel's lists are the same
// without it).
//
// Bound. With a full bank (21 valid distinct slots) at the DAVIS-480p
// shapes (60x107 cells, top-10) one step needs 26.34 GFLOP at r18 (C =
// 256, radius 12) and 224.84 GFLOP at r50 (C = 1024, radius 18): 0.393 ms
// and 3.356 ms at the fp32 CUDA-core peak of 67 TFLOP/s, against 138 / 552
// MB of bank read once: bound by operations. Beside the costs that
// video_topk_affinity_v1.cu lists (the whole window block S, key windows
// reloaded per tile), one step has only one block per tile: 210 blocks of 8
// warps at r18 and 405 at r50 on 132 SMs that hold one block each, so the
// last wave runs part empty. Splitting the slots over blocks, with a merge
// of their lists as local_topk_attend.cu does, is the way to fill the card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (vfs_tpu_torch/ops/_build.py does this at first
// use). Interface: extern "C" functions, launched on the caller's stream;
// nothing is allocated here and the entry point returns the CUDA error.

#include "perframe_topk.cuh"

using namespace perframe;

namespace {

template <class T>
__global__ void __launch_bounds__(NT)
    local_v2_kernel(const float* __restrict__ query,
                    const float* __restrict__ bank,
                    const int* __restrict__ valid, float* __restrict__ out_s,
                    long long* __restrict__ out_i, Geometry g, int F,
                    int topk, unsigned long long* __restrict__ pass_count) {
  extern __shared__ float4 smem[];
  const Smem<T> sm(smem);
  const int y0 = (blockIdx.x / g.tiles_x) * T::TQH;
  const int x0 = (blockIdx.x % g.tiles_x) * T::TQW;
  const size_t frame_stride = (size_t)g.h * g.w * g.C;

  float ls[T::QPW];
  int lo[T::QPW];
  init_lists<T>(ls, lo);
  int passes = 0;
  for (int f = 0; f < F; ++f) {
    if (valid[f] == 0) continue;  // uniform over the block
    score_tile<T>(query, bank + (size_t)f * frame_stride, y0, x0, g, sm);
    __syncthreads();
    extract_tile<T>(sm, f, g, topk, true, ls, lo, &passes);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long hw = (long long)g.h * g.w;
#pragma unroll
  for (int qq = 0; qq < T::QPW; ++qq) {
    const int q = warp + NWARP * qq;
    const int y = y0 + q / T::TQW;
    const int x = x0 + q % T::TQW;
    if (y >= g.h || x >= g.w || lane >= topk) continue;
    float s = ls[qq];
    long long idx;
    int f, dy, dx;
    if (decode(lo[qq], g, &f, &dy, &dx)) {
      idx = f * hw + (long long)(y + dy) * g.w + (x + dx);
    } else {
      s = NEG_INF;
      idx = (long long)y * g.w + x;
    }
    const size_t base = ((size_t)y * g.w + x) * topk;
    out_s[base + lane] = s;
    out_i[base + lane] = idx;
  }
  if (pass_count != nullptr && lane == 0)
    atomicAdd(pass_count, (unsigned long long)passes);
}

template <class T>
cudaError_t launch(const float* query, const float* bank, const int* valid,
                   float* out_s, long long* out_i, int F, int h, int w, int C,
                   int r, float radius2, float inv_tau, int topk,
                   unsigned long long* pass_count, cudaStream_t stream) {
  const Geometry g = make_geometry<T>(h, w, C, r, radius2, inv_tau);
  const size_t bytes = smem_bytes<T>(g);
  const cudaError_t err = allow_smem(local_v2_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  local_v2_kernel<T><<<tiles<T>(g), NT, bytes, stream>>>(
      query, bank, valid, out_s, out_i, g, F, topk, pass_count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest top-k and largest window offset r the compiled kernel takes.
int vfs_local_v2_max_topk() { return KMAX; }
int vfs_local_v2_max_offset() { return MAX_OFFSET; }

// pass_count (one unsigned 64-bit integer, or null) accumulates the passes
// the blocks ran.
int vfs_local_topk_attend_v2(const void* query, const void* bank,
                             const void* valid, void* scores, void* src,
                             int F, int h, int w, int C, int r, float radius2,
                             float inv_tau, int topk, void* pass_count,
                             void* stream) {
  if (F < 1 || h < 1 || w < 1 || C < 4 || C % 4 != 0 || r < 0 ||
      r > MAX_OFFSET || topk < 1 || topk > KMAX ||
      (long long)F * h * w >= INT_MAX ||
      (long long)h * w * C >= INT_MAX ||
      (long long)F * (2 * r + 1) * (2 * r + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(query);
  const float* b = static_cast<const float*>(bank);
  const int* ok = static_cast<const int*>(valid);
  float* s = static_cast<float*>(scores);
  long long* i = static_cast<long long*>(src);
  unsigned long long* pc = static_cast<unsigned long long*>(pass_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r <= 12)
    err = launch<TileA>(q, b, ok, s, i, F, h, w, C, r, radius2, inv_tau,
                        topk, pc, st);
  else if (r <= 20)
    err = launch<TileB>(q, b, ok, s, i, F, h, w, C, r, radius2, inv_tau,
                        topk, pc, st);
  else
    err = launch<TileC>(q, b, ok, s, i, F, h, w, C, r, radius2, inv_tau,
                        topk, pc, st);
  return (int)err;
}

}  // extern "C"
