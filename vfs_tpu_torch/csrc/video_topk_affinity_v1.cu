// Masked top-k video affinity, v1 engine (video_engine='v1'): phase 1 of
// label propagation by per-frame extraction and merge.
//
// Replaces the TPU kernel video_topk_affinity (v1,
// vfs_tpu/ops/pallas_affinity_video.py:531; bodies _make_video_kernel :121,
// with its 'sweep' and 'perframe' extraction, and the bank-split
// _make_split_kernel :355, whose per-split lists merge by a 2-key sort at
// :691-697).
//
// What it computes: the function of video_topk_affinity.cu (row 1), with
// the same outputs, filler convention and tie order. feats (T, h, w, C)
// fp32, contiguous, L2-normalised. For every frame t >= 1 and query cell,
// the exact top-k of dot(q, key) * inv_tau over bank positions j = 0..P
// (j = 0 frame 0; j = s + 1 ring slot s, holding f = t-1 - ((t-1-s) mod P),
// live iff s <= t-1) and keys inside the circle and the map; ties to the
// lowest (j, ky, kx). scores (T, h, w, k) fp32, src (T, h, w, k) int64 =
// f*h*w + ky*w + kx; fillers score -1e30 with src the query's own cell in
// frame 0. Rows t = 0 are not written.
//
// Design (perframe_topk.cuh holds the shared device code). One block per
// (query tile, frame t): blocks run in parallel, so the TPU's sequential
// grid over t with its resident key ring is not carried over. The block
// visits the bank most-recent-first, as frames_of does (:253-269): f = t-1,
// then frame 0 (j = 0), then t-2 .. t-P, skipping ring slots not yet live,
// so the tau exit tightens fast. For each bank frame it scores the tile's
// key window into shared memory (score_tile), then each query's warp runs
// the frame's passes and merges (extract_merge). early_exit = 1 is the
// 'perframe' extraction with the tau exit; 0 runs every pass, which is what
// the TPU's 'sweep' extraction selects (it has no exit); both give the same
// lists. Bank splits only bounded the TPU's VMEM ring: there are none here.
//
// Bound. The work is that of row 1: 2*C multiply-adds per (query, distinct
// live bank frame, in-map circle key). At the DAVIS-480p shapes (60x107
// cells, P = 20, top-10) a steady frame needs 26.34 GFLOP at r18 (C = 256,
// radius 12) and 224.84 GFLOP at r50 (C = 1024, radius 18): 0.393 ms and
// 3.356 ms at the fp32 CUDA-core peak of 67 TFLOP/s (chip_smoke.py's
// affinity_work and bound_ms), while the features read once are 6.6 / 26
// MB a frame. It is bound by operations. This kernel computes the whole
// window block S (r18: 4x8 tile, 26x30 keys, 56% of them in a query's
// circle; r50: 4x4 tile, 38x38 keys, 70%) and reloads each bank frame's key
// window per tile from L2 (r50: 5.9 MB per block and bank frame), with one
// block of 8 warps per SM (S fills shared memory). Its 8x4 register blocks
// read 24 shared-memory wavefronts per 128 FMAs of a warp, and the next
// channel chunk's loads overlap the current chunk's FMAs. Skipping the
// out-of-circle corners of S, TMA staging into a ring of buffers, and TF32 /
// bf16 wgmma for S with an exact fp32 re-rank of the top candidates are the
// ways to the bound.
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
    video_v1_kernel(const float* __restrict__ feats, float* __restrict__ out_s,
                    long long* __restrict__ out_i, Geometry g, int topk,
                    int P, int early_exit,
                    unsigned long long* __restrict__ pass_count) {
  extern __shared__ float4 smem[];
  const Smem<T> sm(smem);
  const int t = blockIdx.y + 1;
  const int y0 = (blockIdx.x / g.tiles_x) * T::TQH;
  const int x0 = (blockIdx.x % g.tiles_x) * T::TQW;
  const size_t frame_stride = (size_t)g.h * g.w * g.C;
  const float* qframe = feats + (size_t)t * frame_stride;

  float ls[T::QPW];
  int lo[T::QPW];
  init_lists<T>(ls, lo);
  int passes = 0;
  // most recent first: f = t-1, frame 0 as j = 0, then t-2 .. t-P
  for (int o = 0; o <= P; ++o) {
    int f, j;
    if (o == 0) {
      f = t - 1;
      j = 1 + f % P;
    } else if (o == 1) {
      f = 0;
      j = 0;
    } else {
      f = t - o;
      if (f < 0) break;  // that ring slot, and every later one, is not live
      j = 1 + f % P;
    }
    score_tile<T>(qframe, feats + (size_t)f * frame_stride, y0, x0, g, sm);
    __syncthreads();
    extract_tile<T>(sm, j, g, topk, early_exit != 0, ls, lo, &passes);
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
    int j, dy, dx;
    if (decode(lo[qq], g, &j, &dy, &dx)) {
      const int f = j == 0 ? 0 : t - 1 - ((t - 1 - (j - 1)) % P);
      idx = f * hw + (long long)(y + dy) * g.w + (x + dx);
    } else {
      s = NEG_INF;
      idx = (long long)y * g.w + x;
    }
    const size_t base = (((size_t)t * g.h + y) * g.w + x) * topk;
    out_s[base + lane] = s;
    out_i[base + lane] = idx;
  }
  if (pass_count != nullptr && lane == 0)
    atomicAdd(pass_count, (unsigned long long)passes);
}

template <class T>
cudaError_t launch(const float* feats, float* out_s, long long* out_i, int T_,
                   int h, int w, int C, int r, float radius2, float inv_tau,
                   int topk, int P, int early_exit,
                   unsigned long long* pass_count, cudaStream_t stream) {
  const Geometry g = make_geometry<T>(h, w, C, r, radius2, inv_tau);
  const size_t bytes = smem_bytes<T>(g);
  const cudaError_t err = allow_smem(video_v1_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles<T>(g), T_ - 1);
  video_v1_kernel<T><<<grid, NT, bytes, stream>>>(
      feats, out_s, out_i, g, topk, P, early_exit, pass_count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest top-k and largest window offset r the compiled kernel takes.
int vfs_video_v1_max_topk() { return KMAX; }
int vfs_video_v1_max_offset() { return MAX_OFFSET; }

// pass_count (one unsigned 64-bit integer, or null) accumulates the passes
// the blocks ran.
int vfs_video_topk_affinity_v1(const void* feats, void* scores, void* src,
                               int T, int h, int w, int C, int r,
                               float radius2, float inv_tau, int topk, int P,
                               int early_exit, void* pass_count,
                               void* stream) {
  if (T < 2 || T - 1 > 65535 || h < 1 || w < 1 || C < 4 || C % 4 != 0 ||
      r < 0 || r > MAX_OFFSET || topk < 1 || topk > KMAX || P < 1 ||
      (long long)h * w * C >= INT_MAX ||
      (long long)(P + 1) * (2 * r + 1) * (2 * r + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  float* s = static_cast<float*>(scores);
  long long* i = static_cast<long long*>(src);
  unsigned long long* pc = static_cast<unsigned long long*>(pass_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (r <= 12)
    err = launch<TileA>(f, s, i, T, h, w, C, r, radius2, inv_tau, topk, P,
                        early_exit, pc, st);
  else if (r <= 20)
    err = launch<TileB>(f, s, i, T, h, w, C, r, radius2, inv_tau, topk, P,
                        early_exit, pc, st);
  else
    err = launch<TileC>(f, s, i, T, h, w, C, r, radius2, inv_tau, topk, P,
                        early_exit, pc, st);
  return (int)err;
}

}  // extern "C"
