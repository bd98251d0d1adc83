// Masked top-k video affinity, v1 engine (video_engine='v1'): phase 1 of
// label propagation for the JHMDB and VIP evals of the port.
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
// frame 0. Rows t = 0 are not written. vfs_video_topk_affinity_v1_bf16
// takes bf16 features (pallas_precision='bfloat16'; the TPU kernel's
// feat_dtype at :130, :165, :382 and :429): the core stages bf16 cells and
// widens them in registers, so its lists equal the fp32 entry's on the
// widened features, and row 1's bf16 lists, bit for bit.
//
// Design. Row 1's: a block per (t, tile of 8 x 32 query cells) runs the
// windowed top-k core (window_topk.cuh: 4 x 4 x 4 register blocks at 8.5
// FFMA per shared-memory wavefront, key rows sharing each staged query
// chunk, a 2-stage cp.async ring of swizzled 32-channel cells, passes
// outside the circle's band skipped, lists in shared memory) over the
// live bank frames, and decodes the lists with row 1's store_video_lists.
// What is v1's own:
// - The bank is walked most recent first, as frames_of does (:253-269):
//   f = t-1, then frame 0 (j = 0), then t-2 .. t-P, ring slots not yet
//   live skipped. Each distinct frame is scored once: while t <= P frame 0
//   is also ring slot 0 (j = 1), and the core inserts its candidates under
//   both j (the TPU kernel and the earlier per-frame design scored it
//   twice).
// - early_exit = 1 ('perframe' with the tau exit) keeps the core's
//   per-lane check of a key row's candidates against the list's last
//   entry: the tau exit, generalised from a frame to a key row. 0 ('sweep',
//   whose TPU extraction has no exit, or video_early_exit=False) skips it,
//   so every query with in-band candidates is merged. The lists are the
//   same; a counter of the (query, key row) merges shows the difference.
// - Bank splits only bounded the TPU's VMEM ring: there are none here.
// - The grid is 1-D with t varying fastest, so the blocks in flight are a
//   few tiles at every t: on the card this ran faster than row 1's
//   tiles-fastest grid at both widths, while the order in which a block
//   walks its bank hardly mattered. The merge counter is a template
//   switch: a count held in a register across the main loop slowed the
//   r18 build (128 registers a thread at 512 threads).
//
// Bound (an H100 SXM): the work is row 1's, 2*C FLOPs per (query, in-map
// circle key, distinct live bank frame): at the DAVIS-480p shapes (60 x 107
// cells, P = 20, top-10) 0.393 ms per steady frame at r18 (C = 256,
// radius 12) and 3.356 ms at r50 (C = 1024, radius 18) on the fp32 CUDA
// cores (67 TFLOP/s); the features read once are 6.6 / 26 MB a frame, so
// operations bound it. The earlier per-frame design (the tile's whole
// key-window score block in shared memory, key windows re-read from L2
// per (tile, frame), per-frame extraction by passes) reached 11.9% /
// 16.8% of that bound (steady, exit on; PERF.md). This one runs at row
// 1's speed or a little above it with the exit on (16% / 21% steady in
// `python3 ab_kernels.py` on an NVIDIA H100 80GB HBM3 at 700 W); with the
// exit off its merges cost 14% (r18) and 7% (r50) more. What holds row 1
// under its bound (the inner loop's FFMA rate and wasted pairs, 47.9% /
// 51.5% of the computed pairs needed, the exposed stage copies) holds
// this kernel too (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (vfs_tpu_torch/ops/_build.py does this at first
// use). Interface: two extern "C" functions (fp32 and bf16 features),
// launched on the caller's stream; they allocate nothing and return
// cudaGetLastError().

#include "window_topk.cuh"

namespace {

using wtk::Geometry;

// The bank of query frame t, most recent first: frame i is f = t-1, 0,
// t-2, t-3, ... While t <= P (dup) the walk stops at f = 1 and frame 0
// stands at j = 0 and, by twice(), at ring slot 0 (j = 1); for t = 1 the
// one frame, f = t-1, is frame 0.
template <class T>
struct RecentBank {
  const T* feats;
  size_t frame_stride;
  int t, P;
  bool dup;  // t <= P
  __device__ int count() const { return dup ? t : P + 1; }
  __device__ int source(int i) const {
    return i == 0 ? t - 1 : i == 1 ? 0 : t - i;
  }
  __device__ int order_j(int i) const {
    const int f = source(i);
    return f == 0 ? 0 : 1 + f % P;
  }
  __device__ bool twice(int i) const { return dup && source(i) == 0; }
  __device__ const T* frame(int i) const {
    return feats + (size_t)source(i) * frame_stride;
  }
};

// Block b: query frame t = b % (T - 1) + 1 of tile b / (T - 1), t fastest.
// COUNT: add the warp's merges to merge_count (an instance of its own; the
// note above says why).
template <int NP, bool EXIT, bool COUNT, class F,
          int NKR = wtk::key_rows(NP), int NT = wtk::threads(NP, NKR)>
__global__ void __launch_bounds__(NT, 1)
    video_v1_kernel(const F* __restrict__ feats,
                    float* __restrict__ out_s, long long* __restrict__ out_i,
                    int T, int P, Geometry g,
                    unsigned long long* __restrict__ merge_count) {
  extern __shared__ float4 smem4[];
  const int t = blockIdx.x % (T - 1) + 1;
  const int tile = blockIdx.x / (T - 1);
  const int y0 = (tile / g.tiles_x) * wtk::TH;
  const int x0 = (tile % g.tiles_x) * wtk::TW;
  const size_t fs = (size_t)g.h * g.w * g.C;
  const RecentBank<F> bank{feats, fs, t, P, t <= P};
  float* smem = reinterpret_cast<float*>(smem4);
  const int merged =
      wtk::run<NP, NKR, EXIT>(feats + (size_t)t * fs, bank, y0, x0, g, smem);
  __syncthreads();
  wtk::store_video_lists<NT>(wtk::lists(g, smem, NKR), t, P, y0, x0, g,
                             out_s, out_i);
  if (COUNT && (threadIdx.x & 31) == 0)
    atomicAdd(merge_count, (unsigned long long)merged);
}

template <int NP, bool EXIT, class F>
cudaError_t launch(const F* feats, float* out_s, long long* out_i, int T,
                   int P, const Geometry& g, unsigned long long* count,
                   cudaStream_t stream) {
  auto kernel = count != nullptr ? video_v1_kernel<NP, EXIT, true, F>
                                 : video_v1_kernel<NP, EXIT, false, F>;
  const size_t smem = wtk::smem_bytes(g, wtk::key_rows(NP));
  const cudaError_t err = wtk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<wtk::tiles(g) * (T - 1), wtk::threads(NP, wtk::key_rows(NP)),
           smem, stream>>>(feats, out_s, out_i, T, P, g, count);
  return cudaGetLastError();
}

template <bool EXIT, class F>
cudaError_t launch_passes(const F* feats, float* out_s, long long* out_i,
                          int T, int P, const Geometry& g,
                          unsigned long long* count, cudaStream_t st) {
  switch (wtk::passes(g.r)) {
    case 1: return launch<1, EXIT>(feats, out_s, out_i, T, P, g, count, st);
    case 2: return launch<2, EXIT>(feats, out_s, out_i, T, P, g, count, st);
    case 3: return launch<3, EXIT>(feats, out_s, out_i, T, P, g, count, st);
    default: return launch<4, EXIT>(feats, out_s, out_i, T, P, g, count, st);
  }
}

// Both entries: F the feature type, whose C must be a multiple of a
// 16-byte quad's channels (4 fp32, 8 bf16).
template <class F>
int entry(const void* feats, void* scores, void* src, int T, int h, int w,
          int C, int r, const int* band, float inv_tau, int topk, int P,
          int early_exit, void* merge_count, void* stream) {
  const long long blocks = (long long)((h + wtk::TH - 1) / wtk::TH) *
                           ((w + wtk::TW - 1) / wtk::TW) * (T - 1);
  if (T < 2 || h < 1 || w < 1 || C < wtk::Feat<F>::QUAD ||
      C % wtk::Feat<F>::QUAD != 0 || P < 1 ||
      !wtk::check_band(r, band, topk) || blocks >= INT_MAX ||
      (long long)(P + 1) * (2 * r + 1) * (2 * r + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Geometry g = wtk::make_geometry(h, w, C, r, band, inv_tau, topk);
  const F* f = static_cast<const F*>(feats);
  float* s = static_cast<float*>(scores);
  long long* i = static_cast<long long*>(src);
  unsigned long long* count = static_cast<unsigned long long*>(merge_count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(early_exit
                   ? launch_passes<true>(f, s, i, T, P, g, count, st)
                   : launch_passes<false>(f, s, i, T, P, g, count, st));
}

}  // namespace

extern "C" {

// r and band: the wrapper's plan
// (vfs_tpu_torch/ops/window_geometry.py::window_plan); band holds r + 1
// host ints. early_exit: the per-lane check of the lists' last entries
// (nonzero) or none. merge_count (one unsigned 64-bit integer, or null:
// no atomics) accumulates the (query, key row) merges the blocks ran.
int vfs_video_topk_affinity_v1(const void* feats, void* scores, void* src,
                               int T, int h, int w, int C, int r,
                               const int* band, float inv_tau, int topk,
                               int P, int early_exit, void* merge_count,
                               void* stream) {
  return entry<float>(feats, scores, src, T, h, w, C, r, band, inv_tau, topk,
                      P, early_exit, merge_count, stream);
}

// The same with bf16 features (C a multiple of 8).
int vfs_video_topk_affinity_v1_bf16(const void* feats, void* scores,
                                    void* src, int T, int h, int w, int C,
                                    int r, const int* band, float inv_tau,
                                    int topk, int P, int early_exit,
                                    void* merge_count, void* stream) {
  return entry<__nv_bfloat16>(feats, scores, src, T, h, w, C, r, band,
                              inv_tau, topk, P, early_exit, merge_count,
                              stream);
}

}  // extern "C"
