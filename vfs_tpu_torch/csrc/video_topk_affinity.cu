// Masked top-k video affinity: phase 1 of DAVIS label propagation, the
// default (v2) engine of every eval of the port.
//
// Replaces the TPU kernel video_topk_affinity2
// (vfs_tpu/ops/pallas_affinity_video.py:1037, kernel body
// _make_video2_kernel :736, mask _video2_mask :996).
//
// What it computes. feats is (T, h, w, C) fp32 (vfs_video_topk_affinity)
// or bf16 (vfs_video_topk_affinity_bf16, the JAX package's
// pallas_precision='bfloat16', feat_dtype at pallas_affinity_video.py:756
// and :818: bf16 x bf16 products summed in fp32), contiguous,
// L2-normalised.
// For every frame t >= 1 and query cell (y, x), the exact top-k of
//   score = dot(feats[t, y, x], feats[f, ky, kx]) * inv_tau
// over the bank positions j = 0..P:
//   j = 0       the first frame (f = 0);
//   j = s + 1   ring slot s, which holds f = t-1 - ((t-1-s) mod P) and is
//               live iff s <= t-1 (so frame 0 is a key twice while t <= P);
// and keys with (dy, dx) = (ky - y, kx - x) inside the circle
// float(dy^2 + dx^2) < radius^2 and inside the map. Ties go to the lowest
// order key (j, dy, dx), which for one query is (j, ky, kx): the tie order
// of the TPU kernel and of the scan engines. Outputs: scores (T, h, w, k)
// fp32 and src (T, h, w, k) int64, src = f*h*w + ky*w + kx. Where a query
// has fewer than k valid keys, the remaining entries are filler: score
// -1e30 (softmax weight 0) and src = the query's own cell in frame 0.
// Rows t = 0 are not written.
//
// Design. One block per (t, tile of 8 x 32 query cells) runs the windowed
// top-k core (window_topk.cuh: register blocks of 4 query rows x 4 columns
// x 4 dx, 8.5 FFMA per shared-memory wavefront, key rows sharing each
// staged query chunk, a 2-stage cp.async ring of 32-channel chunks, warps
// that skip passes outside the circle's band, lists in shared memory) over
// the live bank frames, then decodes the lists. Frame 0 is scored once
// while t <= P: the core inserts each of its candidates under j = 0 and
// under j = 1, so both copies stay in the candidate set as before, at
// 1/min(t, P+1) less work for those frames. A block walks its frames in j
// order, so its lists fill from empty only on frame 0. The decode is the
// core's store_video_lists, shared with row 2. The bf16 entry stages bf16
// cells (64 channels a 128-byte cell: half the stage bytes a channel) and
// widens them in registers; its scores equal the fp32 entry's on the
// widened features bit for bit (window_topk.cuh, Feature types).
//
// Bound (what holds it on an H100 SXM; window_topk.cuh's note has the
// design's figures): fp32 operations, 2*C FLOPs per (query, in-map circle
// key, distinct live bank frame): 0.393 ms per frame at r18 (C = 256,
// radius 12) and 3.356 ms at r50 (C = 1024, radius 18) at 67 TFLOP/s, in
// either feature type (the scoring is fp32 FFMA on the CUDA cores). The
// design reads 8.5 FFMA per shared-memory wavefront and about 15.8 FLOP per
// byte of L2, and 47.9% (r18) / 51.5% (r50) of the pairs it computes count.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (vfs_tpu_torch/ops/_build.py does this at first
// use). Interface: two extern "C" functions (fp32 and bf16 features),
// launched on the caller's stream; they allocate nothing and return
// cudaGetLastError().

#include "window_topk.cuh"

namespace {

using wtk::Geometry;

// The bank of query frame t: j = 0 and the live ring slots, frame 0's ring
// copy folded into j = 0 while t <= P.
template <class T>
struct VideoBank {
  const T* feats;
  size_t frame_stride;
  int t, P;
  bool dup;  // t <= P: ring slot 0 (j = 1) holds frame 0
  __device__ int count() const { return dup ? t : P + 1; }
  __device__ int order_j(int i) const { return dup && i > 0 ? i + 1 : i; }
  __device__ bool twice(int i) const { return dup && i == 0; }
  __device__ const T* frame(int i) const {
    const int j = order_j(i);
    const int f = j == 0 ? 0 : t - 1 - ((t - 1 - (j - 1)) % P);
    return feats + (size_t)f * frame_stride;
  }
};

template <int NP, class T, int NKR = wtk::key_rows(NP),
          int NT = wtk::threads(NP, NKR)>
__global__ void __launch_bounds__(NT, 1)
    video_topk_kernel(const T* __restrict__ feats,
                      float* __restrict__ out_s,
                      long long* __restrict__ out_i, int P, Geometry g) {
  extern __shared__ float4 smem4[];
  const int t = blockIdx.y + 1;
  const int y0 = (blockIdx.x / g.tiles_x) * wtk::TH;
  const int x0 = (blockIdx.x % g.tiles_x) * wtk::TW;
  const size_t fs = (size_t)g.h * g.w * g.C;
  const VideoBank<T> bank{feats, fs, t, P, t <= P};
  float* smem = reinterpret_cast<float*>(smem4);
  wtk::run<NP, NKR>(feats + (size_t)t * fs, bank, y0, x0, g, smem);
  __syncthreads();
  wtk::store_video_lists<NT>(wtk::lists(g, smem, NKR), t, P, y0, x0, g,
                             out_s, out_i);
}

template <int NP, class F>
cudaError_t launch(const F* feats, float* out_s, long long* out_i, int T,
                   int P, const Geometry& g, cudaStream_t stream) {
  auto kernel = video_topk_kernel<NP, F>;
  const size_t smem = wtk::smem_bytes(g, wtk::key_rows(NP));
  const cudaError_t err = wtk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(wtk::tiles(g), T - 1);
  kernel<<<grid, wtk::threads(NP, wtk::key_rows(NP)), smem, stream>>>(
      feats, out_s, out_i, P, g);
  return cudaGetLastError();
}

// Both entries: F the feature type, whose C must be a multiple of a
// 16-byte quad's channels (4 fp32, 8 bf16).
template <class F>
int entry(const void* feats, void* scores, void* src, int T, int h, int w,
          int C, int r, const int* band, float inv_tau, int topk, int P,
          void* stream) {
  if (T < 2 || T - 1 > 65535 || h < 1 || w < 1 ||
      C < wtk::Feat<F>::QUAD || C % wtk::Feat<F>::QUAD != 0 || P < 1 ||
      !wtk::check_band(r, band, topk) ||
      (long long)(P + 1) * (2 * r + 1) * (2 * r + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Geometry g =
      wtk::make_geometry(h, w, C, r, band, inv_tau, topk);
  const F* f = static_cast<const F*>(feats);
  float* s = static_cast<float*>(scores);
  long long* i = static_cast<long long*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wtk::passes(r)) {
    case 1: return (int)launch<1>(f, s, i, T, P, g, st);
    case 2: return (int)launch<2>(f, s, i, T, P, g, st);
    case 3: return (int)launch<3>(f, s, i, T, P, g, st);
    default: return (int)launch<4>(f, s, i, T, P, g, st);
  }
}

}  // namespace

extern "C" {

// r and band: the wrapper's plan
// (vfs_tpu_torch/ops/window_geometry.py::window_plan); band holds r + 1
// host ints. The core derives the rest of the launch from r.
int vfs_video_topk_affinity(const void* feats, void* scores, void* src,
                            int T, int h, int w, int C, int r,
                            const int* band, float inv_tau, int topk, int P,
                            void* stream) {
  return entry<float>(feats, scores, src, T, h, w, C, r, band, inv_tau, topk,
                      P, stream);
}

// The same with bf16 features (C a multiple of 8).
int vfs_video_topk_affinity_bf16(const void* feats, void* scores, void* src,
                                 int T, int h, int w, int C, int r,
                                 const int* band, float inv_tau, int topk,
                                 int P, void* stream) {
  return entry<__nv_bfloat16>(feats, scores, src, T, h, w, C, r, band,
                              inv_tau, topk, P, stream);
}

}  // extern "C"
