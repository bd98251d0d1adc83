// Masked top-k video affinity: phase 1 of DAVIS label propagation.
//
// Replaces the TPU kernel video_topk_affinity2
// (vfs_tpu/ops/pallas_affinity_video.py:1037, kernel body
// _make_video2_kernel :736, mask _video2_mask :996).
//
// What it computes. feats is (T, h, w, C) fp32, contiguous, L2-normalised.
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
// Design. One block per (t, tile of TH x TW query cells); one thread per
// query, one warp per query row. The block walks j ascending, and for each
// key row ky of its dilated window stages that key row (TW + SPAN - 1
// cells) and the query tile in shared memory, CC channels at a time. Each
// thread keeps SPAN running dot products (one per dx) in registers and
// accumulates every one of them with fmaf in ascending channel order, so
// the same key vector always gives a bit-identical score, wherever it sits
// in the bank. Valid candidates of the row then meet a per-thread top-k
// list (score desc, order key asc); only a candidate that beats the list's
// last entry (kept in registers) touches the list. The full comparator
// makes the list exact whatever the visiting order.
//
// Bound. Work is 2*C multiply-adds per (query, live key) pair: at the r18
// DAVIS shape (60x107 cells, C=256, radius 12: 437 offsets, 21 bank
// frames) 2*256*6420*21*437 = 30.2 GFLOP per frame, and at r50 (C=1024,
// radius 18: 1005 offsets) 278 GFLOP per frame. The features are 6.6 MB
// per frame at r18, so the kernel is bound by fp32 operations on the CUDA
// cores, not by bytes. This first version is bound by shared-memory loads
// instead: every 4 FMAs read one float4 of keys from shared memory, and it
// computes all SPAN dx of a key row (about 80% useful at r18 and r50).
// Register blocking over several queries per thread and tensor-core
// (TF32 / bf16 wgmma) variants are the way to the bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (vfs_tpu_torch/ops/_build.py does this at first
// use). Interface: one extern "C" function, launched on the caller's
// stream; it allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int TW = 32;       // query tile width: one warp per query row
constexpr int TH = 4;        // query tile height
constexpr int NT = TW * TH;  // threads per block
constexpr int CC = 32;       // channels staged per chunk
constexpr int KMAX = 32;     // largest top-k kept
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool better(float s, int o, float ts, int to) {
  return s > ts || (s == ts && o < to);
}

// Insert (s, o) into the sorted list (ls, lo) of length topk, dropping its
// last entry; the caller checked that (s, o) beats that entry. Not inlined:
// one copy of the code serves every call site of the unrolled dx loop, and
// insertions are rare next to the candidates that only meet the threshold.
__device__ __noinline__ void insert(float* ls, int* lo, int topk, float s,
                                    int o) {
  int i = topk - 1;
  while (i > 0 && better(s, o, ls[i - 1], lo[i - 1])) {
    ls[i] = ls[i - 1];
    lo[i] = lo[i - 1];
    --i;
  }
  ls[i] = s;
  lo[i] = o;
}

// SPAN: number of dx lanes per key row, >= 2r+1, a multiple of 4.
template <int SPAN>
__global__ void __launch_bounds__(NT)
    video_topk_kernel(const float* __restrict__ feats,
                      float* __restrict__ out_s,
                      long long* __restrict__ out_i, int h, int w, int C,
                      int r, float radius2, float inv_tau, int topk, int P,
                      int tiles_x) {
  constexpr int KW = TW + SPAN - 1;  // staged key-row width
  __shared__ float4 ks[CC / 4][KW];
  __shared__ float4 qs[CC / 4][NT];

  const int tid = threadIdx.x;
  const int qx = tid % TW;
  const int qy = tid / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int t = blockIdx.y + 1;
  const int y = y0 + qy;
  const int x = x0 + qx;
  const bool qvalid = y < h && x < w;
  const int span = 2 * r + 1;
  const size_t frame_stride = (size_t)h * w * C;
  const float* qframe = feats + (size_t)t * frame_stride;

  float ls[KMAX];  // the query's top-k list, (score desc, order key asc)
  int lo[KMAX];
  for (int i = 0; i < topk; ++i) {
    ls[i] = -INFINITY;
    lo[i] = INT_MAX;
  }
  float worst_s = -INFINITY;
  int worst_o = INT_MAX;

  for (int j = 0; j <= P; ++j) {
    int f = 0;
    if (j > 0) {
      const int s = j - 1;
      if (s > t - 1) break;  // this slot and all later ones are not live yet
      f = t - 1 - ((t - 1 - s) % P);
    }
    const float* kframe = feats + (size_t)f * frame_stride;
    for (int kr = 0; kr < TH + 2 * r; ++kr) {
      const int ky = y0 - r + kr;
      if (ky < 0 || ky >= h) continue;  // uniform over the block
      const int dy = ky - y;
      const bool row_on = dy >= -r && dy <= r;  // uniform over the warp
      float acc[SPAN];
#pragma unroll
      for (int d = 0; d < SPAN; ++d) acc[d] = 0.f;

      const float* krow = kframe + (size_t)ky * w * C;
      for (int c0 = 0; c0 < C; c0 += CC) {
        const int n4 = min(CC, C - c0) / 4;
        __syncthreads();  // the previous chunk is consumed
        for (int i = tid; i < KW * n4; i += NT) {
          const int col = i / n4;
          const int c4 = i - col * n4;
          const int kx = x0 - r + col;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kx >= 0 && kx < w)
            v = *reinterpret_cast<const float4*>(krow + (size_t)kx * C + c0 +
                                                 4 * c4);
          ks[c4][col] = v;
        }
        for (int i = tid; i < NT * n4; i += NT) {
          const int q = i / n4;
          const int c4 = i - q * n4;
          const int yy = y0 + q / TW;
          const int xx = x0 + q % TW;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (yy < h && xx < w)
            v = *reinterpret_cast<const float4*>(
                qframe + ((size_t)yy * w + xx) * C + c0 + 4 * c4);
          qs[c4][q] = v;
        }
        __syncthreads();
        if (row_on) {
          for (int c4 = 0; c4 < n4; ++c4) {
            const float4 qv = qs[c4][tid];
#pragma unroll
            for (int d = 0; d < SPAN; ++d) {
              const float4 kv = ks[c4][qx + d];
              float a = acc[d];
              a = fmaf(qv.x, kv.x, a);
              a = fmaf(qv.y, kv.y, a);
              a = fmaf(qv.z, kv.z, a);
              a = fmaf(qv.w, kv.w, a);
              acc[d] = a;
            }
          }
        }
      }

      if (row_on && qvalid) {
#pragma unroll
        for (int d = 0; d < SPAN; ++d) {
          const int dx = d - r;
          const int kx = x + dx;
          if (d < span && (float)(dy * dy + dx * dx) < radius2 && kx >= 0 &&
              kx < w) {
            const float s = acc[d] * inv_tau;
            const int o = (j * span + (dy + r)) * span + d;
            if (better(s, o, worst_s, worst_o)) {
              insert(ls, lo, topk, s, o);
              worst_s = ls[topk - 1];
              worst_o = lo[topk - 1];
            }
          }
        }
      }
    }
  }

  if (!qvalid) return;
  const long long hw = (long long)h * w;
  const size_t base = (((size_t)t * h + y) * w + x) * topk;
  for (int i = 0; i < topk; ++i) {
    float s = ls[i];
    long long idx;
    if (lo[i] == INT_MAX) {  // filler: fewer than k valid keys
      s = NEG_INF;
      idx = (long long)y * w + x;
    } else {
      const int o = lo[i];
      const int j = o / (span * span);
      const int rem = o - j * span * span;
      const int dy = rem / span - r;
      const int dx = rem % span - r;
      const int f = j == 0 ? 0 : t - 1 - ((t - 1 - (j - 1)) % P);
      idx = f * hw + (long long)(y + dy) * w + (x + dx);
    }
    out_s[base + i] = s;
    out_i[base + i] = idx;
  }
}

template <int SPAN>
void launch(const float* feats, float* out_s, long long* out_i, int T, int h,
            int w, int C, int r, float radius2, float inv_tau, int topk,
            int P, cudaStream_t stream) {
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, T - 1);
  video_topk_kernel<SPAN><<<grid, NT, 0, stream>>>(
      feats, out_s, out_i, h, w, C, r, radius2, inv_tau, topk, P, tiles_x);
}

}  // namespace

extern "C" {

// Largest top-k and largest window offset r the compiled kernel takes.
int vfs_video_topk_max_topk() { return KMAX; }
int vfs_video_topk_max_offset() { return 31; }

int vfs_video_topk_affinity(const void* feats, void* scores, void* src,
                            int T, int h, int w, int C, int r,
                            float radius2, float inv_tau, int topk, int P,
                            void* stream) {
  if (T < 2 || h < 1 || w < 1 || C < 4 || C % 4 != 0 || r < 0 || r > 31 ||
      topk < 1 || topk > KMAX || P < 1)
    return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(feats);
  float* s = static_cast<float*>(scores);
  long long* i = static_cast<long long*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int span = 2 * r + 1;
  if (span <= 8)
    launch<8>(f, s, i, T, h, w, C, r, radius2, inv_tau, topk, P, st);
  else if (span <= 16)
    launch<16>(f, s, i, T, h, w, C, r, radius2, inv_tau, topk, P, st);
  else if (span <= 24)
    launch<24>(f, s, i, T, h, w, C, r, radius2, inv_tau, topk, P, st);
  else if (span <= 36)
    launch<36>(f, s, i, T, h, w, C, r, radius2, inv_tau, topk, P, st);
  else
    launch<64>(f, s, i, T, h, w, C, r, radius2, inv_tau, topk, P, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
