// Masked top-k local attention of one query frame against a frame bank: the
// per-step kernel of the scan-tier label propagation (backend='pallas').
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
// the query's own cell in slot 0.
//
// Design. Two stages, launched together by the one C entry point.
// 1. Per slot. One block per (tile of TH x TW query cells, slot f), one
//    thread per query, one warp per query row: the structure of
//    video_topk_affinity.cu with the bank slot as the second grid axis, so
//    a step of h*w queries still fills the card (60x107 cells, 21 slots:
//    1260 blocks). A block of an invalid slot returns at once: the slot is
//    skipped, not scored. For each key row ky of the tile's dilated window
//    the block stages that key row (TW + SPAN - 1 cells) and the query tile
//    in shared memory, CC channels at a time. Each thread keeps SPAN running
//    dot products (one per dx) in registers and sums every one of them with
//    fmaf in ascending channel order: the arithmetic of
//    video_topk_affinity.cu, so the scan path and the decoupled path give a
//    key the same score bit for bit. Valid candidates meet a per-thread
//    top-k list (score desc, order key asc); only one that beats the list's
//    last entry touches the list. The list goes to a scratch buffer.
// 2. Merge. One thread per query merges the valid slots' lists in slot
//    order under the same full comparator (an order key encodes (f, dy,
//    dx), so the merged list is exact whatever the visiting order), then
//    runs the epilogue: the softmax over its list and the weighted sum of
//    the k gathered value rows, in list order.
//
// Bound. Work is 2*C multiply-adds per (query, valid in-map key) pair, plus
// a k*K-term epilogue. At the DAVIS shapes with a full bank (60x107 cells,
// 21 valid slots) that is 26.34 GFLOP per step at r18 (C=256, radius 12)
// and 224.84 GFLOP per step at r50 (C=1024, radius 18), against 138 MB /
// 552 MB of bank read once: the kernel is bound by fp32 operations on the
// CUDA cores, 0.393 ms and 3.356 ms per step at 67 TFLOP/s (chip_smoke.py's
// step_work and bound_ms). Stage 1 is bound by shared-memory loads instead:
// every 4 FMAs read one float4 of keys from shared memory, and it computes
// all SPAN dx of a key row (r = ceil(radius - 1): SPAN = 28 for r = 11, 40
// for r = 17, so 23/28 = 82% and 35/40 = 88% of them useful). Register
// blocking over several queries per thread and tensor-core (TF32 / bf16
// wgmma) scoring with an exact fp32 re-rank are the ways to the bound.
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
constexpr int MAX_OFFSET = 31;
constexpr int MT = 128;      // merge threads per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool better(float s, int o, float ts, int to) {
  return s > ts || (s == ts && o < to);
}

// Insert (s, o) into the sorted list (ls, lo) of length topk, dropping its
// last entry; the caller checked that (s, o) beats that entry. Not inlined:
// one copy serves every call site of the unrolled dx loop, and insertions
// are rare next to the candidates that only meet the threshold.
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

// Stage 1. SPAN: number of dx lanes per key row, >= 2r+1, a multiple of 4.
// Writes the query's top-k list over slot blockIdx.y to part_s / part_o
// (F, h*w, topk); empty entries are (-inf, INT_MAX).
template <int SPAN>
__global__ void __launch_bounds__(NT)
    local_topk_slot_kernel(const float* __restrict__ query,
                           const float* __restrict__ bank,
                           const int* __restrict__ valid,
                           float* __restrict__ part_s,
                           int* __restrict__ part_o, int h, int w, int C,
                           int r, float radius2, float inv_tau, int topk,
                           int tiles_x) {
  constexpr int KW = TW + SPAN - 1;  // staged key-row width
  __shared__ float4 ks[CC / 4][KW];
  __shared__ float4 qs[CC / 4][NT];

  const int f = blockIdx.y;
  if (valid[f] == 0) return;  // uniform over the block; merge skips it too
  const int tid = threadIdx.x;
  const int qx = tid % TW;
  const int qy = tid / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y = y0 + qy;
  const int x = x0 + qx;
  const bool qvalid = y < h && x < w;
  const int span = 2 * r + 1;
  const float* kframe = bank + (size_t)f * h * w * C;

  float ls[KMAX];  // the query's top-k list, (score desc, order key asc)
  int lo[KMAX];
  for (int i = 0; i < topk; ++i) {
    ls[i] = -INFINITY;
    lo[i] = INT_MAX;
  }
  float worst_s = -INFINITY;
  int worst_o = INT_MAX;

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
              query + ((size_t)yy * w + xx) * C + c0 + 4 * c4);
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
          const int o = (f * span + (dy + r)) * span + d;
          if (better(s, o, worst_s, worst_o)) {
            insert(ls, lo, topk, s, o);
            worst_s = ls[topk - 1];
            worst_o = lo[topk - 1];
          }
        }
      }
    }
  }

  if (!qvalid) return;
  const size_t base = (((size_t)f * h + y) * w + x) * topk;
  for (int i = 0; i < topk; ++i) {
    part_s[base + i] = ls[i];
    part_o[base + i] = lo[i];
  }
}

// Stage 2: one thread per query merges the valid slots' lists and runs the
// epilogue.
__global__ void __launch_bounds__(MT)
    local_topk_merge_kernel(const float* __restrict__ vals,
                            const int* __restrict__ valid,
                            const float* __restrict__ part_s,
                            const int* __restrict__ part_o,
                            float* __restrict__ out, float* __restrict__ out_s,
                            long long* __restrict__ out_i, int F, int h,
                            int w, int K, int r, int topk) {
  const int hw = h * w;
  const int q = blockIdx.x * MT + threadIdx.x;
  if (q >= hw) return;
  const int y = q / w;
  const int x = q - y * w;
  const int span = 2 * r + 1;

  float ls[KMAX];
  int lo[KMAX];
  for (int i = 0; i < topk; ++i) {
    ls[i] = -INFINITY;
    lo[i] = INT_MAX;
  }
  for (int f = 0; f < F; ++f) {
    if (valid[f] == 0) continue;
    const size_t base = ((size_t)f * hw + q) * topk;
    for (int i = 0; i < topk; ++i) {
      const float s = part_s[base + i];
      const int o = part_o[base + i];
      // each list is sorted: once an entry misses, the rest miss too
      if (!better(s, o, ls[topk - 1], lo[topk - 1])) break;
      insert(ls, lo, topk, s, o);
    }
  }

  // Decode the list: scores and sources out, then lo[i] becomes the cell
  // index f*h*w + ky*w + kx of entry i and ls[i] its softmax weight.
  const size_t base = (size_t)q * topk;
  for (int i = 0; i < topk; ++i) {
    if (lo[i] == INT_MAX) {  // filler: fewer than k valid keys
      ls[i] = NEG_INF;
      lo[i] = q;
    } else {
      const int o = lo[i];
      const int f = o / (span * span);
      const int rem = o - f * span * span;
      const int dy = rem / span - r;
      const int dx = rem % span - r;
      lo[i] = f * hw + (y + dy) * w + (x + dx);
    }
    out_s[base + i] = ls[i];
    out_i[base + i] = lo[i];
  }
  const float m = ls[0];  // the list is sorted: its first entry is the max
  float z = 0.f;
  for (int i = 0; i < topk; ++i) {
    ls[i] = expf(ls[i] - m);
    z += ls[i];
  }
  for (int i = 0; i < topk; ++i) ls[i] /= z;
  float* dst = out + (size_t)q * K;
  for (int c = 0; c < K; ++c) {
    float a = 0.f;
    for (int i = 0; i < topk; ++i)
      a = fmaf(ls[i], vals[(size_t)lo[i] * K + c], a);
    dst[c] = a;
  }
}

template <int SPAN>
void launch_slots(const float* query, const float* bank, const int* valid,
                  float* part_s, int* part_o, int F, int h, int w, int C,
                  int r, float radius2, float inv_tau, int topk,
                  cudaStream_t stream) {
  const int tiles_x = (w + TW - 1) / TW;
  const int tiles_y = (h + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, F);
  local_topk_slot_kernel<SPAN><<<grid, NT, 0, stream>>>(
      query, bank, valid, part_s, part_o, h, w, C, r, radius2, inv_tau, topk,
      tiles_x);
}

}  // namespace

extern "C" {

// Largest top-k and largest window offset r the compiled kernel takes.
int vfs_local_topk_max_topk() { return KMAX; }
int vfs_local_topk_max_offset() { return MAX_OFFSET; }

// part_s (F*h*w*topk floats) and part_o (as many ints) are scratch for the
// per-slot lists.
int vfs_local_topk_attend(const void* query, const void* bank,
                          const void* vals, const void* valid, void* out,
                          void* scores, void* src, void* part_s,
                          void* part_o, int F, int h, int w, int C, int K,
                          int r, float radius2, float inv_tau, int topk,
                          void* stream) {
  if (F < 1 || F > 65535 || h < 1 || w < 1 || C < 4 || C % 4 != 0 ||
      K < 1 || r < 0 || r > MAX_OFFSET || topk < 1 || topk > KMAX ||
      (long long)F * h * w >= INT_MAX ||
      (long long)F * (2 * r + 1) * (2 * r + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(query);
  const float* b = static_cast<const float*>(bank);
  const int* ok = static_cast<const int*>(valid);
  float* ps = static_cast<float*>(part_s);
  int* po = static_cast<int*>(part_o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int span = 2 * r + 1;
  if (span <= 8)
    launch_slots<8>(q, b, ok, ps, po, F, h, w, C, r, radius2, inv_tau, topk,
                    st);
  else if (span <= 16)
    launch_slots<16>(q, b, ok, ps, po, F, h, w, C, r, radius2, inv_tau, topk,
                     st);
  else if (span <= 28)
    launch_slots<28>(q, b, ok, ps, po, F, h, w, C, r, radius2, inv_tau, topk,
                     st);
  else if (span <= 40)
    launch_slots<40>(q, b, ok, ps, po, F, h, w, C, r, radius2, inv_tau, topk,
                     st);
  else
    launch_slots<64>(q, b, ok, ps, po, F, h, w, C, r, radius2, inv_tau, topk,
                     st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  local_topk_merge_kernel<<<(h * w + MT - 1) / MT, MT, 0, st>>>(
      static_cast<const float*>(vals), ok, ps, po, static_cast<float*>(out),
      static_cast<float*>(scores), static_cast<long long*>(src), F, h, w, K,
      r, topk);
  return (int)cudaGetLastError();
}

}  // extern "C"
