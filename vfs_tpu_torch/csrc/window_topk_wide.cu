// The windowed top-k of rows 1-4 at any radius and top-k: the wide kernel.
//
// Stands in for the TPU kernels of rows 1-4 where the tuned core
// (window_topk.cuh) does not apply, that is where the window offset r =
// ceil(radius - 1) exceeds its MAX_OFFSET (31) or topk exceeds its KMAX
// (32):
//   row 1 video_topk_affinity2 (vfs_tpu/ops/pallas_affinity_video.py:1037,
//         pallas_call :1124)            -> vfs_video_topk_wide[_bf16];
//   row 2 video_topk_affinity (v1, pallas_affinity_video.py:531, :642,
//         :682)                         -> the same entries (one function);
//   row 3 pallas_local_topk_attend (vfs_tpu/ops/pallas_attention.py:357,
//         :530)                         -> vfs_local_topk_wide*, each mode;
//   row 4 pallas_local_topk_attend_v2 (vfs_tpu/ops/pallas_attention_v2.py:
//         130, :191)                    -> vfs_local_topk_wide without its
//                                          epilogue (vals null).
// Neither Pallas kernel limits the radius or top-k, so neither may the
// port. The wrappers (ops/video_affinity*.py, ops/local_attention*.py)
// launch the core where window_geometry.core_takes(radius, topk) holds and
// this kernel otherwise: a dispatch on the operands' size between two
// hand-written kernels.
//
// What it computes: the core's functions, with its outputs, filler
// convention (score -1e30, weight 0, source the query's own cell in frame
// or slot 0) and tie order (the lowest (bank position, ky, kx)).
// - Video (rows 1/2): feats (T, h, w, C) fp32 or bf16. For every frame t >=
//   1 and query cell, the exact top-k of dot(q, key) * inv_tau over bank
//   positions j = 0..P (j = 0 frame 0; j = s + 1 ring slot s, holding f =
//   t-1 - ((t-1-s) mod P), live iff s <= t-1, so frame 0 enters twice
//   while t <= P) and keys with |dx| <= band[|dy|] inside the map. scores
//   (T, h, w, k) fp32 and src (T, h, w, k) int64 = f*h*w + ky*w + kx; rows
//   t = 0 are not written.
// - Local (rows 3/4): query (h, w, C) and bank (F, h, w, C), fp32 or bf16,
//   valid (F,) int32. The top-k over the valid slots by the Sel mode's key
//   (score_key<S>: the score, its bf16 rounding, or its packed
//   quantisation), then, where vals (F, h, w, K) fp32 is given, the
//   softmax and the weighted sum of the values (row 3's epilogue, shared
//   with local_topk_attend.cu). scores (h, w, k) are the keys for the exact
//   and bf16 modes and the exact scores of the picks for packed (the core's
//   re-score), src (h, w, k) int64 = f*h*w + ky*w + kx.
// Every score is the core's: an fmaf chain from 0 in ascending channel order
// (dot4, load_global4), times inv_tau, then score_key<S>. So where both
// kernels apply their lists, scores and logits are equal bit for bit
// (chip_smoke.py checks this at radius 12 / top-10).
//
// Design, simple on purpose (speed is later work). One warp per query cell,
// 8 warps (8 consecutive cells of a row, which read overlapping keys) a
// block. The warp walks the candidates in (bank position, dy, dx) order,
// rows (j, dy) inside the map with the dx range the band table gives (a
// device array of r + 1 ints: no fixed size), and deals them out 32 at a
// time, one per lane; each lane scores its key against the query from
// global memory (L1 serves the query, a broadcast, and the keys the block's
// warps share). A round that holds a candidate better than the list's last
// entry (the tau exit) is sorted by (-key, order key) with a warp bitonic
// sort and merged into the query's running top-k list: each candidate
// finds its place by a binary search in the list, each list entry by a
// binary search over the sorted round, and the merged list is written to a
// second buffer. The two lists (key, order key and, for packed, the exact
// score) lie in global scratch that the wrapper allocates, so no r and no
// k is too large for shared memory or registers. The order key (j, dy + r,
// dx + r) decides ties as the core's does.
//
// Bound (an H100 SXM): the core's, 2*C FLOPs per (query, in-map circle key,
// distinct live bank frame) on the fp32 CUDA cores at 67 TFLOP/s; the
// features are read once in a few MB, so operations bound it. This design
// scores frame 0 twice while t <= P and reads each key row once per lane
// from L1/L2 (16 bytes per 4 FMAs, uncoalesced across lanes), so it runs far
// below that bound: PERF.md §6 has its share.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (vfs_tpu_torch/ops/_build.py does this at first
// use). Interface: eight extern "C" functions (video: fp32 and bf16
// features; local: exact, bf16 scores and packed, each with fp32 and bf16
// features), launched on the caller's stream; they allocate nothing and
// return cudaGetLastError(), or cudaErrorInvalidValue for sizes whose int
// offsets would wrap.

#include "window_topk.cuh"

namespace {

using wtk::better;
using wtk::Sel;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // query cells (a warp each) a block

// A query's running top-k list in global scratch: topk keys, order keys
// and, for Sel::Packed, the exact scores (else s is null).
struct List {
  float* key;
  int* o;
  float* s;
};

// The core's score: an fmaf chain over ascending channels from 0, times
// inv_tau.
template <class T>
__device__ __forceinline__ float score_of(const T* __restrict__ q,
                                          const T* __restrict__ k, int C,
                                          float inv_tau) {
  float a = 0.f;
  for (int c = 0; c < C; c += 4)
    a = wtk::dot4(wtk::load_global4(q + c), wtk::load_global4(k + c), a);
  return a * inv_tau;
}

// Sort the warp's 32 (key, o, s) by better(), best in lane 0: a bitonic
// network over shuffles. Lanes without a candidate hold (-inf, INT_MAX).
__device__ __forceinline__ void sort32(float& key, int& o, float& s,
                                       int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ok = __shfl_xor_sync(FULL, key, stride);
      const int oo = __shfl_xor_sync(FULL, o, stride);
      const float os = __shfl_xor_sync(FULL, s, stride);
      // the lower lane of each pair keeps the better entry in a descending
      // run, the worse in an ascending one; the last run is descending
      const bool keep_better = ((lane & stride) == 0) == ((lane & size) == 0);
      if (keep_better ? better(ok, oo, key, o) : better(key, o, ok, oo)) {
        key = ok;
        o = oo;
        s = os;
      }
    }
  }
}

// Merge the sorted round (lane c holds candidate c) into list A, writing the
// first topk entries of the union to B. Candidate c lands at c + the number
// of A's entries at least as good; entry i of A at i + the number of
// candidates better than it (a binary search over the lanes).
template <Sel S>
__device__ void merge_round(float key, int o, float s, const List& A,
                            const List& B, int topk, int lane) {
  int lo = 0, hi = topk;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(key, o, A.key[mid], A.o[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  if (lane + lo < topk) {
    B.key[lane + lo] = key;
    B.o[lane + lo] = o;
    if constexpr (S == Sel::Packed) B.s[lane + lo] = s;
  }
  for (int base = 0; base < topk; base += 32) {  // warp-uniform
    const int i = base + lane;
    const bool have = i < topk;
    const float ak = have ? A.key[i] : -INFINITY;
    const int ao = have ? A.o[i] : INT_MAX;
    int n = 0;  // candidates better than (ak, ao): a prefix of the round
#pragma unroll
    for (int b = 32; b >= 1; b >>= 1) {
      const int idx = min(n + b, 32) - 1;
      const float ck = __shfl_sync(FULL, key, idx);
      const int co = __shfl_sync(FULL, o, idx);
      if (n + b <= 32 && better(ck, co, ak, ao)) n += b;
    }
    if (have && i + n < topk) {
      B.key[i + n] = ak;
      B.o[i + n] = ao;
      if constexpr (S == Sel::Packed) B.s[i + n] = A.s[i];
    }
  }
}

// One warp's exact top-k for the query cell (y, x) with features q over
// bank's frames. Bank needs count(), live(i), order(i) (the order key's
// bank position) and frame(i). A and B are the query's two list buffers;
// returns the one that holds the result (the other is free).
template <Sel S, class T, class Bank>
__device__ List warp_topk(const T* __restrict__ q, const Bank& bank, int y,
                          int x, int h, int w, int C, int r,
                          const int* __restrict__ band, float inv_tau,
                          int topk, List A, List B, int lane) {
  for (int i = lane; i < topk; i += 32) {
    A.key[i] = -INFINITY;
    A.o[i] = INT_MAX;
    if constexpr (S == Sel::Packed) A.s[i] = -INFINITY;
  }
  __syncwarp();
  const int span = 2 * r + 1;
  int filled = 0;          // candidates dealt in this round (uniform)
  int cj = 0, cdy = 0, cdx = 0;  // this lane's candidate
  auto flush = [&]() {
    float key = -INFINITY, s = -INFINITY;
    int o = INT_MAX;
    if (lane < filled) {
      const T* k = bank.frame(cj) + ((size_t)(y + cdy) * w + (x + cdx)) * C;
      s = score_of(q, k, C, inv_tau);
      key = wtk::score_key<S>(s);
      o = (bank.order(cj) * span + cdy + r) * span + cdx + r;
    }
    if (__any_sync(FULL, better(key, o, A.key[topk - 1], A.o[topk - 1]))) {
      sort32(key, o, s, lane);
      merge_round<S>(key, o, s, A, B, topk, lane);
      __syncwarp();  // B complete before anyone reads it as A
      const List t = A;
      A = B;
      B = t;
    }
    filled = 0;
  };
  const int dy_lo = max(-r, -y), dy_hi = min(r, h - 1 - y);
  for (int i = 0; i < bank.count(); ++i) {
    if (!bank.live(i)) continue;
    for (int dy = dy_lo; dy <= dy_hi; ++dy) {
      const int e = __ldg(band + abs(dy));
      const int end = min(e, w - 1 - x);
      for (int d = max(-e, -x); d <= end;) {
        const int m = min(32 - filled, end - d + 1);
        if (lane >= filled && lane < filled + m) {
          cj = i;
          cdy = dy;
          cdx = d + lane - filled;
        }
        filled += m;
        d += m;
        if (filled == 32) flush();
      }
    }
  }
  if (filled > 0) flush();
  return A;
}

// Rows 1/2's bank of query frame t: bank position j = 0..P.
template <class T>
struct VideoBank {
  const T* feats;
  size_t frame_stride;
  int t, P;
  __device__ int count() const { return P + 1; }
  __device__ bool live(int j) const { return j == 0 || j - 1 <= t - 1; }
  __device__ int order(int j) const { return j; }
  __device__ const T* frame(int j) const {
    const int f = j == 0 ? 0 : t - 1 - ((t - 1 - (j - 1)) % P);
    return feats + (size_t)f * frame_stride;
  }
};

// Rows 3/4's bank: the valid slots.
template <class T>
struct SlotBank {
  const T* bank;
  size_t frame_stride;
  const int* valid;
  int F;
  __device__ int count() const { return F; }
  __device__ bool live(int f) const { return valid[f] != 0; }
  __device__ int order(int f) const { return f; }
  __device__ const T* frame(int f) const {
    return bank + (size_t)f * frame_stride;
  }
};

// Warp g of the launch: query cell g % (h*w) of frame g / (h*w) + 1.
// list_s / list_o: 2 * topk entries a query.
template <class T>
__global__ void __launch_bounds__(32 * WARPS)
    video_wide_kernel(const T* __restrict__ feats, float* __restrict__ out_s,
                      long long* __restrict__ out_i, float* list_s,
                      int* list_o, int n, int h, int w, int C, int r,
                      const int* __restrict__ band, float inv_tau, int topk,
                      int P) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= n) return;  // uniform over the warp
  const int hw = h * w;
  const int t = g / hw + 1;
  const int q = g - (t - 1) * hw;
  const int y = q / w, x = q - y * w;
  const size_t fs = (size_t)hw * C;
  const size_t lists = (size_t)g * 2 * topk;
  const List A{list_s + lists, list_o + lists, nullptr};
  const List B{list_s + lists + topk, list_o + lists + topk, nullptr};
  const VideoBank<T> bank{feats, fs, t, P};
  const List L = warp_topk<Sel::Exact>(feats + (size_t)t * fs + (size_t)q * C,
                                       bank, y, x, h, w, C, r, band, inv_tau,
                                       topk, A, B, lane);
  const int span = 2 * r + 1;
  for (int i = lane; i < topk; i += 32) {
    const int o = L.o[i];
    float s = L.key[i];
    long long idx = q;
    if (o == INT_MAX) {  // filler: fewer than topk valid keys
      s = wtk::NEG_INF;
    } else {
      const int j = o / (span * span);
      const int rem = o - j * span * span;
      const int dy = rem / span - r;
      const int dx = rem % span - r;
      const int f = j == 0 ? 0 : t - 1 - ((t - 1 - (j - 1)) % P);
      idx = (long long)f * hw + (long long)(y + dy) * w + (x + dx);
    }
    const size_t out = ((size_t)t * hw + q) * topk + i;
    out_s[out] = s;
    out_i[out] = idx;
  }
}

// Warp q: query cell q. list_s / list_o (and list_x for packed): 2 * topk
// entries a query. vals null: selection only (row 4).
template <Sel S, class T>
__global__ void __launch_bounds__(32 * WARPS)
    local_wide_kernel(const T* __restrict__ query, const T* __restrict__ bank,
                      const float* __restrict__ vals,
                      const int* __restrict__ valid, float* __restrict__ out,
                      float* __restrict__ out_s, long long* __restrict__ out_i,
                      float* list_s, int* list_o, float* list_x, int F, int h,
                      int w, int C, int K, int r,
                      const int* __restrict__ band, float inv_tau, int topk) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int hw = h * w;
  if (q >= hw) return;  // uniform over the warp
  const int y = q / w, x = q - y * w;
  const size_t lists = (size_t)q * 2 * topk;
  const bool packed = S == Sel::Packed;
  List A{list_s + lists, list_o + lists, packed ? list_x + lists : nullptr};
  List B{list_s + lists + topk, list_o + lists + topk,
         packed ? list_x + lists + topk : nullptr};
  const SlotBank<T> slots{bank, (size_t)hw * C, valid, F};
  const List L = warp_topk<S>(query + (size_t)q * C, slots, y, x, h, w, C, r,
                              band, inv_tau, topk, A, B, lane);
  // the spare list takes each entry's score (then its weight) and cell
  const List W = L.key == A.key ? B : A;
  const int span = 2 * r + 1;
  for (int i = lane; i < topk; i += 32) {
    const int o = L.o[i];
    float s = wtk::NEG_INF;
    long long idx = q;
    if (o != INT_MAX) {  // else filler: fewer than topk valid keys
      const int f = o / (span * span);
      const int rem = o - f * span * span;
      const int dy = rem / span - r;
      const int dx = rem % span - r;
      idx = (long long)f * hw + (long long)(y + dy) * w + (x + dx);
      s = packed ? L.s[i] : L.key[i];
    }
    out_s[(size_t)q * topk + i] = s;
    out_i[(size_t)q * topk + i] = idx;
    W.key[i] = s;
    W.o[i] = (int)idx;  // F*h*w < INT_MAX
  }
  if (vals == nullptr) return;  // uniform: row 4's epilogue runs in PyTorch
  __syncwarp();
  if (lane == 0) {
    // the exact and bf16 keys are sorted, so their first is the max; the
    // exact scores of packed's picks are not
    float m = W.key[0];
    if (packed)
      for (int i = 1; i < topk; ++i) m = fmaxf(m, W.key[i]);
    wtk::softmax_weights(W.key, topk, m);
  }
  __syncwarp();
  for (int c = lane; c < K; c += 32)
    out[(size_t)q * K + c] = wtk::weighted_value(W.key, W.o, topk, vals, K, c);
}

bool bad_window(int r, int topk, long long positions) {
  const long long span = 2LL * r + 1;
  return r < 0 || topk < 1 || positions * span * span >= INT_MAX;
}

template <class V>
int video_entry(const void* feats, void* scores, void* src, void* list_s,
                void* list_o, int T, int h, int w, int C, int r,
                const void* band, float inv_tau, int topk, int P,
                void* stream) {
  const long long n = (long long)(T - 1) * h * w;
  if (T < 2 || h < 1 || w < 1 || C < wtk::Feat<V>::QUAD ||
      C % wtk::Feat<V>::QUAD != 0 || P < 1 || band == nullptr ||
      bad_window(r, topk, P + 1LL) || n + WARPS >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  video_wide_kernel<V><<<(int)((n + WARPS - 1) / WARPS), 32 * WARPS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(feats), static_cast<float*>(scores),
      static_cast<long long*>(src), static_cast<float*>(list_s),
      static_cast<int*>(list_o), (int)n, h, w, C, r,
      static_cast<const int*>(band), inv_tau, topk, P);
  return (int)cudaGetLastError();
}

template <Sel S, class T>
int local_entry(const void* query, const void* bank, const void* vals,
                const void* valid, void* out, void* scores, void* src,
                void* list_s, void* list_o, void* list_x, int F, int h,
                int w, int C, int K, int r, const void* band, float inv_tau,
                int topk, void* stream) {
  if (F < 1 || h < 1 || w < 1 || C < wtk::Feat<T>::QUAD ||
      C % wtk::Feat<T>::QUAD != 0 || (vals != nullptr && K < 1) ||
      band == nullptr || (S == Sel::Packed && list_x == nullptr) ||
      bad_window(r, topk, F) || (long long)F * h * w >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int hw = h * w;
  local_wide_kernel<S, T><<<(hw + WARPS - 1) / WARPS, 32 * WARPS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(query), static_cast<const T*>(bank),
      static_cast<const float*>(vals), static_cast<const int*>(valid),
      static_cast<float*>(out), static_cast<float*>(scores),
      static_cast<long long*>(src), static_cast<float*>(list_s),
      static_cast<int*>(list_o), static_cast<float*>(list_x), F, h, w, C, K,
      r, static_cast<const int*>(band), inv_tau, topk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows 1/2. band: the device array of the plan's r + 1 ints
// (window_geometry.band_tensor); list_s ((T-1)*h*w*2*topk floats) and
// list_o (as many ints) are scratch for the running lists.
int vfs_video_topk_wide(const void* feats, void* scores, void* src,
                        void* list_s, void* list_o, int T, int h, int w,
                        int C, int r, const void* band, float inv_tau,
                        int topk, int P, void* stream) {
  return video_entry<float>(feats, scores, src, list_s, list_o, T, h, w, C,
                            r, band, inv_tau, topk, P, stream);
}

// The same with bf16 features (C a multiple of 8).
int vfs_video_topk_wide_bf16(const void* feats, void* scores, void* src,
                             void* list_s, void* list_o, int T, int h,
                             int w, int C, int r, const void* band,
                             float inv_tau, int topk, int P, void* stream) {
  return video_entry<__nv_bfloat16>(feats, scores, src, list_s, list_o, T, h,
                                    w, C, r, band, inv_tau, topk, P, stream);
}

// Rows 3/4. vals null: no epilogue (out unused). list_s (h*w*2*topk floats),
// list_o (as many ints) and, for packed, list_x (as many floats) are
// scratch for the running lists; band as for the video entries. Every entry
// takes these arguments.
#define VFS_LOCAL_WIDE(NAME, SEL, TYPE)                                      \
  int NAME(const void* query, const void* bank, const void* vals,           \
           const void* valid, void* out, void* scores, void* src,           \
           void* list_s, void* list_o, void* list_x, int F, int h, int w,   \
           int C, int K, int r, const void* band, float inv_tau, int topk,  \
           void* stream) {                                                   \
    return local_entry<SEL, TYPE>(query, bank, vals, valid, out, scores,    \
                                  src, list_s, list_o, list_x, F, h, w, C,  \
                                  K, r, band, inv_tau, topk, stream);       \
  }

// Exact selection; fp32, then bf16 features (C a multiple of 8).
VFS_LOCAL_WIDE(vfs_local_topk_wide, Sel::Exact, float)
VFS_LOCAL_WIDE(vfs_local_topk_wide_bf16, Sel::Exact, __nv_bfloat16)
// scores_dtype='bfloat16'
VFS_LOCAL_WIDE(vfs_local_topk_wide_scores_bf16, Sel::Bf16, float)
VFS_LOCAL_WIDE(vfs_local_topk_wide_scores_bf16_bf16, Sel::Bf16,
               __nv_bfloat16)
// extract_mode='packed'
VFS_LOCAL_WIDE(vfs_local_topk_wide_packed, Sel::Packed, float)
VFS_LOCAL_WIDE(vfs_local_topk_wide_packed_bf16, Sel::Packed, __nv_bfloat16)

#undef VFS_LOCAL_WIDE

}  // extern "C"
