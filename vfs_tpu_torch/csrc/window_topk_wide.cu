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
// or slot 0) and tie order (the lowest (bank position, dy + r, dx + r)).
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
//   and bf16 modes and the exact scores of the picks for packed (re-scored,
//   as the core's stage 2 does), src (h, w, k) int64 = f*h*w + ky*w + kx.
// Every score is the core's: an fmaf chain from 0 in ascending channel
// order (dot4), carried across channel chunks in one accumulator, times
// inv_tau, then score_key<S>. So where both kernels apply, their lists,
// scores and logits are equal bit for bit (chip_smoke.py checks this at
// radius 12 / top-10 and at the core's edge, radius 32 / top-32).
//
// Bound (an H100 SXM): the core's, 2*C FLOPs per (query, in-map circle key,
// distinct live bank frame) on the fp32 CUDA cores at 67 TFLOP/s; the
// features are read once in a few MB, so operations bound it. PERF.md §6
// has the kernel's times and shares of that bound.
//
// What limited the first design (a warp a query, each lane scoring its own
// key row from global memory, at 2-2.5% of the bound), and what this one
// does:
// - Shared-memory and L1 wavefronts per FFMA. A lane's own key row made a
//   warp load touch 32 lines for 4 FMAs a lane (about 0.1 FFMA a
//   wavefront). Here a block owns the core's tile of 8 x 32 query cells
//   and stages, per (bank frame, key row, pass group, channel chunk), the
//   key row's window and the tile's queries with 16-byte cp.async into a
//   2-stage ring (the next chunk's copy in flight while the current one is
//   scored), in the core's 128-byte cells with the (cell / 4) mod 8
//   swizzle (wtk::slot). The FFMAs are the core's inner loop itself
//   (wtk::score_chunk): a thread holds 4 query rows x 4 columns x 4 dx,
//   8.5 FFMA a wavefront.
// - Any span. A warp computes one pass (16 dx) of one row group (4 query
//   rows) for one key row, as in the core. The window's 2r + 1 dx take
//   passes(r) = ceil((2r + 1) / 16) passes; the block's warps cover
//   pass_group of them (at most 6) for key_rows key rows at once, and
//   walk the passes in groups when passes(r) > 6 (r > 47). Each key row's
//   passes start at the band's edge over the tile's rows (wtk::pass_lo),
//   a key row's groups end with its band, and a warp whose pass lies
//   outside its row group's band skips it (warp-uniform). The key window
//   of a group is TW + 16 * pass_group cells whatever r or w.
// - Bounded shared memory. The scores of a (key row, pass group) go to a
//   slab of one row group's 128 queries x (16 * pass_group + 4) floats,
//   written and merged one row group at a time; the band (r + 1 ints) is
//   read from global memory (L1); top-k lists of up to 32 entries sit in
//   shared memory, longer ones in global scratch (L2) with their tails in
//   shared memory. window_geometry.WidePlan gives the bytes: at most
//   215,040 for any r, topk, C, w (the tests walk r 0..300, topk 1..512).
// - Filling the card on a scan step. Rows 3/4 split a step over (tile,
//   slot) blocks, as the core's slot_kernel does, and a second kernel
//   merges the slots' partial lists under the full comparator (a warp a
//   query, any topk) and runs the epilogue. Rows 1/2 have (T - 1) x tiles
//   blocks, each over its frame's bank.
// - Frame 0 once. While t <= P rows 1/2 score frame 0 once and insert each
//   of its candidates under j = 0 and j = 1 (the core's `twice`).
// - Top-k upkeep. After a (key row, pass group), each lane checks one
//   query's new keys against its list's last entry (the tau exit) and the
//   warp merges only the queries that beat it: lists of up to 32 entries
//   by the core's merge_query (an entry a lane in shared memory, a ballot
//   and a shuffle per insertion); longer ones, in global scratch, a round
//   of 32 candidates at a time by a warp bitonic sort (sort32) and a merge
//   into the query's second buffer (merge_round).
// Shared with the core (window_topk.cuh): the inner loop (score_chunk),
// the cell layout and copies (slot, cp_async16, Feat), the pass rule
// (pass_lo), the score key, the 32-entry list merge (merge_query), the
// slot bank and row 3's epilogue. Not shared, and why: the core's run()
// stages a whole key row (TW + 2r cells), keeps every pass's scores, its
// lists and a 32-entry band in shared memory and takes its passes as a
// template, which bounds r and topk by a block's 227 KB; making those
// runtime would touch the loop that rows 1-4 spend their time in. So the
// step walk, the staging of a key row's window, the slab and the list
// store are this kernel's own, and rows 1-4 compile as before
// (ab_kernels.py holds their outputs and times against a tree without
// this kernel's changes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (vfs_tpu_torch/ops/_build.py does this at first
// use). Interface: eight extern "C" functions (video: fp32 and bf16
// features; local: exact, bf16 scores and packed, each with fp32 and bf16
// features), launched on the caller's stream; they allocate nothing and
// return cudaGetLastError() or the first CUDA error, or
// cudaErrorInvalidValue for sizes whose int offsets would wrap or for a
// plan outside the kernel's block shapes.

#include "window_topk.cuh"

namespace {

using wtk::better;
using wtk::Sel;

constexpr unsigned FULL = 0xffffffffu;
constexpr int TH = wtk::TH;
constexpr int TW = wtk::TW;
constexpr int QN = wtk::QN;
constexpr int HALF = QN / 2;  // a row group's queries: the score slab's
constexpr int CW = wtk::CW;
constexpr int PASS_DX = wtk::PASS_DX;
constexpr int MAX_PASS_GROUP = 6;  // window_geometry.MAX_PASS_GROUP
constexpr int MAX_THREADS = 384;  // 170 registers a thread
constexpr int MERGE_WARPS = 4;  // stage 2: a warp a query

// What a launch shares with its blocks. g carries the shapes, r, span,
// topk, tiles_x and inv_tau (merge_query reads topk and span); the rest of
// g is unused: the band is the device array `band`.
struct Wide {
  wtk::Geometry g;
  const int* band;  // r + 1 ints: largest |dx| in the circle for |dy|
  int pg;           // passes a group (the plan's pass_group)
  int nkr;          // key rows a step (the plan's key_rows)
  int nt;           // threads: 2 row groups x pg x nkr warps
  int kc;           // staged cells of a key row's window: TW + 16 pg
  int slab_w;       // floats a query in the score slab: 16 pg + 4
  int sel;          // the lists' score key (Sel)
};

__host__ __device__ inline size_t stage_floats(const Wide& p) {
  return (size_t)(p.nkr * p.kc + QN) * CW;
}

// window_geometry.WidePlan.smem_bytes: the 2-stage ring, the slab, then
// the lists (topk <= KMAX: QN x topk keys and order keys) or, for lists in
// global scratch, each query's tail (key, order key) and buffer index.
inline size_t smem_bytes(const Wide& p) {
  const int topk = p.g.topk;
  return sizeof(float) *
         (2 * stage_floats(p) + (size_t)HALF * p.slab_w +
          (topk <= wtk::KMAX ? 2 * (size_t)QN * topk : 3 * (size_t)QN));
}

__device__ __forceinline__ float key_of(int sel, float s) {
  return sel == (int)Sel::Bf16     ? wtk::score_key<Sel::Bf16>(s)
         : sel == (int)Sel::Packed ? wtk::score_key<Sel::Packed>(s)
                                   : s;
}

// A top-k list in global scratch: topk keys and order keys.
struct GList {
  float* key;
  int* o;
};

// Sort the warp's 32 (key, o) by better(), best in lane 0: a bitonic
// network over shuffles. Lanes without a candidate hold (-inf, INT_MAX).
__device__ __forceinline__ void sort32(float& key, int& o, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ok = __shfl_xor_sync(FULL, key, stride);
      const int oo = __shfl_xor_sync(FULL, o, stride);
      // the lower lane of each pair keeps the better entry in a descending
      // run, the worse in an ascending one; the last run is descending
      const bool keep_better = ((lane & stride) == 0) == ((lane & size) == 0);
      if (keep_better ? better(ok, oo, key, o) : better(key, o, ok, oo)) {
        key = ok;
        o = oo;
      }
    }
  }
}

// Merge the sorted round (lane c holds candidate c) into list A, writing the
// first topk entries of the union to B. Candidate c lands at c + the number
// of A's entries at least as good; entry i of A at i + the number of
// candidates better than it (a binary search over the lanes).
__device__ void merge_round(float key, int o, const GList& A, const GList& B,
                            int topk, int lane) {
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
    }
  }
}

// The tile's running lists. GL false: in shared memory, [QN][topk] keys
// (ls) and order keys (lo). GL true: query q's two buffers in the unit's
// global scratch [h*w][2][topk] (gs, go), buffer cur[q] holding its list,
// its last entry in ts[q] / to[q] (shared memory).
template <bool GL>
struct Store {
  float* ls;
  int* lo;
  float* ts;
  int* to;
  int* cur;
  float* gs;
  int* go;
  int topk, y0, x0, w;

  // offset of query q's buffer b in the unit's scratch
  __device__ size_t at(int q, int b) const {
    const int qi = (y0 + q / TW) * w + x0 + q % TW;
    return ((size_t)qi * 2 + b) * topk;
  }
  __device__ float* keys(int q) const {
    if constexpr (GL) return gs + at(q, cur[q]);
    return ls + q * topk;
  }
  __device__ int* orders(int q) const {
    if constexpr (GL) return go + at(q, cur[q]);
    return lo + q * topk;
  }
  __device__ float tail_key(int q) const {
    if constexpr (GL) return ts[q];
    return ls[q * topk + topk - 1];
  }
  __device__ int tail_order(int q) const {
    if constexpr (GL) return to[q];
    return lo[q * topk + topk - 1];
  }
};

template <bool GL>
__device__ Store<GL> make_store(float* lists, float* gs, int* go, int y0,
                                int x0, const wtk::Geometry& g) {
  Store<GL> L{};
  L.topk = g.topk;
  L.y0 = y0;
  L.x0 = x0;
  L.w = g.w;
  if constexpr (GL) {
    L.ts = lists;
    L.to = reinterpret_cast<int*>(lists + QN);
    L.cur = reinterpret_cast<int*>(lists + 2 * QN);
    L.gs = gs;
    L.go = go;
  } else {
    L.ls = lists;
    L.lo = reinterpret_cast<int*>(lists + QN * g.topk);
  }
  return L;
}

// Empty lists (-inf, INT_MAX) for the tile's queries in the map.
template <bool GL>
__device__ void init_lists(const Store<GL>& L, const wtk::Geometry& g,
                           int nt) {
  for (int e = threadIdx.x; e < QN * L.topk; e += nt) {
    if constexpr (GL) {
      const int q = e / L.topk;
      if (L.y0 + q / TW >= g.h || L.x0 + q % TW >= g.w) continue;
      const size_t a = L.at(q, 0) + (e - q * L.topk);
      L.gs[a] = -INFINITY;
      L.go[a] = INT_MAX;
    } else {
      L.ls[e] = -INFINITY;
      L.lo[e] = INT_MAX;
    }
  }
  if constexpr (GL)
    for (int q = threadIdx.x; q < QN; q += nt) {
      L.ts[q] = -INFINITY;
      L.to[q] = INT_MAX;
      L.cur[q] = 0;
    }
}

// A list in global scratch: query q's candidates c (keys c.row[dx], order
// keys c.o_row + dx; with `twice` also at + span^2) that beat its tail, in
// rounds of 32 sorted by sort32 and merged into its other buffer.
__device__ void merge_global(int q, const wtk::Candidates& c, bool twice,
                             const Store<true>& L, int span2, int lane) {
  const int topk = L.topk;
  int cur = L.cur[q];
  float ts = L.ts[q];
  int to = L.to[q];
  const size_t b0 = L.at(q, 0), b1 = L.at(q, 1);
  for (int rep = 0; rep < (twice ? 2 : 1); ++rep) {
    for (int dx0 = c.dx_begin; dx0 <= c.dx_end; dx0 += 32) {
      const int dx = dx0 + lane;
      float key = -INFINITY;
      int o = INT_MAX;
      if (dx <= c.dx_end) {
        const float sc = c.row[dx];
        const int oc = c.o_row + dx + rep * span2;
        if (better(sc, oc, ts, to)) {
          key = sc;
          o = oc;
        }
      }
      if (!__any_sync(FULL, o != INT_MAX)) continue;
      sort32(key, o, lane);
      const size_t a = cur ? b1 : b0, b = cur ? b0 : b1;
      const GList A{L.gs + a, L.go + a}, B{L.gs + b, L.go + b};
      merge_round(key, o, A, B, topk, lane);
      __syncwarp();  // B complete before anyone reads it
      cur ^= 1;
      ts = B.key[topk - 1];
      to = B.o[topk - 1];
    }
  }
  __syncwarp();
  if (lane == 0) {
    L.cur[q] = cur;
    L.ts[q] = ts;
    L.to[q] = to;
  }
}

// Rows 1/2's bank of query frame t (row 1's VideoBank,
// video_topk_affinity.cu): j = 0 and the live ring slots, frame 0's ring
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

// One block's walk: the tile (y0, x0) of qframe against bank's frames
// (count, frame, order_j, twice as in window_topk.cuh's run()), leaving
// the tile's lists in L. The steps run over (frame i, key-row group kyg of
// nkr key rows, pass group pgi, channel chunk); warp wid computes pass
// wid % pg of the group, row group (wid / pg) % 2 and key row wid / (2 pg)
// of each step.
template <bool GL, class T, class Bank>
__device__ void walk(const T* __restrict__ qframe, const Bank& bank, int y0,
                     int x0, const Wide& p, float* smem, const Store<GL>& L) {
  constexpr int CC = wtk::Feat<T>::CELL;  // channels a chunk
  const wtk::Geometry& g = p.g;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nt = p.nt;
  const int nw = nt >> 5;
  const int pass = wid % p.pg;
  const int rg = (wid / p.pg) & 1;
  const int kk = wid / (2 * p.pg);
  const int xg = lane & 7;
  const int dg = lane >> 3;
  const int r = g.r;
  const int stage = (int)stage_floats(p);
  float* slab = smem + 2 * stage;  // [HALF][slab_w]
  const int ky_begin = max(0, y0 - r);
  const int ky_end = min(g.h, y0 + TH + r);
  const int n_kyg = (ky_end - ky_begin + p.nkr - 1) / p.nkr;
  const int n_chunks = (g.C + CC - 1) / CC;
  const int y_last = min(y0 + TH, g.h) - 1;  // the tile's last row in the map
  const int span2 = g.span * g.span;

  // The band's widest half-extent over rows ya..yb for key row ky: the band
  // never widens with |dy|, so the nearest row's; -1 when that lies
  // beyond r (or the range is empty).
  auto widest = [&](int ky, int ya, int yb) {
    const int d = ky < ya ? ya - ky : ky > yb ? ky - yb : 0;
    return ya <= yb && d <= r ? __ldg(p.band + d) : -1;
  };
  // Where key row ky's passes start, and how many run (the core's rule,
  // over the whole tile's rows).
  auto first_dx = [&](int ky) {
    return wtk::pass_lo(r, widest(ky, y0, y_last));
  };
  auto n_passes = [&](int ky) {
    const int e = widest(ky, y0, y_last);
    return e < 0 ? 0 : (e - wtk::pass_lo(r, e)) / PASS_DX + 1;
  };
  auto groups = [&](int kyg) {
    int n = 0;
    for (int k = 0; k < p.nkr; ++k) {
      const int ky = ky_begin + kyg * p.nkr + k;
      if (ky < ky_end) n = max(n, (n_passes(ky) + p.pg - 1) / p.pg);
    }
    return n;
  };

  struct Step {
    int i, kyg, pgi, chunk, ng;
  };
  auto advance = [&](Step& st) {
    if (++st.chunk < n_chunks) return true;
    st.chunk = 0;
    if (++st.pgi < st.ng) return true;
    st.pgi = 0;
    if (++st.kyg >= n_kyg) {
      st.kyg = 0;
      if (++st.i >= bank.count()) return false;
    }
    st.ng = groups(st.kyg);
    return true;
  };

  // Stage a step into buffer buf: each key row's window of kc cells from
  // key column x0 + its group's first dx, then the tile's queries, channels
  // [chunk * CC, + CC). Thread tid copies quad tid % 8 of cells tid / 8 +
  // k * nt / 8; quads past C and cells outside the map are zero-filled.
  const int quad = tid & 7;
  auto issue = [&](const Step& st, int buf) {
    const T* kframe = bank.frame(st.i);
    const int c = st.chunk * CC + wtk::Feat<T>::QUAD * quad;
    const bool c_ok = c < g.C;
    float4* stg = reinterpret_cast<float4*>(smem + buf * stage);
    const int ky0 = ky_begin + st.kyg * p.nkr;
    for (int k = 0; k < p.nkr; ++k) {
      const int ky = ky0 + k;
      const bool row_ok = c_ok && ky < ky_end;
      const int kx0 =
          row_ok ? x0 + first_dx(ky) + PASS_DX * p.pg * st.pgi : 0;
      const T* krow = kframe + (size_t)(row_ok ? ky : 0) * g.w * g.C + c;
      float4* dst = stg + k * p.kc * (CW / 4);
      for (int col = tid >> 3; col < p.kc; col += nt / 8) {
        const int kx = kx0 + col;
        const bool ok = row_ok && kx >= 0 && kx < g.w;
        wtk::cp_async16(dst + wtk::slot(col, quad),
                        ok ? krow + (size_t)kx * g.C : kframe, ok);
      }
    }
    float4* qst = stg + p.nkr * p.kc * (CW / 4);
    for (int q = tid >> 3; q < QN; q += nt / 8) {
      const int yy = y0 + q / TW;
      const int xx = x0 + q % TW;
      const bool ok = c_ok && yy < g.h && xx < g.w;
      wtk::cp_async16(qst + wtk::slot(q, quad),
                      ok ? qframe + ((size_t)yy * g.w + xx) * g.C + c
                         : qframe,
                      ok);
    }
    wtk::cp_async_commit();
  };

  // Row group hf's queries: each lane checks query wid + nw * lane against
  // its list's last entry over key row ky's candidates in this pass group
  // (dx from gdx0), and the warp merges those that beat it, one at a time.
  auto merge_half = [&](int ky, int hf, int gdx0, int oj, bool twice) {
    const int ql = wid + nw * lane;  // query of the row group
    const int q = hf * HALF + ql;
    const int y = y0 + 4 * hf + ql / TW;
    const int x = x0 + ql % TW;
    wtk::Candidates c{slab, 0, -1, 0};
    bool hit = false;
    if (ql < HALF && y < g.h && x < g.w && abs(ky - y) <= r) {
      const int dy = ky - y;
      const int er = __ldg(p.band + abs(dy));
      c.row = slab + ql * p.slab_w - gdx0;
      // in the band, the map and the group's window (plain comparisons: a
      // nested max(max(-er, -x), gdx0) here returned x on the card)
      const int band_lo = -min(er, x);
      const int band_hi = min(er, g.w - 1 - x);
      const int win_hi = gdx0 + PASS_DX * p.pg - 1;
      c.dx_begin = band_lo > gdx0 ? band_lo : gdx0;
      c.dx_end = band_hi < win_hi ? band_hi : win_hi;
      c.o_row = (oj * g.span + dy + r) * g.span + r;
      const float ts = L.tail_key(q);
      const int to = L.tail_order(q);
#pragma unroll 4
      for (int dx = c.dx_begin; dx <= c.dx_end; ++dx)
        hit |= better(c.row[dx], c.o_row + dx, ts, to);
    }
    unsigned hits = __ballot_sync(FULL, hit);
    while (hits) {
      const int b = __ffs(hits) - 1;
      hits &= hits - 1;
      const int qb = __shfl_sync(FULL, q, b);
      const wtk::Candidates cb{slab + (qb - hf * HALF) * p.slab_w - gdx0,
                               __shfl_sync(FULL, c.dx_begin, b),
                               __shfl_sync(FULL, c.dx_end, b),
                               __shfl_sync(FULL, c.o_row, b)};
      if constexpr (GL)
        merge_global(qb, cb, twice, L, span2, lane);
      else
        wtk::merge_query(qb, cb, twice, wtk::Lists{L.ls, L.lo}, g);
    }
  };

  // The thread's query cells (4 rg + m) * TW + 4 xg + i sit at row
  // qrow + (m * TW + i) * 8, swizzle xg (slot()).
  const int qrow = (4 * rg * TW + 4 * xg) * 8;

  Step cur{0, 0, 0, 0, groups(0)};
  Step nxt = cur;
  bool more = advance(nxt);
  issue(cur, 0);
  float acc[4][4][4];
  bool active = false;
  int krow = 0;  // row of the thread's first key cell 4K
  int ksw = 0;   // K mod 8: that cell's swizzle
  for (int s = 0;; ++s) {
    wtk::cp_async_wait<0>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    if (more) issue(nxt, (s + 1) & 1);

    const int ky0 = ky_begin + cur.kyg * p.nkr;
    if (cur.chunk == 0) {
      // Does this warp's pass lie inside its rows' band for its key row?
      const int ky = ky0 + kk;
      active = false;
      if (ky < ky_end) {
        const int lo = first_dx(ky);
        const int P = cur.pgi * p.pg + pass;
        const int e = widest(ky, y0 + 4 * rg, min(y0 + 4 * rg + 3, y_last));
        const int dx0 = lo + PASS_DX * P;
        active = P < n_passes(ky) && e >= 0 && dx0 <= e &&
                 dx0 + PASS_DX - 1 >= -e;
      }
      // key column of (query column 4 xg + i, dx0 + 4 dg + d) from the
      // window's first: 4K + i + d
      const int K = xg + 4 * pass + dg;
      krow = (kk * p.kc + 4 * K) * 8;
      ksw = K & 7;
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 0; d < 4; ++d) acc[m][i][d] = 0.f;
    }

    if (active) {  // warp-uniform
      const float4* kst =
          reinterpret_cast<const float4*>(smem + (s & 1) * stage);
      const float4* qst = kst + p.nkr * p.kc * (CW / 4);
      wtk::score_chunk<T>(acc, kst, qst, krow, ksw, qrow, xg,
                          (min(CC, g.C - cur.chunk * CC) + 3) / 4);
    }

    if (cur.chunk == n_chunks - 1) {
      // The group's key rows are complete. For each key row and row group
      // in turn, its active warps write their keys to the slab, query ql's
      // at ql * slab_w + dx - (the group's first dx); then the warps merge.
      const int oj = bank.order_j(cur.i);
      const bool twice = bank.twice(cur.i);
      bool first = true;
      for (int k = 0; k < p.nkr && ky0 + k < ky_end; ++k) {
        const int gdx0 = first_dx(ky0 + k) + PASS_DX * p.pg * cur.pgi;
        for (int hf = 0; hf < 2; ++hf) {
          if (y0 + 4 * hf > y_last) continue;  // uniform: no row in the map
          if (!first) __syncthreads();  // the merges read the slab
          first = false;
          if (active && kk == k && rg == hf) {
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int ql = m * TW + 4 * xg + i;
                *reinterpret_cast<float4*>(slab + ql * p.slab_w +
                                           PASS_DX * pass + 4 * dg) =
                    make_float4(key_of(p.sel, acc[m][i][0] * g.inv_tau),
                                key_of(p.sel, acc[m][i][1] * g.inv_tau),
                                key_of(p.sel, acc[m][i][2] * g.inv_tau),
                                key_of(p.sel, acc[m][i][3] * g.inv_tau));
              }
          }
          __syncthreads();
          merge_half(ky0 + k, hf, gdx0, oj, twice);
        }
      }
    }
    if (!more) break;
    cur = nxt;
    more = advance(nxt);
  }
  wtk::cp_async_wait<0>();
}

__device__ __forceinline__ void tile_of(int tile, const wtk::Geometry& g,
                                        int& y0, int& x0) {
  y0 = (tile / g.tiles_x) * TH;
  x0 = (tile % g.tiles_x) * TW;
}

__device__ __forceinline__ int tiles_of(const wtk::Geometry& g) {
  return g.tiles_x * ((g.h + TH - 1) / TH);
}

// Rows 1/2: block b is tile b % tiles of query frame b / tiles + 1; lists
// (GL) in [T - 1][h*w][2][topk] scratch. Decodes its lists to scores and
// sources as the core's store_video_lists does.
template <bool GL, class T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    video_wide_kernel(const T* __restrict__ feats, float* __restrict__ out_s,
                      long long* __restrict__ out_i, float* list_s,
                      int* list_o, int P, Wide p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const wtk::Geometry& g = p.g;
  const int tiles = tiles_of(g);
  const int t = blockIdx.x / tiles + 1;
  int y0, x0;
  tile_of(blockIdx.x % tiles, g, y0, x0);
  const long long hw = (long long)g.h * g.w;
  const size_t fs = (size_t)hw * g.C;
  const size_t unit = (size_t)(t - 1) * hw * 2 * g.topk;
  const Store<GL> L = make_store<GL>(
      smem + 2 * stage_floats(p) + HALF * p.slab_w,
      GL ? list_s + unit : nullptr, GL ? list_o + unit : nullptr, y0, x0, g);
  init_lists<GL>(L, g, p.nt);
  const VideoBank<T> bank{feats, fs, t, P, t <= P};
  walk<GL>(feats + (size_t)t * fs, bank, y0, x0, p, smem, L);
  __syncthreads();
  const int span2 = g.span * g.span;
  for (int e = threadIdx.x; e < QN * g.topk; e += p.nt) {
    const int q = e / g.topk;
    const int i = e - q * g.topk;
    const int y = y0 + q / TW;
    const int x = x0 + q % TW;
    if (y >= g.h || x >= g.w) continue;
    float s = L.keys(q)[i];
    const int o = L.orders(q)[i];
    long long idx;
    if (o == INT_MAX) {  // filler: fewer than topk valid keys
      s = wtk::NEG_INF;
      idx = (long long)y * g.w + x;
    } else {
      const int j = o / span2;
      const int rem = o - j * span2;
      const int dy = rem / g.span - g.r;
      const int dx = rem % g.span - g.r;
      const int f = j == 0 ? 0 : t - 1 - ((t - 1 - (j - 1)) % P);
      idx = f * hw + (long long)(y + dy) * g.w + (x + dx);
    }
    const size_t out = (((size_t)t * g.h + y) * g.w + x) * g.topk + i;
    out_s[out] = s;
    out_i[out] = idx;
  }
}

// Rows 3/4, stage 1: block b is tile b % tiles of slot b / tiles (a block
// of an invalid slot returns at once). Leaves slot f's list of query cell
// qi in buffer 0 of [F][h*w][2][topk] scratch (keys in list_s, order keys
// in list_o); GL lists run in both buffers.
template <bool GL, class T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    local_wide_kernel(const T* __restrict__ query, const T* __restrict__ bank,
                      const int* __restrict__ valid, float* list_s,
                      int* list_o, Wide p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const wtk::Geometry& g = p.g;
  const int tiles = tiles_of(g);
  const int f = blockIdx.x / tiles;
  if (valid[f] == 0) return;  // uniform over the block
  int y0, x0;
  tile_of(blockIdx.x % tiles, g, y0, x0);
  const long long hw = (long long)g.h * g.w;
  const size_t unit = (size_t)f * hw * 2 * g.topk;
  const Store<GL> L =
      make_store<GL>(smem + 2 * stage_floats(p) + HALF * p.slab_w,
                     list_s + unit, list_o + unit, y0, x0, g);
  init_lists<GL>(L, g, p.nt);
  const wtk::SlotBank<T> slot{bank + (size_t)f * hw * g.C, f};
  walk<GL>(query, slot, y0, x0, p, smem, L);
  __syncthreads();
  for (int e = threadIdx.x; e < QN * g.topk; e += p.nt) {
    const int q = e / g.topk;
    const int i = e - q * g.topk;
    if (y0 + q / TW >= g.h || x0 + q % TW >= g.w) continue;
    if constexpr (GL) {
      if (L.cur[q] == 0) continue;  // already in buffer 0
    }
    const size_t a = L.at(q, 0) + i;
    list_s[unit + a] = L.keys(q)[i];
    list_o[unit + a] = L.orders(q)[i];
  }
}

// The core's score of one key row: an fmaf chain over ascending channels
// from 0, times inv_tau (packed's re-score).
template <class T>
__device__ __forceinline__ float score_of(const T* __restrict__ q,
                                          const T* __restrict__ k, int C,
                                          float inv_tau) {
  float a = 0.f;
  for (int c = 0; c < C; c += 4)
    a = wtk::dot4(wtk::load_global4(q + c), wtk::load_global4(k + c), a);
  return a * inv_tau;
}

// Rows 3/4, stage 2: a warp a query merges the valid slots' sorted lists
// (buffer 0 of each slot) under the full comparator, in rounds of 32
// entries (merge_round) between the two buffers of the first valid slot,
// decodes the result (fillers: NEG_INF, the query's own cell), for packed
// re-scores the picks exactly, and, where vals is given, runs row 3's
// epilogue (softmax_weights, weighted_value) over the spare buffer.
template <bool PACKED, class T>
__global__ void __launch_bounds__(32 * MERGE_WARPS)
    local_wide_merge(const T* __restrict__ query, const T* __restrict__ bank,
                     const float* __restrict__ vals,
                     const int* __restrict__ valid, float* list_s,
                     int* list_o, float* __restrict__ out,
                     float* __restrict__ out_s, long long* __restrict__ out_i,
                     int F, int h, int w, int C, int K, int r, int topk,
                     float inv_tau) {
  const int lane = threadIdx.x & 31;
  const int hw = h * w;
  const int q = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (q >= hw) return;  // uniform over the warp
  const int y = q / w, x = q - y * w;
  auto buf = [&](int f, int b) {
    const size_t a = ((size_t)f * hw * 2 + (size_t)q * 2 + b) * topk;
    return GList{list_s + a, list_o + a};
  };
  int f0 = 0;
  while (f0 < F && __ldg(valid + f0) == 0) ++f0;
  GList A = buf(f0 < F ? f0 : 0, 0), B = buf(f0 < F ? f0 : 0, 1);
  if (f0 == F) {  // no valid slot: fillers only
    for (int i = lane; i < topk; i += 32) {
      A.key[i] = -INFINITY;
      A.o[i] = INT_MAX;
    }
    __syncwarp();
  }
  for (int f = f0 + 1; f < F; ++f) {
    if (__ldg(valid + f) == 0) continue;
    const GList part = buf(f, 0);
    for (int base = 0; base < topk; base += 32) {  // the list is sorted
      const int i = base + lane;
      const float key = i < topk ? part.key[i] : -INFINITY;
      const int o = i < topk ? part.o[i] : INT_MAX;
      if (!__any_sync(FULL, better(key, o, A.key[topk - 1], A.o[topk - 1])))
        break;
      merge_round(key, o, A, B, topk, lane);
      __syncwarp();  // B complete before anyone reads it as A
      const GList t = A;
      A = B;
      B = t;
    }
  }
  // decode; the spare list B takes each entry's score (then its weight)
  // and cell
  const int span = 2 * r + 1;
  for (int i = lane; i < topk; i += 32) {
    const int o = A.o[i];
    float s = wtk::NEG_INF;
    long long idx = q;
    if (o != INT_MAX) {  // else filler: fewer than topk valid keys
      const int f = o / (span * span);
      const int rem = o - f * span * span;
      const int dy = rem / span - r;
      const int dx = rem % span - r;
      idx = (long long)f * hw + (long long)(y + dy) * w + (x + dx);
      s = PACKED ? score_of(query + (size_t)q * C, bank + (size_t)idx * C, C,
                            inv_tau)
                 : A.key[i];
    }
    out_s[(size_t)q * topk + i] = s;
    out_i[(size_t)q * topk + i] = idx;
    B.key[i] = s;
    B.o[i] = (int)idx;  // F*h*w < INT_MAX
  }
  if (vals == nullptr) return;  // uniform: row 4's epilogue runs in PyTorch
  __syncwarp();
  if (lane == 0) {
    // the exact and bf16 keys are sorted, so their first is the max; the
    // exact scores of packed's picks are not
    float m = B.key[0];
    if (PACKED)
      for (int i = 1; i < topk; ++i) m = fmaxf(m, B.key[i]);
    wtk::softmax_weights(B.key, topk, m);
  }
  __syncwarp();
  for (int c = lane; c < K; c += 32)
    out[(size_t)q * K + c] = wtk::weighted_value(B.key, B.o, topk, vals, K, c);
}

bool bad_window(int r, int topk, long long positions) {
  const long long span = 2LL * r + 1;
  return r < 0 || topk < 1 || positions * span * span >= INT_MAX;
}

// The plan's block shape (window_geometry.WidePlan): pass_group 1..6,
// key_rows 1..4, at most MAX_THREADS threads.
bool bad_plan(int pg, int nkr) {
  return pg < 1 || pg > MAX_PASS_GROUP || nkr < 1 || nkr > 4 ||
         64 * pg * nkr > MAX_THREADS;
}

Wide make_wide(int h, int w, int C, int r, const void* band, float inv_tau,
               int topk, int pg, int nkr, Sel sel) {
  Wide p{};
  p.g.h = h;
  p.g.w = w;
  p.g.C = C;
  p.g.r = r;
  p.g.span = 2 * r + 1;
  p.g.topk = topk;
  p.g.tiles_x = (w + TW - 1) / TW;
  p.g.inv_tau = inv_tau;
  p.band = static_cast<const int*>(band);
  p.pg = pg;
  p.nkr = nkr;
  p.nt = 64 * pg * nkr;
  p.kc = TW + PASS_DX * pg;
  p.slab_w = PASS_DX * pg + 4;
  p.sel = (int)sel;
  return p;
}

template <class K, class... Args>
cudaError_t launch(K kernel, int blocks, const Wide& p, cudaStream_t stream,
                   Args... args) {
  const size_t smem = smem_bytes(p);
  const cudaError_t err = wtk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, p.nt, smem, stream>>>(args..., p);
  return cudaGetLastError();
}

template <class V>
int video_entry(const void* feats, void* scores, void* src, void* list_s,
                void* list_o, int T, int h, int w, int C, int r,
                const void* band, float inv_tau, int topk, int P, int pg,
                int nkr, void* stream) {
  const bool gl = topk > wtk::KMAX;
  const long long n = (long long)(T - 1) * h * w;
  if (T < 2 || h < 1 || w < 1 || C < wtk::Feat<V>::QUAD ||
      C % wtk::Feat<V>::QUAD != 0 || P < 1 || band == nullptr ||
      bad_window(r, topk, P + 1LL) || n >= INT_MAX || bad_plan(pg, nkr) ||
      (gl && (list_s == nullptr || list_o == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Wide p = make_wide(h, w, C, r, band, inv_tau, topk, pg, nkr,
                           Sel::Exact);
  const int blocks = (T - 1) * p.g.tiles_x * ((h + TH - 1) / TH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const V* f = static_cast<const V*>(feats);
  float* s = static_cast<float*>(scores);
  long long* i = static_cast<long long*>(src);
  float* ls = static_cast<float*>(list_s);
  int* lo = static_cast<int*>(list_o);
  return (int)(gl ? launch(video_wide_kernel<true, V>, blocks, p, st, f, s,
                           i, ls, lo, P)
                  : launch(video_wide_kernel<false, V>, blocks, p, st, f, s,
                           i, ls, lo, P));
}

template <Sel S, class T>
int local_entry(const void* query, const void* bank, const void* vals,
                const void* valid, void* out, void* scores, void* src,
                void* list_s, void* list_o, int F, int h, int w, int C,
                int K, int r, const void* band, float inv_tau, int topk,
                int pg, int nkr, void* stream) {
  if (F < 1 || h < 1 || w < 1 || C < wtk::Feat<T>::QUAD ||
      C % wtk::Feat<T>::QUAD != 0 || (vals != nullptr && K < 1) ||
      band == nullptr || list_s == nullptr || list_o == nullptr ||
      bad_window(r, topk, F) || (long long)F * h * w >= INT_MAX ||
      bad_plan(pg, nkr))
    return (int)cudaErrorInvalidValue;
  const Wide p = make_wide(h, w, C, r, band, inv_tau, topk, pg, nkr, S);
  const int blocks = F * p.g.tiles_x * ((h + TH - 1) / TH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* q = static_cast<const T*>(query);
  const T* b = static_cast<const T*>(bank);
  const int* ok = static_cast<const int*>(valid);
  float* ls = static_cast<float*>(list_s);
  int* lo = static_cast<int*>(list_o);
  const cudaError_t err =
      topk > wtk::KMAX
          ? launch(local_wide_kernel<true, T>, blocks, p, st, q, b, ok, ls,
                   lo)
          : launch(local_wide_kernel<false, T>, blocks, p, st, q, b, ok, ls,
                   lo);
  if (err != cudaSuccess) return (int)err;
  const int hw = h * w;
  local_wide_merge<S == Sel::Packed, T>
      <<<(hw + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS, 0, st>>>(
          q, b, static_cast<const float*>(vals), ok, ls, lo,
          static_cast<float*>(out), static_cast<float*>(scores),
          static_cast<long long*>(src), F, h, w, C, K, r, topk, inv_tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows 1/2. band: the device array of the plan's r + 1 ints
// (window_geometry.band_tensor); pass_group and key_rows: the plan's
// (WidePlan); list_s ((T-1)*h*w*2*topk floats) and list_o (as many ints)
// are scratch for the running lists where topk > 32, else unused (may be
// null).
int vfs_video_topk_wide(const void* feats, void* scores, void* src,
                        void* list_s, void* list_o, int T, int h, int w,
                        int C, int r, const void* band, float inv_tau,
                        int topk, int P, int pass_group, int key_rows,
                        void* stream) {
  return video_entry<float>(feats, scores, src, list_s, list_o, T, h, w, C,
                            r, band, inv_tau, topk, P, pass_group, key_rows,
                            stream);
}

// The same with bf16 features (C a multiple of 8).
int vfs_video_topk_wide_bf16(const void* feats, void* scores, void* src,
                             void* list_s, void* list_o, int T, int h,
                             int w, int C, int r, const void* band,
                             float inv_tau, int topk, int P, int pass_group,
                             int key_rows, void* stream) {
  return video_entry<__nv_bfloat16>(feats, scores, src, list_s, list_o, T, h,
                                    w, C, r, band, inv_tau, topk, P,
                                    pass_group, key_rows, stream);
}

// Rows 3/4. vals null: no epilogue (out unused). list_s (F*h*w*2*topk
// floats) and list_o (as many ints) are scratch for the slots' lists and
// the merge; band, pass_group and key_rows as for the video entries. Every
// entry takes these arguments.
#define VFS_LOCAL_WIDE(NAME, SEL, TYPE)                                      \
  int NAME(const void* query, const void* bank, const void* vals,           \
           const void* valid, void* out, void* scores, void* src,           \
           void* list_s, void* list_o, int F, int h, int w, int C, int K,   \
           int r, const void* band, float inv_tau, int topk, int pass_group, \
           int key_rows, void* stream) {                                     \
    return local_entry<SEL, TYPE>(query, bank, vals, valid, out, scores,    \
                                  src, list_s, list_o, F, h, w, C, K, r,    \
                                  band, inv_tau, topk, pass_group, key_rows, \
                                  stream);                                   \
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
