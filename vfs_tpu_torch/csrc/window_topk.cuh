// The windowed top-k core shared by the four kernels of the port:
//   row 1 video_topk_affinity.cu     (phase 1 of the decoupled propagation,
//         replacing video_topk_affinity2, pallas_affinity_video.py:1037);
//   row 2 video_topk_affinity_v1.cu  (the v1 engine's phase 1, replacing
//         video_topk_affinity, pallas_affinity_video.py:531);
//   row 3 local_topk_attend.cu       (one scan step, replacing
//         pallas_local_topk_attend, vfs_tpu/ops/pallas_attention.py:357);
//   row 4 local_topk_attend_v2.cu    (replacing pallas_local_topk_attend_v2,
//         vfs_tpu/ops/pallas_attention_v2.py:130).
// window_topk_wide.cu, the four rows' kernel where the core's limits (r <=
// MAX_OFFSET, topk <= KMAX) do not hold, shares its inner loop
// (score_chunk), the staged cell layout (slot, cp_async16, Feat), the pass
// rule (pass_lo), the score key (score_key), the list merge of up to KMAX
// entries (merge_query), dot4, the global loads (load_global4) and row 3's
// epilogue (softmax_weights, weighted_value), so that the two give the
// same lists and logits bit for bit where both apply.
//
// What it computes. A block owns a tile of TH x TW = 8 x 32 query cells of
// one query plane (h, w, C) and walks a list of bank frames (h, w, C). For
// every query (y, x) it keeps, in shared memory, the exact top-k of
//   score = dot(query[y, x], frame[ky, kx]) * inv_tau
// over the bank's frames and the keys with (dy, dx) = (ky - y, kx - x) in
// the circle (|dx| <= band[|dy|], the host's table of the float test
// float(dy^2 + dx^2) < radius^2) and in the map, under the full comparator:
// score descending, then order key (j, dy + r, dx + r) ascending. The list
// is exact whatever order the keys arrive in, so row 2, which walks the
// bank in another order than row 1, gives row 1's lists bit for bit; row 4
// runs row 3's stages and gives its lists too. Every score is an fmaf
// chain in ascending channel order from 0, times inv_tau.
//
// Feature types. The core stages fp32 or bf16 features (the JAX package's
// pallas_precision='bfloat16': the bank cast to bf16 after the L2
// normalisation, scored bf16 x bf16 with fp32 accumulation). A staged cell
// is 128 bytes either way: 32 fp32 channels or 64 bf16 channels, so a
// bf16 chunk moves half the bytes per channel from L2 and the stages, the
// swizzle and the shared-memory budget are unchanged. The inner loop
// reads a bf16 cell 4 channels (8 bytes) at a time from the same 16-byte
// quad slots and widens each value in registers (__bfloat1622float2)
// before the same fmaf chain in ascending channel order. A bf16 x bf16
// product is exact in fp32, so a bf16 launch gives the scores, lists and
// tie order of an fp32 launch on the widened features bit for bit.
// Widening costs one integer operation per channel loaded (92 per 256
// FFMAs of a thread's block). Tensor cores are not used: a wgmma bf16
// pre-score sums in another order and needs the exact re-rank of ROADMAP
// Queue 2 core item 5. A bf16 C must be a multiple of 8 (a 16-byte quad
// is fully inside or outside the channels; the wrappers raise ValueError
// otherwise); a C that is not a multiple of 64 leaves the last chunk's
// missing quads zero-filled, and the loop stops at the last channel.
//
// Bound. 2*C FLOPs per (query, in-map circle key, distinct bank frame): at
// the DAVIS shapes (60 x 107 cells, P = 20) 0.393 ms per frame or step at
// r18 and 3.356 ms at r50 on the fp32 CUDA cores of an H100 SXM (67
// TFLOP/s); the features are a few MB, so operations bound it, not bytes.
// What limits a design below that, and what this one does:
//
// - Shared-memory bandwidth. The SM serves one 128-byte wavefront per clock
//   and issues 4 FFMA warp-instructions per clock. A thread holds an
//   MQ x MX x MD = 4 x 4 x 4 register block: 4 query rows x 4 query columns
//   x 4 consecutive dx of one key row. Per 4 channels it loads its 16 query
//   cells (16 LDS.128) and the 7 key cells its 4 columns x 4 dx touch
//   (7 LDS.128, 4 live at a time), then runs 256 FFMAs. The warp's lanes
//   are 8 column groups x 4 dx groups. Cells are stored channel-minor, 32
//   fp32 or 64 bf16 channels (one 128-byte row) a cell, with the row's
//   16-byte quads XOR-swizzled by (cell / 4) mod 8: a query load has 8
//   distinct cells in 8 distinct bank groups (1 wavefront) and a key load
//   11 distinct cells (2 wavefronts). So 16 + 14 = 30 wavefronts feed 256
//   FFMA warp-instructions: 8.5 FFMA per wavefront, against 1 in the
//   first design (one float4 of keys per 4 FMAs, 4 wavefronts per
//   LDS.128). A bf16 load (LDS.64, half of a quad slot) touches the same
//   cells and bank groups, 64 and 88 bytes: the same counts.
// - Wasted entries. A warp's pass is 4 query rows x 32 columns x 16 dx of a
//   key row. For each key row and row group the block knows the band's
//   widest half-extent E over the group's rows; a warp whose pass starts
//   past E, or whose rows are all beyond r of the key row, skips the key
//   row's FMAs (warp-uniform), and the passes start at the band's edge
//   (aligned down to 4 columns from -r), not at -r. Key rows outside the
//   map are not walked. Computed pairs that count: 47.9% at r18 and 51.5%
//   at r50 on the DAVIS map (60 x 107 cells: the last column tile is 11 of
//   32 wide). The first design, one query row per warp and every dx of a
//   SPAN, wasted less (63.9% / 63.2% useful in row 1, 54.8% / 56.9% in
//   row 3) but fed each FFMA from shared memory at 1/8 of this rate. The
//   roles (row group, pass, key row) are dealt so that each of the SM's 4
//   schedulers gets every pass: skipped passes do not leave one idle.
// - L2 traffic. Queries are re-staged for every key row (a tile of C = 1024
//   channels does not fit shared memory), so NKR key rows (4 at r <= 15, 2
//   at r <= 23) share each staged query chunk, and the tile is 8 rows
//   tall: about 15.8 FLOP per L2 byte at r18 and at r50 for an interior
//   tile, against 5.9 and 8.7 for the first design (twice that in bf16).
// - Latency. Chunks of one cell (32 fp32 or 64 bf16 channels) go through
//   a ring of 2 stages with
//   16-byte cp.async (a warp copies 4 whole 128-byte cells); the next
//   chunk's copy is in flight while the current one is computed, with one
//   __syncthreads per chunk. One block of 16 (r18) or 12 (r50) warps runs
//   per SM: the stages, the score buffer and the lists take 174 KB at r18
//   and 169 KB at r50 (top-10).
// - Top-k upkeep. After a key row, each warp writes its scaled scores to a
//   score buffer in shared memory (16 STS.128 a thread). After a barrier,
//   each lane checks one query's in-band scores against its list's last
//   entry; the warp then merges, one query at a time, only the queries
//   with a score that beats it: the list, in shared memory, sits one entry
//   per lane and each such score goes to its place by a ballot and a
//   shuffle. Each list is touched by one warp at a time, so nothing is
//   locked. In a block's first key rows nearly every score enters (rows 3
//   and 4 score one slot per block, so their lists fill from empty in
//   every block); later ones mostly stop at the check. The check is the
//   tau exit of the per-frame TPU kernels generalised from a frame to a
//   key row; run<..., EXIT = false> skips it (row 2's 'sweep'
//   extraction), and every query with in-band candidates is merged: the
//   same lists, more merges.
//
// Score keys. run<..., S> keys its lists by score_key<S>(score): the score
// itself (Sel::Exact, every row's exact mode) or one of row 3's inexact
// selections (pallas_attention.py's scores_dtype='bfloat16' and
// extract_mode='packed'): Sel::Bf16 rounds the score to bf16 (round to
// nearest even, as astype(bf16)); Sel::Packed quantises it to
// rint(clip(s, -15, 15) * PACKED_SCALE), held as a float (JAX packs the
// same integer into an int32 beside 0xFFFF - its flat key column; that
// column runs in (slot, ky, kx) order, so the order key breaks its ties as
// the pack does). The key is applied where a warp writes its scores to the
// score buffer; the tau exit, the merges and better() then run unchanged
// on it. JAX's pack wraps int32 at s >= 14.99977 (qs = 32768); at tau =
// 0.07 with unit features |s| <= 14.29, and the key does not emulate it.
//
// Interface for the kernels that include it: run() leaves the tile's lists
// in shared memory (lists()); the caller reads them after __syncthreads().
// It returns the (query, key row) merges its warp ran, for a counter.
// store_video_lists (rows 1 and 2) decodes them to the video outputs.
// Rows 3 and 4 share their first stage, slot_kernel (launch_slots): one
// block per (tile, bank slot) writes the tile's lists over that slot to a
// partial-list buffer (store_lists), which merge_parts and decode_list
// reduce in a second stage.
//
// Ablation switches, all off in the package's build. `python3
// ab_kernels.py --ablate` builds rows 1 and 3 with one of them on
// (nvcc -DWTK_ABLATE=bit) and times them; their outputs are then wrong,
// only the time is read. The bits:
//   1   drop the inner loop (the shared-memory loads and the FFMAs);
//   2   drop the list merges (the scores still go to the score buffer);
//   4   drop the stage copies (cp.async is not issued);
//   8   drop the barrier of each chunk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#ifndef WTK_ABLATE
#define WTK_ABLATE 0
#endif

namespace wtk {

constexpr int TH = 8;              // query tile rows
constexpr int TW = 32;             // query tile columns
constexpr int QN = TH * TW;        // queries per block
constexpr int ROW_GROUPS = TH / 4; // 4 query rows per warp
constexpr int PASS_DX = 16;        // dx per warp pass: 4 dx groups x 4
constexpr int CW = 32;             // 4-byte words of a staged 128-byte cell
constexpr int STAGES = 2;
constexpr int KMAX = 32;
constexpr int MAX_OFFSET = 31;
constexpr float NEG_INF = -1e30f;  // filler score (softmax weight 0)

// What the core needs of a feature type: channels a cell (the stage's
// chunk), channels a 16-byte quad, and load4(): channels 4 * c4 .. + 3 of
// a staged cell as fp32, from its quad slots `row` (the cell's first
// float4) XOR-swizzled by sw.
template <class T>
struct Feat;

template <>
struct Feat<float> {
  static constexpr int CELL = 32;
  static constexpr int QUAD = 4;
  __device__ static __forceinline__ float4 load4(const float4* st, int row,
                                                 int c4, int sw) {
    return st[row + (c4 ^ sw)];
  }
};

template <>
struct Feat<__nv_bfloat16> {
  static constexpr int CELL = 64;
  static constexpr int QUAD = 8;
  __device__ static __forceinline__ float4 load4(const float4* st, int row,
                                                 int c4, int sw) {
    const uint2 v = reinterpret_cast<const uint2*>(
        st + row + ((c4 >> 1) ^ sw))[c4 & 1];
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

struct Band {
  int e[MAX_OFFSET + 1];  // largest |dx| in the circle for |dy| = 0..r
};

// Warp passes of PASS_DX dx that cover the window's 2r + 1 dx.
__host__ __device__ constexpr int passes(int r) {
  return (2 * r + 1 + PASS_DX - 1) / PASS_DX;
}

// What a launch shares with all its blocks: the shapes, r and the host's
// band table (vfs_tpu_torch/ops/window_geometry.py::circle_band), and
// what the core derives from r.
struct Geometry {
  int h, w, C;
  int r, span;      // largest offset, 2r + 1
  int key_cells;    // staged cells of a key row: its TW + 2r columns
  int score_width;  // floats per query in the score buffer
  int topk;
  int tiles_x;
  float inv_tau;
  Band band;
};

// Threads of a block with np passes and nkr key rows staged together.
__host__ __device__ constexpr int threads(int np, int nkr) {
  return 32 * ROW_GROUPS * np * nkr;
}

// Key rows staged together for np passes: as many as keep a block within
// 512 threads (registers within 128 a thread) and shared memory within
// 227 KB at topk = 32.
__host__ __device__ constexpr int key_rows(int np) {
  return np <= 2 ? 4 : np == 3 ? 2 : 1;
}

__host__ __device__ inline size_t stage_floats(const Geometry& g, int nkr) {
  return (size_t)(nkr * g.key_cells + QN) * CW;
}

inline size_t smem_bytes(const Geometry& g, int nkr) {
  return sizeof(float) * (STAGES * stage_floats(g, nkr) +
                          (size_t)QN * (g.score_width + 2 * g.topk));
}

// The kernels take 0 <= r <= MAX_OFFSET, 1 <= topk <= KMAX and a band
// (r + 1 host ints) that starts at r and never widens; false otherwise
// (the wrapper then gets cudaErrorInvalidValue).
inline bool check_band(int r, const int* band, int topk) {
  if (r < 0 || r > MAX_OFFSET || topk < 1 || topk > KMAX) return false;
  if (band[0] != r) return false;
  for (int dy = 1; dy <= r; ++dy)
    if (band[dy] < 0 || band[dy] > band[dy - 1]) return false;
  return true;
}

inline Geometry make_geometry(int h, int w, int C, int r, const int* band,
                              float inv_tau, int topk) {
  Geometry g;
  g.h = h;
  g.w = w;
  g.C = C;
  g.r = r;
  g.span = 2 * r + 1;
  // A lane whose pairs all lie outside the band or the map may read up to
  // cell 2r + 46 of its key row (a pass starts at most at r, and a lane
  // reads 4 x 7 + 12 + 6 cells past it): that lies in the next key row or
  // the queries of the same stage.
  g.key_cells = TW + 2 * r;
  g.score_width = PASS_DX * passes(r) + 4;
  g.topk = topk;
  g.tiles_x = (w + TW - 1) / TW;
  g.inv_tau = inv_tau;
  for (int i = 0; i <= MAX_OFFSET; ++i) g.band.e[i] = i <= r ? band[i] : -1;
  return g;
}

inline int tiles(const Geometry& g) {
  return g.tiles_x * ((g.h + TH - 1) / TH);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

enum class Sel { Exact, Bf16, Packed };
// fp32(65536 / 30), as JAX rounds pallas_attention.PACKED_SCALE
constexpr float PACKED_SCALE = 0x1.111112p+11f;

template <Sel S>
__device__ __forceinline__ float score_key(float s) {
  if constexpr (S == Sel::Bf16) {
    return __bfloat162float(__float2bfloat16_rn(s));
  } else if constexpr (S == Sel::Packed) {
    // a plain multiply (no FMA contraction), rounded half to even
    return rintf(__fmul_rn(fminf(fmaxf(s, -15.f), 15.f), PACKED_SCALE));
  } else {
    return s;
  }
}

__device__ __forceinline__ bool better(float s, int o, float ts, int to) {
  return s > ts || (s == ts && o < to);
}

// The float4 slot of quad `quad` of cell `cell` in a staged region: a cell
// is one 128-byte row of 8 quads of 16 bytes, XOR-swizzled by (cell / 4)
// mod 8.
__device__ __forceinline__ int slot(int cell, int quad) {
  return (cell << 3) | (quad ^ ((cell >> 2) & 7));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: the destination is zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a + q . k over one channel quad, in channel order
__device__ __forceinline__ float dot4(float4 q, float4 k, float a) {
  a = fmaf(q.x, k.x, a);
  a = fmaf(q.y, k.y, a);
  a = fmaf(q.z, k.z, a);
  return fmaf(q.w, k.w, a);
}

// Channels c .. c + 3 of a feature row in global memory as fp32 (C a
// multiple of a 16-byte quad's channels: the loads are aligned). Row 3's
// packed re-score and the wide kernel (window_topk_wide.cu) read whole rows
// with them, in the core's channel order.
__device__ __forceinline__ float4 load_global4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load_global4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The inner loop, shared with the wide kernel (window_topk_wide.cu): the
// thread's 4 x 4 x 4 register block over the first n4 channel quads of
// one staged chunk. Query cell (m, i) of the block sits at row qrow + (m *
// TW + i) * 8 of qst, swizzle xg; key cell 4K + j at row krow + j * 8 of
// kst, swizzle (K + j / 4) mod 8 (ksw = K mod 8): slot()'s layout.
// acc[m][i][d] += q(m, i) . key(4K + i + d), in ascending channel order.
template <class T>
__device__ __forceinline__ void score_chunk(float (&acc)[4][4][4],
                                            const float4* kst,
                                            const float4* qst, int krow,
                                            int ksw, int qrow, int xg,
                                            int n4) {
  for (int c4 = 0; c4 < n4; ++c4) {
    // key 4K + j: row krow + j * 8, swizzle (K + j / 4) mod 8
    const int sk[2] = {ksw, (ksw + 1) & 7};
    // keys 0..6 pass through the ring kv[j % 4]: column i reads keys
    // i..i+3, then key i + 4 takes key i's place
    float4 kv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kv[j] = Feat<T>::load4(kst, krow + j * 8, c4, sk[0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 qv =
            Feat<T>::load4(qst, qrow + (m * TW + i) * 8, c4, xg);
#pragma unroll
        for (int d = 0; d < 4; ++d)
          acc[m][i][d] = dot4(qv, kv[(i + d) % 4], acc[m][i][d]);
      }
      if (i < 3) kv[i] = Feat<T>::load4(kst, krow + (i + 4) * 8, c4, sk[1]);
    }
  }
}

// Where a row group's passes start: -e rounded down to a multiple of 4
// from -r, e the band's widest half-extent over the group's rows within r
// of the key row (window_geometry.pass_starts).
__device__ __forceinline__ int pass_lo(int r, int e) {
  return -r + 4 * ((r - e) / 4);
}

// The tile's top-k lists in shared memory after the stage ring and the
// score buffer: (score desc, order key asc), topk entries a query.
struct Lists {
  float* s;  // [QN][topk]
  int* o;    // [QN][topk]
};

__device__ __forceinline__ Lists lists(const Geometry& g, float* smem,
                                       int nkr) {
  float* s = smem + STAGES * stage_floats(g, nkr) + QN * g.score_width;
  return {s, reinterpret_cast<int*>(s + QN * g.topk)};
}

// Query q's candidates of key row ky in the score buffer: scores
// row[dx], order keys o_row + dx, for dx in [dx_begin, dx_end] (empty when
// q is outside the map or beyond r of ky).
struct Candidates {
  const float* row;
  int dx_begin, dx_end, o_row;
};

__device__ __forceinline__ Candidates candidates(int q, int ky, int oj,
                                                 int y0, int x0,
                                                 const int* band,
                                                 const float* sbuf,
                                                 const Geometry& g) {
  const int r = g.r;
  const int y = y0 + q / TW;
  const int x = x0 + q % TW;
  const int dy = ky - y;
  Candidates c{sbuf, 0, -1, 0};
  if (y >= g.h || x >= g.w || abs(dy) > r) return c;
  int e = -1;  // the row group's widest band, as its warps saw it
  for (int m = 0; m < 4; ++m) {
    const int yy = y0 + ((q / TW) & ~3) + m;
    const int ady = abs(ky - yy);
    if (yy < g.h && ady <= r) e = max(e, band[ady]);
  }
  const int er = band[abs(dy)];
  c.row = sbuf + q * g.score_width - pass_lo(r, e);
  c.dx_begin = max(-er, -x);
  c.dx_end = min(er, g.w - 1 - x);
  c.o_row = (oj * g.span + dy + r) * g.span + r;
  return c;
}

// One warp merges query q's candidates into its list. Lane l holds list
// entry l; each candidate that beats the list's last entry goes to the
// place the full comparator gives it, by a ballot and a shuffle. With
// `twice`, each candidate also stands at order key o + span^2 (frame 0's
// ring entry).
__device__ __noinline__ void merge_query(int q, const Candidates& c,
                                         bool twice, const Lists& L,
                                         const Geometry& g) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int topk = g.topk;
  const int span2 = g.span * g.span;
  float* ls = L.s + q * topk;
  int* lo = L.o + q * topk;
  float es = lane < topk ? ls[lane] : -INFINITY;  // this lane's entry
  int eo = lane < topk ? lo[lane] : INT_MAX;
  float tail_s = __shfl_sync(FULL, es, topk - 1);
  int tail_o = __shfl_sync(FULL, eo, topk - 1);
  for (int dx0 = c.dx_begin; dx0 <= c.dx_end; dx0 += 32) {
    const int dx = dx0 + lane;
    const bool in = dx <= c.dx_end;
    const float sc = in ? c.row[dx] : -INFINITY;
    const int o = c.o_row + dx;
    // (s, o + span2) never beats the tail unless (s, o) does
    unsigned want = __ballot_sync(FULL, in && better(sc, o, tail_s, tail_o));
    while (want) {
      const int b = __ffs(want) - 1;
      want &= want - 1;
      const float cs = __shfl_sync(FULL, sc, b);
      const int co = __shfl_sync(FULL, o, b);
      for (int k = 0; k < (twice ? 2 : 1); ++k) {
        const int oc = co + k * span2;
        if (!better(cs, oc, tail_s, tail_o)) continue;  // uniform
        const int pos = __popc(
            __ballot_sync(FULL, lane < topk && better(es, eo, cs, oc)));
        const float up_s = __shfl_up_sync(FULL, es, 1);
        const int up_o = __shfl_up_sync(FULL, eo, 1);
        if (lane == pos) {
          es = cs;
          eo = oc;
        } else if (lane > pos && lane < topk) {
          es = up_s;
          eo = up_o;
        }
        tail_s = __shfl_sync(FULL, es, topk - 1);
        tail_o = __shfl_sync(FULL, eo, topk - 1);
      }
    }
  }
  if (lane < topk) {
    ls[lane] = es;
    lo[lane] = eo;
  }
}

// The warps merge key row ky's candidates into the tile's lists. With
// EXIT, each lane first checks one query (wid + nwarps * lane) against its
// list's last entry and the warp merges, one at a time, only the queries
// with a candidate that beats it; without, every query with in-band
// candidates. Returns the number of queries the warp merged.
template <bool EXIT>
__device__ __forceinline__ int merge_row(int ky, int oj, bool twice, int y0,
                                         int x0, const int* band,
                                         const float* sbuf, const Lists& L,
                                         const Geometry& g, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x >> 5) + nwarps * lane;
  bool hit = false;
  Candidates c{sbuf, 0, -1, 0};
  if (q < QN) {
    c = candidates(q, ky, oj, y0, x0, band, sbuf, g);
    if (EXIT) {
      const float tail_s = L.s[q * g.topk + g.topk - 1];
      const int tail_o = L.o[q * g.topk + g.topk - 1];
#pragma unroll 4
      for (int dx = c.dx_begin; dx <= c.dx_end; ++dx)
        hit |= better(c.row[dx], c.o_row + dx, tail_s, tail_o);
    } else {
      hit = c.dx_begin <= c.dx_end;
    }
  }
  unsigned hits = __ballot_sync(0xffffffffu, hit);
  const int merged = __popc(hits);
  while (hits) {
    const int b = __ffs(hits) - 1;
    hits &= hits - 1;
    const int qb = __shfl_sync(0xffffffffu, q, b);
    merge_query(qb, candidates(qb, ky, oj, y0, x0, band, sbuf, g), twice, L,
                g);
  }
  return merged;
}

// Bank: the frames a block walks, of the query's feature type T. Needs
//   int count() const                 number of frames walked
//   const T* frame(int i) const       frame i's (h, w, C) plane
//   int order_j(int i) const          j of frame i in the order key
//   bool twice(int i) const           frame i also stands at j + 1
// (row 1's frame 0 while t <= P: scored once, inserted under both j).
//
// NP: passes per row group; NKR: key rows staged together, which share
// each staged query chunk; EXIT: merge_row's check against the lists' last
// entries; S: the lists' score key (score_key). The block has threads(NP, NKR) >= QN threads; each warp
// computes one (row group, pass, key row) of each group. The tile's lists
// end in shared memory (lists()); the caller reads them after a
// __syncthreads(). Returns the (query, key row) merges the calling warp
// ran (the same in all its lanes).
template <int NP, int NKR, bool EXIT = true, Sel S = Sel::Exact, class T,
          class Bank>
__device__ int run(const T* __restrict__ qframe, const Bank& bank, int y0,
                   int x0, const Geometry& g, float* smem) {
  constexpr int NT = threads(NP, NKR);
  constexpr int CC = Feat<T>::CELL;  // channels a stage
  static_assert(NT >= QN, "merge_row gives each query a lane");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  // The warp's role. Warp wid runs on scheduler wid % 4; the roles are
  // dealt so that each scheduler gets every pass (the last passes are the
  // ones most often skipped) and both row groups.
  const int role = NP == 3 ? wid : (wid & ~3) | ((wid + (wid >> 2)) & 3);
  const int pass = role % NP;
  const int rg = (role / NP) % ROW_GROUPS;
  const int kk = role / (ROW_GROUPS * NP);
  const int xg = lane & 7;
  const int dg = lane >> 3;
  const int r = g.r;
  const int KC = TW + 2 * r;  // staged key columns: kx = x0 - r + col
  const int topk = g.topk;
  const int stage = (int)stage_floats(g, NKR);
  float* sbuf = smem + STAGES * stage;  // [QN][score_width]

  __shared__ int band[MAX_OFFSET + 1];
#pragma unroll
  for (int i = 0; i <= MAX_OFFSET; ++i)  // constant indices into the param
    if (tid == i) band[i] = g.band.e[i];

  const Lists L = lists(g, smem, NKR);
  for (int i = tid; i < QN * topk; i += NT) {
    L.s[i] = -INFINITY;
    L.o[i] = INT_MAX;
  }

  const int ky_begin = max(0, y0 - r);
  const int ky_end = min(g.h, y0 + TH + r);
  const int n_kyg = (ky_end - ky_begin + NKR - 1) / NKR;
  const int n_chunks = (g.C + CC - 1) / CC;
  const int steps = bank.count() * n_kyg * n_chunks;

  // Stage step s: the group's NKR key rows (KC columns each) and the QN
  // queries, channels [c0, c0 + CC). Thread tid copies quad tid % 8 of
  // cells tid / 8 + k * NT / 8, so a warp copies 4 whole 128-byte cells;
  // quads past C, cells past the map and key rows past ky_end are
  // zero-filled.
  const int quad = tid & 7;
  auto issue = [&](int s) {
    if (!(WTK_ABLATE & 4) && s < steps) {
      const int chunk = s % n_chunks;
      const int rest = s / n_chunks;
      const int ky0 = ky_begin + (rest % n_kyg) * NKR;
      const T* kframe = bank.frame(rest / n_kyg);
      const int c = chunk * CC + Feat<T>::QUAD * quad;
      const bool c_ok = c < g.C;
      float4* st = reinterpret_cast<float4*>(smem + (s % STAGES) * stage);
      float4* qst = st + NKR * g.key_cells * (CW / 4);
      const T* krow = kframe + (size_t)ky0 * g.w * g.C + c;
      int krow_i = 0;
      int col = tid >> 3;
      for (int cell = tid >> 3; cell < NKR * KC; cell += NT / 8) {
        while (col >= KC) {  // at most NKR times over the loop
          col -= KC;
          ++krow_i;
        }
        const int kx = x0 - r + col;
        const bool ok =
            c_ok && ky0 + krow_i < ky_end && kx >= 0 && kx < g.w;
        cp_async16(st + krow_i * g.key_cells * (CW / 4) + slot(col, quad),
                   ok ? krow + ((size_t)krow_i * g.w + kx) * g.C : kframe,
                   ok);
        col += NT / 8;
      }
      for (int q = tid >> 3; q < QN; q += NT / 8) {
        const int yy = y0 + q / TW;
        const int xx = x0 + q % TW;
        const bool ok = c_ok && yy < g.h && xx < g.w;
        cp_async16(qst + slot(q, quad),
                   ok ? qframe + ((size_t)yy * g.w + xx) * g.C + c : qframe,
                   ok);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // The thread's query cells (4 rg + m) * TW + 4 xg + i sit at row
  // qrow + (m * TW + i) * 8, swizzle xg (slot()).
  const int qrow = (4 * rg * TW + 4 * xg) * 8;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  float acc[4][4][4];
  int merged = 0;
  bool active = false;
  int dx0 = 0;    // the pass's first dx
  int krow = 0;   // row of the thread's first key cell 4K
  int ksw = 0;    // K mod 8: that cell's swizzle
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    if (!(WTK_ABLATE & 8))
      __syncthreads();  // step s landed; step s - 1's stage is free
    issue(s + STAGES - 1);

    const int chunk = s % n_chunks;
    const int rest = s / n_chunks;
    const int ky0 = ky_begin + (rest % n_kyg) * NKR;
    if (chunk == 0) {
      // Is this warp's pass inside the band of its rows for key row ky?
      const int ky = ky0 + kk;
      int e = -1;
      if (ky < ky_end) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int y = y0 + 4 * rg + m;
          const int ady = abs(ky - y);
          if (y < g.h && ady <= r) e = max(e, band[ady]);
        }
      }
      dx0 = pass_lo(r, e) + PASS_DX * pass;
      active = e >= 0 && dx0 <= e;
      // key column of (query column 4 xg + i, dx0 + 4 dg + d): 4K + i + d
      const int kq = (dx0 + r) / 4 + dg + xg;
      krow = (kk * g.key_cells + 4 * kq) * 8;
      ksw = kq & 7;
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 0; d < 4; ++d) acc[m][i][d] = 0.f;
    }

    if (!(WTK_ABLATE & 1) && active) {  // warp-uniform
      const float4* kst =
          reinterpret_cast<const float4*>(smem + (s % STAGES) * stage);
      const float4* qst = kst + NKR * g.key_cells * (CW / 4);
      score_chunk<T>(acc, kst, qst, krow, ksw, qrow, xg,
                     (min(CC, g.C - chunk * CC) + 3) / 4);
    }
    if (chunk != n_chunks - 1) continue;

    // The group's key rows are complete. For each in turn, its active
    // warps write their scaled scores to the score buffer, query q's at
    // q * score_width + dx - (its row group's pass start); then the warps
    // take the tile's queries in turn and merge each one's in-band scores
    // into its list.
    const int ji = rest / n_kyg;
    const int oj = bank.order_j(ji);
    const bool twice = bank.twice(ji);
    for (int k = 0; k < NKR; ++k) {
      if (k > 0) __syncthreads();  // the merges read key row k - 1
      if (active && kk == k) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = (4 * rg + m) * TW + 4 * xg + i;
            *reinterpret_cast<float4*>(sbuf + q * g.score_width +
                                       PASS_DX * pass + 4 * dg) =
                make_float4(score_key<S>(acc[m][i][0] * g.inv_tau),
                            score_key<S>(acc[m][i][1] * g.inv_tau),
                            score_key<S>(acc[m][i][2] * g.inv_tau),
                            score_key<S>(acc[m][i][3] * g.inv_tau));
          }
      }
      __syncthreads();
      if (!(WTK_ABLATE & 2) && ky0 + k < ky_end)
        merged += merge_row<EXIT>(ky0 + k, oj, twice, y0, x0, band, sbuf, L,
                                  g, NT / 32);
    }
  }
  cp_async_wait<0>();
  return merged;
}

// Rows 1 and 2: decode the tile's lists of query frame t to scores and
// sources (T, h, w, topk). Bank position j = 0 is frame 0, j = s + 1 ring
// slot s, which holds f = t-1 - ((t-1-s) mod P); src = f*h*w + ky*w + kx;
// fillers (fewer than topk valid keys) score NEG_INF and point at the
// query's own cell in frame 0. Call after __syncthreads().
template <int NT>
__device__ void store_video_lists(const Lists& L, int t, int P, int y0,
                                  int x0, const Geometry& g,
                                  float* __restrict__ out_s,
                                  long long* __restrict__ out_i) {
  const long long hw = (long long)g.h * g.w;
  const int span2 = g.span * g.span;
  for (int e = threadIdx.x; e < QN * g.topk; e += NT) {
    const int q = e / g.topk;
    const int y = y0 + q / TW;
    const int x = x0 + q % TW;
    if (y >= g.h || x >= g.w) continue;
    float s = L.s[e];
    const int o = L.o[e];
    long long idx;
    if (o == INT_MAX) {  // filler: fewer than k valid keys
      s = NEG_INF;
      idx = (long long)y * g.w + x;
    } else {
      const int j = o / span2;
      const int rem = o - j * span2;
      const int dy = rem / g.span - g.r;
      const int dx = rem % g.span - g.r;
      const int f = j == 0 ? 0 : t - 1 - ((t - 1 - (j - 1)) % P);
      idx = f * hw + (long long)(y + dy) * g.w + (x + dx);
    }
    const size_t out = (((size_t)t * g.h + y) * g.w + x) * g.topk +
                       (e - q * g.topk);
    out_s[out] = s;
    out_i[out] = idx;
  }
}

// Rows 3 and 4, stage 1: the tile's lists to part p of part_s / part_o
// (parts, h, w, topk), raw: empty entries stay (-inf, INT_MAX). Call after
// __syncthreads().
template <int NT>
__device__ void store_lists(const Lists& L, int p, int y0, int x0,
                            const Geometry& g, float* __restrict__ part_s,
                            int* __restrict__ part_o) {
  for (int e = threadIdx.x; e < QN * g.topk; e += NT) {
    const int q = e / g.topk;
    const int y = y0 + q / TW;
    const int x = x0 + q % TW;
    if (y >= g.h || x >= g.w) continue;
    const size_t out = (((size_t)p * g.h + y) * g.w + x) * g.topk +
                       (e - q * g.topk);
    part_s[out] = L.s[e];
    part_o[out] = L.o[e];
  }
}

// One bank slot: rows 3 and 4's first stage.
template <class T>
struct SlotBank {
  const T* frame_;
  int f;
  __device__ int count() const { return 1; }
  __device__ int order_j(int) const { return f; }
  __device__ bool twice(int) const { return false; }
  __device__ const T* frame(int) const { return frame_; }
};

// Rows 3 and 4, stage 1: the tile's top-k lists over slot blockIdx.y to
// part_s / part_o (F, h*w, topk); empty entries are (-inf, INT_MAX). A
// block of an invalid slot returns at once (stage 2 skips the slot too).
// COUNT: add the warps' (query, key row) merges to merge_count; the
// uncounted instance carries no count. S: the lists' score key.
template <int NP, bool COUNT, class T, Sel S = Sel::Exact,
          int NKR = key_rows(NP), int NT = threads(NP, NKR)>
__global__ void __launch_bounds__(NT, 1)
    slot_kernel(const T* __restrict__ query, const T* __restrict__ bank,
                const int* __restrict__ valid, float* __restrict__ part_s,
                int* __restrict__ part_o, Geometry g,
                unsigned long long* __restrict__ merge_count) {
  extern __shared__ float4 smem4[];
  const int f = blockIdx.y;
  if (valid[f] == 0) return;  // uniform over the block
  const int y0 = (blockIdx.x / g.tiles_x) * TH;
  const int x0 = (blockIdx.x % g.tiles_x) * TW;
  const SlotBank<T> slot{bank + (size_t)f * g.h * g.w * g.C, f};
  float* smem = reinterpret_cast<float*>(smem4);
  const int merged = run<NP, NKR, true, S>(query, slot, y0, x0, g, smem);
  __syncthreads();
  store_lists<NT>(lists(g, smem, NKR), f, y0, x0, g, part_s, part_o);
  if (COUNT && (threadIdx.x & 31) == 0)
    atomicAdd(merge_count, (unsigned long long)merged);
}

template <int NP, bool COUNT, Sel S, class T>
cudaError_t launch_slots_np(const T* query, const T* bank, const int* valid,
                            float* part_s, int* part_o, int F,
                            const Geometry& g,
                            unsigned long long* merge_count,
                            cudaStream_t stream) {
  auto kernel = slot_kernel<NP, COUNT, T, S>;
  const size_t smem = smem_bytes(g, key_rows(NP));
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles(g), F);
  kernel<<<grid, threads(NP, key_rows(NP)), smem, stream>>>(
      query, bank, valid, part_s, part_o, g, merge_count);
  return cudaGetLastError();
}

// Launch stage 1 over F slots on stream, for g.r's passes; T is the
// features' type (float or __nv_bfloat16), S the lists' score key.
template <bool COUNT, Sel S = Sel::Exact, class T>
cudaError_t launch_slots(const T* query, const T* bank, const int* valid,
                         float* part_s, int* part_o, int F,
                         const Geometry& g, unsigned long long* merge_count,
                         cudaStream_t stream) {
  switch (passes(g.r)) {
    case 1: return launch_slots_np<1, COUNT, S>(query, bank, valid, part_s,
                                                part_o, F, g, merge_count,
                                                stream);
    case 2: return launch_slots_np<2, COUNT, S>(query, bank, valid, part_s,
                                                part_o, F, g, merge_count,
                                                stream);
    case 3: return launch_slots_np<3, COUNT, S>(query, bank, valid, part_s,
                                                part_o, F, g, merge_count,
                                                stream);
    default: return launch_slots_np<4, COUNT, S>(query, bank, valid, part_s,
                                                 part_o, F, g, merge_count,
                                                 stream);
  }
}

// Insert (s, o) into the sorted list (ls, lo) of length topk, dropping its
// last entry; the caller checked that (s, o) beats that entry. Not inlined:
// one copy serves every call site, and insertions are rare next to the
// candidates that only meet the threshold.
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

// Rows 3 and 4, stage 2, one thread per query q of hw: the exact top-k
// (ls, lo) of the sorted partial lists part_s / part_o (parts, hw, topk)
// of the parts p with use(p), merged in part order under the full
// comparator (the order keys make the result the same in any order).
template <class Use>
__device__ __forceinline__ void merge_parts(const float* __restrict__ part_s,
                                            const int* __restrict__ part_o,
                                            int parts, Use use, int hw, int q,
                                            int topk, float* ls, int* lo) {
  for (int i = 0; i < topk; ++i) {
    ls[i] = -INFINITY;
    lo[i] = INT_MAX;
  }
  for (int p = 0; p < parts; ++p) {
    if (!use(p)) continue;
    const size_t base = ((size_t)p * hw + q) * topk;
    for (int i = 0; i < topk; ++i) {
      const float s = part_s[base + i];
      const int o = part_o[base + i];
      // each list is sorted: once an entry misses, the rest miss too
      if (!better(s, o, ls[topk - 1], lo[topk - 1])) break;
      insert(ls, lo, topk, s, o);
    }
  }
}

// Decode query q = (y, x)'s merged list: the order key (f, dy + r, dx + r)
// of entry i becomes the cell index f*h*w + ky*w + kx, computed in 64 bits;
// fillers become (NEG_INF, q). Writes both to out_s / out_i [q * topk,
// + topk) and leaves the score in ls[i] and the index's low 32 bits in
// lo[i]: the index itself where F*h*w < 2^31, as row 3's entry requires for
// its value gather.
__device__ __forceinline__ void decode_list(float* ls, int* lo, int topk,
                                            int q, int y, int x, int w,
                                            int hw, int r,
                                            float* __restrict__ out_s,
                                            long long* __restrict__ out_i) {
  const int span = 2 * r + 1;
  const size_t base = (size_t)q * topk;
  for (int i = 0; i < topk; ++i) {
    long long idx = q;
    if (lo[i] == INT_MAX) {  // filler: fewer than k valid keys
      ls[i] = NEG_INF;
    } else {
      const int o = lo[i];
      const int f = o / (span * span);
      const int rem = o - f * span * span;
      const int dy = rem / span - r;
      const int dx = rem % span - r;
      idx = (long long)f * hw + (long long)(y + dy) * w + (x + dx);
    }
    lo[i] = (int)idx;
    out_s[base + i] = ls[i];
    out_i[base + i] = idx;
  }
}

// Row 3's epilogue, shared by local_topk_attend.cu's merge stage and the
// wide kernel so that both give the same logits bit for bit. ls[0..topk):
// one query's scores in list order (NEG_INF for fillers), m their max; ls
// becomes the softmax weights.
__device__ __forceinline__ void softmax_weights(float* ls, int topk,
                                                float m) {
  float z = 0.f;
  for (int i = 0; i < topk; ++i) {
    ls[i] = expf(ls[i] - m);
    z += ls[i];
  }
  for (int i = 0; i < topk; ++i) ls[i] /= z;
}

// Channel c of the weighted sum of the value rows lo[i] of vals (K
// channels a row), summed in list order.
__device__ __forceinline__ float weighted_value(const float* ls,
                                                const int* lo, int topk,
                                                const float* __restrict__ vals,
                                                int K, int c) {
  float a = 0.f;
  for (int i = 0; i < topk; ++i)
    a = fmaf(ls[i], vals[(size_t)lo[i] * K + c], a);
  return a;
}

}  // namespace wtk
