// Device code shared by the per-frame top-k kernels: video_topk_affinity_v1.cu
// (the v1 whole-video engine) and local_topk_attend_v2.cu (the per-step
// attention v2). Both port TPU kernels whose algorithm is "score one bank
// frame, extract that frame's top-k by passes, merge into a running list":
// _make_video_kernel's 'perframe' extraction
// (vfs_tpu/ops/pallas_affinity_video.py:171-251) and pallas_attention_v2's
// frame_body (vfs_tpu/ops/pallas_attention_v2.py:73-115).
//
// A block owns a tile of TQH x TQW query cells of one query frame and, for
// one bank frame at a time:
// 1. score_tile: the tile's score block S = Q K^T over the tile's dilated key
//    window (TQH + 2r rows x TQW + 2r columns, kb keys) into shared memory.
//    Each thread accumulates an MQ x MK (8 queries x 4 keys) register block
//    of S; channels are staged through shared memory CC at a time, and the
//    next chunk's global loads are in flight while the current one is
//    computed. Every entry is summed with fmaf in ascending
//    channel order from 0, the arithmetic of video_topk_affinity.cu and
//    local_topk_attend.cu, so a (query, key) pair scores bit for bit alike
//    in every kernel of the package. Entries outside the query's circle,
//    outside the map, or of a query outside the map are -inf.
// 2. extract_merge: one warp per query runs up to k passes of (max, first
//    window index) over the query's row of S and merges each pass's winner
//    into the query's running list, held one entry per lane, under the full
//    comparator (score desc, order key asc). The order key encodes (bank
//    position j, dy, dx), so the list is exact whatever order the frames
//    come in. With the tau exit, a pass whose max falls below the list's
//    k-th score ends the frame (strict <: ties continue), as in
//    extract_passes; the first pass ending the frame is the skipped merge.
//
// S is the GEMM-shaped block (QN x kb, depth C) that a tensor-core version
// would compute; here it runs on the CUDA cores in fp32.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace perframe {

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;
constexpr int CC = 16;            // channels staged per chunk
constexpr int LD = CC / 4 + 1;    // staged cell row in float4, padded
constexpr int KMAX = 32;          // largest top-k: one list entry per lane
constexpr int MAX_OFFSET = 31;    // largest window offset r
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;  // filler score (softmax weight 0)

// Query tile TQH x TQW; each thread holds MQ queries x MK keys of S.
template <int TQH_, int TQW_>
struct Tile {
  static constexpr int TQH = TQH_;
  static constexpr int TQW = TQW_;
  static constexpr int QN = TQH * TQW;     // queries per tile
  static constexpr int MQ = 8;
  static constexpr int MK = 4;
  static constexpr int QG = QN / MQ;       // query groups
  static constexpr int KG = NT / QG;       // key groups (lanes of a warp)
  static constexpr int KSUB = KG * MK;     // keys of S per register pass
  static constexpr int QPW = QN / NWARP;   // queries per warp
  static constexpr int KPT = KSUB * (CC / 4) / NT;  // staged keys per thread
  static_assert(QN % MQ == 0 && NT % QG == 0 && QN % NWARP == 0 &&
                    KG % 32 == 0 && KPT * NT == KSUB * (CC / 4) &&
                    QN * (CC / 4) <= NT,
                "tile shape");
};

// Tiles by window offset r, so that S fits shared memory: r <= 12 takes
// 4x8 (S at r = 11: 32 x 26 x 30 floats, 100 KB), r <= 20 takes 4x4 (r = 17:
// 16 x 38 x 38, 92 KB), r <= 31 takes 2x4 (r = 31: 8 x 64 x 66, 135 KB).
using TileA = Tile<4, 8>;
using TileB = Tile<4, 4>;
using TileC = Tile<2, 4>;

// What a launch shares with all its blocks.
struct Geometry {
  int h, w, C;
  int r, span;      // largest offset, 2r + 1
  int kh, kw, kb;   // key window rows, columns, keys
  int tiles_x;      // query tiles per row
  float radius2;    // circle: float(dy^2 + dx^2) < radius2
  float inv_tau;
};

template <class T>
Geometry make_geometry(int h, int w, int C, int r, float radius2,
                       float inv_tau) {
  Geometry g;
  g.h = h;
  g.w = w;
  g.C = C;
  g.r = r;
  g.span = 2 * r + 1;
  g.kh = T::TQH + 2 * r;
  g.kw = T::TQW + 2 * r;
  g.kb = g.kh * g.kw;
  g.tiles_x = (w + T::TQW - 1) / T::TQW;
  g.radius2 = radius2;
  g.inv_tau = inv_tau;
  return g;
}

template <class T>
int tiles(const Geometry& g) {
  return g.tiles_x * ((g.h + T::TQH - 1) / T::TQH);
}

// Dynamic shared memory of a block: staged keys and queries, then S.
template <class T>
size_t smem_bytes(const Geometry& g) {
  return (size_t)(T::KSUB + T::QN) * LD * sizeof(float4) +
         (size_t)T::QN * g.kb * sizeof(float);
}

template <class T>
struct Smem {
  float4* ks;  // [KSUB][LD]: a key sub-block's channel chunk
  float4* qs;  // [QN][LD]: the query tile's channel chunk
  float* s;    // [QN][kb]: the score block
  __device__ explicit Smem(float4* base) {
    ks = base;
    qs = ks + T::KSUB * LD;
    s = reinterpret_cast<float*>(qs + T::QN * LD);
  }
};

__device__ __forceinline__ bool better(float s, int o, float ts, int to) {
  return s > ts || (s == ts && o < to);
}

// One chunk of CC channels from global memory into a thread's staging
// registers: the channel quad c4 of each of its key cells (offsets koff in
// the plane, -1 outside the window or the map) and of its query cell (qoff).
// Quads past the last channel are zeros and are never read.
template <int KPT>
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ kframe,
                                            const float* __restrict__ qframe,
                                            const int (&koff)[KPT], int qoff,
                                            int c0, bool in_c,
                                            float4 (&kreg)[KPT],
                                            float4& qreg) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int s = 0; s < KPT; ++s)
    kreg[s] = in_c && koff[s] >= 0
                  ? *reinterpret_cast<const float4*>(kframe + koff[s] + c0)
                  : zero;
  qreg = in_c && qoff >= 0
             ? *reinterpret_cast<const float4*>(qframe + qoff + c0)
             : zero;
}

// S = (Q K^T) * inv_tau for the tile at (y0, x0): qframe and kframe are
// (h, w, C) planes. Ends with S written; the caller syncs before reading.
// Thread tid stages channel quad tid % 4 of keys tid / 4 + 64 s of each key
// sub-block (and of query tid / 4); the next chunk's loads are issued
// before the current chunk is computed, so they are in flight meanwhile.
template <class T>
__device__ void score_tile(const float* __restrict__ qframe,
                           const float* __restrict__ kframe, int y0, int x0,
                           const Geometry& g, const Smem<T>& sm) {
  constexpr int NQ = CC / 4;       // channel quads per chunk
  constexpr int STRIDE = NT / NQ;  // keys between a thread's staging slots
  const int tid = threadIdx.x;
  const int kg = tid % T::KG;
  const int qg = tid / T::KG;
  const int c4s = tid % NQ;
  const int slot = tid / NQ;
  int qoff = -1;
  if (slot < T::QN) {
    const int yy = y0 + slot / T::TQW;
    const int xx = x0 + slot % T::TQW;
    if (yy < g.h && xx < g.w) qoff = (yy * g.w + xx) * g.C + 4 * c4s;
  }
  for (int kb0 = 0; kb0 < g.kb; kb0 += T::KSUB) {
    int koff[T::KPT];
#pragma unroll
    for (int s = 0; s < T::KPT; ++s) {
      const int kk = kb0 + slot + STRIDE * s;
      koff[s] = -1;
      if (kk < g.kb) {
        const int kr = kk / g.kw;
        const int ky = y0 - g.r + kr;
        const int kx = x0 - g.r + (kk - kr * g.kw);
        if (ky >= 0 && ky < g.h && kx >= 0 && kx < g.w)
          koff[s] = (ky * g.w + kx) * g.C + 4 * c4s;
      }
    }
    float acc[T::MQ][T::MK];
#pragma unroll
    for (int m = 0; m < T::MQ; ++m)
#pragma unroll
      for (int i = 0; i < T::MK; ++i) acc[m][i] = 0.f;

    float4 kreg[T::KPT];
    float4 qreg;
    fetch_chunk(kframe, qframe, koff, qoff, 0, 4 * c4s < g.C, kreg, qreg);
    for (int c0 = 0; c0 < g.C; c0 += CC) {
      const int n4 = min(CC, g.C - c0) / 4;
      __syncthreads();  // the previous chunk (and S's readers) are done
#pragma unroll
      for (int s = 0; s < T::KPT; ++s)
        sm.ks[(slot + STRIDE * s) * LD + c4s] = kreg[s];
      if (slot < T::QN) sm.qs[slot * LD + c4s] = qreg;
      __syncthreads();
      if (c0 + CC < g.C)
        fetch_chunk(kframe, qframe, koff, qoff, c0 + CC,
                    4 * c4s < g.C - c0 - CC, kreg, qreg);
      for (int c4 = 0; c4 < n4; ++c4) {
        float4 qv[T::MQ];
#pragma unroll
        for (int m = 0; m < T::MQ; ++m) qv[m] = sm.qs[(qg * T::MQ + m) * LD + c4];
#pragma unroll
        for (int i = 0; i < T::MK; ++i) {
          const float4 kv = sm.ks[(kg + T::KG * i) * LD + c4];
#pragma unroll
          for (int m = 0; m < T::MQ; ++m) {
            float a = acc[m][i];
            a = fmaf(qv[m].x, kv.x, a);
            a = fmaf(qv[m].y, kv.y, a);
            a = fmaf(qv[m].z, kv.z, a);
            a = fmaf(qv[m].w, kv.w, a);
            acc[m][i] = a;
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < T::MK; ++i) {
      const int kk = kb0 + kg + T::KG * i;
      if (kk >= g.kb) continue;
      const int kr = kk / g.kw;
      const int ky = y0 - g.r + kr;
      const int kx = x0 - g.r + (kk - kr * g.kw);
      const bool kin = ky >= 0 && ky < g.h && kx >= 0 && kx < g.w;
#pragma unroll
      for (int m = 0; m < T::MQ; ++m) {
        const int q = qg * T::MQ + m;
        const int qy = y0 + q / T::TQW;
        const int qx = x0 + q % T::TQW;
        const int dy = ky - qy;
        const int dx = kx - qx;
        const bool ok = kin && qy < g.h && qx < g.w &&
                        (float)(dy * dy + dx * dx) < g.radius2;
        sm.s[q * g.kb + kk] = ok ? acc[m][i] * g.inv_tau : -INFINITY;
      }
    }
  }
}

// One warp: query q's passes over its row sq of S (bank position j) and the
// merge into its running list (ls, lo: lane l holds entry l). Returns the
// number of passes run. The row is consumed (winners set to -inf).
template <class T>
__device__ __forceinline__ int extract_merge(float* sq, int q, int j,
                                             const Geometry& g, int topk,
                                             bool early_exit, float& ls,
                                             int& lo) {
  const int lane = threadIdx.x & 31;
  const int qi = q / T::TQW;
  const int qj = q % T::TQW;
  int passes = 0;
  for (int p = 0; p < topk; ++p) {
    float m = -INFINITY;
    int kk = INT_MAX;
    for (int e = lane; e < g.kb; e += 32) {
      const float v = sq[e];
      if (v > m) {  // e ascends: the lane keeps its first maximum
        m = v;
        kk = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(FULL, m, off);
      const int okk = __shfl_xor_sync(FULL, kk, off);
      if (om > m || (om == m && okk < kk)) {
        m = om;
        kk = okk;
      }
    }
    ++passes;
    if (m == -INFINITY) break;  // no valid key left in this frame
    const float tau = __shfl_sync(FULL, ls, topk - 1);
    if (early_exit && m < tau) break;  // nothing left here can enter
    // window (kr, kc) -> order key (j, dy + r, dx + r)
    const int kr = kk / g.kw;
    const int o = (j * g.span + (kr - qi)) * g.span + (kk - kr * g.kw - qj);
    const int pos =
        __popc(__ballot_sync(FULL, lane < topk && better(ls, lo, m, o)));
    const float up_s = __shfl_up_sync(FULL, ls, 1);
    const int up_o = __shfl_up_sync(FULL, lo, 1);
    if (pos < topk) {
      if (lane == pos) {
        ls = m;
        lo = o;
      } else if (lane > pos && lane < topk) {
        ls = up_s;
        lo = up_o;
      }
    }
    if (p + 1 < topk) {
      if (lane == 0) sq[kk] = -INFINITY;
      __syncwarp();
    }
  }
  return passes;
}

template <class T>
__device__ __forceinline__ void init_lists(float (&ls)[T::QPW],
                                           int (&lo)[T::QPW]) {
#pragma unroll
  for (int qq = 0; qq < T::QPW; ++qq) {
    ls[qq] = -INFINITY;
    lo[qq] = INT_MAX;
  }
}

// The passes of every query of the tile over the current S (bank position
// j), one warp per query; adds the passes run to *passes.
template <class T>
__device__ __forceinline__ void extract_tile(const Smem<T>& sm, int j,
                                             const Geometry& g, int topk,
                                             bool early_exit,
                                             float (&ls)[T::QPW],
                                             int (&lo)[T::QPW], int* passes) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int qq = 0; qq < T::QPW; ++qq) {
    const int q = warp + NWARP * qq;
    *passes += extract_merge<T>(sm.s + (size_t)q * g.kb, q, j, g, topk,
                                early_exit, ls[qq], lo[qq]);
  }
}

// Decode a list entry of query (y, x): order key o -> (j, dy, dx). Returns
// false for a filler entry (fewer than k valid keys).
__device__ __forceinline__ bool decode(int o, const Geometry& g, int* j,
                                       int* dy, int* dx) {
  if (o == INT_MAX) return false;
  const int span2 = g.span * g.span;
  *j = o / span2;
  const int rem = o - *j * span2;
  *dy = rem / g.span - g.r;
  *dx = rem % g.span - g.r;
  return true;
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace perframe
