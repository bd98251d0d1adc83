// Weight gradient of narrow 3-D convolutions in exact fp32:
//
//   dW[co, ci, dt, dh, dw] = sum over (n, t, h, w) of dY[n, co, t, h, w] *
//       X[n, ci, t*st + dt - pt, h*sh + dh - ph, w*sw + dw - pw]
//
// with zero padding, groups 1 and dilation 1 (vfs_tpu_torch/ops/
// conv3d_wgrad.py, which routes ConvBN3d's narrow convolutions here).
//
// Replaces no Pallas kernel: the JAX package left this weight gradient to
// XLA's convolution. It is here because cuDNN's fp32 weight gradient of
// these shapes (wgrad2d_grouped_direct_kernel) runs at under 0.5% of the
// card's bound: the weight has 24 to 9,408 entries at the stems and the
// fast pathway's first stage (36,864 at most of the shapes routed here),
// each a sum over up to 12.8 M output positions, and cuDNN cannot spread
// that sum over 132 SMs.
//
// Bound, on an H100 SXM (67 TFLOP/s fp32 FFMA, 3.35 TB/s), at SlowFast-R50
// 4x16's shapes (32 clips of 32 x 224 x 224):
//   fast stem 5x7x7 3->8, stride (1,2,2)    151.0 GFLOP   2.25 ms, operations
//   slow stem 1x7x7 3->64, stride (1,2,2)   30.2 GFLOP    0.45 ms, operations
//   fast res2 1x1x1 8->32 at 32x56x56       0.51 GB       0.15 ms, bytes
//   fast res2 1x3x3 8->8                    0.21 GB       0.06 ms, bytes
//   fast res2 3x1x1 8->8                    0.21 GB       0.06 ms, bytes
// (X and dY read once, dW written once.) The stems are bound by the fp32
// FMAs, the rest by the bytes of X and dY.
//
// Design, two kernels on the caller's stream, both named *wgrad* (the
// benchmark's train.conv_ms_per_step counts kernels by that name):
//
// 1. narrow_wgrad3d_kernel<KW, SW>: split-K over output positions. A slab
//    is (n, t, a tile of TH output rows, the full width). Persistent blocks
//    take slabs blockIdx.x, + gridDim.x, ... (a static order: the sums
//    repeat bit for bit; neighbouring blocks work on neighbouring rows, so
//    the halos and the KT frames a slab shares with the next ones come
//    from L2). A two-stage cp.async ring stages the next slab's input
//    window (KT frames x the rows x the full padded width x Cin, zeros in
//    the padding) and its dY tile (TH x Wo x Cout) in shared memory while
//    the block computes on the current one: 16-byte copies where X and dY
//    are channels-last (NDHWC, as the training step keeps them), 4-byte
//    copies through the strides otherwise.
//    A thread owns one (ci, dh, dt, group of 8 co) and all KW taps along
//    w: KW x 8 fp32 accumulators in registers. It walks a segment of an
//    output row: per position it shifts its register window of KW input
//    values by SW, loads the SW new ones from shared memory (a stride-2
//    7-wide stem reuses 5 of 7), reads the position's 8 dY values as two
//    float4 (the same address for the warp's threads of one co group: a
//    broadcast) and issues KW x 8 FFMAs (for KW <= 3 into sums of the
//    slab, added to the running sums once a slab, which keeps fp32 chains
//    short). The block's threads are E entries
//    (or a chunk of them, blockIdx.y, for wide weights) x G position
//    groups; group g takes the units (row, segment) g, g + G, ... of each
//    slab. At the end the block adds its groups' sums in group order in
//    shared memory and writes its partial dW to a workspace of grid_x x
//    |dW| floats.
// 2. narrow_wgrad3d_sum_kernel: sums the grid_x partials of each dW
//    entry in a fixed order (32 strided lanes, then the 32 lane sums in
//    order; no atomics) and writes dW through the weight's own strides, so
//    the gradient comes out in the weight's memory format.
//
// Arithmetic is fmaf in fp32 throughout: no TF32, no tensor cores. One
// template, instantiated for the tap widths and w strides the families
// need (KW, SW) = (1, 1), (1, 2), (3, 1), (3, 2), (7, 2): 1x1x1 and k x 1
// x 1, 1 x k x k, and the stems.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int CO_TILE = 8;       // output channels a thread holds
constexpr int MAX_THREADS = 512;
constexpr int SUM_LANES = 32;    // lanes that split the partials of an entry

// The host's plan (ops/conv3d_wgrad.py::plan) and the tensors' strides, in
// the order of ops/conv3d_wgrad.py::geometry.
struct Geometry {
  int N, T, H, W, Cin, To, Ho, Wo, Cout, KT, KH, st, sh, pt, ph, pw;
  long long xs[5];  // X's strides in elements: n, c, t, h, w
  long long ys[5];  // dY's strides
  int x_vec, y_vec;  // 16-byte copies of X, dY
  int TH, nseg, seg, groups, entries, ent_cta, slabs, n_ht;
  int lead, rs, fs, win_w, x_floats, y_floats;
  long long ws[5];  // dW's strides: co, ci, t, h, w
};
constexpr int GEO_FIELDS = 47;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Slab {
  int n, to, ho0, rows;
};

__device__ __forceinline__ Slab slab_of(const Geometry& g, int s) {
  Slab b;
  const int hot = s % g.n_ht;
  const int rest = s / g.n_ht;
  b.to = rest % g.To;
  b.n = rest / g.To;
  b.ho0 = hot * g.TH;
  b.rows = min(g.TH, g.Ho - b.ho0);
  return b;
}

// Issue the copies of slab s into one stage (xs: the input window, ys: the
// dY tile); padding is stored as zeros.
__device__ void stage(const Geometry& g, const float* __restrict__ x,
                      const float* __restrict__ dy, float* xs, float* ys,
                      int s) {
  const Slab b = slab_of(g, s);
  const int t0 = b.to * g.st - g.pt;
  const int h0 = b.ho0 * g.sh - g.ph;
  const int nr = (b.rows - 1) * g.sh + g.KH;
  const int quads = g.rs / 4;
  const int win_floats = g.win_w * g.Cin;
  const int row_floats = g.W * g.Cin;
  const int total = g.KT * nr * quads;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int q = i % quads;
    const int rr = i / quads;
    const int r = rr % nr;
    const int dt = rr / nr;
    float* dst = xs + dt * g.fs + r * g.rs + q * 4;
    const int ti = t0 + dt, hi = h0 + r;
    const bool row_ok = ti >= 0 && ti < g.T && hi >= 0 && hi < g.H;
    const float* row =
        row_ok ? x + b.n * g.xs[0] + ti * g.xs[2] + hi * g.xs[3] : x;
    const int f0 = q * 4 - g.lead;        // window float of the quad's first
    const int wf = f0 - g.pw * g.Cin;     // its float in the input row
    if (row_ok && g.x_vec && wf >= 0 && wf + 4 <= row_floats &&
        f0 >= 0 && f0 + 4 <= win_floats) {
      cp_async16(dst, row + wf);
      continue;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = f0 + k;
      const float* src = nullptr;
      if (row_ok && f >= 0 && f < win_floats) {
        const int c = f / g.Cin;
        const int ci = f - c * g.Cin;
        const int wi = c - g.pw;
        if (wi >= 0 && wi < g.W) src = row + wi * g.xs[4] + ci * g.xs[1];
      }
      if (src != nullptr)
        cp_async4(dst + k, src);
      else
        dst[k] = 0.f;
    }
  }
  const int yq = g.Wo * g.Cout / 4;
  const int ytotal = b.rows * yq;
  for (int i = threadIdx.x; i < ytotal; i += blockDim.x) {
    const int q = i % yq;
    const int r = i / yq;
    float* dst = ys + r * g.Wo * g.Cout + q * 4;
    const float* row =
        dy + b.n * g.ys[0] + b.to * g.ys[2] + (b.ho0 + r) * g.ys[3];
    if (g.y_vec) {
      cp_async16(dst, row + q * 4);
      continue;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = q * 4 + k;
      const int w = f / g.Cout;
      const int co = f - w * g.Cout;
      cp_async4(dst + k, row + w * g.ys[4] + co * g.ys[1]);
    }
  }
}

// a[k][c] += win[k] * d[c] for the 8 output channels of d0, d1
template <int KW>
__device__ __forceinline__ void fma_taps(float (&a)[KW][CO_TILE],
                                         const float (&win)[KW],
                                         const float4 d0, const float4 d1) {
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    a[k][0] = fmaf(win[k], d0.x, a[k][0]);
    a[k][1] = fmaf(win[k], d0.y, a[k][1]);
    a[k][2] = fmaf(win[k], d0.z, a[k][2]);
    a[k][3] = fmaf(win[k], d0.w, a[k][3]);
    a[k][4] = fmaf(win[k], d1.x, a[k][4]);
    a[k][5] = fmaf(win[k], d1.y, a[k][5]);
    a[k][6] = fmaf(win[k], d1.z, a[k][6]);
    a[k][7] = fmaf(win[k], d1.w, a[k][7]);
  }
}

template <int KW, int SW>
__global__ void __launch_bounds__(MAX_THREADS)
    narrow_wgrad3d_kernel(const float* __restrict__ x,
                          const float* __restrict__ dy,
                          float* __restrict__ part, const Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int local = threadIdx.x % g.ent_cta;
  const int grp = threadIdx.x / g.ent_cta;
  const int e = blockIdx.y * g.ent_cta + local;
  const bool live = e < g.entries;
  // entry e = ((cog * KT + dt) * KH + dh) * Cin + ci
  int ci = 0, dh = 0, dt = 0, cog = 0;
  if (live) {
    ci = e % g.Cin;
    int r = e / g.Cin;
    dh = r % g.KH;
    r /= g.KH;
    dt = r % g.KT;
    cog = r / g.KT;
  }
  // acc: the thread's sums over all its slabs. Where the registers allow
  // (KW <= 3) a slab is summed apart in sl and then added to acc: an fp32
  // chain then runs over one slab's positions plus one term a slab, not
  // over every position the thread takes.
  constexpr bool PER_SLAB = KW <= 3;
  float acc[KW][CO_TILE], sl[KW][CO_TILE];
#pragma unroll
  for (int k = 0; k < KW; ++k)
#pragma unroll
    for (int c = 0; c < CO_TILE; ++c) acc[k][c] = sl[k][c] = 0.f;

  const int stage_floats = g.x_floats + g.y_floats;
  int s = blockIdx.x;
  if (s < g.slabs) stage(g, x, dy, smem, smem + g.x_floats, s);
  cp_async_commit();
  for (int it = 0; s < g.slabs; s += gridDim.x, ++it) {
    float* cur = smem + (it & 1) * stage_floats;
    float* nxt = smem + ((it + 1) & 1) * stage_floats;
    const int sn = s + gridDim.x;
    if (sn < g.slabs) stage(g, x, dy, nxt, nxt + g.x_floats, sn);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (live) {
      const Slab b = slab_of(g, s);
      const float* xb = cur + dt * g.fs + g.lead + ci;
      const float* yb = cur + g.x_floats + cog * CO_TILE;
      const int units = b.rows * g.nseg;
      const int step = SW * g.Cin;
      for (int u = grp; u < units; u += g.groups) {
        const int r = u / g.nseg;
        const int wa = (u - r * g.nseg) * g.seg;
        const int wb = min(wa + g.seg, g.Wo);
        if (wa >= wb) continue;
        const float* xr = xb + (r * g.sh + dh) * g.rs + wa * step;
        const float* yr = yb + (r * g.Wo + wa) * g.Cout;
        float win[KW];
        // the window of the position before wa: columns (wa - 1) SW + j
#pragma unroll
        for (int j = SW; j < KW; ++j) win[j] = xr[(j - SW) * g.Cin];
#pragma unroll 2
        for (int w = wa; w < wb; ++w) {
#pragma unroll
          for (int k = 0; k + SW < KW; ++k) win[k] = win[k + SW];
#pragma unroll
          for (int k = (KW > SW ? KW - SW : 0); k < KW; ++k)
            win[k] = xr[k * g.Cin];
          const float4 d0 = *reinterpret_cast<const float4*>(yr);
          const float4 d1 = *reinterpret_cast<const float4*>(yr + 4);
          if constexpr (PER_SLAB)
            fma_taps<KW>(sl, win, d0, d1);
          else
            fma_taps<KW>(acc, win, d0, d1);
          xr += step;
          yr += g.Cout;
        }
      }
      if constexpr (PER_SLAB) {
#pragma unroll
        for (int k = 0; k < KW; ++k)
#pragma unroll
          for (int c = 0; c < CO_TILE; ++c) {
            acc[k][c] += sl[k][c];
            sl[k][c] = 0.f;
          }
      }
    }
    __syncthreads();
  }
  // the block's partial: its groups' sums added in group order in shared
  // memory (the ring is free after the last barrier)
  float* red = smem;
#pragma unroll
  for (int k = 0; k < KW; ++k)
#pragma unroll
    for (int c = 0; c < CO_TILE; ++c)
      red[((grp * g.ent_cta + local) * KW + k) * CO_TILE + c] = acc[k][c];
  __syncthreads();
  const int e0 = blockIdx.y * g.ent_cta;
  const int n_out = min(g.ent_cta, g.entries - e0) * KW * CO_TILE;
  float* out = part + ((size_t)blockIdx.x * g.entries + e0) * KW * CO_TILE;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    float sum = red[i];
    for (int q = 1; q < g.groups; ++q)
      sum += red[q * g.ent_cta * KW * CO_TILE + i];
    out[i] = sum;
  }
}

// dW entry idx = (e * KW + k) * 8 + c: the sum of its `parts` partials in
// a fixed order, written through dW's strides.
__global__ void __launch_bounds__(SUM_LANES * 32)
    narrow_wgrad3d_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ dw, int parts, int total,
                              int KW, const Geometry g) {
  __shared__ float lane_sums[SUM_LANES][33];
  const int idx = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (idx < total) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += SUM_LANES)
      s += part[(size_t)p * total + idx];
  }
  lane_sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || idx >= total) return;
  float t = 0.f;
  for (int y = 0; y < SUM_LANES; ++y) t += lane_sums[y][threadIdx.x];
  const int c = idx % CO_TILE;
  const int k = (idx / CO_TILE) % KW;
  int e = idx / (CO_TILE * KW);
  const int ci = e % g.Cin;
  e /= g.Cin;
  const int dh = e % g.KH;
  e /= g.KH;
  const int dt = e % g.KT;
  const int co = (e / g.KT) * CO_TILE + c;
  dw[co * g.ws[0] + ci * g.ws[1] + dt * g.ws[2] + dh * g.ws[3] +
     k * g.ws[4]] = t;
}

Geometry read_geometry(const long long* v) {
  Geometry g;
  int i = 0;
  for (int* f : {&g.N, &g.T, &g.H, &g.W, &g.Cin, &g.To, &g.Ho, &g.Wo, &g.Cout,
                 &g.KT, &g.KH, &g.st, &g.sh, &g.pt, &g.ph, &g.pw})
    *f = (int)v[i++];
  for (long long& s : g.xs) s = v[i++];
  for (long long& s : g.ys) s = v[i++];
  for (int* f : {&g.x_vec, &g.y_vec, &g.TH, &g.nseg, &g.seg, &g.groups,
                 &g.entries, &g.ent_cta, &g.slabs, &g.n_ht, &g.lead, &g.rs,
                 &g.fs, &g.win_w, &g.x_floats, &g.y_floats})
    *f = (int)v[i++];
  for (long long& s : g.ws) s = v[i++];
  return g;
}

// The plan is the host's (ops/conv3d_wgrad.py::plan); here only what keeps
// every access inside X, dY, the workspace, dW and shared memory, and every
// 16-byte copy and float4 read aligned. Whether the slabs and segments
// cover every output position is the plan's to hold (tested there).
bool valid(const Geometry& g, int kw, int sw, int grid_x, int smem_bytes) {
  const long long stage = (long long)g.x_floats + g.y_floats;
  const long long rows = (long long)(g.TH - 1) * g.sh + g.KH;
  return g.N > 0 && g.Cin > 0 && g.Cout > 0 && g.Cout % CO_TILE == 0 &&
         g.To > 0 && g.Ho > 0 && g.Wo > 0 && g.KT > 0 && g.KH > 0 &&
         g.st > 0 && g.sh > 0 && g.TH > 0 && g.nseg > 0 && g.groups > 0 &&
         g.ent_cta > 0 && g.n_ht > 0 &&
         (long long)g.ent_cta * g.groups <= MAX_THREADS &&
         g.entries == g.Cin * g.KT * g.KH * (g.Cout / CO_TILE) &&
         (long long)g.slabs <= (long long)g.N * g.To * g.n_ht &&
         grid_x > 0 && g.lead >= 0 && g.rs % 4 == 0 &&
         (!g.x_vec || (g.lead + g.pw * g.Cin) % 4 == 0) &&
         g.rs >= g.lead + (long long)g.win_w * g.Cin &&
         g.win_w >= (g.Wo - 1) * sw + kw && g.fs % 4 == 0 &&
         (long long)g.fs >= rows * g.rs &&
         (long long)g.x_floats >= (long long)g.KT * g.fs &&
         g.x_floats % 4 == 0 &&
         (long long)g.y_floats >= (long long)g.TH * g.Wo * g.Cout &&
         g.y_floats % 4 == 0 && 2 * stage * 4 <= smem_bytes &&
         (long long)g.ent_cta * g.groups * kw * CO_TILE * 4 <= smem_bytes;
}

template <int KW, int SW>
cudaError_t launch(const float* x, const float* dy, float* part, float* dw,
                   const Geometry& g, int grid_x, int smem_bytes,
                   cudaStream_t st) {
  auto kernel = narrow_wgrad3d_kernel<KW, SW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(grid_x, (g.entries + g.ent_cta - 1) / g.ent_cta);
  kernel<<<grid, g.ent_cta * g.groups, smem_bytes, st>>>(x, dy, part, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = g.entries * KW * CO_TILE;
  narrow_wgrad3d_sum_kernel<<<(total + 31) / 32, dim3(32, SUM_LANES), 0,
                              st>>>(part, dw, grid_x, total, KW, g);
  return cudaGetLastError();
}

template <int KW, int SW>
int blocks_per_sm(int threads, int smem_bytes) {
  auto kernel = narrow_wgrad3d_kernel<KW, SW>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem_bytes) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// dW of one narrow convolution: `geo` holds GEO_FIELDS int64 in Geometry's
// order (ops/conv3d_wgrad.py::geometry), `part` grid_x x |dW| floats
// of workspace (no initial value), `dw` the weight gradient
// (written through geo's dW strides). X, dY and dW are fp32 on the card.
// Returns a cudaError_t (cudaErrorInvalidValue for a plan the kernel does
// not take).
int vfs_narrow_wgrad3d(const void* x, const void* dy, void* part, void* dw,
                       const long long* geo, int n_geo, int kw, int sw,
                       int grid_x, int smem_bytes, void* stream) {
  if (n_geo != GEO_FIELDS) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < GEO_FIELDS; ++i) {
    const bool stride = (i >= 16 && i < 26) || i >= 42;  // int64 fields
    if (!stride && (geo[i] < INT32_MIN || geo[i] > INT32_MAX))
      return (int)cudaErrorInvalidValue;
  }
  const Geometry g = read_geometry(geo);
  if (!valid(g, kw, sw, grid_x, smem_bytes)) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(dy);
  float* pp = static_cast<float*>(part);
  float* wp = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kw == 1 && sw == 1)
    return (int)launch<1, 1>(xp, yp, pp, wp, g, grid_x, smem_bytes, st);
  if (kw == 1 && sw == 2)
    return (int)launch<1, 2>(xp, yp, pp, wp, g, grid_x, smem_bytes, st);
  if (kw == 3 && sw == 1)
    return (int)launch<3, 1>(xp, yp, pp, wp, g, grid_x, smem_bytes, st);
  if (kw == 3 && sw == 2)
    return (int)launch<3, 2>(xp, yp, pp, wp, g, grid_x, smem_bytes, st);
  if (kw == 7 && sw == 2)
    return (int)launch<7, 2>(xp, yp, pp, wp, g, grid_x, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of narrow_wgrad3d_kernel<kw, sw> an SM holds at `threads` threads
// and `smem_bytes` of dynamic shared memory; -1 for a family not built.
int vfs_narrow_wgrad3d_blocks_per_sm(int kw, int sw, int threads,
                                     int smem_bytes) {
  if (kw == 1 && sw == 1) return blocks_per_sm<1, 1>(threads, smem_bytes);
  if (kw == 1 && sw == 2) return blocks_per_sm<1, 2>(threads, smem_bytes);
  if (kw == 3 && sw == 1) return blocks_per_sm<3, 1>(threads, smem_bytes);
  if (kw == 3 && sw == 2) return blocks_per_sm<3, 2>(threads, smem_bytes);
  if (kw == 7 && sw == 2) return blocks_per_sm<7, 2>(threads, smem_bytes);
  return -1;
}

}  // extern "C"
