// Row 1 on the tensor cores: masked top-k video affinity (phase 1 of DAVIS
// label propagation), its fp32 entry where C >= TC_MIN_CHANNELS
// (vfs_tpu_torch/ops/window_geometry.py::tc_takes).
//
// Replaces, like video_topk_affinity.cu, the TPU kernel
// video_topk_affinity2 (vfs_tpu/ops/pallas_affinity_video.py:1037), and
// gives that file's fp32 entry's outputs bit for bit: the same scores
// (each an fmaf chain in ascending channel order from 0, times inv_tau),
// the same lists under the full comparator (score descending, then order
// key (j, dy + r, dx + r) ascending), the same fillers and sources
// (wtk::store_video_lists's rules). The tensor cores only choose which
// keys get that chain.
//
// Bound. The work is the core's: 2*C FLOPs per (query, in-map circle key,
// distinct live bank frame), 3.356 ms a frame at r50 (C = 1024, radius
// 18) on the fp32 CUDA cores of an H100 SXM (67 TFLOP/s). Here each pair
// is three TF32 products on the tensor cores (495 TFLOP/s dense), and a
// tile computes its key strip whole: 64 queries x 56 keys a key row at r
// <= 20, 62% of them in the circle at r = 17. The tensor cores' ceiling
// is then 495 / 3 x 0.62 ~ 100 TFLOP/s of useful fp32 work; what holds
// the kernel below it is the per-step work around the wgmmas (the stage
// barrier, copies, splits, flushes) and shared memory's bandwidth, which
// the B operands, the stage copies and the splits share.
//
// Design, three kernels on the caller's stream, all named video_topk_*
// (the benchmark's row-1 metrics find row 1 by that name):
//
// 1. video_topk_norm_kernel: the largest squared norm of the features,
//    the margin's N^2 (a warp a row).
// 2. video_topk_tc_kernel: one block per (t, tile of 8 x 16 queries),
//    four warpgroups. For each live bank frame, group of NKR = 4 key rows
//    and chunk of 16 channels, a 3-stage cp.async ring stages each key
//    row's strip (x0 - r .. x0 - r + 55) in wgmma's K-major core-matrix
//    layout (8 keys x 16 bytes contiguous; 128 bytes apart along K, 512
//    along the keys; no swizzle) and the tile's queries in 64-byte cells
//    (16-byte quads XOR-swizzled by (cell / 2) mod 4, conflict-free for
//    ldmatrix). The raw keys are their own H part: the tensor cores read
//    an fp32 operand's TF32 part by truncation. A step later each thread
//    writes L = k - trunc(k) (exact in fp32) beside the keys it copied, so
//    a stage costs the L2 its raw bytes only. Warpgroup g owns query rows
//    4 (g % 2) .. + 3 (M = 64) and key rows 2 (g / 2), + 1: per 8 channels
//    each warp loads its 16 queries' A fragment with ldmatrix.x4 and
//    splits it in registers (qh = q with its low 13 bits cleared, ql = q -
//    qh), and the warpgroup issues wgmma m64n56k8 TF32 three times a key
//    row, qh.H + qh.L + ql.H, into fp32 accumulators (2 x 28 registers a
//    thread); the copies of the step after next go out meanwhile. Key rows
//    beyond r of all four query rows are skipped. Every 128 channels each
//    thread adds its accumulators of in-band pairs to running sums in
//    shared memory (the next wgmma ignores D): the accumulation's error
//    then stays that of 128 channels (Margin); the last addition scales by
//    inv_tau. The tile's queries then merge each key row's pre-scores into
//    top-32 lists (the core's merge_query, ballot and shuffle, with the
//    tau exit: a lane a (query, key row)), frame 0 twice while t <= P.
//    After the walk, a warp a query re-ranks exactly (Margin): it
//    re-scores the list's entries at or above theta - 2m with the fmaf
//    chain, reading the rows from L2, ranks them under the full comparator
//    and writes the k best; a query it cannot prove complete from the list
//    (overflow) gets a threshold, and its unit (4 query rows x 16
//    columns) is queued.
// 3. video_topk_overflow_kernel: persistent blocks take the queued units.
//    A block walks a unit like (2) and appends every key whose pre-score
//    reaches its query's threshold to a per-query list in the block's
//    global scratch (room for the whole window, (P + 1) (2r + 1)^2 keys a
//    query: it never fills). Then a warp a query re-scores them all with
//    the fmaf chain and keeps the k best by ballot and shuffle.
// (video_topk_mma_check_kernel: one wgmma on given operands, the
// accumulation model's check on the card; not on the eval's path.)
// Past r = 20 the strip is 80 keys and a group 2 key rows, one a
// warpgroup (shared memory and registers).
//
// Margin. p: a key's pre-score scaled by inv_tau; s: its exact score (the
// fmaf chain times inv_tau). The host's window_geometry.prescore_margin
// gives m with |p - s| <= m for features whose squared norms are at most
// N^2 (kernel 1 measures N^2 on the card): the chain's own rounding
// (gamma_C N^2), the TF32 operands (3 2^-20 N^2: the tensor cores read L
// and ql within 2^-10 of them), the wgmma accumulation under the stated
// model (below) over 128 channels at a time, the running sums' additions
// and the two scalings. The selection: theta is the k-th pre-score of
// the query's list (its top 32 pre-scores), R the list's entries with p
// >= theta - 2m, kappa the k-th exact score in R. Every key of the exact
// top-k E has s >= kappa_E >= theta - m (the list's top k have s >= p - m
// >= theta - m), hence p >= theta - 2m; so a key of E missing from R lies
// beyond the list. Such a key has p <= p_32 (the list's last pre-score)
// and s <= p_32 + m, while R holds k keys with s >= kappa. So when the
// list is not full, or p_32 < kappa - m, E is R's top k; otherwise the
// query overflows, and kernel 3 collects every key with p >= kappa - m:
// E's keys have s >= kappa (R is a subset of all keys), so p >= kappa - m.
// Thresholds are rounded down (__fsub_rd), m up. Accumulation model,
// tested on the card against float64 (chip_smoke.mma_model_check, on
// adversarial operands: at most 0.56 rho): one k8 step returns c plus the
// sum of its 8 exact products within rho = 2^-21 of |c| + sum |a_i b_i|
// (window_geometry.MMA_RHO), and the tensor cores truncate the low 13
// bits of an fp32 operand (the raw keys' H rests on it; the same check).
//
// List size and overflow (margin_probe.py on the cell's six r50 banks,
// margin 1.46x the chain's own bound): a median of 21 keys within m of the
// exact k-th, 1.0-1.4% of queries over 32; on the cell's traffic 1.01% of
// the queries overflow and a query re-scores 21.3 keys (PERF.md).
//
// C crossover: window_geometry.TC_MIN_CHANNELS = 512. ab_kernels.py --tc
// at the r18 window (radius 12, T = 24, random features, no overflow):
// the two paths tie at C = 128-256 and this one leads by 2.5% at 512; the
// overflow pass adds about a tenth on real features, so narrower launches
// (the r18 main path, C = 256) keep the FFMA core. At r50 (C = 1024,
// radius 18) this path is 1.45x faster. The bf16 entry, rows 2-4 and the
// wide kernels keep window_topk.cuh's paths.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (ops/_build.py). Interface: plain C entries below,
// launched on the caller's stream; they allocate nothing and return
// cudaGetLastError().

#include "window_topk.cuh"

#include <cstdint>

namespace {

using wtk::Geometry;

constexpr int TW = 16;       // query tile columns
constexpr int QH1 = 8;       // query rows of a kernel-2 block
constexpr int QH2 = 4;       // query rows of a kernel-3 block
constexpr int LIST = 32;     // pre-score list entries a query
constexpr int CC = 16;       // channels a stage
constexpr int STAGES = 3;
constexpr int FLUSH = 8;     // chunks the accumulators sum (128 channels)
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t TF32_HI = 0xffffe000u;

// The key strip a key row stages: N keys from x0 - r, N = 56 while 16 +
// 2r <= 56 (r <= 20), else 80 (r <= 31).
__host__ __device__ constexpr int strip_of(int r) { return r <= 20 ? 56 : 80; }
// key rows a group (NKR, kernels 2 and 3) and a warpgroup (KPW): the
// shared memory of the stages, the running sums and the lists within the
// H100's 227 KB, the accumulators within 128 registers a thread
__host__ __device__ constexpr int nkr_of(int n) { return n == 56 ? 4 : 2; }
__host__ __device__ constexpr int kpw_of(int n) { return n == 56 ? 2 : 1; }
// threads of a block of qh query rows: a warpgroup per 4 query rows and
// KPW key rows
__host__ __device__ constexpr int threads_of(int qh, int n) {
  return 128 * (qh / 4) * (nkr_of(n) / kpw_of(n));
}

// The bank of query frame t, as video_topk_affinity.cu walks it: j = 0
// and the live ring slots, frame 0's ring copy folded into j = 0 (and
// inserted twice) while t <= P.
struct Bank {
  const float* feats;
  size_t fs;  // h * w * C
  int t, P;
  bool dup;
  __device__ int count() const { return dup ? t : P + 1; }
  __device__ int order_j(int i) const { return dup && i > 0 ? i + 1 : i; }
  __device__ bool twice(int i) const { return dup && i == 0; }
  __device__ int frame_of_j(int j) const {
    return j == 0 ? 0 : t - 1 - ((t - 1 - (j - 1)) % P);
  }
  __device__ size_t frame(int i) const {  // offset of frame i's plane
    return (size_t)frame_of_j(order_j(i)) * fs;
  }
};

// The margin's inputs from the host (window_geometry.prescore_margin) and
// the bound on N^2's rounding (window_geometry.norm_grow).
struct Margin {
  float coef, absolute, grow;
};

// The workspace the wrapper allocates (window_geometry.tc_workspace_ints):
// 8 control words (N^2's bits, the queued units), each query's threshold,
// the queued units (4 query rows x 16 columns), and kernel 3's scratch.
struct Work {
  unsigned* n2_bits;
  int* units_queued;
  float* thr;       // (T - 1, h, w): +inf where the query did not overflow
  int* units;       // ((t - 1) * ceil(h / 4) + y / 4) * tiles_x + x / 16
  int* scratch;     // [grid][64][window]: kernel 3's collected order keys
  int window;       // (P + 1) (2r + 1)^2
  int tiles_x;      // ceil(w / 16)
};

inline Work make_work(void* base, int T, int h, int w, int P, int r) {
  int* p = static_cast<int*>(base);
  Work k;
  k.tiles_x = (w + TW - 1) / TW;
  k.n2_bits = reinterpret_cast<unsigned*>(p);
  k.units_queued = p + 1;
  k.thr = reinterpret_cast<float*>(p + 8);
  k.units = p + 8 + (size_t)(T - 1) * h * w;
  k.scratch = k.units + (size_t)(T - 1) * ((h + 3) / 4) * k.tiles_x;
  k.window = (P + 1) * (2 * r + 1) * (2 * r + 1);
  return k;
}

// counters the wrapper reads while a trace records (null otherwise)
enum Stat { RESCORED = 0, OVERFLOWED = 1 };

__device__ __forceinline__ void add_stat(unsigned long long* stats, Stat i,
                                         unsigned long long n) {
  if (stats != nullptr && n != 0) atomicAdd(stats + i, n);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&v)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
      : "r"(a));
}

// D (+)= A B for one k8 step: A (64 x 8) from this thread's fragment,
// B (56 x 8, K-major) from shared memory through `desc`; scale_d 0 ignores D.
__device__ __forceinline__ void wgmma56(float (&d)[28], const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// D (+)= A B for one k8 step: A (64 x 8) from this thread's fragment,
// B (80 x 8, K-major) from shared memory through `desc`; scale_d 0 ignores D.
__device__ __forceinline__ void wgmma80(float (&d)[40], const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
  if constexpr (N == 56)
    wgmma56(d, a, desc, scale_d);
  else
    wgmma80(d, a, desc, scale_d);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory (cp.async, stores) before the
// async proxy (wgmma) reads them.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps a register's value where the compiler placed it: after wg_wait,
// the wgmmas' asynchronous reads and writes of it are done
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// A K-major operand in shared memory: core matrices of 8 rows x 16 bytes,
// 128 bytes apart along K (LBO) and `sbo` along the rows (SBO), no
// swizzle.
__device__ __forceinline__ uint64_t desc_of(const void* p, int sbo = 512) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// The float4 slot of quad `quad` (0..3) of 64-byte query cell `cell`:
// quads XOR-swizzled by (cell / 2) mod 4, so 8 consecutive cells' quad q
// lie in 8 distinct 16-byte bank groups.
__device__ __forceinline__ int slot(int cell, int quad) {
  return (cell << 2) | (quad ^ ((cell >> 1) & 3));
}

// The fmaf chain of the core (wtk::score_chunk): channels 0..C-1 in order
// from 0, times inv_tau.
__device__ __forceinline__ float exact_score(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             int C, float inv_tau) {
  float a = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; c += 4)
    a = wtk::dot4(wtk::load_global4(q + c), wtk::load_global4(k + c), a);
  return a * inv_tau;
}

// Key o of query (y, x): its frame f and cell.
struct Key {
  int f, ky, kx;
};

__device__ __forceinline__ Key key_of(int o, const Bank& bank, int y, int x,
                                      const Geometry& g) {
  const int span2 = g.span * g.span;
  const int j = o / span2;
  const int rem = o - j * span2;
  const int dy = rem / g.span - g.r;
  const int dx = rem - (rem / g.span) * g.span - g.r;
  return {bank.frame_of_j(j), y + dy, x + dx};
}

__device__ __forceinline__ float rescore(int o, const Bank& bank, int y, int x,
                                         const Geometry& g) {
  const Key k = key_of(o, bank, y, x, g);
  const float* qp = bank.feats + (size_t)bank.t * bank.fs +
                    ((size_t)y * g.w + x) * g.C;
  const float* kp = bank.feats + (size_t)k.f * bank.fs +
                    ((size_t)k.ky * g.w + k.kx) * g.C;
  return exact_score(qp, kp, g.C, g.inv_tau);
}

// Output entry `slot_i` of query (t, y, x): the key of order key o and its
// score, or the filler (NEG_INF, the query's own cell in frame 0) for o ==
// INT_MAX; store_video_lists' rules.
__device__ __forceinline__ void store(float s, int o, int slot_i,
                                      const Bank& bank, int y, int x,
                                      const Geometry& g,
                                      float* __restrict__ out_s,
                                      long long* __restrict__ out_i) {
  long long idx = (long long)y * g.w + x;
  if (o == INT_MAX) {
    s = wtk::NEG_INF;
  } else {
    const Key k = key_of(o, bank, y, x, g);
    idx = (long long)k.f * g.h * g.w + (long long)k.ky * g.w + k.kx;
  }
  const size_t out = (((size_t)bank.t * g.h + y) * g.w + x) * g.topk + slot_i;
  out_s[out] = s;
  out_i[out] = idx;
}

// A warp's top-k list, lane l holding entry l (l < topk): insert the
// lanes' candidates (cs, co) with `valid` that beat the list's last
// entry, each at the place the full comparator gives it (merge_query's
// ballot and shuffle).
__device__ __forceinline__ void warp_insert(float& es, int& eo, float& ts,
                                            int& to, float cs, int co,
                                            bool valid, int topk) {
  const int lane = threadIdx.x & 31;
  unsigned want = __ballot_sync(FULL, valid && wtk::better(cs, co, ts, to));
  while (want) {
    const int b = __ffs(want) - 1;
    want &= want - 1;
    const float bs = __shfl_sync(FULL, cs, b);
    const int bo = __shfl_sync(FULL, co, b);
    if (!wtk::better(bs, bo, ts, to)) continue;  // uniform
    const int pos = __popc(
        __ballot_sync(FULL, lane < topk && wtk::better(es, eo, bs, bo)));
    const float up_s = __shfl_up_sync(FULL, es, 1);
    const int up_o = __shfl_up_sync(FULL, eo, 1);
    if (lane == pos) {
      es = bs;
      eo = bo;
    } else if (lane > pos && lane < topk) {
      es = up_s;
      eo = up_o;
    }
    ts = __shfl_sync(FULL, es, topk - 1);
    to = __shfl_sync(FULL, eo, topk - 1);
  }
}

// Shared memory of a walk: the ring (each stage: NKR key rows x {H, L} x
// N keys x 64 bytes, then QH x 16 query cells of 64 bytes), then the
// running sums [NKR][QH * 16][2r + 1] (pre-scores of the group's key rows,
// scaled when complete).
__host__ __device__ inline size_t ring_floats(int qh, int n) {
  return (size_t)STAGES * (nkr_of(n) * 2 * n + qh * TW) * CC;
}
__host__ __device__ inline size_t sums_floats(int qh, int n, int r) {
  return (size_t)nkr_of(n) * qh * TW * (2 * r + 1);
}

// Where a walk is: bank frame fi, key-row group gi, chunk; advance() steps
// to the next chunk.
struct Pos {
  int fi, gi, chunk;
  __device__ void advance(int n_kyg, int n_chunks) {
    if (++chunk == n_chunks) {
      chunk = 0;
      if (++gi == n_kyg) {
        gi = 0;
        ++fi;
      }
    }
  }
};

// The pre-scores of the block's QH query rows x 16 columns against the
// bank, a group of NKR key rows at a time: Epi's group(ky0, oj, twice)
// runs after each group's last chunk, all threads, with the group's
// pre-scores (times inv_tau) in `sums`.
template <int QH, int N, class Epi>
__device__ void walk(const float* __restrict__ feats, const Bank& bank,
                     int y0, int x0, const Geometry& g, const int* band,
                     float* smem, float* sums, Epi& epi) {
  constexpr int NKR = nkr_of(N);
  constexpr int KPW = kpw_of(N);
  constexpr int NT = threads_of(QH, N);
  constexpr int QN = QH * TW;
  constexpr int KEY4 = N * CC / 4;            // float4 slots of a key part
  constexpr int STAGE4 = (NKR * 2 * N + QN) * (CC / 4);
  constexpr int KSLOTS = (NKR * KEY4 + NT - 1) / NT;
  constexpr int QSLOTS = (QN * 4 + NT - 1) / NT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;       // in its warpgroup
  const int wg = tid >> 7;
  const int half = wg % (QH / 4);        // query rows 4 half .. + 3
  const int kp0 = (wg / (QH / 4)) * KPW; // key rows kp0 .. + KPW - 1
  const int qrow = 4 * half + warp;      // this warp's query row
  const int r = g.r;
  const int SW = g.span;
  const int ky_begin = max(0, y0 - r);
  const int ky_end = min(g.h, y0 + QH + r);
  const int n_kyg = (ky_end - ky_begin + NKR - 1) / NKR;
  const int n_chunks = (g.C + CC - 1) / CC;
  const int steps = bank.count() * n_kyg * n_chunks;
  const size_t row_floats = (size_t)g.w * g.C;
  float4* ring = reinterpret_cast<float4*>(smem);

  // The thread's copies. Key slot j of key row kr is key 8 (j / 32) + j %
  // 8, quad (j / 8) % 4 (the core-matrix layout, contiguous in j): the raw
  // key goes to the row's H part (the tensor cores read its TF32 part, its
  // truncation), and the thread later writes x - trunc(x) to the same slot
  // of the L part. A query slot is quad i % 4 of cell i / 4.
  Pos next{0, 0, 0};  // the next step to stage
  auto issue = [&](int s) {
    if (s < steps) {
      const int ky0 = ky_begin + next.gi * NKR;
      const size_t base = bank.frame(next.fi) + (size_t)ky0 * row_floats +
                          next.chunk * CC;
      float4* st = ring + (s % STAGES) * STAGE4;
#pragma unroll
      for (int k = 0; k < KSLOTS; ++k) {
        const int i = tid + k * NT;
        const int kr = i / KEY4;
        const int j = i - kr * KEY4;
        const int n = 8 * (j >> 5) + (j & 7);
        const int quad = (j >> 3) & 3;
        const int kx = x0 - r + n;
        const bool ok = n < TW + 2 * r && kx >= 0 && kx < g.w &&
                        ky0 + kr < ky_end &&
                        next.chunk * CC + 4 * quad < g.C;
        if (i < NKR * KEY4)
          wtk::cp_async16(st + kr * 2 * KEY4 + j,
                          ok ? feats + base + kr * row_floats +
                                   (size_t)kx * g.C + 4 * quad
                             : feats,
                          ok);
      }
      float4* qst = st + NKR * 2 * KEY4;
      const size_t qbase = (size_t)bank.t * bank.fs + next.chunk * CC;
#pragma unroll
      for (int k = 0; k < QSLOTS; ++k) {
        const int i = tid + k * NT;
        const int qc = i >> 2;
        const int quad = i & 3;
        const int yy = y0 + qc / TW;
        const int xx = x0 + qc % TW;
        const bool ok = yy < g.h && xx < g.w &&
                        next.chunk * CC + 4 * quad < g.C;
        if (i < QN * 4)
          wtk::cp_async16(qst + slot(qc, quad),
                          ok ? feats + qbase + (size_t)yy * row_floats +
                                   (size_t)xx * g.C + 4 * quad
                             : feats,
                          ok);
      }
      next.advance(n_kyg, n_chunks);
    }
    wtk::cp_async_commit();  // an empty group past the end keeps the count
  };
  // The L parts of stage s's keys, from the raw keys this thread copied
  // there (its own copies: cp.async.wait_group covers them).
  auto split_keys = [&](int s) {
    float4* st = ring + (s % STAGES) * STAGE4;
#pragma unroll
    for (int k = 0; k < KSLOTS; ++k) {
      const int i = tid + k * NT;
      if (i >= NKR * KEY4) continue;
      const int kr = i / KEY4;
      float4* h = st + kr * 2 * KEY4 + (i - kr * KEY4);
      const float4 v = *h;
      float4 lo;
      lo.x = v.x - __uint_as_float(__float_as_uint(v.x) & TF32_HI);
      lo.y = v.y - __uint_as_float(__float_as_uint(v.y) & TF32_HI);
      lo.z = v.z - __uint_as_float(__float_as_uint(v.z) & TF32_HI);
      lo.w = v.w - __uint_as_float(__float_as_uint(v.w) & TF32_HI);
      h[KEY4] = lo;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  wtk::cp_async_wait<STAGES - 2>();
  split_keys(0);
  fence_async();
  float acc[KPW][N / 2] = {};
  bool on[KPW];            // the warpgroup computes key row kp0 + kp
  uint64_t in_band[KPW];   // this thread's accumulators of in-band pairs
  const int g8 = lane >> 2;
  const int tig = lane & 3;
  // accumulator 4 j + i is query (qrow, g8 + 8 (i / 2)) against key
  // column 8 j + 2 tig + i % 2: its running sum sits at lane_sum + 8 j + i
  // % 2 + (i / 2) (8 SW - 8) of the key row's sums
  const int lane_sum = (qrow * TW + g8) * SW + 2 * tig - g8;
  Pos at{0, 0, 0};
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // stage s is split; step s - 1's stage is free
    const int chunk = at.chunk;
    const int ky0 = ky_begin + at.gi * NKR;
    if (chunk == 0) {
#pragma unroll
      for (int kp = 0; kp < KPW; ++kp) {
        const int ky = ky0 + kp0 + kp;
        on[kp] = false;
        int e_own = -1;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int y = y0 + 4 * half + m;
          const int ady = abs(ky - y);
          const int e = y < g.h && ky < ky_end && ady <= r ? band[ady] : -1;
          on[kp] |= e >= 0;
          if (m == warp) e_own = e;
        }
        in_band[kp] = 0;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qx = g8 + 8 * (i >> 1);
            const int dx = 8 * j + 2 * tig + (i & 1) - r - qx;
            if (x0 + qx < g.w && dx >= -e_own && dx <= e_own)
              in_band[kp] |= 1ull << (4 * j + i);
          }
      }
    }

    const float4* st = ring + (s % STAGES) * STAGE4;
    const bool fresh = chunk % FLUSH == 0;
    bool any = false;
#pragma unroll
    for (int kp = 0; kp < KPW; ++kp) any |= on[kp];
    uint32_t ah[2][4], al[2][4];
    if (any) {  // warpgroup-uniform
      // A: this warp's 16 queries (query row qrow), both k-steps, split
      // before the fence
      const float4* qst = st + NKR * 2 * KEY4;
      const int cell = qrow * TW + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t v[4];
        ldsm_x4(v, qst + slot(cell, 2 * ks + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[ks][i] = v[i] & TF32_HI;
          al[ks][i] = __float_as_uint(__uint_as_float(v[i]) -
                                      __uint_as_float(ah[ks][i]));
        }
      }
      wg_fence();
#pragma unroll
      for (int kp = 0; kp < KPW; ++kp) {
        if (!on[kp]) continue;
        const float4* kh = st + (kp0 + kp) * 2 * KEY4;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint64_t dh = desc_of(kh + ks * 16);
          const uint64_t dl = desc_of(kh + KEY4 + ks * 16);
          wgmma<N>(acc[kp], ah[ks], dh, !(fresh && ks == 0));
          wgmma<N>(acc[kp], ah[ks], dl, 1);
          wgmma<N>(acc[kp], al[ks], dh, 1);
        }
      }
      wg_commit();
    }
    // while the tensor cores work: split stage s + 1 (this thread's copies
    // landed), stage s + 2 into step s - 1's stage
    wtk::cp_async_wait<0>();
    if (s + 1 < steps) {
      split_keys(s + 1);
      fence_async();
    }
    issue(s + STAGES - 1);
    if (any) {
      wg_wait();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pin(ah[ks][i]);
          pin(al[ks][i]);
        }
#pragma unroll
      for (int kp = 0; kp < KPW; ++kp)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) pin(acc[kp][i]);
    }

    const bool last = chunk == n_chunks - 1;
    if (last || chunk % FLUSH == FLUSH - 1) {
      // add the in-band pairs of the accumulators to the running sums (the
      // first 128 channels set them; the last addition scales)
      const bool first = chunk < FLUSH;
      const int hstep = 8 * SW - 8;
#pragma unroll
      for (int kp = 0; kp < KPW; ++kp) {
        float* base = sums + (kp0 + kp) * QN * SW + lane_sum;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!((in_band[kp] >> (4 * j + i)) & 1)) continue;
            float* p = base + 8 * j + (i & 1) + (i >> 1) * hstep;
            float v = first ? acc[kp][4 * j + i] : *p + acc[kp][4 * j + i];
            if (last) v = v * g.inv_tau;
            *p = v;
          }
      }
    }
    if (last) epi.group(ky0, bank.order_j(at.fi), bank.twice(at.fi));
    at.advance(n_kyg, n_chunks);
  }
  wtk::cp_async_wait<0>();
}

// Kernel 2's group step: the tile's queries merge each key row's
// pre-scores into their top-32 lists (wtk::merge_query, with the tau
// exit).
template <int NKR>
struct ListMerge {
  const Geometry& g;
  const Geometry& gl;  // g with topk = LIST
  const wtk::Lists& L;
  const int* band;
  const float* sums;
  int y0, x0, ky_end;

  __device__ void group(int ky0, int oj, bool twice) {
    constexpr int QN = QH1 * TW;
    constexpr int QPW = 32 / NKR;  // queries a warp checks at once
    __syncthreads();  // the running sums are complete
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const int r = g.r;
    // candidates of query qq against key row ky0 + k
    const auto cand = [&](int qq, int k) {
      wtk::Candidates cc{sums, 0, -1, 0};
      const int y = y0 + qq / TW;
      const int x = x0 + qq % TW;
      const int dy = ky0 + k - y;
      if (ky0 + k >= ky_end || y >= g.h || x >= g.w || abs(dy) > r)
        return cc;
      const int e = band[abs(dy)];
      cc.row = sums + ((size_t)k * QN + qq) * g.span + r;
      cc.dx_begin = max(-e, -x);
      cc.dx_end = min(e, g.w - 1 - x);
      cc.o_row = (oj * g.span + dy + r) * g.span + r;
      return cc;
    };
    // each lane checks one (query, key row) against the query's last
    // entry; a query's key rows lie in one warp, whose hits merge one at a
    // time, so no two warps touch one list
    for (int q0 = 0; q0 < QN; q0 += nwarps * QPW) {
      const int q = q0 + (threadIdx.x >> 5) + nwarps * (lane % QPW);
      const int k = lane / QPW;
      bool hit = false;
      if (q < QN) {
        const wtk::Candidates c = cand(q, k);
        const float tail_s = L.s[q * LIST + LIST - 1];
        const int tail_o = L.o[q * LIST + LIST - 1];
        for (int dx = c.dx_begin; dx <= c.dx_end; ++dx)
          hit |= wtk::better(c.row[dx], c.o_row + dx, tail_s, tail_o);
      }
      unsigned hits = __ballot_sync(FULL, hit);
      while (hits) {
        const int b = __ffs(hits) - 1;
        hits &= hits - 1;
        const int qb = __shfl_sync(FULL, q, b);
        wtk::merge_query(qb, cand(qb, b / QPW), twice, L, gl);
      }
    }
  }
};

// Kernel 3's group step: every key whose pre-score reaches its query's
// threshold joins the query's list in global scratch (frame 0's keys twice
// while t <= P).
template <int NKR>
struct Collect {
  const Geometry& g;
  const int* band;
  const float* sums;
  const float* tau;  // [64] thresholds, +inf: not overflowing
  int* count;        // [64]
  int* keys;         // [64][window]
  int window, y0, x0, ky_end;

  __device__ void group(int ky0, int oj, bool twice) {
    constexpr int QN = QH2 * TW;
    __syncthreads();  // the running sums are complete
    const int r = g.r;
    const int SW = g.span;
    const int span2 = SW * SW;
    for (int i = threadIdx.x; i < NKR * QN * SW; i += blockDim.x) {
      const int k = i / (QN * SW);
      const int qi = i / SW - k * QN;
      const int dx = i % SW - r;
      const int ky = ky0 + k;
      const int dy = ky - (y0 + qi / TW);
      const int x = x0 + qi % TW;
      if (ky >= ky_end || abs(dy) > r) continue;
      const float t = tau[qi];
      if (t == INFINITY || abs(dx) > band[abs(dy)] || x + dx < 0 ||
          x + dx >= g.w || !(sums[i] >= t))
        continue;
      const int o = (oj * SW + dy + r) * SW + dx + r;
      const int at = atomicAdd(count + qi, twice ? 2 : 1);
      keys[(size_t)qi * window + at] = o;
      if (twice) keys[(size_t)qi * window + at + 1] = o + span2;
    }
  }
};

template <int N, int NT = threads_of(QH1, N)>
__global__ void __launch_bounds__(NT, 1)
    video_topk_tc_kernel(const float* __restrict__ feats,
                         float* __restrict__ out_s,
                         long long* __restrict__ out_i, int P,
                         Geometry g, Margin mg, Work wk,
                         unsigned long long* __restrict__ stats) {
  extern __shared__ float4 smem4[];
  constexpr int NKR = nkr_of(N);
  constexpr int QN = QH1 * TW;
  __shared__ int band[wtk::MAX_OFFSET + 1];
  __shared__ int overflow_unit[QH1 / 4];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = blockIdx.y + 1;
  const int y0 = (blockIdx.x / wk.tiles_x) * QH1;
  const int x0 = (blockIdx.x % wk.tiles_x) * TW;
  const size_t fs = (size_t)g.h * g.w * g.C;
  const Bank bank{feats, fs, t, P, t <= P};
#pragma unroll
  for (int i = 0; i <= wtk::MAX_OFFSET; ++i)
    if (tid == i) band[i] = g.band.e[i];
  if (tid < QH1 / 4) overflow_unit[tid] = 0;
  float* smem = reinterpret_cast<float*>(smem4);
  float* sums = smem + ring_floats(QH1, N);
  float* lists = sums + sums_floats(QH1, N, g.r);
  const wtk::Lists L{lists, reinterpret_cast<int*>(lists + QN * LIST)};
  for (int i = tid; i < QN * LIST; i += NT) {
    L.s[i] = -INFINITY;
    L.o[i] = INT_MAX;
  }
  Geometry gl = g;
  gl.topk = LIST;
  ListMerge<NKR> epi{g, gl, L, band, sums, y0, x0,
                     min(g.h, y0 + QH1 + g.r)};
  __syncthreads();
  walk<QH1, N>(feats, bank, y0, x0, g, band, smem, sums, epi);
  __syncthreads();

  // The exact re-rank, a warp a query (Margin in the note).
  const float n2 = __fmul_ru(__uint_as_float(*wk.n2_bits), mg.grow);
  const float m = __fmaf_ru(mg.coef, n2, mg.absolute);
  const float m2 = 2.f * m;
  const int topk = g.topk;
  unsigned long long rescored = 0, overflowed = 0;
  for (int q = tid >> 5; q < QN; q += NT / 32) {
    const int y = y0 + q / TW;
    const int x = x0 + q % TW;
    if (y >= g.h || x >= g.w) continue;  // uniform
    const float es = L.s[q * LIST + lane];
    const int eo = L.o[q * LIST + lane];
    const bool valid = eo != INT_MAX;
    const float theta = __shfl_sync(FULL, es, topk - 1);
    const bool have_k = __shfl_sync(FULL, valid, topk - 1);
    const float tau0 = have_k ? __fsub_rd(theta, m2) : -INFINITY;
    const bool cand = valid && es >= tau0;
    const float s = cand ? rescore(eo, bank, y, x, g) : -INFINITY;
    const int o = cand ? eo : INT_MAX;
    int rank = 0;
    for (int i = 0; i < 32; ++i) {
      const float si = __shfl_sync(FULL, s, i);
      const int oi = __shfl_sync(FULL, o, i);
      rank += wtk::better(si, oi, s, o);
    }
    const int ncand = __popc(__ballot_sync(FULL, cand));
    rescored += ncand;
    float tau = -INFINITY;
    if (ncand >= topk) {
      const int at = __ffs(__ballot_sync(FULL, cand && rank == topk - 1)) - 1;
      tau = __fsub_rd(__shfl_sync(FULL, s, at), m);
    }
    const bool full = __shfl_sync(FULL, valid, LIST - 1);
    const float p_last = __shfl_sync(FULL, es, LIST - 1);
    const size_t qi = ((size_t)(t - 1) * g.h + y) * g.w + x;
    if (full && p_last >= tau) {  // uniform: kernel 3 takes the query
      if (lane == 0) {
        wk.thr[qi] = tau;
        overflow_unit[q / (4 * TW)] = 1;
      }
      ++overflowed;
      continue;
    }
    if (lane == 0) wk.thr[qi] = INFINITY;
    if (cand && rank < topk) store(s, o, rank, bank, y, x, g, out_s, out_i);
    if (lane >= ncand && lane < topk)
      store(0.f, INT_MAX, lane, bank, y, x, g, out_s, out_i);
  }
  if (lane == 0) {
    add_stat(stats, RESCORED, rescored);
    add_stat(stats, OVERFLOWED, overflowed);
  }
  __syncthreads();
  if (tid < QH1 / 4 && overflow_unit[tid]) {
    const int at = atomicAdd(wk.units_queued, 1);
    wk.units[at] = ((t - 1) * ((g.h + 3) / 4) + y0 / 4 + tid) * wk.tiles_x +
                   blockIdx.x % wk.tiles_x;
  }
}

template <int N, int NT = threads_of(QH2, N)>
__global__ void __launch_bounds__(NT, 1)
    video_topk_overflow_kernel(const float* __restrict__ feats,
                               float* __restrict__ out_s,
                               long long* __restrict__ out_i, int P,
                               Geometry g, Work wk,
                               unsigned long long* __restrict__ stats) {
  extern __shared__ float4 smem4[];
  constexpr int NKR = nkr_of(N);
  constexpr int QN = QH2 * TW;
  __shared__ int band[wtk::MAX_OFFSET + 1];
  __shared__ float tau[QN];
  __shared__ int count[QN];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
#pragma unroll
  for (int i = 0; i <= wtk::MAX_OFFSET; ++i)
    if (tid == i) band[i] = g.band.e[i];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sums = smem + ring_floats(QH2, N);
  int* keys = wk.scratch + (size_t)blockIdx.x * QN * wk.window;
  const size_t fs = (size_t)g.h * g.w * g.C;
  const int hq = (g.h + 3) / 4;
  const int queued = *wk.units_queued;
  unsigned long long rescored = 0;
  for (int u = blockIdx.x; u < queued; u += gridDim.x) {
    const int code = wk.units[u];
    const int tile = code % wk.tiles_x;
    const int tq = code / wk.tiles_x;
    const int y0 = 4 * (tq % hq);
    const int t = tq / hq + 1;
    const int x0 = tile * TW;
    const Bank bank{feats, fs, t, P, t <= P};
    for (int qi = tid; qi < QN; qi += NT) {
      const int y = y0 + qi / TW;
      const int x = x0 + qi % TW;
      tau[qi] = y < g.h && x < g.w
                    ? wk.thr[((size_t)(t - 1) * g.h + y) * g.w + x]
                    : INFINITY;
      count[qi] = 0;
    }
    __syncthreads();
    Collect<NKR> epi{g,  band, sums, tau, count, keys, wk.window,
                     y0, x0,   min(g.h, y0 + QH2 + g.r)};
    walk<QH2, N>(feats, bank, y0, x0, g, band, smem, sums, epi);
    __syncthreads();
    for (int qi = tid >> 5; qi < QN; qi += NT / 32) {
      if (tau[qi] == INFINITY) continue;  // uniform
      const int y = y0 + qi / TW;
      const int x = x0 + qi % TW;
      const int n = count[qi];
      rescored += n;
      float es = -INFINITY, ts = -INFINITY;
      int eo = INT_MAX, to = INT_MAX;
      for (int b = 0; b < n; b += 32) {
        const bool in = b + lane < n;
        const int o = in ? keys[(size_t)qi * wk.window + b + lane] : INT_MAX;
        const float s = in ? rescore(o, bank, y, x, g) : -INFINITY;
        warp_insert(es, eo, ts, to, s, o, in, g.topk);
      }
      if (lane < g.topk) store(es, eo, lane, bank, y, x, g, out_s, out_i);
    }
    __syncthreads();  // tau and count are the next unit's
  }
  if (lane == 0) add_stat(stats, RESCORED, rescored);
}
// The largest squared norm of rows of C channels, a warp a row, as float
// bits (non-negative floats order as their bits).
__global__ void __launch_bounds__(256)
    video_topk_norm_kernel(const float* __restrict__ feats, long long rows,
                           int C, unsigned* __restrict__ n2_bits) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  float best = 0.f;
  for (long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       row < rows; row += warps) {
    const float* p = feats + row * C;
    float a = 0.f;
    for (int c = 4 * lane; c < C; c += 128) {
      const float4 v = wtk::load_global4(p + c);
      a = fmaf(v.x, v.x, a);
      a = fmaf(v.y, v.y, a);
      a = fmaf(v.z, v.z, a);
      a = fmaf(v.w, v.w, a);
    }
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(FULL, a, off);
    best = fmaxf(best, a);
  }
  if (lane == 0 && best > 0.f) atomicMax(n2_bits, __float_as_uint(best));
}

// One k8 step of wgmma m64n56 (the main kernel's shape) a problem, a
// warpgroup a problem, on given operands: a (64 x 8), b (56 x 8, a key's 8
// channels a row), c and d (64 x 56), all row-major; the operands are
// passed as they are (the tensor cores read their TF32 part).
__global__ void __launch_bounds__(128)
    video_topk_mma_check_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ c,
                                float* __restrict__ d) {
  constexpr int N = 56;
  __shared__ __align__(128) float bs[N * 8];
  const size_t p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int gq = lane >> 2;
  const int tg = lane & 3;
  for (int i = tid; i < N * 8; i += 128) {  // core matrices, 2 along K
    const int n = i / 8;
    const int k = i % 8;
    bs[(n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + k % 4] = b[p * N * 8 + i];
  }
  const float* A = a + p * 512;
  uint32_t av[4] = {__float_as_uint(A[(16 * w + gq) * 8 + tg]),
                    __float_as_uint(A[(16 * w + gq + 8) * 8 + tg]),
                    __float_as_uint(A[(16 * w + gq) * 8 + tg + 4]),
                    __float_as_uint(A[(16 * w + gq + 8) * 8 + tg + 4])};
  float acc[N / 2];
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i)
      acc[4 * j + i] = c[p * 64 * N + (16 * w + gq + 8 * (i >> 1)) * N +
                         8 * j + 2 * tg + (i & 1)];
  __syncthreads();
  // the check's B holds an 8-key group a 256 bytes (two core matrices)
  wg_fence();
  wgmma<N>(acc, av, desc_of(bs, 256), 1);
  wg_commit();
  wg_wait();
  for (int i = 0; i < N / 2; ++i) pin(acc[i]);
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i)
      d[p * 64 * N + (16 * w + gq + 8 * (i >> 1)) * N + 8 * j + 2 * tg +
        (i & 1)] = acc[4 * j + i];
}

template <int N>
cudaError_t launch(const float* feats, float* out_s,
                   long long* out_i, int T, int P, const Geometry& g,
                   const Margin& mg, const Work& wk, int units_grid,
                   unsigned long long* stats, cudaStream_t stream) {
  auto main_kernel = video_topk_tc_kernel<N>;
  const size_t smem = sizeof(float) * (ring_floats(QH1, N) +
                                       sums_floats(QH1, N, g.r) +
                                       (size_t)2 * QH1 * TW * LIST);
  cudaError_t err = wtk::allow_smem(main_kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = wk.tiles_x * ((g.h + QH1 - 1) / QH1);
  main_kernel<<<dim3(tiles, T - 1), threads_of(QH1, N), smem, stream>>>(
      feats, out_s, out_i, P, g, mg, wk, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto unit_kernel = video_topk_overflow_kernel<N>;
  const size_t smem2 = sizeof(float) * (ring_floats(QH2, N) +
                                        sums_floats(QH2, N, g.r));
  err = wtk::allow_smem(unit_kernel, smem2);
  if (err != cudaSuccess) return err;
  unit_kernel<<<units_grid, threads_of(QH2, N), smem2, stream>>>(
      feats, out_s, out_i, P, g, wk, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row 1's fp32 entry on the tensor cores: video_topk_affinity.cu's
// vfs_video_topk_affinity (same arguments, same outputs), plus `work`
// (window_geometry.tc_workspace_ints(T, h, w, P, r, units_grid) int32
// words), `stats`
// (null, or 2 uint64 counters the kernels add to: keys re-scored, queries
// overflowed), the margin's coef and absolute
// (window_geometry.prescore_margin), the norm bound's rounding `grow`
// (window_geometry.norm_grow) and `units_grid`, the overflow kernel's
// blocks. `work` needs no initial value.
int vfs_video_topk_tc(const void* feats, void* scores, void* src, void* work,
                      void* stats, int T, int h, int w, int C,
                      int r, const int* band, float inv_tau, int topk, int P,
                      float coef, float absolute, float grow, int units_grid,
                      void* stream) {
  if (T < 2 || T - 1 > 65535 || h < 1 || w < 1 || C < 4 || C % 4 != 0 ||
      P < 1 || units_grid < 1 || !wtk::check_band(r, band, topk) ||
      (long long)T * h * w >= INT_MAX ||
      (long long)(P + 1) * (2 * r + 1) * (2 * r + 1) >= INT_MAX / 64)
    return (int)cudaErrorInvalidValue;
  const Geometry g = wtk::make_geometry(h, w, C, r, band, inv_tau, topk);
  const float* f = static_cast<const float*>(feats);
  float* s = static_cast<float*>(scores);
  long long* i = static_cast<long long*>(src);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = make_work(work, T, h, w, P, r);
  const Margin mg{coef, absolute, grow};
  unsigned long long* counters = static_cast<unsigned long long*>(stats);
  cudaError_t err = cudaMemsetAsync(work, 0, 8 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  video_topk_norm_kernel<<<528, 256, 0, st>>>(f, (long long)T * h * w, C,
                                              wk.n2_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (strip_of(r) == 56)
    return (int)launch<56>(f, s, i, T, P, g, mg, wk, units_grid, counters,
                           st);
  return (int)launch<80>(f, s, i, T, P, g, mg, wk, units_grid, counters, st);
}

// n single k8 wgmma steps (video_topk_mma_check_kernel), for the
// accumulation model's check: a holds n x 64 x 8 floats, b n x 56 x 8, c
// and d n x 64 x 56.
int vfs_video_topk_mma_check(const void* a, const void* b, const void* c,
                             void* d, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  video_topk_mma_check_kernel<<<n, 128, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(d));
  return (int)cudaGetLastError();
}

}  // extern "C"
