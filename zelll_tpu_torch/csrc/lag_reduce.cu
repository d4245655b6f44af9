// K1 on Hopper: the lag-window pair reduction over key-sorted particles.
//
// Replaces the TPU kernel zelll_tpu/ops/pallas_pairs.py::_make_kernel (via
// pair_lag_reduce). It computes the same function:
//
//   sum over slots i and lags 1..L, j = i - lag >= 0, of term(dsq(i, j))
//   where key_j >= key_i - W  (candidate key window, W = sum(strides))
//     and dsq < csq           (strict cutoff)
//
// with dsq accumulated from 0 axis by axis, and in split mode each axis'
// separation d = (hi_i - hi_j) + (lo_i - lo_j). Terms: LJ 4 t3 (t3 - 1),
// t = 1/dsq by true division, the LJ pair virial 24 t3 (2 t3 - 1), or
// count (1). There is no dsq > 0 exclusion:
// coincident real particles count, as in the reference.
//
// What it does not copy: the TPU kernel's rolling VMEM window, lane rolls
// and sequential grid are Mosaic devices. The index bound j >= 0 replaces
// the TPU's tail padding. Padding rows (SENTINEL_KEY, sorted last) read as
// ascending spaced keys above every real key, the key rule of
// pallas_pairs.py::_pad_and_desentinel with no tail padding, so they end
// the key window instead of holding it open.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n, read once: 280 MB at n = 1e7 in split mode, 84 us at
// 3.35 TB/s. Operations, counted as FP32 instructions with FMA contraction
// allowed: 13 for each candidate pair in the key window (7 without split)
// plus 12 for each pair inside the cutoff (the IEEE division, the LJ term
// and the f64 add). The benchmark's thin box has 122.8 candidates and 16
// cutoff pairs per slot (chip_smoke.py counts them on the card), 1.8e10
// instructions at n = 1e7: 0.53 ms at 33.5 T instructions/s (the 67 TFLOP/s
// f32 peak counts an FMA as two). So it is bound by operations, that is by
// the instructions issued per evaluated lane. A thread that walked its own
// lags would issue scalar global loads (the key and 3 or 6 coordinates per
// step) that no other lane shares and run its warp to the longest walk.
// --fmad=false (below) gives up the contraction, so the kernel runs more
// than the bound counts.
//
// Design: a one-sided cluster sweep on cluster_sweep.cuh, K3's
// (lag_forces.cu) with the lags behind each slot only. Lane i's partners
// are the slots [jlo_i, i - 1], where jlo_i, found by binary search over
// the keys, is the larger of i - L and the first slot with key_j >=
// key_i - W: keys ascend, so that is exactly the set of lags 1..L in the
// key window, and the lag bound holds where the window is still open (the
// result stays defined where the coverage flag is False). A warp owns a
// cluster of 32 consecutive slots and keeps its own coordinates and range
// in registers; warps run on their own until the block's final fold. Each
// warp
//   1. reduces its cluster's box over the real slots (< n), from the
//      coordinates of this launch, and in split mode the largest |lo| per
//      axis;
//   2. walks the union of its lanes' ranges, [jlo of its first slot, its
//      last real slot - 1] (jlo ascends with i): lane t loads row j0 + t of
//      the (n, dim) arrays and tests the point against the own box; a
//      ballot compacts the survivors, in slot order, into the warp's buffer
//      in shared memory as float4 (x, y, z, slot), plus the low parts in
//      split mode;
//   3. sweeps the buffer 32 entries at a time (reduce_sweep): each lane
//      reads each entry by a broadcast and adds the term where jlo_i <= j <
//      i and dsq < csq. Here the term inline beat hit bits and a term per
//      hit (K6's form), and sweeps of 32 beat 64 (timed on the card;
//      PERF.md).
// Split mode keeps the reference's rule, dsq < csq on the f32 dsq of the
// split separations (no tie band, unlike K3); the prune's split threshold
// is a superset of it. There is no dsq > 0 exclusion: coincident real
// particles count, as in the reference.
//
// Periodic boxes (ops/pbc.py) add two instances, as template parameters of
// the same body (lag_reduce_pbc_kernel; the open-boundary instances keep
// their names and code):
//   KEEP: the TPU kernel's payload term pbc._pbc_term, mask id 2. One
//     payload plane w holds each slot's shift sign (0 real, +/-1 ghost);
//     an entry carries its w in a third buffer beside the coordinates,
//     the lane its own in a register, and the pair counts only where
//     (w_i w_j == 0) & (w_i + w_j >= 0) (keep_pair), one more lane mask
//     before the term.
//   MI: in-kernel minimum image (pallas_pairs.py::_mi_pair_d, mi_box /
//     key_reach): each separation is folded by one box length where
//     |s| > box / 2 (mi_axis; split mode carries the two-diff of the hi
//     difference into the low term), the key window W is the caller's
//     widened sum(strides * reach), and the prune takes the gap to the
//     nearest periodic image of each j point (near_box_mi).
// Both compose, with each term, f32 and split.
//
// Accumulation: each lane sums its f32 terms in f64 (as good as the TPU's
// per-lane f32 Kahan sum, and simpler); the block folds its lanes in a
// fixed order (block_fold) and writes one partial per block. The caller
// sums the partials (the analogue of the jnp.sum outside the TPU kernel).
// No float atomics, so the result is deterministic. Integer terms sum in
// int64 per block, so counts cannot wrap at n = 1e8. No single PyTorch call
// computes this function, so there is no library time to compare with.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence pair counts match it
// bitwise on identical sorted inputs, and the prune's bound holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / kWarp;
// the term inline in the sweep, not per hit after the hit bits (reduce_sweep)
constexpr bool kTwoPhase = false;
constexpr int kBuf = 2 * kWarp;  // a warp's buffer: a sweep + a cluster
constexpr int kMaxDim = 3;
// The C interface's terms (lag_pairs._KERNEL_TERMS)
constexpr int kArgLj = 0;
constexpr int kArgCount = 1;
constexpr int kArgVirial = 2;
// The payload rules (lag_pairs._MASK_*): none, the periodic keep mask
constexpr int kMaskNone = 0;
constexpr int kMaskKeep = 2;

struct Args {
  const float* pos;      // (n, dim) row-major
  const float* lo;       // (n, dim) low parts, or null
  const float* w;        // (n,) shift signs (the keep mask), or null
  const int32_t* keys;   // (n,) ascending, SENTINEL_KEY rows last
  const int32_t* w_key;  // one int32 on the device
  int n;
  int dim;
  int L;
  int spacing;
  float csq;
  float3 mib;            // minimum image: box lengths, 0 on open axes
  void* partial;         // one per block
};

// Row j of an (n, dim) row-major array, w's bits in .w; absent axes read 0,
// which adds exactly 0 to dsq and to the box gap.
__device__ __forceinline__ float4 load_row(const float* rows, int dim, int j,
                                           int32_t w) {
  const float* r = rows + static_cast<int64_t>(j) * dim;
  float4 v = make_float4(r[0], 0.0f, 0.0f, __int_as_float(w));
  if (dim > 1) v.y = r[1];
  if (dim > 2) v.z = r[2];
  return v;
}

template <bool SPLIT, int TERM, typename Acc, bool KEEP, bool MI>
__device__ __forceinline__ void lag_reduce_body(const Args& a) {
  __shared__ float4 buf_hi[kWarps][kBuf];
  __shared__ float4 buf_lo[kWarps][SPLIT ? kBuf : 1];
  __shared__ float buf_w[kWarps][KEEP ? kBuf : 1];
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = blockIdx.x * kBlock + w * kWarp;  // the cluster's first slot
  const int i = base + lane;
  const bool real = i < a.n;
  float4* bh = buf_hi[w];
  float4* bl = buf_lo[w];
  float* bw = buf_w[w];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  Lane<Acc> o;
  o.h = real ? load_row(a.pos, a.dim, i, 0) : zero;
  o.l = SPLIT && real ? load_row(a.lo, a.dim, i, 0) : zero;
  o.key = 0;
  o.acc = Acc(0);
  o.pw = KEEP && real ? a.w[i] : 0.0f;
  o.mib = a.mib;
  // the lane's partners [jlo, i - 1]: the smallest j in [max(i - L, 0), i]
  // with key_j >= key_i - W (j = i holds), by binary search over the keys
  int jlo = i;
  if (real) {
    const int32_t lo_key = load_key(a.keys, i, a.spacing) - *a.w_key;
    int l = i > a.L ? i - a.L : 0, r = i;
    while (l < r) {
      const int m = l + (r - l) / 2;
      if (load_key(a.keys, m, a.spacing) >= lo_key) r = m; else l = m + 1;
    }
    jlo = l;
  }
  o.jlo = jlo;
  o.span = real ? static_cast<unsigned>(i - jlo) : 0u;
  // a cluster past n holds no particle: its warp only joins the fold
  if (base < a.n) {
    // the union of the lanes' ranges: jlo ascends with i
    const int first = __shfl_sync(kAll, jlo, 0);
    const int last = min(base + kWarp, a.n) - 2;  // the last real slot - 1
    const Box box = cluster_box<SPLIT>(o.h, o.l, real);
    const float thr = prune_threshold<SPLIT>(a.csq);
    const unsigned below = (1u << lane) - 1u;
    int cnt = 0;  // entries in the buffer, warp-uniform
    for (int j0 = first; j0 <= last; j0 += kWarp) {
      const int j = j0 + lane;
      const bool valid = j <= last;
      const float4 b = valid ? load_row(a.pos, a.dim, j, j) : zero;
      const float4 b_lo = SPLIT && valid ? load_row(a.lo, a.dim, j, 0) : zero;
      const float b_w = KEEP && valid ? a.w[j] : 0.0f;
      const bool keep = valid && (MI ? near_box_mi<SPLIT>(box, b, b_lo, thr, a.mib)
                                     : near_box<SPLIT>(box, b, b_lo, thr));
      compact(__ballot_sync(kAll, keep), keep, below, cnt, [&](int at) {
        bh[at] = b;
        if (SPLIT) bl[at] = b_lo;
        if (KEEP) bw[at] = b_w;
      });
      if (cnt >= kWarp) {
        __syncwarp();
        reduce_sweep<SPLIT, TERM, false, kTwoPhase, true, KEEP, MI>(o, bh, bl, nullptr, kWarp,
                                                                     a.csq, 0, 0, bw);
        __syncwarp();
        // move the remainder (less than one cluster) to the front
        cnt -= kWarp;
        shift_front<1, SPLIT>(bh, bl, kWarp, cnt, lane);
        if (KEEP) shift_front<1, false>(bw, bw, kWarp, cnt, lane);
      }
    }
    if (cnt > 0) {
      __syncwarp();
      reduce_sweep<SPLIT, TERM, false, kTwoPhase, false, KEEP, MI>(o, bh, bl, nullptr, cnt, a.csq,
                                                                    0, 0, bw);
    }
  }
  block_fold<kWarps>(o.acc, static_cast<Acc*>(a.partial));
}

// The open-boundary instances
template <bool SPLIT, int TERM, typename Acc>
__global__ void __launch_bounds__(kBlock) lag_reduce_kernel(Args a) {
  lag_reduce_body<SPLIT, TERM, Acc, false, false>(a);
}

// The periodic instances: the keep mask, the minimum image, or both
template <bool SPLIT, int TERM, typename Acc, bool KEEP, bool MI>
__global__ void __launch_bounds__(kBlock) lag_reduce_pbc_kernel(Args a) {
  lag_reduce_body<SPLIT, TERM, Acc, KEEP, MI>(a);
}

template <bool SPLIT, int TERM, typename Acc>
void launch_rule(const Args& a, bool keep, bool mi, cudaStream_t s) {
  const int blocks = (a.n + kBlock - 1) / kBlock;
  if (keep && mi)
    lag_reduce_pbc_kernel<SPLIT, TERM, Acc, true, true><<<blocks, kBlock, 0, s>>>(a);
  else if (keep)
    lag_reduce_pbc_kernel<SPLIT, TERM, Acc, true, false><<<blocks, kBlock, 0, s>>>(a);
  else if (mi)
    lag_reduce_pbc_kernel<SPLIT, TERM, Acc, false, true><<<blocks, kBlock, 0, s>>>(a);
  else
    lag_reduce_kernel<SPLIT, TERM, Acc><<<blocks, kBlock, 0, s>>>(a);
}

template <bool SPLIT, int TERM>
void launch_acc(const Args& a, bool int_out, bool keep, bool mi, cudaStream_t s) {
  if (int_out)
    launch_rule<SPLIT, TERM, long long>(a, keep, mi, s);
  else
    launch_rule<SPLIT, TERM, double>(a, keep, mi, s);
}

template <bool SPLIT>
void launch_term(const Args& a, int term, bool int_out, bool keep, bool mi,
                 cudaStream_t s) {
  if (term == kArgLj)
    launch_acc<SPLIT, kTermLj>(a, int_out, keep, mi, s);
  else if (term == kArgVirial)
    launch_acc<SPLIT, kTermVirial>(a, int_out, keep, mi, s);
  else
    launch_acc<SPLIT, kTermCount>(a, int_out, keep, mi, s);
}

}  // namespace

extern "C" {

// Threads per block: the caller allocates ceil(n / block) partials.
int zelll_lag_reduce_block() { return kBlock; }

// pos, lo: (n, dim) row-major f32 (lo null unless split); w: (n,) f32
// shift signs, read with mask 2 (the periodic keep mask) and null
// otherwise; keys: (n,) int32 ascending, SENTINEL_KEY rows last; w_key: one
// int32 on the device (the caller's window, widened for minimum image);
// spacing: the padding-key spacing, (INT32_MAX - INT32_MAX / 2 - 1) / n at
// least 1; term: 0 for LJ, 1 for count, 2 for the LJ pair virial; mask: 0
// or 2; mi != 0 folds the axes whose box length mbx, mby, mbz is > 0 to the
// minimum image; partial: ceil(n / block) doubles (int_out == 0) or int64s
// (int_out != 0). Returns cudaGetLastError() after the launch.
int zelll_lag_reduce(const void* pos, const void* lo, const void* w, const void* keys,
                     const void* w_key, int n, int dim, int L, int spacing,
                     float csq, int term, int int_out, int mask, int mi, float mbx,
                     float mby, float mbz, void* partial, void* stream) {
  if (n <= 0 || n > kSentinelKey - 2 * kWarp || dim < 1 || dim > kMaxDim ||
      L < 1 || spacing < 1 ||
      static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      (term != kArgLj && term != kArgCount && term != kArgVirial) ||
      (mask != kMaskNone && mask != kMaskKeep) || ((mask == kMaskKeep) != (w != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const float*>(pos);
  a.lo = static_cast<const float*>(lo);
  a.w = static_cast<const float*>(w);
  a.keys = static_cast<const int32_t*>(keys);
  a.w_key = static_cast<const int32_t*>(w_key);
  a.n = n;
  a.dim = dim;
  a.L = L;
  a.spacing = spacing;
  a.csq = csq;
  a.mib = mi != 0 ? make_float3(mbx, mby, mbz) : make_float3(0.0f, 0.0f, 0.0f);
  a.partial = partial;
  auto s = static_cast<cudaStream_t>(stream);
  const bool keep = mask == kMaskKeep;
  if (a.lo != nullptr)
    launch_term<true>(a, term, int_out != 0, keep, mi != 0, s);
  else
    launch_term<false>(a, term, int_out != 0, keep, mi != 0, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
