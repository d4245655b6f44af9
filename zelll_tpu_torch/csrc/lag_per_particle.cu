// K2 on Hopper: per-particle pair sums over key-sorted particles.
//
// Replaces the TPU kernel
// zelll_tpu/ops/pallas_pairs.py::_make_per_particle_kernel (:401, via
// pair_lag_per_particle :515). It computes the same function:
//
//   out_i = sum over unique pairs (p, q = p - lag), lag = 1..L, that hold i,
//           of term(dsq), where
//     key_q >= key_p - W       (candidate key window, W = sum(strides))
//     0 < dsq < csq            (strict cutoff; coincident particles excluded)
//
// with dsq = (d0 d0 + d1 d1) + d2 d2, d = pos_p - pos_q, and term the
// count (1), LJ 4 t3 (t3 - 1) with t = 1/dsq by true division, t3 = t^3,
// or (f32 coordinates) any factory's energy or virial of
// ops/potentials.py through the device term table (pair_table.cuh).
// Both ends of a pair receive its term. Coordinates are f32 or f64 and
// the output has their type.
//
// What it does not copy: the TPU kernel's Horner shift accumulator, which
// lands the smaller slot's share of each pair at its window slot because
// Mosaic has no scatter, and its rolling VMEM window and sequential grid.
// The index bounds 0 <= j < n replace the TPU's spread tail coordinates;
// padding rows (SENTINEL_KEY) read as ascending spaced keys above every
// real key, K1's rule (lag_reduce.cu).
//
// The partners of slot i form one slot range. Keys ascend, so the slots j
// behind i in its window (key_j >= key_i - W, i - j <= L) are
// [jlo_i, i - 1] and those ahead (key_i >= key_k - W, k - i <= L) are
// [i + 1, jhi_i]; each lane finds jlo_i and jhi_i by binary search over
// the keys once (ops/cluster_prune.py's lag_ranges). The lag set is exactly
// 1..L on both sides, so an undersized L drops the pairs the plain version
// drops.
//
// What bounds it on an H100: bytes are (3 coordinate planes + 1 output) x
// n x sizeof(T) + 4 n of keys, 160 MB at n = 1e7 in f32, 48 us at
// 3.35 TB/s. Operations, once per unique pair: 7 FP32 instructions for
// each half-stencil candidate and, per cutoff pair, the term and the two
// f64 adds (FP64 counted twice: half the FP32 rate), so it is bound by
// operations, that is by the instructions issued per evaluated lane. A
// thread that walked its two partner lists itself (this kernel's first
// design) issued scalar global loads that no other lane shares, ran its
// warp to the longest walk, and took the term's branch whenever one lane
// of the warp had a pair. No single PyTorch call computes this function.
//
// Design: K3's two-sided cluster sweep (lag_forces.cu) with a scalar term,
// on cluster_sweep.cuh, in f32 and f64. A warp owns a cluster of 32
// consecutive slots and keeps its own coordinates and range in registers;
// warps run on their own (no block barrier). Each warp
//   1. reduces its cluster's box over the real slots (< n) (f64: the box
//      and the gap in double; ClusterPrune);
//   2. walks the union of its lanes' ranges, [jlo of its first slot, jhi of
//      its last real slot] (jlo and jhi ascend with i, and each range holds
//      its own slot, so the union is one range; the header's
//      one_sided_walk over the (3, n) planes): lane t loads slot j0 + t and
//      tests the point against the own box with the threshold csq; a ballot
//      compacts the survivors, in slot order, into the warp's buffer in
//      shared memory (x, y, z and the slot);
//   3. sweeps the buffer 32 entries at a time: phase A reads each entry by
//      a broadcast and sets the lane's hit bit where jlo_i <= j <= jhi_i
//      (one unsigned range test) and 0 < dsq < csq hold (dsq > 0 also
//      drops the own slot, as the plain version's lag >= 1 does); phase B
//      adds the hits' popcount for the count (exact in f64), or the LJ (or
//      table) term of each hit in ascending q.
// Every pair is evaluated from both ends, and both evaluations agree
// bitwise (IEEE subtraction is exactly antisymmetric), so each end adds the
// same term. The prune drops no pair that counts (cluster_sweep.cuh says
// why), and ops/cluster_prune.py's lag_cluster_entries(half=False) counts
// these entries, as it does K3's (tests/test_torch_prune.py holds it to
// brute force, in f64 too). Sentinel rows are slots below n, so they join
// their cluster's box; a box that spans to them keeps every candidate,
// which is correct and only slow.
//
// The term table (TERM = kSumTable, f32 only): the table's kind, mode,
// constants and shift (a TermTable) come as a second kernel parameter
// beside Args, to lag_per_particle_table_kernel, so the instances above keep
// their parameters and code; phase B evaluates table_term once per hit,
// off the unrolled phase A, in the table's energy or virial mode. The
// species term needs a payload plane that K2 does not read, so the C
// interface refuses it.
//
// Accumulation: each lane sums its terms in f64, for both coordinate types,
// and writes its sum once in the coordinates' type: no scatter, no atomics,
// and the result is deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence the pair masks match
// it bitwise on identical sorted inputs, and the prune's bound holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / kWarp;
constexpr int kBuf = 2 * kWarp;  // a warp's buffer: a sweep + a cluster
// The terms, by the C interface's values (lag_pairs._KERNEL_TERMS), which
// are also the kernel's template values
constexpr int kSumLj = 0;
constexpr int kSumCount = 1;
constexpr int kSumTable = 3;  // lag_pairs._TERM_TABLE

template <typename T>
struct Args {
  const T* pos;          // (3, n) planes
  const int32_t* keys;   // (n,) ascending, SENTINEL_KEY rows last
  const int32_t* w_key;  // one int32 on the device
  int n;
  int L;
  int spacing;
  T csq;
  T* out;                // (n,)
};

// A lane: its own point, the slots it pairs with (jlo <= j < jlo + span as
// unsigned arithmetic tests it: [jlo_i, jhi_i], span = 0 for a slot at or
// past n), and its sum.
template <typename T>
struct SumLane {
  typename Vec4Of<T>::type h;
  int jlo;
  unsigned span;
  double acc;
};

// The LJ term 4 t3 (t3 - 1), t = 1/dsq by true division, in T.
template <typename T>
__device__ __forceinline__ T lj_value(T dsq) {
  const T t = T(1) / dsq;
  const T t3 = t * t * t;
  return T(4) * t3 * (t3 - T(1));
}

// Sweeps entries [0, cnt) of the warp's buffer (cnt <= 32, warp-uniform;
// FULL: cnt == 32, unrolled): phase A sets the lane's hit bits (the range,
// 0 < dsq < csq), phase B adds the count of the hits, or their LJ terms
// (the table's terms: tab) in ascending q.
template <typename T, int TERM, bool FULL, typename V = typename Vec4Of<T>::type>
__device__ __forceinline__ void sum_sweep(SumLane<T>& o, const V* bh, int cnt, T csq,
                                          const TermTable* tab = nullptr) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  unsigned hits = 0u;
  auto hit = [&](int q) {
    const V b = bh[q];
    const T dsq = sep_dsq<false>(o.h, zero, b, zero);
    const bool m = static_cast<unsigned>(tag_from(b.w) - o.jlo) < o.span && dsq < csq &&
                   dsq > T(0);
    if (m) hits |= 1u << q;
  };
  if (FULL) {
#pragma unroll
    for (int q = 0; q < kWarp; ++q) hit(q);
  } else {
#pragma unroll 4
    for (int q = 0; q < cnt; ++q) hit(q);
  }
  if (TERM == kSumCount) {
    o.acc += static_cast<double>(__popc(hits));
    return;
  }
  while (hits != 0u) {
    const int q = __ffs(static_cast<int>(hits)) - 1;
    hits &= hits - 1u;
    // the table's term as a discarded branch: the LJ instances' code is as
    // it was before the table came in
    if constexpr (TERM == kSumTable)
      o.acc += static_cast<double>(table_term(sep_dsq<false>(o.h, zero, bh[q], zero), *tab));
    else
      o.acc += static_cast<double>(lj_value(sep_dsq<false>(o.h, zero, bh[q], zero)));
  }
}

// What the walk of cluster_sweep.cuh asks of K2: no further planes, and the
// sweep.
template <typename T, int TERM, typename V = typename Vec4Of<T>::type>
struct SumSweeper {
  SumLane<T>& o;
  const V* bh;
  T csq;
  const TermTable* tab = nullptr;
  __device__ __forceinline__ void store(int, int) {}
  template <bool FULL>
  __device__ __forceinline__ void sweep(int at, int cnt) {
    if constexpr (TERM == kSumTable)
      sum_sweep<T, TERM, FULL>(o, bh + at, cnt, csq, tab);
    else
      sum_sweep<T, TERM, FULL>(o, bh + at, cnt, csq);
  }
  __device__ __forceinline__ void shift(int, int, int) {}
};

// The kernel's body; the table instances read tab.
template <typename T, int TERM>
__device__ __forceinline__ void lag_per_particle_body(const Args<T>& a,
                                                      const TermTable* tab = nullptr) {
  using V = typename Vec4Of<T>::type;
  __shared__ V buf_hi[kWarps][kBuf];
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = blockIdx.x * kBlock + w * kWarp;  // the cluster's first slot
  if (base >= a.n) return;  // the whole warp leaves together
  const int i = base + lane;
  const bool real = i < a.n;
  V* bh = buf_hi[w];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  SumLane<T> o;
  o.h = real ? load_point(a.pos, a.n, 3, i, 0) : vzero;
  o.acc = 0.0;
  // the lane's partner range [jlo, jhi] by binary search over the keys
  int jlo = i, jhi = i;
  if (real) {
    const int32_t w_key = *a.w_key;
    const int32_t key_i = load_key(a.keys, i, a.spacing);
    // smallest j in [max(i - L, 0), i] with key_j >= key_i - W (j = i holds)
    const int32_t lo_key = key_i - w_key;
    int l = i > a.L ? i - a.L : 0, r = i;
    while (l < r) {
      const int m = l + (r - l) / 2;
      if (load_key(a.keys, m, a.spacing) >= lo_key) r = m; else l = m + 1;
    }
    jlo = l;
    // largest k in [i, min(i + L, n - 1)] with key_k - W <= key_i (k = i holds)
    l = i;
    r = a.n - 1 - i > a.L ? i + a.L : a.n - 1;
    while (l < r) {
      const int m = r - (r - l) / 2;
      if (load_key(a.keys, m, a.spacing) - w_key <= key_i) l = m; else r = m - 1;
    }
    jhi = l;
  }
  o.jlo = jlo;
  o.span = real ? static_cast<unsigned>(jhi - jlo) + 1u : 0u;
  // the union of the lanes' ranges: jlo and jhi ascend with i
  const int first = __shfl_sync(kAll, jlo, 0);
  const int last = __reduce_max_sync(kAll, real ? jhi : -1);
  const ClusterPrune<T, false> prune(o.h, zero, real, a.csq);
  SumSweeper<T, TERM> sw{o, bh, a.csq, tab};
  one_sided_walk<false, true>(a.pos, nullptr, 3, first, last, lane, prune, bh, nullptr, sw,
                              a.n);
  if (real) a.out[i] = static_cast<T>(o.acc);
}

template <typename T, int TERM>
__global__ void __launch_bounds__(kBlock) lag_per_particle_kernel(Args<T> a) {
  lag_per_particle_body<T, TERM>(a);
}

// The term table's instance (f32): the table beside Args, so the instances
// above keep their parameters and code
__global__ void __launch_bounds__(kBlock) lag_per_particle_table_kernel(Args<float> a,
                                                                        TermTable tab) {
  lag_per_particle_body<float, kSumTable>(a, &tab);
}

template <typename T>
int launch(const void* pos, const void* keys, const void* w_key, int n, int L,
           int spacing, double csq, int term, void* out, const TermTable& t,
           cudaStream_t s) {
  Args<T> a;
  a.pos = static_cast<const T*>(pos);
  a.keys = static_cast<const int32_t*>(keys);
  a.w_key = static_cast<const int32_t*>(w_key);
  a.n = n;
  a.L = L;
  a.spacing = spacing;
  a.csq = static_cast<T>(csq);
  a.out = static_cast<T*>(out);
  const int blocks = (n + kBlock - 1) / kBlock;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (term == kSumTable) {
      lag_per_particle_table_kernel<<<blocks, kBlock, 0, s>>>(a, t);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (term == kSumLj)
    lag_per_particle_kernel<T, kSumLj><<<blocks, kBlock, 0, s>>>(a);
  else
    lag_per_particle_kernel<T, kSumCount><<<blocks, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pos: (3, n) planes of float (f64 == 0) or double (f64 != 0); keys: (n,)
// int32 ascending, SENTINEL_KEY rows last; w_key: one int32 on the device;
// spacing: the padding-key spacing, (INT32_MAX - INT32_MAX / 2 - 1) / n at
// least 1; csq: cutoff^2, rounded here to the coordinates' type; term: 0
// for LJ, 1 for the count, 3 (f32 only) for the device term table's term
// (tkind, tmode and tvals: pair_table.cuh's kind, its energy or virial
// mode and 6 floats, its 5 constants and the shift, in host memory; not
// the species term); out: (n,) of the coordinates' type. Returns
// cudaGetLastError() after the launch.
int zelll_lag_per_particle(const void* pos, const void* keys, const void* w_key,
                           int n, int L, int spacing, double csq, int term,
                           int f64, void* out, void* stream, int tkind, int tmode,
                           const float* tvals) {
  const bool table = term == kSumTable;
  if (n <= 0 || n > kSentinelKey - 2 * kWarp || L < 1 || spacing < 1 ||
      static_cast<int64_t>(spacing) * n > kSentinelKey - kPadKeyBase ||
      (term != kSumLj && term != kSumCount && !table) ||
      (table && (f64 != 0 || tmode == kTableModeGfn ||
                 !term_table_ok(tkind, tmode, false, nullptr, 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  const TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);
  auto s = static_cast<cudaStream_t>(stream);
  if (f64 != 0)
    return launch<double>(pos, keys, w_key, n, L, spacing, csq, term, out, t, s);
  return launch<float>(pos, keys, w_key, n, L, spacing, csq, term, out, t, s);
}

}  // extern "C"
