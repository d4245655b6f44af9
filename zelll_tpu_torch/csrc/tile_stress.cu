// K8 on Hopper: the configurational stress tensor over segment tiles of
// key-sorted particles.
//
// Replaces the TPU kernel zelll_tpu/ops/tile_pairs.py::
// _make_tile_stress_kernel_packed (:735, via tile_pair_stress). It computes
// the same function:
//
//   sigma_ab = sum over own chunks c (slots 128c .. 128c + 127), bands
//              s < S and j-chunks jc of the band's window
//              [jlo + toff, jlo + toff + jnum), of (g(dsq) d_a) d_b,
//              d = pos_i - pos_j, a <= b, over slots i of c and j of jc where
//     i < n and j < n                  (index bound)
//     lo_s <= key_i - key_j <= hi_s    (only with the band mask)
//     jc < c, or jc == c and j < i     (band 0 only: the slot triangle)
//     0 < dsq < csq                    (strict cutoff; coincident excluded)
//
// with dsq accumulated axis by axis, and in split mode each axis'
// separation d = (hi_i - hi_j) + (lo_i - lo_j) (the f32 dsq decides, as
// in the TPU kernel). The windows and bands come from ops/segments.py on
// the torch side (chunk_bounds, trimmed disjoint for the maskless body).
// Force factors: LJ 24 t (2t - 1) inv with inv = 1/dsq by true division,
// or inv = rsqrt(dsq)^2; t = inv^3. Coordinates are f32 (optionally with
// f32 low parts) or f64.
//
// What it does not copy: the packed 8-row blocks with f32 keys, the DMA
// windows and their semaphores, the lane broadcasts and the fused
// (128, ncomp x 128) accumulator with its cross-program Kahan fold are TPU
// devices. Keys stay int32 here; the index bound replaces the spread
// coordinates of the TPU's tail padding.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once (8 B planes in f64) plus the window bounds,
// about 160 MB at n = 1e7 in f32, 48 us at 3.35 TB/s. Operations: the
// half-stencil candidates times 7 FP32 instructions (13 split), plus per
// cutoff pair the force factor (11), nine products and six f64 adds
// (counted twice), so it is bound by operations, that is by the
// instructions issued per evaluated lane. A block per chunk that staged
// each j-chunk through shared memory, with a barrier per tile, would
// evaluate every lane of every tile in the windows: 10.5 lane evaluations
// per half-stencil candidate on the cube. No single PyTorch call computes
// this function.
//
// Design: K6's half-stencil cluster sweep (tile_reduce.cu) on
// cluster_sweep.cuh, in K9's form (tile_hist.cu), with the six products per
// hit. A warp owns a cluster of 32 consecutive slots, i = 128 c + 32 w +
// lane; the 4 warps of a block share chunk c's windows. Each warp
//   1. reduces its cluster's box over the real slots (< n), and in split
//      mode the largest |lo| per axis (f64: the box and the gap in double;
//      ClusterPrune);
//   2. walks the j-chunks of every band window in order, stopping at n
//      (the header's half_stencil_walk, to which the kernel gives
//      its key plane and its sweep through StressSweeper):
//      lane t loads slot t of each of the chunk's 4 clusters and tests the
//      point against the own box with the threshold csq; a ballot per
//      cluster compacts the survivors, in slot order, into the warp's
//      buffer in shared memory (x, y, z and a tag w; the low parts in split
//      mode, and with the band mask the key, read for survivors only).
//      Band 0 stores the slot in w and the other bands -1, so the triangle
//      is one unsigned range test; band 0's j-clusters after the own
//      cluster, which the triangle masks for every lane, are not loaded;
//   3. sweeps the buffer 32 entries at a time: phase A reads each entry by
//      a broadcast and sets the lane's hit bit where the triangle, the band
//      (with the band mask; the buffer is then swept at the end of each
//      band) and 0 < dsq < csq hold; phase B computes the force factor of
//      each hit and adds its six products to the lane's f64 sums (the
//      sweep of stress_sweep.cuh, which K4 shares).
// The prune drops no pair that counts (cluster_sweep.cuh says why; the
// split threshold is a superset of the strict f32 rule), and
// ops/cluster_prune.py's tile_cluster_entries(half=True) counts these
// entries, as it does K6's and K9's (tests/test_torch_prune.py holds it to
// brute force). Every rule of the function stays a lane mask, so the pair
// set is the plain version's wherever the windows come from, also where the
// coverage flag is False. Masks select, never multiply, so the inf of a
// masked-out dsq = 0 cannot reach a sum.
//
// Periodic boxes (ops/virial.py's pbc_stress_fused on the tile path) add
// instances under a new kernel name, tile_stress_keep_kernel, with the
// shift-sign plane w (0 real, +/-1 ghost, in the coordinates' type; the TPU
// kernel's payload row) as a second kernel parameter, so the open-boundary
// instances keep their names and code: an entry carries its w in a buffer
// beside the coordinates, read for survivors of the prune only, and phase A
// keeps a pair only where (w_i w_j == 0) & (w_i + w_j >= 0) (keep_pair_of,
// virial._pbc_keep_mask): each cross-boundary pair once, as one of its two
// images, whose d_a d_b is the same.
//
// The term table (GFN = kGfnTable: any factory's force factor of
// ops/potentials.py through pair_table.cuh, f32 and split, maskless and
// band-masked, open and with the keep mask) adds instances under a new
// kernel name, tile_stress_table_kernel, with the keep plane (or null) and
// the table as further kernel parameters, so the instances above keep their
// parameters and code. stress_sweep evaluates the table's force factor once
// per hit in phase B, off the unrolled phase A.
//
// Accumulation: each lane sums the six upper-triangle products (xx, xy,
// xz, yy, yz, zz; absent axes give 0) in f64 registers; the block folds
// its lanes in a fixed order (block_fold_n) and writes six partials per own
// chunk. The caller sums the partials. No float atomics, so the result is
// deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. --fmad=false rounds every product
// and sum on its own, as the plain PyTorch version does, so dsq and hence
// the pair masks match it bitwise on identical inputs, and the prune's
// bound holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"
#include "stress_sweep.cuh"

namespace {

constexpr int kChunk = 128;  // slots per chunk = threads per block
constexpr int kClusters = kChunk / kWarp;  // per chunk: warps per block
// a warp's buffer: a remainder (< one sweep of 32) and a j-chunk's survivors
constexpr int kBuf = kWarp + kChunk;
constexpr int kMaxBands = 5;
constexpr int kMaxDim = 3;

template <typename T>
struct Args {
  const T* pos;           // (dim, n) planes
  const float* lo;        // (dim, n) f32 low parts, or null
  const int32_t* keys;    // (nc_pad * 128,) padded keys
  const int32_t* bounds;  // (nc_pad, 3 S): jlo, toff, jnum per band
  const int32_t* bands;   // (S, 2): lo, hi per band
  int n;
  int dim;
  int S;
  T csq;
  double* partial;        // 6 per own chunk
};

// What the half-stencil walk of cluster_sweep.cuh asks of K8: the band,
// the key plane beside the coordinates (band mask), the keep plane (KEEP),
// and the sweep.
template <typename T, bool SPLIT, int GFN, bool BANDMASK, bool KEEP = false,
          typename V = typename Vec4Of<T>::type>
struct StressSweeper {
  const Args<T>& a;
  StressLane<T>& o;
  const V* bh;
  const float4* bl;
  int32_t* bk;
  int32_t band_lo, band_hi;
  const PbcLane<T>* pl = nullptr;
  T* bw = nullptr;
  const T* w = nullptr;
  const TermTable* tab = nullptr;
  __device__ __forceinline__ void band(int32_t lo, int32_t hi) {
    band_lo = lo;
    band_hi = hi;
  }
  __device__ __forceinline__ void store(int at, int j) {
    if (BANDMASK) bk[at] = a.keys[j];
    if constexpr (KEEP) bw[at] = w[j];
  }
  template <bool FULL>
  __device__ __forceinline__ void sweep(int at, int cnt) {
    if constexpr (GFN == kGfnTable)
      stress_sweep<T, SPLIT, kGfnTable, BANDMASK, FULL, KEEP>(
          o, bh + at, bl + at, bk + at, cnt, a.csq, band_lo, band_hi, pl,
          KEEP ? bw + at : nullptr, tab);
    else if constexpr (KEEP)
      stress_sweep<T, SPLIT, GFN, BANDMASK, FULL, KEEP>(o, bh + at, bl + at, bk + at, cnt,
                                                        a.csq, band_lo, band_hi, pl, bw + at);
    else
      stress_sweep<T, SPLIT, GFN, BANDMASK, FULL>(o, bh + at, bl + at, bk + at, cnt, a.csq,
                                                  band_lo, band_hi);
  }
  __device__ __forceinline__ void shift(int done, int cnt, int lane) {
    if (BANDMASK) shift_front<1, false>(bk, bk, done, cnt, lane);
    if constexpr (KEEP) shift_front<1, false>(bw, bw, done, cnt, lane);
  }
};

// The kernel's body; KEEP (the periodic instances) reads the plane w, the
// table instances tab.
template <typename T, bool SPLIT, int GFN, bool BANDMASK, bool KEEP>
__device__ __forceinline__ void tile_stress_body(const Args<T>& a, const T* w_plane,
                                                 const TermTable* tab = nullptr) {
  using V = typename Vec4Of<T>::type;
  __shared__ V buf_hi[kClusters][kBuf];
  __shared__ float4 buf_lo[kClusters][SPLIT ? kBuf : 1];
  __shared__ int32_t buf_key[kClusters][BANDMASK ? kBuf : 1];
  const int c = blockIdx.x;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = c * kChunk + w * kWarp;  // the own cluster's first slot
  const int i = base + lane;
  const bool real = i < a.n;
  V* bh = buf_hi[w];
  float4* bl = buf_lo[w];
  int32_t* bk = buf_key[w];
  T* bw = nullptr;
  if constexpr (KEEP) {
    __shared__ T buf_w[kClusters][kBuf];
    bw = buf_w[w];
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const V vzero = V{T(0), T(0), T(0), T(0)};
  StressLane<T> o;
  o.h = real ? load_point(a.pos, a.n, a.dim, i, 0) : vzero;
  o.l = SPLIT && real ? load_point(a.lo, a.n, a.dim, i, 0) : zero;
  o.key = a.keys[i];  // keys cover every launched chunk
  o.jlo = -1;  // band 0's triangle: -1 <= w < i
  o.span = real ? static_cast<unsigned>(i) + 1u : 0u;
#pragma unroll
  for (int k = 0; k < kComps; ++k) o.acc[k] = 0.0;
  // a cluster past n holds no particle: its warp only joins the fold
  if (base < a.n) {
    const ClusterPrune<T, SPLIT> prune(o.h, o.l, real, a.csq);
    if constexpr (KEEP) {
      const PbcLane<T> pl{real ? w_plane[i] : T(0), make_float3(0.0f, 0.0f, 0.0f),
                          make_float3(0.0f, 0.0f, 0.0f)};
      StressSweeper<T, SPLIT, GFN, BANDMASK, true> sw{a, o, bh, bl, bk, 0, 0, &pl, bw,
                                                      w_plane, tab};
      half_stencil_walk<kClusters, SPLIT, BANDMASK>(a, c, base, lane, prune, bh, bl, sw);
    } else {
      // the open instances as they were built before the periodic ones
      StressSweeper<T, SPLIT, GFN, BANDMASK> sw{a, o, bh, bl, bk, 0, 0, nullptr, nullptr,
                                                nullptr, tab};
      half_stencil_walk<kClusters, SPLIT, BANDMASK>(a, c, base, lane, prune, bh, bl, sw);
    }
  }
  block_fold_n<kClusters>(o.acc, a.partial);
}

// The open-boundary instances
template <typename T, bool SPLIT, int GFN, bool BANDMASK>
__global__ void __launch_bounds__(kChunk) tile_stress_kernel(Args<T> a) {
  tile_stress_body<T, SPLIT, GFN, BANDMASK, false>(a, nullptr);
}

// The periodic instances: the keep mask over the shift-sign plane w,
// beside Args, so the instances above keep their code
template <typename T, bool SPLIT, int GFN, bool BANDMASK>
__global__ void __launch_bounds__(kChunk) tile_stress_keep_kernel(Args<T> a, const T* w) {
  tile_stress_body<T, SPLIT, GFN, BANDMASK, true>(a, w);
}

// The term table's instances (f32 and split, maskless and band-masked, open
// and with the keep mask): the keep plane and the table beside Args, so the
// instances above keep their parameters and code
template <bool SPLIT, bool BANDMASK, bool KEEP>
__global__ void __launch_bounds__(kChunk) tile_stress_table_kernel(Args<float> a,
                                                                   const float* w,
                                                                   TermTable tab) {
  tile_stress_body<float, SPLIT, kGfnTable, BANDMASK, KEEP>(a, w, &tab);
}

template <bool SPLIT, bool BANDMASK>
void launch_table_keep(const Args<float>& a, const float* keep, const TermTable& t,
                       int blocks, cudaStream_t s) {
  if (keep != nullptr)
    tile_stress_table_kernel<SPLIT, BANDMASK, true><<<blocks, kChunk, 0, s>>>(a, keep, t);
  else
    tile_stress_table_kernel<SPLIT, BANDMASK, false><<<blocks, kChunk, 0, s>>>(a, keep, t);
}

template <typename T, bool SPLIT, int GFN>
void launch_mask(const Args<T>& a, bool bandmask, const T* keep, int blocks, cudaStream_t s) {
  if (keep != nullptr) {
    if (bandmask)
      tile_stress_keep_kernel<T, SPLIT, GFN, true><<<blocks, kChunk, 0, s>>>(a, keep);
    else
      tile_stress_keep_kernel<T, SPLIT, GFN, false><<<blocks, kChunk, 0, s>>>(a, keep);
  } else if (bandmask) {
    tile_stress_kernel<T, SPLIT, GFN, true><<<blocks, kChunk, 0, s>>>(a);
  } else {
    tile_stress_kernel<T, SPLIT, GFN, false><<<blocks, kChunk, 0, s>>>(a);
  }
}

template <typename T, bool SPLIT>
void launch(const void* pos, const float* lo, const int32_t* keys,
            const int32_t* bounds, const int32_t* bands, int n, int dim, int S,
            double csq, int gfn, bool bandmask, double* partial, const void* keep,
            const TermTable& t, cudaStream_t s) {
  Args<T> a;
  a.pos = static_cast<const T*>(pos);
  a.lo = lo;
  a.keys = keys;
  a.bounds = bounds;
  a.bands = bands;
  a.n = n;
  a.dim = dim;
  a.S = S;
  a.csq = static_cast<T>(csq);
  a.partial = partial;
  const int blocks = (n + kChunk - 1) / kChunk;
  const T* w = static_cast<const T*>(keep);
  if constexpr (sizeof(T) == sizeof(float)) {
    if (gfn == kGfnTable) {
      if (bandmask)
        launch_table_keep<SPLIT, true>(a, w, t, blocks, s);
      else
        launch_table_keep<SPLIT, false>(a, w, t, blocks, s);
      return;
    }
  }
  if (gfn == kGfnLj)
    launch_mask<T, SPLIT, kGfnLj>(a, bandmask, w, blocks, s);
  else
    launch_mask<T, SPLIT, kGfnLjFast>(a, bandmask, w, blocks, s);
}

}  // namespace

extern "C" {

// Slots per chunk (threads per block); the caller allocates 6 partials per
// chunk that holds a slot below n.
int zelll_tile_stress_chunk() { return kChunk; }

// pos: (dim, n) planes, f32 (f64 != 0: f64); lo: (dim, n) f32 low parts or
// null (f32 only); keys: the padded (nc_pad * 128,) int32 keys; bounds:
// (nc_pad, 3 S) int32 (jlo, toff, jnum) per band; bands: (S, 2) int32 on
// the device; csq: cutoff^2 in the coordinates' type; partial:
// ceil(n / 128) x 6 doubles (xx, xy, xz, yy, yz, zz per chunk); keep: (n,)
// shift signs in the coordinates' type (the periodic keep mask,
// lag_pairs.pbc_keep) or null. gfn 2 (f32 only) takes the device term
// table's force factor (tkind, tmode and tvals: pair_table.cuh's kind, its
// gfn mode and 6 floats, its 5 constants and the shift, in host memory;
// not the species factor). Returns cudaGetLastError() after the launch.
int zelll_tile_stress(const void* pos, const void* lo, const void* keys,
                      const void* bounds, const void* bands, int n, int dim,
                      int S, double csq, int gfn, int bandmask, int f64,
                      void* partial, void* stream, const void* keep, int tkind,
                      int tmode, const float* tvals) {
  const bool table = gfn == kGfnTable;
  if (n <= 0 || dim < 1 || dim > kMaxDim || S < 1 || S > kMaxBands ||
      (gfn != kGfnLj && gfn != kGfnLjFast && !table) || (f64 != 0 && lo != nullptr) ||
      (table && (f64 != 0 || tmode != kTableModeGfn ||
                 !term_table_ok(tkind, tmode, false, nullptr, 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  const TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);
  const auto* l = static_cast<const float*>(lo);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* b = static_cast<const int32_t*>(bounds);
  const auto* bd = static_cast<const int32_t*>(bands);
  auto* out = static_cast<double*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  const bool bm = bandmask != 0;
  if (f64 != 0)
    launch<double, false>(pos, l, k, b, bd, n, dim, S, csq, gfn, bm, out, keep, t, s);
  else if (l != nullptr)
    launch<float, true>(pos, l, k, b, bd, n, dim, S, csq, gfn, bm, out, keep, t, s);
  else
    launch<float, false>(pos, l, k, b, bd, n, dim, S, csq, gfn, bm, out, keep, t, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
