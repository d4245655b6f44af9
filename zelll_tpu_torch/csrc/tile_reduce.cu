// K6 on Hopper: the segment-tile pair reduction over key-sorted particles.
//
// Replaces the TPU kernels zelll_tpu/ops/tile_pairs.py::
// _make_tile_kernel_packed (:259, via tile_pair_reduce and
// tile_lj_rebuild_energy) and ::_make_tile_kernel (:67, the int32-key form
// behind packed=False). Both compute one function:
//
//   sum over own chunks c (slots 128c .. 128c + 127), bands s < S and
//   j-chunks jc of the band's window [jlo + toff, jlo + toff + jnum), of
//   term(dsq(i, j)) over slots i of c and j of jc where
//     i < n and j < n                  (index bound)
//     lo_s <= key_i - key_j <= hi_s    (only with the band mask)
//     jc < c, or jc == c and j < i     (band 0 only: the slot triangle)
//     dsq < csq                        (strict cutoff)
//
// with dsq accumulated axis by axis, and in split mode each axis'
// separation d = (hi_i - hi_j) + (lo_i - lo_j). The windows and bands come
// from ops/segments.py on the torch side (chunk_bounds, trimmed disjoint
// for the maskless body). Terms: LJ 4 t3 (t3 - 1) with t = 1/dsq by true
// division, the same with t = rsqrtf(dsq)^2, the LJ pair virial
// 24 t3 (2 t3 - 1) with t = 1/dsq, or count (1).
//
// What it does not copy: the packed 8-row f32 blocks with f32 keys, the
// per-band DMA windows and their semaphores, the (128,1)->(128,128) lane
// broadcasts and the Kahan folding across the sequential grid are TPU
// devices. Keys stay int32 here, so one kernel serves both TPU layouts; the
// index bound replaces the spread coordinates of the TPU's tail padding.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once: 160 MB at n = 1e7 in f32 mode, 48 us at
// 3.35 TB/s. Operations: the half-stencil candidates (same or half-stencil
// neighbour cell, about 135 per slot at the benchmark's density of 10 per
// cell) times 7 FP32 instructions (13 split), plus 9-12 per cutoff pair
// (chip_smoke.py counts both on the card): about 0.33 ms at 33.5 T
// instructions/s. So it is bound by operations, that is by the
// instructions issued per evaluated lane. Evaluating all 128 x 128 lanes of
// every j-chunk of the windows costs about 10.5 lane evaluations per
// half-stencil candidate on the benchmark's cube.
//
// Design: a half-stencil cluster-pair sweep on cluster_sweep.cuh, K7's
// (tile_forces.cu) over the half stencil. A warp owns a cluster of 32
// consecutive slots, i = 128 c + 32 w + lane, and keeps its own
// coordinates and key in registers; the 4 warps of a block share chunk c's
// windows but otherwise run on their own until the block's final fold.
// Each warp
//   1. reduces its cluster's box over the real slots (< n), from the
//      coordinates of this launch, and in split mode the largest |lo| per
//      axis;
//   2. walks the j-chunks of every band window in order, stopping at n:
//      lane t loads slot t of each of the chunk's 4 clusters and tests the
//      point against the own box; a ballot per cluster compacts the
//      survivors, in slot order, into the warp's buffer in shared memory as
//      float4 (x, y, z, w), plus the low parts in split mode and the key in
//      a third buffer with the band mask. Band 0 stores the slot in w and
//      the other bands -1, so the triangle is one unsigned range test in
//      the sweep (Lane in cluster_sweep.cuh); band 0's j-clusters after the
//      own cluster, which the triangle masks for every lane, are not
//      loaded;
//   3. sweeps the buffer 32 entries at a time (reduce_sweep): phase A reads
//      each entry by a broadcast and sets the lane's hit bit where the
//      triangle, the band (with the band mask; the buffer is then swept at
//      the end of each band) and dsq < csq hold; phase B adds the term of
//      each hit (a count adds the hits' popcount). Here the two phases beat
//      the term inline (K1's form), and sweeps of 32 beat 64 (timed on the
//      card; PERF.md).
// Every rule of the function stays a lane mask, so the sum is the plain
// version's wherever the windows come from, also where the coverage flag
// is False. There is no dsq > 0 test: coincident particles count, and
// lj_term of them is inf, as in the plain version. Masks select, never
// multiply, so an inf from a masked-out pair cannot reach the sum.
//
// The payload row (tile_reduce_keep_kernel, KEEP; the TPU kernel's
// n_payload = 1 through _packed_core(payload=)): the one payload rule on
// the card is the periodic keep mask, mask id 2 (ops/pbc.py's shift-sign
// plane w, pbc._pbc_term). Each lane keeps its own slot's w in a register;
// each buffer entry carries its j slot's w in a third buffer (where the
// reference's packed block carries it in its free row), and the pair
// counts only where (w_i w_j == 0) & (w_i + w_j >= 0) (keep_pair), one
// more lane mask before the term. The half-stencil triangle rule is
// unchanged.
//
// Accumulation: each lane sums its f32 terms in f64 (integer terms in
// int64); the block folds its lanes in a fixed order (block_fold) and
// writes one partial per own chunk. The caller sums the partials. No float
// atomics, so the result is deterministic, and every kahan mode of the TPU
// kernel gets the same sum, tighter than its f32 Kahan sums.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence pair counts match it
// bitwise on identical inputs, and the prune's bound holds.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_sweep.cuh"

namespace {

constexpr int kChunk = 128;  // slots per chunk = threads per block
constexpr int kClusters = kChunk / kWarp;  // per chunk: warps per block
// the term per hit after the hit bits (reduce_sweep)
constexpr bool kTwoPhase = true;
// a warp's buffer: a remainder (< one sweep of 32) and a j-chunk's survivors
constexpr int kBuf = kWarp + kChunk;
constexpr int kMaxBands = 5;
constexpr int kMaxDim = 3;
// The payload rules (lag_pairs._MASK_*): none, the periodic keep mask
constexpr int kMaskNone = 0;
constexpr int kMaskKeep = 2;

struct Args {
  const float* pos;       // (dim, n) planes
  const float* lo;        // (dim, n) low parts, or null
  const int32_t* keys;    // (nc_pad * 128,) padded keys
  const float* w;         // (n,) shift signs (the keep mask), or null
  const int32_t* bounds;  // (nc_pad, 3 S): jlo, toff, jnum per band
  const int32_t* bands;   // (S, 2): lo, hi per band
  int n;
  int dim;
  int S;
  float csq;
  void* partial;          // one per own chunk
};

// Coordinates of slot j (< n) from the planes, w's bits in .w; absent axes
// read 0, which adds exactly 0 to dsq and to the box gap.
__device__ __forceinline__ float4 load_slot(const float* planes, int n,
                                            int dim, int j, int32_t w) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(w));
  v.x = planes[j];
  if (dim > 1) v.y = planes[static_cast<int64_t>(n) + j];
  if (dim > 2) v.z = planes[2 * static_cast<int64_t>(n) + j];
  return v;
}

template <bool SPLIT, int TERM, bool BANDMASK, typename Acc, bool KEEP>
__device__ __forceinline__ void tile_reduce_body(const Args& a) {
  __shared__ float4 buf_hi[kClusters][kBuf];
  __shared__ float4 buf_lo[kClusters][SPLIT ? kBuf : 1];
  __shared__ int32_t buf_key[kClusters][BANDMASK ? kBuf : 1];
  __shared__ float buf_w[kClusters][KEEP ? kBuf : 1];
  const int c = blockIdx.x;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int base = c * kChunk + w * kWarp;  // the own cluster's first slot
  const int i = base + lane;
  const bool real = i < a.n;
  float4* bh = buf_hi[w];
  float4* bl = buf_lo[w];
  int32_t* bk = buf_key[w];
  float* bw = buf_w[w];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  Lane<Acc> o;
  o.h = real ? load_slot(a.pos, a.n, a.dim, i, 0) : zero;
  o.l = SPLIT && real ? load_slot(a.lo, a.n, a.dim, i, 0) : zero;
  o.key = a.keys[i];  // keys cover every launched chunk
  o.jlo = -1;         // band 0 pairs with w < i, the other bands always
  o.span = real ? static_cast<unsigned>(i) + 1u : 0u;
  o.acc = Acc(0);
  o.pw = KEEP && real ? a.w[i] : 0.0f;
  // a cluster past n holds no particle: its warp only joins the fold
  if (base < a.n) {
    const Box box = cluster_box<SPLIT>(o.h, o.l, real);
    const float thr = prune_threshold<SPLIT>(a.csq);
    const unsigned below = (1u << lane) - 1u;
    int cnt = 0;  // entries in the buffer, warp-uniform
    int32_t band_lo = 0, band_hi = 0;
    for (int s = 0; s < a.S; ++s) {
      const int32_t* win = a.bounds + (static_cast<int64_t>(c) * a.S + s) * 3;
      const int first = win[0] + win[1];
      const int num = win[2];
      band_lo = a.bands[2 * s];
      band_hi = a.bands[2 * s + 1];
      for (int jc = first; jc < first + num; ++jc) {
        if (jc * kChunk >= a.n) break;  // later clusters lie past n too
        // band 0: a j-cluster that starts after the own cluster holds no
        // j < i for any lane, and neither do the later ones
        if (s == 0 && jc * kChunk > base) break;
        // the j-chunk's live clusters: all loads in flight at once, then
        // the survivors of each appended in slot order
        float4 b[kClusters], b_lo[kClusters];
        int32_t kj[kClusters];
        float wj[kClusters];
        bool keep[kClusters];
#pragma unroll
        for (int k = 0; k < kClusters; ++k) {
          const int j0 = jc * kChunk + k * kWarp;
          const int j = j0 + lane;
          keep[k] = j < a.n && (s != 0 || j0 <= base);
          b[k] = keep[k] ? load_slot(a.pos, a.n, a.dim, j, s == 0 ? j : -1) : zero;
          b_lo[k] = SPLIT && keep[k] ? load_slot(a.lo, a.n, a.dim, j, 0) : zero;
          kj[k] = BANDMASK && keep[k] ? a.keys[j] : 0;
          wj[k] = KEEP && keep[k] ? a.w[j] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kClusters; ++k) {
          keep[k] = keep[k] && near_box<SPLIT>(box, b[k], b_lo[k], thr);
          compact(__ballot_sync(kAll, keep[k]), keep[k], below, cnt, [&](int at) {
            bh[at] = b[k];
            if (SPLIT) bl[at] = b_lo[k];
            if (BANDMASK) bk[at] = kj[k];
            if (KEEP) bw[at] = wj[k];
          });
        }
        if (cnt >= kWarp) {
          __syncwarp();
          int done = 0;
          for (; cnt - done >= kWarp; done += kWarp)
            reduce_sweep<SPLIT, TERM, BANDMASK, kTwoPhase, true, KEEP>(
                o, bh + done, bl + done, bk + done, kWarp, a.csq, band_lo, band_hi, bw + done);
          __syncwarp();
          // move the remainder to the front of the buffer
          cnt -= done;
          shift_front<1, SPLIT>(bh, bl, done, cnt, lane);
          if (BANDMASK) shift_front<1, false>(bk, bk, done, cnt, lane);
          if (KEEP) shift_front<1, false>(bw, bw, done, cnt, lane);
        }
      }
      if (BANDMASK && cnt > 0) {
        // the band is uniform within a sweep
        __syncwarp();
        reduce_sweep<SPLIT, TERM, BANDMASK, kTwoPhase, false, KEEP>(o, bh, bl, bk, cnt, a.csq,
                                                                    band_lo, band_hi, bw);
        __syncwarp();
        cnt = 0;
      }
    }
    if (cnt > 0) {
      __syncwarp();
      reduce_sweep<SPLIT, TERM, BANDMASK, kTwoPhase, false, KEEP>(o, bh, bl, bk, cnt, a.csq,
                                                                  band_lo, band_hi, bw);
    }
  }
  block_fold<kClusters>(o.acc, static_cast<Acc*>(a.partial));
}

// The open-boundary instances
template <bool SPLIT, int TERM, bool BANDMASK, typename Acc>
__global__ void __launch_bounds__(kChunk) tile_reduce_kernel(Args a) {
  tile_reduce_body<SPLIT, TERM, BANDMASK, Acc, false>(a);
}

// The payload row with the periodic keep mask
template <bool SPLIT, int TERM, bool BANDMASK, typename Acc>
__global__ void __launch_bounds__(kChunk) tile_reduce_keep_kernel(Args a) {
  tile_reduce_body<SPLIT, TERM, BANDMASK, Acc, true>(a);
}

template <bool SPLIT, int TERM, bool BANDMASK, typename Acc>
void launch_keep(const Args& a, bool keep, int blocks, cudaStream_t s) {
  if (keep)
    tile_reduce_keep_kernel<SPLIT, TERM, BANDMASK, Acc><<<blocks, kChunk, 0, s>>>(a);
  else
    tile_reduce_kernel<SPLIT, TERM, BANDMASK, Acc><<<blocks, kChunk, 0, s>>>(a);
}

template <bool SPLIT, int TERM, bool BANDMASK>
void launch_acc(const Args& a, bool int_out, bool keep, int blocks, cudaStream_t s) {
  if (int_out)
    launch_keep<SPLIT, TERM, BANDMASK, long long>(a, keep, blocks, s);
  else
    launch_keep<SPLIT, TERM, BANDMASK, double>(a, keep, blocks, s);
}

template <bool SPLIT, int TERM>
void launch_mask(const Args& a, bool bandmask, bool int_out, bool keep, int blocks,
                 cudaStream_t s) {
  if (bandmask)
    launch_acc<SPLIT, TERM, true>(a, int_out, keep, blocks, s);
  else
    launch_acc<SPLIT, TERM, false>(a, int_out, keep, blocks, s);
}

template <bool SPLIT>
void launch_term(const Args& a, int term, bool bandmask, bool int_out, bool keep,
                 int blocks, cudaStream_t s) {
  if (term == kTermLj)
    launch_mask<SPLIT, kTermLj>(a, bandmask, int_out, keep, blocks, s);
  else if (term == kTermLjFast)
    launch_mask<SPLIT, kTermLjFast>(a, bandmask, int_out, keep, blocks, s);
  else if (term == kTermVirial)
    launch_mask<SPLIT, kTermVirial>(a, bandmask, int_out, keep, blocks, s);
  else
    launch_mask<SPLIT, kTermCount>(a, bandmask, int_out, keep, blocks, s);
}

}  // namespace

extern "C" {

// Slots per chunk (threads per block); the caller allocates one partial
// per chunk that holds a slot below n.
int zelll_tile_reduce_chunk() { return kChunk; }

// pos, lo: (dim, n) f32 planes (lo null unless split); w: (n,) f32 shift
// signs, read with mask 2 (the periodic keep mask) and null otherwise;
// keys: the padded (nc_pad * 128,) int32 keys; bounds: (nc_pad, 3 S) int32
// (jlo, toff, jnum) per band; bands: (S, 2) int32 on the device; mask: 0
// or 2; partial: ceil(n / 128) doubles (int_out == 0) or int64s
// (int_out != 0). Returns cudaGetLastError() after the launch.
int zelll_tile_reduce(const void* pos, const void* lo, const void* w, const void* keys,
                      const void* bounds, const void* bands, int n, int dim,
                      int S, float csq, int term, int int_out, int bandmask,
                      int mask, void* partial, void* stream) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || S < 1 || S > kMaxBands ||
      (term != kTermLj && term != kTermLjFast && term != kTermCount &&
       term != kTermVirial) ||
      (mask != kMaskNone && mask != kMaskKeep) || ((mask == kMaskKeep) != (w != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const float*>(pos);
  a.lo = static_cast<const float*>(lo);
  a.w = static_cast<const float*>(w);
  a.keys = static_cast<const int32_t*>(keys);
  a.bounds = static_cast<const int32_t*>(bounds);
  a.bands = static_cast<const int32_t*>(bands);
  a.n = n;
  a.dim = dim;
  a.S = S;
  a.csq = csq;
  a.partial = partial;
  const int blocks = (n + kChunk - 1) / kChunk;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.lo != nullptr)
    launch_term<true>(a, term, bandmask != 0, int_out != 0, mask == kMaskKeep, blocks, s);
  else
    launch_term<false>(a, term, bandmask != 0, int_out != 0, mask == kMaskKeep, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
