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
// division, the same with t = rsqrtf(dsq)^2, or count (1).
//
// What it does not copy: the packed 8-row f32 blocks with f32 keys, the
// per-band DMA windows and their semaphores, the (128,1)->(128,128) lane
// broadcasts and the Kahan folding across the sequential grid are TPU
// devices. Keys stay int32 here, so one kernel serves both TPU layouts; the
// index bound replaces the spread coordinates of the TPU's tail padding.
//
// Design: one block of 128 threads per own chunk; thread t owns slot
// i = 128c + t and keeps its coordinates in registers. For each j-chunk of
// each band window, the block stages the chunk's coordinates and keys in
// shared memory (one coalesced load per plane, stored as float4 so that a
// lane costs one 16-byte broadcast load), then every thread runs over the
// 128 lanes. Masks select, never multiply, so an inf from a masked-out
// dsq = 0 cannot reach the sum (safe_term changes nothing).
//
// Accumulation: each thread sums its f32 terms in f64 (integer terms in
// int64); warps fold with shuffles in a fixed order and each block writes
// one partial. The caller sums the partials. No float atomics, so the
// result is deterministic, and every kahan mode of the TPU kernel gets the
// same sum, tighter than its f32 Kahan sums.
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane) x n read once: 160 MB at n = 1e7 in f32 mode, 48 us at
// 3.35 TB/s. Operations: the half-stencil candidates (same or half-stencil
// neighbour cell, about 135 per slot at the benchmark's density of 10 per
// cell) times 7 FP32 instructions (13 split), plus 9-12 per cutoff pair
// (chip_smoke.py counts both on the card): about 0.34 ms at 33.5 T
// instructions/s. So it is bound by operations. This design evaluates
// every lane of every tile in the windows, about 12 times the candidates,
// and stages through shared memory with a barrier per tile; tighter tiles,
// register blocking and asynchronous staging are left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence pair counts match it
// bitwise on identical inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 128;  // slots per chunk = threads per block
constexpr int kMaxBands = 5;
constexpr int kMaxDim = 3;
constexpr int kTermLj = 0;
constexpr int kTermLjFast = 1;
constexpr int kTermCount = 2;

template <int TERM>
__device__ __forceinline__ float term_value(float dsq) {
  if (TERM == kTermLj) {
    const float t = 1.0f / dsq;
    const float t3 = t * t * t;
    return 4.0f * t3 * (t3 - 1.0f);
  }
  if (TERM == kTermLjFast) {
    const float r = rsqrtf(dsq);
    const float t = r * r;
    const float t3 = t * t * t;
    return 4.0f * t3 * (t3 - 1.0f);
  }
  return 1.0f;
}

// Term value in the accumulator's type: f64 for float outputs, int64 for
// integer ones (the term is cast to int32 first, as astype(int32) does).
template <typename Acc>
__device__ __forceinline__ Acc to_acc(float v);
template <>
__device__ __forceinline__ double to_acc<double>(float v) {
  return static_cast<double>(v);
}
template <>
__device__ __forceinline__ long long to_acc<long long>(float v) {
  return static_cast<long long>(static_cast<int32_t>(v));
}

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const float* pos;       // (dim, n) planes
  const float* lo;        // (dim, n) low parts, or null
  const int32_t* keys;    // (nc_pad * 128,) padded keys
  const int32_t* bounds;  // (nc_pad, 3 S): jlo, toff, jnum per band
  const int32_t* bands;   // (S, 2): lo, hi per band
  int n;
  int dim;
  int S;
  float csq;
  void* partial;          // one per own chunk
};

// Coordinates of slot j (< n) from the planes; absent axes read 0, which
// adds exactly 0 to dsq.
__device__ __forceinline__ float4 load_slot(const float* planes, int n,
                                            int dim, int j, int32_t key) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(key));
  if (j < n) {
    v.x = planes[j];
    if (dim > 1) v.y = planes[static_cast<int64_t>(n) + j];
    if (dim > 2) v.z = planes[2 * static_cast<int64_t>(n) + j];
  }
  return v;
}

template <bool SPLIT, int TERM, bool BANDMASK, typename Acc>
__global__ void __launch_bounds__(kChunk) tile_reduce_kernel(Args a) {
  // the staged j-chunk: x, y, z and the key's bits per lane; split mode
  // adds the low parts
  __shared__ float4 jhi[kChunk];
  __shared__ float4 jlo[SPLIT ? kChunk : 1];
  __shared__ Acc warp_sums[kChunk / 32];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int i = c * kChunk + t;
  const bool own_real = i < a.n;
  const int32_t own_key = a.keys[i];  // keys cover every launched chunk
  const float4 oh = load_slot(a.pos, a.n, a.dim, i, own_key);
  const float4 ol =
      SPLIT ? load_slot(a.lo, a.n, a.dim, i, 0) : make_float4(0, 0, 0, 0);
  Acc acc = 0;
  for (int s = 0; s < a.S; ++s) {
    const int32_t* w = a.bounds + (static_cast<int64_t>(c) * a.S + s) * 3;
    const int first = w[0] + w[1];
    const int num = w[2];
    const int32_t band_lo = a.bands[2 * s];
    const int32_t band_hi = a.bands[2 * s + 1];
    for (int jt = 0; jt < num; ++jt) {
      const int jc = first + jt;
      const int j0 = jc * kChunk;
      const int32_t jkey = a.keys[j0 + t];
      jhi[t] = load_slot(a.pos, a.n, a.dim, j0 + t, jkey);
      if (SPLIT) jlo[t] = load_slot(a.lo, a.n, a.dim, j0 + t, 0);
      __syncthreads();
      // lanes at or past n hold no particle
      const int lanes = min(kChunk, a.n - j0);
#pragma unroll 4
      for (int q = 0; q < lanes; ++q) {
        const float4 b = jhi[q];
        float dx = oh.x - b.x;
        float dy = oh.y - b.y;
        float dz = oh.z - b.z;
        if (SPLIT) {
          const float4 bl = jlo[q];
          dx = dx + (ol.x - bl.x);
          dy = dy + (ol.y - bl.y);
          dz = dz + (ol.z - bl.z);
        }
        float dsq = dx * dx;
        dsq = dsq + dy * dy;
        dsq = dsq + dz * dz;
        bool m = own_real && dsq < a.csq;
        if (BANDMASK) {
          const long long diff = static_cast<long long>(own_key) -
                                 static_cast<long long>(__float_as_int(b.w));
          m = m && diff >= band_lo && diff <= band_hi;
        }
        if (s == 0) m = m && (jc < c || (jc == c && q < t));
        if (m) acc += to_acc<Acc>(term_value<TERM>(dsq));
      }
      __syncthreads();
    }
  }
  // fixed-order block fold: warps, then the warp sums in warp 0
  acc = warp_sum(acc);
  const int lane = t & 31;
  const int warp = t >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kChunk / 32 ? warp_sums[lane] : Acc(0);
    acc = warp_sum(acc);
    if (lane == 0) static_cast<Acc*>(a.partial)[c] = acc;
  }
}

template <bool SPLIT, int TERM, bool BANDMASK>
void launch_acc(const Args& a, bool int_out, int blocks, cudaStream_t s) {
  if (int_out)
    tile_reduce_kernel<SPLIT, TERM, BANDMASK, long long>
        <<<blocks, kChunk, 0, s>>>(a);
  else
    tile_reduce_kernel<SPLIT, TERM, BANDMASK, double>
        <<<blocks, kChunk, 0, s>>>(a);
}

template <bool SPLIT, int TERM>
void launch_mask(const Args& a, bool bandmask, bool int_out, int blocks,
                 cudaStream_t s) {
  if (bandmask)
    launch_acc<SPLIT, TERM, true>(a, int_out, blocks, s);
  else
    launch_acc<SPLIT, TERM, false>(a, int_out, blocks, s);
}

template <bool SPLIT>
void launch_term(const Args& a, int term, bool bandmask, bool int_out,
                 int blocks, cudaStream_t s) {
  if (term == kTermLj)
    launch_mask<SPLIT, kTermLj>(a, bandmask, int_out, blocks, s);
  else if (term == kTermLjFast)
    launch_mask<SPLIT, kTermLjFast>(a, bandmask, int_out, blocks, s);
  else
    launch_mask<SPLIT, kTermCount>(a, bandmask, int_out, blocks, s);
}

}  // namespace

extern "C" {

// Slots per chunk (threads per block); the caller allocates one partial
// per chunk that holds a slot below n.
int zelll_tile_reduce_chunk() { return kChunk; }

// pos, lo: (dim, n) f32 planes (lo null unless split); keys: the padded
// (nc_pad * 128,) int32 keys; bounds: (nc_pad, 3 S) int32 (jlo, toff, jnum)
// per band; bands: (S, 2) int32 on the device; partial: ceil(n / 128)
// doubles (int_out == 0) or int64s (int_out != 0). Returns
// cudaGetLastError() after the launch.
int zelll_tile_reduce(const void* pos, const void* lo, const void* keys,
                      const void* bounds, const void* bands, int n, int dim,
                      int S, float csq, int term, int int_out, int bandmask,
                      void* partial, void* stream) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || S < 1 || S > kMaxBands ||
      (term != kTermLj && term != kTermLjFast && term != kTermCount))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const float*>(pos);
  a.lo = static_cast<const float*>(lo);
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
    launch_term<true>(a, term, bandmask != 0, int_out != 0, blocks, s);
  else
    launch_term<false>(a, term, bandmask != 0, int_out != 0, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
