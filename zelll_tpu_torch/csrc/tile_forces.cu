// K7 on Hopper: per-particle pair forces by segment tiles over key-sorted
// particles, any box shape.
//
// Replaces the TPU kernels zelll_tpu/ops/tile_pairs.py::
// _make_tile_forces_kernel_packed (:1025, via _packed_forces_core and
// tile_pair_forces) and ::_make_tile_forces_kernel (:1295, the int32-key
// form behind tile_pair_forces(packed=False)). Both compute one function:
//
//   f_i = sum over bands s < S (the full, mirrored stencil: S = 1, 3, 9
//         for dim = 1, 2, 3) and j-chunks jc of the band's window
//         [jlo + toff, jlo + toff + jnum) of own chunk c = i / 128,
//         of g d over slots j of jc where
//     i < n and j < n                  (index bound)
//     lo_s <= key_i - key_j <= hi_s    (only with the band mask)
//     0 < dsq < csq                    (strict cutoff; drops i == j and
//                                       coincident particles)
//     d = pos_i - pos_j, g = gfn(dsq)
//
// with dsq accumulated axis by axis, and in split mode each axis'
// separation d = (hi_i - hi_j) + (lo_i - lo_j); in split mode a pair whose
// f32 dsq lies within 1e-6 csq of the cutoff is decided on the f64 dsq of
// its split separations (as K3 does). The windows and bands come
// from ops/segments.py on the torch side (chunk_bounds with half=False,
// trimmed disjoint in band_order(full=True) for the maskless body). Force
// factors: LJ 24 t (2t - 1) inv with inv = 1/dsq by true division, or
// inv = rsqrtf(dsq)^2; t = inv^3.
//
// What it does not copy: the packed 8-row f32 blocks with f32 keys, the
// per-band DMA windows and their semaphores, the lane broadcasts, and the
// deferred (128, 128) g d accumulators that the TPU kernel folds with one
// ones-vector matrix product per chunk. Keys stay int32 here, so one kernel
// serves both TPU layouts; the index bound replaces the spread coordinates
// of the TPU's padding rows.
//
// Design: K6's (tile_reduce.cu). One block of 128 threads per own chunk;
// thread t owns slot i = 128c + t and keeps its coordinates in registers.
// For each j-chunk of each band window, the block stages the chunk's
// coordinates and keys in shared memory as float4, then every thread runs
// over the 128 lanes and adds g d to its own sums. The bands are mirrored,
// so every pair is met from both ends and only the i side is written: no
// slot triangle, no scatter, no atomics, a deterministic result. Masks
// select, never multiply, so an inf from a masked-out dsq = 0 cannot reach
// a sum (safe_term changes nothing).
//
// Accumulation: each thread sums its f32 products g d in f64 and writes
// (dim, n) planes of f32, or f64 when asked (the checks compare f64 sums).
//
// What bounds it on an H100: bytes are 4 B x (3 or 6 coordinate planes +
// 1 key plane + 3 force planes) x n, 280 MB at n = 1e7 in f32 mode,
// 84 us at 3.35 TB/s. Operations, counted once per unique pair as for K3
// (lag_forces.cu): 7 FP32 instructions per half-stencil candidate (13
// split) plus 20 per cutoff pair, about 0.4 ms at the benchmark's density,
// so it is bound by operations. This design evaluates every lane of every
// tile of 9 windows, about 20 times the half-stencil candidates, with a
// barrier per tile; tighter windows, register blocking and asynchronous
// staging are left for later. No single PyTorch call computes it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. No --use_fast_math (it would break
// the true division); --fmad=false rounds every product and sum on its own,
// as the plain PyTorch version does, so dsq and hence the pair masks match
// it bitwise on identical inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 128;  // slots per chunk = threads per block
constexpr int kMaxBands = 9;
constexpr int kMaxDim = 3;
constexpr int kGfnLj = 0;
constexpr int kGfnLjFast = 1;
// Split mode's tie band around the cutoff (_TIE_BAND in lag_pairs.py)
constexpr float kTieBand = 1e-6f;

template <int GFN>
__device__ __forceinline__ float force_factor(float dsq) {
  float inv;
  if (GFN == kGfnLj) {
    inv = 1.0f / dsq;
  } else {
    const float r = rsqrtf(dsq);
    inv = r * r;
  }
  const float t = inv * inv * inv;
  return 24.0f * t * (2.0f * t - 1.0f) * inv;
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
  void* out;              // (dim, n) planes of float or double
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

template <bool SPLIT, int GFN, bool BANDMASK, typename Out>
__global__ void __launch_bounds__(kChunk) tile_forces_kernel(Args a) {
  // the staged j-chunk: x, y, z and the key's bits per lane; split mode
  // adds the low parts
  __shared__ float4 jhi[kChunk];
  __shared__ float4 jlo[SPLIT ? kChunk : 1];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int i = c * kChunk + t;
  const bool own_real = i < a.n;
  const int32_t own_key = a.keys[i];  // keys cover every launched chunk
  const float4 oh = load_slot(a.pos, a.n, a.dim, i, own_key);
  const float4 ol =
      SPLIT ? load_slot(a.lo, a.n, a.dim, i, 0) : make_float4(0, 0, 0, 0);
  double fx = 0.0, fy = 0.0, fz = 0.0;
  for (int s = 0; s < a.S; ++s) {
    const int32_t* w = a.bounds + (static_cast<int64_t>(c) * a.S + s) * 3;
    const int first = w[0] + w[1];
    const int num = w[2];
    const int32_t band_lo = a.bands[2 * s];
    const int32_t band_hi = a.bands[2 * s + 1];
    for (int jt = 0; jt < num; ++jt) {
      const int j0 = (first + jt) * kChunk;
      const int32_t jkey = a.keys[j0 + t];
      jhi[t] = load_slot(a.pos, a.n, a.dim, j0 + t, jkey);
      if (SPLIT) jlo[t] = load_slot(a.lo, a.n, a.dim, j0 + t, 0);
      __syncthreads();
      // lanes at or past n hold no particle
      const int lanes = min(kChunk, a.n - j0);
#pragma unroll 4
      for (int q = 0; q < lanes; ++q) {
        const float4 b = jhi[q];
        const float4 bl = SPLIT ? jlo[q] : make_float4(0, 0, 0, 0);
        float dx = oh.x - b.x;
        float dy = oh.y - b.y;
        float dz = oh.z - b.z;
        if (SPLIT) {
          dx = dx + (ol.x - bl.x);
          dy = dy + (ol.y - bl.y);
          dz = dz + (ol.z - bl.z);
        }
        float dsq = dx * dx;
        dsq = dsq + dy * dy;
        dsq = dsq + dz * dz;
        bool inside = dsq < a.csq;
        if (SPLIT && fabsf(dsq - a.csq) <= kTieBand * a.csq) {
          // near the cutoff the f32 dsq may fall on the wrong side: decide
          // on the f64 dsq of the split separations (split_cutoff_test in
          // lag_pairs.py); absent axes add 0
          const double ex =
              (static_cast<double>(oh.x) - static_cast<double>(b.x)) +
              (static_cast<double>(ol.x) - static_cast<double>(bl.x));
          const double ey =
              (static_cast<double>(oh.y) - static_cast<double>(b.y)) +
              (static_cast<double>(ol.y) - static_cast<double>(bl.y));
          const double ez =
              (static_cast<double>(oh.z) - static_cast<double>(b.z)) +
              (static_cast<double>(ol.z) - static_cast<double>(bl.z));
          double dsq64 = ex * ex;
          dsq64 = dsq64 + ey * ey;
          dsq64 = dsq64 + ez * ez;
          inside = dsq64 < static_cast<double>(a.csq);
        }
        bool m = own_real && inside && dsq > 0.0f;
        if (BANDMASK) {
          const long long diff = static_cast<long long>(own_key) -
                                 static_cast<long long>(__float_as_int(b.w));
          m = m && diff >= band_lo && diff <= band_hi;
        }
        if (m) {
          const float g = force_factor<GFN>(dsq);
          fx += static_cast<double>(g * dx);
          fy += static_cast<double>(g * dy);
          fz += static_cast<double>(g * dz);
        }
      }
      __syncthreads();
    }
  }
  if (own_real) {
    Out* out = static_cast<Out*>(a.out);
    const int64_t n = a.n;
    out[i] = static_cast<Out>(fx);
    if (a.dim > 1) out[n + i] = static_cast<Out>(fy);
    if (a.dim > 2) out[2 * n + i] = static_cast<Out>(fz);
  }
}

template <bool SPLIT, int GFN, bool BANDMASK>
void launch_out(const Args& a, bool f64_out, int blocks, cudaStream_t s) {
  if (f64_out)
    tile_forces_kernel<SPLIT, GFN, BANDMASK, double>
        <<<blocks, kChunk, 0, s>>>(a);
  else
    tile_forces_kernel<SPLIT, GFN, BANDMASK, float>
        <<<blocks, kChunk, 0, s>>>(a);
}

template <bool SPLIT, int GFN>
void launch_mask(const Args& a, bool bandmask, bool f64_out, int blocks,
                 cudaStream_t s) {
  if (bandmask)
    launch_out<SPLIT, GFN, true>(a, f64_out, blocks, s);
  else
    launch_out<SPLIT, GFN, false>(a, f64_out, blocks, s);
}

template <bool SPLIT>
void launch_gfn(const Args& a, int gfn, bool bandmask, bool f64_out,
                int blocks, cudaStream_t s) {
  if (gfn == kGfnLj)
    launch_mask<SPLIT, kGfnLj>(a, bandmask, f64_out, blocks, s);
  else
    launch_mask<SPLIT, kGfnLjFast>(a, bandmask, f64_out, blocks, s);
}

}  // namespace

extern "C" {

// Slots per chunk (threads per block).
int zelll_tile_forces_chunk() { return kChunk; }

// pos, lo: (dim, n) f32 planes (lo null unless split); keys: the padded
// (nc_pad * 128,) int32 keys; bounds: (nc_pad, 3 S) int32 (jlo, toff, jnum)
// per band; bands: (S, 2) int32 on the device; gfn: 0 for the LJ force
// factor, 1 for its rsqrt form; out: (dim, n) planes of float
// (f64_out == 0) or double (f64_out != 0). Returns cudaGetLastError()
// after the launch.
int zelll_tile_forces(const void* pos, const void* lo, const void* keys,
                      const void* bounds, const void* bands, int n, int dim,
                      int S, float csq, int gfn, int f64_out, int bandmask,
                      void* out, void* stream) {
  if (n <= 0 || dim < 1 || dim > kMaxDim || S < 1 || S > kMaxBands ||
      (gfn != kGfnLj && gfn != kGfnLjFast))
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
  a.out = out;
  const int blocks = (n + kChunk - 1) / kChunk;
  auto s = static_cast<cudaStream_t>(stream);
  if (a.lo != nullptr)
    launch_gfn<true>(a, gfn, bandmask != 0, f64_out != 0, blocks, s);
  else
    launch_gfn<false>(a, gfn, bandmask != 0, f64_out != 0, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
