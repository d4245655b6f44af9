// The device term table: the pair potentials of ops/potentials.py as one
// set of forms that the energy kernels K1 (lag_reduce.cu) and K6
// (tile_reduce.cu) and the forces kernels K3 (lag_forces.cu) and K7
// (tile_forces.cu) evaluate per pair, through one template value each
// (kTermTable, kTermSpecies in cluster_sweep.cuh; kGfnTable, kGfnSpecies in
// the forces kernels) instead of an instance per potential.
//
// Replaces no TPU kernel of its own: the TPU kernels
// (zelll_tpu/ops/pallas_pairs.py::_make_kernel, ::_make_forces_kernel,
// zelll_tpu/ops/tile_pairs.py::_make_tile_kernel_packed,
// ::_make_tile_forces_kernel_packed) trace whatever term or force factor
// they are given, zelll_tpu/ops/potentials.py's factories among them; a
// CUDA kernel is compiled ahead, so the factories' forms live here.
//
// A TermTable is passed by value in each kernel's Args: the kind (uniform
// across a launch, so the switch does not diverge), the mode, up to five
// f32 constants and the shift of ops.potentials.shifted. Each form repeats
// its torch function in ops/potentials.py operation by operation on the
// same f32 constants (the host rounds the factory's f64 values, as torch
// rounds a Python scalar for an f32 tensor), with every product and sum
// rounded on its own (--fmad=false), IEEE division, reciprocal (a constant
// over dsq is the constant times 1 / dsq, as torch computes it) and sqrtf,
// and the CUDA library's expf, which torch's exp on the card also calls.
// The kernels and the plain versions therefore differ only where expf's
// implementation or the order of the f64 sums does: near a zero of the
// force factor (the LJ minimum, WCA's cut, Morse's well) an ulp there is a
// large part of a small row. Modes:
//   energy: the potential less the shift (0 unless shifted);
//   gfn:    the force factor -2 dV/d(dsq), never shifted;
//   virial: gfn(dsq) * dsq (ops.virial.virial_term_from_gfn).
// The species term (lennard_jones_mixed) reads its pair's (eps_ij,
// sigma_ij) from an S x S table in device memory that the host computes in
// f32 arithmetic as the torch function does (ops.potentials.species_table):
// parameters computed in f64 and rounded once would differ from the
// function's by an ulp of sigma_ij^2, which near the LJ minimum, where the
// force factor passes 0 and a row's scale does not, is more than the
// per-row limit of the checks. Each endpoint's species index is the JAX
// package's rule: s when s is one of 1 .. S-1, else 0.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTableLj = 0;
constexpr int kTableWca = 1;
constexpr int kTableSoftSphere = 2;
constexpr int kTableGaussian = 3;
constexpr int kTableMorse = 4;
constexpr int kTableYukawa = 5;
constexpr int kTableBuckingham = 6;
constexpr int kTableHarmonic = 7;
constexpr int kTableMixedLj = 8;
constexpr int kTableModeEnergy = 0;
constexpr int kTableModeGfn = 1;
constexpr int kTableModeVirial = 2;
constexpr int kTableParams = 5;
constexpr int kTableMaxSpecies = 16;

struct TermTable {
  int kind;
  int mode;
  float p[kTableParams];
  float shift;
  const float2* mix;  // (S * S) (eps_ij, sigma_ij), species term only
  int ns;             // S
};

// The species index of a plane value (lennard_jones_mixed's _mix).
__device__ __forceinline__ int table_species(float s, int ns) {
  return (s == floorf(s) && s >= 1.0f && s < static_cast<float>(ns))
             ? static_cast<int>(s)
             : 0;
}

__device__ __forceinline__ float table_cube(float x) { return x * x * x; }

__device__ __forceinline__ float table_energy(float dsq, const TermTable& t) {
  const float* p = t.p;
  switch (t.kind) {
    case kTableLj: {
      const float c = table_cube(p[0] * (1.0f / dsq));
      return p[1] * c * (c - 1.0f);
    }
    case kTableWca: {
      const float c = table_cube(p[0] * (1.0f / dsq));
      const float v = p[1] * c * (c - 1.0f) + p[4];
      return dsq < p[3] ? v : 0.0f;
    }
    case kTableSoftSphere: {
      const float x = p[0] * (1.0f / dsq);
      float w = x;
      for (int k = 1; k < static_cast<int>(p[3]); ++k) w = w * x;
      return p[1] * w;
    }
    case kTableGaussian:
      return p[1] * expf(-dsq * p[0]);
    case kTableMorse: {
      const float y = 1.0f - expf(p[1] * (sqrtf(dsq) - p[2]));
      return p[0] * (y * y) - p[0];
    }
    case kTableYukawa: {
      const float r = sqrtf(dsq);
      return p[0] * expf(p[1] * r) / r;
    }
    case kTableBuckingham: {
      const float r = sqrtf(dsq);
      return p[0] * expf(-r * p[1]) - p[2] * (1.0f / table_cube(dsq));
    }
    default: {  // kTableHarmonic
      const float y = sqrtf(dsq) - p[2];
      return p[0] * (y * y);
    }
  }
}

__device__ __forceinline__ float table_gfn(float dsq, const TermTable& t) {
  const float* p = t.p;
  switch (t.kind) {
    case kTableLj: {
      const float c = table_cube(p[0] * (1.0f / dsq));
      return p[2] * c * (2.0f * c - 1.0f) / dsq;
    }
    case kTableWca: {
      const float c = table_cube(p[0] * (1.0f / dsq));
      const float g = p[2] * c * (2.0f * c - 1.0f) / dsq;
      return dsq < p[3] ? g : 0.0f;
    }
    case kTableSoftSphere: {
      const float x = p[0] * (1.0f / dsq);
      float w = x;
      for (int k = 1; k < static_cast<int>(p[3]); ++k) w = w * x;
      return p[2] * w / dsq;
    }
    case kTableGaussian:
      return p[2] * expf(-dsq * p[0]);
    case kTableMorse: {
      const float r = sqrtf(dsq);
      const float x = expf(p[1] * (r - p[2]));
      return p[3] * x * (1.0f - x) / r;
    }
    case kTableYukawa: {
      const float r = sqrtf(dsq);
      return p[0] * expf(p[1] * r) * (p[2] * r + 1.0f) / (dsq * r);
    }
    case kTableBuckingham: {
      const float r = sqrtf(dsq);
      const float d2 = dsq * dsq;
      return p[3] * expf(-r * p[1]) / r - p[4] * (1.0f / (d2 * d2));
    }
    default:  // kTableHarmonic
    {
      const float r = sqrtf(dsq);
      return p[1] * (r - p[2]) / r;
    }
  }
}

// The table's term in its mode (energy or virial: K1, K6).
__device__ __forceinline__ float table_term(float dsq, const TermTable& t) {
  if (t.mode == kTableModeVirial) return table_gfn(dsq, t) * dsq;
  return table_energy(dsq, t) - t.shift;
}

// The species pair's (eps_ij, sigma_ij) for plane values si, sj.
__device__ __forceinline__ float2 table_mix(float si, float sj, const TermTable& t) {
  return __ldg(&t.mix[table_species(si, t.ns) * t.ns + table_species(sj, t.ns)]);
}

// lennard_jones_mixed's term: 4 eps_ij t (t - 1), t = (sigma_ij^2 / dsq)^3.
__device__ __forceinline__ float table_species_term(float dsq, float si, float sj,
                                                    const TermTable& t) {
  const float2 m = table_mix(si, sj, t);
  const float c = table_cube(m.y * m.y / dsq);
  return 4.0f * m.x * c * (c - 1.0f);
}

// lennard_jones_mixed's force factor: 24 eps_ij t (2t - 1) / dsq.
__device__ __forceinline__ float table_species_gfn(float dsq, float si, float sj,
                                                   const TermTable& t) {
  const float2 m = table_mix(si, sj, t);
  const float c = table_cube(m.y * m.y / dsq);
  return 24.0f * m.x * c * (2.0f * c - 1.0f) / dsq;
}

// The host side of a C interface: the table from the caller's kind, mode,
// kTableParams + 1 floats (the constants, then the shift) and species table.
inline TermTable make_term_table(int kind, int mode, const float* vals,
                                 const void* mix, int ns) {
  TermTable t{};
  t.kind = kind;
  t.mode = mode;
  if (vals != nullptr) {
    for (int k = 0; k < kTableParams; ++k) t.p[k] = vals[k];
    t.shift = vals[kTableParams];
  }
  t.mix = static_cast<const float2*>(mix);
  t.ns = ns;
  return t;
}

// Whether the C interface's table arguments are ones the kernels take.
inline bool term_table_ok(int kind, int mode, bool species, const void* mix, int ns) {
  if (species)
    return kind == kTableMixedLj && mix != nullptr && ns >= 1 && ns <= kTableMaxSpecies;
  return kind >= kTableLj && kind <= kTableHarmonic && mode >= kTableModeEnergy &&
         mode <= kTableModeVirial;
}

}  // namespace
