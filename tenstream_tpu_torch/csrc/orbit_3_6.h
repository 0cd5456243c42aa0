// K1's and K2's tables for the 3_6 scheme (and every scheme with the same
// diffuse tables) as compile-time code.  Generated by
// tenstream_tpu_torch/pprts/cuda_ops.py::orbit_header_text from the tables of
// the plain version (orbit_groups of diff_pair_orbits(3_6, with_mz=False),
// _shift_tables, surface_closure_rows); do not edit: load_extension refuses
// to build from a copy that differs from what they generate.
#pragma once

struct Orbit_3_6 {
  static constexpr int K1_ND = 6;
  static constexpr int K1_NORB = 11;

  // source s of a cell (k, i, j) is u[s] at face (k, i, j) + (k1_gz, k1_gx, k1_gy)(s)
  __host__ __device__ static constexpr int k1_gz(int s) { return s == 0 ? 1 : 0; }
  __host__ __device__ static constexpr int k1_gx(int s) { return s == 2 ? 1 : 0; }
  __host__ __device__ static constexpr int k1_gy(int s) { return s == 4 ? 1 : 0; }
  // dst d at face (k, i, j) is produced by the cell (k, i, j) + (k1_cz, k1_cx, k1_cy)(d)
  __host__ __device__ static constexpr int k1_cz(int d) { return d == 1 ? -1 : 0; }
  __host__ __device__ static constexpr int k1_cx(int d) { return d == 3 ? -1 : 0; }
  __host__ __device__ static constexpr int k1_cy(int d) { return d == 5 ? -1 : 0; }
  // one cell's contributions: c[d] = sum over the orbit groups (o, ss) of dst d of
  // o(o) * (sum of s(src) over ss), groups in orbit order, as the plain version
  template <class O, class S>
  __device__ static __forceinline__ void k1_contract(O o, S s, float* c) {
    c[0] = o(0) * s(0) + o(3) * s(1) + o(6) * (s(2) + s(3) + s(4) + s(5));
    c[1] = o(1) * s(0) + o(4) * s(1) + o(7) * (s(2) + s(3) + s(4) + s(5));
    c[2] = o(2) * s(0) + o(5) * s(1) + o(8) * s(2) + o(9) * s(3) + o(10) * (s(4) + s(5));
    c[3] = o(2) * s(0) + o(5) * s(1) + o(8) * s(3) + o(9) * s(2) + o(10) * (s(4) + s(5));
    c[4] = o(2) * s(0) + o(5) * s(1) + o(8) * s(4) + o(9) * s(5) + o(10) * (s(2) + s(3));
    c[5] = o(2) * s(0) + o(5) * s(1) + o(8) * s(5) + o(9) * s(4) + o(10) * (s(2) + s(3));
  }

  // Lambertian surface closure on face nz: the up dofs gain albedo * (sum of the
  // down dofs) * their hemisphere weight
  template <class U>
  __device__ static __forceinline__ void k1_closure(U u, float alb, float* S) {
    const float edn = u(1);
    S[0] += alb * edn * 1.0f;
  }
};
