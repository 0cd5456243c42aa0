// K1's and K2's tables for the 3_10 scheme (and every scheme with the same
// diffuse tables) as compile-time code.  Generated by
// tenstream_tpu_torch/pprts/cuda_ops.py::orbit_header_text from the tables of
// the plain version (orbit_groups of diff_pair_orbits(3_10, with_mz=False),
// _shift_tables, surface_closure_rows); do not edit: load_extension refuses
// to build from a copy that differs from what they generate.
#pragma once

struct Orbit_3_10 {
  static constexpr int K1_ND = 10;
  static constexpr int K1_NORB = 24;

  // source s of a cell (k, i, j) is u[s] at face (k, i, j) + (k1_gz, k1_gx, k1_gy)(s)
  __host__ __device__ static constexpr int k1_gz(int s) { return s == 0 ? 1 : 0; }
  __host__ __device__ static constexpr int k1_gx(int s) { return s == 2 ? 1 : s == 4 ? 1 : 0; }
  __host__ __device__ static constexpr int k1_gy(int s) { return s == 6 ? 1 : s == 8 ? 1 : 0; }
  // dst d at face (k, i, j) is produced by the cell (k, i, j) + (k1_cz, k1_cx, k1_cy)(d)
  __host__ __device__ static constexpr int k1_cz(int d) { return d == 1 ? -1 : 0; }
  __host__ __device__ static constexpr int k1_cx(int d) { return d == 3 ? -1 : d == 5 ? -1 : 0; }
  __host__ __device__ static constexpr int k1_cy(int d) { return d == 7 ? -1 : d == 9 ? -1 : 0; }
  // one cell's contributions: c[d] = sum over the orbit groups (o, ss) of dst d of
  // o(o) * (sum of s(src) over ss), groups in orbit order, as the plain version
  template <class O, class S>
  __device__ static __forceinline__ void k1_contract(O o, S s, float* c) {
    c[0] = o(0) * s(0) + o(4) * s(1) + o(8) * (s(2) + s(3) + s(6) + s(7)) + o(16) * (s(4) + s(5) + s(8) + s(9));
    c[1] = o(1) * s(0) + o(5) * s(1) + o(9) * (s(2) + s(3) + s(6) + s(7)) + o(17) * (s(4) + s(5) + s(8) + s(9));
    c[2] = o(2) * s(0) + o(6) * s(1) + o(10) * s(2) + o(11) * s(3) + o(14) * (s(6) + s(7)) + o(18) * s(4) + o(19) * s(5) + o(22) * (s(8) + s(9));
    c[3] = o(2) * s(0) + o(6) * s(1) + o(10) * s(3) + o(11) * s(2) + o(14) * (s(6) + s(7)) + o(18) * s(5) + o(19) * s(4) + o(22) * (s(8) + s(9));
    c[4] = o(3) * s(0) + o(7) * s(1) + o(12) * s(2) + o(13) * s(3) + o(15) * (s(6) + s(7)) + o(20) * s(4) + o(21) * s(5) + o(23) * (s(8) + s(9));
    c[5] = o(3) * s(0) + o(7) * s(1) + o(12) * s(3) + o(13) * s(2) + o(15) * (s(6) + s(7)) + o(20) * s(5) + o(21) * s(4) + o(23) * (s(8) + s(9));
    c[6] = o(2) * s(0) + o(6) * s(1) + o(10) * s(6) + o(11) * s(7) + o(14) * (s(2) + s(3)) + o(18) * s(8) + o(19) * s(9) + o(22) * (s(4) + s(5));
    c[7] = o(2) * s(0) + o(6) * s(1) + o(10) * s(7) + o(11) * s(6) + o(14) * (s(2) + s(3)) + o(18) * s(9) + o(19) * s(8) + o(22) * (s(4) + s(5));
    c[8] = o(3) * s(0) + o(7) * s(1) + o(12) * s(6) + o(13) * s(7) + o(15) * (s(2) + s(3)) + o(20) * s(8) + o(21) * s(9) + o(23) * (s(4) + s(5));
    c[9] = o(3) * s(0) + o(7) * s(1) + o(12) * s(7) + o(13) * s(6) + o(15) * (s(2) + s(3)) + o(20) * s(9) + o(21) * s(8) + o(23) * (s(4) + s(5));
  }

  // Lambertian surface closure on face nz: the up dofs gain albedo * (sum of the
  // down dofs) * their hemisphere weight
  template <class U>
  __device__ static __forceinline__ void k1_closure(U u, float alb, float* S) {
    const float edn = u(1);
    S[0] += alb * edn * 1.0f;
  }
};
