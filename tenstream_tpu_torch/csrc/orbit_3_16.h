// K1's and K2's tables for the 3_16 scheme (and every scheme with the same
// diffuse tables) as compile-time code.  Generated by
// tenstream_tpu_torch/pprts/cuda_ops.py::orbit_header_text from the tables of
// the plain version (orbit_groups of diff_pair_orbits(3_16, with_mz=False),
// _shift_tables, surface_closure_rows); do not edit: load_extension refuses
// to build from a copy that differs from what they generate.
#pragma once

struct Orbit_3_16 {
  static constexpr int K1_ND = 16;
  static constexpr int K1_NORB = 48;

  // source s of a cell (k, i, j) is u[s] at face (k, i, j) + (k1_gz, k1_gx, k1_gy)(s)
  __host__ __device__ static constexpr int k1_gz(int s) { return s == 0 ? 1 : s == 2 ? 1 : s == 4 ? 1 : s == 6 ? 1 : 0; }
  __host__ __device__ static constexpr int k1_gx(int s) { return s == 8 ? 1 : s == 10 ? 1 : 0; }
  __host__ __device__ static constexpr int k1_gy(int s) { return s == 12 ? 1 : s == 14 ? 1 : 0; }
  // dst d at face (k, i, j) is produced by the cell (k, i, j) + (k1_cz, k1_cx, k1_cy)(d)
  __host__ __device__ static constexpr int k1_cz(int d) { return d == 1 ? -1 : d == 3 ? -1 : d == 5 ? -1 : d == 7 ? -1 : 0; }
  __host__ __device__ static constexpr int k1_cx(int d) { return d == 9 ? -1 : d == 11 ? -1 : 0; }
  __host__ __device__ static constexpr int k1_cy(int d) { return d == 13 ? -1 : d == 15 ? -1 : 0; }
  // one cell's contributions: c[d] = sum over the orbit groups (o, ss) of dst d of
  // o(o) * (sum of s(src) over ss), groups in orbit order, as the plain version
  template <class O, class S>
  __device__ static __forceinline__ void k1_contract(O o, S s, float* c) {
    c[0] = o(0) * s(0) + o(2) * (s(2) + s(6)) + o(4) * s(4) + o(12) * s(1) + o(14) * (s(3) + s(7)) + o(16) * s(5) + o(24) * (s(8) + s(9)) + o(26) * s(13) + o(28) * s(12) + o(36) * (s(10) + s(11)) + o(38) * s(15) + o(40) * s(14);
    c[1] = o(1) * s(0) + o(3) * (s(2) + s(6)) + o(5) * s(4) + o(13) * s(1) + o(15) * (s(3) + s(7)) + o(17) * s(5) + o(25) * (s(8) + s(9)) + o(27) * s(13) + o(29) * s(12) + o(37) * (s(10) + s(11)) + o(39) * s(15) + o(41) * s(14);
    c[2] = o(0) * s(2) + o(2) * (s(0) + s(4)) + o(4) * s(6) + o(12) * s(3) + o(14) * (s(1) + s(5)) + o(16) * s(7) + o(24) * (s(12) + s(13)) + o(26) * s(8) + o(28) * s(9) + o(36) * (s(14) + s(15)) + o(38) * s(10) + o(40) * s(11);
    c[3] = o(1) * s(2) + o(3) * (s(0) + s(4)) + o(5) * s(6) + o(13) * s(3) + o(15) * (s(1) + s(5)) + o(17) * s(7) + o(25) * (s(12) + s(13)) + o(27) * s(8) + o(29) * s(9) + o(37) * (s(14) + s(15)) + o(39) * s(10) + o(41) * s(11);
    c[4] = o(0) * s(4) + o(2) * (s(2) + s(6)) + o(4) * s(0) + o(12) * s(5) + o(14) * (s(3) + s(7)) + o(16) * s(1) + o(24) * (s(8) + s(9)) + o(26) * s(12) + o(28) * s(13) + o(36) * (s(10) + s(11)) + o(38) * s(14) + o(40) * s(15);
    c[5] = o(1) * s(4) + o(3) * (s(2) + s(6)) + o(5) * s(0) + o(13) * s(5) + o(15) * (s(3) + s(7)) + o(17) * s(1) + o(25) * (s(8) + s(9)) + o(27) * s(12) + o(29) * s(13) + o(37) * (s(10) + s(11)) + o(39) * s(14) + o(41) * s(15);
    c[6] = o(0) * s(6) + o(2) * (s(0) + s(4)) + o(4) * s(2) + o(12) * s(7) + o(14) * (s(1) + s(5)) + o(16) * s(3) + o(24) * (s(12) + s(13)) + o(26) * s(9) + o(28) * s(8) + o(36) * (s(14) + s(15)) + o(38) * s(11) + o(40) * s(10);
    c[7] = o(1) * s(6) + o(3) * (s(0) + s(4)) + o(5) * s(2) + o(13) * s(7) + o(15) * (s(1) + s(5)) + o(17) * s(3) + o(25) * (s(12) + s(13)) + o(27) * s(9) + o(29) * s(8) + o(37) * (s(14) + s(15)) + o(39) * s(11) + o(41) * s(10);
    c[8] = o(6) * (s(0) + s(4)) + o(8) * s(6) + o(9) * s(2) + o(18) * (s(1) + s(5)) + o(20) * s(7) + o(21) * s(3) + o(30) * s(8) + o(31) * s(9) + o(34) * (s(12) + s(13)) + o(42) * s(10) + o(43) * s(11) + o(46) * (s(14) + s(15));
    c[9] = o(6) * (s(0) + s(4)) + o(8) * s(2) + o(9) * s(6) + o(18) * (s(1) + s(5)) + o(20) * s(3) + o(21) * s(7) + o(30) * s(9) + o(31) * s(8) + o(34) * (s(12) + s(13)) + o(42) * s(11) + o(43) * s(10) + o(46) * (s(14) + s(15));
    c[10] = o(7) * (s(0) + s(4)) + o(10) * s(6) + o(11) * s(2) + o(19) * (s(1) + s(5)) + o(22) * s(7) + o(23) * s(3) + o(32) * s(8) + o(33) * s(9) + o(35) * (s(12) + s(13)) + o(44) * s(10) + o(45) * s(11) + o(47) * (s(14) + s(15));
    c[11] = o(7) * (s(0) + s(4)) + o(10) * s(2) + o(11) * s(6) + o(19) * (s(1) + s(5)) + o(22) * s(3) + o(23) * s(7) + o(32) * s(9) + o(33) * s(8) + o(35) * (s(12) + s(13)) + o(44) * s(11) + o(45) * s(10) + o(47) * (s(14) + s(15));
    c[12] = o(6) * (s(2) + s(6)) + o(8) * s(0) + o(9) * s(4) + o(18) * (s(3) + s(7)) + o(20) * s(1) + o(21) * s(5) + o(30) * s(12) + o(31) * s(13) + o(34) * (s(8) + s(9)) + o(42) * s(14) + o(43) * s(15) + o(46) * (s(10) + s(11));
    c[13] = o(6) * (s(2) + s(6)) + o(8) * s(4) + o(9) * s(0) + o(18) * (s(3) + s(7)) + o(20) * s(5) + o(21) * s(1) + o(30) * s(13) + o(31) * s(12) + o(34) * (s(8) + s(9)) + o(42) * s(15) + o(43) * s(14) + o(46) * (s(10) + s(11));
    c[14] = o(7) * (s(2) + s(6)) + o(10) * s(0) + o(11) * s(4) + o(19) * (s(3) + s(7)) + o(22) * s(1) + o(23) * s(5) + o(32) * s(12) + o(33) * s(13) + o(35) * (s(8) + s(9)) + o(44) * s(14) + o(45) * s(15) + o(47) * (s(10) + s(11));
    c[15] = o(7) * (s(2) + s(6)) + o(10) * s(4) + o(11) * s(0) + o(19) * (s(3) + s(7)) + o(22) * s(5) + o(23) * s(1) + o(32) * s(13) + o(33) * s(12) + o(35) * (s(8) + s(9)) + o(44) * s(15) + o(45) * s(14) + o(47) * (s(10) + s(11));
  }

  // Lambertian surface closure on face nz: the up dofs gain albedo * (sum of the
  // down dofs) * their hemisphere weight
  template <class U>
  __device__ static __forceinline__ void k1_closure(U u, float alb, float* S) {
    const float edn = u(1) + u(3) + u(5) + u(7);
    S[0] += alb * edn * 0.25f;
    S[2] += alb * edn * 0.25f;
    S[4] += alb * edn * 0.25f;
    S[6] += alb * edn * 0.25f;
  }
};
