// K1's and K2's tables for the 8_18 scheme (and every scheme with the same
// diffuse tables) as compile-time code.  Generated by
// tenstream_tpu_torch/pprts/cuda_ops.py::orbit_header_text from the tables of
// the plain version (orbit_groups of diff_pair_orbits(8_18, with_mz=False),
// _shift_tables, surface_closure_rows); do not edit: load_extension refuses
// to build from a copy that differs from what they generate.
#pragma once

struct Orbit_8_18 {
  static constexpr int K1_ND = 18;
  static constexpr int K1_NORB = 68;

  // source s of a cell (k, i, j) is u[s] at face (k, i, j) + (k1_gz, k1_gx, k1_gy)(s)
  __host__ __device__ static constexpr int k1_gz(int s) { return s == 0 ? 1 : s == 2 ? 1 : s == 4 ? 1 : s == 6 ? 1 : s == 8 ? 1 : 0; }
  __host__ __device__ static constexpr int k1_gx(int s) { return s == 10 ? 1 : s == 12 ? 1 : 0; }
  __host__ __device__ static constexpr int k1_gy(int s) { return s == 14 ? 1 : s == 16 ? 1 : 0; }
  // dst d at face (k, i, j) is produced by the cell (k, i, j) + (k1_cz, k1_cx, k1_cy)(d)
  __host__ __device__ static constexpr int k1_cz(int d) { return d == 1 ? -1 : d == 3 ? -1 : d == 5 ? -1 : d == 7 ? -1 : d == 9 ? -1 : 0; }
  __host__ __device__ static constexpr int k1_cx(int d) { return d == 11 ? -1 : d == 13 ? -1 : 0; }
  __host__ __device__ static constexpr int k1_cy(int d) { return d == 15 ? -1 : d == 17 ? -1 : 0; }
  // one cell's contributions: c[d] = sum over the orbit groups (o, ss) of dst d of
  // o(o) * (sum of s(src) over ss), groups in orbit order, as the plain version
  template <class O, class S>
  __device__ static __forceinline__ void k1_contract(O o, S s, float* c) {
    c[0] = o(0) * s(0) + o(6) * s(1) + o(12) * (s(2) + s(4) + s(6) + s(8)) + o(26) * (s(3) + s(5) + s(7) + s(9)) + o(40) * (s(10) + s(11) + s(14) + s(15)) + o(54) * (s(12) + s(13) + s(16) + s(17));
    c[1] = o(1) * s(0) + o(7) * s(1) + o(13) * (s(2) + s(4) + s(6) + s(8)) + o(27) * (s(3) + s(5) + s(7) + s(9)) + o(41) * (s(10) + s(11) + s(14) + s(15)) + o(55) * (s(12) + s(13) + s(16) + s(17));
    c[2] = o(2) * s(0) + o(8) * s(1) + o(14) * s(2) + o(16) * (s(4) + s(8)) + o(18) * s(6) + o(28) * s(3) + o(30) * (s(5) + s(9)) + o(32) * s(7) + o(42) * (s(10) + s(11)) + o(44) * s(15) + o(46) * s(14) + o(56) * (s(12) + s(13)) + o(58) * s(17) + o(60) * s(16);
    c[3] = o(3) * s(0) + o(9) * s(1) + o(15) * s(2) + o(17) * (s(4) + s(8)) + o(19) * s(6) + o(29) * s(3) + o(31) * (s(5) + s(9)) + o(33) * s(7) + o(43) * (s(10) + s(11)) + o(45) * s(15) + o(47) * s(14) + o(57) * (s(12) + s(13)) + o(59) * s(17) + o(61) * s(16);
    c[4] = o(2) * s(0) + o(8) * s(1) + o(14) * s(4) + o(16) * (s(2) + s(6)) + o(18) * s(8) + o(28) * s(5) + o(30) * (s(3) + s(7)) + o(32) * s(9) + o(42) * (s(14) + s(15)) + o(44) * s(10) + o(46) * s(11) + o(56) * (s(16) + s(17)) + o(58) * s(12) + o(60) * s(13);
    c[5] = o(3) * s(0) + o(9) * s(1) + o(15) * s(4) + o(17) * (s(2) + s(6)) + o(19) * s(8) + o(29) * s(5) + o(31) * (s(3) + s(7)) + o(33) * s(9) + o(43) * (s(14) + s(15)) + o(45) * s(10) + o(47) * s(11) + o(57) * (s(16) + s(17)) + o(59) * s(12) + o(61) * s(13);
    c[6] = o(2) * s(0) + o(8) * s(1) + o(14) * s(6) + o(16) * (s(4) + s(8)) + o(18) * s(2) + o(28) * s(7) + o(30) * (s(5) + s(9)) + o(32) * s(3) + o(42) * (s(10) + s(11)) + o(44) * s(14) + o(46) * s(15) + o(56) * (s(12) + s(13)) + o(58) * s(16) + o(60) * s(17);
    c[7] = o(3) * s(0) + o(9) * s(1) + o(15) * s(6) + o(17) * (s(4) + s(8)) + o(19) * s(2) + o(29) * s(7) + o(31) * (s(5) + s(9)) + o(33) * s(3) + o(43) * (s(10) + s(11)) + o(45) * s(14) + o(47) * s(15) + o(57) * (s(12) + s(13)) + o(59) * s(16) + o(61) * s(17);
    c[8] = o(2) * s(0) + o(8) * s(1) + o(14) * s(8) + o(16) * (s(2) + s(6)) + o(18) * s(4) + o(28) * s(9) + o(30) * (s(3) + s(7)) + o(32) * s(5) + o(42) * (s(14) + s(15)) + o(44) * s(11) + o(46) * s(10) + o(56) * (s(16) + s(17)) + o(58) * s(13) + o(60) * s(12);
    c[9] = o(3) * s(0) + o(9) * s(1) + o(15) * s(8) + o(17) * (s(2) + s(6)) + o(19) * s(4) + o(29) * s(9) + o(31) * (s(3) + s(7)) + o(33) * s(5) + o(43) * (s(14) + s(15)) + o(45) * s(11) + o(47) * s(10) + o(57) * (s(16) + s(17)) + o(59) * s(13) + o(61) * s(12);
    c[10] = o(4) * s(0) + o(10) * s(1) + o(20) * (s(2) + s(6)) + o(22) * s(8) + o(23) * s(4) + o(34) * (s(3) + s(7)) + o(36) * s(9) + o(37) * s(5) + o(48) * s(10) + o(49) * s(11) + o(52) * (s(14) + s(15)) + o(62) * s(12) + o(63) * s(13) + o(66) * (s(16) + s(17));
    c[11] = o(4) * s(0) + o(10) * s(1) + o(20) * (s(2) + s(6)) + o(22) * s(4) + o(23) * s(8) + o(34) * (s(3) + s(7)) + o(36) * s(5) + o(37) * s(9) + o(48) * s(11) + o(49) * s(10) + o(52) * (s(14) + s(15)) + o(62) * s(13) + o(63) * s(12) + o(66) * (s(16) + s(17));
    c[12] = o(5) * s(0) + o(11) * s(1) + o(21) * (s(2) + s(6)) + o(24) * s(8) + o(25) * s(4) + o(35) * (s(3) + s(7)) + o(38) * s(9) + o(39) * s(5) + o(50) * s(10) + o(51) * s(11) + o(53) * (s(14) + s(15)) + o(64) * s(12) + o(65) * s(13) + o(67) * (s(16) + s(17));
    c[13] = o(5) * s(0) + o(11) * s(1) + o(21) * (s(2) + s(6)) + o(24) * s(4) + o(25) * s(8) + o(35) * (s(3) + s(7)) + o(38) * s(5) + o(39) * s(9) + o(50) * s(11) + o(51) * s(10) + o(53) * (s(14) + s(15)) + o(64) * s(13) + o(65) * s(12) + o(67) * (s(16) + s(17));
    c[14] = o(4) * s(0) + o(10) * s(1) + o(20) * (s(4) + s(8)) + o(22) * s(2) + o(23) * s(6) + o(34) * (s(5) + s(9)) + o(36) * s(3) + o(37) * s(7) + o(48) * s(14) + o(49) * s(15) + o(52) * (s(10) + s(11)) + o(62) * s(16) + o(63) * s(17) + o(66) * (s(12) + s(13));
    c[15] = o(4) * s(0) + o(10) * s(1) + o(20) * (s(4) + s(8)) + o(22) * s(6) + o(23) * s(2) + o(34) * (s(5) + s(9)) + o(36) * s(7) + o(37) * s(3) + o(48) * s(15) + o(49) * s(14) + o(52) * (s(10) + s(11)) + o(62) * s(17) + o(63) * s(16) + o(66) * (s(12) + s(13));
    c[16] = o(5) * s(0) + o(11) * s(1) + o(21) * (s(4) + s(8)) + o(24) * s(2) + o(25) * s(6) + o(35) * (s(5) + s(9)) + o(38) * s(3) + o(39) * s(7) + o(50) * s(14) + o(51) * s(15) + o(53) * (s(10) + s(11)) + o(64) * s(16) + o(65) * s(17) + o(67) * (s(12) + s(13));
    c[17] = o(5) * s(0) + o(11) * s(1) + o(21) * (s(4) + s(8)) + o(24) * s(6) + o(25) * s(2) + o(35) * (s(5) + s(9)) + o(38) * s(7) + o(39) * s(3) + o(50) * s(15) + o(51) * s(14) + o(53) * (s(10) + s(11)) + o(64) * s(17) + o(65) * s(16) + o(67) * (s(12) + s(13));
  }

  // Lambertian surface closure on face nz: the up dofs gain albedo * (sum of the
  // down dofs) * their hemisphere weight
  template <class U>
  __device__ static __forceinline__ void k1_closure(U u, float alb, float* S) {
    const float edn = u(1) + u(3) + u(5) + u(7) + u(9);
    S[0] += alb * edn * 0.4375f;
    S[2] += alb * edn * 0.140625f;
    S[4] += alb * edn * 0.140625f;
    S[6] += alb * edn * 0.140625f;
    S[8] += alb * edn * 0.140625f;
  }
};
