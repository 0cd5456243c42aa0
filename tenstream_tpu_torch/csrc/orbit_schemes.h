// The table sets K1 and K2 are compiled for, in the order of
// tenstream_tpu_torch/pprts/cuda_ops.py::ORBIT_SCHEMES (the instantiation index).
// Generated by cuda_ops.py::orbit_index_text; do not edit.
#pragma once

#include "orbit_3_10.h"
#include "orbit_3_6.h"
#include "orbit_8_12.h"
#include "orbit_3_16.h"
#include "orbit_8_18.h"
#include "orbit_3_24.h"
#include "orbit_3_30.h"

// X(instantiation index, tables struct)
#define TS_ORBIT_SCHEMES(X) \
  X(0, Orbit_3_10) \
  X(1, Orbit_3_6) \
  X(2, Orbit_8_12) \
  X(3, Orbit_3_16) \
  X(4, Orbit_8_18) \
  X(5, Orbit_3_24) \
  X(6, Orbit_3_30)

// the diffuse dof counts K3 is instantiated for: X(nd)
#define TS_DENSE_NDS(X) X(6) X(10) X(12) X(16) X(18) X(24) X(30)
