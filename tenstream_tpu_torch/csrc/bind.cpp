// PyTorch binding of the diffuse-operator kernels in orbit_ops.cu and
// dense_ops.cu and of the BoxMC photon tracer in boxmc_ops.cu.  The only
// source that includes PyTorch's headers: it checks the tensors,
// allocates the outputs and scratch, launches on the current stream and
// checks the launch.  Check messages are string literals only: a message that formats
// a number (c10::str through an ostringstream) crashed the process instead
// of raising with the CUDA build toolchain the kernels were tested with.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

#include <vector>

#include "boxmc_ops.h"
#include "dense_ops.h"
#include "orbit_tables.h"

namespace {

// nd and norb of K1/K2's instantiation inst (orbit_schemes.h); raises for
// an index with none
void orbit_dims(int64_t inst, int* nd, int* norb) {
  TORCH_CHECK(inst >= 0 && inst < (1 << 20) && orbit_scheme_dims((int)inst, nd, norb) == 0,
              "no K1/K2 instantiation with this index");
}

void check_f32(const torch::Tensor& x, const char* name, int64_t dim) {
  TORCH_CHECK(x.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(x.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(x.dim() == dim, name, " has the wrong number of dims");
  TORCH_CHECK(x.is_contiguous(), name, " must be contiguous");
}

torch::Tensor orbit_contract(torch::Tensor src, torch::Tensor orb, int64_t inst) {
  int nd = 0, norb = 0;
  orbit_dims(inst, &nd, &norb);
  check_f32(src, "src", 5);
  check_f32(orb, "orb", 5);
  const int64_t B = src.size(0);
  TORCH_CHECK(src.size(1) == nd, "src dof dim != the instantiation's nd");
  TORCH_CHECK(orb.size(0) == B && orb.size(1) == norb, "orb must be (B, norb, ...)");
  TORCH_CHECK(orb.size(2) == src.size(2) && orb.size(3) == src.size(3) &&
                  orb.size(4) == src.size(4),
              "orb and src cell dims differ");
  TORCH_CHECK(orb.device() == src.device(), "src and orb on different devices");
  const int64_t ncell = src.size(2) * src.size(3) * src.size(4);
  TORCH_CHECK(ncell * norb < (int64_t)1 << 31, "field too large for int indexing");
  const c10::cuda::CUDAGuard guard(src.device());
  auto out = torch::empty_like(src);
  if (B == 0 || ncell == 0) return out;
  cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(launch_orbit_contract((int)inst, src.data_ptr<float>(), orb.data_ptr<float>(),
                                       out.data_ptr<float>(), (int)B, (int)ncell, stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// K1 of instantiation inst: nd dofs, norb channels.  In halo mode u and orb
// are padded by a one-cell ring: (.., nx + 2, ny + 2) against w's (nx, ny).
std::vector<torch::Tensor> fused_A_dots(torch::Tensor u, torch::Tensor w, torch::Tensor orb,
                                        torch::Tensor albedo, int64_t inst, bool halo) {
  int nd = 0, norb = 0;
  orbit_dims(inst, &nd, &norb);
  check_f32(u, "u", 5);
  check_f32(w, "w", 5);
  check_f32(orb, "orb", 5);
  check_f32(albedo, "albedo", 3);
  const int64_t B = w.size(0), nz = w.size(2) - 1, nx = w.size(3), ny = w.size(4);
  const int64_t pad = halo ? 2 : 0;
  TORCH_CHECK(w.size(1) == nd, "w must have the instantiation's nd dofs");
  TORCH_CHECK(nz >= 1, "w needs at least two face levels");
  TORCH_CHECK(nx >= 1 && ny >= 1, "w needs at least one column");
  TORCH_CHECK(u.size(0) == B && u.size(1) == nd && u.size(2) == nz + 1 && u.size(3) == nx + pad &&
                  u.size(4) == ny + pad,
              "u must have the shape of w, padded by a one-cell ring in halo mode");
  TORCH_CHECK(orb.size(0) == B && orb.size(1) == norb && orb.size(2) == nz &&
                  orb.size(3) == nx + pad && orb.size(4) == ny + pad,
              "orb must be (B, norb, nz, nx, ny), padded by a one-cell ring in halo mode");
  TORCH_CHECK(albedo.size(0) == B && albedo.size(1) == nx && albedo.size(2) == ny,
              "albedo must be (B, nx, ny)");
  TORCH_CHECK(w.device() == u.device() && orb.device() == u.device() &&
                  albedo.device() == u.device(),
              "tensors on different devices");
  TORCH_CHECK(nz * (nx + pad) * (ny + pad) * norb < (int64_t)1 << 31 &&
                  (nz + 1) * (nx + pad) * (ny + pad) * nd < (int64_t)1 << 31,
              "field too large for int indexing");
  TORCH_CHECK(B < 65536, "batch too large for the grid");
  const c10::cuda::CUDAGuard guard(u.device());
  auto Au = torch::empty_like(w);
  auto dots = torch::empty({B, 2}, u.options());
  if (B == 0) return {Au, dots};
  const int nblk = fused_A_dots_blocks((int)inst, (int)B, (int)nz, (int)nx, (int)ny);
  TORCH_CHECK(nblk > 0, "K1: no launch configuration on this device");
  auto partials = torch::empty({B, nblk, 2}, u.options());
  cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(launch_fused_A_dots((int)inst, u.data_ptr<float>(), w.data_ptr<float>(),
                                     orb.data_ptr<float>(), albedo.data_ptr<float>(),
                                     Au.data_ptr<float>(), partials.data_ptr<float>(),
                                     dots.data_ptr<float>(), (int)B, (int)nz, (int)nx, (int)ny,
                                     halo ? 1 : 0, stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {Au, dots};
}

// itab layout (see tenstream_tpu_torch/pprts/cuda_ops.py::_dense_tables):
// nd, gz[nd], gx[nd], gy[nd], cz[nd], cx[nd], cy[nd]
DenseTables make_dense_tables(const std::vector<int64_t>& itab) {
  TORCH_CHECK(!itab.empty() && itab[0] >= 1 && itab[0] <= TS_DENSE_MAXD,
              "dense tables: nd outside 1..30");
  const size_t D = (size_t)itab[0];
  TORCH_CHECK(itab.size() == 1 + 6 * D, "dense tables: wrong number of ints");
  DenseTables t = {};
  size_t q = 0;
  t.nd = (int)itab[q++];
  for (int* row : {t.gz, t.gx, t.gy})
    for (size_t s = 0; s < D; ++s) {
      row[s] = (int)itab[q++];
      TORCH_CHECK(row[s] == 0 || row[s] == 1, "dense tables: K3 takes gshift in {0, 1} only");
    }
  for (int* row : {t.cz, t.cx, t.cy})
    for (size_t s = 0; s < D; ++s) {
      row[s] = (int)itab[q++];
      TORCH_CHECK(row[s] == -1 || row[s] == 0, "dense tables: K3 takes cshift in {-1, 0} only");
    }
  return t;
}

// K3's launch configuration: (threads per block, shared memory bytes per
// block, blocks per SM) for float32 (bf16 = false) or bfloat16 coefficients
// and nd dofs
std::vector<int64_t> dense_config(bool bf16, int64_t nd) {
  int threads = 0, smem = 0, per_sm = 0;
  TORCH_CHECK(nd >= 1 && nd <= TS_DENSE_MAXD, "nd outside 1..30");
  C10_CUDA_CHECK(diffuse_apply_dense_config(bf16 ? 1 : 0, (int)nd, &threads, &smem, &per_sm));
  return {threads, smem, per_sm};
}

torch::Tensor diffuse_apply_dense(torch::Tensor x, torch::Tensor c, std::vector<int64_t> itab) {
  const DenseTables t = make_dense_tables(itab);
  check_f32(x, "x", 5);
  TORCH_CHECK(c.is_cuda(), "c must be a CUDA tensor");
  const bool bf16 = c.scalar_type() == torch::kBFloat16;
  TORCH_CHECK(bf16 || c.scalar_type() == torch::kFloat32, "c must be float32 or bfloat16");
  TORCH_CHECK(c.dim() == 6, "c must have 6 dims");
  TORCH_CHECK(c.is_contiguous(), "c must be contiguous");
  const int64_t B = x.size(0), nz = x.size(2) - 1, nx = x.size(3), ny = x.size(4);
  TORCH_CHECK(x.size(1) == t.nd, "x dof dim != nd");
  TORCH_CHECK(nz >= 1, "x needs at least two face levels");
  TORCH_CHECK(c.size(0) == B && c.size(1) == t.nd && c.size(2) == t.nd && c.size(3) == nz &&
                  c.size(4) == nx && c.size(5) == ny,
              "c must be (B, nd, nd, nz, nx, ny)");
  TORCH_CHECK(c.device() == x.device(), "x and c on different devices");
  TORCH_CHECK((nz + 1) * nx * ny < (int64_t)1 << 31, "field too large for int indexing");
  TORCH_CHECK(B < 65536, "batch too large for the grid");
  const c10::cuda::CUDAGuard guard(x.device());
  auto out = torch::empty_like(x);
  if (B == 0 || nx == 0 || ny == 0) return out;
  cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(launch_diffuse_apply_dense(x.data_ptr<float>(), c.data_ptr(), bf16 ? 1 : 0,
                                            out.data_ptr<float>(), &t, (int)B, (int)nz, (int)nx,
                                            (int)ny, stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// K3's halo mode: hx (B, nd, nz+1, ny) and hy (B, nd, nz+1, nx) are the
// planes just past the block's high x and y edges; returns out and the
// faces past those edges, ox (B, nd, nz+1, ny) and oy (B, nd, nz+1, nx).
std::vector<torch::Tensor> diffuse_apply_dense_halo(torch::Tensor x, torch::Tensor c,
                                                    std::vector<int64_t> itab, torch::Tensor hx,
                                                    torch::Tensor hy) {
  const DenseTables t = make_dense_tables(itab);
  for (int s = 0; s < t.nd; ++s)
    TORCH_CHECK(!(t.gx[s] && t.gy[s]), "dense tables: K3's halo mode reads no corner");
  check_f32(x, "x", 5);
  check_f32(hx, "hx", 4);
  check_f32(hy, "hy", 4);
  TORCH_CHECK(c.is_cuda(), "c must be a CUDA tensor");
  const bool bf16 = c.scalar_type() == torch::kBFloat16;
  TORCH_CHECK(bf16 || c.scalar_type() == torch::kFloat32, "c must be float32 or bfloat16");
  TORCH_CHECK(c.dim() == 6, "c must have 6 dims");
  TORCH_CHECK(c.is_contiguous(), "c must be contiguous");
  const int64_t B = x.size(0), nz = x.size(2) - 1, nx = x.size(3), ny = x.size(4);
  TORCH_CHECK(x.size(1) == t.nd, "x dof dim != nd");
  TORCH_CHECK(nz >= 1, "x needs at least two face levels");
  TORCH_CHECK(c.size(0) == B && c.size(1) == t.nd && c.size(2) == t.nd && c.size(3) == nz &&
                  c.size(4) == nx && c.size(5) == ny,
              "c must be (B, nd, nd, nz, nx, ny)");
  TORCH_CHECK(hx.size(0) == B && hx.size(1) == t.nd && hx.size(2) == nz + 1 && hx.size(3) == ny,
              "hx must be (B, nd, nz+1, ny)");
  TORCH_CHECK(hy.size(0) == B && hy.size(1) == t.nd && hy.size(2) == nz + 1 && hy.size(3) == nx,
              "hy must be (B, nd, nz+1, nx)");
  TORCH_CHECK(c.device() == x.device() && hx.device() == x.device() && hy.device() == x.device(),
              "x, c and the halo planes on different devices");
  TORCH_CHECK((nz + 1) * nx * ny < (int64_t)1 << 31, "field too large for int indexing");
  TORCH_CHECK(B < 65536, "batch too large for the grid");
  const c10::cuda::CUDAGuard guard(x.device());
  auto out = torch::empty_like(x);
  auto ox = torch::zeros_like(hx);
  auto oy = torch::zeros_like(hy);
  if (B == 0 || nx == 0 || ny == 0) return {out, ox, oy};
  cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  const DenseHalo h = {hx.data_ptr<float>(), hy.data_ptr<float>(), ox.data_ptr<float>(),
                       oy.data_ptr<float>()};
  C10_CUDA_CHECK(launch_diffuse_apply_dense_halo(x.data_ptr<float>(), c.data_ptr(), bf16 ? 1 : 0,
                                                 out.data_ptr<float>(), &t, &h, (int)B, (int)nz,
                                                 (int)nx, (int)ny, stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {out, ox, oy};
}

// tables layout (see tenstream_tpu_torch/boxmc/cuda_tracer.py::_tables):
// dir_code[6], diff_dn[6], diff_up[6]
std::vector<torch::Tensor> boxmc_trace(torch::Tensor params, torch::Tensor order, int64_t ldir,
                                       int64_t ndir,
                                       int64_t ndiff, std::vector<int64_t> tables,
                                       int64_t max_iter) {
  TORCH_CHECK(tables.size() == 18, "boxmc tables: expected 18 ints");
  BoxTables t;
  for (int f = 0; f < 6; ++f) {
    t.dir_code[f] = (int)tables[f];
    t.diff_dn[f] = (int)tables[6 + f];
    t.diff_up[f] = (int)tables[12 + f];
  }
  for (int64_t c : tables)
    TORCH_CHECK(c >= -1 && c < ndir + ndiff, "boxmc tables: code out of range");
  check_f32(params, "params", 2);
  TORCH_CHECK(params.size(1) == BOXMC_NPARAM, "params must be (B, 9)");
  TORCH_CHECK(max_iter >= 0 && max_iter <= 400000, "max_iter out of range");
  TORCH_CHECK(boxmc_layout_ok((int)ndir, (int)ndiff), "boxmc: no kernel for this layout");
  const int64_t B = params.size(0);
  TORCH_CHECK(B <= 400000, "too many entries for one launch");
  TORCH_CHECK(order.is_cuda() && order.scalar_type() == torch::kInt32 && order.dim() == 1 &&
                  order.size(0) == B && order.is_contiguous() && order.device() == params.device(),
              "order must be a contiguous int32 (B,) tensor beside params");
  const c10::cuda::CUDAGuard guard(params.device());
  auto out = torch::empty({B, ndir + ndiff}, params.options());
  auto counts = torch::zeros({B + 2}, params.options().dtype(torch::kInt64));
  auto steps = counts.narrow(0, 0, B);
  auto trips = counts.narrow(0, B, 1);
  if (B == 0) return {out, steps, trips};
  auto rec_code = torch::empty({B * BOXMC_PHOTONS}, params.options().dtype(torch::kUInt8));
  auto rec_w = torch::empty({B * BOXMC_PHOTONS}, params.options());
  auto entry_scratch =
      torch::empty({B * boxmc_entry_scratch_bytes()}, params.options().dtype(torch::kUInt8));
  BoxmcLaunch a;
  a.params = params.data_ptr<float>();
  a.order = order.data_ptr<int>();
  a.out = out.data_ptr<float>();
  a.steps = (long long*)steps.data_ptr<int64_t>();
  a.trips = (long long*)trips.data_ptr<int64_t>();
  a.queue = (unsigned int*)(counts.data_ptr<int64_t>() + B + 1);
  a.rec_code = rec_code.data_ptr<uint8_t>();
  a.rec_w = rec_w.data_ptr<float>();
  a.entry_scratch = entry_scratch.data_ptr();
  a.tables = &t;
  a.batch = (int)B;
  cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  C10_CUDA_CHECK(launch_boxmc_trace(&a, (int)ldir, (int)ndir, (int)ndiff, (int)max_iter, stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {out, steps, trips};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("orbit_contract", &orbit_contract, "K2: per-cell orbit contraction (CUDA)");
  m.def("fused_A_dots", &fused_A_dots, "K1: A(u) = u - S(u) plus two dots (CUDA)",
        pybind11::arg("u"), pybind11::arg("w"), pybind11::arg("orb"), pybind11::arg("albedo"),
        pybind11::arg("inst"), pybind11::arg("halo") = false);
  m.def("diffuse_apply_dense", &diffuse_apply_dense,
        "K3: S(x) on dense [src, dst] coefficients, float32 or bfloat16 (CUDA)");
  m.def("diffuse_apply_dense_halo", &diffuse_apply_dense_halo,
        "K3's halo mode on a rank's block: halo planes in, the faces past the block's high edges "
        "out (CUDA)");
  m.def("diffuse_apply_dense_config", &dense_config,
        "K3's launch configuration on the current device for float32 or bfloat16 coefficients "
        "and nd dofs: threads, shared memory bytes and blocks per SM");
  m.def("boxmc_trace", &boxmc_trace,
        "K4: BoxMC photon tracing, a photon queue over the launch and a fixed-order reduction per "
        "entry; rows [T | S], photon-steps and warp loop trips (CUDA)");
}
