// Every point of a DC sweep in one launch, one thread per Monte-Carlo lane,
// in f64.
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_op.py::_dc_sweep_kernel
// (body _dc_sweep_core, launched at pallas_op.py:837 through
// _dc_sweep_call and make_dc_fused), which computes vmap(engine/dc.py
// make_dc), compat and (the PHYS instantiations) its phys_be mode
// (pallas_op.py:856-960: the physics diode with Bv and Rs and its
// breakdown-frame limit): per lane, the junction voltages start at zero and
// carry from point to point; at each point
//
//   x = 0 (dc.py passes zeros; _dc_sweep_core x0 = (zn, zn));
//   the DC-flavour Newton of newton.cuh: iteration 0 stamps the carried
//   junction voltages, later ones UpdateVoltages + pnjlim of the last
//   solution; OP stamps with status gmin 0 (a capacitor leaks the gmin
//   floor, an inductor stamps its dt = 1e-9 companion, no gmin diagonal,
//   an LM its +1e-3 branch diagonal, pallas_op.py:285-298, and a K
//   nothing);
//   convergence from iteration 1 on by CheckConvergence, every |new - old|
//   <= abstol or <= reltol*|new|, and the solution finite (dc.go:142-187);
//   the point's voltage-source values are row p of the lane's table
//   vs (P, nV): eval_sources at t = 0 with the swept dc slot(s) replaced,
//   as ops/dc.py builds it (one table for every lane when no V leaf is
//   batched: lane stride 0).
//
// The lane's dyn row is [isrc(nI), lrhs(nL)]: the current sources at t = 0
// and the inductor companion RHS.  Outputs per lane and point: x (n), the
// Newton iterations and whether the point converged.  ops/dc.py::dc_plain
// is the same arithmetic as torch operations, and the build uses
// -fmad=false.
//
// The TPU kernel reads each point's sources through a static select chain
// over all P points and writes its outputs through a (P, n+2) broadcast
// mask (Mosaic has no dynamic indexing of register arrays), which is why
// the JAX package falls back to one launch per point above 128 points; a
// thread here indexes its point directly, so there is no such limit.
//
// Bound: operations, the Newton iterations of every point (chip_smoke.py
// newton_flops); the bytes are the dev row, the source table and the
// outputs.  Like the OP kernel it is latency-bound: one thread's points
// and iterations are a serial chain through its local-memory matrix.

#include "newton.cuh"

namespace {

using namespace tsr;

template <int NMAX, bool PHYS>
__global__ void __launch_bounds__(THREADS)
dc_sweep_kernel(const int* __restrict__ topo_g, int topo_len,
                const double* __restrict__ dev,
                const double* __restrict__ dyn_g,
                const double* __restrict__ vs, long long vs_stride,
                int npts, double* __restrict__ x_out,
                int* __restrict__ iters_out, int* __restrict__ conv_out,
                int nlanes, double reltol, double abstol, int max_iter,
                double gmin_floor) {
  extern __shared__ int topo[];
  for (int i = threadIdx.x; i < topo_len; i += blockDim.x) topo[i] = topo_g[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nlanes) return;

  const int n = topo[H_NP1], ne = topo[H_NE];
  const int nr = topo[H_NR], nc = topo[H_NC], nl = topo[H_NL];
  const int nv_src = topo[H_NV], ni = topo[H_NI];
  const int* ent = topo + topo[H_ENT];
  const double* dv = dev + (size_t)lane * topo[H_ND];
  const double* g = dv;
  const double* lval = dv + nr + 2 * nc;
  const Deck deck(topo, dv);
  const double* isrc = dyn_g + (size_t)lane * (ni + nl);
  const double* lrhs = isrc + ni;
  const double* vlane = vs + (size_t)lane * vs_stride;
  // status gmin 0: the capacitor leak is the floor
  const double gc = max_nan(0.0, gmin_floor);

  double m[NMAX][NMAX + 1];
  double x[NMAX];
  double jv[MAX_KJ];
  double nv[MAX_NVAL];
  for (int i = 0; i < deck.kj; ++i) jv[i] = 0.0;

  for (int p = 0; p < npts; ++p) {
    const double* vsrc = vlane + (size_t)p * nv_src;
    auto lin = [g, lval, lrhs, vsrc, isrc, gc](int tag, int k) -> double {
      switch (tag) {
        case TAG_G: return g[k];
        case TAG_GEQ: return gc;
        case TAG_LTERM: return lval[k] / 1e-9;
        case TAG_LRHS: return lrhs[k];
        case TAG_VSRC: return vsrc[k];
        case TAG_ISRC: return isrc[k];
        // an LM's +1e-3 branch diagonal against the plan's sign -1
        // (magnetic.go:216-217); the OP plan has no K and no LM RHS
        case TAG_LMTERM: return -1e-3;
        default: return 1.0;  // TAG_ONE (the OP plan has no TAG_CEQ)
      }
    };
    for (int i = 0; i < n; ++i) x[i] = 0.0;
    bool conv = false;
    const int iters = newton<NMAX, FL_DC, PHYS>(deck, ent, ne, lin, m, x,
                                                jv, nv, 0.0, max_iter, reltol,
                                                abstol, &conv);
    const size_t pt = (size_t)lane * npts + p;
    for (int i = 0; i < n; ++i) x_out[pt * n + i] = x[i];
    iters_out[pt] = iters;
    conv_out[pt] = conv ? 1 : 0;
  }
}

template <int NMAX, bool PHYS>
cudaError_t launch(const int* topo, int topo_len, const double* dev,
                   const double* dyn, const double* vs, long long vs_stride,
                   int npts, double* x_out, int* iters, int* conv,
                   int nlanes, double reltol, double abstol, int max_iter,
                   double gmin_floor, cudaStream_t stream) {
  const int blocks = (nlanes + THREADS - 1) / THREADS;
  const size_t shmem = (size_t)topo_len * sizeof(int);
  dc_sweep_kernel<NMAX, PHYS><<<blocks, THREADS, shmem, stream>>>(
      topo, topo_len, dev, dyn, vs, vs_stride, npts, x_out, iters, conv,
      nlanes, reltol, abstol, max_iter, gmin_floor);
  return cudaGetLastError();
}

template <bool PHYS>
int launch_np1(int np1, const int* topo, int topo_len, const double* dev,
               const double* dyn, const double* vs, long long vs_stride,
               int npts, double* x_out, int* iters, int* conv, int nlanes,
               double reltol, double abstol, int max_iter,
               double gmin_floor, cudaStream_t s) {
  if (np1 <= 8)
    return launch<8, PHYS>(topo, topo_len, dev, dyn, vs, vs_stride, npts,
                           x_out, iters, conv, nlanes, reltol, abstol,
                           max_iter, gmin_floor, s);
  if (np1 <= 16)
    return launch<16, PHYS>(topo, topo_len, dev, dyn, vs, vs_stride, npts,
                            x_out, iters, conv, nlanes, reltol, abstol,
                            max_iter, gmin_floor, s);
  if (np1 <= 32)
    return launch<32, PHYS>(topo, topo_len, dev, dyn, vs, vs_stride, npts,
                            x_out, iters, conv, nlanes, reltol, abstol,
                            max_iter, gmin_floor, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch the DC sweep kernel for nlanes lanes of npts points on `stream`;
// returns the cudaError_t of the launch (0 on success).  np1 picks the
// matrix size, physics the physics instantiation; vs_stride is the lane
// stride of the source table (0 when every lane shares one).
extern "C" int tsr_dc_sweep(int np1, const int* topo, int topo_len,
                            const double* dev, const double* dyn,
                            const double* vs, long long vs_stride, int npts,
                            double* x_out, int* iters, int* conv, int nlanes,
                            double reltol, double abstol, int max_iter,
                            double gmin_floor, int physics, void* stream) {
  if (nlanes <= 0 || npts <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (physics)
    return launch_np1<true>(np1, topo, topo_len, dev, dyn, vs, vs_stride,
                            npts, x_out, iters, conv, nlanes, reltol, abstol,
                            max_iter, gmin_floor, s);
  return launch_np1<false>(np1, topo, topo_len, dev, dyn, vs, vs_stride,
                           npts, x_out, iters, conv, nlanes, reltol, abstol,
                           max_iter, gmin_floor, s);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
