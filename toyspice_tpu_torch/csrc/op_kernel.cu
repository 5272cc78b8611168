// One operating-point Newton solve per Monte-Carlo lane per launch, one
// thread per lane, in f64.
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_op.py::_op_kernel (body
// _op_core with the "op" flavour, launched at pallas_op.py:555), compat and
// (the PHYS instantiations) its phys_be mode (pallas_op.py:574-595): the
// physics diode with Bv and Rs and its breakdown-frame limit; the OP has
// no companions, so nothing else changes with the semantics.  The host
// (ops/op.py::make_op_fused) runs the reference's rescue ladders around it:
// plain NR, the gmin ladder, source stepping, each rung one launch on the
// lanes still active.  Per lane:
//
//   if use_seed: x0 = the linear-devices-only estimate (op.go:90-111): the
//     plan's leading linear stamps with status gmin 0, no gmin diagonal,
//     solved by Gauss-Jordan; the zero vector if any entry is non-finite;
//   if act: the OP Newton of newton.cuh (junction voltages from x at every
//     iteration, status gmin on the MOSFET drain/source diagonals and on
//     every non-ground diagonal).
//
// OP stamps (ops/assemble.py mode "op"): a capacitor leaks max(status gmin,
// gmin floor), an inductor stamps its dt = 1e-9 companion, sources take
// their t = 0 values, each magnetic inductor (LM) stamps its +1e-3 branch
// diagonal (pallas_op.py:130-138), a mutual coupling nothing.  The lane's
// dyn row is [status_gmin, use_seed, act, vsrc(nV), isrc(nI), lrhs(nL)],
// as ops/op.py builds it.  An inactive lane
// returns x0 (or the estimate), jv0, 0 iterations and not converged.
// ops/op.py::op_plain is the same arithmetic as torch operations, and the
// build uses -fmad=false.
//
// Bound: operations, a Newton iteration's device evaluations, build and
// solve (chip_smoke.py newton_flops); the bytes are a few rows per lane.
// Like the run kernel it is latency-bound: one thread's iterations are a
// serial chain through its local-memory matrix.

#include "newton.cuh"

namespace {

using namespace tsr;

template <int NMAX, bool PHYS>
__global__ void __launch_bounds__(THREADS)
op_kernel(const int* __restrict__ topo_g, int topo_len,
          const double* __restrict__ dev, const double* __restrict__ dyn_g,
          const double* __restrict__ x0, const double* __restrict__ jv0,
          double* __restrict__ x_out, double* __restrict__ jv_out,
          int* __restrict__ iters_out, int* __restrict__ conv_out,
          int nlanes, double reltol, double abstol, int max_iter,
          double gmin_floor) {
  extern __shared__ int topo[];
  for (int i = threadIdx.x; i < topo_len; i += blockDim.x) topo[i] = topo_g[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nlanes) return;

  const int n = topo[H_NP1], ne = topo[H_NE], n_lin = topo[H_NLIN];
  const int nr = topo[H_NR], nc = topo[H_NC], nl = topo[H_NL];
  const int nv_src = topo[H_NV], ni = topo[H_NI];
  const int* ent = topo + topo[H_ENT];
  const double* dv = dev + (size_t)lane * topo[H_ND];
  const double* g = dv;
  const double* lval = dv + nr + 2 * nc;
  const Deck deck(topo, dv);
  const int kj = deck.kj;
  const double* dyn = dyn_g + (size_t)lane * (3 + nv_src + ni + nl);
  const double gmin = dyn[0];
  const bool use_seed = dyn[1] > 0.5;
  const bool act = dyn[2] > 0.5;
  const double* vsrc = dyn + 3;
  const double* isrc = vsrc + nv_src;
  const double* lrhs = isrc + ni;

  double m[NMAX][NMAX + 1];
  double x[NMAX];
  double jv[MAX_KJ];
  double nv[MAX_NVAL];
  for (int i = 0; i < n; ++i) x[i] = x0[(size_t)lane * n + i];
  for (int i = 0; i < kj; ++i) jv[i] = jv0[(size_t)lane * kj + i];

  // an OP linear stamp's value with the capacitor leak gc (by value: a
  // reference capture would take the address of the kernel's scalars)
  auto lin_for = [g, lval, lrhs, vsrc, isrc](double gc) {
    return [g, lval, lrhs, vsrc, isrc, gc](int tag, int k) -> double {
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
  };

  if (use_seed) {  // the linear-devices-only estimate, status gmin 0
    build<NMAX, false>(m, n, ent, n_lin, lin_for(max_nan(0.0, gmin_floor)),
                       nv);
    if (!gauss_jordan<NMAX>(m, n, x))
      for (int i = 0; i < n; ++i) x[i] = 0.0;
  }
  int iters = 0;
  bool conv = false;
  if (act)
    iters = newton<NMAX, FL_OP, PHYS>(deck, ent, ne,
                                      lin_for(max_nan(gmin, gmin_floor)), m,
                                      x, jv, nv, gmin, max_iter, reltol,
                                      abstol, &conv);

  for (int i = 0; i < n; ++i) x_out[(size_t)lane * n + i] = x[i];
  for (int i = 0; i < kj; ++i) jv_out[(size_t)lane * kj + i] = jv[i];
  iters_out[lane] = iters;
  conv_out[lane] = conv ? 1 : 0;
}

template <int NMAX, bool PHYS>
cudaError_t launch(const int* topo, int topo_len, const double* dev,
                   const double* dyn, const double* x0, const double* jv0,
                   double* x_out, double* jv_out, int* iters, int* conv,
                   int nlanes, double reltol, double abstol, int max_iter,
                   double gmin_floor, cudaStream_t stream) {
  const int blocks = (nlanes + THREADS - 1) / THREADS;
  const size_t shmem = (size_t)topo_len * sizeof(int);
  op_kernel<NMAX, PHYS><<<blocks, THREADS, shmem, stream>>>(
      topo, topo_len, dev, dyn, x0, jv0, x_out, jv_out, iters, conv, nlanes,
      reltol, abstol, max_iter, gmin_floor);
  return cudaGetLastError();
}

template <bool PHYS>
int launch_np1(int np1, const int* topo, int topo_len, const double* dev,
               const double* dyn, const double* x0, const double* jv0,
               double* x_out, double* jv_out, int* iters, int* conv,
               int nlanes, double reltol, double abstol, int max_iter,
               double gmin_floor, cudaStream_t s) {
  if (np1 <= 8)
    return launch<8, PHYS>(topo, topo_len, dev, dyn, x0, jv0, x_out, jv_out,
                           iters, conv, nlanes, reltol, abstol, max_iter,
                           gmin_floor, s);
  if (np1 <= 16)
    return launch<16, PHYS>(topo, topo_len, dev, dyn, x0, jv0, x_out,
                            jv_out, iters, conv, nlanes, reltol, abstol,
                            max_iter, gmin_floor, s);
  if (np1 <= 32)
    return launch<32, PHYS>(topo, topo_len, dev, dyn, x0, jv0, x_out,
                            jv_out, iters, conv, nlanes, reltol, abstol,
                            max_iter, gmin_floor, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch the OP kernel for nlanes lanes on `stream`; returns the
// cudaError_t of the launch (0 on success).  np1 picks the matrix size,
// physics the physics instantiation.
extern "C" int tsr_op(int np1, const int* topo, int topo_len,
                      const double* dev, const double* dyn, const double* x0,
                      const double* jv0, double* x_out, double* jv_out,
                      int* iters, int* conv, int nlanes, double reltol,
                      double abstol, int max_iter, double gmin_floor,
                      int physics, void* stream) {
  if (nlanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (physics)
    return launch_np1<true>(np1, topo, topo_len, dev, dyn, x0, jv0, x_out,
                            jv_out, iters, conv, nlanes, reltol, abstol,
                            max_iter, gmin_floor, s);
  return launch_np1<false>(np1, topo, topo_len, dev, dyn, x0, jv0, x_out,
                           jv_out, iters, conv, nlanes, reltol, abstol,
                           max_iter, gmin_floor, s);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
