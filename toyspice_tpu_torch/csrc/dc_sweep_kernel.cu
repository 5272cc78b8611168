// Every point of a DC sweep in one launch, each Monte-Carlo lane on a
// segment of W = 4, 8, 16 or 32 lanes of a warp (np1's size bucket), in
// f64.
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
//   the DC-flavour Newton of newton.cuh's seg_newton: iteration 0 stamps
//   the carried junction voltages, later ones UpdateVoltages + pnjlim of
//   the last solution; OP stamps with status gmin 0 (newton.cuh OpStamp: a
//   capacitor leaks the gmin floor, an inductor stamps its dt = 1e-9
//   companion, no gmin diagonal, an LM its +1e-3 branch diagonal,
//   pallas_op.py:285-298, and a K nothing);
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
// segment here indexes its point directly, so there is no such limit.
//
// Bound: operations, the Newton iterations of every point (chip_smoke.py
// newton_flops); the bytes are the dev row, the source table and the
// outputs.  A lane's points and iterations are one chain of dependent
// steps (the junction voltages carry from point to point): its segment
// spreads each iteration's device evaluations, build and elimination over
// its threads, keeps the lane's rows in the segment's slice of shared
// memory, and leaves the card THREADS / W lanes a block (8192 lanes of
// np1 <= 4: 256 blocks of 4 warps) to hide one another's latencies.

#include "newton.cuh"

namespace {

using namespace tsr;

// A launch's lanes on segments of W = NMAX threads, THREADS / W lanes a
// block: the table, then each segment's slice (newton.cuh opdc_slice).
// lane_doubles is ops/dc.py lane_doubles: the dyn row, the point's nV
// source values, then the junction voltages and value slots
// (newton_doubles); a launch that gives fewer than the deck's counts need
// returns x all NaN, 0 iterations and not converged at every point of
// every lane, and reads and writes no slice.
template <int NMAX, bool PHYS>
__global__ void __launch_bounds__(THREADS, SEG_BLOCKS)
dc_seg_kernel(const int* __restrict__ topo_g, int topo_len, int lane_doubles,
              const double* __restrict__ dev,
              const double* __restrict__ dyn_g,
              const double* __restrict__ vs, long long vs_stride, int npts,
              double* __restrict__ x_out, int* __restrict__ iters_out,
              int* __restrict__ conv_out, int nlanes, double reltol,
              double abstol, int max_iter, double gmin_floor) {
  constexpr int W = NMAX;
  constexpr unsigned mask = 0xffffffffu;
  extern __shared__ __align__(16) double seg_smem[];
  int* topo = reinterpret_cast<int*>(seg_smem);
  for (int i = threadIdx.x; i < topo_len; i += blockDim.x) topo[i] = topo_g[i];
  __syncthreads();
  const int seg = threadIdx.x / W;
  const int me = threadIdx.x & (W - 1);  // the row this thread owns
  const int lane0 = blockIdx.x * (THREADS / W);
  if (lane0 + (int)(threadIdx.x & ~31) / W >= nlanes) return;  // the warp
  const int lane = lane0 + seg;
  const bool real = lane < nlanes;
  const int row_lane = real ? lane : nlanes - 1;  // rows read, never written

  const int n = topo[H_NP1];
  const int nr = topo[H_NR], nc = topo[H_NC], nl = topo[H_NL];
  const int nv_src = topo[H_NV], ni = topo[H_NI];
  const int4* ent = reinterpret_cast<const int4*>(topo + topo[H_ROWS]);
  const int* roff = topo + topo[H_ROWS] + 4 * topo[H_NE];
  const double* dv = dev + (size_t)row_lane * topo[H_ND];
  const Deck deck(topo, dv);
  const int kj = deck.kj;
  const int dw = ni + nl;
  if (lane_doubles < dw + nv_src + kj + D_SLOTS * deck.n_d +
                         Q_SLOTS * deck.n_q + M_SLOTS * deck.n_m) {
    if (!real) return;  // a short slice
    for (int p = 0; p < npts; ++p) {
      const size_t pt = (size_t)lane * npts + p;
      if (me < n) x_out[pt * n + me] = NAN;
      if (me == 0) {
        iters_out[pt] = 0;
        conv_out[pt] = 0;
      }
    }
    return;
  }

  double* sl = seg_smem + (topo_len + 3) / 4 * 2 +
               seg * opdc_slice<NMAX>(lane_doubles);
  double* buf = sl;
  double* row = sl + (NMAX + 2) * (1 + me);
  double* xs = sl + (NMAX + 2) * (NMAX + 1);
  double* dyn = xs + NMAX;
  double* sv = dyn + dw;
  double* jv = sv + nv_src;
  double* nv = jv + kj;
  for (int i = me; i < dw; i += W) dyn[i] = dyn_g[(size_t)row_lane * dw + i];
  for (int i = me; i < kj; i += W) jv[i] = 0.0;
  const double* vlane = vs + (size_t)row_lane * vs_stride;
  // status gmin 0: the capacitor leak is the floor
  const OpStamp stamp{dv, dv + nr + 2 * nc, dyn + ni, sv, dyn,
                      max_nan(0.0, gmin_floor)};

  for (int p = 0; p < npts; ++p) {
    for (int s = me; s < nv_src; s += W) sv[s] = vlane[(size_t)p * nv_src + s];
    xs[me] = 0.0;
    __syncwarp(mask);
    bool conv = false;
    const int iters = seg_newton<NMAX, FL_DC, PHYS>(
        deck, ent, roff, stamp, 0.0, real, max_iter, reltol, abstol, buf,
        row, xs, jv, nv, me, &conv);
    if (real) {
      const size_t pt = (size_t)lane * npts + p;
      if (me < n) x_out[pt * n + me] = xs[me];
      if (me == 0) {
        iters_out[pt] = iters;
        conv_out[pt] = conv ? 1 : 0;
      }
    }
  }
}

template <int NMAX, bool PHYS>
cudaError_t launch(const int* topo, int topo_len, int lane_doubles,
                   const double* dev, const double* dyn, const double* vs,
                   long long vs_stride, int npts, double* x_out, int* iters,
                   int* conv, int nlanes, double reltol, double abstol,
                   int max_iter, double gmin_floor, cudaStream_t stream) {
  return seg_launch(dc_seg_kernel<NMAX, PHYS>,
                    opdc_shape<NMAX>(nlanes, topo_len, lane_doubles), stream,
                    topo, topo_len, lane_doubles, dev, dyn, vs, vs_stride,
                    npts, x_out, iters, conv, nlanes, reltol, abstol,
                    max_iter, gmin_floor);
}

template <bool PHYS>
int launch_np1(int np1, const int* topo, int topo_len, int lane_doubles,
               const double* dev, const double* dyn, const double* vs,
               long long vs_stride, int npts, double* x_out, int* iters,
               int* conv, int nlanes, double reltol, double abstol,
               int max_iter, double gmin_floor, cudaStream_t s) {
  switch (seg_bucket(np1)) {
    case 4:
      return launch<4, PHYS>(topo, topo_len, lane_doubles, dev, dyn, vs,
                             vs_stride, npts, x_out, iters, conv, nlanes,
                             reltol, abstol, max_iter, gmin_floor, s);
    case 8:
      return launch<8, PHYS>(topo, topo_len, lane_doubles, dev, dyn, vs,
                             vs_stride, npts, x_out, iters, conv, nlanes,
                             reltol, abstol, max_iter, gmin_floor, s);
    case 16:
      return launch<16, PHYS>(topo, topo_len, lane_doubles, dev, dyn, vs,
                              vs_stride, npts, x_out, iters, conv, nlanes,
                              reltol, abstol, max_iter, gmin_floor, s);
    case 32:
      return launch<32, PHYS>(topo, topo_len, lane_doubles, dev, dyn, vs,
                              vs_stride, npts, x_out, iters, conv, nlanes,
                              reltol, abstol, max_iter, gmin_floor, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch the DC sweep kernel for nlanes lanes of npts points on `stream`;
// returns the cudaError_t of the launch (0 on success).  np1 picks the
// segment width, physics the physics instantiation; topo is the whole
// table, row view included; lane_doubles is ops/dc.py lane_doubles;
// vs_stride is the lane stride of the source table (0 when every lane
// shares one).
extern "C" int tsr_dc_sweep(int np1, const int* topo, int topo_len,
                            int lane_doubles, const double* dev,
                            const double* dyn, const double* vs,
                            long long vs_stride, int npts, double* x_out,
                            int* iters, int* conv, int nlanes, double reltol,
                            double abstol, int max_iter, double gmin_floor,
                            int physics, void* stream) {
  if (nlanes <= 0 || npts <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (physics)
    return launch_np1<true>(np1, topo, topo_len, lane_doubles, dev, dyn, vs,
                            vs_stride, npts, x_out, iters, conv, nlanes,
                            reltol, abstol, max_iter, gmin_floor, s);
  return launch_np1<false>(np1, topo, topo_len, lane_doubles, dev, dyn, vs,
                           vs_stride, npts, x_out, iters, conv, nlanes,
                           reltol, abstol, max_iter, gmin_floor, s);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
