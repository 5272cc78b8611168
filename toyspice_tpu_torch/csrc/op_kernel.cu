// One operating-point Newton solve per Monte-Carlo lane per launch, each
// lane on a segment of W = 4, 8, 16 or 32 lanes of a warp (np1's size
// bucket), in f64.
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
//   if use_seed: x0 = the linear-devices-only estimate (op.go:90-111): each
//     row's leading linear stamps (the row view's linear prefix, ops/
//     run_plan.py linear_prefix) with status gmin 0, no gmin diagonal,
//     solved on the segment; the zero vector if any entry is non-finite;
//   if act: the OP Newton of newton.cuh's seg_newton (junction voltages
//     from x at every iteration, status gmin on the MOSFET drain/source
//     diagonals and on every non-ground diagonal).
//
// OP stamps (ops/assemble.py mode "op", newton.cuh OpStamp): a capacitor
// leaks max(status gmin, gmin floor), an inductor stamps its dt = 1e-9
// companion, sources take their t = 0 values, each magnetic inductor (LM)
// stamps its +1e-3 branch diagonal (pallas_op.py:130-138), a mutual
// coupling nothing.  The lane's dyn row is [status_gmin, use_seed, act,
// vsrc(nV), isrc(nI), lrhs(nL)], as ops/op.py builds it.  An inactive lane
// returns x0 (or the estimate), jv0, 0 iterations and not converged.
// ops/op.py::op_plain is the same arithmetic as torch operations, and the
// build uses -fmad=false.
//
// Bound: operations, a Newton iteration's device evaluations, build and
// solve (chip_smoke.py newton_flops); the bytes are a few rows per lane.
// A lane's Newton is a chain of dependent steps: its segment spreads each
// iteration's device evaluations over its threads, the build over its rows
// and the elimination's divisions and updates over its rows (gj_warp_reg,
// the matrix in registers), keeps the lane's dyn row, x, junction voltages
// and value slots in the segment's slice of shared memory, and leaves the
// card THREADS / W lanes a block (8192 lanes of np1 <= 4: 256 blocks of 4
// warps) to hide one another's latencies.

#include "newton.cuh"

namespace {

using namespace tsr;

// A launch's lanes on segments of W = NMAX threads, THREADS / W lanes a
// block: the table, then each segment's slice (newton.cuh opdc_slice).
// lane_doubles is ops/op.py lane_doubles: the dyn row, then the junction
// voltages and value slots (newton_doubles); a launch that gives fewer
// than the deck's counts need returns x all NaN, jv0, 0 iterations and
// not converged on every lane, and reads and writes no slice.
template <int NMAX, bool PHYS>
__global__ void __launch_bounds__(THREADS, SEG_BLOCKS)
op_seg_kernel(const int* __restrict__ topo_g, int topo_len, int lane_doubles,
              const double* __restrict__ dev,
              const double* __restrict__ dyn_g,
              const double* __restrict__ x0, const double* __restrict__ jv0,
              double* __restrict__ x_out, double* __restrict__ jv_out,
              int* __restrict__ iters_out, int* __restrict__ conv_out,
              int nlanes, double reltol, double abstol, int max_iter,
              double gmin_floor) {
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
  const int* rlin = roff + n + 1;  // each row's linear prefix
  const double* dv = dev + (size_t)row_lane * topo[H_ND];
  const Deck deck(topo, dv);
  const int kj = deck.kj;
  const int dw = 3 + nv_src + ni + nl;
  if (lane_doubles < dw + kj + D_SLOTS * deck.n_d + Q_SLOTS * deck.n_q +
                         M_SLOTS * deck.n_m) {  // a short slice
    if (!real) return;
    if (me < n) x_out[(size_t)lane * n + me] = NAN;
    for (int i = me; i < kj; i += W)
      jv_out[(size_t)lane * kj + i] = jv0[(size_t)lane * kj + i];
    if (me == 0) {
      iters_out[lane] = 0;
      conv_out[lane] = 0;
    }
    return;
  }

  double* sl = seg_smem + (topo_len + 3) / 4 * 2 +
               seg * opdc_slice<NMAX>(lane_doubles);
  double* buf = sl;
  double* row = sl + (NMAX + 2) * (1 + me);
  double* xs = sl + (NMAX + 2) * (NMAX + 1);
  double* dyn = xs + NMAX;
  double* jv = dyn + dw;
  double* nv = jv + kj;
  for (int i = me; i < dw; i += W) dyn[i] = dyn_g[(size_t)row_lane * dw + i];
  if (me < n) xs[me] = x0[(size_t)row_lane * n + me];
  for (int i = me; i < kj; i += W) jv[i] = jv0[(size_t)row_lane * kj + i];
  __syncwarp(mask);
  const double gmin = dyn[0];
  const bool use_seed = dyn[1] > 0.5;
  const bool act = dyn[2] > 0.5;
  const double* vsrc = dyn + 3;
  const double* isrc = vsrc + nv_src;
  const double* lrhs = isrc + ni;
  const double* lval = dv + nr + 2 * nc;

  if (__any_sync(mask, use_seed)) {
    // the linear-devices-only estimate, status gmin 0; a segment without
    // use_seed runs it along and keeps x0
    const double keep = me < n ? xs[me] : 0.0;
    __syncwarp(mask);
    const int e0 = me < n ? roff[me] : 0;
    const int e1 = me < n ? e0 + rlin[me] : 0;
    const bool fin = seg_solve<NMAX, false, false>(
        ent, e0, e1, OpStamp{dv, lval, lrhs, vsrc, isrc,
                             max_nan(0.0, gmin_floor)},
        nullptr, 0.0, n, buf, row, me, xs);
    __syncwarp(mask);
    if (me < n) xs[me] = use_seed ? (fin ? xs[me] : 0.0) : keep;
    __syncwarp(mask);
  }
  bool conv = false;
  const int iters = seg_newton<NMAX, FL_OP, PHYS>(
      deck, ent, roff,
      OpStamp{dv, lval, lrhs, vsrc, isrc, max_nan(gmin, gmin_floor)}, gmin,
      real && act, max_iter, reltol, abstol, buf, row, xs, jv, nv, me,
      &conv);

  if (!real) return;
  if (me < n) x_out[(size_t)lane * n + me] = xs[me];
  for (int i = me; i < kj; i += W) jv_out[(size_t)lane * kj + i] = jv[i];
  if (me == 0) {
    iters_out[lane] = iters;
    conv_out[lane] = conv ? 1 : 0;
  }
}

template <int NMAX, bool PHYS>
cudaError_t launch(const int* topo, int topo_len, int lane_doubles,
                   const double* dev, const double* dyn, const double* x0,
                   const double* jv0, double* x_out, double* jv_out,
                   int* iters, int* conv, int nlanes, double reltol,
                   double abstol, int max_iter, double gmin_floor,
                   cudaStream_t stream) {
  return seg_launch(op_seg_kernel<NMAX, PHYS>,
                    opdc_shape<NMAX>(nlanes, topo_len, lane_doubles), stream,
                    topo, topo_len, lane_doubles, dev, dyn, x0, jv0, x_out,
                    jv_out, iters, conv, nlanes, reltol, abstol, max_iter,
                    gmin_floor);
}

template <bool PHYS>
int launch_np1(int np1, const int* topo, int topo_len, int lane_doubles,
               const double* dev, const double* dyn, const double* x0,
               const double* jv0, double* x_out, double* jv_out, int* iters,
               int* conv, int nlanes, double reltol, double abstol,
               int max_iter, double gmin_floor, cudaStream_t s) {
  switch (seg_bucket(np1)) {
    case 4:
      return launch<4, PHYS>(topo, topo_len, lane_doubles, dev, dyn, x0, jv0,
                             x_out, jv_out, iters, conv, nlanes, reltol,
                             abstol, max_iter, gmin_floor, s);
    case 8:
      return launch<8, PHYS>(topo, topo_len, lane_doubles, dev, dyn, x0, jv0,
                             x_out, jv_out, iters, conv, nlanes, reltol,
                             abstol, max_iter, gmin_floor, s);
    case 16:
      return launch<16, PHYS>(topo, topo_len, lane_doubles, dev, dyn, x0,
                              jv0, x_out, jv_out, iters, conv, nlanes, reltol,
                              abstol, max_iter, gmin_floor, s);
    case 32:
      return launch<32, PHYS>(topo, topo_len, lane_doubles, dev, dyn, x0,
                              jv0, x_out, jv_out, iters, conv, nlanes, reltol,
                              abstol, max_iter, gmin_floor, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch the OP kernel for nlanes lanes on `stream`; returns the
// cudaError_t of the launch (0 on success).  np1 picks the segment width,
// physics the physics instantiation; topo is the whole table, row view
// and linear prefixes included; lane_doubles is ops/op.py lane_doubles.
extern "C" int tsr_op(int np1, const int* topo, int topo_len,
                      int lane_doubles, const double* dev, const double* dyn,
                      const double* x0, const double* jv0, double* x_out,
                      double* jv_out, int* iters, int* conv, int nlanes,
                      double reltol, double abstol, int max_iter,
                      double gmin_floor, int physics, void* stream) {
  if (nlanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (physics)
    return launch_np1<true>(np1, topo, topo_len, lane_doubles, dev, dyn, x0,
                            jv0, x_out, jv_out, iters, conv, nlanes, reltol,
                            abstol, max_iter, gmin_floor, s);
  return launch_np1<false>(np1, topo, topo_len, lane_doubles, dev, dyn, x0,
                           jv0, x_out, jv_out, iters, conv, nlanes, reltol,
                           abstol, max_iter, gmin_floor, s);
}

// The launch shape of the OP and DC sweep kernels for nlanes lanes of np1
// (newton.cuh opdc_shape): out = (W, lanes a block, blocks, threads a
// block, bytes of shared memory a block); returns cudaErrorInvalidValue
// past the caps.
extern "C" int tsr_opdc_seg_shape(int np1, int nlanes, int topo_len,
                                  int lane_doubles, int* out) {
  SegShape s;
  if (!opdc_shape_np1(np1, nlanes, topo_len, lane_doubles, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = s.w;
  out[1] = s.per_block;
  out[2] = s.blocks;
  out[3] = s.threads;
  out[4] = s.shmem;
  return 0;
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
