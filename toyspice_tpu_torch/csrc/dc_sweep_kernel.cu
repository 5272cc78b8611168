// Every point of a DC sweep in one launch, each Monte-Carlo lane on a
// segment of W = 4, 8, 16 or 32 lanes of a warp (np1's size bucket; np1
// 33 to 64 on a whole warp, two rows a thread; past 64 on a whole block,
// dc_block_kernel), in f64.
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
// np1 <= 4: 256 blocks of 4 warps; the 64-row bucket as many of its 4 as
// fit the block's shared memory) to hide one another's latencies.

#include "newton.cuh"

namespace {

using namespace tsr;

// A launch's lanes on segments of W threads (newton.cuh Seg), a block's
// lanes as seg_shape_of sets them: the table (with TSH; else it is read
// in device memory, in the 64-row bucket only), then each segment's slice
// (newton.cuh opdc_slice).
// lane_doubles is ops/dc.py lane_doubles: the dyn row, the point's nV
// source values, then the junction voltages and value slots
// (newton_doubles); a launch that gives fewer than the deck's counts need
// returns x all NaN, 0 iterations and not converged at every point of
// every lane, and reads and writes no slice.
template <int NMAX, bool PHYS, bool TSH>
__global__ void __launch_bounds__(THREADS, SEG_BLOCKS)
dc_seg_kernel(const int* __restrict__ topo_g, int topo_len, int lane_doubles,
              const double* __restrict__ dev,
              const double* __restrict__ dyn_g,
              const double* __restrict__ vs, long long vs_stride, int npts,
              double* __restrict__ x_out, int* __restrict__ iters_out,
              int* __restrict__ conv_out, int nlanes, double reltol,
              double abstol, int max_iter, double gmin_floor) {
  constexpr int W = Seg<NMAX>::W;
  constexpr unsigned mask = 0xffffffffu;
  extern __shared__ __align__(16) double seg_smem[];
  const int* topo = kernel_table<TSH>(topo_g, topo_len, seg_smem);
  const int seg = threadIdx.x / W;
  const int me = threadIdx.x & (W - 1);  // its rows: me + s * W
  const int lane0 =
      blockIdx.x * (NMAX > 32 ? (int)blockDim.x / W : THREADS / W);
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
      for (int i = me; i < n; i += W) x_out[pt * n + i] = NAN;
      if (me == 0) {
        iters_out[pt] = 0;
        conv_out[pt] = 0;
      }
    }
    return;
  }

  double* sl = slice_base<TSH>(seg_smem, topo_len) +
               seg * opdc_slice<NMAX>(lane_doubles);
  double* buf = sl;
  double* rows = sl + (NMAX + 2);
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
    for (int i = me; i < NMAX; i += W) xs[i] = 0.0;
    __syncwarp(mask);
    bool conv = false;
    const int iters = seg_newton<NMAX, FL_DC, PHYS>(
        deck, ent, roff, stamp, 0.0, real, max_iter, reltol, abstol, buf,
        rows, xs, jv, nv, me, &conv);
    if (real) {
      const size_t pt = (size_t)lane * npts + p;
      for (int i = me; i < n; i += W) x_out[pt * n + i] = xs[i];
      if (me == 0) {
        iters_out[pt] = iters;
        conv_out[pt] = conv ? 1 : 0;
      }
    }
  }
}

// The block bucket (np1 past 64, or a lane that overflows the 64-row
// bucket's block): a lane's points on a whole block of BLOCK_THREADS, the
// segment kernel's Newton with the block in place of the segment
// (newton.cuh block_newton in flavour FL_DC: each device on thread j (mod
// T), each row on thread i (mod T), the convergence a block-wide AND, the
// system eliminated by gj_block in the block's slice).  The lane's system,
// x, the last iterate and its lane_doubles live in the block's slice
// (newton.cuh block_slice): shared memory while it fits (newton.cuh
// block_place), else a slice of `work` in device memory (block k takes
// slice k and lanes k, k + gridDim.x, ...; work is null otherwise).
template <bool PHYS, bool TSH>
__global__ void __launch_bounds__(BLOCK_THREADS, BLOCK_MIN_BLOCKS)
dc_block_kernel(const int* __restrict__ topo_g, int topo_len,
                int lane_doubles, const double* __restrict__ dev,
                const double* __restrict__ dyn_g,
                const double* __restrict__ vs, long long vs_stride, int npts,
                double* __restrict__ x_out, int* __restrict__ iters_out,
                int* __restrict__ conv_out, int nlanes, double reltol,
                double abstol, int max_iter, double gmin_floor,
                double* work) {
  constexpr int T = BLOCK_THREADS;
  extern __shared__ __align__(16) double seg_smem[];
  const int* topo = kernel_table<TSH>(topo_g, topo_len, seg_smem);
  const int me = threadIdx.x;
  const int n = topo[H_NP1];
  const int nr = topo[H_NR], nc = topo[H_NC], nl = topo[H_NL];
  const int nv_src = topo[H_NV], ni = topo[H_NI];
  const int4* ent = reinterpret_cast<const int4*>(topo + topo[H_ROWS]);
  const int* roff = topo + topo[H_ROWS] + 4 * topo[H_NE];
  const int dw = ni + nl;
  double* const m =
      work ? work + (size_t)blockIdx.x * block_slice(n, lane_doubles)
           : slice_base<TSH>(seg_smem, topo_len);
  double* const xs = m + gj_slice_doubles(n);
  double* const xo = xs + ((n + 1) & ~1);
  double* const dyn = xo + ((n + 1) & ~1);
  double* const sv = dyn + dw;
  double* const jv = sv + nv_src;

  for (int lane = blockIdx.x; lane < nlanes; lane += gridDim.x) {
    __syncthreads();  // the last lane's reads of the slice are done
    const double* dv = dev + (size_t)lane * topo[H_ND];
    const Deck deck(topo, dv);
    const int kj = deck.kj;
    if (lane_doubles < dw + nv_src + kj + D_SLOTS * deck.n_d +
                           Q_SLOTS * deck.n_q + M_SLOTS * deck.n_m) {
      for (int p = 0; p < npts; ++p) {  // a short slice
        const size_t pt = (size_t)lane * npts + p;
        for (int i = me; i < n; i += T) x_out[pt * n + i] = NAN;
        if (me == 0) {
          iters_out[pt] = 0;
          conv_out[pt] = 0;
        }
      }
      continue;
    }
    double* const nv = jv + kj;
    for (int i = me; i < dw; i += T) dyn[i] = dyn_g[(size_t)lane * dw + i];
    for (int i = me; i < kj; i += T) jv[i] = 0.0;
    const double* vlane = vs + (size_t)lane * vs_stride;
    // status gmin 0: the capacitor leak is the floor
    const OpStamp stamp{dv, dv + nr + 2 * nc, dyn + ni, sv, dyn,
                        max_nan(0.0, gmin_floor)};
    for (int p = 0; p < npts; ++p) {
      for (int s = me; s < nv_src; s += T)
        sv[s] = vlane[(size_t)p * nv_src + s];
      for (int i = me; i < n; i += T) xs[i] = 0.0;
      __syncthreads();
      bool conv = false;
      const int iters = block_newton<FL_DC, PHYS>(
          deck, ent, roff, stamp, 0.0, true, max_iter, reltol, abstol, 0.0,
          Phys{}, m, xs, xo, jv, nv, &conv);
      const size_t pt = (size_t)lane * npts + p;
      for (int i = me; i < n; i += T) x_out[pt * n + i] = xs[i];
      if (me == 0) {
        iters_out[pt] = iters;
        conv_out[pt] = conv ? 1 : 0;
      }
      __syncthreads();  // x is read out before the next point clears it
    }
  }
}

template <int NMAX, bool PHYS>
cudaError_t launch(int np1, const int* topo, int topo_len, int lane_doubles,
                   const double* dev, const double* dyn, const double* vs,
                   long long vs_stride, int npts, double* x_out, int* iters,
                   int* conv, int nlanes, double reltol, double abstol,
                   int max_iter, double gmin_floor, double* work,
                   long long work_len, cudaStream_t stream) {
  const SegShape sh =
      opdc_shape_in(NMAX, np1, nlanes, topo_len, lane_doubles);
  // the instantiation that keeps the table where the shape does (np1's
  // buckets of 4 to 32 rows only in shared memory)
  auto go = [&](auto tsh) -> cudaError_t {
    constexpr bool T = decltype(tsh)::value;
    if constexpr (NMAX == BLOCK_BUCKET)
      return block_launch(dc_block_kernel<PHYS, T>, sh, work, work_len,
                          stream, topo, topo_len, lane_doubles, dev, dyn,
                          vs, vs_stride, npts, x_out, iters, conv, nlanes,
                          reltol, abstol, max_iter, gmin_floor);
    else
      return seg_launch(dc_seg_kernel<NMAX, PHYS, T>, sh, stream, topo,
                        topo_len, lane_doubles, dev, dyn, vs, vs_stride,
                        npts, x_out, iters, conv, nlanes, reltol, abstol,
                        max_iter, gmin_floor);
  };
  if (sh.table) return go(std::true_type());
  if constexpr (NMAX >= 64) return go(std::false_type());
  return cudaErrorInvalidValue;
}

template <bool PHYS>
int launch_np1(int np1, const int* topo, int topo_len, int lane_doubles,
               const double* dev, const double* dyn, const double* vs,
               long long vs_stride, int npts, double* x_out, int* iters,
               int* conv, int nlanes, double reltol, double abstol,
               int max_iter, double gmin_floor, double* work,
               long long work_len, cudaStream_t s) {
  return with_bucket(opdc_bucket(np1, topo_len, lane_doubles), [&](auto b) {
    return launch<decltype(b)::value, PHYS>(
        np1, topo, topo_len, lane_doubles, dev, dyn, vs, vs_stride, npts,
        x_out, iters, conv, nlanes, reltol, abstol, max_iter, gmin_floor,
        work, work_len, s);
  });
}

}  // namespace

// Launch the DC sweep kernel for nlanes lanes of npts points on `stream`;
// returns the cudaError_t of the launch (0 on success).  np1 picks the
// segment width, physics the physics instantiation; topo is the whole
// table, row view included; lane_doubles is ops/dc.py lane_doubles;
// vs_stride is the lane stride of the source table (0 when every lane
// shares one); work holds work_len doubles, the block bucket's slices that
// do not fit shared memory (ops/run.py block_work; not read otherwise).
extern "C" int tsr_dc_sweep(int np1, const int* topo, int topo_len,
                            int lane_doubles, const double* dev,
                            const double* dyn, const double* vs,
                            long long vs_stride, int npts, double* x_out,
                            int* iters, int* conv, int nlanes, double reltol,
                            double abstol, int max_iter, double gmin_floor,
                            int physics, double* work, long long work_len,
                            void* stream) {
  if (nlanes <= 0 || npts <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (physics)
    return launch_np1<true>(np1, topo, topo_len, lane_doubles, dev, dyn, vs,
                            vs_stride, npts, x_out, iters, conv, nlanes,
                            reltol, abstol, max_iter, gmin_floor, work,
                            work_len, s);
  return launch_np1<false>(np1, topo, topo_len, lane_doubles, dev, dyn, vs,
                           vs_stride, npts, x_out, iters, conv, nlanes,
                           reltol, abstol, max_iter, gmin_floor, work,
                           work_len, s);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
