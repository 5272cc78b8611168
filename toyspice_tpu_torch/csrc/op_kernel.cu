// One operating-point Newton solve per Monte-Carlo lane per launch, each
// lane on a segment of W = 4, 8, 16 or 32 lanes of a warp (np1's size
// bucket; np1 33 to 64 on a whole warp, two rows a thread; past 64 on a
// whole block, op_block_kernel), in f64.
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
// the matrix in registers; in the 64-row bucket gj_warp_smem, the matrix
// in the slice), keeps the lane's dyn row, x, junction voltages and value
// slots in the segment's slice of shared memory, and leaves the card
// THREADS / W lanes a block (8192 lanes of np1 <= 4: 256 blocks of 4
// warps; the 64-row bucket as many of its 4 as fit the block's shared
// memory, newton.cuh seg_shape_of) to hide one another's latencies.

#include "newton.cuh"

namespace {

using namespace tsr;

// A launch's lanes on segments of W threads (newton.cuh Seg), a block's
// lanes as seg_shape_of sets them: the table (with TSH; else it is read
// in device memory, in the 64-row bucket only), then each segment's slice
// (newton.cuh opdc_slice).
// lane_doubles is ops/op.py lane_doubles: the dyn row, then the junction
// voltages and value slots (newton_doubles); a launch that gives fewer
// than the deck's counts need returns x all NaN, jv0, 0 iterations and
// not converged on every lane, and reads and writes no slice.
template <int NMAX, bool PHYS, bool TSH>
__global__ void __launch_bounds__(THREADS, SEG_BLOCKS)
op_seg_kernel(const int* __restrict__ topo_g, int topo_len, int lane_doubles,
              const double* __restrict__ dev,
              const double* __restrict__ dyn_g,
              const double* __restrict__ x0, const double* __restrict__ jv0,
              double* __restrict__ x_out, double* __restrict__ jv_out,
              int* __restrict__ iters_out, int* __restrict__ conv_out,
              int nlanes, double reltol, double abstol, int max_iter,
              double gmin_floor) {
  constexpr int W = Seg<NMAX>::W, R = Seg<NMAX>::R;
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
  const int* rlin = roff + n + 1;  // each row's linear prefix
  const double* dv = dev + (size_t)row_lane * topo[H_ND];
  const Deck deck(topo, dv);
  const int kj = deck.kj;
  const int dw = 3 + nv_src + ni + nl;
  if (lane_doubles < dw + kj + D_SLOTS * deck.n_d + Q_SLOTS * deck.n_q +
                         M_SLOTS * deck.n_m) {  // a short slice
    if (!real) return;
    for (int i = me; i < n; i += W) x_out[(size_t)lane * n + i] = NAN;
    for (int i = me; i < kj; i += W)
      jv_out[(size_t)lane * kj + i] = jv0[(size_t)lane * kj + i];
    if (me == 0) {
      iters_out[lane] = 0;
      conv_out[lane] = 0;
    }
    return;
  }

  double* sl = slice_base<TSH>(seg_smem, topo_len) +
               seg * opdc_slice<NMAX>(lane_doubles);
  double* buf = sl;
  double* rows = sl + (NMAX + 2);
  double* xs = sl + (NMAX + 2) * (NMAX + 1);
  double* dyn = xs + NMAX;
  double* jv = dyn + dw;
  double* nv = jv + kj;
  for (int i = me; i < dw; i += W) dyn[i] = dyn_g[(size_t)row_lane * dw + i];
  for (int i = me; i < n; i += W) xs[i] = x0[(size_t)row_lane * n + i];
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
    double keep[R];
#pragma unroll
    for (int s = 0; s < R; ++s)
      keep[s] = me + s * W < n ? xs[me + s * W] : 0.0;
    __syncwarp(mask);
    int e0[R], e1[R];
    seg_ranges<NMAX>(roff, rlin, n, me, e0, e1);
    const bool fin = seg_solve<NMAX, false, false>(
        ent, e0, e1, OpStamp{dv, lval, lrhs, vsrc, isrc,
                             max_nan(0.0, gmin_floor)},
        nullptr, 0.0, n, buf, rows, me, xs);
    __syncwarp(mask);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int i = me + s * W;
      if (i < n) xs[i] = use_seed ? (fin ? xs[i] : 0.0) : keep[s];
    }
    __syncwarp(mask);
  }
  bool conv = false;
  const int iters = seg_newton<NMAX, FL_OP, PHYS>(
      deck, ent, roff,
      OpStamp{dv, lval, lrhs, vsrc, isrc, max_nan(gmin, gmin_floor)}, gmin,
      real && act, max_iter, reltol, abstol, buf, rows, xs, jv, nv, me,
      &conv);

  if (!real) return;
  for (int i = me; i < n; i += W) x_out[(size_t)lane * n + i] = xs[i];
  for (int i = me; i < kj; i += W) jv_out[(size_t)lane * kj + i] = jv[i];
  if (me == 0) {
    iters_out[lane] = iters;
    conv_out[lane] = conv ? 1 : 0;
  }
}

// The block bucket (np1 past 64, or a lane that overflows the 64-row
// bucket's block): a lane on a whole block of BLOCK_THREADS, the segment
// kernel's solve with the block in place of the segment (newton.cuh
// block_solve and block_newton: each device on thread j (mod T), each row
// on thread i (mod T), the convergence a block-wide AND, the system
// eliminated by gj_block in the block's slice).  The lane's system, x, the
// last iterate and its lane_doubles live in the block's slice
// (newton.cuh block_slice): shared memory while it fits (newton.cuh
// block_place), else a slice of `work` in device memory (block k takes
// slice k and lanes k, k + gridDim.x, ...; work is null otherwise).
template <bool PHYS, bool TSH>
__global__ void __launch_bounds__(BLOCK_THREADS, BLOCK_MIN_BLOCKS)
op_block_kernel(const int* __restrict__ topo_g, int topo_len,
                int lane_doubles, const double* __restrict__ dev,
                const double* __restrict__ dyn_g,
                const double* __restrict__ x0,
                const double* __restrict__ jv0, double* __restrict__ x_out,
                double* __restrict__ jv_out, int* __restrict__ iters_out,
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
  const int* rlin = roff + n + 1;  // each row's linear prefix
  const int dw = 3 + nv_src + ni + nl;
  double* const m =
      work ? work + (size_t)blockIdx.x * block_slice(n, lane_doubles)
           : slice_base<TSH>(seg_smem, topo_len);
  double* const xs = m + gj_slice_doubles(n);
  double* const xo = xs + ((n + 1) & ~1);
  double* const dyn = xo + ((n + 1) & ~1);
  double* const jv = dyn + dw;

  for (int lane = blockIdx.x; lane < nlanes; lane += gridDim.x) {
    __syncthreads();  // the last lane's reads of the slice are done
    const double* dv = dev + (size_t)lane * topo[H_ND];
    const Deck deck(topo, dv);
    const int kj = deck.kj;
    if (lane_doubles < dw + kj + D_SLOTS * deck.n_d + Q_SLOTS * deck.n_q +
                           M_SLOTS * deck.n_m) {  // a short slice
      for (int i = me; i < n; i += T) x_out[(size_t)lane * n + i] = NAN;
      for (int i = me; i < kj; i += T)
        jv_out[(size_t)lane * kj + i] = jv0[(size_t)lane * kj + i];
      if (me == 0) {
        iters_out[lane] = 0;
        conv_out[lane] = 0;
      }
      continue;
    }
    double* const nv = jv + kj;
    for (int i = me; i < dw; i += T) dyn[i] = dyn_g[(size_t)lane * dw + i];
    for (int i = me; i < n; i += T) xs[i] = x0[(size_t)lane * n + i];
    for (int i = me; i < kj; i += T) jv[i] = jv0[(size_t)lane * kj + i];
    __syncthreads();
    const double gmin = dyn[0];
    const bool use_seed = dyn[1] > 0.5;
    const bool act = dyn[2] > 0.5;
    const double* vsrc = dyn + 3;
    const double* isrc = vsrc + nv_src;
    const double* lrhs = isrc + ni;
    const double* lval = dv + nr + 2 * nc;
    if (use_seed) {  // the linear-devices-only estimate, status gmin 0
      const bool fin = block_solve<false, false>(
          ent, roff, rlin,
          OpStamp{dv, lval, lrhs, vsrc, isrc, max_nan(0.0, gmin_floor)},
          nullptr, 0.0, n, m, xs);
      for (int i = me; i < n; i += T) xs[i] = fin ? xs[i] : 0.0;
      __syncthreads();
    }
    bool conv = false;
    const int iters = block_newton<FL_OP, PHYS>(
        deck, ent, roff,
        OpStamp{dv, lval, lrhs, vsrc, isrc, max_nan(gmin, gmin_floor)}, gmin,
        act, max_iter, reltol, abstol, 0.0, Phys{}, m, xs, xo, jv, nv,
        &conv);
    for (int i = me; i < n; i += T) x_out[(size_t)lane * n + i] = xs[i];
    for (int i = me; i < kj; i += T) jv_out[(size_t)lane * kj + i] = jv[i];
    if (me == 0) {
      iters_out[lane] = iters;
      conv_out[lane] = conv ? 1 : 0;
    }
  }
}

template <int NMAX, bool PHYS>
cudaError_t launch(int np1, const int* topo, int topo_len, int lane_doubles,
                   const double* dev, const double* dyn, const double* x0,
                   const double* jv0, double* x_out, double* jv_out,
                   int* iters, int* conv, int nlanes, double reltol,
                   double abstol, int max_iter, double gmin_floor,
                   double* work, long long work_len, cudaStream_t stream) {
  const SegShape sh =
      opdc_shape_in(NMAX, np1, nlanes, topo_len, lane_doubles);
  // the instantiation that keeps the table where the shape does (np1's
  // buckets of 4 to 32 rows only in shared memory)
  auto go = [&](auto tsh) -> cudaError_t {
    constexpr bool T = decltype(tsh)::value;
    if constexpr (NMAX == BLOCK_BUCKET)
      return block_launch(op_block_kernel<PHYS, T>, sh, work, work_len,
                          stream, topo, topo_len, lane_doubles, dev, dyn,
                          x0, jv0, x_out, jv_out, iters, conv, nlanes,
                          reltol, abstol, max_iter, gmin_floor);
    else
      return seg_launch(op_seg_kernel<NMAX, PHYS, T>, sh, stream, topo,
                        topo_len, lane_doubles, dev, dyn, x0, jv0, x_out,
                        jv_out, iters, conv, nlanes, reltol, abstol,
                        max_iter, gmin_floor);
  };
  if (sh.table) return go(std::true_type());
  if constexpr (NMAX >= 64) return go(std::false_type());
  return cudaErrorInvalidValue;
}

template <bool PHYS>
int launch_np1(int np1, const int* topo, int topo_len, int lane_doubles,
               const double* dev, const double* dyn, const double* x0,
               const double* jv0, double* x_out, double* jv_out, int* iters,
               int* conv, int nlanes, double reltol, double abstol,
               int max_iter, double gmin_floor, double* work,
               long long work_len, cudaStream_t s) {
  return with_bucket(opdc_bucket(np1, topo_len, lane_doubles), [&](auto b) {
    return launch<decltype(b)::value, PHYS>(
        np1, topo, topo_len, lane_doubles, dev, dyn, x0, jv0, x_out, jv_out,
        iters, conv, nlanes, reltol, abstol, max_iter, gmin_floor, work,
        work_len, s);
  });
}

}  // namespace

// Launch the OP kernel for nlanes lanes on `stream`; returns the
// cudaError_t of the launch (0 on success).  np1 picks the segment width
// (past 64 a block a lane), physics the physics instantiation; topo is the
// whole table, row view and linear prefixes included; lane_doubles is
// ops/op.py lane_doubles; work holds work_len doubles, the block bucket's
// slices that do not fit shared memory (ops/run.py block_work; not read
// otherwise).
extern "C" int tsr_op(int np1, const int* topo, int topo_len,
                      int lane_doubles, const double* dev, const double* dyn,
                      const double* x0, const double* jv0, double* x_out,
                      double* jv_out, int* iters, int* conv, int nlanes,
                      double reltol, double abstol, int max_iter,
                      double gmin_floor, int physics, double* work,
                      long long work_len, void* stream) {
  if (nlanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (physics)
    return launch_np1<true>(np1, topo, topo_len, lane_doubles, dev, dyn, x0,
                            jv0, x_out, jv_out, iters, conv, nlanes, reltol,
                            abstol, max_iter, gmin_floor, work, work_len, s);
  return launch_np1<false>(np1, topo, topo_len, lane_doubles, dev, dyn, x0,
                           jv0, x_out, jv_out, iters, conv, nlanes, reltol,
                           abstol, max_iter, gmin_floor, work, work_len, s);
}

// The launch shape of the OP and DC sweep kernels for nlanes lanes of np1
// (newton.cuh opdc_shape_in): out = (W, lanes a block, blocks, threads a
// block, bytes of shared memory a block, doubles of a block's slice in
// device memory: 0 when the slices fit shared memory, 1 when the table is
// in shared memory: 0 when it is read in device memory); returns
// cudaErrorInvalidValue for np1 < 1.
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
  out[5] = s.work;
  out[6] = s.table;
  return 0;
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
