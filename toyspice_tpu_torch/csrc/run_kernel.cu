// The compat instantiations of the whole-run kernel (csrc/run_kernel.cuh):
// linear, magnetic (LM and K) and Newton; without the waveform store, or
// with it when built with -DTSR_STORE (ops/_build.py builds both, as two
// libraries whose nvcc calls run side by side).
//
// Replaces the TPU kernels toyspice_tpu/ops/pallas_run.py::_run_kernel
// (launched at pallas_run.py:811) and, with the store,
// toyspice_tpu/ops/pallas_tran.py::_fused_kernel (:1429, launched at
// :2252), compat subset; run_kernel.cuh says how.

#include "run_kernel.cuh"

namespace {

using namespace tsr;

// the Newton instantiation, or a linear one with or without the magnetic
// stamps (a deck with LM or K has no diode, BJT or MOSFET)
template <int NMAX, bool STORE>
cudaError_t launch_kind(const RunArgs& a, int nonlinear, int mag,
                        cudaStream_t s) {
  if (nonlinear) return launch<NMAX, true, false, STORE, false>(a, s);
  if (mag) return launch<NMAX, false, true, STORE, false>(a, s);
  return launch<NMAX, false, false, STORE, false>(a, s);
}

#ifdef TSR_STORE
constexpr bool STORE_BUILD = true;
#else
constexpr bool STORE_BUILD = false;
#endif
// the buckets this library holds: with -DTSR_WIDE the 64-row bucket and
// the block bucket (a library of their own, whose nvcc call runs beside
// this one's)
#ifdef TSR_WIDE
constexpr int MIN_BUCKET = 64, MAX_BUCKET = BLOCK_BUCKET;
#else
constexpr int MIN_BUCKET = 4, MAX_BUCKET = 32;
#endif

// compat without trap; LM or K with a Newton is run_kernel_mag.cu's
template <bool STORE>
int launch_np1(const RunArgs& a, int np1, int nonlinear, int mag,
               int physics, void* stream) {
  if (physics || a.trap || (nonlinear && mag))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.nlanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_bucket<MIN_BUCKET, MAX_BUCKET>(
      run_bucket(np1, a.topo_len, a.lane_doubles), [&](auto b) {
        return launch_kind<decltype(b)::value, STORE>(a, nonlinear, mag, s);
      });
}

}  // namespace

#ifndef TSR_STORE
// Launch the whole-run kernel for nlanes lanes on `stream` from t = 0;
// returns the cudaError_t of the launch (0 on success).  np1 picks the
// matrix size, nonlinear the Newton instantiation, mag the magnetic
// stamps, physics the physics semantics and trap != 0 its trapezoidal
// companions (every run-kernel library has this entry point; this one
// holds compat, and refuses physics, trap and LM/K with a Newton).  topo
// is the whole table, row view included; lane_doubles the doubles a lane
// keeps beside its system (ops/run.py run_doubles: its source values, an
// even count, then a Newton deck's junction voltages and value slots),
// which size its segments' slices; work holds work_len doubles, the block
// bucket's slices that do not fit shared memory (ops/run.py block_work;
// not read otherwise).  state and jv are updated in place; t, dt and att
// are written.
extern "C" int tsr_run(int np1, int nonlinear, int mag, int physics,
                       int trap, const int* topo, int topo_len,
                       int lane_doubles, const double* dev,
                       const double* rc,
                       double* state, double* jv, double* t, double* dt,
                       int* acc, int* att, int* fail, int* nri, int nlanes,
                       double tstop, double minstep, double tmax,
                       double trtol, int max_attempts, double reltol,
                       double abstol, int max_iter, double* work,
                       long long work_len, void* stream) {
  RunArgs a{topo,    topo_len, lane_doubles, dev,     rc,      state,
            jv,      t,        dt,         acc,     att,     fail,
            nri,     nlanes,   tstop,      minstep, tmax,    trtol,
            max_attempts,      reltol,     abstol,  max_iter, 0.0,
            0,       0,        nullptr,    nullptr, nullptr, nullptr,
            trap};
  a.np1 = np1;
  a.work = work;
  a.work_len = work_len;
  return launch_np1<STORE_BUILD>(a, np1, nonlinear, mag, physics, stream);
}
#else

// The same with the waveform store, from each lane's t, dt and att: out_x
// (nlanes, max_store, np1) and out_t (nlanes, max_store), zeroed by the
// caller; out_n and overflow (nlanes) are written.  stream != 0 pauses a
// lane whose block is full.
extern "C" int tsr_run_store(
    int np1, int nonlinear, int mag, int physics, int trap, const int* topo,
    int topo_len, int lane_doubles,
    const double* dev, const double* rc, double* state, double* jv,
    double* t, double* dt, int* acc, int* att, int* fail, int* nri,
    int nlanes, double tstop, double minstep, double tmax, double trtol,
    int max_attempts, double reltol, double abstol, int max_iter,
    double tstart, int max_store, int stream, double* out_x, double* out_t,
    int* out_n, int* overflow, double* work, long long work_len,
    void* cuda_stream) {
  RunArgs a{topo,    topo_len, lane_doubles, dev,     rc,      state,
            jv,      t,        dt,         acc,     att,     fail,
            nri,     nlanes,   tstop,      minstep, tmax,    trtol,
            max_attempts,      reltol,     abstol,  max_iter, tstart,
            max_store, stream, out_x,      out_t,   out_n,   overflow,
            trap};
  a.np1 = np1;
  a.work = work;
  a.work_len = work_len;
  return launch_np1<STORE_BUILD>(a, np1, nonlinear, mag, physics,
                                 cuda_stream);
}
#endif

// The launch shape of a deck of np1 unknowns over nlanes lanes with a
// table of topo_len words and lane_doubles a lane (ops/run.py
// run_doubles), as the entries above compute it: out = {W, lanes a block,
// blocks, threads a block, bytes of shared memory, doubles of a block's
// slice in device memory (0 when the slices fit shared memory; the block
// bucket's grid is then bounded by the workspace), 1 when the table is in
// shared memory (0: read in device memory)}; returns
// cudaErrorInvalidValue for np1 < 1.
extern "C" int tsr_run_seg_shape(int np1, int nlanes, int topo_len,
                                 int lane_doubles, int* out) {
  SegShape s;
  if (!seg_shape_np1(np1, nlanes, topo_len, lane_doubles, &s))
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

// The bucket (newton.cuh seg_bucket, or BLOCK_BUCKET) a launch of np1
// unknowns with a table of topo_len words and lane_doubles a lane takes
// (newton.cuh fit_bucket): 64 and BLOCK_BUCKET are the -DTSR_WIDE
// library's, ops/run.py run_bucket says the same.
extern "C" int tsr_run_bucket(int np1, int topo_len, int lane_doubles) {
  return run_bucket(np1, topo_len, lane_doubles);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
