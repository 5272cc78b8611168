// The magnetic instantiations of the whole-run kernel
// (csrc/run_kernel.cuh) that the two other sources do not hold: physics
// semantics, BE or trapezoidal, with magnetic inductors (LM) and mutual
// couplings (K), linear and Newton (PHYS MAG); and compat LM and K
// together with diodes, BJTs or MOSFETs (compat MAG NL).  Built without
// the waveform store, or with it when built with -DTSR_STORE (ops/_build.py
// builds both, beside run_kernel.cu and run_kernel_phys.cu).
//
// Replaces the physics magnetics of the TPU kernels
// toyspice_tpu/ops/pallas_run.py::_run_kernel (:652, launched at :811):
// the live Jiles-Atherton commit (pallas_run.py:478-583, engine/state.py
// make_commit) and the physics mutual (pallas_run.py:433-469); and with
// the store toyspice_tpu/ops/pallas_tran.py::_fused_kernel (:1429,
// launched at :2252).  run_kernel.cuh says how: an accepted step sums each
// core's mmf (turns x current over its windings, in winding order), clips
// H = mmf/len to +-1e6 and runs one J-A step of every winding's core copy
// (ja_step) with the commit's fixed 300.15 K Ms; each attempt stamps the
// incremental L and M = k sqrt(La Lb) of the committed cores (MagPhys).
//
// Bound: operations, as the other instantiations; the J-A step adds a
// tanh and a few dozen f64 operations per winding and accepted step
// (chip_smoke.py ja_flops).

#include "run_kernel.cuh"

namespace {

using namespace tsr;

// the Newton or the linear instantiation, physics or compat (compat's
// linear MAG instantiation lives in run_kernel.cu)
template <int NMAX, bool STORE>
cudaError_t launch_kind(const RunArgs& a, int nonlinear, int physics,
                        cudaStream_t s) {
  if (!physics) return launch<NMAX, true, true, STORE, false>(a, s);
  if (nonlinear) return launch<NMAX, true, true, STORE, true>(a, s);
  return launch<NMAX, false, true, STORE, true>(a, s);
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

// LM or K under physics, or compat with a Newton (compat has no trap)
template <bool STORE>
int launch_np1(const RunArgs& a, int np1, int nonlinear, int mag,
               int physics, void* stream) {
  if (!mag || !(physics || nonlinear) || (!physics && a.trap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.nlanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_bucket<MIN_BUCKET, MAX_BUCKET>(
      run_bucket(np1, a.topo_len, a.lane_doubles), [&](auto b) {
        return launch_kind<decltype(b)::value, STORE>(a, nonlinear,
                                                      physics, s);
      });
}

}  // namespace

#ifndef TSR_STORE
// Launch the magnetic whole-run kernel for nlanes lanes on `stream` from
// t = 0; returns the cudaError_t of the launch (0 on success).  The
// arguments are tsr_run's (csrc/run_kernel.cu); this library holds LM or K
// under physics, and under compat with a Newton.
extern "C" int tsr_run_mag(int np1, int nonlinear, int mag, int physics,
                           int trap, const int* topo, int topo_len,
                           int lane_doubles, const double* dev,
                           const double* rc,
                           double* state, double* jv, double* t, double* dt,
                           int* acc, int* att, int* fail, int* nri,
                           int nlanes, double tstop, double minstep,
                           double tmax, double trtol, int max_attempts,
                           double reltol, double abstol, int max_iter,
                           double* work, long long work_len, void* stream) {
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

// The same with the waveform store, from each lane's t, dt and att (the
// arguments of tsr_run_store in csrc/run_kernel.cu).
extern "C" int tsr_run_mag_store(
    int np1, int nonlinear, int mag, int physics, int trap, const int* topo,
    int topo_len, int lane_doubles, const double* dev, const double* rc,
    double* state, double* jv, double* t, double* dt, int* acc, int* att,
    int* fail, int* nri, int nlanes, double tstop, double minstep,
    double tmax, double trtol, int max_attempts, double reltol,
    double abstol, int max_iter, double tstart, int max_store, int stream,
    double* out_x, double* out_t, int* out_n, int* overflow,
    double* work, long long work_len, void* cuda_stream) {
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

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
