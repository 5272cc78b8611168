// The PHYS instantiations of the whole-run kernel (csrc/run_kernel.cuh):
// physics semantics, BE or trapezoidal, for decks of R, C, L, V, I, D, Q
// and M, linear and Newton; without the waveform store, or with it when
// built with -DTSR_STORE (ops/_build.py builds both).
//
// Replaces the physics subset (modes phys_be and phys_trap) of the TPU
// kernels toyspice_tpu/ops/pallas_run.py::_run_kernel (:652, launched at
// :811) and toyspice_tpu/ops/pallas_tran.py::_fused_kernel (:1429,
// launched at :2252) for decks without LM or K; run_kernel.cuh says how.

#include "run_kernel.cuh"

namespace {

using namespace tsr;

// the Newton instantiation or the linear one
template <int NMAX, bool STORE>
cudaError_t launch_kind(const RunArgs& a, int nonlinear, cudaStream_t s) {
  if (nonlinear) return launch<NMAX, true, false, STORE, true>(a, s);
  return launch<NMAX, false, false, STORE, true>(a, s);
}

#ifdef TSR_STORE
constexpr bool STORE_BUILD = true;
#else
constexpr bool STORE_BUILD = false;
#endif

// physics without LM or K (run_kernel_mag.cu holds those)
template <bool STORE>
int launch_np1(const RunArgs& a, int np1, int nonlinear, int mag,
               int physics, void* stream) {
  if (!physics || mag) return static_cast<int>(cudaErrorInvalidValue);
  if (a.nlanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg_bucket(np1)) {
    case 4: return launch_kind<4, STORE>(a, nonlinear, s);
    case 8: return launch_kind<8, STORE>(a, nonlinear, s);
    case 16: return launch_kind<16, STORE>(a, nonlinear, s);
    case 32: return launch_kind<32, STORE>(a, nonlinear, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#ifndef TSR_STORE
// Launch the physics whole-run kernel for nlanes lanes on `stream` from
// t = 0; returns the cudaError_t of the launch (0 on success).  The
// arguments are tsr_run's (csrc/run_kernel.cu); this library holds physics
// without LM or K.  state (with the physics rows) and jv are updated in
// place; t, dt and att are written.
extern "C" int tsr_run_phys(int np1, int nonlinear, int mag, int physics,
                            int trap, const int* topo, int topo_len,
                            int nl_doubles, const double* dev,
                            const double* rc,
                            double* state, double* jv, double* t,
                            double* dt, int* acc, int* att, int* fail,
                            int* nri, int nlanes, double tstop,
                            double minstep, double tmax, double trtol,
                            int max_attempts, double reltol, double abstol,
                            int max_iter, void* stream) {
  const RunArgs a{topo,    topo_len, nl_doubles, dev,     rc,      state,
                  jv,      t,        dt,         acc,     att,     fail,
                  nri,     nlanes,   tstop,      minstep, tmax,    trtol,
                  max_attempts,      reltol,     abstol,  max_iter, 0.0,
                  0,       0,        nullptr,    nullptr, nullptr, nullptr,
                  trap};
  return launch_np1<STORE_BUILD>(a, np1, nonlinear, mag, physics, stream);
}
#else

// The same with the waveform store, from each lane's t, dt and att (the
// arguments of tsr_run_store in csrc/run_kernel.cu).
extern "C" int tsr_run_phys_store(
    int np1, int nonlinear, int mag, int physics, int trap, const int* topo,
    int topo_len, int nl_doubles,
    const double* dev, const double* rc, double* state, double* jv,
    double* t, double* dt, int* acc, int* att, int* fail, int* nri,
    int nlanes, double tstop, double minstep, double tmax, double trtol,
    int max_attempts, double reltol, double abstol, int max_iter,
    double tstart, int max_store, int stream, double* out_x, double* out_t,
    int* out_n, int* overflow, void* cuda_stream) {
  const RunArgs a{topo,    topo_len, nl_doubles, dev,     rc,      state,
                  jv,      t,        dt,         acc,     att,     fail,
                  nri,     nlanes,   tstop,      minstep, tmax,    trtol,
                  max_attempts,      reltol,     abstol,  max_iter, tstart,
                  max_store, stream, out_x,      out_t,   out_n,   overflow,
                  trap};
  return launch_np1<STORE_BUILD>(a, np1, nonlinear, mag, physics,
                                 cuda_stream);
}
#endif

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
