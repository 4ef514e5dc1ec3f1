// The lane engine on the card: one CUDA thread per lane, each walking its
// lane's chunk of requests through lane_engine.cuh's step (the serial
// form of the reference's XLA lane engine, core/fastsim_jax.py:138 and
// :364). One launch advances every lane by one chunk; the state stays on
// the device between launches. See lane_engine.cuh for the semantics and
// for what bounds a lane.
//
// Blocks of one thread: the scheduler spreads the R lanes over the SMs,
// so each lane has an SM's L1 to itself (a Table I lane's 80 KB of state
// fits in it).
#include <cuda_runtime.h>

#include "lane_engine.cuh"

namespace {

__global__ void __launch_bounds__(1) lane_engine_kernel(const lane_engine::Args a) {
  const int r = blockIdx.x;
  if (r < a.R) lane_engine::lane_run(a, r);
}

}  // namespace

// Load the kernel's module without launching it (asking for the kernel's
// attributes loads a lazily loaded module). Returns the cudaError_t.
extern "C" int repro_lane_engine_load() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, lane_engine_kernel));
}

// Advance R lanes by one chunk of m requests each. Returns the launch's
// cudaError_t.
extern "C" int repro_lane_engine(const uint64_t* fields, const int32_t* P, const int32_t* O,
                                 const int32_t* lengths, const int32_t* share, int R, int J,
                                 int N, int m, int idx0, int B, int warmup, int ripple_from,
                                 int ghost, void* stream) {
  if (R < 1 || J < 1 || N < 1 || m < 0) return cudaErrorInvalidValue;
  const lane_engine::Args a = lane_engine::make_args(fields, P, O, lengths, share, R, J, N, m,
                                                     idx0, B, warmup, ripple_from, ghost);
  lane_engine_kernel<<<R, 1, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
