// The lane engine's plain version: lane_engine.cuh's step built by g++ for
// the host, the lanes run one after another. The CPU tests hold it to the
// reference package; on the card, chip_smoke.py holds the CUDA kernels
// (lane_engine.cu, the same step on either route) to it.
#include "lane_engine.cuh"

extern "C" int repro_lane_engine_host(const uint64_t* fields, const int32_t* P, const int32_t* O,
                                      const int32_t* lengths, const int32_t* share, int R, int J,
                                      int N, int m, int idx0, int B, int warmup, int ripple_from,
                                      int ghost) {
  if (lane_engine::check_shape(R, J, N, m) != 0) return 1;
  const lane_engine::Args a = lane_engine::make_args(fields, P, O, lengths, share, R, J, N, m,
                                                     idx0, B, warmup, ripple_from, ghost);
  for (int r = 0; r < R; ++r) lane_engine::lane_run(a, r);
  return 0;
}

// Words of shared memory a block of lane_engine.cu takes on route 1
// (whole = 1) or route 2: the same formula the kernels launch with.
extern "C" int64_t repro_lane_engine_shared_words_host(int J, int N, int whole) {
  return lane_engine::shared_words(J, N, whole != 0);
}
