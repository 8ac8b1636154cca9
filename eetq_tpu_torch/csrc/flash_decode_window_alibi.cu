// The flash-decode's sliding-window and ALiBi variant (flash_decode.cuh), compiled apart.
#include "flash_decode.cuh"

cudaError_t eetq_fd::launch_window_alibi(const Params& p, int b, int d, bool int8, bool paged,
                                         cudaStream_t s) {
  return dispatch<true, true>(p, b, d, int8, paged, s);
}
