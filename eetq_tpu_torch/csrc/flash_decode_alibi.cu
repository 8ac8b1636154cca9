// The flash-decode's ALiBi variant (flash_decode.cuh), compiled apart.
#include "flash_decode.cuh"

cudaError_t eetq_fd::launch_alibi(const Params& p, int b, int d, bool int8, bool paged,
                                  cudaStream_t s) {
  return dispatch<false, true>(p, b, d, int8, paged, s);
}
