// The common library's error text: what a wrapper raises with when a launch
// returns a CUDA error code (ops/_launch.py: raise_on_error).  The per-rule
// libraries (bitlife.cu, bitltl.cu) carry their own copy, since each is
// loaded alone.

#include <cuda_runtime.h>

extern "C" const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
