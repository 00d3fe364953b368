#include "common.cuh"

EKF_EXPORT const char* ekf_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
