// Shared declarations of the filter kernels (built with nvcc for sm_90a
// into one shared library with a plain C interface; see ops/cuda_lib.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define EKF_EXPORT extern "C" __attribute__((visibility("default")))

// Camera calibration constants, passed by host pointer from ctypes and by
// value to the kernels.  Field order is ops/cuda_lib.py's CamParams.
struct CamParams {
    float fx, fy, cx, cy, k1, k2, dx, dy;
    float tan_x, tan_y, pixels_x, pixels_y;
};

// Every exported launcher returns the launch's cudaError_t (0 = success).
static inline int ekf_last_error() { return (int)cudaGetLastError(); }

// Stage marks of tools/small_kernel_clocks.py, which builds an instrumented
// copy of a kernel with EKF_STAGE_CLOCKS and these two defined:
// EKF_MARK(slot, dep) records clock64 in ``slot`` once the float ``dep`` is
// computed, EKF_NOTE(slot, v) records the integer v.  They compile to
// nothing here.
#ifndef EKF_MARK
#define EKF_MARK(slot, dep)
#define EKF_NOTE(slot, value)
#endif
