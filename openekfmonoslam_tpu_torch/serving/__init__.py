"""Serving layer: engine sessions behind a socket, the GPU analog of the
reference's Android JNI bindings (android/EKFMonoSlam/jni/EKFNative.cpp)."""
