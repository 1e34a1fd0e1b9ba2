// fused_bpm_update: one BPM weight update in one pass on Hopper.
//
// Replaces the Pallas TPU kernel hpnn_tpu/ops/pallas_kernels.py
// fused_bpm_update (body _fused_bpm_kernel): the reference's momentum step
// for one layer (ger_dw_acc, cuda_ann.cu:134-148; ann.c:1996-1999),
//   step = dw + (lr*d[i])*h[j];  W' = W + step;  dw' = alpha*step,
// with the association of the Pallas body kept exactly: lr*d[i] first, then
// times h[j], then plus dw, each product and sum rounded on its own
// (__dmul_rn/__fmul_rn, __dadd_rn/__fadd_rn: nothing contracts into an FMA).
// W and dw are read, W' and dw' written to fresh outputs; the inputs are
// left as they were, which is what the JAX caller sees.
//
// What bounds it on the H100: 4 flops a weight against 4 values moved a
// weight (W and dw read, W' and dw' written), so it is bound by device
// memory: 784x300 at float32 moves 3.76 MB, 1.1 us at 3.35 TB/s.
//
// Design: one thread per weight in a grid-stride loop, consecutive threads
// on consecutive columns of a row (coalesced W/dw/h, d[i] a broadcast);
// float64 and float32.  Built without --use_fast_math.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after the launch; the launch is asynchronous on the caller's stream.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_bpm_kernel(const T* __restrict__ w, const T* __restrict__ dw, const T* __restrict__ d,
                 const T* __restrict__ h, T* __restrict__ w_out, T* __restrict__ dw_out, int n,
                 int m, T lr, T alpha) {
    const long long total = static_cast<long long>(n) * m;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
         e += stride) {
        const int i = static_cast<int>(e / m), j = static_cast<int>(e % m);
        const T step = add(dw[e], mul(mul(lr, d[i]), h[j]));
        w_out[e] = add(w[e], step);
        dw_out[e] = mul(alpha, step);
    }
}

template <typename T>
int launch(const void* w, const void* dw, const void* d, const void* h, void* w_out,
           void* dw_out, int n, int m, double lr, double alpha, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(n) * m;
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 32LL * sms) blocks = 32LL * sms;
    if (blocks < 1) return static_cast<int>(cudaSuccess);
    fused_bpm_kernel<T><<<static_cast<int>(blocks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(w), static_cast<const T*>(dw), static_cast<const T*>(d),
        static_cast<const T*>(h), static_cast<T*>(w_out), static_cast<T*>(dw_out), n, m, T(lr),
        T(alpha));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hpnn_fused_bpm_update_f64(const void* w, const void* dw, const void* d, const void* h,
                              void* w_out, void* dw_out, int n, int m, double lr,
                              double alpha, int device, void* stream) {
    return launch<double>(w, dw, d, h, w_out, dw_out, n, m, lr, alpha, device, stream);
}

int hpnn_fused_bpm_update_f32(const void* w, const void* dw, const void* d, const void* h,
                              void* w_out, void* dw_out, int n, int m, double lr,
                              double alpha, int device, void* stream) {
    return launch<float>(w, dw, d, h, w_out, dw_out, n, m, lr, alpha, device, stream);
}

const char* hpnn_bpm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
