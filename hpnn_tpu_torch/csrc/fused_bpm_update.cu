// fused_bpm_update: one BPM weight update in one pass on Hopper.
//
// Replaces the Pallas TPU kernel hpnn_tpu/ops/pallas_kernels.py
// fused_bpm_update (body _fused_bpm_kernel): the reference's momentum step
// for one layer (ger_dw_acc, cuda_ann.cu:134-148; ann.c:1996-1999),
//   step = dw + (lr*d[i])*h[j];  W' = W + step;  dw' = alpha*step,
// with the association of the Pallas body kept exactly: lr*d[i] first, then
// times h[j], then plus dw, each product and sum rounded on its own
// (__dmul_rn/__fmul_rn, __dadd_rn/__fadd_rn: nothing contracts into an FMA).
// bfloat16 rounds where the Pallas body rounds in interpret mode and where
// PyTorch's bfloat16 operations round: each operation takes its operands to
// float32, computes there (__fmul_rn/__fadd_rn) and rounds the result to
// bfloat16 (__float2bfloat16_rn); lr and alpha come in already rounded to
// bfloat16 by the caller.  No intermediate keeps float32 precision, so a
// sum is float32's rounding of the exact sum rounded again to bfloat16, as
// the plain version's is.
// W and dw are read, W' and dw' written to fresh outputs; the inputs are
// left as they were, which is what the JAX caller sees.
//
// What bounds it on the H100: 4 flops a weight against 4 values moved a
// weight (W and dw read, W' and dw' written) plus d and h once, so it is
// bound by device memory: (4*N*M + N + M) * size / 3.35 TB/s, 1.12 us at
// 300x784 float32 and 80.1 us at 4096x4096 float32 (160.3 us at float64,
// 40.1 us at bfloat16).
//
// Design:
// * 2-D indexing, no integer division: a thread owns one vector of V
//   consecutive columns (blockIdx.x, threadIdx.x) and one row (blockIdx.y,
//   threadIdx.y), striding by the grid's rows only past 65535 row blocks.
//   Its h values come in once, and lr*d[i] is formed once a row, the same
//   rounded product the per-weight form took, so the bits do not change.
// * 16-byte loads and stores (float4 / double2 / eight bfloat16 in a uint4,
//   V = 4 / 2 / 8) where the row pitch M*sizeof(T) is a multiple of 16 and
//   every pointer is 16-byte aligned; otherwise scalar columns (V = 1),
//   coalesced all the same.
// * Streaming stores (__stcs) for W' and dw', which the kernel never reads.
// * The grid comes from the caller's plan (fused_bpm_plan in
//   hpnn_tpu_torch/ops/kernels.py, a pure function of the shape and the
//   type): blocks of up to 256 threads, a thread a row.  On the H100 that
//   beat one wave of blocks walking many rows each at 4096x4096, and one
//   block walking all the rows at the tutorials' layers (PERF.md, PR 8;
//   scripts/torch_compare_bpm.py --plans).  The launch reads no device
//   attribute.
// Built without --use_fast_math.
//
// hpnn_bpm_empty launches an empty kernel: chip_smoke.py times it in the
// same loop as the update, the floor a launch cannot go below.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after the launch; the launch is asynchronous on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// A host double as T: exact for lr and alpha, which the caller rounds to T.
template <typename T>
T from_double(double x) {
    return static_cast<T>(x);
}
template <>
__nv_bfloat16 from_double<__nv_bfloat16>(double x) {
    return __float2bfloat16_rn(static_cast<float>(x));
}

template <typename T, int V>
struct Vec {
    T v[V];
};

// Read-only loads and streaming stores of V consecutive elements.
template <typename T, int V>
struct Io;

template <typename T>
struct Io<T, 1> {
    static __device__ __forceinline__ Vec<T, 1> load(const T* p) { return {{__ldg(p)}}; }
    static __device__ __forceinline__ void store(T* p, const Vec<T, 1>& x) { __stcs(p, x.v[0]); }
};

template <>
struct Io<float, 4> {
    static __device__ __forceinline__ Vec<float, 4> load(const float* p) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p));
        return {{x.x, x.y, x.z, x.w}};
    }
    static __device__ __forceinline__ void store(float* p, const Vec<float, 4>& x) {
        __stcs(reinterpret_cast<float4*>(p), make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));
    }
};

template <>
struct Io<__nv_bfloat16, 1> {
    static __device__ __forceinline__ Vec<__nv_bfloat16, 1> load(const __nv_bfloat16* p) {
        return {{__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)))}};
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const Vec<__nv_bfloat16, 1>& x) {
        __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(x.v[0]));
    }
};

template <>
struct Io<__nv_bfloat16, 8> {
    union Bits {
        uint4 u;
        unsigned short b[8];
    };
    static __device__ __forceinline__ Vec<__nv_bfloat16, 8> load(const __nv_bfloat16* p) {
        Bits x;
        x.u = __ldg(reinterpret_cast<const uint4*>(p));
        Vec<__nv_bfloat16, 8> v;
#pragma unroll
        for (int k = 0; k < 8; ++k) v.v[k] = __ushort_as_bfloat16(x.b[k]);
        return v;
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const Vec<__nv_bfloat16, 8>& v) {
        Bits x;
#pragma unroll
        for (int k = 0; k < 8; ++k) x.b[k] = __bfloat16_as_ushort(v.v[k]);
        __stcs(reinterpret_cast<uint4*>(p), x.u);
    }
};

template <>
struct Io<double, 2> {
    static __device__ __forceinline__ Vec<double, 2> load(const double* p) {
        const double2 x = __ldg(reinterpret_cast<const double2*>(p));
        return {{x.x, x.y}};
    }
    static __device__ __forceinline__ void store(double* p, const Vec<double, 2>& x) {
        __stcs(reinterpret_cast<double2*>(p), make_double2(x.v[0], x.v[1]));
    }
};

// One row of a thread's vector: step = dw + g*h; W' = W + step; dw' = alpha*step.
template <typename T, int V>
__device__ __forceinline__ void update(const Vec<T, V>& w, const Vec<T, V>& dw,
                                       const Vec<T, V>& h, T g, T alpha, T* w_out, T* dw_out) {
    Vec<T, V> wo, dwo;
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const T step = add(dw.v[k], mul(g, h.v[k]));
        wo.v[k] = add(w.v[k], step);
        dwo.v[k] = mul(alpha, step);
    }
    Io<T, V>::store(w_out, wo);
    Io<T, V>::store(dw_out, dwo);
}

template <typename T, int V>
__global__ void __launch_bounds__(256)
fused_bpm_kernel(const T* __restrict__ w, const T* __restrict__ dw, const T* __restrict__ d,
                 const T* __restrict__ h, T* __restrict__ w_out, T* __restrict__ dw_out, int n,
                 int m, T lr, T alpha) {
    const int col = (blockIdx.x * blockDim.x + threadIdx.x) * V;
    if (col >= m) return;
    const Vec<T, V> hv = Io<T, V>::load(h + col);
    const long long step_rows = static_cast<long long>(gridDim.y) * blockDim.y;
    for (long long r = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y; r < n;
         r += step_rows) {
        const size_t e = static_cast<size_t>(r) * m + col;
        update<T, V>(Io<T, V>::load(w + e), Io<T, V>::load(dw + e), hv,
                     mul(lr, Io<T, 1>::load(d + r).v[0]), alpha, w_out + e, dw_out + e);
    }
}

__global__ void empty_kernel() {}

cudaError_t use_device(int device) {
    int cur = -1;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == device) return err;
    return cudaSetDevice(device);
}

template <typename T>
int launch(const void* w, const void* dw, const void* d, const void* h, void* w_out,
           void* dw_out, int n, int m, double lr, double alpha, int vec, int tx, int ty,
           int gx, int gy, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
    const dim3 grid(gx, gy), block(tx, ty);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const T* wi = static_cast<const T*>(w);
    const T* dwi = static_cast<const T*>(dw);
    const T* di = static_cast<const T*>(d);
    const T* hi = static_cast<const T*>(h);
    T* wo = static_cast<T*>(w_out);
    T* dwo = static_cast<T*>(dw_out);
    constexpr int VW = 16 / sizeof(T);
    if (vec == VW)
        fused_bpm_kernel<T, VW><<<grid, block, 0, s>>>(wi, dwi, di, hi, wo, dwo, n, m,
                                                       from_double<T>(lr),
                                                       from_double<T>(alpha));
    else if (vec == 1)
        fused_bpm_kernel<T, 1><<<grid, block, 0, s>>>(wi, dwi, di, hi, wo, dwo, n, m,
                                                      from_double<T>(lr),
                                                      from_double<T>(alpha));
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hpnn_fused_bpm_update_f64(const void* w, const void* dw, const void* d, const void* h,
                              void* w_out, void* dw_out, int n, int m, double lr,
                              double alpha, int vec, int tx, int ty, int gx, int gy, int device,
                              void* stream) {
    return launch<double>(w, dw, d, h, w_out, dw_out, n, m, lr, alpha, vec, tx, ty, gx, gy,
                          device, stream);
}

int hpnn_fused_bpm_update_f32(const void* w, const void* dw, const void* d, const void* h,
                              void* w_out, void* dw_out, int n, int m, double lr,
                              double alpha, int vec, int tx, int ty, int gx, int gy, int device,
                              void* stream) {
    return launch<float>(w, dw, d, h, w_out, dw_out, n, m, lr, alpha, vec, tx, ty, gx, gy,
                         device, stream);
}

int hpnn_fused_bpm_update_bf16(const void* w, const void* dw, const void* d, const void* h,
                               void* w_out, void* dw_out, int n, int m, double lr,
                               double alpha, int vec, int tx, int ty, int gx, int gy,
                               int device, void* stream) {
    return launch<__nv_bfloat16>(w, dw, d, h, w_out, dw_out, n, m, lr, alpha, vec, tx, ty, gx,
                                 gy, device, stream);
}

int hpnn_bpm_empty(int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

const char* hpnn_bpm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
