// fused_linear_act: out[b, n] = act(sum_m xs[b, m] * W[n, m]) on Hopper.
//
// Replaces the Pallas TPU kernel hpnn_tpu/ops/pallas_kernels.py
// fused_linear_act (body _fused_linear_act_kernel), the per-layer product of
// batched_forward_pallas that run_nn and the serving registry evaluate every
// layer through.
//
// What bounds it on the H100: by the card's roofline, B >= 64 at float32 and
// float64 is bound by the FMAs (784->300 at B=4096: 1.93 GFLOP, 29 us at
// 67 TFLOP/s) and smaller batches by reading W once.  Measured, this kernel
// is bound by neither: at small B its grid has few blocks (5 for 784->300 at
// B <= 64) and each walks the K stages in series, so memory latency times
// the stage count sets its time.  The design hides part of that latency
// (the next stage prefetched into registers, full stages unrolled); more
// blocks per layer at small B is the next step (PERF.md).
//
// Design:
// * one block owns a 64x64 tile of the output (64 batch rows x 64 output
//   columns); 256 threads each keep a 4x4 micro-tile of sums in registers;
// * the reduction runs as a loop over K tiles of 32 inside the block, staged
//   through shared memory (both operands transposed to [k][row] so the inner
//   loop reads shared memory without bank conflicts), with the next stage's
//   global loads issued into registers before the current stage's FMAs and
//   full stages unrolled.  This replaces the TPU kernel's sequential
//   "arbitrary" grid axis and its VMEM accumulator: there
//   is no split-K and no atomics, so every output element is summed by ONE
//   thread in a fixed order (ascending m within each K tile, the tiles'
//   partial sums added in ascending order) -- the same bits for any batch
//   size, padding or row position.  That fixed order is what keeps the
//   strict serving tier bit-identical to run_nn on the card;
// * ragged edges are masked at load and store (the TPU version padded the
//   operands on the host to 256/256/512 tiles sized for VMEM);
// * float32 and bfloat16 accumulate in float, float64 in double; the
//   epilogue applies ann_act once (tanhf(0.5*x) for float/bfloat16, the
//   reference's literal 2/(1+exp(-x))-1 for double), converts once (round to
//   nearest even for bfloat16) and stores once.
// wgmma, TMA and a persistent schedule are later work.
//
// C interface (loaded with ctypes): every entry returns cudaGetLastError()
// after the launch; the launch is asynchronous on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;                              // batch rows per block
constexpr int BN = 64;                              // output columns per block
constexpr int BK = 32;                              // reduction depth per stage
constexpr int TM = 4;                               // rows per thread
constexpr int TN = 4;                               // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);      // 256
constexpr int LOAD_ROWS = THREADS / BK;             // rows loaded per pass: 8

template <typename T>
struct Traits;

template <>
struct Traits<float> {
    using Acc = float;
    static __device__ __forceinline__ float zero() { return 0.0f; }
    static __device__ __forceinline__ float load(float v) { return v; }
    static __device__ __forceinline__ float store(float v) { return v; }
    static __device__ __forceinline__ float act(float a) { return tanhf(0.5f * a); }
    static __device__ __forceinline__ float mac(float a, float b, float c) {
        return __fmaf_rn(a, b, c);
    }
};

template <>
struct Traits<__nv_bfloat16> {
    using Acc = float;
    static __device__ __forceinline__ __nv_bfloat16 zero() { return __float2bfloat16(0.0f); }
    static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
    static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16(v); }
    static __device__ __forceinline__ float act(float a) { return tanhf(0.5f * a); }
    static __device__ __forceinline__ float mac(float a, float b, float c) {
        return __fmaf_rn(a, b, c);
    }
};

template <>
struct Traits<double> {
    using Acc = double;
    static __device__ __forceinline__ double zero() { return 0.0; }
    static __device__ __forceinline__ double load(double v) { return v; }
    static __device__ __forceinline__ double store(double v) { return v; }
    static __device__ __forceinline__ double act(double a) {
        return 2.0 / (1.0 + exp(-1.0 * a)) - 1.0;
    }
    static __device__ __forceinline__ double mac(double a, double b, double c) {
        return __fma_rn(a, b, c);
    }
};

// One stage's operands, global -> registers, in the operand type (converted
// only when stored to shared memory, so nothing waits on the loads here):
// thread (lk, lr) takes k0 + lk of rows lr, lr + 8, ... of the xs tile and of
// the W tile, so a warp reads 32 consecutive k of one row (coalesced along
// M).  Out-of-range elements read as zero; they never enter a sum (the
// compute loop stops at the real k).
template <typename T>
__device__ __forceinline__ void fetch_stage(
    const T* __restrict__ xs, const T* __restrict__ w, int B, int N, int M,
    int row0, int col0, int lk, int lr, int k0, T (&xr)[BM / LOAD_ROWS],
    T (&wr)[BN / LOAD_ROWS]) {
    const int k = k0 + lk;
#pragma unroll
    for (int p = 0; p < BM / LOAD_ROWS; ++p) {
        const int row = row0 + lr + p * LOAD_ROWS;
        xr[p] = (row < B && k < M) ? xs[static_cast<size_t>(row) * M + k]
                                   : Traits<T>::zero();
    }
#pragma unroll
    for (int p = 0; p < BN / LOAD_ROWS; ++p) {
        const int col = col0 + lr + p * LOAD_ROWS;
        wr[p] = (col < N && k < M) ? w[static_cast<size_t>(col) * M + k]
                                   : Traits<T>::zero();
    }
}

// One k of a stage: part[i][j] += xs[row i][k] * W[col j][k] for the
// thread's 4x4 outputs (rows ty + 16*i, columns tx + 16*j).
template <typename Tr, typename Acc>
__device__ __forceinline__ void stage_step(const Acc (&xs_s)[BK][BM + 1],
                                           const Acc (&w_s)[BK][BN + 1],
                                           int kk, int tx, int ty,
                                           Acc (&part)[TM][TN]) {
    Acc a[TM];
    Acc b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = xs_s[kk][ty + i * (BM / TM)];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = w_s[kk][tx + j * (BN / TN)];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = Tr::mac(a[i], b[j], part[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_linear_act_kernel(const T* __restrict__ xs, const T* __restrict__ w,
                        T* __restrict__ out, int B, int N, int M, int act) {
    using Tr = Traits<T>;
    using Acc = typename Tr::Acc;
    // +1 column: the transposed stores below hit distinct banks
    __shared__ Acc xs_s[BK][BM + 1];
    __shared__ Acc w_s[BK][BN + 1];

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);  // owns columns tx + 16*j
    const int ty = tid / (BN / TN);  // owns rows ty + 16*i
    const int row0 = blockIdx.x * BM;
    const int col0 = blockIdx.y * BN;
    const int lk = tid % BK;         // loader: k offset inside the stage
    const int lr = tid / BK;         // loader: first row of its passes

    Acc acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

    // registers holding the NEXT stage's operands: their global loads are
    // issued before this stage's FMAs and land while those run, so the
    // load latency is hidden instead of paid once per stage
    T xr[BM / LOAD_ROWS];
    T wr[BN / LOAD_ROWS];
    fetch_stage<T>(xs, w, B, N, M, row0, col0, lk, lr, 0, xr, wr);

    for (int k0 = 0; k0 < M; k0 += BK) {
#pragma unroll
        for (int p = 0; p < BM / LOAD_ROWS; ++p)
            xs_s[lk][lr + p * LOAD_ROWS] = Tr::load(xr[p]);
#pragma unroll
        for (int p = 0; p < BN / LOAD_ROWS; ++p)
            w_s[lk][lr + p * LOAD_ROWS] = Tr::load(wr[p]);
        __syncthreads();
        if (k0 + BK < M)
            fetch_stage<T>(xs, w, B, N, M, row0, col0, lk, lr, k0 + BK, xr, wr);
        // the stage's partial sums, added to the running sums once per
        // stage: a two-level sum whose rounding error grows with
        // BK + M/BK terms instead of M (the TPU kernel likewise added one
        // MXU product per reduction tile to its accumulator).  Only the
        // real k of the stage enter: the sum never sees the padding.
        Acc part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) part[i][j] = Acc(0);
        if (k0 + BK <= M) {
            // a full stage: unrolled, so the shared-memory loads of later
            // k overlap the FMAs of earlier ones
#pragma unroll
            for (int kk = 0; kk < BK; ++kk)
                stage_step<Tr>(xs_s, w_s, kk, tx, ty, part);
        } else {
            for (int kk = 0; kk < M - k0; ++kk)
                stage_step<Tr>(xs_s, w_s, kk, tx, ty, part);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int row = row0 + ty + i * (BM / TM);
        if (row >= B) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = col0 + tx + j * (BN / TN);
            if (col >= N) continue;
            const Acc v = act ? Tr::act(acc[i][j]) : acc[i][j];
            out[static_cast<size_t>(row) * N + col] = Tr::store(v);
        }
    }
}

template <typename T>
int launch(const void* xs, const void* w, void* out, int B, int N, int M,
           int act, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((B + BM - 1) / BM, (N + BN - 1) / BN);
    fused_linear_act_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(xs), static_cast<const T*>(w), static_cast<T*>(out),
        B, N, M, act);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int hpnn_fused_linear_act_f32(const void* xs, const void* w, void* out, int B,
                              int N, int M, int act, int device, void* stream) {
    return launch<float>(xs, w, out, B, N, M, act, device, stream);
}

int hpnn_fused_linear_act_bf16(const void* xs, const void* w, void* out, int B,
                               int N, int M, int act, int device, void* stream) {
    return launch<__nv_bfloat16>(xs, w, out, B, N, M, act, device, stream);
}

int hpnn_fused_linear_act_f64(const void* xs, const void* w, void* out, int B,
                              int N, int M, int act, int device, void* stream) {
    return launch<double>(xs, w, out, B, N, M, act, device, stream);
}

const char* hpnn_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
