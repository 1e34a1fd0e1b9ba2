// train_epoch: one epoch of per-sample train-to-convergence on Hopper, the
// whole epoch in one cooperative launch.
//
// Replaces the Pallas TPU kernel hpnn_tpu/ops/convergence_pallas.py
// _train_one, as _kernel_plain (one launch per epoch) and _kernel (the
// iteration-budgeted launch with host resume) ran it.  The budget is two
// arguments of this one kernel (start_idx, iter_budget), not a second kernel.
//
// What it computes, in sample order s = start_idx .. S-1 (ann.c:2281-2372,
// snn.c:1417-1595, hpnn_tpu/ops/convergence.py:89-145): zero dw under BPM;
// forward; init_err; p_trg (the last index with t == 1, default 0); then the
// do/while: deltas from the pre-update weights, the BP update
// W += lr*(d (x) h) or the BPM one dw += lr*(d (x) h); W += dw; dw *= alpha,
// a fresh forward, epr, dEp = ep - epr, the first-max argmax against p_trg
// (LNN: is_ok = true), first_ok at it == 1; continue while
// it <= MAX && (dEp > delta || !(is_ok && it > MIN)).  One stats row per
// sample (init_err, first_ok, n_iter, final_dep, success) in double.  Rows of
// samples the launch does not train keep what the caller put there (the
// wrapper puts n_iter = -1).  Once the launch's iteration count reaches
// iter_budget no new sample starts; the first sample of a launch always runs.
//
// What bounds it on the H100: per iteration the net does about 9P flops for
// BP and 11P for BPM (P = sum of N_l*M_l; 238,200 for MNIST 784-300-10),
// a few hundredths of a microsecond at the card's peak, and moves no bytes to
// device memory if the weights stay on chip.  The work is one sample wide and
// sequential from iteration to iteration, so what bounds this kernel is the
// latency of its 2L grid-wide barriers per iteration (L layers) and of the
// dependent loads between them, far above either roofline bound.
//
// Design (a simple kernel that is right; speed is later work):
// * one cooperative launch (cudaLaunchCooperativeKernel) whose grid is no
//   larger than what can be resident at once; phases meet at
//   cooperative_groups grid barriers: L-1 hidden-delta phases, L forward
//   phases with the update fused in, one decision phase;
// * the weights stay in device memory (2-4 MB at the tutorial shapes, which
//   the 50 MB L2 holds) and are read with ld.global.cg, so no block sees a
//   stale L1 line of a row another block wrote;
// * rows are split over warps: in forward phase l the warp that owns row i
//   first applies the row's update (reading the previous activations), then
//   sums the updated row against the new activations; the hidden delta of
//   column j is summed by the warp that owns column j, from the pre-update
//   weights (nothing is scattered, no atomics).  Each dot product is summed
//   lane-strided in ascending order and then by a fixed xor-butterfly, so
//   every n_iter and every bit repeats from run to run, and budgeted launches
//   equal one launch bit for bit;
// * block 0 computes the output head (the SNN softmax denominator as the
//   reference's TINY-seeded serial fold), the error, the argmax, the output
//   delta and the stop test, and publishes the decision in device memory
//   before the barrier that every block reads it after: all blocks take the
//   same branch, so none skips a barrier;
// * any width is masked by the loop bounds; nothing is padded.
//
// Types: float64 computes in double; float32 in float (full FMA, never TF32);
// bfloat16 keeps float master weights and dw, rounds matrix-vector operands,
// activations and deltas to bfloat16, sums in float, and keeps the outer
// product, the update and the errors in float, as the TPU kernel did.
// Rounding: this file is built without --use_fast_math; the update
// w + lr*(d*h) and the error sums use explicit round-to-nearest intrinsics
// (__dmul_rn/__dadd_rn and the float ones), so nvcc cannot contract them
// into FMAs and each product is rounded where the JAX package rounds it.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after the launch (or the error of a refused launch); the launch is
// asynchronous on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KIND_ANN = 0;
constexpr int KIND_SNN = 1;
constexpr int KIND_LNN = 2;
constexpr double TINY = 1e-14;  // include/libhpnn/common.h:79

template <typename T>
struct Net {
    T* w[MAX_LAYERS];   // master weights (n[l], m[l]), updated in place
    T* dw[MAX_LAYERS];  // BPM momentum (same shapes), or null under BP
    int n[MAX_LAYERS];
    int m[MAX_LAYERS];
    int layers;
};

// ---- arithmetic with the rounding spelled out -------------------------------

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// bfloat16 rounding of a float-held value (identity unless BF)
template <bool BF>
__device__ __forceinline__ float rb(float x) {
    return BF ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}
template <bool BF>
__device__ __forceinline__ double rb(double x) { return x; }

// ann_act(x) = 2/(1+exp(-x))-1 (ann.c:883-885): the literal expression at
// float64, tanhf(0.5x) otherwise (the port's ops/activations.py split)
template <bool BF>
__device__ __forceinline__ double act(double x) {
    return sub(dvd(2.0, add(1.0, exp(-x))), 1.0);
}
template <bool BF>
__device__ __forceinline__ float act(float x) { return rb<BF>(tanhf(0.5f * x)); }

// ann_dact(y) = -0.5*(y*y - 1) (ann.c:886-888), each operation rounded
template <bool BF, typename T>
__device__ __forceinline__ T dact(T y) {
    return rb<BF>(mul(T(-0.5), rb<BF>(sub(rb<BF>(mul(y, y)), T(1)))));
}

__device__ __forceinline__ double expT(double x) { return exp(x); }
__device__ __forceinline__ float expT(float x) { return expf(x); }
__device__ __forceinline__ double logT(double x) { return log(x); }
__device__ __forceinline__ float logT(float x) { return logf(x); }

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }
template <typename T>
__device__ __forceinline__ void st(T* p, T v) { __stcg(p, v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

struct Args {
    const void* xs;
    const void* ts;
    double* stats;    // (S, 5)
    void* scratch;    // 3 * sum(n) + n_out elements of T
    int* ctl;         // [0] continue flag, [1] iterations used by this launch
    int S, n_in, n_out, kind, momentum;
    double lr, alpha, delta;
    int min_iter, max_iter, start_idx, iter_budget;
};

// Forward phase of layer l: rows i owned by warp gw.  With upd, the warp
// first applies row i's BP/BPM update from h (the previous activations)
// and then sums the updated row against v (the new activations).
template <typename T, bool BF>
__device__ void forward_phase(const Net<T>& net, int l, bool upd, bool momentum,
                              T lr, T alpha, const T* v, const T* h, const T* d,
                              T* out, bool last, int kind, int gw, int nw, int lane) {
    const int N = net.n[l], M = net.m[l];
    T* W = net.w[l];
    T* DW = net.dw[l];
    for (int i = gw; i < N; i += nw) {
        T* row = W + static_cast<size_t>(i) * M;
        T* drow = momentum ? DW + static_cast<size_t>(i) * M : nullptr;
        const T di = upd ? ld(d + i) : T(0);
        T acc = T(0);
        for (int j = lane; j < M; j += 32) {
            T w = ld(row + j);
            if (upd) {
                // lr * (d_i * h_j): the product rounded before lr scales it
                const T step = mul(lr, mul(di, ld(h + j)));
                if (momentum) {
                    const T s2 = add(ld(drow + j), step);
                    w = add(w, s2);
                    st(drow + j, mul(alpha, s2));
                } else {
                    w = add(w, step);
                }
                st(row + j, w);
            }
            acc = fma_(rb<BF>(w), ld(v + j), acc);
        }
        acc = warp_sum(acc);
        if (lane == 0) {
            const T z = rb<BF>(acc);
            // SNN's softmax and LNN's linear head are applied by block 0
            st(out + i, (last && kind != KIND_ANN) ? z : act<BF>(z));
        }
    }
}

// Hidden delta of layer l: d_l[j] = (W_{l+1}^T d_{l+1})[j] * dact(a_l[j]),
// column j summed by the warp that owns it, from the pre-update W_{l+1}.
template <typename T, bool BF>
__device__ void delta_phase(const Net<T>& net, int l, const T* a, const T* dnext,
                            T* dl, int gw, int nw, int lane) {
    const int N1 = net.n[l + 1], M1 = net.m[l + 1];
    const T* W = net.w[l + 1];
    for (int j = gw; j < M1; j += nw) {
        T acc = T(0);
        for (int i = lane; i < N1; i += 32)
            acc = fma_(rb<BF>(ld(W + static_cast<size_t>(i) * M1 + j)), ld(dnext + i), acc);
        acc = warp_sum(acc);
        if (lane == 0) st(dl + j, rb<BF>(mul(rb<BF>(acc), dact<BF>(ld(a + j)))));
    }
}

// Per-sample state, held by thread 0 of block 0.
template <typename T>
struct Sample {
    T ep, init_err, dep;
    int it, p_trg, first_ok, is_ok;
};

// Block 0: the output head, the error, the argmax and the output delta of
// the forward whose last layer is in z; returns the error.
template <typename T, bool BF>
__device__ T head_and_error(const Args& a, const T* t, const T* z, T* o, T* dL,
                            int* guess, T* sh) {
    const int n = a.n_out, tid = threadIdx.x;
    if (a.kind == KIND_SNN) {
        for (int i = tid; i < n; i += THREADS)
            st(o + i, rb<BF>(expT(rb<BF>(sub(ld(z + i), T(1))))));
        __syncthreads();
        if (tid == 0) {
            // softmax(x-1), denominator summed in order: float64 seeds it
            // with TINY (snn.c:296-334); float32 and bfloat16 add TINY after
            // the sum, as the TPU kernel's head and the plain version do
            constexpr bool seed = sizeof(T) == sizeof(double);
            T dv = seed ? T(TINY) : T(0);
            for (int i = 0; i < n; ++i) dv = add(dv, ld(o + i));
            if (!seed) dv = add(dv, T(TINY));
            sh[0] = dv;
        }
        __syncthreads();
        const T dv = sh[0];
        for (int i = tid; i < n; i += THREADS) st(o + i, rb<BF>(dvd(ld(o + i), dv)));
    } else {
        for (int i = tid; i < n; i += THREADS) st(o + i, ld(z + i));
    }
    __syncthreads();
    // output delta: ANN (t-o)*dact(o) (ann.c:1308-1310); SNN, LNN t-o
    for (int i = tid; i < n; i += THREADS) {
        const T oi = ld(o + i), diff = rb<BF>(sub(t[i], oi));
        st(dL + i, a.kind == KIND_ANN ? rb<BF>(mul(diff, dact<BF>(oi))) : diff);
    }
    T err = T(0);
    if (tid == 0) {
        T acc = T(0);
        int best = 0;
        T bv = ld(o);
        for (int i = 0; i < n; ++i) {
            const T oi = ld(o + i);
            if (a.kind == KIND_SNN) {
                // -(1/N) sum_{o>0} t*log(o+TINY) (snn.c:447-477)
                if (oi > T(0)) acc = add(acc, mul(t[i], logT(add(oi, T(TINY)))));
            } else {
                // 0.5*sum((t-o)^2) (ann.c:1246-1275)
                const T diff = sub(t[i], oi);
                acc = add(acc, mul(diff, diff));
            }
            if (oi > bv) {  // first maximal index (strict compare)
                bv = oi;
                best = i;
            }
        }
        err = a.kind == KIND_SNN ? dvd(-acc, T(n)) : mul(T(0.5), acc);
        *guess = best;
    }
    return err;
}

template <typename T, bool BF>
__global__ void __launch_bounds__(THREADS)
train_epoch_kernel(Net<T> net, Args a) {
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x % 32;
    const int nw = gridDim.x * WARPS;
    const int gw = blockIdx.x * WARPS + threadIdx.x / 32;
    const bool lead = blockIdx.x == 0;
    const int L = net.layers;
    const T lr = T(a.lr), alpha = T(a.alpha), delta = T(a.delta);
    __shared__ T sh[1];

    int off[MAX_LAYERS + 1];
    off[0] = 0;
    for (int l = 0; l < L; ++l) off[l + 1] = off[l] + net.n[l];
    T* buf = static_cast<T*>(a.scratch);
    T* acts[2] = {buf, buf + off[L]};  // activations of two forwards
    T* dl = buf + 2 * off[L];          // deltas
    T* o = buf + 3 * off[L];           // the output head's values (block 0)

    Sample<T> sm{};
    int iters_used = 0;  // thread 0 of block 0
    for (int s = a.start_idx; s < a.S; ++s) {
        if (s > a.start_idx && ld(a.ctl + 1) >= a.iter_budget) break;
        const T* x = static_cast<const T*>(a.xs) + static_cast<size_t>(s) * a.n_in;
        const T* t = static_cast<const T*>(a.ts) + static_cast<size_t>(s) * a.n_out;
        if (a.momentum) {  // ann_raz_momentum (ann.c:2391)
            const int tid = blockIdx.x * THREADS + threadIdx.x;
            for (int l = 0; l < L; ++l) {
                const size_t cnt = static_cast<size_t>(net.n[l]) * net.m[l];
                for (size_t k = tid; k < cnt; k += static_cast<size_t>(gridDim.x) * THREADS)
                    st(net.dw[l] + k, T(0));
            }
        }
        int cur = 0;
        for (int l = 0; l < L; ++l) {
            forward_phase<T, BF>(net, l, false, false, lr, alpha,
                                 l ? acts[cur] + off[l - 1] : x, nullptr, nullptr,
                                 acts[cur] + off[l], l == L - 1, a.kind, gw, nw, lane);
            grid.sync();
        }
        if (lead) {
            int guess = 0;
            const T err = head_and_error<T, BF>(a, t, acts[cur] + off[L - 1], o,
                                                dl + off[L - 1], &guess, sh);
            if (threadIdx.x == 0) {
                sm = Sample<T>{};
                sm.init_err = err;
                sm.ep = err;
                sm.p_trg = 0;
                for (int i = 0; i < a.n_out; ++i)
                    if (t[i] == T(1)) sm.p_trg = i;
            }
        }
        grid.sync();
        while (true) {
            for (int l = L - 2; l >= 0; --l) {
                delta_phase<T, BF>(net, l, acts[cur] + off[l], dl + off[l + 1], dl + off[l],
                                   gw, nw, lane);
                grid.sync();
            }
            const int nxt = cur ^ 1;
            for (int l = 0; l < L; ++l) {
                forward_phase<T, BF>(net, l, true, a.momentum, lr, alpha,
                                     l ? acts[nxt] + off[l - 1] : x,
                                     l ? acts[cur] + off[l - 1] : x, dl + off[l],
                                     acts[nxt] + off[l], l == L - 1, a.kind, gw, nw, lane);
                grid.sync();
            }
            cur = nxt;
            if (lead) {
                int guess = 0;
                const T epr = head_and_error<T, BF>(a, t, acts[cur] + off[L - 1], o,
                                                    dl + off[L - 1], &guess, sh);
                if (threadIdx.x == 0) {
                    sm.it += 1;
                    sm.dep = sub(sm.ep, epr);
                    sm.ep = epr;
                    sm.is_ok = a.kind == KIND_LNN || guess == sm.p_trg;
                    if (sm.it == 1) sm.first_ok = sm.is_ok;
                    const bool cont = sm.it <= a.max_iter &&
                                      (sm.dep > delta || !(sm.is_ok && sm.it > a.min_iter));
                    if (!cont) {
                        double* row = a.stats + static_cast<size_t>(s) * 5;
                        row[0] = double(sm.init_err);
                        row[1] = sm.first_ok ? 1.0 : 0.0;
                        row[2] = double(sm.it);
                        row[3] = double(sm.dep);
                        row[4] = (sm.is_ok && sm.it > a.min_iter) ? 1.0 : 0.0;
                        iters_used += sm.it;
                        st(a.ctl + 1, iters_used);
                    }
                    st(a.ctl, cont ? 1 : 0);
                }
            }
            grid.sync();
            if (!ld(a.ctl)) break;
        }
    }
}

template <typename T, bool BF>
int launch(void* const* w, void* const* dw, const int* n, const int* m, int layers,
           const Args& args, int device, void* stream, int* grid_out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (layers < 1 || layers > MAX_LAYERS) return static_cast<int>(cudaErrorInvalidValue);
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, train_epoch_kernel<T, BF>,
                                                        THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    Net<T> net{};
    int widest = 1;
    for (int l = 0; l < layers; ++l) {
        net.w[l] = static_cast<T*>(w[l]);
        net.dw[l] = args.momentum ? static_cast<T*>(dw[l]) : nullptr;
        net.n[l] = n[l];
        net.m[l] = m[l];
        if (n[l] > widest) widest = n[l];
    }
    net.layers = layers;
    // one warp per row of the widest layer, no more blocks than can be
    // resident together (a cooperative launch requires it)
    int blocks = (widest + WARPS - 1) / WARPS;
    if (blocks > per_sm * sms) blocks = per_sm * sms;
    if (blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    if (grid_out) *grid_out = blocks;
    Args a = args;
    void* kargs[] = {&net, &a};
    err = cudaLaunchCooperativeKernel((const void*)train_epoch_kernel<T, BF>,
                                      dim3(blocks), dim3(THREADS), kargs, 0,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BF>
int entry(void* const* w, void* const* dw, const int* n, const int* m, int layers,
          const void* xs, const void* ts, double* stats, void* scratch, int* ctl, int S,
          int n_in, int n_out, int kind, int momentum, double lr, double alpha,
          double delta, int min_iter, int max_iter, int start_idx, int iter_budget,
          int device, void* stream, int* grid_out) {
    Args a{xs, ts, stats, scratch, ctl, S, n_in, n_out, kind, momentum, lr, alpha, delta,
           min_iter, max_iter, start_idx, iter_budget};
    return launch<T, BF>(w, dw, n, m, layers, a, device, stream, grid_out);
}

}  // namespace

extern "C" {

#define HPNN_TRAIN_ENTRY(NAME, T, BF)                                                    \
    int NAME(void* const* w, void* const* dw, const int* n, const int* m, int layers,  \
             const void* xs, const void* ts, double* stats, void* scratch, int* ctl,    \
             int S, int n_in, int n_out, int kind, int momentum, double lr,            \
             double alpha, double delta, int min_iter, int max_iter, int start_idx,     \
             int iter_budget, int device, void* stream, int* grid_out) {                \
        return entry<T, BF>(w, dw, n, m, layers, xs, ts, stats, scratch, ctl, S, n_in,  \
                            n_out, kind, momentum, lr, alpha, delta, min_iter,          \
                            max_iter, start_idx, iter_budget, device, stream, grid_out);\
    }

HPNN_TRAIN_ENTRY(hpnn_train_epoch_f64, double, false)
HPNN_TRAIN_ENTRY(hpnn_train_epoch_f32, float, false)
HPNN_TRAIN_ENTRY(hpnn_train_epoch_bf16, float, true)

const char* hpnn_train_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
