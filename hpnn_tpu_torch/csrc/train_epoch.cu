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
// device memory.  The work is one sample wide and each iteration depends on
// the one before, so what bounds the kernel is latency: its grid barriers
// (about 1.1 us each), the L2 round trips between them, and the head's
// serial folds.  On an H100 (700 W), an MNIST ANN BP f64 iteration takes
// 7.7 us against 20.4 us for the first kernel of this file; a copy with
// clock stamps in block 0 (8.8 us) splits it into two barriers 2.3 us, the
// layer-0 phase 2.2 (its delta 0.7, its rows in shared memory 1.5), the
// layer-1 phase 3.0 (staging 1.3, its rows through L2 1.8) and the head
// 1.2.  At XRD 851-230-230 BPM f64 (10.5 us, from 67-68) the head's serial
// 230-wide error fold takes most of its 3.9 us.  PERF.md has the runs.
//
// Design:
// * one cooperative launch (cudaLaunchCooperativeKernel) whose grid is no
//   larger than what can be resident at once; rows are split over warps
//   (warp gw of nw owns rows gw, gw + nw, ... of every layer) and the warp
//   that owns row j of layer l also owns column j of layer l+1's delta.
//   Blocks of 4 warps (75 at MNIST widths, 58 at XRD's), up to 8 where the
//   rows outnumber 4 warps on every SM; where they outnumber the warps the
//   card holds at once, the grid is what it holds and a warp takes several
//   rows of a layer;
// * 2L - 2 grid barriers an iteration for L >= 2 layers (1 for L = 1): one
//   after each hidden-delta phase of layers L-2 .. 1 and one after each
//   forward phase.  The delta of layer 0 has one consumer, the warp that
//   owns row j of W_0, so that warp sums column j of W_1 against d_1 at the
//   start of the layer-0 forward phase, with no barrier between; it loads
//   that column (and a_0[j]) into registers right after the last barrier
//   of the iteration before, so the loads overlap the head;
// * the head in every block: after the last forward barrier each block
//   stages the outputs into its shared memory and computes the softmax,
//   the error, the argmax, the output delta and the stop test itself, from
//   the same bits, so every block takes the same branch and no block waits
//   for another's decision (each counts its own iterations for the
//   budget).  Block 0 alone writes the stats rows.  The serial folds (the
//   SNN denominator, the error) read shared memory;
// * where the weights live: W_0's rows (and dw_0's under BPM) in their
//   owner's shared memory for the whole launch, written back to W_0 when
//   it ends (the resident plan), since no delta reads W_0's columns; the
//   layers l >= 1 in device memory, read through L2 with ld.global.cg
//   (their columns are read by other SMs, and a stale L1 line would be a
//   silent wrong answer).  Where W_0's rows do not fit (a very wide input
//   layer), W_0 stays in device memory (the staged plan); where even the
//   staged vectors do not fit, the launch is refused;
// * each phase stages the vectors it reads (the sample, the previous and
//   the new activations) into shared memory once, in the blocks that own
//   rows of the layer, and a row is walked CHUNK elements a lane at a
//   time, the chunk's loads issued together;
// * each dot product is summed lane-strided in ascending order and then by
//   a fixed xor butterfly, and each head fold serially in ascending order,
//   exactly as the first kernel of this file did, so every bit repeats and
//   budgeted launches equal one launch bit for bit.
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
// asynchronous on the caller's stream.  hpnn_train_epoch_{f64,f32,bf16}
// keep the first kernel's signature (ctl is no longer read: every block
// counts its own iterations) and choose the plan by shape;
// hpnn_train_epoch_plan_{f64,f32,bf16} drop ctl, take an argument that
// forces the plan (resident 0 or 1; -1 leaves it to the shape), report
// what was launched (blocks, resident, shared bytes a block, rows of W_0 a
// warp, warps a block; resident -1 and the bytes the widths need when
// they are refused) and, given a device array of three int64, have block
// 0 write there the grid barriers it took inside the launch's iterations,
// all the barriers it took, and the iterations.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int MAX_THREADS = 256;  // a block is 4 to 8 warps, chosen by the plan
constexpr int MIN_WARPS = 4;
constexpr int CHUNK = 8;  // row elements a lane loads together
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

// Data another SM writes during the launch goes through L2.
template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }
template <typename T>
__device__ __forceinline__ void st(T* p, T v) { __stcg(p, v); }

// How a row is read and written: through L2 in device memory, or in the
// owner's shared memory.
struct InL2 {
    template <typename T>
    static __device__ __forceinline__ T load(const T* p) { return __ldcg(p); }
    template <typename T>
    static __device__ __forceinline__ void store(T* p, T v) { __stcg(p, v); }
};
struct OnChip {
    template <typename T>
    static __device__ __forceinline__ T load(const T* p) { return *p; }
    template <typename T>
    static __device__ __forceinline__ void store(T* p, T v) { *p = v; }
};

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
    void* scratch;    // 3 * sum(n) elements of T: two forwards' activations, deltas
    long long* counts;  // (3,) or null: grid barriers in iterations, in all; iterations
    int S, n_in, n_out, kind, momentum;
    double lr, alpha, delta;
    int min_iter, max_iter, start_idx, iter_budget;
};

// What the launch takes, chosen on the host: warps a block, rows of W_0 a
// warp (slots in the resident plan) and the widest input of layers 1..
// (the staged h, v).
struct Plan {
    int warps;
    int rows0;
    int hmax;
};

// The block's shared memory, carved in order, each region 16-byte aligned.
template <typename T>
struct Smem {
    T *x, *t, *o, *dl, *term, *h, *v, *w0, *dw0;
};

__host__ __device__ inline size_t region(size_t elems, size_t item) {
    return (elems * item + 15) / 16 * 16;
}

// Shared bytes of the staged vectors: x, the head's four n_out vectors,
// h and v.
__host__ __device__ inline size_t staged_bytes(int n_in, int n_out, int hmax, size_t item) {
    return region(n_in, item) + 4 * region(n_out, item) + 2 * region(hmax, item);
}

// Shared bytes of W_0's resident rows (and dw_0's under BPM).
__host__ __device__ inline size_t resident_bytes(const Plan& p, int m0, int momentum, size_t item) {
    return region(static_cast<size_t>(p.warps) * p.rows0 * m0, item) * (momentum ? 2 : 1);
}

template <typename T>
__device__ Smem<T> carve(unsigned char* base, const Args& a, const Plan& p, int m0, bool res) {
    Smem<T> s{};
    size_t at = 0;
    auto take = [&](size_t elems) {
        T* ptr = reinterpret_cast<T*>(base + at);
        at += region(elems, sizeof(T));
        return ptr;
    };
    s.x = take(a.n_in);
    s.t = take(a.n_out);
    s.o = take(a.n_out);
    s.dl = take(a.n_out);
    s.term = take(a.n_out);
    s.h = take(p.hmax);
    s.v = take(p.hmax);
    if (res) {
        s.w0 = take(static_cast<size_t>(p.warps) * p.rows0 * m0);
        if (a.momentum) s.dw0 = take(static_cast<size_t>(p.warps) * p.rows0 * m0);
    }
    return s;
}

// Block-wide copy of n elements of device memory into shared memory.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = ld(src + i);
}

// One row of a forward phase, by one warp: with upd, the row takes the
// BP/BPM step from its delta di and h (the previous activations), then the
// updated row is summed against v (the new activations); h and v are in
// shared memory (one vector in layer 0, SAME: the sample is both).  Lane k
// takes elements k, k + 32, ... in ascending order, CHUNK of them at a time
// with their loads issued together, and the lanes' sums meet in the xor
// butterfly: every lane returns the same bits.
template <typename Mem, bool SAME, typename T, bool BF>
__device__ __forceinline__ T row_pass(T* row, T* drow, int M, bool upd, bool momentum, T lr,
                                      T alpha, T di, const T* h, const T* v, int lane) {
    T acc = T(0);
    for (int j0 = lane; j0 < M; j0 += 32 * CHUNK) {
        T w[CHUNK], hv[CHUNK], vv[CHUNK], dv[CHUNK];
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
            const int j = j0 + 32 * k;
            w[k] = hv[k] = vv[k] = dv[k] = T(0);
            if (j < M) {
                w[k] = Mem::load(row + j);
                vv[k] = v[j];
                if (upd) {
                    hv[k] = SAME ? vv[k] : h[j];
                    if (momentum) dv[k] = Mem::load(drow + j);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
            const int j = j0 + 32 * k;
            if (j < M) {
                T wk = w[k];
                if (upd) {
                    // lr * (d_i * h_j): the product rounded before lr scales it
                    const T step = mul(lr, mul(di, hv[k]));
                    if (momentum) {
                        const T s2 = add(dv[k], step);
                        wk = add(wk, s2);
                        Mem::store(drow + j, mul(alpha, s2));
                    } else {
                        wk = add(wk, step);
                    }
                    Mem::store(row + j, wk);
                }
                acc = fma_(rb<BF>(wk), vv[k], acc);
            }
        }
    }
    return warp_sum(acc);
}

// Delta of hidden unit j of layer l, summed by the warp that owns it:
// (W_{l+1}^T d_{l+1})[j] * dact(a_j) from the pre-update W_{l+1}, each lane
// over i = lane, lane + 32, ... in ascending order, continuing acc from
// element i0 (the elements before it were summed by the caller).  dnext is
// in shared memory when layer l+1 is the last.
template <typename T, bool BF>
__device__ __forceinline__ T hidden_delta(const Net<T>& net, int l, const T* dnext,
                                          bool dnext_on_chip, T acc, int i0, T a_j, int j) {
    const int N1 = net.n[l + 1], M1 = net.m[l + 1];
    const T* W = net.w[l + 1];
#pragma unroll 4
    for (int i = i0; i < N1; i += 32) {
        const T d = dnext_on_chip ? dnext[i] : ld(dnext + i);
        acc = fma_(rb<BF>(ld(W + static_cast<size_t>(i) * M1 + j)), d, acc);
    }
    acc = warp_sum(acc);
    return rb<BF>(mul(rb<BF>(acc), dact<BF>(a_j)));
}

// The same for unit j of layer 0, with the first CHUNK elements a lane
// reads of W_1's column j, and a_0[j], already in col and a0: prefetch_col
// loads them right after the last forward barrier of the iteration before
// (neither changes after it), so the loads overlap the head.
template <typename T, bool BF>
__device__ __forceinline__ T delta0(const Net<T>& net, const T* dnext, bool dnext_on_chip,
                                    const T (&col)[CHUNK], T a0, int j, int lane) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
        const int i = lane + 32 * q;
        if (i < net.n[1]) acc = fma_(rb<BF>(col[q]), dnext_on_chip ? dnext[i] : ld(dnext + i), acc);
    }
    return hidden_delta<T, BF>(net, 0, dnext, dnext_on_chip, acc, lane + 32 * CHUNK, a0, j);
}

template <typename T>
__device__ __forceinline__ void prefetch_col(const Net<T>& net, const T* a, int j, int lane,
                                             T (&col)[CHUNK], T& a0) {
    if (net.layers < 2 || j >= net.n[0]) return;
#pragma unroll
    for (int q = 0; q < CHUNK; ++q) {
        const int i = lane + 32 * q;
        col[q] = i < net.n[1] ? ld(net.w[1] + static_cast<size_t>(i) * net.m[1] + j) : T(0);
    }
    a0 = ld(a + j);
}

// The head's results, broadcast to the block.
template <typename T>
struct Head {
    T dv, err;
    int guess;
};

// Every block: the output head of the forward whose last layer is in z (the
// SNN softmax, LNN's identity, ANN's sigmoid already applied), the output
// delta into s.dl, the error and the first-max argmax into hd.  The two
// serial folds (the SNN denominator and the error) are thread 0's, in
// ascending order over shared memory; everything else is spread over the
// block.  Ends with the block synchronised.
template <typename T, bool BF>
__device__ void head(const Args& a, const Smem<T>& s, const T* z, Head<T>& hd) {
    const int n = a.n_out, tid = threadIdx.x;
    if (a.kind == KIND_SNN) {
        for (int i = tid; i < n; i += blockDim.x) s.o[i] = rb<BF>(expT(rb<BF>(sub(ld(z + i), T(1)))));
        __syncthreads();
        if (tid == 0) {
            // softmax(x-1), denominator summed in order: float64 seeds it
            // with TINY (snn.c:296-334); float32 and bfloat16 add TINY after
            // the sum, as the TPU kernel's head and the plain version do
            constexpr bool seed = sizeof(T) == sizeof(double);
            T dv = seed ? T(TINY) : T(0);
            for (int i = 0; i < n; ++i) dv = add(dv, s.o[i]);
            if (!seed) dv = add(dv, T(TINY));
            hd.dv = dv;
        }
        __syncthreads();
        const T dv = hd.dv;
        for (int i = tid; i < n; i += blockDim.x) s.o[i] = rb<BF>(dvd(s.o[i], dv));
    } else {
        for (int i = tid; i < n; i += blockDim.x) s.o[i] = ld(z + i);
    }
    __syncthreads();
    // output delta: ANN (t-o)*dact(o) (ann.c:1308-1310); SNN, LNN t-o; and
    // each output's error term: SNN t*log(o+TINY) where o > 0
    // (snn.c:447-477), ANN and LNN (t-o)^2 (ann.c:1246-1275)
    for (int i = tid; i < n; i += blockDim.x) {
        const T oi = s.o[i], ti = s.t[i], diff = rb<BF>(sub(ti, oi));
        s.dl[i] = a.kind == KIND_ANN ? rb<BF>(mul(diff, dact<BF>(oi))) : diff;
        if (a.kind == KIND_SNN) {
            s.term[i] = oi > T(0) ? mul(ti, logT(add(oi, T(TINY)))) : T(0);
        } else {
            const T e = sub(ti, oi);
            s.term[i] = mul(e, e);
        }
    }
    __syncthreads();
    if (tid == 0) {
        T acc = T(0);
        int best = 0;
        T bv = s.o[0];
        for (int i = 0; i < n; ++i) {
            const T oi = s.o[i];
            if (a.kind != KIND_SNN || oi > T(0)) acc = add(acc, s.term[i]);
            if (oi > bv) {  // first maximal index (strict compare)
                bv = oi;
                best = i;
            }
        }
        hd.err = a.kind == KIND_SNN ? dvd(-acc, T(n)) : mul(T(0.5), acc);
        hd.guess = best;
    }
    __syncthreads();
}

// Per-sample state, the same in every thread of every block.
template <typename T>
struct Sample {
    T ep, init_err, dep;
    int it, p_trg, first_ok, is_ok;
};

template <typename T, bool BF, bool RES>
__global__ void __launch_bounds__(MAX_THREADS, 1)
train_epoch_kernel(Net<T> net, Args a, Plan p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ Head<T> hd;
    cg::grid_group grid = cg::this_grid();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nw = gridDim.x * p.warps;
    const int gw = blockIdx.x * p.warps + warp;
    const int L = net.layers, N0 = net.n[0], M0 = net.m[0];
    const T lr = T(a.lr), alpha = T(a.alpha), delta = T(a.delta);
    const Smem<T> s = carve<T>(smem_raw, a, p, M0, RES);

    int off[MAX_LAYERS + 1];
    off[0] = 0;
    for (int l = 0; l < L; ++l) off[l + 1] = off[l] + net.n[l];
    T* buf = static_cast<T*>(a.scratch);
    T* acts[2] = {buf, buf + off[L]};  // activations of two forwards
    T* dl = buf + 2 * off[L];          // deltas of layers 1 .. L-2

    // Row r of this warp in layer 0: W_0 row gw + r*nw, held in slot
    // warp*rows0 + r of the block's shared memory in the resident plan.
    auto w0row = [&](int r, int i) -> T* {
        return RES ? s.w0 + static_cast<size_t>(warp * p.rows0 + r) * M0
                   : net.w[0] + static_cast<size_t>(i) * M0;
    };
    auto dw0row = [&](int r, int i) -> T* {
        return RES ? s.dw0 + static_cast<size_t>(warp * p.rows0 + r) * M0
                   : net.dw[0] + static_cast<size_t>(i) * M0;
    };
    if (RES) {
        for (int r = 0, i = gw; i < N0; ++r, i += nw)
            for (int j = lane; j < M0; j += 32) w0row(r, i)[j] = ld(net.w[0] + static_cast<size_t>(i) * M0 + j);
    }

    T col[CHUNK];  // W_1's column gw and a_0[gw] for the next delta0
    T a0 = T(0);
    long long syncs = 0;  // the launch's grid barriers, counted as they are taken
    auto sync = [&]() {
        grid.sync();
        ++syncs;
    };

    // Forward phase l: every row the warp owns, updated first when upd.
    // Layer 0 reads the staged sample and, with upd and L >= 2, forms its
    // own delta from W_1's column (no barrier after the last hidden delta);
    // layers l >= 1 stage the previous and the new activations first.
    auto forward = [&](int l, bool upd, int cur, int nxt) {
        const int N = net.n[l], M = net.m[l];
        const bool last = l == L - 1;
        const T* h = s.x;
        const T* v = s.x;
        // only a block that owns rows of layer l stages its inputs
        if (l > 0 && blockIdx.x * p.warps < N) {
            if (upd) stage(s.h, acts[cur] + off[l - 1], M);
            stage(s.v, acts[nxt] + off[l - 1], M);
            __syncthreads();
            h = s.h;
            v = s.v;
        }
        T* out = acts[nxt] + off[l];
        for (int r = 0, i = gw; i < N; ++r, i += nw) {
            T di = T(0);
            if (upd) {
                if (last) di = s.dl[i];
                else if (l == 0 && r == 0)
                    di = delta0<T, BF>(net, L == 2 ? s.dl : dl + off[1], L == 2, col, a0, i, lane);
                else if (l == 0)
                    di = hidden_delta<T, BF>(net, 0, L == 2 ? s.dl : dl + off[1], L == 2, T(0),
                                             lane, ld(acts[cur] + i), i);
                else di = ld(dl + off[l] + i);
            }
            T acc;
            if (l == 0) {
                acc = RES ? row_pass<OnChip, true, T, BF>(w0row(r, i),
                                                           a.momentum ? dw0row(r, i) : nullptr, M,
                                                           upd, a.momentum, lr, alpha, di, h, v, lane)
                          : row_pass<InL2, true, T, BF>(w0row(r, i),
                                                         a.momentum ? dw0row(r, i) : nullptr, M,
                                                         upd, a.momentum, lr, alpha, di, h, v, lane);
            } else {
                acc = row_pass<InL2, false, T, BF>(
                    net.w[l] + static_cast<size_t>(i) * M,
                    a.momentum ? net.dw[l] + static_cast<size_t>(i) * M : nullptr, M, upd,
                    a.momentum, lr, alpha, di, h, v, lane);
            }
            if (lane == 0) {
                const T z = rb<BF>(acc);
                // SNN's softmax and LNN's linear head are applied by head()
                st(out + i, (last && a.kind != KIND_ANN) ? z : act<BF>(z));
            }
        }
        sync();
    };

    Sample<T> sm{};
    long long used = 0;       // iterations of the samples this launch finished
    long long iter_syncs = 0;  // grid barriers inside those iterations
    int cur = 0;   // acts[cur]: the latest forward
    for (int smp = a.start_idx; smp < a.S; ++smp) {
        if (smp > a.start_idx && used >= a.iter_budget) break;
        const T* x = static_cast<const T*>(a.xs) + static_cast<size_t>(smp) * a.n_in;
        const T* t = static_cast<const T*>(a.ts) + static_cast<size_t>(smp) * a.n_out;
        for (int i = threadIdx.x; i < a.n_in; i += blockDim.x) s.x[i] = x[i];
        for (int i = threadIdx.x; i < a.n_out; i += blockDim.x) s.t[i] = t[i];
        if (a.momentum) {  // ann_raz_momentum (ann.c:2391), each row by its owner
            for (int l = 0; l < L; ++l)
                for (int r = 0, i = gw; i < net.n[l]; ++r, i += nw) {
                    T* drow = l == 0 ? dw0row(r, i) : net.dw[l] + static_cast<size_t>(i) * net.m[l];
                    for (int j = lane; j < net.m[l]; j += 32) {
                        if (l == 0 && RES) drow[j] = T(0);
                        else st(drow + j, T(0));
                    }
                }
        }
        __syncthreads();
        // the first forward goes to the other buffer: a block still in the
        // last head of the previous sample may be reading acts[cur]
        int nxt = cur ^ 1;
        for (int l = 0; l < L; ++l) forward(l, false, cur, nxt);
        cur = nxt;
        prefetch_col(net, acts[cur], gw, lane, col, a0);
        head<T, BF>(a, s, acts[cur] + off[L - 1], hd);
        sm = Sample<T>{};
        sm.init_err = hd.err;
        sm.ep = hd.err;
        for (int i = 0; i < a.n_out; ++i)
            if (s.t[i] == T(1)) sm.p_trg = i;
        const long long syncs_before = syncs;
        while (true) {
            nxt = cur ^ 1;
            for (int l = L - 2; l >= 1; --l) {
                for (int j = gw; j < net.n[l]; j += nw) {
                    const T d = hidden_delta<T, BF>(net, l, l + 1 == L - 1 ? s.dl : dl + off[l + 1],
                                                    l + 1 == L - 1, T(0), lane,
                                                    ld(acts[cur] + off[l] + j), j);
                    if (lane == 0) st(dl + off[l] + j, d);
                }
                sync();
            }
            for (int l = 0; l < L; ++l) forward(l, true, cur, nxt);
            cur = nxt;
            prefetch_col(net, acts[cur], gw, lane, col, a0);
            head<T, BF>(a, s, acts[cur] + off[L - 1], hd);
            sm.it += 1;
            sm.dep = sub(sm.ep, hd.err);
            sm.ep = hd.err;
            sm.is_ok = a.kind == KIND_LNN || hd.guess == sm.p_trg;
            if (sm.it == 1) sm.first_ok = sm.is_ok;
            const bool cont =
                sm.it <= a.max_iter && (sm.dep > delta || !(sm.is_ok && sm.it > a.min_iter));
            if (!cont) break;
        }
        iter_syncs += syncs - syncs_before;
        used += sm.it;
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            double* row = a.stats + static_cast<size_t>(smp) * 5;
            row[0] = double(sm.init_err);
            row[1] = sm.first_ok ? 1.0 : 0.0;
            row[2] = double(sm.it);
            row[3] = double(sm.dep);
            row[4] = (sm.is_ok && sm.it > a.min_iter) ? 1.0 : 0.0;
        }
    }
    if (RES) {  // W_0's rows back to device memory
        for (int r = 0, i = gw; i < N0; ++r, i += nw)
            for (int j = lane; j < M0; j += 32) st(net.w[0] + static_cast<size_t>(i) * M0 + j, w0row(r, i)[j]);
    }
    if (a.counts && blockIdx.x == 0 && threadIdx.x == 0) {
        a.counts[0] = iter_syncs;
        a.counts[1] = syncs;
        a.counts[2] = used;
    }
}

// How many blocks of one plan's kernel an SM holds at dyn shared bytes a
// block (its static shared bytes in stat).
template <typename T, bool BF, bool RES>
cudaError_t blocks_per_sm(int warps, size_t dyn, int* fit, int* stat) {
    auto kernel = train_epoch_kernel<T, BF, RES>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *stat = static_cast<int>(attr.sharedSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(fit, kernel, 32 * warps, dyn);
}

template <typename T, bool BF, bool RES>
int launch_plan(const Net<T>& net, const Args& args, const Plan& plan, int blocks, size_t dyn,
                void* stream) {
    auto kernel = train_epoch_kernel<T, BF, RES>;
    Net<T> n = net;
    Args a = args;
    Plan p = plan;
    void* kargs[] = {&n, &a, &p};
    cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                                  dim3(32 * plan.warps), kargs, dyn,
                                                  static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The plan: one warp a row of the widest layer, in blocks of 4 warps (or
// up to 8, where 4 a block would need more blocks than the card has SMs):
// the rows of a block share one SM's shared-memory bandwidth, and more,
// smaller blocks cost more L2 traffic where they all stage the same
// vectors (on the H100, 4 warps a block was the best of 1 to 8 at XRD
// widths and within 2% of the best at MNIST's; PERF.md).  A cooperative
// launch needs every block resident at once, so where the rows outnumber
// the warps the card holds, the grid shrinks to what it holds and each
// warp takes several rows of a layer.  W_0's rows resident when they fit
// beside the staged vectors, else staged only; refused when even that
// does not fit.  force_res (0/1) overrides the choice of plan.  out =
// {blocks, resident, shared bytes a block, rows0, warps a block}.
template <typename T, bool BF>
int launch(void* const* w, void* const* dw, const int* n, const int* m, int layers,
           const Args& args, int device, void* stream, int force_res, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (layers < 1 || layers > MAX_LAYERS) return static_cast<int>(cudaErrorInvalidValue);
    int coop = 0, sms = 0, optin = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    Net<T> net{};
    int widest = 1;
    Plan plan{1, 1, 0};
    for (int l = 0; l < layers; ++l) {
        net.w[l] = static_cast<T*>(w[l]);
        net.dw[l] = args.momentum ? static_cast<T*>(dw[l]) : nullptr;
        net.n[l] = n[l];
        net.m[l] = m[l];
        if (n[l] > widest) widest = n[l];
        if (l > 0 && m[l] > plan.hmax) plan.hmax = m[l];
    }
    net.layers = layers;
    plan.warps = (widest + sms - 1) / sms;
    if (plan.warps < MIN_WARPS) plan.warps = MIN_WARPS;
    if (plan.warps > MAX_THREADS / 32) plan.warps = MAX_THREADS / 32;
    // what the kernel's static shared memory takes, with room to spare
    const size_t room = static_cast<size_t>(optin) - 64;
    const size_t item = sizeof(T);
    const size_t staged = staged_bytes(args.n_in, args.n_out, plan.hmax, item);
    int blocks = (widest + plan.warps - 1) / plan.warps;
    bool res = false;
    size_t dyn = 0;
    int fit = 0, stat = 0;
    // fewer blocks mean more rows of W_0 a warp, so more resident bytes a
    // block and perhaps fewer blocks an SM: shrink until the grid fits
    while (true) {
        const int nw = blocks * plan.warps;
        plan.rows0 = (n[0] + nw - 1) / nw;
        const size_t resident = staged + resident_bytes(plan, m[0], args.momentum, item);
        res = force_res >= 0 ? force_res == 1 : resident <= room;
        dyn = res ? resident : staged;
        if (dyn > room) {
            if (out) {  // refused: the bytes the widths need
                out[0] = blocks;
                out[1] = -1;
                out[2] = static_cast<int>(dyn);
                out[3] = plan.rows0;
                out[4] = plan.warps;
            }
            return static_cast<int>(cudaErrorInvalidValue);
        }
        err = res ? blocks_per_sm<T, BF, true>(plan.warps, dyn, &fit, &stat)
                  : blocks_per_sm<T, BF, false>(plan.warps, dyn, &fit, &stat);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (fit < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
        if (blocks <= fit * sms) break;
        blocks = fit * sms;
    }
    if (out) {
        out[0] = blocks;
        out[1] = res ? 1 : 0;
        out[2] = static_cast<int>(dyn) + stat;
        out[3] = plan.rows0;
        out[4] = plan.warps;
    }
    return res ? launch_plan<T, BF, true>(net, args, plan, blocks, dyn, stream)
               : launch_plan<T, BF, false>(net, args, plan, blocks, dyn, stream);
}

template <typename T, bool BF>
int entry(void* const* w, void* const* dw, const int* n, const int* m, int layers,
          const void* xs, const void* ts, double* stats, void* scratch, int S, int n_in,
          int n_out, int kind, int momentum, double lr, double alpha, double delta,
          int min_iter, int max_iter, int start_idx, int iter_budget, int device,
          void* stream, int force_res, int* out, long long* counts) {
    Args a{xs, ts, stats, scratch, counts, S, n_in, n_out, kind, momentum, lr, alpha, delta,
           min_iter, max_iter, start_idx, iter_budget};
    return launch<T, BF>(w, dw, n, m, layers, a, device, stream, force_res, out);
}

}  // namespace

extern "C" {

#define HPNN_TRAIN_ENTRY(NAME, PLANNED, T, BF)                                           \
    int NAME(void* const* w, void* const* dw, const int* n, const int* m, int layers,  \
             const void* xs, const void* ts, double* stats, void* scratch, int* ctl,    \
             int S, int n_in, int n_out, int kind, int momentum, double lr,            \
             double alpha, double delta, int min_iter, int max_iter, int start_idx,     \
             int iter_budget, int device, void* stream, int* grid_out) {                \
        int out[5] = {0, 0, 0, 0, 0};                                                   \
        const int rc = entry<T, BF>(w, dw, n, m, layers, xs, ts, stats, scratch, S, n_in, \
                                    n_out, kind, momentum, lr, alpha, delta, min_iter,  \
                                    max_iter, start_idx, iter_budget, device, stream,   \
                                    -1, out, nullptr);                                  \
        if (grid_out) *grid_out = out[0];                                               \
        return rc;                                                                      \
    }                                                                                   \
    int PLANNED(void* const* w, void* const* dw, const int* n, const int* m, int layers, \
                const void* xs, const void* ts, double* stats, void* scratch, int S,    \
                int n_in, int n_out, int kind, int momentum, double lr, double alpha,  \
                double delta, int min_iter, int max_iter, int start_idx,               \
                int iter_budget, int device, void* stream, int force_res,              \
                int* plan_out, long long* counts) {                                     \
        return entry<T, BF>(w, dw, n, m, layers, xs, ts, stats, scratch, S, n_in, n_out, \
                            kind, momentum, lr, alpha, delta, min_iter, max_iter,       \
                            start_idx, iter_budget, device, stream, force_res,          \
                            plan_out, counts);                                          \
    }

HPNN_TRAIN_ENTRY(hpnn_train_epoch_f64, hpnn_train_epoch_plan_f64, double, false)
HPNN_TRAIN_ENTRY(hpnn_train_epoch_f32, hpnn_train_epoch_plan_f32, float, false)
HPNN_TRAIN_ENTRY(hpnn_train_epoch_bf16, hpnn_train_epoch_plan_bf16, float, true)

const char* hpnn_train_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
