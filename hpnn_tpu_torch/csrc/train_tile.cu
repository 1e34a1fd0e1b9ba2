// train_tile: one epoch of batched-tile train-to-convergence on Hopper, in
// one cooperative launch.
//
// Replaces the Pallas TPU kernel hpnn_tpu/ops/convergence_tile.py
// _kernel_tile (body _group_loop), launched by _tiled_epoch_pallas_impl.
// Its resume pair (start_group, group_budget) lets the host split an epoch
// into launches of whole groups.
//
// What it computes (hpnn_tpu/ops/convergence_tile.py:163-353): the samples
// split into consecutive groups of `tile` rows (the last one ragged: its
// missing lanes are never trained); groups run in order, the weights
// carrying over.  Per group: zero dw under BPM; the forward of every lane;
// init_err and p_trg (the last index with t == 1, default 0) per lane; then
// lockstep iterations until every lane is dead.  Per iteration every live
// lane's deltas come from the pre-update weights; each layer then takes one
// update summed over the live lanes (g = sum_s d_s (x) h_s, W += lr*g for
// BP, dw += lr*g; W += dw; dw *= alpha for BPM); then each live lane's fresh
// forward, error, dEp = ep - epr, first-max argmax against p_trg (LNN:
// is_ok = true) and stop test it <= MAX && (dEp > delta || !(is_ok && it >
// MIN)).  A lane's n_iter, final dEp and is_ok freeze at the iteration it
// stops; first_ok is latched at lockstep iteration 1.  One float64 stats row
// per sample (init_err, first_ok, n_iter, final_dep, success); rows of groups
// the launch does not train keep what the caller put there.
//
// What bounds it on the H100: per lockstep iteration with S live lanes the
// net does about 4*S*P + 2*S*P_hidden + 2*P flops for BP (BPM adds about
// 3P; P the weight count): 31 MFLOP at MNIST 784-300-10 and S = 32, half a
// microsecond at the float64 peak, and moves no bytes to device memory if
// the weights stay on chip.  The iterations are sequential, so what bounds
// this kernel is the latency of its 2L+1 grid-wide barriers per iteration
// and the L2 traffic of the lane products between them (PERF.md).
//
// Design (a simple kernel that is right; train_epoch.cu's design with a
// lane axis):
// * one cooperative launch, no more blocks than can be resident at once;
//   phases meet at cooperative_groups grid barriers: L-1 hidden-delta
//   phases, one update phase, L forward phases, one decision phase;
// * all data the launch writes (weights, momentum, activations, deltas,
//   lane state) lives in device memory (L2 at these sizes) and is read with
//   ld.global.cg, so no block sees a stale L1 line another block wrote;
// * block 0 keeps the list of live lanes in ascending order; every phase
//   walks it, so dead lanes cost nothing and the ragged tail's missing lanes
//   are never touched;
// * hidden deltas: a warp takes one column j for up to LPT lanes, summing
//   from the pre-update weights; forward: a warp takes one row i for up to
//   LPT lanes, after the update phase.  Each lane's dot product is summed
//   lane-strided in ascending order and then by a fixed xor butterfly, the
//   order of train_epoch.cu, so a lane's sums do not depend on which other
//   lanes are live or how many lanes the group has;
// * update: one thread per weight, the live lanes' products summed in
//   ascending lane order starting from the first live lane's product (no
//   atomics); at one lane this is train_epoch.cu's lr * (d_i * h_j);
// * block 0, one warp per lane, computes the output head, the error, the
//   argmax, the output delta and the stop test, and publishes the live list
//   before the barrier that every block reads it after: all blocks take the
//   same branch, so none skips a barrier.
// These give three contracts, checked on the card by chip_smoke.py: tile=1
// equals train_epoch.cu bit for bit (weights and stats) for ANN and LNN at
// every dtype and for SNN at float32/bfloat16; a group's masked lanes are
// inert (a ragged tail equals its real rows trained alone); and launches of
// a few groups equal one launch bit for bit.  float64 SNN is the exception
// to the first: the tile head sums exp(z-1) and adds TINY last
// (convergence_tile.py:203-205), where the per-sample float64 head seeds the
// sum with TINY, as the JAX package's two engines differ too; at float64 SNN
// this kernel is held to the tile module's plain version instead.
//
// Types: AT is the activation and error type (double, or float, with
// bfloat16 activations held as float and rounded where the TPU kernel
// rounds); WT the resident weight type (double, float or bfloat16); ADD the
// type the update is added in (and dw's type):
//   f64 storage None: AT double, WT double, ADD double
//   f32 storage None: AT float,  WT float,  ADD float
//   bf16 storage None: AT float (bf16), WT float (masters), ADD float
//   f32 / bf16 storage "bf16": WT bf16, ADD float (rounded with
//     __float2bfloat16_rn after the add)
//   f32 storage "f32": WT float, ADD double (lr*g in float, then widened)
//   f64 storage "f32": AT double, WT float, ADD double
// Matrix-vector operands are the weights rounded to the activation type,
// summed in float (double at float64) and rounded to the activation type;
// the update products are summed in float (double at float64).  This file is
// built without --use_fast_math; the update and the error sums use explicit
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs.
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
constexpr int LPT = 4;           // lanes a warp sums at once (one weight read)
constexpr int LIST_SMEM = 1024;  // live lists up to this long are staged in shared memory
constexpr int KIND_ANN = 0;
constexpr int KIND_SNN = 1;
constexpr int KIND_LNN = 2;
constexpr double TINY = 1e-14;  // include/libhpnn/common.h:79

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

// resident weights: loaded and stored through these, whatever their type
__device__ __forceinline__ double wload(const double* p) { return __ldcg(p); }
__device__ __forceinline__ float wload(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float wload(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void wstore(double* p, double v) { __stcg(p, v); }
__device__ __forceinline__ void wstore(float* p, double v) { __stcg(p, __double2float_rn(v)); }
__device__ __forceinline__ void wstore(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void wstore(__nv_bfloat16* p, float v) {
    __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename WT, typename ADD>
struct Net {
    WT* w[MAX_LAYERS];    // resident weights (n[l], m[l]), updated in place
    ADD* dw[MAX_LAYERS];  // BPM momentum (same shapes), or null under BP
    int n[MAX_LAYERS];
    int m[MAX_LAYERS];
    int layers;
};

struct Args {
    const void* xs;   // (S, n_in) in AT
    const void* ts;   // (S, n_out) in AT
    double* stats;    // (S, 5)
    void* scratch;    // AT: 3 * tile * sum(n) + tile * n_out + 3 * tile
    int* lanes;       // int: 6 * tile + 1
    int S, n_in, n_out, kind, momentum, tile;
    double lr, alpha, delta;
    int min_iter, max_iter, start_group, group_budget;
};

// Where a phase finds lane k of the live list: the group's identity list
// (count lanes from 0) or the list block 0 published, staged in shared
// memory when it fits.
struct Lanes {
    const int* glob;  // null: identity
    const int* smem;  // null: read glob
    int count;
    __device__ __forceinline__ int operator[](int k) const {
        if (!glob) return k;
        return smem ? smem[k] : __ldcg(glob + k);
    }
};

// Forward phase of layer l for the listed lanes: warp task (row i, up to
// LPT lanes); z = sum_j W[i][j] * v_s[j] for each lane, then the hidden
// activation (or, on the last layer, ANN's; SNN's softmax and LNN's linear
// head are applied by block 0).  v of lane s is vin + s * vstride.
template <typename AT, bool BF, typename WT, typename ADD>
__device__ void forward_phase(const Net<WT, ADD>& net, int l, const Lanes& lanes,
                              const AT* vin, size_t vstride, AT* out, size_t ostride,
                              bool last, int kind, int gw, int nw, int lane) {
    const int N = net.n[l], M = net.m[l];
    const WT* W = net.w[l];
    const int chunks = (lanes.count + LPT - 1) / LPT;
    const long long tasks = static_cast<long long>(N) * chunks;
    for (long long t = gw; t < tasks; t += nw) {
        const int i = static_cast<int>(t / chunks);
        const int k0 = static_cast<int>(t % chunks) * LPT;
        const int kn = min(LPT, lanes.count - k0);
        int s[LPT];
        AT acc[LPT];
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            s[k] = k < kn ? lanes[k0 + k] : 0;
            acc[k] = AT(0);
        }
        const WT* row = W + static_cast<size_t>(i) * M;
        for (int j = lane; j < M; j += 32) {
            const AT w = rb<BF>(static_cast<AT>(wload(row + j)));
#pragma unroll
            for (int k = 0; k < LPT; ++k)
                if (k < kn) acc[k] = fma_(w, ld(vin + s[k] * vstride + j), acc[k]);
        }
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            if (k >= kn) break;
            const AT z = rb<BF>(warp_sum(acc[k]));
            if (lane == 0) st(out + s[k] * ostride + i, (last && kind != KIND_ANN) ? z : act<BF>(z));
        }
    }
}

// Hidden delta of layer l for the listed lanes: warp task (column j, up to
// LPT lanes); d_l[j] = (W_{l+1}^T d_{l+1})[j] * dact(a_l[j]) from the
// pre-update W_{l+1}.  Lane s's vectors are at base + s * stride.
template <typename AT, bool BF, typename WT, typename ADD>
__device__ void delta_phase(const Net<WT, ADD>& net, int l, const Lanes& lanes,
                            const AT* a, const AT* dnext, AT* dl, size_t stride,
                            int gw, int nw, int lane) {
    const int N1 = net.n[l + 1], M1 = net.m[l + 1];
    const WT* W = net.w[l + 1];
    const int chunks = (lanes.count + LPT - 1) / LPT;
    const long long tasks = static_cast<long long>(M1) * chunks;
    for (long long t = gw; t < tasks; t += nw) {
        const int j = static_cast<int>(t / chunks);
        const int k0 = static_cast<int>(t % chunks) * LPT;
        const int kn = min(LPT, lanes.count - k0);
        int s[LPT];
        AT acc[LPT];
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            s[k] = k < kn ? lanes[k0 + k] : 0;
            acc[k] = AT(0);
        }
        for (int i = lane; i < N1; i += 32) {
            const AT w = rb<BF>(static_cast<AT>(wload(W + static_cast<size_t>(i) * M1 + j)));
#pragma unroll
            for (int k = 0; k < LPT; ++k)
                if (k < kn) acc[k] = fma_(w, ld(dnext + s[k] * stride + i), acc[k]);
        }
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
            if (k >= kn) break;
            const AT sum = rb<BF>(warp_sum(acc[k]));
            if (lane == 0) {
                const size_t at = s[k] * stride + j;
                st(dl + at, rb<BF>(mul(sum, dact<BF>(ld(a + at)))));
            }
        }
    }
}

// Update phase: one thread per weight of every layer.  g = the live lanes'
// d_s[i] * h_s[j] summed in ascending lane order from the first live lane's
// product; BP W += lr*g; BPM dw += lr*g; W += dw; dw *= alpha; the add in
// ADD, then rounded to the resident type.
template <typename AT, typename WT, typename ADD>
__device__ void update_phase(const Net<WT, ADD>& net, const Lanes& lanes, const AT* x,
                             size_t xstride, const AT* acts, const AT* dl, size_t stride,
                             const int* off, bool momentum, AT lr, ADD alpha, int gtid,
                             int nthreads) {
    for (int l = 0; l < net.layers; ++l) {
        const int N = net.n[l], M = net.m[l];
        const long long cnt = static_cast<long long>(N) * M;
        const AT* h = l ? acts + off[l - 1] : x;
        const size_t hstride = l ? stride : xstride;
        const AT* d = dl + off[l];
        WT* W = net.w[l];
        ADD* DW = net.dw[l];
        for (long long e = gtid; e < cnt; e += nthreads) {
            const int i = static_cast<int>(e / M), j = static_cast<int>(e % M);
            AT g = AT(0);
            // LPT lanes' operands loaded together, then summed in lane order
            for (int k0 = 0; k0 < lanes.count; k0 += LPT) {
                const int kn = min(LPT, lanes.count - k0);
                AT dv[LPT], hv[LPT];
#pragma unroll
                for (int k = 0; k < LPT; ++k) {
                    if (k < kn) {
                        const int s = lanes[k0 + k];
                        dv[k] = ld(d + s * stride + i);
                        hv[k] = ld(h + s * hstride + j);
                    }
                }
#pragma unroll
                for (int k = 0; k < LPT; ++k) {
                    if (k < kn) {
                        const AT p = mul(dv[k], hv[k]);
                        g = k0 + k ? add(g, p) : p;
                    }
                }
            }
            const ADD step = static_cast<ADD>(mul(lr, g));
            const ADD w = static_cast<ADD>(wload(W + e));
            if (momentum) {
                const ADD s2 = add(ld(DW + e), step);
                wstore(W + e, add(w, s2));
                st(DW + e, mul(alpha, s2));
            } else {
                wstore(W + e, add(w, step));
            }
        }
    }
}

// Per-lane state, in device memory, owned by block 0.
template <typename AT>
struct LaneState {
    AT* ep;         // error of the lane's current forward
    AT* init;       // init_err
    AT* dep;        // dEp, frozen at the lane's exit
    int* live;      // 1 while the lane trains
    int* list;      // the live lanes in ascending order
    int* n_it;      // n_iter, frozen at exit
    int* p_trg;
    int* ok;        // is_ok of the last iteration the lane ran
    int* first_ok;
    int* count;     // length of list
};

// Block 0, one warp per lane: the output head of lane s's forward, its
// error (returned on lane 0 of the warp), argmax (*guess on lane 0) and
// output delta.  z, o and dL are the lane's vectors.
template <typename AT, bool BF>
__device__ AT head_and_error(const Args& a, const AT* t, const AT* z, AT* o, AT* dL,
                             int* guess, int lane) {
    const int n = a.n_out;
    if (a.kind == KIND_SNN) {
        for (int i = lane; i < n; i += 32) st(o + i, rb<BF>(expT(rb<BF>(sub(ld(z + i), AT(1))))));
        __syncwarp();
        AT dv = AT(0);
        if (lane == 0) {
            // softmax(x-1): exp(z-1) summed in order, TINY added last
            // (hpnn_tpu/ops/convergence_tile.py:203-205)
            for (int i = 0; i < n; ++i) dv = add(dv, ld(o + i));
            dv = add(dv, AT(TINY));
        }
        dv = __shfl_sync(0xffffffffu, dv, 0);
        for (int i = lane; i < n; i += 32) st(o + i, rb<BF>(dvd(ld(o + i), dv)));
    } else {
        for (int i = lane; i < n; i += 32) st(o + i, ld(z + i));
    }
    __syncwarp();
    // output delta: ANN (t-o)*dact(o) (ann.c:1308-1310); SNN, LNN t-o
    for (int i = lane; i < n; i += 32) {
        const AT oi = ld(o + i), diff = rb<BF>(sub(t[i], oi));
        st(dL + i, a.kind == KIND_ANN ? rb<BF>(mul(diff, dact<BF>(oi))) : diff);
    }
    AT err = AT(0);
    if (lane == 0) {
        AT acc = AT(0);
        int best = 0;
        AT bv = ld(o);
        for (int i = 0; i < n; ++i) {
            const AT oi = ld(o + i);
            if (a.kind == KIND_SNN) {
                // -(1/N) sum_{o>0} t*log(o+TINY) (snn.c:447-477)
                if (oi > AT(0)) acc = add(acc, mul(t[i], logT(add(oi, AT(TINY)))));
            } else {
                // 0.5*sum((t-o)^2) (ann.c:1246-1275)
                const AT diff = sub(t[i], oi);
                acc = add(acc, mul(diff, diff));
            }
            if (oi > bv) {  // first maximal index (strict compare)
                bv = oi;
                best = i;
            }
        }
        err = a.kind == KIND_SNN ? dvd(-acc, AT(n)) : mul(AT(0.5), acc);
        *guess = best;
    }
    return err;
}

template <typename AT, bool BF, typename WT, typename ADD>
__global__ void __launch_bounds__(THREADS)
train_tile_kernel(Net<WT, ADD> net, Args a) {
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int nw = gridDim.x * WARPS;
    const int gw = blockIdx.x * WARPS + warp;
    const int gtid = blockIdx.x * THREADS + threadIdx.x;
    const int nthreads = gridDim.x * THREADS;
    const bool lead = blockIdx.x == 0;
    const int L = net.layers;
    const int T = a.tile;
    const AT lr = AT(a.lr), delta = AT(a.delta);
    const ADD alpha = ADD(a.alpha);
    __shared__ int slist[LIST_SMEM];

    int off[MAX_LAYERS + 1];
    off[0] = 0;
    for (int l = 0; l < L; ++l) off[l + 1] = off[l] + net.n[l];
    const size_t stride = off[L];  // one lane's activations or deltas
    AT* buf = static_cast<AT*>(a.scratch);
    AT* acts[2] = {buf, buf + T * stride};
    AT* dl = buf + 2 * T * stride;
    AT* o = buf + 3 * T * stride;  // T * n_out: the output heads
    LaneState<AT> ls;
    ls.ep = o + static_cast<size_t>(T) * a.n_out;
    ls.init = ls.ep + T;
    ls.dep = ls.init + T;
    ls.live = a.lanes;
    ls.list = ls.live + T;
    ls.n_it = ls.list + T;
    ls.p_trg = ls.n_it + T;
    ls.ok = ls.p_trg + T;
    ls.first_ok = ls.ok + T;
    ls.count = ls.first_ok + T;

    const int G = (a.S + T - 1) / T;
    const long long g_end = min(static_cast<long long>(G),
                                static_cast<long long>(a.start_group) + a.group_budget);
    for (int g = a.start_group; g < g_end; ++g) {
        const int r0 = g * T;
        const int nreal = min(T, a.S - r0);
        const AT* xg = static_cast<const AT*>(a.xs) + static_cast<size_t>(r0) * a.n_in;
        const AT* tg = static_cast<const AT*>(a.ts) + static_cast<size_t>(r0) * a.n_out;
        if (a.momentum) {  // momentum zeroes at group entry (ann.c:2391)
            for (int l = 0; l < L; ++l) {
                const size_t cnt = static_cast<size_t>(net.n[l]) * net.m[l];
                for (size_t k = gtid; k < cnt; k += nthreads) st(net.dw[l] + k, ADD(0));
            }
        }
        const Lanes all{nullptr, nullptr, nreal};
        int cur = 0;
        for (int l = 0; l < L; ++l) {
            forward_phase<AT, BF>(net, l, all, l ? acts[cur] + off[l - 1] : xg,
                                  l ? stride : a.n_in, acts[cur] + off[l], stride,
                                  l == L - 1, a.kind, gw, nw, lane);
            grid.sync();
        }
        if (lead) {
            for (int s = warp; s < nreal; s += WARPS) {
                const AT* t = tg + static_cast<size_t>(s) * a.n_out;
                int guess = 0;
                const AT err = head_and_error<AT, BF>(
                    a, t, acts[cur] + s * stride + off[L - 1], o + s * a.n_out,
                    dl + s * stride + off[L - 1], &guess, lane);
                if (lane == 0) {
                    int p = 0;
                    for (int i = 0; i < a.n_out; ++i)
                        if (t[i] == AT(1)) p = i;
                    st(ls.init + s, err);
                    st(ls.ep + s, err);
                    st(ls.p_trg + s, p);
                    st(ls.live + s, 1);
                    st(ls.list + s, s);
                }
            }
            if (threadIdx.x == 0) st(ls.count, nreal);
        }
        grid.sync();
        int it = 0;
        while (true) {
            const int count = ld(ls.count);
            if (count == 0) break;
            const bool staged = count <= LIST_SMEM;
            if (staged) {
                for (int k = threadIdx.x; k < count; k += THREADS) slist[k] = ld(ls.list + k);
                __syncthreads();
            }
            const Lanes live{ls.list, staged ? slist : nullptr, count};
            for (int l = L - 2; l >= 0; --l) {
                delta_phase<AT, BF>(net, l, live, acts[cur] + off[l], dl + off[l + 1],
                                    dl + off[l], stride, gw, nw, lane);
                grid.sync();
            }
            update_phase<AT>(net, live, xg, a.n_in, acts[cur], dl, stride, off,
                             a.momentum != 0, lr, alpha, gtid, nthreads);
            grid.sync();
            const int nxt = cur ^ 1;
            for (int l = 0; l < L; ++l) {
                forward_phase<AT, BF>(net, l, live, l ? acts[nxt] + off[l - 1] : xg,
                                      l ? stride : a.n_in, acts[nxt] + off[l], stride,
                                      l == L - 1, a.kind, gw, nw, lane);
                grid.sync();
            }
            cur = nxt;
            it += 1;
            if (lead) {
                for (int k = warp; k < count; k += WARPS) {
                    const int s = live[k];
                    const AT* t = tg + static_cast<size_t>(s) * a.n_out;
                    int guess = 0;
                    const AT epr = head_and_error<AT, BF>(
                        a, t, acts[cur] + s * stride + off[L - 1], o + s * a.n_out,
                        dl + s * stride + off[L - 1], &guess, lane);
                    if (lane == 0) {
                        const AT dep = sub(ld(ls.ep + s), epr);
                        const int ok = a.kind == KIND_LNN || guess == ld(ls.p_trg + s);
                        st(ls.ep + s, epr);
                        st(ls.dep + s, dep);
                        st(ls.n_it + s, it);
                        st(ls.ok + s, ok);
                        if (it == 1) st(ls.first_ok + s, ok);
                        const bool cont = it <= a.max_iter &&
                                          (dep > delta || !(ok && it > a.min_iter));
                        st(ls.live + s, cont ? 1 : 0);
                    }
                }
                __syncthreads();
                if (threadIdx.x == 0) {
                    // the next list: the lanes still live, in ascending order
                    int n = 0;
                    for (int k = 0; k < count; ++k) {
                        const int s = live[k];
                        if (ld(ls.live + s)) st(ls.list + n++, s);
                    }
                    st(ls.count, n);
                    if (n == 0) {
                        for (int s = 0; s < nreal; ++s) {
                            double* row = a.stats + static_cast<size_t>(r0 + s) * 5;
                            const int n_it = ld(ls.n_it + s), ok = ld(ls.ok + s);
                            row[0] = double(ld(ls.init + s));
                            row[1] = ld(ls.first_ok + s) ? 1.0 : 0.0;
                            row[2] = double(n_it);
                            row[3] = double(ld(ls.dep + s));
                            row[4] = (ok && n_it > a.min_iter) ? 1.0 : 0.0;
                        }
                    }
                }
            }
            grid.sync();
        }
    }
}

template <typename AT, bool BF, typename WT, typename ADD>
int launch(void* const* w, void* const* dw, const int* n, const int* m, int layers,
           const Args& args, int device, void* stream, int* grid_out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (layers < 1 || layers > MAX_LAYERS || args.tile < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, train_tile_kernel<AT, BF, WT, ADD>, THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    Net<WT, ADD> net{};
    long long widest = 1;
    const long long chunks = (args.tile + LPT - 1) / LPT;
    for (int l = 0; l < layers; ++l) {
        net.w[l] = static_cast<WT*>(w[l]);
        net.dw[l] = args.momentum ? static_cast<ADD*>(dw[l]) : nullptr;
        net.n[l] = n[l];
        net.m[l] = m[l];
        if (n[l] > widest) widest = n[l];
    }
    net.layers = layers;
    // one warp per (row, lane chunk) of the widest layer, and at least two
    // blocks an SM for the update phase's one thread a weight; no more
    // blocks than can be resident together (a cooperative launch requires it)
    long long want = (widest * chunks + WARPS - 1) / WARPS;
    if (want < 2LL * sms) want = 2LL * sms;
    const long long cap = static_cast<long long>(per_sm) * sms;
    int blocks = static_cast<int>(want < cap ? want : cap);
    if (blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    if (grid_out) *grid_out = blocks;
    Args a = args;
    void* kargs[] = {&net, &a};
    err = cudaLaunchCooperativeKernel((const void*)train_tile_kernel<AT, BF, WT, ADD>,
                                      dim3(blocks), dim3(THREADS), kargs, 0,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define HPNN_TILE_ENTRY(NAME, AT, BF, WT, ADD)                                          \
    int NAME(void* const* w, void* const* dw, const int* n, const int* m, int layers,  \
             const void* xs, const void* ts, double* stats, void* scratch, int* lanes,  \
             int S, int n_in, int n_out, int kind, int momentum, int tile, double lr,   \
             double alpha, double delta, int min_iter, int max_iter, int start_group,   \
             int group_budget, int device, void* stream, int* grid_out) {               \
        Args a{xs, ts, stats, scratch, lanes, S, n_in, n_out, kind, momentum, tile, lr, \
               alpha, delta, min_iter, max_iter, start_group, group_budget};            \
        return launch<AT, BF, WT, ADD>(w, dw, n, m, layers, a, device, stream,          \
                                       grid_out);                                       \
    }

HPNN_TILE_ENTRY(hpnn_train_tile_f64, double, false, double, double)
HPNN_TILE_ENTRY(hpnn_train_tile_f64_w32, double, false, float, double)
HPNN_TILE_ENTRY(hpnn_train_tile_f32, float, false, float, float)
HPNN_TILE_ENTRY(hpnn_train_tile_f32_wbf16, float, false, __nv_bfloat16, float)
HPNN_TILE_ENTRY(hpnn_train_tile_f32_w32, float, false, float, double)
HPNN_TILE_ENTRY(hpnn_train_tile_bf16, float, true, float, float)
HPNN_TILE_ENTRY(hpnn_train_tile_bf16_wbf16, float, true, __nv_bfloat16, float)

const char* hpnn_train_tile_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
