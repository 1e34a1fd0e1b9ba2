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
// 3P; P the weight count): 31 MFLOP at MNIST 784-300-10 and S = 32.  The
// iterations are sequential, and within one the layers are, so the time
// goes to grid barriers (about 1.2 us each), the L2 round trips after them,
// and in the layer-0 phase to the SM's shared-memory bandwidth and FP64
// pipe: every block that owns rows of W_0 reads every live lane's input
// twice an iteration (the update's sum over lanes, then the forward).
// PERF.md has the times against the first kernel of this file, the bound
// and the phase split (scripts/torch_compare_tile.py, chip_smoke.py).
//
// Design (train_epoch.cu's, carried to a lane axis):
// * one cooperative launch of at most one block an SM, 8 warps; row i of
//   layer l belongs to block i mod G (slot i / G), whose warps share its
//   work;
// * 2L - 2 grid barriers a lockstep iteration for L >= 2 layers (1 for
//   L = 1): one after each hidden-delta phase of layers L-2 .. 1 and one
//   after each layer phase.  A layer phase is the update fused into the
//   row owner's forward: the block first forms, for each of its rows, g =
//   the live lanes' d_s[i] * h_s[j] summed in ascending lane order from the
//   first live lane's product (mul, then add: never contracted) and applies
//   BP or BPM to the row in the add type, then sums the updated row against
//   every live lane's new input.  h is the previous forward's activations,
//   v the new ones: the two activation buffers alternate, so no block
//   overwrites what a slower one still reads.  The delta of layer 0 is
//   formed in the layer-0 phase by the owner of its row of W_0, from W_1's
//   column (loaded with the head's outputs right after the iteration's last
//   barrier, before anyone updates W_1) against d_1;
// * the head, the stop test and the live list in every block: after the
//   last barrier of an iteration each block stages the live lanes' outputs
//   and computes the softmax, the output deltas, the error and the first-max
//   argmax of every live lane (the serial folds one thread a lane, the
//   argmax in another warp than the error), the stop tests and the next
//   ascending live list (warp ballots), from the same bits, so every block
//   takes the same branch and no barrier waits for a decision.  Per-lane
//   state is each block's own copy; block 0 alone writes the stats rows;
// * where the data lives is a plan chosen on the host (convergence_tile_
//   kernel.py tile_plan): the block's scratch -- the lane state, the rows'
//   deltas (lane-major, so one vector load gives a lane's rows), the
//   block's a_0 and W_1's columns -- in shared memory where it fits beside
//   one lane's input (the kernel's SC = true), else all of it in the
//   block's own slice of a device workspace (SC = false: wide layers at
//   large tiles); then, where they fit, the head's vectors, the group's
//   targets, W_0's rows of the block (written back to W_0 when the launch
//   ends), the group's inputs (staged once a group; else staged in lane
//   chunks for each forward and read in place by the update), dw_0's rows.
//   What does not fit lives in the workspace slice (head) or in place
//   (targets, W_0, dw_0).  Layers l >= 1 stay in device memory and are
//   read with ld.global.cg: other SMs read their columns, and a stale L1
//   line would be a silent wrong answer.  Only an input layer so wide that
//   one lane's input does not fit in shared memory is refused;
// * the work of a phase, in register tiles sized to it: the forward of
//   layer 0 as warp tasks of the block's rows (up to 3) x 8 lanes (2 where
//   8 would leave most warps idle), of layers l >= 1 as rows (up to 2) x 4
//   lanes; the update as 3 elements a thread x 4 lanes at a time (through
//   L2: 1 element x 16 lanes, 4 when fewer live); the whole iterations of a
//   loop carry no guard, the rest is guarded;
// * nothing in local memory: grid.sync()'s fence drops L1, so a spilled
//   register or a stack array read after a barrier is an L2 round trip
//   (the build must report a 0-byte stack frame);
// * dead lanes cost nothing: every phase walks the live list;
// * each dot product is summed lane-strided (element j by thread j mod 32,
//   ascending) and then by a fixed xor butterfly (its shuffles written as
//   PTX, or the same adds in one thread where a sum has at most 32
//   elements), each head fold serially in ascending order, each update sum
//   in ascending lane order: the orders of the first kernel of this file,
//   so a lane's sums do not depend on which other lanes are live, which
//   block, warp or plan forms them, and every result is bit-identical to
//   that kernel's.
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
// C interface (loaded with ctypes): hpnn_train_tile_limits reports the
// card's SMs and shared bytes a block; each entry takes the plan as an int64
// array (its layout is Plan below), returns cudaGetLastError() after the
// launch (or the error of a refused launch; out[0] gets the blocks an SM
// holds at the plan) and, given a device array of three int64, has block 0
// write there the grid barriers it took inside lockstep iterations, all the
// barriers it took, and the lockstep iterations.  The launch is
// asynchronous on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int MAX_THREADS = 256;
constexpr int DB = 8;  // lanes a warp task of a delta sums at once
constexpr int FB = 8;  // elements a head fold loads together
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

// How data is read and written: Coh for what other blocks write during the
// launch (activations, hidden deltas, the layers l >= 1), through L2; Own
// for the block's own data (in shared memory or its own rows and slice of
// device memory) and the launch's read-only inputs.
struct Coh {
    template <typename T>
    static __device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }
    template <typename T>
    static __device__ __forceinline__ void st(T* p, T v) { __stcg(p, v); }
};
struct Own {
    template <typename T>
    static __device__ __forceinline__ T ld(const T* p) { return *p; }
    template <typename T>
    static __device__ __forceinline__ void st(T* p, T v) { *p = v; }
};
// Shm for data the plan keeps in shared memory: ld.shared / st.shared,
// where a generic pointer would take the generic path.
__device__ __forceinline__ unsigned sa(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
struct Shm {
    static __device__ __forceinline__ double ld(const double* p) {
        double v;
        asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(sa(p)));
        return v;
    }
    static __device__ __forceinline__ float ld(const float* p) {
        float v;
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(sa(p)));
        return v;
    }
    static __device__ __forceinline__ int ld(const int* p) {
        int v;
        asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(sa(p)));
        return v;
    }
    static __device__ __forceinline__ unsigned short ld(const unsigned short* p) {
        unsigned short v;
        asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(sa(p)));
        return v;
    }
    static __device__ __forceinline__ void st(double* p, double v) {
        asm volatile("st.shared.f64 [%0], %1;" ::"r"(sa(p)), "d"(v) : "memory");
    }
    static __device__ __forceinline__ void st(float* p, float v) {
        asm volatile("st.shared.f32 [%0], %1;" ::"r"(sa(p)), "f"(v) : "memory");
    }
    static __device__ __forceinline__ void st(unsigned short* p, unsigned short v) {
        asm volatile("st.shared.u16 [%0], %1;" ::"r"(sa(p)), "h"(v) : "memory");
    }
};

// resident weights: read and written through these, whatever their type
template <class M>
__device__ __forceinline__ double wget(const double* p) { return M::ld(p); }
template <class M>
__device__ __forceinline__ float wget(const float* p) { return M::ld(p); }
template <class M>
__device__ __forceinline__ float wget(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(M::ld(reinterpret_cast<const unsigned short*>(p))));
}
template <class M>
__device__ __forceinline__ void wput(double* p, double v) { M::st(p, v); }
template <class M>
__device__ __forceinline__ void wput(float* p, double v) { M::st(p, __double2float_rn(v)); }
template <class M>
__device__ __forceinline__ void wput(float* p, float v) { M::st(p, v); }
template <class M>
__device__ __forceinline__ void wput(__nv_bfloat16* p, float v) {
    M::st(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// The xor butterfly of the first kernel of this file (v += shfl_xor(v, off),
// off = 16 .. 1), its shuffles written as PTX: every lane of the warp
// reaches them, and __shfl_xor_sync in code the compiler cannot prove
// convergent is lowered with a collective fallback around each one.
__device__ __forceinline__ float bfly(float v, int off) {
    float r;
    asm volatile("shfl.sync.bfly.b32 %0, %1, %2, 0x1f, 0xffffffff;" : "=f"(r) : "f"(v), "r"(off));
    return r;
}
__device__ __forceinline__ double bfly(double v, int off) {
    int lo = __double2loint(v), hi = __double2hiint(v);
    asm volatile("shfl.sync.bfly.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(lo) : "r"(off));
    asm volatile("shfl.sync.bfly.b32 %0, %0, %1, 0x1f, 0xffffffff;" : "+r"(hi) : "r"(off));
    return __hiloint2double(hi, lo);
}
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += bfly(v, off);
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
    const void* xs;       // (S, n_in) in AT
    const void* ts;       // (S, n_out) in AT
    double* stats;        // (S, 5)
    void* scratch;        // AT: 3 * lanes * sum(n): two forwards' activations, hidden deltas
    unsigned char* ws;    // blocks * ws_stride bytes: each block's slice
    long long* counts;    // (3,) or null: grid barriers in iterations, in all; iterations
    int S, n_in, n_out, kind, momentum, tile;
    double lr, alpha, delta;
    int min_iter, max_iter, start_group, group_budget;
};

// The regions of a block's data, each in shared memory or (not on chip) in
// the block's workspace slice, the first five (the block's scratch) all in
// one or the other; T, W0, DW0 not on chip are read in place.
// rows0 is the most rows of layer 0 a block owns (the plan's rows[0]).
enum Region {
    R_STATE_AT,   // ep, init, dep, err, the SNN denominator: 5 * lanes AT
    R_STATE_INT,  // n_it, p_trg, ok, first_ok, cont, guess, two lists, count
    R_DD,         // the deltas of the block's rows in a phase: lanes * rp AT, lane-major
    R_OWN,        // the block's a_0 (its rows of layer 0): rows0 * lanes AT
    R_COL,        // W_1's columns of its rows of W_0: rows0 * n[1] AT
    R_HO,         // the head's outputs: lanes * n_out AT
    R_HDL,        // the output deltas: lanes * n_out AT
    R_T,          // the group's targets: lanes * n_out AT
    R_W0,         // W_0's rows: rows0 * n_in WT
    R_X,          // the inputs of x_lanes lanes: x_lanes * n_in AT
    R_DW0,        // dw_0's rows: rows0 * n_in ADD
    NREG
};

// The launch plan (convergence_tile_kernel.py tile_plan), passed as int64:
// blocks, warps, lanes (the lane slots: min(tile, S)), x_lanes (== lanes:
// the group's inputs staged once a group), rp (the row pitch of a lane's
// deltas: the most rows a block owns in any layer, rounded up to 4),
// smem_bytes, ws_stride, then per region (on chip, byte offset).
constexpr int PLAN_HEAD = 7;
struct Plan {
    int blocks, warps, lanes, x_lanes, rp;
    long long smem_bytes, ws_stride;
    int on_chip[NREG];
    long long off[NREG];
};

// RB consecutive values at p in shared memory (16-byte aligned when
// RB > 1) in as few loads as their type allows; with M = Own, in the
// block's workspace slice, one load each.
template <int RB>
__device__ __forceinline__ void load_rows(const double* p, double (&d)[RB]) {
#pragma unroll
    for (int u = 0; u + 1 < RB; u += 2)
        asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];" : "=d"(d[u]), "=d"(d[u + 1]) : "r"(sa(p + u)));
    if constexpr (RB & 1) d[RB - 1] = Shm::ld(p + RB - 1);
}
template <int RB>
__device__ __forceinline__ void load_rows(const float* p, float (&d)[RB]) {
    if constexpr (RB == 4) {
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]) : "r"(sa(p)));
    } else {
#pragma unroll
        for (int u = 0; u + 1 < RB; u += 2)
            asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(d[u]), "=f"(d[u + 1]) : "r"(sa(p + u)));
        if constexpr (RB & 1) d[RB - 1] = Shm::ld(p + RB - 1);
    }
}
template <int RB, class M, typename T>
__device__ __forceinline__ void load_rows(const T* p, T (&d)[RB]) {
    if constexpr (std::is_same_v<M, Shm>) {
        load_rows<RB>(p, d);
    } else {
#pragma unroll
        for (int u = 0; u < RB; ++u) d[u] = M::ld(p + u);
    }
}

template <int N>
using Int = std::integral_constant<int, N>;

// SC: the block's scratch (the lane state, dd, own, col) in shared memory
// (BM = Shm), else in its workspace slice (BM = Own)
template <typename AT, bool BF, typename WT, typename ADD, bool SC>
__global__ void __launch_bounds__(MAX_THREADS, 1)
train_tile_kernel(Net<WT, ADD> net, Args a, Plan p) {
    using BM = std::conditional_t<SC, Shm, Own>;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int off[MAX_LAYERS + 1];  // layer l's slice of a lane's vectors
    cg::grid_group grid = cg::this_grid();
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
    const int G = gridDim.x, b = blockIdx.x;
    const int L = net.layers, T = p.lanes, RP = p.rp, n_in = a.n_in, n_out = a.n_out;
    const AT lr = AT(a.lr), delta = AT(a.delta);
    const ADD alpha = ADD(a.alpha);
    unsigned char* const mine = a.ws + static_cast<size_t>(b) * p.ws_stride;
    auto region = [&](int r) -> unsigned char* {
        return (p.on_chip[r] ? smem : mine) + p.off[r];
    };

    AT* const sat = reinterpret_cast<AT*>(region(R_STATE_AT));
    AT *const ep = sat, *const init = sat + T, *const dep = sat + 2 * T;
    AT *const errv = sat + 3 * T, *const dvv = sat + 4 * T;
    int* const sit = reinterpret_cast<int*>(region(R_STATE_INT));
    int *const n_it = sit, *const p_trg = sit + T, *const okv = sit + 2 * T;
    int *const first_ok = sit + 3 * T, *const cont = sit + 4 * T, *const guess = sit + 5 * T;
    int* list = sit + 6 * T;
    int* nlist = sit + 7 * T;
    int* const cnt = sit + 8 * T;
    AT* const dd = reinterpret_cast<AT*>(region(R_DD));
    AT* const own = reinterpret_cast<AT*>(region(R_OWN));
    AT* const col = reinterpret_cast<AT*>(region(R_COL));
    AT* const ho = reinterpret_cast<AT*>(region(R_HO));
    AT* const hdl = reinterpret_cast<AT*>(region(R_HDL));
    AT* const tt = reinterpret_cast<AT*>(smem + p.off[R_T]);
    AT* const xb = reinterpret_cast<AT*>(smem + p.off[R_X]);
    const bool x_group = p.x_lanes >= T;  // the group's inputs staged once a group

    if (tid == 0) {
        off[0] = 0;
        for (int l = 0; l < L; ++l) off[l + 1] = off[l] + net.n[l];
    }
    __syncthreads();
    const size_t stride = off[L];  // one lane's activations or deltas
    AT* const buf = static_cast<AT*>(a.scratch);
    // two forwards' activations (acts(c), c = 0 or 1), then the hidden deltas
    auto acts = [&](int c) { return buf + static_cast<size_t>(c) * T * stride; };
    AT* const dlg = buf + 2 * static_cast<size_t>(T) * stride;

    auto rows_of = [&](int l) { return b < net.n[l] ? (net.n[l] - 1 - b) / G + 1 : 0; };
    const int M0 = net.m[0], R0 = rows_of(0);
    const int N1 = L >= 2 ? net.n[1] : 0, M1 = L >= 2 ? net.m[1] : 0;
    // W_0's rows (dw_0's) of this block: slot r at base + r * rstride
    const bool w0_chip = p.on_chip[R_W0];
    WT* const w0b = p.on_chip[R_W0] ? reinterpret_cast<WT*>(smem + p.off[R_W0])
                                    : net.w[0] + static_cast<size_t>(b) * M0;
    const size_t w0rs = p.on_chip[R_W0] ? M0 : static_cast<size_t>(G) * M0;
    ADD* const dw0b = !a.momentum ? nullptr
                      : p.on_chip[R_DW0] ? reinterpret_cast<ADD*>(smem + p.off[R_DW0])
                                         : net.dw[0] + static_cast<size_t>(b) * M0;
    const size_t dw0rs = p.on_chip[R_DW0] ? M0 : static_cast<size_t>(G) * M0;
    if (p.on_chip[R_W0]) {
        for (int e = tid; e < R0 * M0; e += nthreads)
            w0b[e] = net.w[0][static_cast<size_t>(b + e / M0 * G) * M0 + e % M0];
    }

    long long syncs = 0;  // the launch's grid barriers, counted as they are taken
    auto sync = [&]() {
        grid.sync();
        ++syncs;
    };
    int count = 0;  // live lanes, the same in every thread of every block
    int cur = 0;    // acts(cur): the latest forward

    // The update of R rows (slot r at wbase + r * wrs; dw's at dwbase +
    // r * dwrs), RB rows at a time: g = the live lanes' dd[s][r] * h_s[j] in
    // list order, the first lane's product first; h_s at h + s * hls.  Thread
    // t takes elements t, t + nthreads, .. JB of them at once, and loads QB
    // lanes' inputs together.
    auto update_rows = [&](auto rbv, auto jbv, auto qbv, auto hm, auto wm, WT* wbase,
                           size_t wrs, ADD* dwbase, size_t dwrs, int R, int M, const AT* h,
                           int hls) {
        constexpr int RB = decltype(rbv)::value, JB = decltype(jbv)::value;
        constexpr int QB = decltype(qbv)::value;
        using HM = decltype(hm);
        using WM = decltype(wm);
        const int S = count;
        for (int j0 = tid; j0 < M; j0 += JB * nthreads) {
            for (int r0 = 0; r0 < R; r0 += RB) {
                AT g[JB][RB];
#pragma unroll
                for (int jb = 0; jb < JB; ++jb)
#pragma unroll
                    for (int u = 0; u < RB; ++u) g[jb][u] = AT(0);
                for (int k0 = 0; k0 < S; k0 += QB) {
                    int sq[QB];
                    AT hv[QB][JB];
                    // the batch's missing lanes (past S) and elements (past
                    // M) are selected away, not branched around
                    const int nq = min(QB, S - k0);
#pragma unroll
                    for (int q = 0; q < QB; ++q) {
                        sq[q] = BM::ld(list + k0 + min(q, nq - 1));
                        const AT* const hr = h + sq[q] * hls;
#pragma unroll
                        for (int jb = 0; jb < JB; ++jb) {
                            const int j = min(j0 + jb * nthreads, M - 1);
                            hv[q][jb] = HM::ld(hr + j);
                        }
                    }
#pragma unroll
                    for (int q = 0; q < QB; ++q) {
                        AT d[RB];
                        load_rows<RB, BM>(dd + sq[q] * RP + r0, d);
                        const bool first = k0 + q == 0, in = q < nq;
#pragma unroll
                        for (int jb = 0; jb < JB; ++jb)
#pragma unroll
                            for (int u = 0; u < RB; ++u) {
                                const AT pr = mul(d[u], hv[q][jb]);
                                g[jb][u] = first ? pr : in ? add(g[jb][u], pr) : g[jb][u];
                            }
                    }
                }
#pragma unroll
                for (int jb = 0; jb < JB; ++jb) {
                    const int j = j0 + jb * nthreads;
                    if (j >= M) break;
#pragma unroll
                    for (int u = 0; u < RB; ++u) {
                        if (r0 + u >= R) break;
                        WT* const wp = wbase + (r0 + u) * wrs + j;
                        const ADD step = static_cast<ADD>(mul(lr, g[jb][u]));
                        const ADD w = static_cast<ADD>(wget<WM>(wp));
                        if (a.momentum) {
                            ADD* const dp = dwbase + (r0 + u) * dwrs + j;
                            const ADD s2 = add(WM::ld(dp), step);
                            wput<WM>(wp, add(w, s2));
                            WM::st(dp, mul(alpha, s2));
                        } else {
                            wput<WM>(wp, add(w, step));
                        }
                    }
                }
            }
        }
    };

    // The forward of R rows (slot r at wbase + r * wrs) for the live lanes at
    // list positions k_begin .. k_end-1: lane s's input at v + slot * vls,
    // slot s (slot0 < 0) or k - slot0; z_s[i] goes (through act unless
    // !actv) to out + s * stride + i, and to own when keep.  A warp task is
    // RB rows x LB lanes; thread t sums elements t, t + 32, ... of each
    // (row, lane), KB of them loaded together, then the butterfly; each
    // output's lane applies the activation.
    auto forward_rows = [&](auto rbv, auto lbv, auto kbv, auto vm, auto wm, const WT* wbase,
                            size_t wrs, int R, int M, const AT* v, int vls, int k_begin,
                            int k_end, int slot0, AT* out, bool actv, bool keep) {
        constexpr int RB = decltype(rbv)::value, LB = decltype(lbv)::value;
        constexpr int KB = decltype(kbv)::value;
        using VM = decltype(vm);
        using WM = decltype(wm);
        const int S = k_end - k_begin;
        if (R == 0 || S <= 0) return;
        const int nrb = (R + RB - 1) / RB, nlb = (S + LB - 1) / LB;
        for (int task = warp; task < nrb * nlb; task += nwarps) {
            const int r0 = task / nlb * RB, kq = k_begin + task % nlb * LB;
            const int rn = min(RB, R - r0), qn = min(LB, k_end - kq);
            const AT* vp[LB];
            const WT* wp[RB];
#pragma unroll
            for (int q = 0; q < LB; ++q) {
                const int k = kq + min(q, qn - 1);
                vp[q] = v + (slot0 < 0 ? BM::ld(list + k) : k - slot0) * vls;
            }
#pragma unroll
            for (int u = 0; u < RB; ++u) wp[u] = wbase + (r0 + min(u, rn - 1)) * wrs;
            AT acc[RB][LB];
#pragma unroll
            for (int u = 0; u < RB; ++u)
#pragma unroll
                for (int q = 0; q < LB; ++q) acc[u][q] = AT(0);
            // whole iterations without an element guard, then the row's end
            int j0 = lane;
            for (; j0 - lane + 32 * KB <= M; j0 += 32 * KB) {
                AT wv[RB][KB], xv[LB][KB];
#pragma unroll
                for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
                    for (int u = 0; u < RB; ++u)
                        wv[u][kk] = rb<BF>(static_cast<AT>(wget<WM>(wp[u] + j0 + 32 * kk)));
#pragma unroll
                    for (int q = 0; q < LB; ++q) xv[q][kk] = VM::ld(vp[q] + j0 + 32 * kk);
                }
#pragma unroll
                for (int kk = 0; kk < KB; ++kk)
#pragma unroll
                    for (int u = 0; u < RB; ++u)
#pragma unroll
                        for (int q = 0; q < LB; ++q)
                            if (u < rn && q < qn) acc[u][q] = fma_(wv[u][kk], xv[q][kk], acc[u][q]);
            }
            for (; j0 < M; j0 += 32 * KB) {
                AT wv[RB][KB], xv[LB][KB];
#pragma unroll
                for (int kk = 0; kk < KB; ++kk) {
                    const int j = j0 + 32 * kk;
#pragma unroll
                    for (int u = 0; u < RB; ++u)
                        wv[u][kk] = j < M ? rb<BF>(static_cast<AT>(wget<WM>(wp[u] + j))) : AT(0);
#pragma unroll
                    for (int q = 0; q < LB; ++q) xv[q][kk] = j < M ? VM::ld(vp[q] + j) : AT(0);
                }
#pragma unroll
                for (int kk = 0; kk < KB; ++kk) {
                    if (j0 + 32 * kk >= M) break;
#pragma unroll
                    for (int u = 0; u < RB; ++u)
#pragma unroll
                        for (int q = 0; q < LB; ++q)
                            if (u < rn && q < qn) acc[u][q] = fma_(wv[u][kk], xv[q][kk], acc[u][q]);
                }
            }
            // each (row, lane)'s sum to lane u * LB + q
            AT z = AT(0);
#pragma unroll
            for (int u = 0; u < RB; ++u)
#pragma unroll
                for (int q = 0; q < LB; ++q)
                    if (u < rn && q < qn) {
                        const AT sum = warp_sum(acc[u][q]);
                        if (lane == u * LB + q) z = sum;
                    }
            const int u = lane / LB, q = lane % LB;
            if (u < rn && q < qn) {
                z = rb<BF>(z);
                const AT y = actv ? act<BF>(z) : z;
                const int s = BM::ld(list + kq + q);
                Coh::st(out + s * static_cast<int>(stride) + b + (r0 + u) * G, y);
                if (keep) BM::st(own + (r0 + u) * T + s, y);
            }
        }
    };

    // Hidden delta of the block's R rows of layer l for every live lane:
    // (W_{l+1}^T d_{l+1})[j] * dact(a_l[j]) from the pre-update W_{l+1}, its
    // column j (row j = b + r*G) from col (l = 0) or through L2; d_{l+1} of
    // lane s at dn + s * dnls.  Layer 0's go to dd, the others' to dlg.  A
    // column of at most 32 elements: one thread an output, each virtual
    // lane's one product and the butterfly's adds in its order; longer: a
    // warp task of DB lanes and the butterfly.
    auto delta_rows = [&](auto dnm, int l, int R, const AT* dn, size_t dnls) {
        using DNM = decltype(dnm);
        const int S = count, Nn = net.n[l + 1], Mn = net.m[l + 1];
        auto column = [&](int r, int i) {
            return l == 0 ? BM::ld(col + r * Nn + i)
                          : rb<BF>(static_cast<AT>(wget<Coh>(net.w[l + 1] + static_cast<size_t>(i) * Mn + b + r * G)));
        };
        auto finish = [&](int r, int s, AT sum) {
            const int j = b + r * G;
            const AT aj = l == 0 ? BM::ld(own + r * T + s) : Coh::ld(acts(cur) + s * stride + off[l] + j);
            const AT d = rb<BF>(mul(rb<BF>(sum), dact<BF>(aj)));
            if (l == 0) BM::st(dd + s * RP + r, d);
            else Coh::st(dlg + s * stride + off[l] + j, d);
        };
        if (Nn <= 32) {
            for (int e = tid; e < R * S; e += nthreads) {
                const int r = e / S, s = BM::ld(list + e - r * S);
                AT v[32];
#pragma unroll
                for (int i = 0; i < 32; ++i)
                    v[i] = i < Nn ? fma_(column(r, i), DNM::ld(dn + s * static_cast<int>(dnls) + i), AT(0))
                                  : AT(0);
                // the butterfly's adds, in its order, for its lane 0
#pragma unroll
                for (int i = 0; i < 16; ++i) v[i] = v[i] + v[i + 16];
#pragma unroll
                for (int i = 0; i < 8; ++i) v[i] = v[i] + v[i + 8];
#pragma unroll
                for (int i = 0; i < 4; ++i) v[i] = v[i] + v[i + 4];
#pragma unroll
                for (int i = 0; i < 2; ++i) v[i] = v[i] + v[i + 2];
                finish(r, s, v[0] + v[1]);
            }
            return;
        }
        const int nlb = (S + DB - 1) / DB;
        for (int task = warp; task < R * nlb; task += nwarps) {
            const int r = task / nlb, k0 = task % nlb * DB, qn = min(DB, S - k0);
            int sq[DB];
            AT acc[DB];
#pragma unroll
            for (int q = 0; q < DB; ++q) {
                sq[q] = list[k0 + min(q, qn - 1)];
                acc[q] = AT(0);
            }
            for (int i = lane; i < Nn; i += 32) {
                const AT c = column(r, i);
#pragma unroll
                for (int q = 0; q < DB; ++q)  // sq past qn repeat a listed lane: selected away
                    acc[q] = q < qn ? fma_(c, DNM::ld(dn + sq[q] * static_cast<int>(dnls) + i), acc[q]) : acc[q];
            }
            AT z = AT(0);
#pragma unroll
            for (int q = 0; q < DB; ++q)
                if (q < qn) {
                    const AT sum = warp_sum(acc[q]);
                    if (lane == q) z = sum;
                }
            if (lane < qn) finish(r, list[k0 + lane], z);
        }
    };

    // One phase of a forward (upd: of a lockstep iteration), ending at a
    // grid barrier: a hidden-delta phase of layer l (delta), or layer l's
    // phase: with upd the deltas of the block's rows (layer 0's from W_1's
    // columns) and their update, then their forward.
    auto phase = [&](bool delta, int l, bool upd, int nxt, const AT* xg) {
        const int S = count;
        if (delta || (upd && l == 0 && L >= 2)) {
            const int R = rows_of(l);
            if (R > 0) {
                if (l + 1 == L - 1) delta_rows(Own{}, l, R, hdl, n_out);
                else delta_rows(Coh{}, l, R, dlg + off[l + 1], stride);
            }
        }
        const int R = delta ? 0 : rows_of(l), M = net.m[l];
        const bool last = l == L - 1;
        if (R > 0) {
            if (upd) {
                if (l > 0 || L == 1) {
                    for (int e = tid; e < R * S; e += nthreads) {
                        const int r = e / S, s = list[e - r * S], i = b + r * G;
                        dd[s * RP + r] = last ? hdl[s * n_out + i] : Coh::ld(dlg + s * stride + off[l] + i);
                    }
                }
                __syncthreads();
                if (l > 0) {
                    auto upd_l = [&](auto rbv, auto qbv) {
                        update_rows(rbv, Int<1>{}, qbv, Coh{}, Coh{},
                                    net.w[l] + static_cast<size_t>(b) * M,
                                    static_cast<size_t>(G) * M,
                                    a.momentum ? net.dw[l] + static_cast<size_t>(b) * M : nullptr,
                                    static_cast<size_t>(G) * M, R, M, acts(cur) + off[l - 1],
                                    static_cast<int>(stride));
                    };
                    // 16 lanes' inputs through L2 at once, 4 when fewer live
                    // (the scratch off chip -- wide layers at large tiles --
                    // takes one register tile a call site: no spills)
                    if constexpr (!SC) upd_l(Int<1>{}, Int<4>{});
                    else if (R == 1 && S >= 16) upd_l(Int<1>{}, Int<16>{});
                    else if (R == 1) upd_l(Int<1>{}, Int<4>{});
                    else if (S >= 16) upd_l(Int<2>{}, Int<16>{});
                    else upd_l(Int<2>{}, Int<4>{});
                } else {
                    // W_0's rows (and dw_0's) on chip or in place; the inputs
                    // on chip (staged for the group) or read in place (lane
                    // chunks)
                    auto upd_0 = [&](auto rbv) {
                        if (w0_chip && (!a.momentum || p.on_chip[R_DW0]) && x_group)
                            update_rows(rbv, Int<3>{}, Int<4>{}, Shm{}, Shm{}, w0b, w0rs, dw0b,
                                        dw0rs, R, M, xb, n_in);
                        else if (x_group)
                            update_rows(rbv, Int<3>{}, Int<4>{}, Shm{}, Own{}, w0b, w0rs, dw0b,
                                        dw0rs, R, M, xb, n_in);
                        else
                            update_rows(rbv, Int<2>{}, Int<16>{}, Own{}, Own{}, w0b, w0rs, dw0b,
                                        dw0rs, R, M, xg, n_in);
                    };
                    // (3-row chunks only where they start at row 0: a lane's
                    // deltas are read in 16-byte pairs)
                    if constexpr (!SC) upd_0(Int<1>{});
                    else if (R == 1) upd_0(Int<1>{});
                    else if (R == 3) upd_0(Int<3>{});
                    else upd_0(Int<2>{});
                }
                __syncthreads();
            }
            AT* const out = acts(nxt) + off[l];
            const bool actv = !(last && a.kind != KIND_ANN);
            if (l > 0) {
                auto fwd_l = [&](auto rbv) {
                    forward_rows(rbv, Int<4>{}, Int<4>{}, Coh{}, Coh{},
                                 net.w[l] + static_cast<size_t>(b) * M, static_cast<size_t>(G) * M,
                                 R, M, acts(nxt) + off[l - 1], static_cast<int>(stride), 0, S, -1,
                                 out, actv, false);
                };
                if constexpr (!SC) fwd_l(Int<1>{});
                else if (R == 1) fwd_l(Int<1>{});
                else fwd_l(Int<2>{});
            } else {
                // the group's inputs in one pass, or lane chunks staged in
                // turn; tasks of RB = the block's rows (up to 4) and 8
                // lanes, or 2 where 8 would leave most warps idle
                const int chunk = x_group ? S : p.x_lanes;
                for (int c0 = 0; c0 < S; c0 += chunk) {
                    const int ce = min(S, c0 + chunk);
                    if (!x_group) {
                        for (int e = tid; e < (ce - c0) * n_in; e += nthreads) {
                            const int q = e / n_in;
                            xb[e] = xg[static_cast<size_t>(list[c0 + q]) * n_in + e - q * n_in];
                        }
                        __syncthreads();
                    }
                    const bool wide = (ce - c0 + 7) / 8 * ((R + 2) / 3) * 2 >= nwarps;
                    const int slot0 = x_group ? -1 : c0;
                    auto fwd_0 = [&](auto rbv, auto wm) {
                        if (!SC || wide)
                            forward_rows(rbv, Int<8>{}, Int<2>{}, Shm{}, wm, w0b, w0rs, R, M, xb,
                                         n_in, c0, ce, slot0, out, actv, L >= 2);
                        else
                            forward_rows(rbv, Int<2>{}, Int<4>{}, Shm{}, wm, w0b, w0rs, R, M, xb,
                                         n_in, c0, ce, slot0, out, actv, L >= 2);
                    };
                    auto fwd_r = [&](auto rbv) {
                        if (w0_chip) fwd_0(rbv, Shm{});
                        else fwd_0(rbv, Own{});
                    };
                    if constexpr (!SC) fwd_r(Int<1>{});
                    else if (R == 1) fwd_r(Int<1>{});
                    else if (R == 2) fwd_r(Int<2>{});
                    else fwd_r(Int<3>{});
                    if (!x_group) __syncthreads();
                }
            }
        }
        sync();
    };

    // The head of the latest forward in every block, for the listed lanes:
    // outputs (SNN softmax), output deltas, error, argmax, and, after an
    // iteration, the stop tests and the next live list (entry: init_err,
    // ep and p_trg).  W_1's columns of the block's rows of W_0 are loaded
    // in the same pass as the outputs.
    auto head = [&](bool entry, int it, const AT* tg) {  // tg: the group's targets
        const int S = count, nz = S * n_out, ncol = L >= 2 ? R0 * N1 : 0;
        const AT* const z = acts(cur) + off[L - 1];
        // FB elements a thread, their loads issued together
        for (int e0 = tid; e0 < max(nz, ncol); e0 += FB * nthreads) {
            AT zi[FB], c[FB];
            int at[FB];
#pragma unroll
            for (int f = 0; f < FB; ++f) {
                const int e = e0 + f * nthreads;
                if (e < nz) {
                    const int k = e / n_out, i = e - k * n_out, s = list[k];
                    at[f] = s * n_out + i;
                    zi[f] = Coh::ld(z + s * stride + i);
                }
                if (e < ncol) {
                    const int r = e / N1, i = e - r * N1;
                    c[f] = wget<Coh>(net.w[1] + static_cast<size_t>(i) * M1 + b + r * G);
                }
            }
#pragma unroll
            for (int f = 0; f < FB; ++f) {
                const int e = e0 + f * nthreads;
                if (e < nz) ho[at[f]] = a.kind == KIND_SNN ? rb<BF>(expT(rb<BF>(sub(zi[f], AT(1))))) : zi[f];
                if (e < ncol) col[e] = rb<BF>(c[f]);
            }
        }
        __syncthreads();
        if (a.kind == KIND_SNN) {
            // softmax(x-1): exp(z-1) summed in order, TINY added last
            // (hpnn_tpu/ops/convergence_tile.py:203-205)
            for (int k = tid; k < S; k += nthreads) {
                const int s = list[k];
                const AT* const o = ho + s * n_out;
                AT dv = AT(0);
                int i = 0;
                for (; i + FB <= n_out; i += FB) {
                    AT v[FB];
#pragma unroll
                    for (int f = 0; f < FB; ++f) v[f] = o[i + f];
#pragma unroll
                    for (int f = 0; f < FB; ++f) dv = add(dv, v[f]);
                }
                for (; i < n_out; ++i) dv = add(dv, o[i]);
                dvv[s] = add(dv, AT(TINY));
            }
            __syncthreads();
            for (int e = tid; e < nz; e += nthreads) {
                const int k = e / n_out, s = list[k], at = s * n_out + e - k * n_out;
                ho[at] = rb<BF>(dvd(ho[at], dvv[s]));
            }
            __syncthreads();
        }
        // output delta: ANN (t-o)*dact(o) (ann.c:1308-1310); SNN, LNN t-o
        for (int e = tid; e < nz; e += nthreads) {
            const int k = e / n_out, i = e - k * n_out, s = list[k], at = s * n_out + i;
            const AT oi = ho[at], diff = rb<BF>(sub(tg[at], oi));
            hdl[at] = a.kind == KIND_ANN ? rb<BF>(mul(diff, dact<BF>(oi))) : diff;
        }
        // the serial folds of lane k: its error in thread k, its argmax
        // (and at entry p_trg) in thread S32 + k, another warp; each in
        // ascending order, FB elements' loads issued together
        const int S32 = (S + 31) & ~31, nfull = n_out / FB * FB;
        for (int idx = tid; idx < 2 * S32; idx += nthreads) {
            const int k = idx < S32 ? idx : idx - S32;
            if (k >= S) continue;
            const int s = list[k];
            const AT* const o = ho + s * n_out;
            const AT* const t = tg + s * n_out;
            if (idx < S32 && a.kind == KIND_SNN) {
                // -(1/N) sum_{o>0} t*log(o+TINY) (snn.c:447-477)
                AT acc = AT(0);
                for (int i = 0; i < n_out; ++i) {
                    const AT oi = o[i];
                    if (oi > AT(0)) acc = add(acc, mul(t[i], logT(add(oi, AT(TINY)))));
                }
                errv[s] = dvd(-acc, AT(n_out));
            } else if (idx < S32) {
                // 0.5*sum((t-o)^2) (ann.c:1246-1275)
                AT acc = AT(0);
                for (int i0 = 0; i0 < nfull; i0 += FB) {
                    AT ov[FB], tv[FB];
#pragma unroll
                    for (int f = 0; f < FB; ++f) {
                        ov[f] = o[i0 + f];
                        tv[f] = t[i0 + f];
                    }
#pragma unroll
                    for (int f = 0; f < FB; ++f) {
                        const AT diff = sub(tv[f], ov[f]);
                        acc = add(acc, mul(diff, diff));
                    }
                }
                for (int i = nfull; i < n_out; ++i) {
                    const AT diff = sub(t[i], o[i]);
                    acc = add(acc, mul(diff, diff));
                }
                errv[s] = mul(AT(0.5), acc);
            } else {
                int best = 0;
                AT bv = o[0];
                for (int i0 = 0; i0 < nfull; i0 += FB) {
                    AT ov[FB];
#pragma unroll
                    for (int f = 0; f < FB; ++f) ov[f] = o[i0 + f];
#pragma unroll
                    for (int f = 0; f < FB; ++f) {
                        if (ov[f] > bv) {  // first maximal index (strict compare)
                            bv = ov[f];
                            best = i0 + f;
                        }
                    }
                }
                for (int i = nfull; i < n_out; ++i) {
                    if (o[i] > bv) {
                        bv = o[i];
                        best = i;
                    }
                }
                guess[s] = best;
                if (entry) {
                    int pt = 0;
                    for (int i = 0; i < n_out; ++i)
                        if (t[i] == AT(1)) pt = i;
                    p_trg[s] = pt;
                }
            }
        }
        __syncthreads();
        for (int k = tid; k < S; k += nthreads) {
            const int s = list[k];
            const AT e = errv[s];
            if (entry) {
                init[s] = e;
                ep[s] = e;
                continue;
            }
            const AT d = sub(ep[s], e);
            const int ok = a.kind == KIND_LNN || guess[s] == p_trg[s];
            ep[s] = e;
            dep[s] = d;
            n_it[s] = it;
            okv[s] = ok;
            if (it == 1) first_ok[s] = ok;
            cont[s] = it <= a.max_iter && (d > delta || !(ok && it > a.min_iter));
        }
        if (entry) {
            __syncthreads();
            return;
        }
        __syncthreads();
        if (warp == 0) {
            // the next list: the lanes still live, in ascending order
            int n = 0;
            for (int k0 = 0; k0 < S; k0 += 32) {
                const int k = k0 + lane;
                const int s = k < S ? list[k] : 0;
                const bool live = k < S && cont[s];
                const unsigned mask = __ballot_sync(0xffffffffu, live);
                if (live) nlist[n + __popc(mask & ((1u << lane) - 1u))] = s;
                n += __popc(mask);
            }
            if (lane == 0) *cnt = n;
        }
        __syncthreads();
        int* const t = list;
        list = nlist;
        nlist = t;
        count = *cnt;
    };

    long long iter_syncs = 0, lockstep = 0;
    const int groups = (a.S + a.tile - 1) / a.tile;
    const long long g_end = min(static_cast<long long>(groups),
                                static_cast<long long>(a.start_group) + a.group_budget);
    for (int g = a.start_group; g < g_end; ++g) {
        const int r0 = g * a.tile;
        const int nreal = min(a.tile, a.S - r0);
        const AT* const xg = static_cast<const AT*>(a.xs) + static_cast<size_t>(r0) * n_in;
        const AT* tg = static_cast<const AT*>(a.ts) + static_cast<size_t>(r0) * n_out;
        if (x_group)
            for (int e = tid; e < nreal * n_in; e += nthreads) xb[e] = xg[e];
        if (p.on_chip[R_T]) {
            for (int e = tid; e < nreal * n_out; e += nthreads) tt[e] = tg[e];
            tg = tt;
        }
        if (a.momentum) {  // momentum zeroes at group entry (ann.c:2391), each row by its owner
            for (int e = tid; e < R0 * M0; e += nthreads) dw0b[e / M0 * dw0rs + e % M0] = ADD(0);
            for (int l = 1; l < L; ++l) {
                const int R = rows_of(l), M = net.m[l];
                for (int e = tid; e < R * M; e += nthreads)
                    Coh::st(net.dw[l] + static_cast<size_t>(b + e / M * G) * M + e % M, ADD(0));
            }
        }
        for (int k = tid; k < nreal; k += nthreads) list[k] = k;
        count = nreal;
        __syncthreads();
        // it = 0: the group's entry forward; then lockstep iterations 1, 2, ..
        // until every lane is dead.  Each forward goes to the other buffer: a
        // block still in the last head may be reading acts(cur).
        for (int it = 0;; ++it) {
            const long long before = syncs;
            const bool upd = it > 0;
            const int nxt = cur ^ 1, nd = upd ? max(L - 2, 0) : 0;
            for (int ph = 0; ph < nd + L; ++ph)
                phase(ph < nd, ph < nd ? L - 2 - ph : ph - nd, upd, nxt, xg);
            cur = nxt;
            head(!upd, it, tg);
            if (upd) {
                iter_syncs += syncs - before;
                ++lockstep;
            }
            if (count == 0) break;
        }
        if (b == 0) {
            for (int s = tid; s < nreal; s += nthreads) {
                double* const row = a.stats + static_cast<size_t>(r0 + s) * 5;
                row[0] = double(init[s]);
                row[1] = first_ok[s] ? 1.0 : 0.0;
                row[2] = double(n_it[s]);
                row[3] = double(dep[s]);
                row[4] = (okv[s] && n_it[s] > a.min_iter) ? 1.0 : 0.0;
            }
        }
        __syncthreads();
    }
    if (p.on_chip[R_W0]) {  // W_0's rows back to device memory
        for (int e = tid; e < R0 * M0; e += nthreads)
            net.w[0][static_cast<size_t>(b + e / M0 * G) * M0 + e % M0] = w0b[e];
    }
    if (a.counts && b == 0 && tid == 0) {
        a.counts[0] = iter_syncs;
        a.counts[1] = syncs;
        a.counts[2] = lockstep;
    }
}

template <typename AT, bool BF, typename WT, typename ADD>
int launch(void* const* w, void* const* dw, const int* n, const int* m, int layers,
           const Args& args, const long long* plan, int device, void* stream, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    Plan p{};
    p.blocks = static_cast<int>(plan[0]);
    p.warps = static_cast<int>(plan[1]);
    p.lanes = static_cast<int>(plan[2]);
    p.x_lanes = static_cast<int>(plan[3]);
    p.rp = static_cast<int>(plan[4]);
    p.smem_bytes = plan[5];
    p.ws_stride = plan[6];
    for (int r = 0; r < NREG; ++r) {
        p.on_chip[r] = static_cast<int>(plan[PLAN_HEAD + 2 * r]);
        p.off[r] = plan[PLAN_HEAD + 2 * r + 1];
    }
    if (layers < 1 || layers > MAX_LAYERS || args.tile < 1 || p.blocks < 1 || p.warps < 1 ||
        p.warps * 32 > MAX_THREADS || p.lanes < 1 || p.x_lanes < 1 || p.rp < 1 || p.rp % 4 ||
        !p.on_chip[R_X])
        return static_cast<int>(cudaErrorInvalidValue);
    const bool sc = p.on_chip[R_STATE_AT];  // the block's scratch: all on chip or none
    for (int r : {R_STATE_INT, R_DD, R_OWN, R_COL})
        if (static_cast<bool>(p.on_chip[r]) != sc) return static_cast<int>(cudaErrorInvalidValue);
    int coop = 0, sms = 0, fit = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kernel = sc ? train_tile_kernel<AT, BF, WT, ADD, true>
                     : train_tile_kernel<AT, BF, WT, ADD, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, 32 * p.warps,
                                                        static_cast<size_t>(p.smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (out) out[0] = fit;
    if (static_cast<long long>(fit) * sms < p.blocks)
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    Net<WT, ADD> net{};
    for (int l = 0; l < layers; ++l) {
        net.w[l] = static_cast<WT*>(w[l]);
        net.dw[l] = args.momentum ? static_cast<ADD*>(dw[l]) : nullptr;
        net.n[l] = n[l];
        net.m[l] = m[l];
    }
    net.layers = layers;
    Args a = args;
    void* kargs[] = {&net, &a, &p};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.blocks), dim3(32 * p.warps),
                                      kargs, static_cast<size_t>(p.smem_bytes),
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define HPNN_TILE_ENTRY(NAME, AT, BF, WT, ADD)                                              \
    int NAME(void* const* w, void* const* dw, const int* n, const int* m, int layers,      \
             const void* xs, const void* ts, double* stats, void* scratch, void* ws,        \
             long long* counts, int S, int n_in, int n_out, int kind, int momentum,         \
             int tile, double lr, double alpha, double delta, int min_iter, int max_iter,   \
             int start_group, int group_budget, const long long* plan, int device,          \
             void* stream, int* out) {                                                      \
        Args a{xs, ts, stats, scratch, static_cast<unsigned char*>(ws), counts, S, n_in,    \
               n_out, kind, momentum, tile, lr, alpha, delta, min_iter, max_iter,           \
               start_group, group_budget};                                                  \
        return launch<AT, BF, WT, ADD>(w, dw, n, m, layers, a, plan, device, stream, out); \
    }

HPNN_TILE_ENTRY(hpnn_train_tile_f64, double, false, double, double)
HPNN_TILE_ENTRY(hpnn_train_tile_f64_w32, double, false, float, double)
HPNN_TILE_ENTRY(hpnn_train_tile_f32, float, false, float, float)
HPNN_TILE_ENTRY(hpnn_train_tile_f32_wbf16, float, false, __nv_bfloat16, float)
HPNN_TILE_ENTRY(hpnn_train_tile_f32_w32, float, false, float, double)
HPNN_TILE_ENTRY(hpnn_train_tile_bf16, float, true, float, float)
HPNN_TILE_ENTRY(hpnn_train_tile_bf16_wbf16, float, true, __nv_bfloat16, float)

// out: the card's SMs, shared bytes a block can opt in to, cooperative launch
int hpnn_train_tile_limits(int device, int* out) {
    cudaError_t err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, device);
    return static_cast<int>(err);
}

const char* hpnn_train_tile_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
