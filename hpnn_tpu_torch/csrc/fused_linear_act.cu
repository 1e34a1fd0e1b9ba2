// fused_linear_act: out[b, n] = act(sum_m xs[b, m] * W[n, m]) on Hopper.
//
// Replaces the Pallas TPU kernel hpnn_tpu/ops/pallas_kernels.py
// fused_linear_act (body _fused_linear_act_kernel), the per-layer product of
// batched_forward_pallas that run_nn and the serving registry evaluate every
// layer through.
//
// What bounds it on the H100: at B <= 64 (the serving buckets) the data is
// W (0.94 MB at 784->300 f32), read once at 3.35 TB/s in a fraction of a
// microsecond, so launch and memory latency set the time: how many SMs
// work at once and how many dependent global round trips each makes.  At
// B = 4096 float32 and float64 are bound by the FMAs (784->300: 1.93 GFLOP,
// 29 us at 67 TFLOP/s float32; float64 on the CUDA cores peaks near half
// of that) and by how evenly the tiles spread over the 132 SMs;
// bfloat16 is bound by the bytes against the tensor cores' rate.
//
// The fixed summation order (what every plan keeps).  The reduction over m
// runs in stages of 32 (the last one ragged).  Each stage's partial is an
// FMA chain from zero in ascending m (bfloat16: two m16n8k16 tensor-core
// MMAs, the second accumulating onto the first, from a zero accumulator);
// the stage partials are added, from zero, in ascending stage order; the
// activation is applied once, the result converted once (round to nearest
// even for bfloat16) and stored once.  So an output's bits depend on its
// row of xs and its row of W only: not on the batch size, the padding, the
// row's position or the plan.  That is what keeps the strict serving tier
// bit-identical to run_nn on the card.  float32 and float64 take the same
// arithmetic as the first port of this kernel, so their bits did not
// move; bfloat16 moved from float FMAs to the tensor cores at every batch
// size (within 2e-2 of the plain version).
//
// The plans (chosen by the wrapper, ops/kernels.py _plan, from B, N, M and
// the dtype alone; each gives the same bits because each takes the order
// above):
// * Direct (small products, S <= 32 stages): a block owns a small tile
//   (4x8 outputs, bfloat16 16x8) and all its stages, a warp a stage.  Each
//   warp reads its stage's operands straight from L1/L2, writes its stage
//   partials to shared memory, and after one barrier a thread an output
//   adds them in order.  One launch, no staging loop, no workspace.
// * Staged, one group: a block owns a tile (32x16 to 128x80 outputs) and
//   walks every stage, keeping the running sum in registers.  Stages
//   reach shared memory through a ring of three to six slots filled by
//   cp.async ahead of the math (16-byte copies where M and the pointers
//   allow, else 8 bytes (one float64, two float32) or 4 (a bfloat16 pair)
//   where M is even; float32 and bfloat16 with an odd M go through
//   registers instead),
//   out-of-range elements zero-filled.  Slots are [row][k] with a padded
//   pitch, so the math reads 16 bytes along k without bank conflicts.
//   float32 and float64 compute on the CUDA cores, a register micro-tile
//   of up to 8x5 outputs a thread (a warp 4 rows x 8 columns of threads;
//   float32 stays full float32, float64 stays on FP64 FMAs); bfloat16 on
//   the tensor cores (mma.sync, float32 accumulate), small batches padded
//   to the MMA's 16 rows inside the block.  Above 512 rows the wrapper
//   fits the tile to whole waves of the card: 128x80 tiles cut 4096 x 300
//   outputs into 128 blocks and 96x80 tiles 4096 x 230 into 129, one a
//   SM, where 64x64 or 128x128 tiles leave a second, mostly idle wave.
// * Staged, split (when the tiles alone would leave most of the 132 SMs
//   idle): the stages are split into groups across blocks.  Stage
//   partials are independent of each other; only the final chain of adds
//   is sequential.  So each block writes each of its stages' partials,
//   un-summed, to a workspace [S][B][N] in the accumulator type, and a
//   second launch on the same stream adds the S partials of each output
//   from zero in ascending stage order: the chain of the one-group plan.
//
// C interface (loaded with ctypes): every entry returns cudaGetLastError()
// after its launches; they are asynchronous on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;  // stage depth: the unit of the summation order

template <typename T>
struct Traits;

template <>
struct Traits<float> {
    using Acc = float;
    using Vec = float4;  // 16 bytes along k
    static constexpr int V = 4;
    static __device__ __forceinline__ float act(float a) { return tanhf(0.5f * a); }
    static __device__ __forceinline__ float store(float v) { return v; }
    static __device__ __forceinline__ float mac(float a, float b, float c) {
        return __fmaf_rn(a, b, c);
    }
    static __device__ __forceinline__ float lane(const float4& v, int u) {
        return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
    }
};

template <>
struct Traits<double> {
    using Acc = double;
    using Vec = double2;
    static constexpr int V = 2;
    static __device__ __forceinline__ double act(double a) {
        return 2.0 / (1.0 + exp(-1.0 * a)) - 1.0;
    }
    static __device__ __forceinline__ double store(double v) { return v; }
    static __device__ __forceinline__ double mac(double a, double b, double c) {
        return __fma_rn(a, b, c);
    }
    static __device__ __forceinline__ double lane(const double2& v, int u) {
        return u == 0 ? v.x : v.y;
    }
};

template <>
struct Traits<__nv_bfloat16> {
    using Acc = float;
    static __device__ __forceinline__ float act(float a) { return tanhf(0.5f * a); }
    static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16(v); }
};

template <typename T>
struct Params {
    const T* xs;                       // (B, M)
    const T* w;                        // (N, M)
    T* out;                            // (B, N)
    typename Traits<T>::Acc* ws;       // (S, B, N) stage partials; groups > 1 only
    int B, N, M, S, G, act;            // S stages of BK; G stages per group
};

// ---- stage loads --------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = pred ? BYTES : 0;  // 0: nothing read, the slot zero-filled
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                     "r"(n)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                     "n"(BYTES), "r"(n)
                     : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How a stage reaches shared memory: 16-byte cp.async (M a multiple of the
// vector, both pointers aligned: a vector is all inside or all outside the
// matrix), else an 8-byte cp.async of one float64 or a float32 pair, or a
// 4-byte one of a bfloat16 pair (M even), else plain loads into
// registers, stored after the math: float32 and bfloat16 with an odd M
// (float32 measured faster on the H100 that way than one 4-byte cp.async
// an element).
enum LoadMode { WIDE = 0, NARROW = 1, REGS = 2 };

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
    return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

// Rows [r0, r0 + R) x k [k0, k0 + BK) of a (rows, M) matrix into a slot
// [R][LD]: a warp copies consecutive k of a row (coalesced along M).
template <typename T, int MODE, int R, int THREADS, int LD>
struct Loader {
    static constexpr int CH = MODE == WIDE ? 16 / static_cast<int>(sizeof(T))
                                           : (MODE == NARROW ? (sizeof(T) == 2 ? 2 : 8 / static_cast<int>(sizeof(T))) : 1);
    static constexpr int BYTES = CH * static_cast<int>(sizeof(T));
    static constexpr int CPR = BK / CH;       // chunks per row
    static constexpr int RPP = THREADS / CPR; // rows per pass
    static constexpr int PASSES = (R + RPP - 1) / RPP;
    static_assert(THREADS % CPR == 0, "threads must cover whole rows");
    int kc;  // this thread's first k inside the stage
    int lr;  // this thread's first row inside the tile
    T reg[MODE == REGS ? PASSES : 1];

    __device__ __forceinline__ explicit Loader(int tid) : kc((tid % CPR) * CH), lr(tid / CPR) {}

    // issue one stage: asynchronous copies, or (REGS) loads into registers
    __device__ __forceinline__ void issue(T* slot, const T* __restrict__ src, int rows, int M,
                                          int r0, int k0) {
        const int k = k0 + kc;
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
            const int r = lr + p * RPP;
            if (r >= R) continue;
            const int row = r0 + r;
            const bool in = row < rows && k < M;
            const T* at = in ? src + static_cast<size_t>(row) * M + k : src;
            if constexpr (MODE == REGS)
                reg[p] = in ? *at : zero_of<T>();
            else
                cp_async<BYTES>(slot + r * LD + kc, at, in);
        }
    }

    // REGS only: the registers of the last issue into their slot
    __device__ __forceinline__ void settle(T* slot) const {
        if constexpr (MODE == REGS) {
#pragma unroll
            for (int p = 0; p < PASSES; ++p) {
                const int r = lr + p * RPP;
                if (r < R) slot[r * LD + kc] = reg[p];
            }
        }
    }
};

// ---- float32 / float64: CUDA cores ----------------------------------------
// TX x TY threads; thread (tx, ty) owns rows ty + TY*i and columns tx + TX*j
// of the tile.  Slots are [row][LD] in T with LD = BK + 16/sizeof(T): a
// warp's 16-byte reads along k of 16 consecutive rows hit distinct banks.
template <typename T, int BM, int BN, int TM, int TN>
struct Simt {
    static constexpr int TX = BN / TN;
    static constexpr int TY = BM / TM;
    static constexpr int THREADS = TX * TY;
    static constexpr int LD = BK + 16 / static_cast<int>(sizeof(T));
    static constexpr int SLOT = (BM + BN) * LD;  // elements of one ring slot
    // ring depth: as many slots as fit in 120 KB, three to six (small
    // tiles keep more stages in flight against the load latency; a deeper
    // ring for the large tiles measured slower on the H100)
    static constexpr size_t FIT = (120 * 1024) / (sizeof(T) * SLOT);
    static constexpr int NS = FIT < 3 ? 3 : FIT > 6 ? 6 : static_cast<int>(FIT);
    // float64's 256-thread tiles of at most 4x4 a thread keep to 128
    // registers, so two blocks share an SM (measured faster; float32
    // measured slower so capped); larger micro-tiles need more
    static constexpr int MIN_BLOCKS = THREADS <= 256 && TM * TN <= 16 && sizeof(T) == 8 ? 2 : 1;
    static constexpr size_t SMEM = sizeof(T) * SLOT * NS;
    static_assert(TX % 8 == 0 && TY % 4 == 0, "a warp is 4 x 8 threads");
};

template <typename T, int BM, int BN, int TM, int TN, int MODE>
__global__ void __launch_bounds__(Simt<T, BM, BN, TM, TN>::THREADS,
                                  Simt<T, BM, BN, TM, TN>::MIN_BLOCKS)
simt_kernel(const Params<T> p) {
    using Tr = Traits<T>;
    using K = Simt<T, BM, BN, TM, TN>;
    using Vec = typename Tr::Vec;
    constexpr int V = Tr::V;
    constexpr int LD = K::LD;
    constexpr int NS = K::NS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int tid = threadIdx.x;
    // a warp covers 4 rows x 8 columns of threads: its 16-byte reads of a
    // stage touch 4 rows of xs and 8 of W, one wavefront each
    const int tx = (tid / 32) % (K::TX / 8) * 8 + tid % 8;
    const int ty = (tid / 32) / (K::TX / 8) * 4 + tid % 32 / 8;
    const int row0 = blockIdx.x * BM;
    const int col0 = blockIdx.y * BN;
    const int s0 = blockIdx.z * p.G;
    const int nst = min(p.S, s0 + p.G) - s0;
    const bool split = gridDim.z > 1;

    Loader<T, MODE, BM, K::THREADS, LD> lx(tid);
    Loader<T, MODE, BN, K::THREADS, LD> lw(tid);
    auto xslot = [&](int i) { return smem + (i % NS) * K::SLOT; };
    auto wslot = [&](int i) { return smem + (i % NS) * K::SLOT + BM * LD; };

#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
        if (i < nst) {
            lx.issue(xslot(i), p.xs, p.B, p.M, row0, (s0 + i) * BK);
            lw.issue(wslot(i), p.w, p.N, p.M, col0, (s0 + i) * BK);
            lx.settle(xslot(i));
            lw.settle(wslot(i));
        }
        cp_async_commit();
    }

    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

    for (int it = 0; it < nst; ++it) {
        const int s = s0 + it;
        cp_async_wait<NS - 2>();
        __syncthreads();
        const int nx = it + NS - 1;  // refills the slot read last iteration
        if (nx < nst) {
            lx.issue(xslot(nx), p.xs, p.B, p.M, row0, (s0 + nx) * BK);
            lw.issue(wslot(nx), p.w, p.N, p.M, col0, (s0 + nx) * BK);
        }
        cp_async_commit();

        const T* xt = xslot(it);
        const T* wt = wslot(it);
        T part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) part[i][j] = T(0);
        const int kn = min(BK, p.M - s * BK);
        if (kn == BK) {
#pragma unroll
            for (int kq = 0; kq < BK; kq += V) {
                // a column's vector at a time: each output's chain still
                // takes its k in ascending order, and fewer registers live
                Vec a[TM];
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    a[i] = *reinterpret_cast<const Vec*>(xt + (ty + K::TY * i) * LD + kq);
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    const Vec b = *reinterpret_cast<const Vec*>(wt + (tx + K::TX * j) * LD + kq);
#pragma unroll
                    for (int u = 0; u < V; ++u)
#pragma unroll
                        for (int i = 0; i < TM; ++i)
                            part[i][j] = Tr::mac(Tr::lane(a[i], u), Tr::lane(b, u), part[i][j]);
                }
            }
        } else {
            // the ragged last stage: only the real k enter the chain
            for (int kk = 0; kk < kn; ++kk) {
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        part[i][j] = Tr::mac(xt[(ty + K::TY * i) * LD + kk],
                                             wt[(tx + K::TX * j) * LD + kk], part[i][j]);
            }
        }
        if (nx < nst) {
            lx.settle(xslot(nx));
            lw.settle(wslot(nx));
        }
        if (split) {
            T* plane = p.ws + static_cast<size_t>(s) * p.B * p.N;
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const int row = row0 + ty + K::TY * i;
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    const int col = col0 + tx + K::TX * j;
                    if (row < p.B && col < p.N)
                        plane[static_cast<size_t>(row) * p.N + col] = part[i][j];
                }
            }
        } else {
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
        }
    }

    if (split) return;  // stage_sum_kernel adds the partials
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int row = row0 + ty + K::TY * i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = col0 + tx + K::TX * j;
            if (row >= p.B || col >= p.N) continue;
            p.out[static_cast<size_t>(row) * p.N + col] =
                Tr::store(p.act ? Tr::act(acc[i][j]) : acc[i][j]);
        }
    }
}

// ---- bfloat16: tensor cores -------------------------------------------------
// D = A(16x16, row) x B(16x8, col) + D, bfloat16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// WARPS_M x WARPS_N warps; a warp owns (BM/WARPS_M) x (BN/WARPS_N) of the
// tile as 16x8 MMA tiles.  Slots are [row][k] with a pitch of 40 (80
// bytes): fragment loads hit 32 distinct banks and rows stay 16-byte
// aligned for the copies.
template <int BM, int BN, int WARPS_M, int WARPS_N>
struct Mma {
    static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
    static constexpr int LD = BK + 8;
    static constexpr int SLOT = (BM + BN) * LD;
    static constexpr int NS = 4;  // ring slots (stages in flight)
    static constexpr size_t SMEM = sizeof(__nv_bfloat16) * SLOT * NS;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, int MODE>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
mma_kernel(const Params<__nv_bfloat16> p) {
    using T = __nv_bfloat16;
    using Tr = Traits<T>;
    using K = Mma<BM, BN, WARPS_M, WARPS_N>;
    constexpr int WTM = BM / WARPS_M;
    constexpr int WTN = BN / WARPS_N;
    constexpr int MT = WTM / 16;
    constexpr int NT = WTN / 8;
    constexpr int LD = K::LD;
    constexpr int NS = K::NS;
    static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0, "warp tile");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row / column group
    const int t = lane & 3;   // thread in group
    const int wr0 = (warp % WARPS_M) * WTM;
    const int wc0 = (warp / WARPS_M) * WTN;
    const int row0 = blockIdx.x * BM;
    const int col0 = blockIdx.y * BN;
    const int s0 = blockIdx.z * p.G;
    const int nst = min(p.S, s0 + p.G) - s0;
    const bool split = gridDim.z > 1;

    Loader<T, MODE, BM, K::THREADS, LD> lx(tid);
    Loader<T, MODE, BN, K::THREADS, LD> lw(tid);
    auto xslot = [&](int i) { return smem + (i % NS) * K::SLOT; };
    auto wslot = [&](int i) { return smem + (i % NS) * K::SLOT + BM * LD; };

#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
        if (i < nst) {
            lx.issue(xslot(i), p.xs, p.B, p.M, row0, (s0 + i) * BK);
            lw.issue(wslot(i), p.w, p.N, p.M, col0, (s0 + i) * BK);
            lx.settle(xslot(i));
            lw.settle(wslot(i));
        }
        cp_async_commit();
    }

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    for (int it = 0; it < nst; ++it) {
        const int s = s0 + it;
        cp_async_wait<NS - 2>();
        __syncthreads();
        const int nx = it + NS - 1;
        if (nx < nst) {
            lx.issue(xslot(nx), p.xs, p.B, p.M, row0, (s0 + nx) * BK);
            lw.issue(wslot(nx), p.w, p.N, p.M, col0, (s0 + nx) * BK);
        }
        cp_async_commit();

        const T* xt = xslot(it);
        const T* wt = wslot(it);
        float part[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
        for (int kh = 0; kh < BK; kh += 16) {
            uint32_t a[MT][4], b[NT][2];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const T* r = xt + (wr0 + i * 16 + g) * LD + kh + 2 * t;
                a[i][0] = *reinterpret_cast<const uint32_t*>(r);
                a[i][1] = *reinterpret_cast<const uint32_t*>(r + 8 * LD);
                a[i][2] = *reinterpret_cast<const uint32_t*>(r + 8);
                a[i][3] = *reinterpret_cast<const uint32_t*>(r + 8 * LD + 8);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const T* c = wt + (wc0 + j * 8 + g) * LD + kh + 2 * t;
                b[j][0] = *reinterpret_cast<const uint32_t*>(c);
                b[j][1] = *reinterpret_cast<const uint32_t*>(c + 8);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j) mma_bf16(part[i][j], a[i], b[j]);
        }
        if (nx < nst) {
            lx.settle(xslot(nx));
            lw.settle(wslot(nx));
        }
        if (split) {
            float* plane = p.ws + static_cast<size_t>(s) * p.B * p.N;
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int row = row0 + wr0 + i * 16 + g + (e >> 1) * 8;
                        const int col = col0 + wc0 + j * 8 + 2 * t + (e & 1);
                        if (row < p.B && col < p.N)
                            plane[static_cast<size_t>(row) * p.N + col] = part[i][j][e];
                    }
        } else {
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
        }
    }

    if (split) return;  // stage_sum_kernel adds the partials
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = row0 + wr0 + i * 16 + g + (e >> 1) * 8;
                const int col = col0 + wc0 + j * 8 + 2 * t + (e & 1);
                if (row >= p.B || col >= p.N) continue;
                const float v = p.act ? Tr::act(acc[i][j][e]) : acc[i][j][e];
                p.out[static_cast<size_t>(row) * p.N + col] = Tr::store(v);
            }
}

// ---- small problems: every stage of a tile at once --------------------------
// The direct plan: a block owns a small tile and all S <= 32 stages, one
// warp a stage.  Each warp reads its stage's operands straight from L1/L2
// (no shared-memory staging, no stage loop), writes its stage partials to
// shared memory, and after one barrier a thread an output adds the S
// partials from zero in ascending stage order: the same chain as every
// other plan, one launch, no workspace.
constexpr int DIRECT_MAX_STAGES = 32;
constexpr int DIRECT_COLS = 8;  // float32 / float64: a 4 x 8 tile

// float32 / float64: lane = one output of an R x C tile (C = DIRECT_COLS,
// R*C = 32); the lane's stage partial is its FMA chain over the stage's k,
// ascending.  C stays a kernel argument: as a compile-time constant ptxas
// gave the float64 kernel of up to 16 stages 32 registers where it had
// used 40, and 300->10 at B=1 measured 0.5 us slower on the H100.
template <typename T, bool VEC, int MAX_STAGES>
__global__ void __launch_bounds__(32 * MAX_STAGES)
direct_simt(const Params<T> p, int C) {
    using Tr = Traits<T>;
    using Vec = typename Tr::Vec;
    constexpr int V = Tr::V;
    __shared__ T part[DIRECT_MAX_STAGES][32];
    const int s = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int R = 32 / C;
    const int row = blockIdx.x * R + lane / C;
    const int col = blockIdx.y * C + lane % C;
    const bool live = row < p.B && col < p.N;
    T acc = T(0);
    if (live) {
        const T* xr = p.xs + static_cast<size_t>(row) * p.M + s * BK;
        const T* wr = p.w + static_cast<size_t>(col) * p.M + s * BK;
        const int kn = min(BK, p.M - s * BK);
        if (VEC && kn == BK) {
#pragma unroll
            for (int kq = 0; kq < BK; kq += V) {
                const Vec a = __ldg(reinterpret_cast<const Vec*>(xr + kq));
                const Vec b = __ldg(reinterpret_cast<const Vec*>(wr + kq));
#pragma unroll
                for (int u = 0; u < V; ++u) acc = Tr::mac(Tr::lane(a, u), Tr::lane(b, u), acc);
            }
        } else {
            for (int kk = 0; kk < kn; ++kk) acc = Tr::mac(__ldg(xr + kk), __ldg(wr + kk), acc);
        }
    }
    part[s][lane] = acc;
    __syncthreads();
    if (threadIdx.x < 32 && live) {
        T sum = T(0);
#pragma unroll 8
        for (int q = 0; q < p.S; ++q) sum += part[q][lane];
        p.out[static_cast<size_t>(row) * p.N + col] = Tr::store(p.act ? Tr::act(sum) : sum);
    }
}

// bfloat16: a 16 x 8 tile, a warp's stage partial two m16n8k16 MMAs with
// fragments loaded from global memory (rows past B and k past M as zero).
__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* __restrict__ base, int row,
                                              int rows, int M, int k, bool aligned) {
    if (row >= rows || k >= M) return 0u;
    const __nv_bfloat16* at = base + static_cast<size_t>(row) * M + k;
    if (aligned) return __ldg(reinterpret_cast<const unsigned*>(at));  // k even, M even
    const unsigned lo = __bfloat16_as_ushort(__ldg(at));
    const unsigned hi = k + 1 < M ? __bfloat16_as_ushort(__ldg(at + 1)) : 0u;
    return lo | (hi << 16);
}

__global__ void __launch_bounds__(32 * DIRECT_MAX_STAGES)
direct_mma(const Params<__nv_bfloat16> p) {
    using Tr = Traits<__nv_bfloat16>;
    __shared__ float part[DIRECT_MAX_STAGES][16 * 8];
    const int s = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = blockIdx.x * 16;
    const int col0 = blockIdx.y * 8;
    const bool aligned = p.M % 2 == 0 &&
                         ((reinterpret_cast<uintptr_t>(p.xs) | reinterpret_cast<uintptr_t>(p.w)) % 4) == 0;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kh = 0; kh < BK; kh += 16) {
        const int k = s * BK + kh + 2 * t;
        uint32_t a[4], b[2];
        a[0] = bf16_pair(p.xs, row0 + g, p.B, p.M, k, aligned);
        a[1] = bf16_pair(p.xs, row0 + g + 8, p.B, p.M, k, aligned);
        a[2] = bf16_pair(p.xs, row0 + g, p.B, p.M, k + 8, aligned);
        a[3] = bf16_pair(p.xs, row0 + g + 8, p.B, p.M, k + 8, aligned);
        b[0] = bf16_pair(p.w, col0 + g, p.N, p.M, k, aligned);
        b[1] = bf16_pair(p.w, col0 + g, p.N, p.M, k + 8, aligned);
        mma_bf16(d, a, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) part[s][(g + (e >> 1) * 8) * 8 + 2 * t + (e & 1)] = d[e];
    __syncthreads();
    for (int o = threadIdx.x; o < 16 * 8; o += blockDim.x) {
        const int row = row0 + o / 8;
        const int col = col0 + o % 8;
        if (row >= p.B || col >= p.N) continue;
        float sum = 0.0f;
#pragma unroll 8
        for (int q = 0; q < p.S; ++q) sum += part[q][o];
        p.out[static_cast<size_t>(row) * p.N + col] = Tr::store(p.act ? Tr::act(sum) : sum);
    }
}

// The epilogue of a split plan, a second launch on the same stream: one
// thread an output adds its S stage partials from zero in ascending stage
// order, activates and stores.  (Electing each tile's last block with an
// atomic ticket to do this inside the first launch was measured slower on
// the H100 at every split cell: the reduction then runs on one SM a tile,
// behind a device-wide fence.)
template <typename T>
__global__ void __launch_bounds__(256) stage_sum_kernel(const Params<T> p) {
    using Tr = Traits<T>;
    using Acc = typename Tr::Acc;
    const size_t plane = static_cast<size_t>(p.B) * p.N;
    const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
    if (idx >= plane) return;
    Acc acc = Acc(0);
#pragma unroll 8
    for (int s = 0; s < p.S; ++s) acc += p.ws[idx + s * plane];
    p.out[idx] = Tr::store(p.act ? Tr::act(acc) : acc);
}

// ---- launch -----------------------------------------------------------------

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int load_mode(const Params<T>& p) {
    constexpr int n = 16 / static_cast<int>(sizeof(T));
    const uintptr_t a = reinterpret_cast<uintptr_t>(p.xs) | reinterpret_cast<uintptr_t>(p.w);
    if (p.M % n == 0 && a % 16 == 0) return WIDE;
    if (sizeof(T) == 8) return NARROW;
    if (sizeof(T) == 4) return p.M % 2 == 0 && a % 8 == 0 ? NARROW : REGS;
    return p.M % 2 == 0 && a % 4 == 0 ? NARROW : REGS;
}

// Above 48 KB a kernel's dynamic shared memory needs the opt-in, asked for
// at every launch (a host-side attribute, per device).
template <typename T, typename KernelFn>
void launch_kernel(KernelFn kernel, size_t smem, dim3 grid, int threads, cudaStream_t st,
                   const Params<T>& p) {
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    kernel<<<grid, threads, smem, st>>>(p);
}

template <typename T, int BM, int BN, int TM, int TN>
void run_simt(const Params<T>& p, cudaStream_t st) {
    using K = Simt<T, BM, BN, TM, TN>;
    const dim3 grid(cdiv(p.B, BM), cdiv(p.N, BN), cdiv(p.S, p.G));
    const int mode = load_mode(p);
    if (mode == WIDE)
        launch_kernel(simt_kernel<T, BM, BN, TM, TN, WIDE>, K::SMEM, grid, K::THREADS, st, p);
    else if (sizeof(T) == 8 || mode == NARROW)
        launch_kernel(simt_kernel<T, BM, BN, TM, TN, NARROW>, K::SMEM, grid, K::THREADS, st, p);
    else if constexpr (sizeof(T) == 4)
        launch_kernel(simt_kernel<T, BM, BN, TM, TN, REGS>, K::SMEM, grid, K::THREADS, st, p);
}

template <int BM, int BN, int WM, int WN>
void run_mma(const Params<__nv_bfloat16>& p, cudaStream_t st) {
    using K = Mma<BM, BN, WM, WN>;
    const dim3 grid(cdiv(p.B, BM), cdiv(p.N, BN), cdiv(p.S, p.G));
    switch (load_mode(p)) {
        case WIDE:
            launch_kernel(mma_kernel<BM, BN, WM, WN, WIDE>, K::SMEM, grid, K::THREADS, st, p);
            break;
        case NARROW:
            launch_kernel(mma_kernel<BM, BN, WM, WN, NARROW>, K::SMEM, grid, K::THREADS, st, p);
            break;
        default:
            launch_kernel(mma_kernel<BM, BN, WM, WN, REGS>, K::SMEM, grid, K::THREADS, st, p);
    }
}

// After the tile launch: a split plan's stage sums.
template <typename T>
int finish(const Params<T>& p, cudaStream_t st) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || p.G >= p.S) return static_cast<int>(err);
    const size_t plane = static_cast<size_t>(p.B) * p.N;
    stage_sum_kernel<T><<<static_cast<unsigned>((plane + 255) / 256), 256, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// The tiles, by the index the wrapper's plan names (ops/kernels.py
// SIMT_TILES and MMA_TILES).  float32 / float64, rows x columns of a block
// (outputs a thread): 0 = 32x32 (2x2), 1 = 64x64 (4x4), 2 = 128x64 (8x4),
// 3 = 128x80 (float32 8x5; float64 4x5 on 512 threads, where 8x5 spills),
// 4 = 96x80 (6x5), 5 = 32x16 (2x2, for layers of at most 16 outputs);
// bfloat16: 0 = 32x32, 1 = 64x64, 2 = 128x64.  The 80-wide tiles let the
// planner fit a large batch's tiles to one wave of the card's SMs: 300
// outputs are four of them, 230 three.  DIRECT: the direct plan (float32 /
// float64 4 x 8, bfloat16 16 x 8).
constexpr int DIRECT = 6;

template <typename T>
int dispatch_simt(const Params<T>& p, int tile, cudaStream_t st) {
    switch (tile) {
        case 0: run_simt<T, 32, 32, 2, 2>(p, st); break;
        case 1: run_simt<T, 64, 64, 4, 4>(p, st); break;
        case 2: run_simt<T, 128, 64, 8, 4>(p, st); break;
        case 3:
            if constexpr (sizeof(T) == 8) run_simt<T, 128, 80, 4, 5>(p, st);
            else run_simt<T, 128, 80, 8, 5>(p, st);
            break;
        case 4: run_simt<T, 96, 80, 6, 5>(p, st); break;
        case 5: run_simt<T, 32, 16, 2, 2>(p, st); break;
        case DIRECT: {
            if (p.S > DIRECT_MAX_STAGES) return static_cast<int>(cudaErrorInvalidValue);
            const dim3 grid(cdiv(p.B, 32 / DIRECT_COLS), cdiv(p.N, DIRECT_COLS));
            const bool vec = p.M % Traits<T>::V == 0 &&
                             ((reinterpret_cast<uintptr_t>(p.xs) | reinterpret_cast<uintptr_t>(p.w)) % 16) == 0;
            // up to 16 stages, blocks of at most 512 threads get 128
            // registers a thread: a lane's stage operands fit in flight
            if (p.S <= 16) {
                if (vec)
                    direct_simt<T, true, 16><<<grid, 32 * p.S, 0, st>>>(p, DIRECT_COLS);
                else
                    direct_simt<T, false, 16><<<grid, 32 * p.S, 0, st>>>(p, DIRECT_COLS);
            } else if (vec) {
                direct_simt<T, true, DIRECT_MAX_STAGES><<<grid, 32 * p.S, 0, st>>>(p, DIRECT_COLS);
            } else {
                direct_simt<T, false, DIRECT_MAX_STAGES><<<grid, 32 * p.S, 0, st>>>(p, DIRECT_COLS);
            }
            return static_cast<int>(cudaGetLastError());
        }
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return finish(p, st);
}

int dispatch_mma(const Params<__nv_bfloat16>& p, int tile, cudaStream_t st) {
    switch (tile) {
        case 0: run_mma<32, 32, 2, 2>(p, st); break;
        case 1: run_mma<64, 64, 2, 4>(p, st); break;
        case 2: run_mma<128, 64, 4, 2>(p, st); break;
        case DIRECT:
            if (p.S > DIRECT_MAX_STAGES) return static_cast<int>(cudaErrorInvalidValue);
            direct_mma<<<dim3(cdiv(p.B, 16), cdiv(p.N, 8)), 32 * p.S, 0, st>>>(p);
            return static_cast<int>(cudaGetLastError());
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return finish(p, st);
}

template <typename T>
Params<T> params(const void* xs, const void* w, void* out, void* ws, int B, int N, int M,
                 int act, int per_group) {
    Params<T> p;
    p.xs = static_cast<const T*>(xs);
    p.w = static_cast<const T*>(w);
    p.out = static_cast<T*>(out);
    p.ws = static_cast<typename Traits<T>::Acc*>(ws);
    p.B = B;
    p.N = N;
    p.M = M;
    p.S = M > 0 ? cdiv(M, BK) : 1;  // M = 0: one empty stage, act(0)
    p.G = per_group;
    p.act = act;
    return p;
}

}  // namespace

extern "C" {

// xs (B, M), w (N, M), out (B, N), all contiguous; ws holds S*B*N
// accumulator values when the plan has more than one stage group
// (S = ceil(M/32) stages, per_group of them a group), else it may be null;
// tile indexes the tile shapes above.
int hpnn_fused_linear_act_f32(const void* xs, const void* w, void* out, void* ws,
                              int B, int N, int M, int act, int tile, int per_group,
                              int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return dispatch_simt(params<float>(xs, w, out, ws, B, N, M, act, per_group), tile,
                         static_cast<cudaStream_t>(stream));
}

int hpnn_fused_linear_act_f64(const void* xs, const void* w, void* out, void* ws,
                              int B, int N, int M, int act, int tile, int per_group,
                              int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return dispatch_simt(params<double>(xs, w, out, ws, B, N, M, act, per_group), tile,
                         static_cast<cudaStream_t>(stream));
}

int hpnn_fused_linear_act_bf16(const void* xs, const void* w, void* out, void* ws,
                               int B, int N, int M, int act, int tile, int per_group,
                               int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return dispatch_mma(params<__nv_bfloat16>(xs, w, out, ws, B, N, M, act, per_group),
                        tile, static_cast<cudaStream_t>(stream));
}

const char* hpnn_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
