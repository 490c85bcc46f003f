// One Stripe windowed unit as one CUDA kernel: a convolution over a halo,
// a boundary remainder whose tail the block's constraints mask, or any
// constraint-carrying block, summed over its window and reduction
// variables and stored.
//
// Replaces: src/repro/core/lower_pallas.py::_emit_windowed (with
// _halo_spec, _tile_slice, _contract_sides and step_mask: the
// pl.pallas_call that gathers halo operands on the host, unrolls every
// window position, contracts the two sides, masks constraint-dead points
// and accumulates across the reduction grid steps).
//
// Semantics are Stripe's, as in contraction.cu: every variable of the
// block nest that addresses the output is parallel, every other one (the
// window taps i, j, the contracted channel c, the reduction grid axes) is
// summed.  At each point the kernel evaluates the one or two operand
// sides (or, for an assigning block, its whole DAG), multiplies the two
// sides, and adds the product into the accumulator if every constraint of
// the block holds there; the accumulator's type is the reference's
// (float32, or int32 for an integer output, so the int8 convolution is
// bit-exact) and the store rounds once to the output's type.
//
// No halo gather.  Every address is affine in the nest's variables, so the
// unit comes in as data (struct WinParams): a table of tracked affine
// quantities, each a constant plus a coefficient per output variable and
// per reduction variable.  They are the element offset of each input, each
// input coordinate that can leave its dimension (x + i - 1 at x = 0), and
// each constraint (live where it is >= 0).  A thread sets them from its
// output point and steps them with an odometer over the reduction
// variables, one add per quantity per step.  An input read whose
// coordinate lies outside its dimension reads 0, which is what the
// reference's zero padding gives, so the TPU kernel's host-side pad and
// strided take (halo rows materialised once per block, duplicated by the
// margin) have no counterpart: the card reads the halo from L2.
//
// Launch: one output point per thread, grid-stride.  Variable 0 is the
// output variable with the smallest output stride (the channels k of an
// NHWC convolution): a warp stores 32 neighbouring outputs, reads the
// filter coalesced and the input as one broadcast element.  The reduction
// runs in a fixed order inside the thread, so results are deterministic.
// Reduction variable 0 is the innermost loop; the binding picks the
// largest one that moves no checked coordinate and no constraint (the
// channels c), so that for a unit multiplying two plain loads (a
// convolution) the inner loop is a specialised dot product (as in
// contraction.cu) whose range checks and masks are decided once per tap.
//
// What bounds it: a convolution of real size (ResNet-50's 3x3 layers) is
// far above the ridge, so operations bound it.  What this simple design
// leaves on the table: no shared-memory tiles of input and filter (every
// multiply-add loads both operands, from L1/L2), no register blocking (one
// output per thread), and no tensor cores (an implicit GEMM on wgmma would
// be the fast form).  A unit that is not a product of two plain loads, or
// whose innermost variable moves a guarded coordinate, runs the general
// evaluator at every point.

#include "dag.cuh"

#define MAXV 8    // output variables, and reduction variables
#define MAXS 6    // inputs
#define MAXQ 16   // tracked affine quantities
#define MAXD 8    // output rank

struct WinParams {
    void* out;
    const void* slot[MAXS];
    // quantity q = q0 + sum_i qo[q][i] * out_var_i + sum_j qr[q][j] * red_var_j:
    //   q in [0, n_slot): the element offset of input q;
    //   then n_chk input coordinates, each valid in [0, chk_hi) for input chk_slot;
    //   then n_cons constraints, each live where q >= 0.
    long long q0[MAXQ];
    long long qo[MAXQ][MAXV];
    long long qr[MAXQ][MAXV];
    long long out_stride[MAXV];
    long long n_points;
    double scale;
    double consts[MAXC];
    int slot_dt[MAXS];
    int chk_slot[MAXQ];
    int chk_hi[MAXQ];
    int out_dt;
    int is_int;   // accumulate in int32 (integer output), else float32
    int n_sides;  // 2: lhs * rhs; 1: lhs alone (one side, or an assign DAG)
    int out_ext[MAXV];
    int out_dim[MAXV];
    int out_coef[MAXV];
    int out_clip[MAXD];
    int red_ext[MAXV];
    int out_rank;
    int n_out;
    int n_red;
    int n_slot;
    int n_chk;
    int n_cons;
    int fast;     // lhs is "load 0", rhs "load 1", and variable 0 moves no check
    Prog lhs;
    Prog rhs;
};

__device__ __forceinline__ float mac(float a, float b, float acc) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int a, int b, int acc) { return a * b + acc; }

// Adds the quantities' coefficients of reduction variable j, ``times``
// times, to q (a loop the compiler unrolls over MAXQ, so q stays in
// registers).
__device__ __forceinline__ void step(long long* q, const WinParams& p, int n_q, int j,
                                     long long times) {
#pragma unroll
    for (int k = 0; k < MAXQ; ++k)
        if (k < n_q) q[k] += p.qr[k][j] * times;
}

// Whether every constraint holds at q, and which inputs read in range.
__device__ __forceinline__ bool live_at(const long long* q, const WinParams& p, int n_q,
                                        unsigned* valid) {
    bool live = true;
    unsigned v = (1u << p.n_slot) - 1u;
#pragma unroll
    for (int k = 0; k < MAXQ; ++k) {
        if (k >= p.n_slot && k < p.n_slot + p.n_chk) {
            const int c = k - p.n_slot;
            if (q[k] < 0 || q[k] >= p.chk_hi[c]) v &= ~(1u << p.chk_slot[c]);
        } else if (k >= p.n_slot + p.n_chk && k < n_q && q[k] < 0) {
            live = false;
        }
    }
    *valid = v;
    return live;
}

// T: accumulator type.  FAST: the unit multiplies two plain loads, of
// types SA and SB, and reduction variable 0 moves no checked coordinate
// and no constraint: the inner loop over it is then a plain dot product
// whose validity is decided once per step of the other variables.
template <typename T, typename SA, typename SB, bool FAST>
__global__ void windowed_kernel(const __grid_constant__ WinParams p) {
    const int n_q = p.n_slot + p.n_chk + p.n_cons;
    const int inner = p.n_red > 0 ? p.red_ext[0] : 1;
    long long n_outer = 1;
    for (int j = 1; j < p.n_red; ++j) n_outer *= p.red_ext[j];
    const long long step_pts = (long long)gridDim.x * blockDim.x;
    for (long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x; pt < p.n_points;
         pt += step_pts) {
        int ov[MAXV];
        long long rest = pt;
        for (int i = 0; i < p.n_out; ++i) {
            ov[i] = (int)(rest % p.out_ext[i]);
            rest /= p.out_ext[i];
        }
        int coord[MAXD];
        for (int d = 0; d < p.out_rank; ++d) coord[d] = 0;
        long long oo = 0;
        for (int i = 0; i < p.n_out; ++i) {
            coord[p.out_dim[i]] += p.out_coef[i] * ov[i];
            oo += p.out_stride[i] * ov[i];
        }
        bool inside = true;
        for (int d = 0; d < p.out_rank; ++d)
            if (coord[d] >= p.out_clip[d]) inside = false;
        if (!inside) continue;

        long long q[MAXQ];
#pragma unroll
        for (int k = 0; k < MAXQ; ++k) {
            long long v = 0;
            if (k < n_q) {
                v = p.q0[k];
                for (int i = 0; i < p.n_out; ++i) v += p.qo[k][i] * ov[i];
            }
            q[k] = v;
        }
        int cnt[MAXV];
        for (int j = 0; j < MAXV; ++j) cnt[j] = 0;
        T acc = (T)0;
        for (long long it = 0; it < n_outer; ++it) {
            if constexpr (FAST) {
                unsigned valid;
                if (live_at(q, p, n_q, &valid) && valid == 3u) {
                    const SA* a = (const SA*)p.slot[0] + q[0];
                    const SB* b = (const SB*)p.slot[1] + q[1];
                    const long long sa = p.n_red > 0 ? p.qr[0][0] : 0;
                    const long long sb = p.n_red > 0 ? p.qr[1][0] : 0;
#pragma unroll 4
                    for (int k = 0; k < inner; ++k) {
                        acc = mac(as_t<T>(__ldg(a)), as_t<T>(__ldg(b)), acc);
                        a += sa;
                        b += sb;
                    }
                }
            } else {
                for (int k = 0; k < inner; ++k) {
                    unsigned valid;
                    if (live_at(q, p, n_q, &valid)) {
                        T v = eval_prog<T>(p.lhs, p.slot, p.slot_dt, q, valid, (T)0, p.consts);
                        if (p.n_sides == 2)
                            v = v * eval_prog<T>(p.rhs, p.slot, p.slot_dt, q, valid, (T)0,
                                                 p.consts);
                        acc += v;
                    }
                    if (p.n_red > 0) step(q, p, n_q, 0, 1);
                }
                if (p.n_red > 0) step(q, p, n_q, 0, -inner);
            }
            // odometer over reduction variables 1.., variable 1 fastest
            for (int j = 1; j < p.n_red; ++j) {
                ++cnt[j];
                step(q, p, n_q, j, 1);
                if (cnt[j] < p.red_ext[j]) break;
                cnt[j] = 0;
                step(q, p, n_q, j, -p.red_ext[j]);
            }
        }
        const T val = p.scale != 1.0 ? acc * (T)p.scale : acc;
        store_as(p.out, p.out_dt, oo, val);
    }
}

template <typename T, typename SA, typename SB, bool FAST>
static void launch(const WinParams* p, int n_blocks, int block, cudaStream_t st) {
    windowed_kernel<T, SA, SB, FAST><<<n_blocks, block, 0, st>>>(*p);
}

extern "C" {

// Launches one windowed unit on ``stream``; returns cudaGetLastError().
int stripe_windowed_launch(const WinParams* p, int n_blocks, int block, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int a = p->slot_dt[0], b = p->slot_dt[1];
    if (p->fast && !p->is_int && a == DT_F32 && b == DT_F32)
        launch<float, float, float, true>(p, n_blocks, block, st);
    else if (p->fast && !p->is_int && a == DT_BF16 && b == DT_BF16)
        launch<float, __nv_bfloat16, __nv_bfloat16, true>(p, n_blocks, block, st);
    else if (p->fast && !p->is_int && a == DT_F16 && b == DT_F16)
        launch<float, __half, __half, true>(p, n_blocks, block, st);
    else if (p->fast && p->is_int && a == DT_I8 && b == DT_I8)
        launch<int, int8_t, int8_t, true>(p, n_blocks, block, st);
    else if (p->is_int)
        launch<int, int, int, false>(p, n_blocks, block, st);
    else
        launch<float, float, float, false>(p, n_blocks, block, st);
    return (int)cudaGetLastError();
}

// Layout of WinParams as this compiler laid it out, for the binding's check.
void stripe_windowed_layout(long long* out) {
    out[0] = (long long)sizeof(WinParams);
    out[1] = (long long)offsetof(WinParams, qr);
    out[2] = (long long)offsetof(WinParams, scale);
    out[3] = (long long)offsetof(WinParams, chk_hi);
    out[4] = (long long)offsetof(WinParams, out_rank);
    out[5] = (long long)offsetof(WinParams, rhs);
}

}  // extern "C"
