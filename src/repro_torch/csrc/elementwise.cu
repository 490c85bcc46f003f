// One Stripe elementwise unit as one CUDA kernel: the unit's DAG (an
// activation, a bias add, a gate, a join of several tensors) evaluated at
// every point of the output region and stored.
//
// Replaces: src/repro/core/lower_pallas.py::_emit_elementwise (the
// pl.pallas_call of one elementwise block on the TPU: the DAG on the input
// tiles, broadcast to the output block).
//
// The unit comes in as data (struct EwParams): the output's index
// variables with their extents and the output dimension each addresses,
// an element stride per variable for every input (0 where the input lacks
// the variable: that is how an input of lower rank broadcasts), the clip
// of the output region, and the DAG as a postfix program, evaluated by the
// same device code as the contraction's prologue and epilogue (dag.cuh).
// Evaluation type: float32 for a float output, int32 for an integer one,
// rounded once at the store (dag.cuh says how that relates to the
// reference's _eval_tnode, which evaluates in the output's type).
//
// Launch: one thread per output point in a grid-stride loop.  Variable 0
// is the output variable with the smallest output stride, so neighbouring
// threads store to neighbouring addresses and read neighbouring input
// elements; the binding merges the variables a tile split apart first.
//
// What bounds it: bytes.  A map reads each input element once and writes
// each output element once, a handful of operations per element: at the
// H100 SXM data sheet's 3.35 TB/s and 67 TFLOP/s float32 it sits far below
// the ridge.  What this simple design leaves on the table: one element per
// thread (no vector loads of 16 bytes), and the index arithmetic of the
// general odometer on every point.

#include "dag.cuh"

#define MAXV 8   // output variables
#define MAXE 6   // inputs
#define MAXD 8   // output rank

struct EwParams {
    void* out;
    const void* in[MAXE];
    long long in_base[MAXE];
    long long in_stride[MAXE][MAXV];
    long long out_stride[MAXV];
    long long n_points;
    double consts[MAXC];
    int in_dt[MAXE];
    int out_dt;
    int is_int;  // evaluate in int32 (integer output), else float32
    int ext[MAXV];
    int out_dim[MAXV];
    int out_coef[MAXV];
    int out_clip[MAXD];
    int out_rank;
    int n_var;
    int n_in;
    Prog prog;
};

// T: evaluation type; I: the type of the point index (32-bit division
// where the region has fewer than 2**32 points: the odometer divides once
// per variable per point)
template <typename T, typename I>
__global__ void elementwise_kernel(const __grid_constant__ EwParams p) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long pt = (long long)blockIdx.x * blockDim.x + threadIdx.x; pt < p.n_points;
         pt += step) {
        I rest = (I)pt;
        int coord[MAXD];
        for (int d = 0; d < p.out_rank; ++d) coord[d] = 0;
        long long off[MAXE];
        for (int s = 0; s < p.n_in; ++s) off[s] = p.in_base[s];
        long long oo = 0;
        for (int i = 0; i < p.n_var; ++i) {
            const I e = (I)p.ext[i];
            const int v = (int)(rest % e);
            rest /= e;
            coord[p.out_dim[i]] += p.out_coef[i] * v;
            oo += p.out_stride[i] * v;
            for (int s = 0; s < p.n_in; ++s) off[s] += p.in_stride[s][i] * v;
        }
        bool inside = true;
        for (int d = 0; d < p.out_rank; ++d)
            if (coord[d] >= p.out_clip[d]) inside = false;
        if (!inside) continue;
        const T val = eval_prog<T>(p.prog, p.in, p.in_dt, off, ~0u, (T)0, p.consts);
        store_as(p.out, p.out_dt, oo, val);
    }
}

extern "C" {

// Launches one elementwise unit on ``stream``; returns cudaGetLastError().
int stripe_elementwise_launch(const EwParams* p, int n_blocks, int block, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const bool small = p->n_points < (1ll << 32);
    if (p->is_int && small)
        elementwise_kernel<int, unsigned><<<n_blocks, block, 0, st>>>(*p);
    else if (p->is_int)
        elementwise_kernel<int, long long><<<n_blocks, block, 0, st>>>(*p);
    else if (small)
        elementwise_kernel<float, unsigned><<<n_blocks, block, 0, st>>>(*p);
    else
        elementwise_kernel<float, long long><<<n_blocks, block, 0, st>>>(*p);
    return (int)cudaGetLastError();
}

// Layout of EwParams as this compiler laid it out, for the binding's check.
void stripe_elementwise_layout(long long* out) {
    out[0] = (long long)sizeof(EwParams);
    out[1] = (long long)offsetof(EwParams, in_stride);
    out[2] = (long long)offsetof(EwParams, consts);
    out[3] = (long long)offsetof(EwParams, ext);
    out[4] = (long long)offsetof(EwParams, out_rank);
    out[5] = (long long)offsetof(EwParams, prog);
}

}  // extern "C"
