// Device code shared by the Stripe kernels (contraction.cu, elementwise.cu,
// windowed.cu): the element types a tensor may have, typed loads and
// stores, and the evaluator of the tile-compute DAGs, which the binding
// compiles to short postfix programs.
//
// Evaluation type.  A program evaluates in one type T: float for a float
// output, int for an integer output.  That is the reference's accumulator
// type (src/repro/core/lower_jnp.py::_acc_dtype: int32 for integer
// outputs, else float32); every load converts to T on the way in and the
// store rounds T to the output's type once, round to nearest even for
// bf16 / f16 (what torch's and JAX's casts do), wrapping for int8.  The
// reference's tile evaluators keep a bf16 / f16 operand in its own type
// and type constants as the output (lower_pallas.py::_eval_tnode,
// _apply_epilogue), so a DAG over 16-bit floats rounds after each of its
// ops there and only at the store here: the two differ by those roundings,
// a few units of the last place of the 16-bit type.  For float32 and for
// integers the two agree exactly, op by op.  Integer programs take only
// the ops that are closed over the integers (the binding refuses the rest).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define MAXP 32     // postfix program length
#define MAXC 8      // constants
#define MAXSTACK 8  // evaluation stack depth

// op-codes; must match repro_torch/kernels/contraction.py
#define OP_LOAD 0
#define OP_CONST 1
#define OP_ACC 2
#define OP_UNARY 16   // + index into the unary table
#define OP_BINARY 48  // + index into the binary table

// element types; must match repro_torch/kernels/_build.py (DTYPE_CODES)
#define DT_F32 0
#define DT_BF16 1
#define DT_F16 2
#define DT_I8 3
#define DT_I32 4

struct Prog {
    int n;
    int code[MAXP];
    int arg[MAXP];
};

// ------------------------------------------------------------ conversions
template <typename S> struct Elem;
template <> struct Elem<float> {
    static __device__ __forceinline__ float f(float x) { return x; }
    static __device__ __forceinline__ int i(float x) { return (int)x; }
};
template <> struct Elem<__nv_bfloat16> {
    static __device__ __forceinline__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
    static __device__ __forceinline__ int i(__nv_bfloat16 x) { return (int)__bfloat162float(x); }
};
template <> struct Elem<__half> {
    static __device__ __forceinline__ float f(__half x) { return __half2float(x); }
    static __device__ __forceinline__ int i(__half x) { return (int)__half2float(x); }
};
template <> struct Elem<int8_t> {
    static __device__ __forceinline__ float f(int8_t x) { return (float)x; }
    static __device__ __forceinline__ int i(int8_t x) { return (int)x; }
};
template <> struct Elem<int> {
    static __device__ __forceinline__ float f(int x) { return (float)x; }
    static __device__ __forceinline__ int i(int x) { return x; }
};

// an element of type S as the evaluation type T
template <typename T, typename S> __device__ __forceinline__ T as_t(S x);
template <> __device__ __forceinline__ float as_t<float, float>(float x) { return x; }
template <> __device__ __forceinline__ float as_t<float, __nv_bfloat16>(__nv_bfloat16 x) { return Elem<__nv_bfloat16>::f(x); }
template <> __device__ __forceinline__ float as_t<float, __half>(__half x) { return Elem<__half>::f(x); }
template <> __device__ __forceinline__ float as_t<float, int8_t>(int8_t x) { return Elem<int8_t>::f(x); }
template <> __device__ __forceinline__ float as_t<float, int>(int x) { return Elem<int>::f(x); }
template <> __device__ __forceinline__ int as_t<int, float>(float x) { return Elem<float>::i(x); }
template <> __device__ __forceinline__ int as_t<int, __nv_bfloat16>(__nv_bfloat16 x) { return Elem<__nv_bfloat16>::i(x); }
template <> __device__ __forceinline__ int as_t<int, __half>(__half x) { return Elem<__half>::i(x); }
template <> __device__ __forceinline__ int as_t<int, int8_t>(int8_t x) { return Elem<int8_t>::i(x); }
template <> __device__ __forceinline__ int as_t<int, int>(int x) { return x; }

// element ``off`` of a tensor of type code ``dt``, as T
template <typename T>
__device__ __forceinline__ T load_as(const void* p, int dt, long long off) {
    switch (dt) {
        case DT_BF16: return as_t<T>(__ldg((const __nv_bfloat16*)p + off));
        case DT_F16: return as_t<T>(__ldg((const __half*)p + off));
        case DT_I8: return as_t<T>(__ldg((const int8_t*)p + off));
        case DT_I32: return as_t<T>(__ldg((const int*)p + off));
        default: return as_t<T>(__ldg((const float*)p + off));
    }
}

// store T into element ``off`` of a tensor of type code ``dt``
__device__ __forceinline__ void store_as(void* p, int dt, long long off, float v) {
    switch (dt) {
        case DT_BF16: ((__nv_bfloat16*)p)[off] = __float2bfloat16_rn(v); break;
        case DT_F16: ((__half*)p)[off] = __float2half_rn(v); break;
        case DT_I8: ((int8_t*)p)[off] = (int8_t)(int)v; break;
        case DT_I32: ((int*)p)[off] = (int)v; break;
        default: ((float*)p)[off] = v;
    }
}

__device__ __forceinline__ void store_as(void* p, int dt, long long off, int v) {
    switch (dt) {
        case DT_BF16: ((__nv_bfloat16*)p)[off] = __float2bfloat16_rn((float)v); break;
        case DT_F16: ((__half*)p)[off] = __float2half_rn((float)v); break;
        case DT_I8: ((int8_t*)p)[off] = (int8_t)v; break;
        case DT_I32: ((int*)p)[off] = v; break;
        default: ((float*)p)[off] = (float)v;
    }
}

// ------------------------------------------------------------ op tables
__device__ __forceinline__ float unary_op(int k, float x) {
    switch (k) {
        case 0: return -x;                                        // neg
        case 1: return expf(x);                                   // exp
        case 2: return logf(x);                                   // log
        case 3: return tanhf(x);                                  // tanh
        case 4: return sqrtf(x);                                  // sqrt
        case 5: return rsqrtf(x);                                 // rsqrt
        case 6: return 1.0f / (1.0f + expf(-x));                  // sigmoid
        case 7: return x > 0.0f ? x : 0.0f;                       // relu
        case 8: return fabsf(x);                                  // abs
        case 9: return x * x;                                     // square
        case 10: return erff(x);                                  // erf
        case 11: return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));  // gelu (exact)
        case 12: return x / (1.0f + expf(-x));                    // silu
        case 13: return (float)((x > 0.0f) - (x < 0.0f));         // sign
        case 14: return floorf(x);                                // floor
        default: return x;                                        // cast
    }
}

// the ops closed over the integers; the binding refuses the others
__device__ __forceinline__ int unary_op(int k, int x) {
    switch (k) {
        case 0: return -x;                   // neg
        case 7: return x > 0 ? x : 0;        // relu
        case 8: return x < 0 ? -x : x;       // abs
        case 9: return x * x;                // square
        case 13: return (x > 0) - (x < 0);   // sign
        default: return x;                   // floor, cast
    }
}

__device__ __forceinline__ float binary_op(int k, float a, float b) {
    switch (k) {
        case 0: return a + b;          // add
        case 1: return a - b;          // sub
        case 2: return a * b;          // mul
        case 3: return a / b;          // div
        case 4: return fmaxf(a, b);    // max
        case 5: return fminf(a, b);    // min
        default: return powf(a, b);    // pow
    }
}

__device__ __forceinline__ int binary_op(int k, int a, int b) {
    switch (k) {
        case 0: return a + b;          // add
        case 1: return a - b;          // sub
        case 2: return a * b;          // mul
        case 4: return a > b ? a : b;  // max
        default: return a < b ? a : b; // min
    }
}

// Evaluate a postfix program.  OP_LOAD a reads element off[a] of tensor
// ptr[a] (type dt[a]); a tensor whose bit is clear in ``valid`` reads 0
// there (the zero padding of an out-of-range halo read).
template <typename T>
__device__ T eval_prog(const Prog& pg, const void* const* ptr, const int* dt,
                       const long long* off, unsigned valid, T acc,
                       const double* consts) {
    T st[MAXSTACK];
    int sp = 0;
    for (int i = 0; i < pg.n; ++i) {
        const int c = pg.code[i];
        const int a = pg.arg[i];
        if (c == OP_LOAD) {
            st[sp++] = ((valid >> a) & 1u) ? load_as<T>(ptr[a], dt[a], off[a]) : (T)0;
        } else if (c == OP_CONST) {
            st[sp++] = (T)consts[a];
        } else if (c == OP_ACC) {
            st[sp++] = acc;
        } else if (c < OP_BINARY) {
            st[sp - 1] = unary_op(c - OP_UNARY, st[sp - 1]);
        } else {
            const T b = st[--sp];
            st[sp - 1] = binary_op(c - OP_BINARY, st[sp - 1], b);
        }
    }
    return st[sp - 1];
}
