/* Elementwise libm transcendentals over arrays.
 *
 * The reference's evaluators call the C library's float/double math
 * functions (expf/logf/... via the <cmath> overloads); numpy's SIMD
 * implementations differ from libm by ~1 ulp, which breaks bit-parity of
 * similarity matrices and therefore of DP scores.  This tiny native library
 * applies the exact libm functions over numpy buffers.
 *
 * Build: tools/build_native.py (cc -O2 -shared -fPIC -lm).
 */

#include <math.h>

#define VEC1F(NAME, FN)                                               \
    void NAME(const float *x, float *y, long n) {                     \
        for (long i = 0; i < n; ++i) y[i] = FN(x[i]);                 \
    }

#define VEC1D(NAME, FN)                                               \
    void NAME(const double *x, double *y, long n) {                   \
        for (long i = 0; i < n; ++i) y[i] = FN(x[i]);                 \
    }

VEC1F(v_expf, expf)
VEC1F(v_logf, logf)
VEC1F(v_log10f, log10f)
VEC1F(v_sqrtf, sqrtf)
VEC1F(v_erfcf, erfcf)
VEC1D(v_exp, exp)
VEC1D(v_log, log)
VEC1D(v_erfc, erfc)
VEC1D(v_sqrt, sqrt)

/* float x -> double exp(x) -> truncate to float: the pattern produced when
 * C++ code calls exp() on a float with only the double overload visible. */
void v_exp_f2d2f(const float *x, float *y, long n) {
    for (long i = 0; i < n; ++i) y[i] = (float)exp((double)x[i]);
}

void v_powf(const float *x, const float *p, float *y, long n) {
    for (long i = 0; i < n; ++i) y[i] = powf(x[i], p[i]);
}
