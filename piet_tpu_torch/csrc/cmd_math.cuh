// Shared device math of the port's kernels: the exact helpers and the
// per-pixel command evaluators of piet_tpu_torch/ops/cmd_math.py, written
// expression for expression in the same order.
//
// Exactness contract (kernels.py builds with -fmad=false -prec-div=true
// -prec-sqrt=true -ftz=false): every multiply and add rounds on its own,
// division and sqrt are IEEE, denormals are kept.  Float constants are
// written as (float)<double literal>, which is how numpy and PyTorch round
// a python float to f32 (a direct 1.234f literal may round differently).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PIET_F32(x) ((float)(x))

namespace piet {

// Command tags (piet_tpu/raster/ptcl.py) and the entry word map
// (piet_tpu/layout/entry_stream.py).
constexpr int CMD_CIRCLE = 2, CMD_LINE = 3, CMD_FILL = 4, CMD_STROKE = 5,
              CMD_FILL_EDGE = 6, CMD_DRAW_FILL = 7, CMD_SOLID = 8,
              CMD_BEGIN_CLIP = 10, CMD_END_CLIP = 11, CMD_BEGIN_LAYER = 12,
              CMD_END_LAYER = 13, CMD_DRAW_LIN_GRAD = 14,
              CMD_DRAW_RAD_GRAD = 15, CMD_WIND = 16;
constexpr int ENTRY_WORDS = 16, W_S0_TAG = 0, W_S0_ARG = 1, W_S1_TAG = 8,
              W_S1_ARG = 9;
constexpr int META_CLEAR_BIT = 8;
constexpr int MAX_GROUP_DEPTH = 4;
// Initial SQUARED distance field (ops/cmd_math.py DF2_INIT).
constexpr float DF2_INIT = PIET_F32(1e18);

__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || a != a) ? a : b;  // NaN-propagating, as torch.minimum
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
// min and max that give the canonical NaN when an input is a NaN, in one
// instruction each (sm_80 and later).  The GPU's float arithmetic makes
// only that NaN, so for inputs that are arithmetic results -- every
// caller below -- they agree with tmin/tmax bit for bit, except that a
// pair of zeros of opposite signs may give the other zero: each caller
// says why that cannot change its result.  tmin/tmax take a compare, a
// NaN test and a select on the ALU pipe, which bounds the fine kernels.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
// tmin(v, 1) of an arithmetic result v (1 is no zero).
__device__ __forceinline__ float min1(float v) { return min_nan(v, 1.f); }
// tmin(tmax(v, 0), 1) of an arithmetic result v: tmax(-0, +0) is +0, so
// the sum with +0 (which leaves every other value as it is) settles the
// sign of a zero whichever zero max_nan returns.
__device__ __forceinline__ float sat(float v) {
  return __fadd_rn(min1(max_nan(v, 0.f)), 0.f);
}
// jnp.sign: keeps -0.0 and NaN (torch.sign does not).
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}
// Saturating float -> int32 (NaN -> 0), as XLA converts.
__device__ __forceinline__ int f2i_sat(float x) { return __float2int_rz(x); }
// int32 arithmetic that wraps, as torch's int32 tensors do.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// Exact floor-div/mod of small non-negative ints via f32 with residue
// fixup (piet_tpu/ops/coarse.py::_fdivmod).  w >= 1.
__device__ __forceinline__ void fdivmod(int local, int w, int* q_out,
                                        int* r_out) {
  float wf = (float)w;
  int q = __float2int_rz(floorf((float)local / wf));
  int r = local - q * w;
  q = q + (r >= w ? 1 : 0) - (r < 0 ? 1 : 0);
  *q_out = q;
  *r_out = local - q * w;
}

__device__ __forceinline__ float ieee_sqrt(float x) {
  const float s0 = sqrtf(x);
  const uint32_t ub = __float_as_uint(s0);
  float best_s = s0, best_a = INFINITY;
#pragma unroll
  for (int d = -2; d <= 2; ++d) {
    const float s = __uint_as_float(ub + (uint32_t)d);
    const float c = s * 4097.f;
    const float hi = c - (c - s);
    const float lo = s - hi;
    const float dd = ((hi * hi) - x) + (2.f * (hi * lo)) + (lo * lo);
    const float a = fabsf(dd);
    if (a < best_a) {
      best_s = s;
      best_a = a;
    }
  }
  return x > 0.f ? best_s : s0;
}

__device__ __forceinline__ float div_det(float a, float b) {
  const float q0 = a / b;
  const float cb = b * 4097.f;
  const float bh = cb - (cb - b);
  const float bl = b - bh;
  const uint32_t u0 = __float_as_uint(q0);
  float best_q = q0, best_r = INFINITY, best_ev = 0.f;
#pragma unroll
  for (int d = -3; d <= 3; ++d) {
    const uint32_t uq = u0 + (uint32_t)d;
    const float q = __uint_as_float(uq);
    const float cq = q * 4097.f;
    const float qh = cq - (cq - q);
    const float ql = q - qh;
    const float r = fabsf((((a - qh * bh) - qh * bl) - ql * bh) - ql * bl);
    const float ev = 1.f - (float)(uq & 1u);
    if ((r < best_r) || ((r == best_r) && (ev > best_ev))) {
      best_q = q;
      best_ev = ev;
      best_r = r;
    }
  }
  const bool ok = (b != 0.f) && (fabsf(q0) < INFINITY) && (q0 == q0);
  return ok ? best_q : q0;
}

// x*x + y*y from exact split squares (contraction-immune).
__device__ __forceinline__ float dot2_det(float x, float y) {
  const float cx = x * 4097.f, cy = y * 4097.f;
  const float xh = cx - (cx - x), yh = cy - (cy - y);
  const float xl = x - xh, yl = y - yh;
  return (((xh * xh) + (2.f * (xh * xl))) + (xl * xl)) +
         (((yh * yh) + (2.f * (yh * yl))) + (yl * yl));
}

__device__ __forceinline__ float line_field_sq(const float* a, float X,
                                               float Y) {
  const float sx = a[0], sy = a[1], ex = a[2], ey = a[3], inv_denom = a[5];
  const float lvx = ex - sx, lvy = ey - sy;
  const float dpx = X - sx, dpy = Y - sy;
  const float dotp = (lvx * dpx) + (lvy * dpy);
  const float tpar = inv_denom < INFINITY ? sat(dotp * inv_denom) : 0.f;
  const float fx = (lvx * tpar) - dpx;
  const float fy = (lvy * tpar) - dpy;
  return (fx * fx) + (fy * fy);
}

__device__ __forceinline__ float fill_F(float u) {
  const float c = sat(u);
  return min1(u) - (0.5f * (c * c));
}

// Returns the masked delta (0 where the mask is off) through *delta.
__device__ __forceinline__ bool fill_delta(const float* a, float X, float Y,
                                           float* delta) {
  const float sx = a[0], sy = a[1], ey = a[2], m = a[3], K = a[4];
  const float rsy = sy - Y;
  const float rey = ey - Y;
  const float w0 = sat(rsy);
  const float w1 = sat(rey);
  const bool mask = w0 != w1;
  // sat never gives -0, so no pair of zeros of opposite signs here.
  const float wa = min_nan(w0, w1);
  const float wb = max_nan(w0, w1);
  const float rx = sx - X;
  const float ua = rx + (m * (wa - rsy));
  const float ub = rx + (m * (wb - rsy));
  // Where ua and ub are zeros of opposite signs, umax - umin is a zero
  // whichever zeros min_nan/max_nan give, so the delta is deg, which
  // does not read them.
  const float umin = min_nan(ua, ub);
  const float umax = max_nan(ua, ub);
  const float d = (fill_F(umax) - fill_F(umin)) * K;
  const float u0 = w0 <= w1 ? ua : ub;
  const float deg = (1.f - sat(u0)) * (w0 - w1);
  *delta = (umax - umin > PIET_F32(1e-4)) ? d : deg;
  return mask;
}

__device__ __forceinline__ float edge_delta(const float* a, float Y) {
  return a[0] * sat(Y - a[1] + 1.f);
}

__device__ __forceinline__ float clip_alpha(float x, float even_odd) {
  const float eo = fabsf(x - 2.f * rintf(0.5f * x));
  const float nz = min1(fabsf(x));
  return even_odd != 0.f ? eo : nz;
}

// Coverage of the draw command's clip rect (operand words 8-11).
__device__ __forceinline__ float clip_cov(const float* a, float X, float Y) {
  const float covx = sat(tmin(a[10], X + 1.f) - tmax(a[8], X));
  const float covy = sat(tmin(a[11], Y + 1.f) - tmax(a[9], Y));
  return covx * covy;
}

// One pixel's interpreter state and the command evaluators of
// ops/cmd_math.py::make_commands / make_grad_commands, shared by the fine
// kernels.  The distance field is kept SQUARED (df2): a line takes the
// min of squared distances and a stroke takes the one correctly rounded
// sqrt of the min.  sqrt is monotone, so min(sqrt a, sqrt b) ==
// sqrt(min(a, b)) bit for bit, and sqrt(DF2_INIT) == DF_INIT.
//
// kStack: the clip-coverage and saved-rgb stacks of the group commands
// (MAX_GROUP_DEPTH each, in registers and local memory).  With it, every
// draw's alpha is multiplied by the open clip's coverage, as make_commands
// does when given ``cov``; without it there is no such multiply.  A draw
// may skip the multiply on a stack state (kCov = false) while no group
// command has run: the coverage is then cov[0] == 1, and alpha * 1 ==
// alpha on every f32 (a NaN alpha comes out of arithmetic, so it is the
// canonical NaN either way).
template <bool kStack>
struct PixelState {
  float r = 1.f, g = 1.f, b = 1.f, df2 = DF2_INIT, area = 0.f;
  float cov[kStack ? MAX_GROUP_DEPTH + 1 : 1];
  float svr[kStack ? MAX_GROUP_DEPTH : 1], svg[kStack ? MAX_GROUP_DEPTH : 1],
      svb[kStack ? MAX_GROUP_DEPTH : 1];
  int dclip = 0, dlayer = 0;
  float X, Y;

  // The stacks at their start: full coverage, ``saved`` planes (1 in the
  // entry-stream kernel, 0 in the dense group interpreter, as their JAX
  // counterparts start).  The fine kernels set them only when their first
  // group command comes: nothing reads them before.
  __device__ __forceinline__ void init_stacks(float saved) {
#pragma unroll
    for (int d = 0; d < (kStack ? MAX_GROUP_DEPTH + 1 : 1); ++d) cov[d] = 1.f;
#pragma unroll
    for (int d = 0; d < (kStack ? MAX_GROUP_DEPTH : 1); ++d)
      svr[d] = svg[d] = svb[d] = saved;
  }

  template <bool kCov = kStack>
  __device__ __forceinline__ float stack_cov(float alpha) const {
    return kCov ? alpha * cov[dclip] : alpha;
  }
  __device__ __forceinline__ void blend(float fr, float fg, float fb,
                                        float w) {
    r = r + (fr - r) * w;
    g = g + (fg - g) * w;
    b = b + (fb - b) * w;
  }

  template <bool kCov = kStack>
  __device__ __forceinline__ void circle(const float* a) {
    const float cx = a[0] + 0.5f * (a[2] - a[0]);
    const float cy = a[1] + 0.5f * (a[3] - a[1]);
    const float dx = X - cx, dy = Y - cy;
    const float rad = ieee_sqrt((dx * dx) + (dy * dy));
    const float circle_r = tmin(cx - a[0], cy - a[1]);
    float alpha = sat(circle_r - rad);
    alpha = stack_cov<kCov>(alpha * clip_cov(a, X, Y));
    const float keep = 1.f - alpha;
    r = r * keep;
    g = g * keep;
    b = b * keep;
  }
  // df2 and a squared field are never -0.
  __device__ __forceinline__ void line(const float* a) {
    df2 = min_nan(df2, line_field_sq(a, X, Y));
  }
  __device__ __forceinline__ void fill(const float* a) {
    float d;
    if (fill_delta(a, X, Y, &d)) area = area + d;
  }
  template <bool kCov = kStack>
  __device__ __forceinline__ void stroke(const float* a) {
    const float df = ieee_sqrt(df2);
    float alpha = sat(a[0] + 0.5f - df);
    alpha = stack_cov<kCov>(alpha * clip_cov(a, X, Y));
    blend(a[1], a[2], a[3], a[4] * alpha);
    df2 = DF2_INIT;
  }
  __device__ __forceinline__ void fill_edge(const float* a) {
    area = area + edge_delta(a, Y);
  }
  template <bool kCov = kStack>
  __device__ __forceinline__ void draw_fill(const float* a) {
    const float x = area + a[0];
    float alpha = clip_alpha(x, a[5]);
    alpha = stack_cov<kCov>(alpha * clip_cov(a, X, Y));
    blend(a[1], a[2], a[3], a[4] * alpha);
    area = 0.f;
  }
  template <bool kCov = kStack>
  __device__ __forceinline__ void solid(const float* a) {
    const float alpha = stack_cov<kCov>(1.f * clip_cov(a, X, Y));
    blend(a[0], a[1], a[2], a[3] * alpha);
  }
  __device__ __forceinline__ void begin_clip(const float* a) {
    const float x = area + a[0];
    const float ca = clip_alpha(x, a[1]);
    const int nd = min(dclip + 1, MAX_GROUP_DEPTH);
    cov[nd] = cov[dclip] * ca;
    dclip = nd;
    area = 0.f;
  }
  __device__ __forceinline__ void end_clip() { dclip = max(dclip - 1, 0); }
  __device__ __forceinline__ void begin_layer() {
    const int ld = min(dlayer, MAX_GROUP_DEPTH - 1);
    svr[ld] = r;
    svg[ld] = g;
    svb[ld] = b;
    dlayer = ld + 1;
  }
  __device__ __forceinline__ void end_layer(const float* a) {
    const float alpha = a[0];
    const int ld = max(dlayer - 1, 0);
    r = svr[ld] + (r - svr[ld]) * alpha;
    g = svg[ld] + (g - svg[ld]) * alpha;
    b = svb[ld] + (b - svb[ld]) * alpha;
    dlayer = ld;
  }
  template <bool kCov = kStack>
  __device__ __forceinline__ void gradient(const float* a, bool radial) {
    float tg;
    if (radial) {
      const float dx = X - a[1], dy = Y - a[2];
      tg = sat(ieee_sqrt((dx * dx) + (dy * dy)) * a[3]);
    } else {
      tg = sat((a[1] * X) + (a[2] * Y) + a[3]);
    }
    const float fr = a[4] + (a[8] - a[4]) * tg;
    const float fg = a[5] + (a[9] - a[5]) * tg;
    const float fb = a[6] + (a[10] - a[6]) * tg;
    const float fa = a[7] + (a[11] - a[7]) * tg;
    const float x = area + a[0];
    const float alpha = stack_cov<kCov>(min1(fabsf(x)));
    blend(fr, fg, fb, fa * alpha);
    area = 0.f;
  }
  __device__ __forceinline__ void wind(const float* a) { area = area + a[0]; }
};

// Deterministic linear -> sRGB u8 code (scene/color.py::linear_to_srgb_det).
__device__ __forceinline__ uint32_t srgb_encode(float ch) {
  const float PL[9] = {
      __uint_as_float(0xbc11672du), __uint_as_float(0x3df85f12u),
      __uint_as_float(0xbf3c26e2u), __uint_as_float(0x40265a14u),
      __uint_as_float(0xc0be1d92u), __uint_as_float(0x41133b6au),
      __uint_as_float(0xc11f25bau), __uint_as_float(0x41021532u),
      __uint_as_float(0xc05af24eu)};
  const float PE[6] = {
      __uint_as_float(0x3af86540u), __uint_as_float(0x3c129325u),
      __uint_as_float(0x3d64d0e6u), __uint_as_float(0x3e75e776u),
      __uint_as_float(0x3f317295u), __uint_as_float(0x3f7ffffeu)};
  ch = sat(ch);
  const float lo = ch * PIET_F32(12.92);
  const uint32_t u = __float_as_uint(ch);
  const float e = (float)((int)((u >> 23) & 0x1FFu) - 127);
  const float m = __uint_as_float((u & 0x007FFFFFu) | 0x3F800000u);
  float acc = PL[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) acc = (acc * m) + PL[i];
  const float t = (e + acc) * PIET_F32(1.0 / 2.4);
  const float k = floorf(t);
  const float fr = t - k;
  const float s =
      __int_as_float((int)((unsigned)(__float2int_rz(k) + 127) << 23));
  float pe = PE[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) pe = (pe * fr) + PE[i];
  const float hi = (PIET_F32(1.055) * (s * pe)) - PIET_F32(0.055);
  const float srgb = ch < PIET_F32(0.0031308) ? lo : hi;
  return (uint32_t)__float2int_rn(srgb * 255.f);
}

__device__ __forceinline__ uint32_t pack_rgba8(float r, float g, float b) {
  return srgb_encode(r) | (srgb_encode(g) << 8) | (srgb_encode(b) << 16) |
         0xFF000000u;
}

}  // namespace piet
