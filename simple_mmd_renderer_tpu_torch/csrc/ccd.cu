// CCD IK of one IK group (`core/pose.solve_ik_group_plain`) in one launch.
//
// No TPU kernel's port: the reference solves an IK group as an unrolled
// chain of XLA operations; the port's plain loop replays it as ~20,000
// one-microsecond torch kernels a group. The work is a serial chain of small
// dependent arithmetic on a few KB of state, so one thread solves one chain,
// reading and writing the pose's rows in global memory (L1-resident), and
// the whole body runs in the launch: the `ik_rot` reset, the FK of the links
// and the target, every iteration (the mirror rule while i < loop / 2),
// every link's axis, angle and Euler limit, the refresh of the chain's
// worlds, the target's FK, and the convergence test; a converged chain is
// frozen, as the plain loop's masked writes freeze it, and each iteration's
// active flag is written to `active` [loop * G] (the stage clock's CCD
// count), when given. Everything that varies between rigs comes from the
// group's tables: the per-link codes (fix type, limited, Euler order),
// parents, limits, angle limit and loop.
//
// The group is one block, its chains in lockstep as the plain loop's
// batched operations run them. A chain may read another's bones through an
// append parent (`_group_iks` keeps chains' bones and ancestors apart, not
// their append parents), and does so only in an FK phase (`fk_phase`): a
// barrier before the phase's reads and one between its reads and its
// writes give every chain what the batched `_fk_bones` reads. A block of
// kThreads threads shares out a larger group's chains.
//
// The bits are the plain loop's on the card. Built with --fmad=false, each
// elementwise operation rounds once, in the order the torch expression
// evaluates it; the libm calls are the CUDA math library aten calls. The
// primitives that round inside one aten or cuBLAS kernel are mirrored in the
// order they take on the card (found by probes on the H100):
//   torch.sum(., -1) of 3 terms: (a + c) + b; of 4: (a + c) + (b + d)
//   torch.linalg.vector_norm(., dim=-1) of 3: sqrt((a*a + c*c) + b*b)
//   torch.linalg.cross: fma(a_p, b_q, -(a_q * b_p))
//   the batched 4x4 product (`@`) and einsum("gji,gj->gi"): cuBLAS picks
//   its kernel, and with it the order of the dot products, by the batch.
//   `smr_ccd_orders` finds, on the device, which of the candidate orders
//   (`dot4`, `dot3`) reproduces cuBLAS's own answers at the group's batch;
//   the solve reads the two codes from `orders`.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr int kFixNone = 0;
constexpr int kFixAll = 4;
// Euler orders, as `IKSegment.codes` numbers them
constexpr int kXYZ = 0, kXZY = 1, kYXZ = 2, kYZX = 3, kZXY = 4, kZYX = 5;
constexpr int kThreads = 256;
constexpr int kDot4Orders = 2;
constexpr int kDot3Orders = 4;

struct Quat {
  float x, y, z, w;
};

struct Rig {                      // per-bone tables, [B] or [B, 3]
  const long long* parent;        // -1: none
  const long long* app;           // append parent, -1: none
  const float* app_ratio;
  const unsigned char* app_rot;
  const unsigned char* app_trans;
  const unsigned char* is_link;
  const float* offset;
  const float* anim_rot;
  const float* anim_trans;
  const float* morph_rot;
  const float* morph_trans;
};

struct Pose {                     // written in place
  float* world;                   // [B, 4, 4]
  float* total_rot;               // [B, 4]
  float* total_trans;             // [B, 3]
  float* pre_ik_rot;              // [B, 4]
  float* ik_rot;                  // [B, 4]
};

struct Group {
  const long long* links;         // [G, L], links[0] nearest the target
  const long long* link_parent;   // [G, L] (0 where none)
  const unsigned char* link_has_parent;  // [G, L]
  const long long* targets;       // [G]
  const long long* goals;         // [G]
  const float* angle_limit;       // [G]
  const float* limits_min;        // [G, L, 3]
  const float* limits_max;        // [G, L, 3]
  const int* codes;               // [3, L]: fix type, limited, Euler order
  int g, n_links, loop;
};

__device__ __forceinline__ Quat load_q(const float* p, long long i) {
  const float* q = p + 4 * i;
  return {q[0], q[1], q[2], q[3]};
}

__device__ __forceinline__ void store_q(float* p, long long i, Quat q) {
  float* o = p + 4 * i;
  o[0] = q.x;
  o[1] = q.y;
  o[2] = q.z;
  o[3] = q.w;
}

__device__ __forceinline__ void load_m(const float* world, long long i,
                                       float m[16]) {
  const float* p = world + 16 * i;
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = p[k];
}

__device__ __forceinline__ void store_m(float* world, long long i,
                                        const float m[16]) {
  float* p = world + 16 * i;
#pragma unroll
  for (int k = 0; k < 16; ++k) p[k] = m[k];
}

__device__ __forceinline__ void eye(float m[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = (k % 5 == 0) ? 1.0f : 0.0f;
}

// torch.clamp(x, min=lo) (a NaN stays NaN)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}

__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return (a + c) + (b + d);
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1]);
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int p = (i + 1) % 3, q = (i + 2) % 3;
    out[i] = __fmaf_rn(a[p], b[q], -(a[q] * b[p]));
  }
}

// x . y of 4 terms in cuBLAS's order `code` (the batched 4x4 product): the
// orders seen on the H100 (one FMA chain at G >= 2, two halves at G = 1)
__device__ __forceinline__ float dot4(float x0, float x1, float x2, float x3,
                                      float y0, float y1, float y2, float y3,
                                      int code) {
  if (code == 1) {
    return __fmaf_rn(x1, y1, x0 * y0) + __fmaf_rn(x3, y3, x2 * y2);
  }
  return __fmaf_rn(x3, y3, __fmaf_rn(x2, y2, __fmaf_rn(x1, y1, x0 * y0)));
}

// x . y of 3 terms in cuBLAS's order `code` (einsum "gji,gj->gi", a
// batched gemv): the four orders seen on the H100 between G = 1 and 4096
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2, int code) {
  switch (code) {
    case 1:
      return __fmaf_rn(x1, y1, x0 * y0) + x2 * y2;
    case 2:
      return (x0 * y0 + x2 * y2) + x1 * y1;
    case 3:
      return __fmaf_rn(x2, y2, x0 * y0) + x1 * y1;
    default:  // one chain of FMAs, j = 0..2
      return __fmaf_rn(x2, y2, __fmaf_rn(x1, y1, x0 * y0));
  }
}

// c = a @ b, row-major 4x4
__device__ __forceinline__ void mm4(const float a[16], const float b[16],
                                    float c[16], int code) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[4 * r + k] = dot4(a[4 * r], a[4 * r + 1], a[4 * r + 2], a[4 * r + 3],
                          b[k], b[4 + k], b[8 + k], b[12 + k], code);
    }
  }
}

// out[i] = sum_j m[j][i] * v[j] over the 3x3 block of a 4x4
__device__ __forceinline__ void rotate_t(const float m[16], const float v[3],
                                         float out[3], int code) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = dot3(m[i], m[4 + i], m[8 + i], v[0], v[1], v[2], code);
  }
}

// math3d.quat_mul
__device__ __forceinline__ Quat qmul(Quat a, Quat b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y + a.y * b.w + a.z * b.x - a.x * b.z,
          a.w * b.z + a.z * b.w + a.x * b.y - a.y * b.x,
          a.w * b.w - (a.x * b.x + a.y * b.y + a.z * b.z)};
}

__device__ __forceinline__ Quat conj(Quat q) { return {-q.x, -q.y, -q.z, q.w}; }

// math3d.affine(math3d.quat_to_mat3(q), t)
__device__ __forceinline__ void affine(Quat q, const float t[3],
                                       float m[16]) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float xy = q.x * q.y, yz = q.y * q.z, zx = q.z * q.x;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  m[0] = 1.0f - 2.0f * (yy + zz);
  m[1] = 2.0f * (xy - wz);
  m[2] = 2.0f * (zx + wy);
  m[3] = t[0];
  m[4] = 2.0f * (xy + wz);
  m[5] = 1.0f - 2.0f * (zz + xx);
  m[6] = 2.0f * (yz - wx);
  m[7] = t[1];
  m[8] = 2.0f * (zx - wy);
  m[9] = 2.0f * (yz + wx);
  m[10] = 1.0f - 2.0f * (xx + yy);
  m[11] = t[2];
  m[12] = 0.0f;
  m[13] = 0.0f;
  m[14] = 0.0f;
  m[15] = 1.0f;
}

// math3d.quat_slerp(identity, b, t)
__device__ Quat slerp_from_identity(Quat b, float t) {
  const Quat a = {0.0f, 0.0f, 0.0f, 1.0f};
  float comega = sum4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
  const bool flip = comega < 0.0f;
  comega = fabsf(comega);
  const float omega = acosf(clamp(comega, -1.0f, 1.0f));
  const bool small = omega <= kEps;
  const float somega = sinf(small ? 1.0f : omega);
  const float p = sinf((1.0f - t) * omega) / somega;
  float l = sinf(t * omega) / somega;
  l = flip ? -l : l;
  if (small) return a;
  return {a.x * p + b.x * l, a.y * p + b.y * l, a.z * p + b.z * l,
          a.w * p + b.w * l};
}

// math3d.axis_angle_to_quat
__device__ Quat axis_angle(const float axis[3], float angle) {
  const float norm = norm3(axis);
  const float half = angle * 0.5f;
  const float s = sinf(half) / clamp_min(norm, kEps);
  const float w = cosf(half);
  if (!(norm > kEps)) return {0.0f, 0.0f, 0.0f, 1.0f};
  return {s * axis[0], s * axis[1], s * axis[2], w};
}

__device__ __forceinline__ float asin_safe(float v) {
  return asinf(clamp(v, -1.0f, 1.0f));
}

// math3d.quat_to_euler
__device__ void quat_to_euler(Quat q, int order, float e[3]) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  const float xy = q.x * q.y, zx = q.z * q.x, yz = q.y * q.z;
  switch (order) {
    case kXYZ:
      e[0] = atan2f(2.0f * (wx - yz), 1.0f - 2.0f * (xx + yy));
      e[1] = asin_safe(2.0f * (wy + zx));
      e[2] = atan2f(2.0f * (wz - xy), 1.0f - 2.0f * (yy + zz));
      break;
    case kXZY:
      e[0] = atan2f(2.0f * (wx + yz), 1.0f - 2.0f * (xx + zz));
      e[1] = atan2f(2.0f * (wy + zx), 1.0f - 2.0f * (yy + zz));
      e[2] = asin_safe(2.0f * (wz - xy));
      break;
    case kYXZ:
      e[0] = asin_safe(2.0f * (wx - yz));
      e[1] = atan2f(2.0f * (wy + zx), 1.0f - 2.0f * (xx + yy));
      e[2] = atan2f(2.0f * (wz + xy), 1.0f - 2.0f * (xx + zz));
      break;
    case kYZX:
      e[0] = atan2f(2.0f * (wx - yz), 1.0f - 2.0f * (xx + zz));
      e[1] = atan2f(2.0f * (wy - zx), 1.0f - 2.0f * (yy + zz));
      e[2] = asin_safe(2.0f * (wz + xy));
      break;
    case kZXY:
      e[0] = asin_safe(2.0f * (wx + yz));
      e[1] = atan2f(2.0f * (wy - zx), 1.0f - 2.0f * (xx + yy));
      e[2] = atan2f(2.0f * (wz - xy), 1.0f - 2.0f * (xx + zz));
      break;
    default:  // kZYX
      e[0] = atan2f(2.0f * (wx + yz), 1.0f - 2.0f * (xx + yy));
      e[1] = asin_safe(2.0f * (wy - zx));
      e[2] = atan2f(2.0f * (wz + xy), 1.0f - 2.0f * (yy + zz));
      break;
  }
}

// math3d.euler_to_quat
__device__ Quat euler_to_quat(const float e[3], int order) {
  const float cx = cosf(e[0] * 0.5f), sx = sinf(e[0] * 0.5f);
  const float cy = cosf(e[1] * 0.5f), sy = sinf(e[1] * 0.5f);
  const float cz = cosf(e[2] * 0.5f), sz = sinf(e[2] * 0.5f);
  switch (order) {
    case kXYZ:
      return {sx * cy * cz + cx * sy * sz, cx * sy * cz - sx * cy * sz,
              sx * sy * cz + cx * cy * sz, cx * cy * cz - sx * sy * sz};
    case kXZY:
      return {sx * cy * cz - cx * sy * sz, cx * sy * cz - sx * cy * sz,
              cx * cy * sz + sx * sy * cz, cx * cy * cz + sx * sy * sz};
    case kYXZ:
      return {sx * cy * cz + cx * sy * sz, cx * sy * cz - sx * cy * sz,
              cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz};
    case kYZX:
      return {sx * cy * cz + cx * sy * sz, cx * sy * cz + sx * cy * sz,
              cx * cy * sz - sx * sy * cz, cx * cy * cz - sx * sy * sz};
    case kZXY:
      return {sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
              cx * cy * sz + sx * sy * cz, cx * cy * cz - sx * sy * sz};
    default:  // kZYX
      return {sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
              cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz};
  }
}

// pose._limit_euler; `mirror` is the i < loop / 2 flag
__device__ void limit_euler(float e[3], const float* emin, const float* emax,
                            bool mirror) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = e[k];
    const float lo = emin[k], hi = emax[k];
    const float tf_lo = 2.0f * lo - v;
    v = v < lo ? ((tf_lo <= hi && mirror) ? tf_lo : lo) : v;
    const float tf_hi = 2.0f * hi - v;
    v = v > hi ? ((tf_hi >= lo && mirror) ? tf_hi : hi) : v;
    e[k] = v;
  }
}

// the append parent's total_rot and total_trans that pose._fk_bones reads
// for bone b, into app[0..3] and app[4..6] where b appends them: read
// before the phase's writes, since another chain of the group may write
// them in the same phase
__device__ void fk_read_append(const Rig& rig, const Pose& s, long long b,
                               float* app) {
  const long long a = rig.app[b];
  if (a < 0) return;
  if (rig.app_rot[b]) {
    const Quat q = load_q(s.total_rot, a);
    app[0] = q.x;
    app[1] = q.y;
    app[2] = q.z;
    app[3] = q.w;
  }
  if (rig.app_trans[b]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) app[4 + k] = s.total_trans[3 * a + k];
  }
}

// pose._fk_bones for one bone b, its append parent's fields from `app`
// (`fk_read_append`); `all_fields`: also its total_trans and pre_ik_rot
// (the pre-loop FK; the loop's FK of the target keeps only its world and
// total_rot, as the plain loop's result does)
__device__ void fk_bone(const Rig& rig, const Pose& s, long long b,
                        const float* app, bool all_fields, int mm) {
  Quat tot = qmul(load_q(rig.morph_rot, b), load_q(rig.anim_rot, b));
  float tt[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tt[k] = rig.morph_trans[3 * b + k] + rig.anim_trans[3 * b + k];
  }
  const bool has_app = rig.app[b] >= 0;
  const float ratio = rig.app_ratio[b];
  if (rig.app_rot[b] && has_app) {
    tot = qmul(tot, slerp_from_identity({app[0], app[1], app[2], app[3]},
                                        ratio));
  }
  const bool app_t = rig.app_trans[b] && has_app;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    tt[k] = tt[k] + (app_t ? ratio * app[4 + k] : 0.0f);
  }
  const bool link = rig.is_link[b];
  const Quat pre = link ? tot : load_q(s.pre_ik_rot, b);
  if (link) tot = qmul(load_q(s.ik_rot, b), tot);
  float t[3], local[16], pw[16], w[16];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = tt[k] + rig.offset[3 * b + k];
  affine(tot, t, local);
  const long long parent = rig.parent[b];
  if (parent >= 0) {
    load_m(s.world, parent, pw);
  } else {
    eye(pw);
  }
  mm4(pw, local, w, mm);
  store_m(s.world, b, w);
  store_q(s.total_rot, b, tot);
  if (all_fields) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s.total_trans[3 * b + k] = tt[k];
    store_q(s.pre_ik_rot, b, pre);
  }
}

__device__ __forceinline__ void position(const float* world, long long b,
                                         float* p) {
  const float* m = world + 16 * b;
  p[0] = m[3];
  p[1] = m[7];
  p[2] = m[11];
}

__device__ __forceinline__ bool converged(const float* goal,
                                          const float* target) {
  float e[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) e[k] = goal[k] - target[k];
  return sum3(e[0] * e[0], e[1] * e[1], e[2] * e[2]) < kEps;
}

// the world of link k's parent (the identity where it has none)
__device__ __forceinline__ void link_parent_world(const Group& grp,
                                                  const Pose& s, int row,
                                                  float m[16]) {
  if (grp.link_has_parent[row]) {
    load_m(s.world, grp.link_parent[row], m);
  } else {
    eye(m);
  }
}

// chain g's link k, or its target where k < 0
__device__ __forceinline__ long long chain_bone(const Group& grp, int g,
                                                int k) {
  return k < 0 ? grp.targets[g]
               : grp.links[static_cast<long long>(g) * grp.n_links + k];
}

// the per-chain scratch `ws` [G, kWs]: the goal's position, the target's,
// the converged flag, the append fields of the FK phase's bone
constexpr int kWs = 16;
constexpr int kGoal = 0, kTarget = 3, kDone = 6, kApp = 8;

// the block's threads share out the group's chains
#define FOR_CHAINS(g) \
  for (int g = threadIdx.x; g < grp.g; g += blockDim.x)

// one FK phase, as the plain loop's batched `_fk_bones` of every chain's
// link k (the target where k < 0, whose position it then keeps): every
// chain's reads before any chain's write, and after every write of the
// phases before. `masked`: converged chains are left as they are
__device__ void fk_phase(const Rig& rig, const Pose& s, const Group& grp,
                         float* ws, int k, bool all_fields, bool masked,
                         int mm) {
  __syncthreads();
  FOR_CHAINS(g) {
    float* w = ws + kWs * g;
    if (masked && w[kDone] != 0.0f) continue;
    fk_read_append(rig, s, chain_bone(grp, g, k), w + kApp);
  }
  __syncthreads();
  FOR_CHAINS(g) {
    float* w = ws + kWs * g;
    if (masked && w[kDone] != 0.0f) continue;
    const long long b = chain_bone(grp, g, k);
    fk_bone(rig, s, b, w + kApp, all_fields, mm);
    if (k < 0) position(s.world, b, w + kTarget);
  }
}

// link j's step of chain g (the loop's body before the target's FK): its
// new ik_rot, then the chain's worlds from link j down to links[0]. It
// reads and writes chain g's own bones and their parents, which no other
// chain of the group writes (`_group_iks` groups chains whose bones and
// ancestors are apart), so it needs no barrier
__device__ void link_step(const Rig& rig, const Pose& s, const Group& grp,
                          int g, int j, bool mirror, const float* w, int mm,
                          int ein) {
  const int nl = grp.n_links;
  const int* fix = grp.codes;
  const int* limited = grp.codes + nl;
  const int* order = grp.codes + 2 * nl;
  const long long* links = grp.links + static_cast<long long>(g) * nl;
  const int row = g * nl + j;
  const long long b = links[j];
  const float* goal = w + kGoal;
  const float* tp = w + kTarget;
  float lp[3], td[3], id[3], axis[3], loc[16];
  position(s.world, b, lp);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    td[k] = lp[k] - tp[k];
    id[k] = lp[k] - goal[k];
  }
  const float tn = clamp_min(norm3(td), kEps);
  const float in = clamp_min(norm3(id), kEps);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    td[k] = td[k] / tn;
    id[k] = id[k] / in;
  }
  cross3(td, id, axis);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    axis[k] = fabsf(axis[k]) < kEps ? kEps : axis[k];
  }
  link_parent_world(grp, s, row, loc);
  if (limited[j] && fix[j] != kFixNone && mirror) {
    // the axis pinned to the parent-local fixed axis
    const int ai = fix[j] - 1;
    const float d = sum3(axis[0] * loc[ai], axis[1] * loc[4 + ai],
                         axis[2] * loc[8 + ai]);
    const float sign = d >= 0.0f ? 1.0f : -1.0f;
    axis[0] = axis[1] = axis[2] = 0.0f;
    axis[ai] = sign;
  } else {
    float r[3];
    rotate_t(loc, axis, r, ein);
    const float rn = clamp_min(norm3(r), kEps);
#pragma unroll
    for (int k = 0; k < 3; ++k) axis[k] = r[k] / rn;
  }
  const float cosang = clamp(sum3(td[0] * id[0], td[1] * id[1],
                                  td[2] * id[2]), -1.0f, 1.0f);
  const float angle = fminf(acosf(cosang),
                            grp.angle_limit[g] * static_cast<float>(j + 1));
  Quat new_ik = qmul(axis_angle(axis, angle), load_q(s.ik_rot, b));
  if (limited[j]) {
    const Quat pre = load_q(s.pre_ik_rot, b);
    float e[3];
    quat_to_euler(qmul(new_ik, pre), order[j], e);
    limit_euler(e, grp.limits_min + 3 * row, grp.limits_max + 3 * row,
                mirror);
    new_ik = qmul(euler_to_quat(e, order[j]), conj(pre));
  }
  store_q(s.ik_rot, b, new_ik);
  for (int k = j; k >= 0; --k) {
    const long long bk = links[k];
    const Quat tr = qmul(load_q(s.ik_rot, bk), load_q(s.pre_ik_rot, bk));
    float t[3], local[16], pw[16], wm[16];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t[c] = s.total_trans[3 * bk + c] + rig.offset[3 * bk + c];
    }
    affine(tr, t, local);
    link_parent_world(grp, s, g * nl + k, pw);
    mm4(pw, local, wm, mm);
    store_m(s.world, bk, wm);
    store_q(s.total_rot, bk, tr);
  }
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}

// the block's clocks at a barrier, into clocks[2 * at] (%globaltimer, ns)
// and clocks[2 * at + 1] (clock64, the SM's cycles)
__device__ __forceinline__ void mark(unsigned long long* clocks, int at) {
  if (!clocks) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    clocks[2 * at] = globaltimer();
    clocks[2 * at + 1] = static_cast<unsigned long long>(clock64());
  }
}

// one block: the group's chains in lockstep, phase by phase as the plain
// loop's batched operations run
__global__ void __launch_bounds__(kThreads)
ccd_kernel(Rig rig, Pose s, Group grp, const int* orders,
           unsigned char* active_out, float* ws, unsigned long long* clocks) {
  const int mm = orders[0], ein = orders[1];
  // no candidate order reproduces cuBLAS at this batch: fail, rather than
  // give other bits than the plain loop
  if (mm < 0 || ein < 0) __trap();
  const int nl = grp.n_links;
  mark(clocks, 0);
  FOR_CHAINS(g) {
    float* w = ws + kWs * g;
    for (int k = 0; k < nl; ++k) {
      store_q(s.ik_rot, chain_bone(grp, g, k), {0.0f, 0.0f, 0.0f, 1.0f});
    }
    position(s.world, grp.goals[g], w + kGoal);
  }
  // the links from the farthest, then the target
  for (int k = nl - 1; k >= -1; --k) {
    fk_phase(rig, s, grp, ws, k, true, false, mm);
  }
  FOR_CHAINS(g) {
    float* w = ws + kWs * g;
    w[kDone] = converged(w + kGoal, w + kTarget) ? 1.0f : 0.0f;
  }
  mark(clocks, 1);
  const int ikt = grp.loop / 2;
  for (int i = 0; i < grp.loop; ++i) {
    const bool mirror = i < ikt;
    if (active_out) {
      FOR_CHAINS(g) {
        active_out[static_cast<long long>(i) * grp.g + g] =
            ws[kWs * g + kDone] != 0.0f ? 0 : 1;
      }
    }
    for (int j = 0; j < nl; ++j) {
      if (grp.codes[j] == kFixAll) continue;
      FOR_CHAINS(g) {
        const float* w = ws + kWs * g;
        if (w[kDone] == 0.0f) link_step(rig, s, grp, g, j, mirror, w, mm, ein);
      }
      fk_phase(rig, s, grp, ws, -1, false, true, mm);
    }
    FOR_CHAINS(g) {
      float* w = ws + kWs * g;
      if (w[kDone] == 0.0f) {
        w[kDone] = converged(w + kGoal, w + kTarget) ? 1.0f : 0.0f;
      }
    }
  }
  mark(clocks, 2);
}

// the first candidate order of each product that reproduces cuBLAS's own
// answers on every sample (-1: none does)
__global__ void orders_kernel(const float* a, const float* b, const float* ab,
                              const float* v, const float* av, int n,
                              int* orders) {
  __shared__ int bad4[kDot4Orders], bad3[kDot3Orders];
  if (threadIdx.x < kDot4Orders) bad4[threadIdx.x] = 0;
  if (threadIdx.x < kDot3Orders) bad3[threadIdx.x] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < 16 * n; e += blockDim.x) {
    const int m = e / 16, r = (e / 4) % 4, k = e % 4;
    const float* x = a + 16 * m + 4 * r;
    const float* y = b + 16 * m + k;
    for (int c = 0; c < kDot4Orders; ++c) {
      const float got = dot4(x[0], x[1], x[2], x[3], y[0], y[4], y[8], y[12],
                             c);
      if (__float_as_int(got) != __float_as_int(ab[e])) atomicAdd(&bad4[c], 1);
    }
  }
  for (int e = threadIdx.x; e < 3 * n; e += blockDim.x) {
    const int m = e / 3, i = e % 3;
    const float* x = a + 16 * m + i;
    const float* y = v + 3 * m;
    for (int c = 0; c < kDot3Orders; ++c) {
      const float got = dot3(x[0], x[4], x[8], y[0], y[1], y[2], c);
      if (__float_as_int(got) != __float_as_int(av[e])) atomicAdd(&bad3[c], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int o4 = -1, o3 = -1;
    for (int c = kDot4Orders - 1; c >= 0; --c) o4 = bad4[c] == 0 ? c : o4;
    for (int c = kDot3Orders - 1; c >= 0; --c) o3 = bad3[c] == 0 ? c : o3;
    orders[0] = o4;
    orders[1] = o3;
  }
}

// the primitives alone, for the card's checks against torch
__global__ void primitive_kernel(const float* x, const float* y, float* out,
                                 int n, int which, int code) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  switch (which) {
    case 0:
      out[i] = sum3(x[3 * i], x[3 * i + 1], x[3 * i + 2]);
      break;
    case 1:
      out[i] = sum4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
      break;
    case 2:
      out[i] = norm3(x + 3 * i);
      break;
    case 3:
      cross3(x + 3 * i, y + 3 * i, out + 3 * i);
      break;
    case 4: {
      float a[16], b[16], c[16];
      for (int k = 0; k < 16; ++k) {
        a[k] = x[16 * i + k];
        b[k] = y[16 * i + k];
      }
      mm4(a, b, c, code);
      for (int k = 0; k < 16; ++k) out[16 * i + k] = c[k];
      break;
    }
    default: {
      float m[16];
      for (int k = 0; k < 16; ++k) m[k] = x[16 * i + k];
      rotate_t(m, y + 3 * i, out + 3 * i, code);
      break;
    }
  }
}

}  // namespace

extern "C" int smr_ccd(
    const void* parent, const void* app, const void* app_ratio,
    const void* app_rot, const void* app_trans, const void* is_link,
    const void* offset, const void* anim_rot, const void* anim_trans,
    const void* morph_rot, const void* morph_trans, void* world,
    void* total_rot, void* total_trans, void* pre_ik_rot, void* ik_rot,
    const void* links, const void* link_parent, const void* link_has_parent,
    const void* targets, const void* goals, const void* angle_limit,
    const void* limits_min, const void* limits_max, const void* codes, int g,
    int n_links, int loop, const void* orders, void* active, void* ws,
    void* clocks, void* stream) {
  if (g <= 0 || n_links <= 0 || loop < 0 || !orders || !ws)
    return static_cast<int>(cudaErrorInvalidValue);
  Rig rig = {static_cast<const long long*>(parent),
             static_cast<const long long*>(app),
             static_cast<const float*>(app_ratio),
             static_cast<const unsigned char*>(app_rot),
             static_cast<const unsigned char*>(app_trans),
             static_cast<const unsigned char*>(is_link),
             static_cast<const float*>(offset),
             static_cast<const float*>(anim_rot),
             static_cast<const float*>(anim_trans),
             static_cast<const float*>(morph_rot),
             static_cast<const float*>(morph_trans)};
  Pose s = {static_cast<float*>(world), static_cast<float*>(total_rot),
            static_cast<float*>(total_trans), static_cast<float*>(pre_ik_rot),
            static_cast<float*>(ik_rot)};
  Group grp = {static_cast<const long long*>(links),
               static_cast<const long long*>(link_parent),
               static_cast<const unsigned char*>(link_has_parent),
               static_cast<const long long*>(targets),
               static_cast<const long long*>(goals),
               static_cast<const float*>(angle_limit),
               static_cast<const float*>(limits_min),
               static_cast<const float*>(limits_max),
               static_cast<const int*>(codes), g, n_links, loop};
  const int threads = g < kThreads ? (g + 31) / 32 * 32 : kThreads;
  ccd_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rig, s, grp, static_cast<const int*>(orders),
      static_cast<unsigned char*>(active), static_cast<float*>(ws),
      static_cast<unsigned long long*>(clocks));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smr_ccd_orders(const void* a, const void* b, const void* ab,
                              const void* v, const void* av, int n,
                              void* orders, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  orders_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(ab), static_cast<const float*>(v),
      static_cast<const float*>(av), n, static_cast<int*>(orders));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smr_ccd_primitive(const void* x, const void* y, void* out,
                                 int n, int which, int code, void* stream) {
  if (n <= 0 || which < 0 || which > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  primitive_kernel<<<(n + 127) / 128, 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), n, which, code);
  return static_cast<int>(cudaGetLastError());
}
