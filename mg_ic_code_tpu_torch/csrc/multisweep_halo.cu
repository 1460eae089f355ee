// The multisweep march (csrc/multisweep_march.cuh, which says what it
// computes and how it is built) on ONE SHARD of a level cut over a device
// mesh (parallel/halo.py): an x-slab whose neighbours' rows sit in
// (2H, ny, nz) pads beside it (ops/fused_sweeps.multisweep_relax(halo=...),
// the JAX package's mg_ic_code_tpu/ops/fused_sweeps.py:378 multisweep_relax
// in its halo form), or an (x, y) pencil prepadded by H on both sides of x
// and y (ops/fused_sweeps.multisweep_relax_tiled_pre, :1540
// multisweep_relax_tiled_pre). A seam between shards is an open segment end
// whose planes come from the pads; only the faces flagged as the domain's
// take the ghost rule; the parity and the y face rule stay in the level's
// frame. The body is the whole-level one of csrc/multisweep.cu with the
// planes outside [0, nx) read from the pads instead of modulo nx.
#include "multisweep_march.cuh"

namespace {

// Where the march reads its planes: the source-indexing policy, a template
// parameter so that each form compiles to its own code. Plane q of u is at
// u + q*sx for 0 <= q < nx; a plane outside [0, nx) is read only beyond an
// OPEN segment end (a seam; at an x face of the domain the ghost rule
// stands in), and is
//   SRC_SLAB:  in the (2H, ny, nz) pads of an x-slab of a sharded level,
//              H = NP: rows [0, H) below the slab, [H, 2H) above;
//   SRC_PRE:   in the same array: a pencil prepadded by H on both sides of x
//              and y, u pointing at its cell (0, 0, 0); its y has H pad
//              columns on each side, and its y face rule fires at global
//              rows 0 and ny_global - 1 (y_off + row). out has its own
//              plane stride there.
// The same for rhs and a.
enum MarchSource { SRC_SLAB = 1, SRC_PRE = 2 };

// The source's shape.
struct MarchGeom {
  long long sx, sxo;     // plane strides of the inputs and of out
  int face_lo, face_hi;  // the x faces at planes 0 and nx - 1 are the
                         // domain's (else seams)
  int y_off, ny_global;  // SRC_PRE
};

// What a launch reads: u, rhs, a at cell (0, 0, 0), the SRC_SLAB pads. The
// arrays are separate __restrict__ parameters of the kernel: out never
// aliases an input.
template <typename T>
struct MarchSrc {
  const T* u; const T* rhs; const T* a;
  const T* upad; const T* rpad; const T* apad;
  MarchGeom g;
};

// What a thread marching a shard carries beyond WaveThread.
template <typename T>
struct ShardThread {
  const T* upad; const T* rpad; const T* apad;  // SRC_SLAB
  long long sxo;          // plane stride of out
  bool face_lo, face_hi;  // plane 0 / nx-1 lies at an x face of the domain
};

// Where plane q of every array is: at offset `off` from the array's plane 0,
// or (SRC_SLAB, q outside [0, nx); `pad` set) from its pad's row 0. One
// offset serves u, rhs and a alike, so it is computed once per plane.
template <int SRC, int NP, typename T>
__device__ __forceinline__ long long plane_off(const WaveThread<T>& w, int q,
                                               bool& pad) {
  pad = false;
  if constexpr (SRC == SRC_SLAB) {
    if (q < 0) {
      pad = true;
      return (q + NP) * w.sx;
    }
    if (q >= w.nx) {
      pad = true;
      return (q - w.nx + NP) * w.sx;
    }
  }
  return q * w.sx;
}

// One step of the march: plane t+1 enters the ring, plane t+2 is loaded,
// and pass ps works on plane t - ps for ps = 0 .. NP-1, in the pair's
// column whose cells have this step's colour.
//
// STEADY: every plane t+2 .. t-NP lies inside (xs, xe), inside [0, nx) and
// away from the x faces of the domain, so no pass needs a validity test, an
// x-face rule or a wrapped index, and the ring slot of plane t is the
// compile-time ST: every shared-memory address is the thread's base plus a
// constant. Otherwise `st` is t's slot at run time and every pass is tested.
template <typename T, int NP, int TY, int TZ, int SRC, bool STEADY, int ST>
__device__ __forceinline__ void wave_step(WaveThread<T>& w,
                                          const ShardThread<T>& x,
                                          const int t, const int st_rt) {
  using L = WaveLayout<TY, TZ>;
  constexpr int R = NP + 2;
  constexpr int HP = L::HP, PZ = L::PZ, PLANE = L::PLANE;
  const int st = STEADY ? ST : st_rt;
  // the x faces of the domain, the plane stride of out, the pads
  const bool face_lo = x.face_lo, face_hi = x.face_hi;
  const long long so = x.sxo;
  const T *upad = x.upad, *rpad = x.rpad, *apad = x.apad;
  // offset of plane q, and whether it lies in the pads (a steady step
  // stays inside [0, nx))
  bool in_pad = false;
  auto xo = [&](int q) {
    return STEADY ? q * w.sx : plane_off<SRC, NP>(w, q, in_pad);
  };
  // slot of plane t + d
  auto slot = [&](int d) {
    int s = st + d;
    if (s < 0) s += R;
    if (s >= R) s -= R;
    return s;
  };
  // column 0 of the pair lives in half (row parity), column 1 in the other
  const int half0 = w.jpar ? HP : 0, half1 = HP - half0;

  if (STEADY || t + 1 < w.xe) {
    T* pl = w.cell + slot(1) * PLANE;
    pl[half0] = w.raw_u[0];
    pl[half1] = w.raw_u[1];
  }
  if (STEADY || t + 2 < w.xe) {
    const long long o = xo(t + 2);
    const T* next = (in_pad ? upad : w.u) + o;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      w.raw_u[c] = w.live[c] ? __ldg(next + w.coff[c]) : (T)0;
  }

  // the column of the pair whose cells have this step's colour
  const int c = (t + w.par) & 1;
  const bool act = c ? w.live[1] : w.live[0];
  const int col = c ? w.coff[1] : w.coff[0];
  // a, rhs of this step's cells: plane t came with the step before, the
  // older planes are in cache (loads in flight over the barrier), and the
  // next step's first cell is asked for now
  T av[NP], rv[NP];
  av[0] = w.next_a;
  rv[0] = w.next_r;
  const T* ap = w.a + t * w.sx;
  const T* rp = w.rhs + t * w.sx;
  const int sxi = (int)w.sx;
#pragma unroll
  for (int ps = 1; ps < NP; ++ps) {
    av[ps] = (T)0; rv[ps] = (T)0;
    if (STEADY) {
      if (act) {
        av[ps] = __ldg(ap + (col - ps * sxi));
        rv[ps] = __ldg(rp + (col - ps * sxi));
      }
    } else if (act && t - ps >= w.xs && t - ps < w.xe) {
      const long long o = xo(t - ps) + col;
      av[ps] = __ldg((in_pad ? apad : w.a) + o);
      rv[ps] = __ldg((in_pad ? rpad : w.rhs) + o);
    }
  }
  {
    const int ncol = c ? w.coff[0] : w.coff[1];
    w.next_a = (T)0; w.next_r = (T)0;
    if (STEADY) {
      if (c ? w.live[0] : w.live[1]) {
        w.next_a = __ldg(ap + (ncol + sxi));
        w.next_r = __ldg(rp + (ncol + sxi));
      }
    } else if ((c ? w.live[0] : w.live[1]) && t + 1 < w.xe) {
      const long long o = xo(t + 1) + ncol;
      w.next_a = __ldg((in_pad ? apad : w.a) + o);
      w.next_r = __ldg((in_pad ? rpad : w.rhs) + o);
    }
  }
  // P = lambda*beta/dx^2, 1 - lambda*alpha*a, lambda*rhs
  T Pc[NP], kc[NP], tr[NP];
#pragma unroll
  for (int ps = 0; ps < NP; ++ps) {
    const T aa = w.alpha * av[ps];
    const T lam = recip(aa + w.six_b_inv);
    Pc[ps] = lam * w.b_inv;
    kc[ps] = (T)1 - lam * aa;
    tr[ps] = lam * rv[ps];
  }
  __syncthreads();

  // the half the step's cells live in, and the way to the other half
  const int half = c ? half1 : half0;
  const int dh = HP - 2 * half;
  if (act) {
    // Everything a step reads was written before the barrier, apart from
    // the thread's own results: the own column of planes t+1 .. t-NP and
    // the y and z neighbours of every pass are loaded up front, and the NP
    // updates then run from registers.
    const T* rb = w.cell + half;
    const T* yp = rb + (dh + PZ);
    const T* ym = rb + (dh - PZ);
    const T* zp = rb + (dh + c);      // even column: same index, odd: +1
    const T* zm = rb + (dh + c - 1);  // even column: index - 1, odd: same
    const T wza = c ? w.wza[1] : w.wza[0], wzb = c ? w.wzb[1] : w.wzb[0];
    const T cz = c ? w.csz[1] : w.csz[0];
    T own_u[NP + 2];
#pragma unroll
    for (int i = 0; i < NP + 2; ++i) own_u[i] = rb[slot(1 - i) * PLANE];
    T yz[NP];
#pragma unroll
    for (int ps = 0; ps < NP; ++ps) {
      const int o = slot(-ps) * PLANE;
      T nb = (Pc[ps] * w.wya) * yp[o];
      nb = nb + (Pc[ps] * w.wyb) * ym[o];
      nb = nb + (Pc[ps] * wza) * zp[o];
      nb = nb + (Pc[ps] * wzb) * zm[o];
      yz[ps] = nb;
    }
    T* wb = w.cell + half;
    T up = own_u[0];
    bool have_up = STEADY;
#pragma unroll
    for (int ps = 0; ps < NP; ++ps) {
      const int q = t - ps;
      if (!STEADY && (q < w.xs || q >= w.xe)) continue;
      const T uc = own_u[ps + 1];
      T nb = (T)0, cs = (T)0;
      if (STEADY) {
        nb = Pc[ps] * up;
        nb = nb + Pc[ps] * own_u[ps + 2];
      } else {
        // beyond an open segment end the cell reads itself
        const T upv = have_up ? up : (q + 1 < w.xe ? own_u[ps] : uc);
        const T umv = q > w.xs ? own_u[ps + 2] : uc;
        fold_terms<T>(upv, umv, face_lo && q == 0,
                      face_hi && q == w.nx - 1,
                      w.c0xlo, w.c1xlo, w.c0xhi, w.c1xhi, Pc[ps], nb, cs);
      }
      cs = (cs + w.csy) + cz;
      const T k_uc = kc[ps] + Pc[ps] * (cs - (T)6);
      const T un = (k_uc * uc + tr[ps]) + (nb + yz[ps]);
      wb[slot(-ps) * PLANE] = un;
      up = un;
      have_up = true;
      // the last pass of plane q: final
      if (ps == NP - 1 && q >= w.x0 && q < w.x1 && (c ? w.own[1] : w.own[0]))
        w.out[q * so + col] = un;
    }
  }

  // plane t - NP + 1 has had its last pass: the pair's other column has
  // been final since the step before
  const int qo = t - NP + 1;
  if (qo >= w.x0 && qo < w.x1 && (c ? w.own[0] : w.own[1]))
    w.out[qo * so + (c ? w.coff[0] : w.coff[1])] =
        w.cell[slot(1 - NP) * PLANE + half + dh];
}

// st == ST picks the instantiation whose ring slots are constants
template <typename T, int NP, int TY, int TZ, int SRC, int ST>
__device__ __forceinline__ void steady_step(WaveThread<T>& w,
                                            const ShardThread<T>& x,
                                            int t, int st) {
  if constexpr (ST < NP + 2) {
    if (st == ST) wave_step<T, NP, TY, TZ, SRC, true, ST>(w, x, t, st);
    else steady_step<T, NP, TY, TZ, SRC, ST + 1>(w, x, t, st);
  }
}

template <typename T, int NP, int TY, int TZ, int SRC>
__global__ void __launch_bounds__((TY * TZ) / 2)
march_kernel(const T* __restrict__ u, const T* __restrict__ rhs,
             const T* __restrict__ a, const T* __restrict__ upad,
             const T* __restrict__ rpad, const T* __restrict__ apad,
             T* __restrict__ out, const MarchGeom g, const LevelParams<T> p,
             const int base, const int xseg) {
  using L = WaveLayout<TY, TZ>;
  constexpr int R = NP + 2;       // planes in the ring
  constexpr int HZ = L::HZ;
  extern __shared__ __align__(16) unsigned char wave_smem[];
  T* ring = reinterpret_cast<T*>(wave_smem);
  // zero the ring: the padding stays zero, and no slot ever holds anything
  // but finite values
  for (int i = threadIdx.x; i < R * L::PLANE; i += blockDim.x) ring[i] = (T)0;
  __syncthreads();

  const int kk = threadIdx.x % HZ;
  const int jj = threadIdx.x / HZ;
  const int lk = 2 * kk;
  // unwrapped global indices of the thread's row and first column
  const int uj = (int)blockIdx.y * (TY - 2 * NP) - NP + jj;
  const int uk = (int)blockIdx.x * (TZ - 2 * NP) - NP + lk;

  WaveThread<T> w;
  w.u = u; w.rhs = rhs; w.a = a; w.out = out;
  w.cell = ring + (jj + 1) * L::PZ + kk + 1;
  w.jpar = jj & 1;
  w.sx = g.sx;
  w.nx = p.nx;
  w.x0 = (int)blockIdx.z * xseg;
  w.x1 = min(p.nx, w.x0 + xseg);
  // a shard's periodic x wraps through its pads, never modulo nx
  w.wrapx = false;
  ShardThread<T> x;
  x.upad = upad; x.rpad = rpad; x.apad = apad;
  x.sxo = g.sxo;
  const bool face_lo = x.face_lo = g.face_lo != 0;
  const bool face_hi = x.face_hi = g.face_hi != 0;
  // a segment end at an x face of the domain stops there; every other end
  // (a seam between shards, a cut inside the shard) is open
  w.xs = face_lo ? max(0, w.x0 - NP) : w.x0 - NP;
  w.xe = face_hi ? min(p.nx, w.x1 + NP) : w.x1 + NP;
  w.par = uj + uk + base;
  w.alpha = p.alpha; w.six_b_inv = p.six_b_inv; w.b_inv = p.b_inv;
  w.c0xlo = p.c0[0][0]; w.c1xlo = p.c1[0][0];
  w.c0xhi = p.c0[0][1]; w.c1xhi = p.c1[0][1];

  const bool py = p.periodic[1] != 0, pz = p.periodic[2] != 0;
  const T one = (T)1;
  int gj = uj;
  bool live_j = uj >= 0 && uj < p.ny;
  bool ylo = !py && gj == 0, yhi = !py && gj == p.ny - 1;
  if constexpr (SRC == SRC_PRE) {
    // prepadded: the pad columns are real rows of the neighbours, apart
    // from those beyond a y face of the domain, which are never read
    const int yg = uj + g.y_off;
    live_j = uj >= -NP && uj < p.ny + NP &&
             (py || (yg >= 0 && yg < g.ny_global));
    ylo = !py && yg == 0;
    yhi = !py && yg == g.ny_global - 1;
  } else if (py) {
    gj = uj % p.ny;
    if (gj < 0) gj += p.ny;
    live_j = true;
  }
  const bool own_j = jj >= NP && jj < TY - NP && uj < p.ny;
  w.wya = yhi ? (T)0 : (ylo ? one + p.c1[1][0] : one);
  w.wyb = ylo ? (T)0 : (yhi ? one + p.c1[1][1] : one);
  w.csy = (ylo ? p.c0[1][0] : (T)0) + (yhi ? p.c0[1][1] : (T)0);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int ukc = uk + c;
    int gk = ukc;
    bool live_k = ukc >= 0 && ukc < p.nz;
    if (pz) {
      gk = ukc % p.nz;
      if (gk < 0) gk += p.nz;
      live_k = true;
    }
    w.live[c] = live_j && live_k;
    w.own[c] = own_j && w.live[c] && lk + c >= NP && lk + c < TZ - NP &&
               ukc < p.nz;
    w.coff[c] = gj * p.nz + gk;
    const bool zlo = !pz && gk == 0, zhi = !pz && gk == p.nz - 1;
    w.wza[c] = zhi ? (T)0 : (zlo ? one + p.c1[2][0] : one);
    w.wzb[c] = zlo ? (T)0 : (zhi ? one + p.c1[2][1] : one);
    w.csz[c] = (zlo ? p.c0[2][0] : (T)0) + (zhi ? p.c0[2][1] : (T)0);
  }

  // plane xs enters the ring, plane xs + 1 is loaded, and a, rhs of the
  // first step's first cell
  int st = w.xs % R;
  if (st < 0) st += R;
  {
    T* pl = w.cell + st * L::PLANE;
    const int half0 = w.jpar ? L::HP : 0;
    bool pad0, pad1;
    const long long o = plane_off<SRC, NP>(w, w.xs, pad0);
    const long long o1 = plane_off<SRC, NP>(w, w.xs + 1, pad1);
    const T* u0 = (pad0 ? upad : u) + o;
    const T* u1 = (pad1 ? upad : u) + o1;
    pl[half0] = w.live[0] ? u0[w.coff[0]] : (T)0;
    pl[L::HP - half0] = w.live[1] ? u0[w.coff[1]] : (T)0;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      w.raw_u[c] = (w.live[c] && w.xs + 1 < w.xe) ? u1[w.coff[c]] : (T)0;
    const int c = (w.xs + w.par) & 1;
    const bool act = c ? w.live[1] : w.live[0];
    const int col = c ? w.coff[1] : w.coff[0];
    w.next_a = act ? ((pad0 ? apad : a) + o)[col] : (T)0;
    w.next_r = act ? ((pad0 ? rpad : rhs) + o)[col] : (T)0;
  }

  // steps xs .. xe+NP-2; those in [lo_s, hi_s) are steady: t - NP >= xs,
  // t + 2 < xe, no plane of the staircase at an x face of the domain, and
  // every plane t - NP .. t + 2 inside [0, nx) (none in the pads)
  const int lo_s = max(w.xs, 0) + NP, hi_s = min(w.xe, p.nx) - 2;
  int t = w.xs;
  const int last = w.xe + NP - 1;
  for (; t < last && t < lo_s; ++t, st = st + 1 == R ? 0 : st + 1)
    wave_step<T, NP, TY, TZ, SRC, false, 0>(w, x, t, st);
  for (; t < hi_s; ++t, st = st + 1 == R ? 0 : st + 1)
    steady_step<T, NP, TY, TZ, SRC, 0>(w, x, t, st);
  for (; t < last; ++t, st = st + 1 == R ? 0 : st + 1)
    wave_step<T, NP, TY, TZ, SRC, false, 0>(w, x, t, st);
}

template <typename T, int NP, int TY, int TZ, int SRC>
cudaError_t launch_tile(const MarchSrc<T>& src, T* out,
                        const LevelParams<T>& p, int base,
                        cudaStream_t stream) {
  constexpr int TIY = TY - 2 * NP, TIZ = TZ - 2 * NP;
  static_assert(TIY > 0 && TIZ > 0 && TZ % 2 == 0, "tile too small");
  const int nty = (p.ny + TIY - 1) / TIY, ntz = (p.nz + TIZ - 1) / TIZ;
  const size_t smem = (size_t)(NP + 2) * WaveLayout<TY, TZ>::PLANE * sizeof(T);
  const int threads = (TY * TZ) / 2;
  auto kern = march_kernel<T, NP, TY, TZ, SRC>;
  static int cache[kMaxDevices] = {};
  int capacity = 0;
  cudaError_t err =
      march_capacity((const void*)kern, threads, smem, cache, &capacity);
  if (err != cudaSuccess) return err;
  int nseg = 1, xseg = p.nx;
  march_segments(p.nx, (long long)nty * ntz, capacity, NP, &nseg, &xseg);
  dim3 grid((unsigned)ntz, (unsigned)nty, (unsigned)nseg);
  kern<<<grid, threads, smem, stream>>>(src.u, src.rhs, src.a, src.upad,
                                        src.rpad, src.apad, out, src.g, p,
                                        base, xseg);
  return cudaGetLastError();
}


template <int SRC, typename T>
cudaError_t launch_multisweep(const MarchSrc<T>& src, T* out,
                              const LevelParams<T>& p, int base, int nsweeps,
                              cudaStream_t stream) {
  // a periodic axis that wraps inside a tile must have an even extent so
  // that the checkerboard stays consistent across the wrap (an axis that
  // wraps through pads was checked by the caller on the level)
  if ((SRC != SRC_PRE && p.periodic[1] && p.ny % 2) ||
      (p.periodic[2] && p.nz % 2))
    return cudaErrorInvalidValue;
  if (nsweeps == 2)
    return launch_tile<T, 4, 40, 40, SRC>(src, out, p, base, stream);
  if (nsweeps == 4)
    return launch_tile<T, 8, 40, 40, SRC>(src, out, p, base, stream);
  return cudaErrorInvalidValue;
}

// An x-slab with (2H, ny, nz) pads (SRC_SLAB).
template <typename T>
MarchSrc<T> padded_slab(const T* u, const T* rhs, const T* a, const T* upad,
                        const T* rpad, const T* apad, const LevelParams<T>& p,
                        int face_lo, int face_hi) {
  const long long sx = (long long)p.ny * p.nz;
  return MarchSrc<T>{u, rhs, a, upad, rpad, apad,
                     MarchGeom{sx, sx, face_lo, face_hi, 0, p.ny}};
}

// A pencil prepadded by H on both sides of x and y: (nx+2H, ny+2H, nz)
// (SRC_PRE).
template <typename T>
MarchSrc<T> prepadded(const T* u_pre, const T* r_pre, const T* a_pre,
                      const LevelParams<T>& p, int face_lo, int face_hi,
                      int y_off, int ny_global, int H) {
  const long long sx = (long long)(p.ny + 2 * H) * p.nz;
  const long long o = H * sx + (long long)H * p.nz;  // cell (0, 0, 0)
  return MarchSrc<T>{u_pre + o, r_pre + o, a_pre + o, nullptr, nullptr,
                     nullptr, MarchGeom{sx, (long long)p.ny * p.nz, face_lo,
                                        face_hi, y_off, ny_global}};
}

}  // namespace

// C entry point: out <- nsweeps (2 or 4) sweeps of the (nx, ny, nz) x-slab u
// of a sharded level, with (2H, ny, nz) pads (H = 2*nsweeps) of u, rhs and a:
// rows [0, H) lie below the slab, [H, 2H) above. face_lo / face_hi: the
// slab's low / high x face is a face of the domain (the ghost rule; its pad
// is not read); else a seam, read from the pad. base = sum(lo) + the slab's
// x origin in the level. out must not alias an input.
extern "C" int mgk_multisweep_halo(const void* u, const void* rhs,
                                   const void* a, const void* upad,
                                   const void* rpad, const void* apad,
                                   void* out, int is_double, int nx, int ny,
                                   int nz, const int* kinds, double rho,
                                   double alpha, double beta, double dx,
                                   int base, int face_lo, int face_hi,
                                   int nsweeps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nx < 1) return (int)cudaErrorInvalidValue;
  if (is_double) {
    using T = double;
    auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_multisweep<SRC_SLAB>(
        padded_slab((const T*)u, (const T*)rhs, (const T*)a, (const T*)upad,
                    (const T*)rpad, (const T*)apad, p, face_lo, face_hi),
        (T*)out, p, base, nsweeps, st);
  }
  using T = float;
  auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  return (int)launch_multisweep<SRC_SLAB>(
      padded_slab((const T*)u, (const T*)rhs, (const T*)a, (const T*)upad,
                  (const T*)rpad, (const T*)apad, p, face_lo, face_hi),
      (T*)out, p, base, nsweeps, st);
}

// C entry point: out (nx, ny, nz) <- nsweeps (2 or 4) sweeps of one pencil of
// a sharded level from PREPADDED u, rhs, a of shape (nx+2H, ny+2H, nz),
// H = 2*nsweeps. face_lo / face_hi as for mgk_multisweep_halo; y_off is the
// pencil's y origin in the level of y extent ny_global (the y face rule
// fires at global rows 0 and ny_global - 1 only); base = sum(lo) + x origin
// + y_off.
extern "C" int mgk_multisweep_pre(const void* u_pre, const void* rhs_pre,
                                  const void* a_pre, void* out, int is_double,
                                  int nx, int ny, int nz, const int* kinds,
                                  double rho, double alpha, double beta,
                                  double dx, int base, int face_lo,
                                  int face_hi, int y_off, int ny_global,
                                  int nsweeps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int H = 2 * nsweeps;
  if (nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
  if (is_double) {
    using T = double;
    auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_multisweep<SRC_PRE>(
        prepadded((const T*)u_pre, (const T*)rhs_pre, (const T*)a_pre, p,
                  face_lo, face_hi, y_off, ny_global, H),
        (T*)out, p, base, nsweeps, st);
  }
  using T = float;
  auto p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  return (int)launch_multisweep<SRC_PRE>(
      prepadded((const T*)u_pre, (const T*)rhs_pre, (const T*)a_pre, p,
                face_lo, face_hi, y_off, ny_global, H),
      (T*)out, p, base, nsweeps, st);
}
