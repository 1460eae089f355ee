// multisweep_relax: nsweeps red-black Gauss-Seidel sweeps of one WHOLE level
// in ONE launch: the march of csrc/multisweep_march.cuh (which says what it
// computes, which TPU kernels it replaces and how it is built) with the
// planes of the level itself, taken modulo nx where x is periodic. The entry
// point of ops/fused_sweeps.multisweep_relax and of
// ops/wavefront.wavefront_relax. The body is the one measured before the
// shard forms existed (their body is csrc/multisweep_halo.cu, a unit of its
// own so that the two build in parallel).
#include "multisweep_march.cuh"

namespace {

// Plane q of the march as a plane of the level arrays: q itself, or q modulo
// nx where x is periodic.
template <typename T>
__device__ __forceinline__ int xplane(const WaveThread<T>& w, int q) {
  if (w.wrapx) {
    q %= w.nx;
    if (q < 0) q += w.nx;
  }
  return q;
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
template <typename T, int NP, int TY, int TZ, bool STEADY, int ST>
__device__ __forceinline__ void wave_step(WaveThread<T>& w, const int t,
                                          const int st_rt) {
  using L = WaveLayout<TY, TZ>;
  constexpr int R = NP + 2;
  constexpr int HP = L::HP, PZ = L::PZ, PLANE = L::PLANE;
  const int st = STEADY ? ST : st_rt;
  // plane q in the level arrays (a steady step never wraps)
  auto xq = [&](int q) { return STEADY ? q : xplane(w, q); };
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
    const T* next = w.u + xq(t + 2) * w.sx;
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
      const long long o = xq(t - ps) * w.sx + col;
      av[ps] = __ldg(w.a + o);
      rv[ps] = __ldg(w.rhs + o);
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
      const long long o = xq(t + 1) * w.sx + ncol;
      w.next_a = __ldg(w.a + o);
      w.next_r = __ldg(w.rhs + o);
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
        const bool xface = !w.wrapx;
        fold_terms<T>(upv, umv, xface && q == 0, xface && q == w.nx - 1,
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
        w.out[q * w.sx + col] = un;
    }
  }

  // plane t - NP + 1 has had its last pass: the pair's other column has
  // been final since the step before
  const int qo = t - NP + 1;
  if (qo >= w.x0 && qo < w.x1 && (c ? w.own[0] : w.own[1]))
    w.out[qo * w.sx + (c ? w.coff[0] : w.coff[1])] =
        w.cell[slot(1 - NP) * PLANE + half + dh];
}

// st == ST picks the instantiation whose ring slots are constants
template <typename T, int NP, int TY, int TZ, int ST>
__device__ __forceinline__ void steady_step(WaveThread<T>& w, int t, int st) {
  if constexpr (ST < NP + 2) {
    if (st == ST) wave_step<T, NP, TY, TZ, true, ST>(w, t, st);
    else steady_step<T, NP, TY, TZ, ST + 1>(w, t, st);
  }
}

template <typename T, int NP, int TY, int TZ>
__global__ void __launch_bounds__((TY * TZ) / 2)
march_kernel(const T* __restrict__ u, const T* __restrict__ rhs,
                 const T* __restrict__ a, T* __restrict__ out,
                 const LevelParams<T> p, const int base, const int xseg) {
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
  w.sx = (long long)p.ny * p.nz;
  w.nx = p.nx;
  w.x0 = (int)blockIdx.z * xseg;
  w.x1 = min(p.nx, w.x0 + xseg);
  w.wrapx = p.periodic[0] != 0;
  // a periodic x has no face: both segment ends are open, wherever they lie
  w.xs = w.wrapx ? w.x0 - NP : max(0, w.x0 - NP);
  w.xe = w.wrapx ? w.x1 + NP : min(p.nx, w.x1 + NP);
  w.par = uj + uk + base;
  w.alpha = p.alpha; w.six_b_inv = p.six_b_inv; w.b_inv = p.b_inv;
  w.c0xlo = p.c0[0][0]; w.c1xlo = p.c1[0][0];
  w.c0xhi = p.c0[0][1]; w.c1xhi = p.c1[0][1];

  const bool py = p.periodic[1] != 0, pz = p.periodic[2] != 0;
  const T one = (T)1;
  int gj = uj;
  bool live_j = uj >= 0 && uj < p.ny;
  if (py) {
    gj = uj % p.ny;
    if (gj < 0) gj += p.ny;
    live_j = true;
  }
  const bool own_j = jj >= NP && jj < TY - NP && uj < p.ny;
  const bool ylo = !py && gj == 0, yhi = !py && gj == p.ny - 1;
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
    const long long o = xplane(w, w.xs) * w.sx;
    const long long o1 = xplane(w, w.xs + 1) * w.sx;
    pl[half0] = w.live[0] ? u[o + w.coff[0]] : (T)0;
    pl[L::HP - half0] = w.live[1] ? u[o + w.coff[1]] : (T)0;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      w.raw_u[c] = (w.live[c] && w.xs + 1 < w.xe)
                       ? u[o1 + w.coff[c]] : (T)0;
    const int c = (w.xs + w.par) & 1;
    const bool act = c ? w.live[1] : w.live[0];
    w.next_a = act ? a[o + (c ? w.coff[1] : w.coff[0])] : (T)0;
    w.next_r = act ? rhs[o + (c ? w.coff[1] : w.coff[0])] : (T)0;
  }

  // steps xs .. xe+NP-2; those in [lo_s, hi_s) are steady: t - NP >= xs,
  // t + 2 < xe, no plane of the staircase at an x face of the domain, and
  // (periodic x) every plane t - NP .. t + 2 inside [0, nx)
  const int lo_s = max(w.xs, 0) + NP, hi_s = min(w.xe, p.nx) - 2;
  int t = w.xs;
  const int last = w.xe + NP - 1;
  for (; t < last && t < lo_s; ++t, st = st + 1 == R ? 0 : st + 1)
    wave_step<T, NP, TY, TZ, false, 0>(w, t, st);
  for (; t < hi_s; ++t, st = st + 1 == R ? 0 : st + 1)
    steady_step<T, NP, TY, TZ, 0>(w, t, st);
  for (; t < last; ++t, st = st + 1 == R ? 0 : st + 1)
    wave_step<T, NP, TY, TZ, false, 0>(w, t, st);
}

template <typename T, int NP, int TY, int TZ>
cudaError_t launch_tile(const T* u, const T* rhs, const T* a, T* out,
                        const LevelParams<T>& p, int base,
                        cudaStream_t stream) {
  constexpr int TIY = TY - 2 * NP, TIZ = TZ - 2 * NP;
  static_assert(TIY > 0 && TIZ > 0 && TZ % 2 == 0, "tile too small");
  const int nty = (p.ny + TIY - 1) / TIY, ntz = (p.nz + TIZ - 1) / TIZ;
  const size_t smem = (size_t)(NP + 2) * WaveLayout<TY, TZ>::PLANE * sizeof(T);
  const int threads = (TY * TZ) / 2;
  auto kern = march_kernel<T, NP, TY, TZ>;
  static int cache[kMaxDevices] = {};
  int capacity = 0;
  cudaError_t err =
      march_capacity((const void*)kern, threads, smem, cache, &capacity);
  if (err != cudaSuccess) return err;
  int nseg = 1, xseg = p.nx;
  march_segments(p.nx, (long long)nty * ntz, capacity, NP, &nseg, &xseg);
  dim3 grid((unsigned)ntz, (unsigned)nty, (unsigned)nseg);
  kern<<<grid, threads, smem, stream>>>(u, rhs, a, out, p, base, xseg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_multisweep(const T* u, const T* rhs, const T* a, T* out,
                              const LevelParams<T>& p, int base, int nsweeps,
                              cudaStream_t stream) {
  // a periodic axis wraps inside a tile or a segment: its extent must be
  // even so that the checkerboard stays consistent across the wrap
  if ((p.periodic[0] && p.nx % 2) || (p.periodic[1] && p.ny % 2) ||
      (p.periodic[2] && p.nz % 2))
    return cudaErrorInvalidValue;
  if (nsweeps == 2)
    return launch_tile<T, 4, 40, 40>(u, rhs, a, out, p, base, stream);
  if (nsweeps == 4)
    return launch_tile<T, 8, 40, 40>(u, rhs, a, out, p, base, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point: out <- nsweeps (2 or 4) sweeps of u; u is not modified and
// out must not alias it.
extern "C" int mgk_multisweep_relax(const void* u, const void* rhs,
                                    const void* a, void* out, int is_double,
                                    int nx, int ny, int nz, const int* kinds,
                                    double rho, double alpha, double beta,
                                    double dx, int base, int nsweeps,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double) {
    auto p = make_level_params<double>(nx, ny, nz, kinds, rho, alpha, beta, dx);
    return (int)launch_multisweep<double>((const double*)u, (const double*)rhs,
                                          (const double*)a, (double*)out, p,
                                          base, nsweeps, st);
  }
  auto p = make_level_params<float>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  return (int)launch_multisweep<float>((const float*)u, (const float*)rhs,
                                       (const float*)a, (float*)out, p, base,
                                       nsweeps, st);
}
