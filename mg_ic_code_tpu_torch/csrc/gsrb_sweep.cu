// gsrb_sweep: the one-sweep and one-pass entry points of the GSRB smoother
// (ops/fused_sweeps.gsrb_full_sweep / gsrb_half_sweep), ONE launch a call,
// out of place: the kernel reads u and writes every cell of a new `out`
// once, updated or copied; the caller's u is only read.
//
// Replaces the TPU kernels mg_ic_code_tpu/ops/pallas_kernels.py:
// gsrb_half_sweep (body _gsrb_kernel: one colour pass written through a
// parity blend) and :gsrb_full_sweep (body _gsrb_pair_kernel: red and black
// in one HBM pass, red recomputed on one halo row per side so that black
// sees the post-red neighbours). Every cell is updated with gsrb_update_row's
// expressions (csrc/gsrb_device.cuh) in their order, as every gsrb_relax form
// updates it: a full sweep is bit for bit two half sweeps and
// gsrb_relax(nsweeps = 1).
//
// What bounds them on this card: the bytes (a half sweep reads u, rhs, a
// and b once and writes out once: 4 or 5 arrays; a full sweep the same)
// and, for a full sweep, the two colours' dependence. The design moves each
// array through device memory once:
//  * "stream" (a half sweep): a thread takes four consecutive z cells of one
//    row, both colours, updates the pass's colour (one cell of each pair:
//    no divergence) and copies the other; 16-byte loads and stores where nz
//    is a multiple of 4 and every array starts on 16 bytes, else one element
//    at a time. The x and y neighbours are the rows above and below, read
//    through L1 and L2 (the block's own rows and the planes next to it,
//    which the blocks before it brought in).
//  * "march" (a full sweep): a block owns ty rows of the y-z plane (all of
//    z) and a segment of x, and walks x with a ring of u planes in shared
//    memory, each with two rows beyond the tile on each side, filled by
//    cp.async one step ahead; rhs, a and b come from the level arrays. It
//    runs red on plane t over the tile and one row more on each side, in
//    place in the ring (red reads only black cells, which red leaves
//    alone), and black one plane behind on the tile from the post-red ring,
//    and writes plane t - 1 (black computed, red from the ring), one barrier
//    a step (sweep_march_kernel): u is read once and out written once, the
//    rind rows and the segment's end planes are read again (from L2) and
//    red recomputed on them. A domain face needs no ghost plane: its rule
//    folds into the weights of the cell's own index, from the post-red
//    interior that black reads; a periodic axis wraps its rind. A full
//    sweep with an odd periodic axis is refused by the wrapper (across such
//    a wrap a red cell reads a red neighbour, which red writes in place).
//    A half sweep takes no march: on an H100 one read 0.11-0.14 ms at
//    256^3 P and 960x144x144 against the stream form's 0.089 and 0.105
//    (scripts/sweep_probe.py, PERF.md).
// fused_sweeps.sweep_geometry picks the form, the tile rows and the x
// segments in Python. Where a level fits the L2 a full sweep takes its other
// form, "grid": gsrb_relax's grid form at nsweeps = 1 (csrc/gsrb_relax.cu:
// one cooperative launch, a grid barrier between the colours, the second
// pass reading from the L2).
#include "multisweep_march.cuh"

extern __shared__ __align__(16) unsigned char sweep_smem[];

namespace {

// Threads per block of the stream form (fused_sweeps.SWEEP_THREADS), and the
// most a march block may have (fused_sweeps.SWEEP_MARCH_THREADS).
constexpr int kSweepThreads = 256;
constexpr int kMaxMarchThreads = 512;
// The forms' codes (fused_sweeps.SWEEP_FORMS): a half sweep's stream, a
// full sweep's march.
enum SweepForm { SWEEP_STREAM = 0, SWEEP_MARCH = 1 };

template <typename T>
struct SweepArgs {
  LevelParams<T> p;
  const T* u;    // the caller's state, only read
  const T* rhs;
  const T* a;
  const T* b;    // null: constant bCoef
  T* out;
  int par;       // the (first) colour updates the cells with (i+j+k+par) even
  int ty;        // march: rows of a tile (the last tile takes what is left)
  int ytiles;    // march: tiles along y; block = segment * ytiles + tile
  int xseg;      // march: planes of a segment (the last takes what is left)
  bool vec;      // 16-byte rows: nz a multiple of 16 bytes, arrays aligned
};

// n as an index of an axis of `size` cells: wrapped where the axis is
// periodic, else -1 past a face.
__device__ __forceinline__ int wrap_index(int n, int size, bool periodic) {
  if (n >= 0 && n < size) return n;
  if (!periodic) return -1;
  n %= size;
  return n < 0 ? n + size : n;
}

// Four consecutive cells of a row from q on: one or two 16-byte loads (VEC),
// else element by element, a cell past the row's end (k0 + s >= nz) read
// at q (in range, never used).
template <bool VEC>
__device__ __forceinline__ void load4(const float* x, int q, int n,
                                      float (&v)[4]) {
  if constexpr (VEC) {
    const float4 w = *reinterpret_cast<const float4*>(x + q);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) v[s] = x[q + (s < n ? s : 0)];
  }
}
template <bool VEC>
__device__ __forceinline__ void load4(const double* x, int q, int n,
                                      double (&v)[4]) {
  if constexpr (VEC) {
    const double2 w0 = *reinterpret_cast<const double2*>(x + q);
    const double2 w1 = *reinterpret_cast<const double2*>(x + q + 2);
    v[0] = w0.x; v[1] = w0.y; v[2] = w1.x; v[3] = w1.y;
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) v[s] = x[q + (s < n ? s : 0)];
  }
}
template <bool VEC>
__device__ __forceinline__ void store4(float* x, int q, int n,
                                       const float (&v)[4]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(x + q) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s < n) x[q + s] = v[s];
  }
}
template <bool VEC>
__device__ __forceinline__ void store4(double* x, int q, int n,
                                       const double (&v)[4]) {
  if constexpr (VEC) {
    *reinterpret_cast<double2*>(x + q) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(x + q + 2) = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s < n) x[q + s] = v[s];
  }
}

// The "stream" form of a half sweep: thread m takes cells 4c .. 4c + 3 of
// row (i, j), m = (i * ny + j) * ceil(nz / 4) + c. Of each z pair (k0 + 2h,
// k0 + 2h + 1) the cell o = (i + j + k0 + par) & 1 is updated, the other
// copied.
template <typename T, int PER, bool VEC>
__global__ void __launch_bounds__(kSweepThreads)
half_stream_kernel(const __grid_constant__ SweepArgs<T> g) {
  const LevelParams<T>& p = g.p;
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int chunks = (nz + 3) >> 2;
  const int m = blockIdx.x * kSweepThreads + threadIdx.x;
  if (m >= nx * ny * chunks) return;
  const int row = m / chunks;
  const int k0 = 4 * (m - row * chunks);
  const int i = row / ny, j = row - i * ny;
  const int n = nz - k0;  // cells of the chunk in the row (4 or more: all)
  const bool px = PER < 0 ? p.periodic[0] != 0 : PER == 1;
  const bool py = PER < 0 ? p.periodic[1] != 0 : PER == 1;
  const bool pz = PER < 0 ? p.periodic[2] != 0 : PER == 1;
  // the rows of the neighbours: wrapped across a periodic face, the row
  // itself across another (its weight 0 masks it), as axis_pair reads them
  const int rxp = i == nx - 1 ? (px ? row - (nx - 1) * ny : row) : row + ny;
  const int rxm = i == 0 ? (px ? row + (nx - 1) * ny : row) : row - ny;
  const int ryp = j == ny - 1 ? (py ? row - (ny - 1) : row) : row + 1;
  const int rym = j == 0 ? (py ? row + (ny - 1) : row) : row - 1;
  const T* u = g.u;
  const int q = row * nz + k0;
  T c[4], xp[4], xm[4], yp[4], ym[4], rv[4], av[4], bv[4];
  load4<VEC>(u, q, n, c);
  load4<VEC>(u, rxp * nz + k0, n, xp);
  load4<VEC>(u, rxm * nz + k0, n, xm);
  load4<VEC>(u, ryp * nz + k0, n, yp);
  load4<VEC>(u, rym * nz + k0, n, ym);
  load4<VEC>(g.rhs, q, n, rv);
  load4<VEC>(g.a, q, n, av);
  const bool with_b = g.b != nullptr;
  if (with_b) {
    load4<VEC>(g.b, q, n, bv);
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) bv[s] = (T)0;
  }
  const T* ur = u + row * nz;
  // z neighbours outside the chunk: below its first cell and above its last
  const T zlo = ur[k0 > 0 ? k0 - 1 : (pz ? nz - 1 : 0)];
  const T zhi = ur[k0 + 4 < nz ? k0 + 4 : (pz ? 0 : nz - 1)];
  const T zfirst = pz ? ur[0] : (T)0;  // the wrap of the row's last cell
  const RowFold<T> rf = row_fold<T, PER>(p, i, j);
  const int o = (i + j + k0 + g.par) & 1;
  T v[4] = {c[0], c[1], c[2], c[3]};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the updated cell of pair h: k0 + 2h + o
    const int k = k0 + 2 * h + o;
    const T uc = o ? c[2 * h + 1] : c[2 * h];
    const T zm_in = o ? c[2 * h] : (h ? c[1] : zlo);
    const T zp_in = o ? (h ? zhi : c[2]) : c[2 * h + 1];
    T up[3], um[3];
    up[0] = o ? xp[2 * h + 1] : xp[2 * h];
    um[0] = o ? xm[2 * h + 1] : xm[2 * h];
    up[1] = o ? yp[2 * h + 1] : yp[2 * h];
    um[1] = o ? ym[2 * h + 1] : ym[2 * h];
    up[2] = k == nz - 1 ? (pz ? zfirst : uc) : zp_in;
    um[2] = k == 0 ? (pz ? ur[nz - 1] : uc) : zm_in;
    const T a_c = o ? av[2 * h + 1] : av[2 * h];
    const T r_c = o ? rv[2 * h + 1] : rv[2 * h];
    const T b_c = o ? bv[2 * h + 1] : bv[2 * h];
    const T nv = gsrb_update_row<T, false, PER>(uc, up, um, a_c, r_c, with_b,
                                                 b_c, rf, p, k);
    if (o)
      v[2 * h + 1] = nv;
    else
      v[2 * h] = nv;
  }
  store4<VEC>(g.out, q, n, v);
}

// The items (r, kk) of an (nrows, hz) box that thread `first` of `threads`
// takes, by a stride of `threads`: digits that advance with a carry (no
// division per item).
struct RowWalk {
  int r, kk, dr, dk, hz;
  __device__ __forceinline__ RowWalk(int first, int threads, int hz_)
      : hz(hz_) {
    r = first / hz;
    kk = first - r * hz;
    dr = threads / hz;
    dk = threads - dr * hz;
  }
  __device__ __forceinline__ void next() {
    kk += dk;
    if (kk >= hz) {
      kk -= hz;
      ++r;
    }
    r += dr;
  }
};

// A cell's a, rhs and b (b 0 where it is constant), from the level arrays
// at q.
template <typename T>
struct Coefs {
  T a, rhs, b;
};

template <typename T>
__device__ __forceinline__ Coefs<T> coefs_at(const SweepArgs<T>& g,
                                             long long q, bool with_b) {
  return Coefs<T>{__ldg(g.a + q), __ldg(g.rhs + q),
                  with_b ? __ldg(g.b + q) : (T)0};
}

// The new value of cell (i, j, k) from the u ring: its plane's slot Uc and
// the slots of the planes before and after it (Um, Up), its ring row r (the
// rows r - 1 and r + 1 beside it), its coefficients x; the update of
// gsrb_update_row, the neighbours read as axis_pair reads them.
template <typename T, int PER>
__device__ __forceinline__ T ring_cell(const T* Uc, const T* Um, const T* Up,
                                       int r, int k, const Coefs<T>& x,
                                       bool with_b, const LevelParams<T>& p,
                                       int i, int j, bool pz) {
  const int nz = p.nz;
  const int c = r * nz + k;
  const T uc = Uc[c];
  T up[3], um[3];
  up[0] = Up[c];
  um[0] = Um[c];
  up[1] = Uc[c + nz];
  um[1] = Uc[c - nz];
  up[2] = k == nz - 1 ? (pz ? Uc[c - (nz - 1)] : uc) : Uc[c + 1];
  um[2] = k == 0 ? (pz ? Uc[c + (nz - 1)] : uc) : Uc[c - 1];
  return gsrb_update_row<T, false, PER>(uc, up, um, x.a, x.rhs, with_b, x.b,
                                        row_fold<T, PER>(p, i, j), p, k);
}

// The "march" form of a full sweep. Ring plane m of u is level plane
// x0 - 2 + m, with RIND rows beyond the tile on each side; RU planes: the
// four a step reads and one fetched a step ahead. A thread keeps its items
// (ring row r, z pair kk) from step to step. Step s: red on plane
// t = x0 - 1 + s (ring plane s + 1) at the item (rows of the tile and one
// beyond on each side), in place in the u ring; then, from step 2 on,
// black on plane t - 1 at the same item where its row is a tile row, from
// the ring, written out with the pair's red cell. Black at (t - 1, j, k) is
// the pair position red took at (t, j, k): its x + 1 neighbour is what the
// same thread has just written; every other neighbour it reads is red of
// plane t - 1 or t - 2, written in earlier steps; and red of plane t reads
// black cells only, which nobody writes into the ring. So a step needs one
// barrier, before it (its planes' copies landed, the previous step's red
// writes seen). rhs, a and b come from the level arrays (each cell's once
// a colour: L1 and L2 keep the other colour's half of a sector), both of an
// item's loads issued before either update.
template <typename T, int PER>
__global__ void __launch_bounds__(kMaxMarchThreads)
sweep_march_kernel(const __grid_constant__ SweepArgs<T> g) {
  constexpr int RIND = 2, RU = 5;
  const LevelParams<T>& p = g.p;
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const bool px = PER < 0 ? p.periodic[0] != 0 : PER == 1;
  const bool py = PER < 0 ? p.periodic[1] != 0 : PER == 1;
  const bool pz = PER < 0 ? p.periodic[2] != 0 : PER == 1;
  const int threads = blockDim.x;
  const int tile = blockIdx.x % g.ytiles, seg = blockIdx.x / g.ytiles;
  const int y0 = tile * g.ty;
  const int ty = min(g.ty, ny - y0);
  const int x0 = seg * g.xseg;
  const int x1 = min(nx, x0 + g.xseg);
  const int urows = ty + 2 * RIND;
  const int uplane = urows * nz;
  const bool with_b = g.b != nullptr;
  T* U = reinterpret_cast<T*>(sweep_smem);
  const int nsteps = (x1 - x0) + 2;
  const int hz = (nz + 1) >> 1;

  // ring plane m: a plane or row past an open face is not fetched (its slot
  // keeps what it held: every read of it is masked by its weight 0)
  const auto fetch_u = [&](int m) {
    const int i = wrap_index(x0 - 2 + m, nx, px);
    if (i < 0) return;
    T* dst = U + (m % RU) * uplane;
    const T* base = g.u + (long long)i * ny * nz;
    if (g.vec) {
      constexpr int per16 = 16 / sizeof(T);
      const int cpr = nz / per16;
      for (int e = threadIdx.x; e < urows * cpr; e += threads) {
        const int r = e / cpr, w = e - r * cpr;
        const int j = wrap_index(y0 - RIND + r, ny, py);
        if (j < 0) continue;
        copy_chunk(shared_address(dst + r * nz + w * per16),
                   base + (long long)j * nz + w * per16);
      }
    } else {
      for (int e = threadIdx.x; e < urows * nz; e += threads) {
        const int r = e / nz, k = e - r * nz;
        const int j = wrap_index(y0 - RIND + r, ny, py);
        if (j < 0) continue;
        copy_async<T>(shared_address(dst + r * nz + k),
                      base + (long long)j * nz + k);
      }
    }
  };
  fetch_u(0);
  fetch_u(1);
  fetch_u(2);
  copy_commit();

  for (int s = 0; s < nsteps; ++s) {
    copy_wait<0>();
    __syncthreads();
    if (s + 3 < nsteps + 2) fetch_u(s + 3);
    copy_commit();
    // red on t (ring plane s + 1), black on w = t - 1 (ring plane s)
    const int t = wrap_index(x0 - 1 + s, nx, px);
    const int w = x0 - 2 + s;
    const T* Uw = U + (s % RU) * uplane;
    T* Ut = U + ((s + 1) % RU) * uplane;
    const T* Up = U + ((s + 2) % RU) * uplane;
    const T* Uwm = U + ((s + RU - 1) % RU) * uplane;
    for (RowWalk it(threadIdx.x, threads, hz); it.r < ty + 2; it.next()) {
      const int r = it.r + 1;  // ring row (rows 0 and urows - 1: rind)
      const int jt = wrap_index(y0 - RIND + r, ny, py);
      const int kt = 2 * it.kk + ((t + jt + g.par) & 1);
      const bool red = t >= 0 && jt >= 0 && kt < nz;
      // black, where the item's row is a tile row
      const int j = y0 + r - RIND;
      const bool out = s >= 2 && r >= RIND && r < ty + RIND;
      const int kw = 2 * it.kk + ((w + j + g.par + 1) & 1);
      const int kc = kw ^ 1;
      const int kq = kw < nz ? kw : kc;
      const long long row = ((long long)w * ny + j) * nz;
      Coefs<T> xt, xw;
      if (red)
        xt = coefs_at(g, ((long long)t * ny + jt) * nz + kt, with_b);
      if (out) xw = coefs_at(g, row + kq, with_b);
      if (red)
        Ut[r * nz + kt] =
            ring_cell<T, PER>(Ut, Uw, Up, r, kt, xt, with_b, p, t, jt, pz);
      if (!out) continue;
      const T nv = ring_cell<T, PER>(Uw, Uwm, Ut, r, kq, xw, with_b, p, w,
                                     j, pz);
      const T cv = Uw[r * nz + (kc < nz ? kc : kq)];
      T* o = g.out + row;
      if (g.vec) {
        if (kw & 1)
          store_pair(o + kc, cv, nv);
        else
          store_pair(o + kw, nv, cv);
      } else {
        if (kw < nz) o[kw] = nv;
        if (kc < nz) o[kc] = cv;
      }
    }
  }
}

template <typename T>
const void* stream_kernel(int per, bool vec) {
  if (vec)
    return per == 1 ? (const void*)half_stream_kernel<T, 1, true>
           : per == 0 ? (const void*)half_stream_kernel<T, 0, true>
                      : (const void*)half_stream_kernel<T, -1, true>;
  return per == 1 ? (const void*)half_stream_kernel<T, 1, false>
         : per == 0 ? (const void*)half_stream_kernel<T, 0, false>
                    : (const void*)half_stream_kernel<T, -1, false>;
}

template <typename T>
const void* march_kernel(int per) {
  return per == 1 ? (const void*)sweep_march_kernel<T, 1>
         : per == 0 ? (const void*)sweep_march_kernel<T, 0>
                    : (const void*)sweep_march_kernel<T, -1>;
}

// The shared-memory limit of a kernel is an attribute of the kernel on one
// device: set to the most a block may take (SWEEP_SMEM of the wrapper) once
// per kernel and device.
constexpr int kMaxSweepSmem = 232448;

cudaError_t allow_smem(const void* kern, unsigned char* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSweepSmem);
    if (err != cudaSuccess) return err;
    done[dev] = 1;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t sweep_impl(const void* u, const void* rhs, const void* a,
                       const void* b, void* out, const int* geo, double rho,
                       double alpha, double beta, double dx, int par,
                       cudaStream_t st) {
  const int form = geo[0], nx = geo[2], ny = geo[3], nz = geo[4];
  const int* kinds = geo + 5;
  const int per = geo[11], ty = geo[12], xseg = geo[13], nseg = geo[14];
  const int smem = geo[15], threads = geo[16];
  if (nx < 2 || ny < 2 || nz < 2 || (long long)nx * ny * nz >= (1LL << 31) ||
      per < -1 || per > 1 || form < SWEEP_STREAM || form > SWEEP_MARCH)
    return cudaErrorInvalidValue;
  SweepArgs<T> g = {};
  g.p = make_level_params<T>(nx, ny, nz, kinds, rho, alpha, beta, dx);
  g.u = (const T*)u;
  g.rhs = (const T*)rhs;
  g.a = (const T*)a;
  g.b = (const T*)b;
  g.out = (T*)out;
  g.par = ((par % 2) + 2) % 2;
  const unsigned long long bits =
      (unsigned long long)u | (unsigned long long)rhs |
      (unsigned long long)a | (unsigned long long)b |
      (unsigned long long)out;
  void* params[] = {(void*)&g};
  if (form == SWEEP_STREAM) {
    g.vec = nz % 4 == 0 && (bits & 15) == 0;
    const long long items = (long long)nx * ny * ((nz + 3) / 4);
    return cudaLaunchKernel(stream_kernel<T>(per, g.vec),
                            dim3((unsigned)((items + kSweepThreads - 1) /
                                            kSweepThreads)),
                            dim3(kSweepThreads), params, 0, st);
  }
  if (ty < 1 || xseg < 1 || nseg < 1 || (long long)(nseg - 1) * xseg >= nx ||
      (long long)nseg * xseg < nx || smem < 0 || smem > kMaxSweepSmem ||
      threads < 32 || threads > kMaxMarchThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  // the u ring: five planes of the tile's rows and two more on each side
  if (5LL * (ty + 4) * nz * (long long)sizeof(T) > smem)
    return cudaErrorInvalidValue;
  g.ty = ty;
  g.ytiles = (ny + ty - 1) / ty;
  g.xseg = xseg;
  g.vec = (nz * (int)sizeof(T)) % 16 == 0 && (bits & 15) == 0;
  return cudaLaunchKernel(march_kernel<T>(per),
                          dim3((unsigned)(g.ytiles * nseg)), dim3(threads),
                          params, (size_t)smem, st);
}

template <typename T>
cudaError_t sweep_capacity(int form, int per, int threads, int smem,
                           int* capacity) {
  static unsigned char done[3][3][kMaxDevices] = {};
  if (per < -1 || per > 1 || form < SWEEP_STREAM || form > SWEEP_MARCH ||
      smem < 0 || smem > kMaxSweepSmem || threads < 32 ||
      threads > (form == SWEEP_STREAM ? kSweepThreads : kMaxMarchThreads))
    return cudaErrorInvalidValue;
  const int f = per + 1;
  const void* kerns[2];
  int nk = 0;
  unsigned char* flags[2];
  if (form == SWEEP_STREAM) {
    kerns[0] = stream_kernel<T>(per, false);
    kerns[1] = stream_kernel<T>(per, true);
    flags[0] = done[0][f];
    flags[1] = done[1][f];
    nk = 2;
  } else {
    kerns[0] = march_kernel<T>(per);
    flags[0] = done[2][f];
    nk = 1;
  }
  int cap = 1 << 30;
  for (int q = 0; q < nk; ++q) {
    cudaError_t err = allow_smem(kerns[q], flags[q]);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kerns[q],
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = multiprocessors(&sms);
    if (err != cudaSuccess) return err;
    cap = per_sm * sms < cap ? per_sm * sms : cap;
  }
  *capacity = cap;
  return cudaSuccess;
}

}  // namespace

// C entry point (csrc/mg_kernels.h's conventions): one sweep or one colour
// pass of the level u into out, ONE launch (u, rhs, a, b only read; b may be
// null: constant bCoef = 1). par = (sum(lo) + colour) & 1 for a half sweep,
// sum(lo) & 1 for a full sweep: its first colour updates the cells with
// (i + j + k + par) even. geo (kept per shape by the wrapper: one array a
// call): form (SweepForm), is_double, nx, ny, nz, the six face kinds, per
// (1 every axis periodic, 0 none, -1 some), and for the march ty, xseg,
// nseg, smem (bytes of shared memory a block), threads (a block), from
// fused_sweeps.sweep_geometry.
extern "C" int mgk_gsrb_sweep(const void* u, const void* rhs, const void* a,
                              const void* b, void* out, const int* geo,
                              double rho, double alpha, double beta,
                              double dx, int par, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(geo[1] ? sweep_impl<double>(u, rhs, a, b, out, geo, rho,
                                           alpha, beta, dx, par, st)
                      : sweep_impl<float>(u, rhs, a, b, out, geo, rho, alpha,
                                          beta, dx, par, st));
}

// C entry point: *capacity <- blocks of the form's kernel (form as
// mgk_gsrb_sweep's, per as its geo's) of `threads` threads with `smem`
// bytes of shared memory each that the current device runs at once; also
// lets the kernel take up to kMaxSweepSmem bytes (once per kernel and
// device).
extern "C" int mgk_gsrb_sweep_capacity(int is_double, int form, int per,
                                       int threads, int smem,
                                       int* capacity) {
  return (int)(is_double
                   ? sweep_capacity<double>(form, per, threads, smem,
                                            capacity)
                   : sweep_capacity<float>(form, per, threads, smem,
                                           capacity));
}
