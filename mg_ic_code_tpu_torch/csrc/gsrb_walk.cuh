// Grid-wide colour passes over a whole level, shared by the towers' big
// depths (csrc/tower.cu) and the grid form of gsrb_relax
// (csrc/gsrb_relax.cu): the threads of a launch walk the level's z pairs
// (k, k ^ 1) in grid-stride loops, and a pass updates the cell of its colour
// in each pair.
//
// A thread takes the items of a loop U at a time and computes all U values
// before it stores any: the compiler cannot tell that a store does not feed
// a later item's loads, so items taken one at a time would each wait for
// their loads in turn. U = 2 where some thread has two items or more (the
// caller's `many`), else 1. An item past the end, or a cell past an odd nz,
// computes cell (0, 0, 0) and stores nothing, so every load is in range and
// none is behind a branch. Within a colour pass no item reads another's
// cell (first_pass reads another array than it writes), but for one: along
// a periodic axis of odd extent n, cells 0 and n - 1 are neighbours of one
// colour across the wrap. A pass in place on such a level (pass_faces)
// reads those neighbours from a copy made before the pass (save_faces),
// as the plain version and the JAX body read the state before the pass.
// The walk over a level's z pairs (`w`, from the thread's first item) is
// set up once and copied for each pass. Where the stride is a whole number of x planes (the
// wrappers size the grid so: fused_sweeps.pair_grid_blocks), a thread keeps
// its (j, k pair) and steps along x only: the y terms of its cells stay out
// of the loop. FAST, PER and C (the arithmetic's type) are gsrb_cell's; b
// is the variable bCoef (null: constant). Cells are indexed by int: the
// wrappers take levels below 2^31 cells.
#pragma once

#include "gsrb_device.cuh"

// The items first, first + stride, ... of an (n0, n1, n2) box in C order,
// as digits (a, b, c) that advance by the stride's own digits with a carry:
// four divisions where the walk starts, none per item.
struct Walk {
  int a, b, c, sa, sb, sc, n1, n2;
  __device__ __forceinline__ void init(int first, int stride, int n1_,
                                       int n2_) {
    n1 = n1_;
    n2 = n2_;
    const int plane = n1 * n2;
    a = first / plane;
    b = (first - a * plane) / n2;
    c = first - a * plane - b * n2;
    sa = stride / plane;
    sb = (stride - sa * plane) / n2;
    sc = stride - sa * plane - sb * n2;
  }
  __device__ __forceinline__ void next() {
    c += sc;
    if (c >= n2) { c -= n2; ++b; }
    b += sb;
    if (b >= n1) { b -= n1; ++a; }
    a += sa;
  }
};

// The wrap faces of the periodic axes of odd extent of a level: per such
// axis the cells at index 0 (side 0) and n - 1 (side 1), x as (side, j, k),
// y as (i, side, k), z as (i, j, side), one after the other from `base`
// (null where the axis is not one: face_cells of a level without one is 0).
template <typename T>
struct Faces {
  T* f[3];
};

template <typename T>
__host__ __device__ __forceinline__ int face_area(const LevelParams<T>& p,
                                                  int ax) {
  return ax == 0 ? p.ny * p.nz : ax == 1 ? p.nx * p.nz : p.nx * p.ny;
}

template <typename T>
__host__ __device__ __forceinline__ bool odd_wrap(const LevelParams<T>& p,
                                                  int ax) {
  const int n = ax == 0 ? p.nx : ax == 1 ? p.ny : p.nz;
  return p.periodic[ax] && (n & 1);
}

template <typename T>
__host__ __device__ __forceinline__ int face_cells(const LevelParams<T>& p) {
  int n = 0;
  for (int ax = 0; ax < 3; ++ax)
    if (odd_wrap(p, ax)) n += 2 * face_area(p, ax);
  return n;
}

template <typename T>
__device__ __forceinline__ Faces<T> make_faces(const LevelParams<T>& p,
                                               T* base) {
  Faces<T> f;
  for (int ax = 0; ax < 3; ++ax) {
    f.f[ax] = base && odd_wrap(p, ax) ? base : nullptr;
    if (f.f[ax]) base += 2 * face_area(p, ax);
  }
  return f;
}

// Copies into f the wrap-face cells of the pass of parity par (those with
// i + j + k + par even) from the state get(q), items first, first + stride,
// ... A pass may do it for the next pass: it writes none of those cells.
template <typename T, typename Get>
__device__ __forceinline__ void save_faces(const Faces<T>& f, const Get& get,
                                           const LevelParams<T>& p, int par,
                                           int first, int stride) {
  for (int ax = 0; ax < 3; ++ax) {
    if (!f.f[ax]) continue;
    const int area = face_area(p, ax);
    for (int m = first; m < 2 * area; m += stride) {
      int i, j, k, s;
      if (ax == 0) {
        s = m / area;
        j = (m - s * area) / p.nz;
        k = m - s * area - j * p.nz;
        i = s ? p.nx - 1 : 0;
      } else if (ax == 1) {
        i = m / (2 * p.nz);
        s = (m - i * 2 * p.nz) / p.nz;
        k = m - i * 2 * p.nz - s * p.nz;
        j = s ? p.ny - 1 : 0;
      } else {
        s = m & 1;
        i = (m >> 1) / p.ny;
        j = (m >> 1) - i * p.ny;
        k = s ? p.nz - 1 : 0;
      }
      if (((i + j + k + par) & 1) == 0)
        f.f[ax][m] = get((i * p.ny + j) * p.nz + k);
    }
  }
}

// gsrb_cell with the neighbours across an odd periodic wrap read from the
// faces f (the state before the pass) in place of the level.
template <typename T, bool FAST, int PER, typename C, typename Get>
__device__ __forceinline__ T gsrb_cell_faces(const Get& get,
                                             const Faces<T>& f, T av, T rv,
                                             const T* b,
                                             const LevelParams<T>& p, int i,
                                             int j, int k, int idx) {
  const int sy = p.nz, sx = p.ny * p.nz;
  T up[3], um[3];
  axis_pair<T, int, PER>(get, idx, i, p.nx, sx, p.periodic[0], up[0], um[0]);
  axis_pair<T, int, PER>(get, idx, j, p.ny, sy, p.periodic[1], up[1], um[1]);
  axis_pair<T, int, PER>(get, idx, k, p.nz, 1, p.periodic[2], up[2], um[2]);
  if (f.f[0]) {
    if (i == p.nx - 1) up[0] = f.f[0][j * p.nz + k];
    if (i == 0) um[0] = f.f[0][(p.ny + j) * p.nz + k];
  }
  if (f.f[1]) {
    if (j == p.ny - 1) up[1] = f.f[1][2 * i * p.nz + k];
    if (j == 0) um[1] = f.f[1][(2 * i + 1) * p.nz + k];
  }
  if (f.f[2]) {
    const int r = 2 * (i * p.ny + j);
    if (k == p.nz - 1) up[2] = f.f[2][r];
    if (k == 0) um[2] = f.f[2][r + 1];
  }
  return gsrb_update<T, FAST, PER, C>(get(idx), up, um, av, rv,
                                      b != nullptr,
                                      b != nullptr ? b[idx] : (T)0, p, i, j,
                                      k);
}

// One colour pass in place on u (device or shared memory) over the
// (nx, ny, ceil(nz/2)) z pairs of the walk: the cell of the pass's colour
// in each. COL: the walk steps along x only. ODD: the level has an odd
// periodic axis, whose wrapped neighbours come from the faces f.
template <int U, bool COL, int PER, bool FAST, typename C, typename T,
          bool ODD = false>
__device__ __forceinline__ void pass_u(T* u, const T* rhs, const T* a,
                                       const T* b, const LevelParams<T>& p,
                                       int par, Walk w,
                                       const Faces<T>* f = nullptr) {
  const auto get = [u](int q) { return u[q]; };
  while (w.a < p.nx) {
    int idx[U];
    T v[U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      int i = w.a, j = w.b, k = 2 * w.c + ((i + j + par) & 1);
      const bool live = i < p.nx && k < p.nz;
      i = live ? i : 0;
      j = live ? j : 0;
      k = live ? k : 0;
      const int q = (i * p.ny + j) * p.nz + k;
      if constexpr (ODD)
        v[s] = gsrb_cell_faces<T, FAST, PER, C>(get, *f, a[q], rhs[q], b, p,
                                                i, j, k, q);
      else
        v[s] = gsrb_cell<T, int, FAST, PER, C>(get, a[q], rhs[q], b, p, i,
                                               j, k, q);
      idx[s] = live ? q : -1;
      if (COL)
        w.a += w.sa;
      else
        w.next();
    }
#pragma unroll
    for (int s = 0; s < U; ++s)
      if (idx[s] >= 0) u[idx[s]] = v[s];
  }
}

// Which axes of level p are periodic: 1 every axis, 0 none, -1 some (the
// PER of gsrb_device.cuh). The periodic box and the canonical levels take
// the two fixed forms, whose cell update has no face of the other kind to
// compute and discard.
template <typename T>
__device__ __forceinline__ int periodic_axes(const LevelParams<T>& p) {
  const int n = p.periodic[0] + p.periodic[1] + p.periodic[2];
  return n == 3 ? 1 : n == 0 ? 0 : -1;
}

template <int PER, bool FAST, typename C, typename T>
__device__ __forceinline__ void pass_per(T* u, const T* rhs, const T* a,
                                         const T* b, const LevelParams<T>& p,
                                         int par, const Walk& w, bool many) {
  const bool col = w.sb == 0 && w.sc == 0;
  if (many && col)
    pass_u<2, true, PER, FAST, C>(u, rhs, a, b, p, par, w);
  else if (col)
    pass_u<1, true, PER, FAST, C>(u, rhs, a, b, p, par, w);
  else if (many)
    pass_u<2, false, PER, FAST, C>(u, rhs, a, b, p, par, w);
  else
    pass_u<1, false, PER, FAST, C>(u, rhs, a, b, p, par, w);
}

// A colour pass in the form `per` (periodic_axes) says.
template <bool FAST, typename C, typename T>
__device__ __forceinline__ void pass_in_place(T* u, const T* rhs, const T* a,
                                              const T* b,
                                              const LevelParams<T>& p,
                                              int par, const Walk& w,
                                              bool many, int per) {
  if (per == 1)
    pass_per<1, FAST, C>(u, rhs, a, b, p, par, w, many);
  else if (per == 0)
    pass_per<0, FAST, C>(u, rhs, a, b, p, par, w, many);
  else
    pass_per<-1, FAST, C>(u, rhs, a, b, p, par, w, many);
}

// A colour pass in place on a level with a periodic axis of odd extent (per
// 1 or -1), the wrapped neighbours along it from the faces f. The kernels
// that run it are instantiated apart (their ODD), so that every other
// level runs the code it ran without it.
template <bool FAST, typename C, typename T>
__device__ __forceinline__ void pass_faces(T* u, const T* rhs, const T* a,
                                           const T* b,
                                           const LevelParams<T>& p, int par,
                                           const Walk& w, bool many, int per,
                                           const Faces<T>& f) {
  if (per == 1 && many)
    pass_u<2, false, 1, FAST, C, T, true>(u, rhs, a, b, p, par, w, &f);
  else if (per == 1)
    pass_u<1, false, 1, FAST, C, T, true>(u, rhs, a, b, p, par, w, &f);
  else if (many)
    pass_u<2, false, -1, FAST, C, T, true>(u, rhs, a, b, p, par, w, &f);
  else
    pass_u<1, false, -1, FAST, C, T, true>(u, rhs, a, b, p, par, w, &f);
}

// The first colour pass of a level from the state `get`, written out whole
// into u: the pass's cells get the update, the other cell of each z pair
// (k ^ 1) its value from `get` (exact: the pass reads only the other colour
// and the cell itself). Without a pass to make (update false) both get the
// value from `get` (which rounds the state where C asks: as_compute).
template <int U, bool FAST, int PER, typename C, typename T, typename Get>
__device__ __forceinline__ void first_pass_u(T* u, const Get& get,
                                             const T* rhs, const T* a,
                                             const T* b,
                                             const LevelParams<T>& p, int par,
                                             bool update, Walk w) {
  while (w.a < p.nx) {
    int idx[U], pidx[U];
    T v[U], pv[U];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      int i = w.a, j = w.b, k = 2 * w.c + ((i + j + par) & 1);
      const bool live = i < p.nx, own = live && k < p.nz;
      const bool partner = live && (k ^ 1) < p.nz;
      const int row = live ? (i * p.ny + j) * p.nz : 0;
      const int kp = partner ? k ^ 1 : 0;
      i = own ? i : 0;
      j = own ? j : 0;
      k = own ? k : 0;
      const int q = own ? row + k : 0;
      v[s] = update ? gsrb_cell<T, int, FAST, PER, C>(get, a[q], rhs[q], b,
                                                      p, i, j, k, q)
                    : get(q);
      pv[s] = get(row + kp);
      idx[s] = own ? q : -1;
      pidx[s] = partner ? row + kp : -1;
      w.next();
    }
#pragma unroll
    for (int s = 0; s < U; ++s) {
      if (idx[s] >= 0) u[idx[s]] = v[s];
      if (pidx[s] >= 0) u[pidx[s]] = pv[s];
    }
  }
}

template <bool FAST, int PER, typename C, typename T, typename Get>
__device__ __forceinline__ void first_pass(T* u, const Get& get, const T* rhs,
                                           const T* a, const T* b,
                                           const LevelParams<T>& p, int par,
                                           bool update, const Walk& w,
                                           bool many) {
  if (many)
    first_pass_u<2, FAST, PER, C>(u, get, rhs, a, b, p, par, update, w);
  else
    first_pass_u<1, FAST, PER, C>(u, get, rhs, a, b, p, par, update, w);
}

// The walk over level p's z pairs from item `first` by `stride`, and
// whether a thread has two items or more.
template <typename T>
__device__ __forceinline__ Walk pair_walk(const LevelParams<T>& p, int first,
                                          int stride, bool& many) {
  const int hz = (p.nz + 1) >> 1;
  many = p.nx * p.ny * hz > stride;
  Walk w;
  w.init(first, stride, p.ny, hz);
  return w;
}
