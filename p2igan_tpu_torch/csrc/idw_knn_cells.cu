// Generic IDW k-NN forward for any number of points (#9): every query of the
// (D, H, W) grid takes its k nearest of a sample's points (by the f32 sqrt
// distance, lowest index on ties) and writes their inverse-distance-weighted
// mean, and, when asked, its selection (sel_idx, w_norm: (B, Q, k)) for the
// backward's scatter.
//
// Replaces p2igan_tpu/ops/pallas/idw_kernel.py::_idw_forward_chunked (P >
// 4096: the masks that vary per frame, 65536 to 98304 points) and
// _idw_forward_single (P <= 4096, #8: the same selection, so the same search
// serves it; the wrappers keep the JAX package's split). The TPU kernel
// streams every point past every query in chunks and merges per-chunk top-k
// lists in XLA; the points are voxels of the query lattice, so a query's k
// nearest almost always lie within a cell or two of it. Here the points are
// sorted into cells, and each query visits only the cells that could hold one
// of its k nearest: an exact search, not an approximation.
//
// Cell build (p2i_idw_cell_build, five small launches, every call, no host
// sync): a uniform grid of CZ x CY x CX cells over the query grid's extent
// (one frame x 8 x 8 pixels at full width: 16 x 16 x 16 a sample); a valid
// point (penalty 0) falls in the cell of its clamped coordinates, every other
// slot (invalid or padding, penalty 1e30) in one more set, cell C - 1. Count
// (per-cell atomics), a per-sample exclusive scan, a scatter of each point's
// float4 and original index into cell order. The invalid set is scattered in
// ascending index (a prefix count, not an atomic), the valid cells in any
// order. Per cell the members' bounding box and least penalty: every lower
// bound below is taken to these boxes, never to nominal cell edges, so points
// anywhere (clamped, outside [0, 1]) stay bounded. Memory: 24 bytes a slot
// and 44 a cell.
//
// Search (knn_cells_kernel): a block takes 16 x 16 queries of one frame. It
// bounds the distance from its queries' box to every cell (knn_box_bound)
// and visits the cells in bands of growing bound (a quarter of a cell's width
// a band), staging their points in shared memory (a cell whose bound has
// meanwhile risen above every thread's k-th distance is dropped); a thread
// scans a staged cell only when its own bound to the cell is not strictly
// above its k-th distance. The block stops when the
// least bound of the cells left is strictly above every thread's k-th
// distance. Then the invalid set, chunk by chunk in index order, while some
// thread's list could still take one of its points: with fewer than k valid
// points, or none (every served nowcasting window after an event's first),
// the invalid slots fill the lists exactly as in the brute-force order.
//
// Exactness: a point enters a list when (d, index) is lexicographically below
// the k-th entry (knn_scan_any_order), so the visiting order does not matter,
// and a cell is skipped only when its bound, computed with knn_distance's
// rounded operations on smaller operands, is strictly above the k-th
// distance: no member could have entered. The output, sel_idx and w_norm
// equal the brute-force plain version's bit for bit.
//
// Bound on the H100: the bytes (the points, values and outputs once); the
// operations are the pairs that the data needs, (9 + 3k + 1) a pair whose
// distance is at most the query's k-th, which is far less.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "idw_knn.cuh"

namespace {

using p2i::kKnnMaxK;

constexpr int kThreads = 256;      // queries a search block: 16 x 16 pixels
constexpr int kTileX = 16;
constexpr int kTileY = 16;
constexpr int kStage = 1024;       // points staged in shared memory a round
constexpr int kMaxCells = 4097;    // ops/idw_kernel.py MAX_CELLS + the invalid set
constexpr int kBuildThreads = 256; // points a build block (an invalid-set chunk)
constexpr int kScanThreads = 1024;

// float <-> int keys whose signed order is the floats' order, for atomicMin/Max
__device__ __forceinline__ int float_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// floor(v * n) clamped to [0, n - 1], NaN to 0 (ops/idw_kernel.py _cell_axis)
__device__ __forceinline__ int cell_axis(float v, int n) {
  const float f = floorf(__fmul_rn(v, static_cast<float>(n)));
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

__device__ __forceinline__ int point_cell(float4 p, int CZ, int CY, int CX, int C) {
  if (p.w != 0.0f) return C - 1;
  return (cell_axis(p.z, CZ) * CY + cell_axis(p.y, CY)) * CX + cell_axis(p.x, CX);
}

// Boxes as keys: (lo x, y, z, least penalty, hi x, y, z, 0) a cell.
__global__ void cell_init_kernel(int* __restrict__ count, int* __restrict__ fill,
                                 int* __restrict__ box, int cells) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  count[c] = 0;
  fill[c] = 0;
  const int lo = float_key(INFINITY), hi = float_key(-INFINITY);
  int4* b = reinterpret_cast<int4*>(box) + 2 * static_cast<size_t>(c);
  b[0] = make_int4(lo, lo, lo, lo);
  b[1] = make_int4(hi, hi, hi, 0);
}

__device__ __forceinline__ void box_atomics(int* b, int lx, int ly, int lz, int lw,
                                            int hx, int hy, int hz) {
  atomicMin(b + 0, lx);
  atomicMin(b + 1, ly);
  atomicMin(b + 2, lz);
  atomicMin(b + 3, lw);
  atomicMax(b + 4, hx);
  atomicMax(b + 5, hy);
  atomicMax(b + 6, hz);
}

// grid (chunks, B), kBuildThreads a block: each slot's cell, the valid cells'
// counts and boxes, the invalid set's box (one atomic a warp) and its count a
// chunk.
__global__ void cell_count_kernel(const float4* __restrict__ pts, int* __restrict__ cell_of,
                                  int* __restrict__ count, int* __restrict__ box,
                                  int* __restrict__ inv_chunk, int Pp, int C, int CZ,
                                  int CY, int CX) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kBuildThreads + threadIdx.x;
  const bool in = i < Pp;
  const size_t slot = static_cast<size_t>(b) * Pp + i;
  const float4 p = in ? pts[slot] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int c = in ? point_cell(p, CZ, CY, CX, C) : 0;
  const bool inv = in && c == C - 1;
  const int kx = float_key(p.x), ky = float_key(p.y), kz = float_key(p.z),
            kw = float_key(p.w);
  if (in) {
    cell_of[slot] = c;
    if (!inv) {
      atomicAdd(count + static_cast<size_t>(b) * C + c, 1);
      box_atomics(box + (static_cast<size_t>(b) * C + c) * 8, kx, ky, kz, kw, kx, ky, kz);
    }
  }
  const unsigned m = __ballot_sync(0xffffffffu, inv);
  if (inv) {
    const int lx = __reduce_min_sync(m, kx), ly = __reduce_min_sync(m, ky),
              lz = __reduce_min_sync(m, kz), lw = __reduce_min_sync(m, kw),
              hx = __reduce_max_sync(m, kx), hy = __reduce_max_sync(m, ky),
              hz = __reduce_max_sync(m, kz);
    if ((threadIdx.x & 31) == __ffs(m) - 1) {
      box_atomics(box + (static_cast<size_t>(b) * C + C - 1) * 8, lx, ly, lz, lw, hx,
                  hy, hz);
    }
  }
  const int n_inv = __syncthreads_count(inv);
  if (threadIdx.x == 0) inv_chunk[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = n_inv;
}

// Exclusive scan of in[0, n) into out (may alias in) by one block of
// kScanThreads, each thread a run of consecutive entries. Returns the total.
__device__ int block_exclusive_scan(const int* in, int* out, int n) {
  __shared__ int s_warp[kScanThreads / 32];
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per), hi = min(n, lo + per);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += in[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  __syncthreads();  // s_warp of an earlier call is read
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  int run = before + incl - local;
  for (int i = lo; i < hi; ++i) {
    const int v = in[i];
    out[i] = run;
    run += v;
  }
  return total;
}

// One block a sample: the invalid set's chunk offsets and size, then the
// cells' starts.
__global__ void cell_scan_kernel(int* __restrict__ count, int* __restrict__ start,
                                 int* __restrict__ inv_chunk, int C, int chunks) {
  const size_t b = blockIdx.x;
  int* ic = inv_chunk + b * chunks;
  const int n_inv = block_exclusive_scan(ic, ic, chunks);
  if (threadIdx.x == 0) count[b * C + C - 1] = n_inv;
  __syncthreads();
  block_exclusive_scan(count + b * C, start + b * C, C);
}

// grid (chunks, B): each slot's float4 and index to its place in cell order.
__global__ void cell_scatter_kernel(const float4* __restrict__ pts,
                                    const int* __restrict__ cell_of,
                                    const int* __restrict__ start, int* __restrict__ fill,
                                    const int* __restrict__ inv_chunk,
                                    float4* __restrict__ spts, int* __restrict__ order,
                                    int Pp, int C) {
  __shared__ int s_warp[kBuildThreads / 32];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kBuildThreads + threadIdx.x;
  const bool in = i < Pp;
  const size_t slot = static_cast<size_t>(b) * Pp + i;
  const int c = in ? cell_of[slot] : 0;
  const bool inv = in && c == C - 1;
  const unsigned m = __ballot_sync(0xffffffffu, inv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  if (!in) return;
  const size_t cell = static_cast<size_t>(b) * C + c;
  int pos;
  if (inv) {  // ascending index: earlier chunks, earlier warps, lower lanes
    int rank = __popc(m & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += s_warp[w];
    pos = start[cell] + inv_chunk[static_cast<size_t>(b) * gridDim.x + blockIdx.x] + rank;
  } else {
    pos = start[cell] + atomicAdd(fill + cell, 1);
  }
  spts[static_cast<size_t>(b) * Pp + pos] = pts[slot];
  order[static_cast<size_t>(b) * Pp + pos] = i;
}

__global__ void cell_decode_kernel(int* __restrict__ box, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) reinterpret_cast<float*>(box)[i] = key_float(box[i]);
}

// Block-wide max of a and min of u, returned to every thread.
__device__ __forceinline__ void block_max_min(float& a, float& u, float (*s_red)[kThreads / 32]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    u = fminf(u, __shfl_xor_sync(0xffffffffu, u, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // s_red of an earlier call is read
  if (lane == 0) {
    s_red[0][warp] = a;
    s_red[1][warp] = u;
  }
  __syncthreads();
  a = s_red[0][0];
  u = s_red[1][0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    a = fmaxf(a, s_red[0][w]);
    u = fminf(u, s_red[1][w]);
  }
}

// Shared memory of the search: the stage, its descriptors, a bound and a list
// entry a cell.
size_t search_smem(int C) {
  return static_cast<size_t>(kStage) * (sizeof(float4) + sizeof(int)) +
         static_cast<size_t>(kThreads) * (2 * sizeof(float4) + 2 * sizeof(int)) +
         static_cast<size_t>(C) * (sizeof(float) + sizeof(int));
}

// grid (tiles_x * tiles_y, D, B), kThreads a block.
__global__ void __launch_bounds__(kThreads) knn_cells_kernel(
    const float4* __restrict__ spts, const int* __restrict__ order,
    const int* __restrict__ count, const int* __restrict__ start,
    const float4* __restrict__ boxes, const float* __restrict__ vals,
    const float* __restrict__ lx, const float* __restrict__ ly,
    const float* __restrict__ lz, float* __restrict__ out, int* __restrict__ sel,
    float* __restrict__ w_norm, int Pp, int H, int W, int C, int tiles_x,
    float delta, int k, float rho, float tau, int rho_is_2) {
  extern __shared__ float4 smem[];
  float4* s_pts = smem;                  // (kStage,) staged points
  float4* s_lo = s_pts + kStage;         // (kThreads,) descriptor boxes
  float4* s_hi = s_lo + kThreads;
  int* s_idx = reinterpret_cast<int*>(s_hi + kThreads);  // (kStage,) their indices
  int* s_end = s_idx + kStage;           // (kThreads,) descriptor ends in the stage
  int* s_src = s_end + kThreads;         // (kThreads,) descriptor starts in cell order
  float* s_lb = reinterpret_cast<float*>(s_src + kThreads);  // (C,) block bounds
  int* s_list = reinterpret_cast<int*>(s_lb + C);            // (C,) a band's cells
  __shared__ float s_red[2][kThreads / 32];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_n;
  __shared__ int s_next[2];

  const int tid = threadIdx.x;
  const size_t b = blockIdx.z;
  const int tile_y = blockIdx.x / tiles_x;
  const int x = (blockIdx.x - tile_y * tiles_x) * kTileX + (tid % kTileX);
  const int y = tile_y * kTileY + tid / kTileX;
  const int z = blockIdx.y;
  const bool active = x < W && y < H;
  // an inactive thread takes the tile's last column / row, a query of the tile
  const float qx = lx[min(x, W - 1)], qy = ly[min(y, H - 1)], qz = lz[z];
  const float3 q = make_float3(qx, qy, qz);

  // the tile's query box (one frame: z is the same for every thread)
  float3 t_lo = q, t_hi = q;
  block_max_min(t_hi.x, t_lo.x, s_red);
  block_max_min(t_hi.y, t_lo.y, s_red);

  const int* bcount = count + b * C;
  const int* bstart = start + b * C;
  const float4* bbox = boxes + 2 * b * C;
  const float4* bpts = spts + b * Pp;
  const int* bord = order + b * Pp;
  for (int c = tid; c < C; c += kThreads) {
    s_lb[c] = (c < C - 1 && bcount[c] > 0)
                  ? p2i::knn_box_bound(t_lo, t_hi, bbox[2 * c], bbox[2 * c + 1])
                  : INFINITY;  // empty; the invalid set comes last, on its own
  }

  p2i::KnnList l;
  p2i::knn_init(l);
  int wi = INT_MAX;
  float done = -INFINITY;  // the cells with a bound <= done are visited
  const int lane = tid & 31, warp = tid >> 5;
  for (;;) {
    float wmax = active ? l.worst : -INFINITY;
    float umin = INFINITY;
    __syncthreads();  // s_lb written
    for (int c = tid; c < C; c += kThreads) {
      const float v = s_lb[c];
      if (v > done) umin = fminf(umin, v);
    }
    block_max_min(wmax, umin, s_red);
    if (umin == INFINITY || umin > wmax) break;  // no thread's list can change
    const float T = fminf(wmax, umin + delta);
    if (tid == 0) s_n = 0;
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      const float v = s_lb[c];
      if (v > done && v <= T) s_list[atomicAdd(&s_n, 1)] = c;
    }
    __syncthreads();
    const int n = s_n;
    int li = 0, mo = 0;  // next list entry, members of it already staged
    while (li < n) {
      // a listed cell whose block bound now exceeds every thread's k-th
      // distance is dropped: none of its members could enter
      float wr = active ? l.worst : -INFINITY, unused = INFINITY;
      block_max_min(wr, unused, s_red);
      const int j = li + tid;
      int cnt = 0, src = 0;
      float4 lo = make_float4(INFINITY, INFINITY, INFINITY, INFINITY), hi = lo;
      if (j < n && s_lb[s_list[j]] <= wr) {
        const int c = s_list[j];
        const int off = tid == 0 ? mo : 0;
        cnt = bcount[c] - off;
        src = bstart[c] + off;
        lo = bbox[2 * c];
        hi = bbox[2 * c + 1];
      }
      // inclusive scan of cnt over the block
      int end = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, end, o);
        if (lane >= o) end += v;
      }
      __syncthreads();  // the previous round's stage and descriptors are read
      if (lane == 31) s_warp[warp] = end;
      s_src[tid] = src;
      s_lo[tid] = lo;
      s_hi[tid] = hi;
      __syncthreads();
      int total = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        end += w < warp ? s_warp[w] : 0;
        total += s_warp[w];
      }
      const int begin = end - cnt;
      s_end[tid] = end;
      const int nd = min(kThreads, n - li);
      if (total <= kStage) {
        if (tid == 0) {
          s_next[0] = li + nd;
          s_next[1] = 0;
        }
      } else if (begin <= kStage && kStage < end) {  // the cell cut by the stage
        s_next[0] = j;
        s_next[1] = (tid == 0 ? mo : 0) + (kStage - begin);
      }
      __syncthreads();
      const int staged = min(total, kStage);
      for (int p = tid; p < staged; p += kThreads) {
        int d0 = 0, d1 = nd - 1;  // the descriptor holding stage slot p
        while (d0 < d1) {
          const int mid = (d0 + d1) >> 1;
          if (s_end[mid] > p) {
            d1 = mid;
          } else {
            d0 = mid + 1;
          }
        }
        const int g = s_src[d0] + p - (d0 ? s_end[d0 - 1] : 0);
        s_pts[p] = bpts[g];
        s_idx[p] = bord[g];
      }
      li = s_next[0];
      mo = s_next[1];
      __syncthreads();
      if (active) {
        for (int d = 0; d < nd; ++d) {
          const int beg = d ? s_end[d - 1] : 0;
          if (beg >= staged) break;
          const int e = min(s_end[d], staged);
          if (p2i::knn_box_bound(q, q, s_lo[d], s_hi[d]) > l.worst) continue;
          p2i::knn_scan_any_order(l, wi, qx, qy, qz, s_pts + beg, s_idx + beg, e - beg, k);
        }
      }
    }
    done = T;
  }

  // the invalid set (cell C - 1), in ascending index, chunk by chunk
  const int n_inv = bcount[C - 1];
  const float4 inv_lo = bbox[2 * (C - 1)], inv_hi = bbox[2 * (C - 1) + 1];
  const float lb_inv = p2i::knn_box_bound(q, q, inv_lo, inv_hi);
  for (int base = 0; base < n_inv; base += kStage) {
    const int src = bstart[C - 1] + base;
    const int first = bord[src];
    // a thread needs the chunk unless (lb_inv, first) cannot go below its k-th
    const bool need = active && !(lb_inv > l.worst || (lb_inv == l.worst && first > wi));
    if (!__syncthreads_or(need)) break;  // later chunks hold higher indices
    const int m = min(kStage, n_inv - base);
    for (int p = tid; p < m; p += kThreads) {
      s_pts[p] = bpts[src + p];
      s_idx[p] = bord[src + p];
    }
    __syncthreads();
    if (need) {
      for (int j = 0; j < m; ++j) {
        const int i = s_idx[j];
        if (lb_inv > l.worst || (lb_inv == l.worst && i > wi)) break;
        p2i::knn_scan_any_order(l, wi, qx, qy, qz, s_pts + j, s_idx + j, 1, k);
      }
    }
    __syncthreads();  // the stage is read
  }

  if (!active) return;
  const size_t row = b * (static_cast<size_t>(gridDim.y) * H * W) +
                     (static_cast<size_t>(z) * H + y) * W + x;
  p2i::knn_write_out(l, vals + b * Pp, k, rho, tau, rho_is_2, out + row,
                     sel == nullptr ? nullptr : sel + row * k,
                     w_norm == nullptr ? nullptr : w_norm + row * k);
}

int cell_build(const float4* pts, int* ints, float4* spts, int* cells, float* boxes,
               int B, int Pp, int CZ, int CY, int CX, cudaStream_t s) {
  const int C = CZ * CY * CX + 1;
  const int chunks = (Pp + kBuildThreads - 1) / kBuildThreads;
  const size_t slots = static_cast<size_t>(B) * Pp;
  int* cell_of = ints;
  int* order = ints + slots;
  int* inv_chunk = ints + 2 * slots;
  int* count = cells;
  int* start = cells + static_cast<size_t>(B) * C;
  int* fill = cells + 2 * static_cast<size_t>(B) * C;
  int* box = reinterpret_cast<int*>(boxes);
  const int n_cells = B * C;
  cell_init_kernel<<<(n_cells + 255) / 256, 256, 0, s>>>(count, fill, box, n_cells);
  const dim3 grid(chunks, B);
  cell_count_kernel<<<grid, kBuildThreads, 0, s>>>(pts, cell_of, count, box, inv_chunk,
                                                   Pp, C, CZ, CY, CX);
  cell_scan_kernel<<<B, kScanThreads, 0, s>>>(count, start, inv_chunk, C, chunks);
  cell_scatter_kernel<<<grid, kBuildThreads, 0, s>>>(pts, cell_of, start, fill, inv_chunk,
                                                     spts, order, Pp, C);
  cell_decode_kernel<<<(8 * n_cells + 255) / 256, 256, 0, s>>>(box, 8 * n_cells);
  return static_cast<int>(cudaGetLastError());
}

bool bad_build_args(const float* pts, int B, int Pp, int CZ, int CY, int CX) {
  return B < 1 || B > 65535 || Pp < 1 || CZ < 1 || CY < 1 || CX < 1 ||
         CZ * CY * CX + 1 > kMaxCells || reinterpret_cast<uintptr_t>(pts) % 16;
}

}  // namespace

// The cell build alone. pts: (B, Pp, 4) rows (x, y, z, penalty), 16-byte
// aligned. Scratch and outputs: ints (2 B Pp + B ceil(Pp / 256)) int32: the
// slots' cells, then their original indices in cell order, then the invalid
// set's chunk offsets; spts (B, Pp, 4) the points in cell order; cells
// (3, B, C) int32: count, start, fill; boxes (B, C, 2, 4) float32: lo (x, y, z,
// least penalty), hi (x, y, z, 0). C = CZ CY CX + 1 <= 4097. Returns a
// cudaError_t.
extern "C" int p2i_idw_cell_build(const float* pts, int* ints, float* spts, int* cells,
                                  float* boxes, int B, int Pp, int CZ, int CY, int CX,
                                  void* stream) {
  if (bad_build_args(pts, B, Pp, CZ, CY, CX)) return static_cast<int>(cudaErrorInvalidValue);
  return cell_build(reinterpret_cast<const float4*>(pts), ints,
                    reinterpret_cast<float4*>(spts), cells, boxes, B, Pp, CZ, CY, CX,
                    static_cast<cudaStream_t>(stream));
}

// The build, then the search. vals (B, Pp); lx/ly/lz the grid's (W,), (H,),
// (D,) coordinates; out (B, Q), Q = D H W; sel (B, Q, k) int32 and w_norm
// (B, Q, k) written when both are non-null.
extern "C" int p2i_idw_knn_chunked(const float* pts, const float* vals, const float* lx,
                                   const float* ly, const float* lz, int* ints,
                                   float* spts, int* cells, float* boxes, float* out,
                                   int* sel, float* w_norm, int B, int Pp, int D, int H,
                                   int W, int CZ, int CY, int CX, int k, float rho,
                                   float tau, int rho_is_2, void* stream) {
  if (bad_build_args(pts, B, Pp, CZ, CY, CX) || k < 1 || k > kKnnMaxK || D < 1 ||
      D > 65535 || H < 1 || W < 1 || ((sel == nullptr) != (w_norm == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = cell_build(reinterpret_cast<const float4*>(pts), ints,
                      reinterpret_cast<float4*>(spts), cells, boxes, B, Pp, CZ, CY, CX, s);
  if (rc != 0) return rc;
  const int C = CZ * CY * CX + 1;
  const size_t smem = search_smem(C);
  cudaError_t err = cudaFuncSetAttribute(knn_cells_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles_y = (H + kTileY - 1) / kTileY;
  const size_t slots = static_cast<size_t>(B) * Pp;
  const dim3 grid(tiles_x * tiles_y, D, B);
  knn_cells_kernel<<<grid, kThreads, smem, s>>>(
      reinterpret_cast<const float4*>(spts), ints + slots, cells,
      cells + static_cast<size_t>(B) * C, reinterpret_cast<const float4*>(boxes), vals,
      lx, ly, lz, out, sel, w_norm, Pp, H, W, C, tiles_x, 0.25f / static_cast<float>(CX), k,
      rho, tau, rho_is_2);
  return static_cast<int>(cudaGetLastError());
}
