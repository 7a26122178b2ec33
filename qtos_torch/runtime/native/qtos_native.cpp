// Native runtime for qtos_tpu: grid A* and the trajectory ring buffer.
//
// The reference's runtime-around-the-solver is native too (TOWR/ifopt C++ in
// Docker, PyBullet C engine); here the host-side pieces that sit off the TPU
// compute path — global grid search and the 1 kHz trajectory data plane that
// replaces the CSV files (reference: QTOS/combiner.py truncate-and-concat,
// scripts/run.py row reader) — are C++ behind a C ABI (ctypes-friendly).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 qtos_native.cpp -o libqtos_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// A* over a (H, W) obstacle grid. blocked: row-major uint8, 1 = blocked.
// out_path receives (row, col) pairs; returns path length in cells or -1.
// Semantics match qtos_tpu/planner/astar.py (8-connected, no corner cutting).
// ---------------------------------------------------------------------------
int qtos_astar(const uint8_t* blocked, int H, int W, int sr, int sc, int gr,
               int gc, int diagonal, int* out_path, int max_len) {
  if (sr < 0 || sr >= H || sc < 0 || sc >= W || gr < 0 || gr >= H || gc < 0 ||
      gc >= W)
    return -1;
  auto at = [&](int r, int c) { return blocked[r * W + c] != 0; };
  if (at(sr, sc) || at(gr, gc)) return -1;

  const int N = H * W;
  std::vector<float> g_cost(N, 1e30f);
  std::vector<int> came(N, -1);
  std::vector<uint8_t> closed(N, 0);
  auto idx = [&](int r, int c) { return r * W + c; };
  auto heur = [&](int r, int c) {
    float dr = float(r - gr), dc = float(c - gc);
    return std::sqrt(dr * dr + dc * dc);
  };

  struct Node {
    float f;
    float g;
    int id;
    bool operator>(const Node& o) const { return f > o.f; }
  };
  std::priority_queue<Node, std::vector<Node>, std::greater<Node>> open;
  g_cost[idx(sr, sc)] = 0.f;
  open.push({heur(sr, sc), 0.f, idx(sr, sc)});

  static const int DR[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
  static const int DC[8] = {0, 0, -1, 1, -1, 1, -1, 1};
  static const float DW[8] = {1.f, 1.f, 1.f, 1.f, 1.41421f, 1.41421f, 1.41421f, 1.41421f};
  const int nsteps = diagonal ? 8 : 4;

  const int goal = idx(gr, gc);
  while (!open.empty()) {
    Node cur = open.top();
    open.pop();
    if (closed[cur.id]) continue;
    if (cur.id == goal) {
      // reconstruct (reversed), then emit forward
      std::vector<int> rev;
      for (int id = goal; id != -1; id = came[id]) rev.push_back(id);
      int n = int(rev.size());
      if (n > max_len) return -1;
      for (int i = 0; i < n; ++i) {
        int id = rev[n - 1 - i];
        out_path[2 * i] = id / W;
        out_path[2 * i + 1] = id % W;
      }
      return n;
    }
    closed[cur.id] = 1;
    int r = cur.id / W, c = cur.id % W;
    for (int s = 0; s < nsteps; ++s) {
      int nr = r + DR[s], nc = c + DC[s];
      if (nr < 0 || nr >= H || nc < 0 || nc >= W) continue;
      if (at(nr, nc)) continue;
      if (s >= 4 && (at(r + DR[s], c) || at(r, c + DC[s]))) continue;  // corner cut
      float ng = cur.g + DW[s];
      int nid = idx(nr, nc);
      if (ng < g_cost[nid]) {
        g_cost[nid] = ng;
        came[nid] = cur.id;
        open.push({ng + heur(nr, nc), ng, nid});
      }
    }
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Trajectory ring buffer: the host data plane replacing the reference's CSV
// files + docker cp (QTOS/combiner.py:125-135 truncate-and-concat stitching,
// scripts/run.py:184 row reader). Rows are [37-col trajectory | 4-col
// contact mask].
// ---------------------------------------------------------------------------
struct RingBuf {
  int capacity;
  int cols;
  int end;  // rows valid in [0, end)
  std::vector<float> traj;
  std::vector<float> contact;
};

void* qtos_ringbuf_create(int capacity, int cols) {
  RingBuf* rb = new RingBuf();
  rb->capacity = capacity;
  rb->cols = cols;
  rb->end = 0;
  rb->traj.assign(size_t(capacity) * cols, 0.f);
  rb->contact.assign(size_t(capacity) * 4, 0.f);
  return rb;
}

void qtos_ringbuf_free(void* h) { delete static_cast<RingBuf*>(h); }

int qtos_ringbuf_end(void* h) { return static_cast<RingBuf*>(h)->end; }

// Stitch a new segment at row `at`: truncates everything from `at` on and
// appends the segment (the combiner.combine semantics). Returns new end or -1.
int qtos_ringbuf_stitch(void* h, int at, const float* rows, const float* contact,
                        int n) {
  RingBuf* rb = static_cast<RingBuf*>(h);
  if (at < 0 || at > rb->end || at + n > rb->capacity) return -1;
  std::memcpy(&rb->traj[size_t(at) * rb->cols], rows,
              sizeof(float) * size_t(n) * rb->cols);
  std::memcpy(&rb->contact[size_t(at) * 4], contact, sizeof(float) * size_t(n) * 4);
  rb->end = at + n;
  return rb->end;
}

// Copy rows [start, start+n) into out. Returns rows copied.
int qtos_ringbuf_read(void* h, int start, int n, float* out) {
  RingBuf* rb = static_cast<RingBuf*>(h);
  if (start < 0 || start >= rb->end) return 0;
  n = std::min(n, rb->end - start);
  std::memcpy(out, &rb->traj[size_t(start) * rb->cols],
              sizeof(float) * size_t(n) * rb->cols);
  return n;
}

// First row >= from with all four feet in contact (the stitch-point search,
// QTOS/combiner.py:245-296). Returns row index or -1.
int qtos_ringbuf_find_contact(void* h, int from) {
  RingBuf* rb = static_cast<RingBuf*>(h);
  for (int r = std::max(from, 0); r < rb->end; ++r) {
    const float* c = &rb->contact[size_t(r) * 4];
    if (c[0] > 0.5f && c[1] > 0.5f && c[2] > 0.5f && c[3] > 0.5f) return r;
  }
  return -1;
}

}  // extern "C"
