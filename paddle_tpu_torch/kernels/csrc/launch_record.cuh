// Launch geometry queries, shared by every kernel source of the port.
//
// Each source's `<entry>_geometry` C function runs its entry point with a
// Scope open: every launch site first calls `note(grid, threads, smem)`,
// which, inside a Scope, records the launch (5 ints: grid x, y, z, threads
// a block, dynamic shared memory bytes) and tells the site to skip it. So
// the geometry a query reports is the one the launch code computes — the
// card holds the Python launch plans of `analysis/kernelcheck.py` equal to
// it. Outside a Scope `note` returns false and costs one load.
#pragma once

#include <cuda_runtime.h>

namespace launch_record {

struct Record {
  int* out;  // 5 ints a launch
  int max;   // launches `out` has room for
  int n;     // launches noted (may exceed max: the caller's room is short)
};

inline Record*& current() {
  static thread_local Record* record = nullptr;
  return record;
}

// True inside a Scope: the launch is recorded and must not be made.
inline bool note(dim3 grid, int threads, size_t smem) {
  Record* r = current();
  if (r == nullptr) return false;
  if (r->n < r->max) {
    int* o = r->out + 5 * r->n;
    o[0] = (int)grid.x;
    o[1] = (int)grid.y;
    o[2] = (int)grid.z;
    o[3] = threads;
    o[4] = (int)smem;
  }
  ++r->n;
  return true;
}

struct Scope {
  Record record;
  Scope(int* out, int max) : record{out, max, 0} { current() = &record; }
  ~Scope() { current() = nullptr; }
};

// The query's result: launches noted, or the entry point's error negated.
inline int result(const Scope& scope, int err) {
  return err != 0 ? -err : scope.record.n;
}

// A stand-in operand address for a query: 1 MiB, 16-byte aligned, never
// dereferenced (no launch is made).
inline void* fake_ptr() { return reinterpret_cast<void*>(1 << 20); }

}  // namespace launch_record
