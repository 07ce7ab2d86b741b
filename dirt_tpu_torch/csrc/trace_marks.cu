// Stage markers for the device trace (sm_90a).
//
// Replaces no TPU kernel: a CUDA-graph replay carries no host spans, since
// the port's Python runs only while the graph is captured. So a stage of
// the raster op, of the shading or of the texture lookup
// (``dirt_tpu_torch/utils/trace.py``'s SPANS table) is bounded on the
// device itself: a one-thread kernel that does nothing is launched on the
// stage's stream where the stage opens and where it closes, and a capture
// records those launches into the graph like any other. A profiler's device trace (torch.profiler, Nsight Systems) shows
// ``span_mark<C, O>`` in every replay, on the same clock as every other
// device operation: the marker that closes span C (0: none) and opens span
// O (0: none), so stages that abut share one marker.
//
// The binning's closing marker also folds the cap fills into a small block
// of device counters (``g_fills``): for each cap, the count the binning
// used (an int64 scalar it already computed on the device) over the cap,
// kept as the running maximum. The block is a module global, so it outlives
// every graph that wrote it; ``dirt_trace_fills`` reads it and
// ``dirt_trace_clear`` zeroes it.
//
// What bounds it: a launch. One thread, at most six 8-byte loads and six
// atomics; ~1-2 us of device time a marker inside a graph.

#include <cuda_runtime.h>

constexpr int FILLS = 6;  // trace.FILLS: pool, work, expand, budget, tile, bin

struct Fills {
  const long long* used[FILLS];  // device int64 scalars, or null
  long long cap[FILLS];
};

__device__ float g_fills[FILLS];

template <int Close, int Open>
__global__ void span_mark(Fills f) {
  for (int i = 0; i < FILLS; ++i) {
    if (f.used[i] != nullptr && f.cap[i] > 0) {
      const float share =
          static_cast<float>(static_cast<double>(*f.used[i]) /
                             static_cast<double>(f.cap[i]));
      // Shares are >= 0, and non-negative floats order as their bits do.
      atomicMax(reinterpret_cast<int*>(&g_fills[i]), __float_as_int(share));
    }
  }
}

namespace {

using Launch = void (*)(Fills, cudaStream_t);

template <int Close, int Open>
void launch(Fills f, cudaStream_t stream) {
  span_mark<Close, Open><<<1, 1, 0, stream>>>(f);
}

struct Mark {
  int close, open;
  Launch launch;
};

// The markers launched (trace.py's MARKS): the raster op's in a step's
// order, then a shading call's, a texture lookup's and a texture
// gradient's.
const Mark kMarks[] = {
    {0, 1, launch<0, 1>}, {1, 0, launch<1, 0>},   // clip
    {0, 2, launch<0, 2>}, {2, 3, launch<2, 3>},   // setup, binning
    {3, 4, launch<3, 4>}, {4, 0, launch<4, 0>},   // raster_fwd
    {0, 5, launch<0, 5>}, {5, 0, launch<5, 0>},   // raster_bwd
    {0, 6, launch<0, 6>}, {6, 0, launch<6, 0>},   // shade
    {0, 7, launch<0, 7>}, {7, 0, launch<7, 0>},   // texture
    {0, 8, launch<0, 8>}, {8, 0, launch<8, 0>}};  // texture_grad

}  // namespace

// Plain C entry points (bound with ctypes).
//
// One marker that closes span `close` and opens span `open` (a pair of
// kMarks; any other is an invalid value) on `stream`; `used` and `caps` are
// host arrays of FILLS (device pointers to int64 scalars, null where a fill is
// not kept, and the caps they are shares of), or both null. No
// synchronisation. Returns the CUDA error code (0 on success).
extern "C" int dirt_span_mark(int close, int open,
                              const void* const* used, const long long* caps,
                              void* stream) {
  Launch found = nullptr;
  for (const Mark& mark : kMarks) {
    if (mark.close == close && mark.open == open) found = mark.launch;
  }
  if (found == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Fills f;
  for (int i = 0; i < FILLS; ++i) {
    f.used[i] = used ? static_cast<const long long*>(used[i]) : nullptr;
    f.cap[i] = caps ? caps[i] : 0;
  }
  found(f, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The current device's fills into `out` (FILLS floats, host). Synchronous.
extern "C" int dirt_trace_fills(float* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_fills, sizeof(float) * FILLS));
}

// Zero the current device's fills. Synchronous.
extern "C" int dirt_trace_clear() {
  const float zeros[FILLS] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_fills, zeros, sizeof(float) * FILLS));
}
