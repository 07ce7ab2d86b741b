// Inclusive max-scan of a 1-D int64 array for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it stands for XLA's lax.cummax in
// dirt_tpu/ops/binning.py (bin_faces_packed's face_of, s0_of, run_start,
// x8_run and lim8_run, :514, :515, :626, :701, :702), which torch.cummax ran
// as one row in one block at ~3 ns an element.
//   y[i] = max(x[0], ..., x[i])
//
// What bounds it: bytes only. Each element is read once and written once,
// 16 B an element (5.0 M elements: 0.024 ms at 3.35 TB/s). The design is a
// single pass with decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", 2016), so no element is
// read twice and the only traffic beside x and y is two words a tile:
//
// * A block scans one tile of TILE = THREADS x ITEMS elements. It takes the
//   tile's number from an atomicAdd on a counter, not from blockIdx, so
//   tiles start in index order and a block waits only on tiles whose blocks
//   are already running, however the blocks are scheduled.
// * A warp loads its 512 elements as 16-byte vectors, neighbouring lanes on
//   neighbouring addresses, into shared memory (one spare word after every
//   16, so reading a thread's 16 consecutive items hits no bank twice), and
//   each thread reads back its 16 consecutive items. The stores go the same
//   way back.
// * Inside the tile: a max over each thread's items, a __shfl_up_sync
//   max-scan over the warp, the eight warps' totals through shared memory.
// * Each tile has a flag word and a value word in `status`. A tile publishes
//   its aggregate (flag AGGREGATE), then, once it knows the maximum of
//   every tile before it, its inclusive maximum in the same value word (flag
//   PREFIX); the value is written before the flag, with a fence between
//   them. int64 values need all 64 bits, so flag and value cannot share a
//   word. A reader that sees AGGREGATE may read the inclusive maximum
//   instead: max is idempotent and that maximum covers only tiles the
//   reader takes in anyway, so either value gives the same result.
// * Warp 0 of a waiting tile looks back over 32 predecessors at a time
//   (a lane each), waits until none of them is unpublished, and stops at
//   the nearest PREFIX.
//
// Max is exact and associative on integers, so the result equals
// torch.cummax(x, 0).values bit for bit on any input, whatever order the
// tiles finish in. The identity is INT64_MIN.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_ITEMS = 32 * ITEMS;                   // 512
constexpr int TILE = THREADS * ITEMS;                    // 4096
constexpr int PAD = 16;          // a spare shared word after every 16
constexpr int WARP_WORDS = WARP_ITEMS + WARP_ITEMS / PAD;
constexpr long long IDENTITY = LLONG_MIN;
constexpr unsigned FULL = 0xffffffffu;
// Flag words: 0 until the tile publishes anything.
constexpr unsigned long long AGGREGATE = 1;
constexpr unsigned long long PREFIX = 2;

__device__ __forceinline__ long long max64(long long a, long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int padded(int e) { return e + e / PAD; }

__device__ __forceinline__ void publish(volatile unsigned long long* flags,
                                        volatile long long* values, int tile,
                                        long long value,
                                        unsigned long long flag) {
  values[tile] = value;
  __threadfence();
  flags[tile] = flag;
}

// The maximum of every tile before `tile`, by warp 0's look-back.
__device__ long long look_back(volatile unsigned long long* flags,
                               volatile long long* values, int tile,
                               int lane) {
  long long prefix = IDENTITY;
  for (int last = tile - 1;; last -= 32) {
    const int j = last - lane;
    // Lanes past tile 0 read as an empty aggregate: tile 0 publishes
    // PREFIX at once, so the look-back stops at it or before.
    unsigned long long flag = AGGREGATE;
    do {
      if (j >= 0) {
        flag = flags[j];
      }
    } while (__any_sync(FULL, flag == 0));
    __threadfence();
    long long value = IDENTITY;
    if (j >= 0) {
      value = values[j];
    }
    const unsigned done = __ballot_sync(FULL, flag == PREFIX);
    const int stop = done ? __ffs(done) - 1 : 31;
    long long m = IDENTITY;
    if (lane <= stop) {
      m = value;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      m = max64(m, __shfl_xor_sync(FULL, m, d));
    }
    prefix = max64(prefix, m);
    if (done) {
      return prefix;
    }
  }
}

// `status`: [0] the tile counter, [1, 1 + tiles) the flags, [1 + tiles,
// 1 + 2 tiles) the values, all zero at launch. `vector`: x and y are 16-byte
// aligned, so whole warp segments move as 16-byte vectors.
__global__ void __launch_bounds__(THREADS)
max_scan_kernel(const long long* __restrict__ x, long long* __restrict__ y,
                long long n, unsigned long long* status, int tiles,
                bool vector) {
  __shared__ long long s_items[WARPS * WARP_WORDS];
  __shared__ long long s_warp[WARPS];
  __shared__ long long s_prefix;
  __shared__ int s_tile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = static_cast<int>(atomicAdd(status, 1ull));
  }
  __syncthreads();
  const int tile = s_tile;
  volatile unsigned long long* flags = status + 1;
  volatile long long* values =
      reinterpret_cast<volatile long long*>(status + 1 + tiles);

  // Warp-striped loads into this warp's shared segment.
  const long long seg = static_cast<long long>(tile) * TILE +
                        static_cast<long long>(warp) * WARP_ITEMS;
  long long* sw = s_items + warp * WARP_WORDS;
  const bool whole = vector && seg + WARP_ITEMS <= n;
  if (whole) {
    const longlong2* src = reinterpret_cast<const longlong2*>(x + seg);
#pragma unroll
    for (int k = 0; k < ITEMS / 2; ++k) {
      const int v = k * 32 + lane;
      const longlong2 pair = src[v];
      sw[padded(2 * v)] = pair.x;
      sw[padded(2 * v) + 1] = pair.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = k * 32 + lane;
      long long v = IDENTITY;
      if (seg + e < n) {
        v = x[seg + e];
      }
      sw[padded(e)] = v;
    }
  }
  __syncwarp();

  // Each thread's ITEMS consecutive elements, scanned in registers.
  long long item[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    item[i] = sw[padded(lane * ITEMS + i)];
  }
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) {
    item[i] = max64(item[i], item[i - 1]);
  }

  // The warp's scan of the threads' maxima, then the warps' totals.
  long long run = item[ITEMS - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(FULL, run, d);
    if (lane >= d) {
      run = max64(run, up);
    }
  }
  long long before = __shfl_up_sync(FULL, run, 1);
  if (lane == 0) {
    before = IDENTITY;
  }
  if (lane == 31) {
    s_warp[warp] = run;
  }
  __syncthreads();
  long long aggregate = IDENTITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const long long total = s_warp[w];
    if (w < warp) {
      before = max64(before, total);
    }
    aggregate = max64(aggregate, total);
  }

  // The tiles before this one.
  if (warp == 0) {
    long long prefix = IDENTITY;
    if (tile == 0) {
      if (lane == 0) {
        publish(flags, values, tile, aggregate, PREFIX);
      }
    } else {
      if (lane == 0) {
        publish(flags, values, tile, aggregate, AGGREGATE);
      }
      prefix = look_back(flags, values, tile, lane);
      if (lane == 0) {
        publish(flags, values, tile, max64(prefix, aggregate), PREFIX);
      }
    }
    if (lane == 0) {
      s_prefix = prefix;
    }
  }
  __syncthreads();
  const long long carry = max64(s_prefix, before);

  // Back through the same shared segment to warp-striped stores (every
  // lane read its items before the barrier above).
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    sw[padded(lane * ITEMS + i)] = max64(item[i], carry);
  }
  __syncwarp();
  if (whole) {
    longlong2* dst = reinterpret_cast<longlong2*>(y + seg);
#pragma unroll
    for (int k = 0; k < ITEMS / 2; ++k) {
      const int v = k * 32 + lane;
      dst[v] = make_longlong2(sw[padded(2 * v)], sw[padded(2 * v) + 1]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = k * 32 + lane;
      if (seg + e < n) {
        y[seg + e] = sw[padded(e)];
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `x` and `y` hold n int64
// elements (8-byte aligned; 16-byte aligned ones move as vectors),
// `status` 1 + 2 * ceil(n / 4096) zeroed int64 words (`status_words`, checked
// against the tile size). One launch on `stream` when n > 0, no
// synchronisation. Returns the CUDA error code (0 on success).
extern "C" int dirt_max_scan(const void* x, void* y, void* status,
                             long long n, long long status_words,
                             void* stream) {
  if (n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return 0;
  }
  const long long tiles = (n + TILE - 1) / TILE;
  if (tiles > INT_MAX || status_words != 1 + 2 * tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const auto ya = reinterpret_cast<uintptr_t>(y);
  if (xa % 8 || ya % 8 || reinterpret_cast<uintptr_t>(status) % 8) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  max_scan_kernel<<<static_cast<unsigned>(tiles), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(x), static_cast<long long*>(y), n,
      static_cast<unsigned long long*>(status), static_cast<int>(tiles),
      xa % 16 == 0 && ya % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}
