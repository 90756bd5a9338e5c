// K8 — the Threefry-2x32 hash (20 rounds), one thread an output pair.
//
// Not a TPU kernel's port: JAX's threefry2x32 (jax/_src/prng.py,
// _threefry2x32_lowering) is an XLA computation, reached from the
// reference's spawn (noize_tpu/erosion/particles.py:75), its splits and
// fold-ins and the vegetation draws.  The plain version is
// prng._threefry2x32_plain: the same rounds as int64 torch operations,
// some 170 launches a hash whatever its size.
//
// Bound: a draw is bytes (each output pair 16 bytes, each counter 16 read),
// a few microseconds at the sizes the port draws; the plain version is
// launch-bound.
//
// Design: the counters and the key words broadcast against each other
// (up to 8 dimensions, a stride each, 0 where broadcast), so a stack of
// keys, a split or a 10^6 draw is one launch with no copies; each thread
// runs the five key injections and 20 rounds in uint32 registers (adds wrap,
// rotations are funnel shifts) and writes the two words as int64, the plain
// version's dtype.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 8;

struct Bcast {
  int ndim;
  long long shape[kMaxDims];
  long long key[kMaxDims], x0[kMaxDims], x1[kMaxDims];  // element strides
};

__device__ __forceinline__ unsigned rotl(unsigned v, int r) { return __funnelshift_l(v, v, r); }

__global__ void __launch_bounds__(kThreads)
threefry(const unsigned* __restrict__ key, long long key_word, const long long* __restrict__ x0,
         const long long* __restrict__ x1, Bcast b, long long total, long long* y0,
         long long* y1) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    long long rest = e, ok = 0, o0 = 0, o1 = 0;
    for (int d = b.ndim - 1; d >= 0; --d) {
      const long long idx = rest % b.shape[d];
      rest /= b.shape[d];
      ok += idx * b.key[d];
      o0 += idx * b.x0[d];
      o1 += idx * b.x1[d];
    }
    const unsigned ks0 = key[ok], ks1 = key[ok + key_word];
    const unsigned ks[3] = {ks0, ks1, ks0 ^ ks1 ^ 0x1BD11BDAu};
    unsigned a = (unsigned)x0[o0] + ks[0];
    unsigned c = (unsigned)x1[o1] + ks[1];
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a += c;
        c = rotl(c, rot[i % 2][j]) ^ a;
      }
      a += ks[(i + 1) % 3];
      c += ks[(i + 2) % 3] + (unsigned)(i + 1);
    }
    y0[e] = (long long)a;
    y1[e] = (long long)c;
  }
}

}  // namespace

// key: uint32 words, word 0 of each key at the key strides' offset and word
// 1 key_word elements after it; x0, x1: int64 counters (values < 2^32);
// y0, y1: int64[total], row-major over shape.  shape and the three stride
// lists (host i64[ndim] each, element strides, 0 where broadcast) describe
// the broadcast.  All other pointers are device memory.
extern "C" int noize_threefry(const unsigned* key, long long key_word, const long long* x0,
                              const long long* x1, int ndim, const long long* shape,
                              const long long* key_strides, const long long* x0_strides,
                              const long long* x1_strides, long long* y0, long long* y1,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ndim < 0 || ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  Bcast b;
  b.ndim = ndim;
  long long total = 1;
  for (int d = 0; d < ndim; ++d) {
    if (shape[d] < 0) return static_cast<int>(cudaErrorInvalidValue);
    b.shape[d] = shape[d];
    b.key[d] = key_strides[d];
    b.x0[d] = x0_strides[d];
    b.x1[d] = x1_strides[d];
    total *= shape[d];
  }
  if (total == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (total + kThreads - 1) / kThreads;
  threefry<<<(int)(blocks < 8192 ? blocks : 8192), kThreads, 0, stream>>>(
      key, key_word, x0, x1, b, total, y0, y1);
  return static_cast<int>(cudaGetLastError());
}
