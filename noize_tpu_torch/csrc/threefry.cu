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
// (up to 8 dimensions, a stride each, 0 where broadcast, passed by value in
// one struct), so a stack of keys, a split or a 10^6 draw is one launch with
// no copies; each thread runs the five key injections and 20 rounds in
// uint32 registers (adds wrap, rotations are funnel shifts) and writes the
// two words as int64, the plain version's dtype.
//
// The draw entry (noize_randint, redesigned for the card): a whole
// randint(key, shape, lo, hi) — or randint(split(key), ...), the spawn's
// draw — in one launch.  The host path of the hash above built stride
// arrays for every call and randint ran a split, a hash and ~12 int64
// elementwise operations after it; here each thread derives its leaf key
// from its key by the split chain (each split one hash of the counter
// block (0, j)), hashes its counter i, applies randint's modular combine in
// uint32 (prng.randint), and writes int32 or, for the spawn's coordinates,
// float32 (round to nearest, as .to(float32)).  Five hashes an output, all
// in registers; the plain version is prng._randint_composed.
#include <cuda_runtime.h>

constexpr int kMaxDims = 8;

// The broadcast of one hash, passed by value to noize_threefry (outside the
// unnamed namespace: the C entry's parameter needs external linkage).
struct NoizeBcast {
  int ndim;
  long long shape[kMaxDims];
  long long key[kMaxDims], x0[kMaxDims], x1[kMaxDims];  // element strides
};

namespace {

constexpr int kThreads = 256;
using Bcast = NoizeBcast;

__device__ __forceinline__ unsigned rotl(unsigned v, int r) { return __funnelshift_l(v, v, r); }

// threefry2x32 of the block (x0, x1) under the key (k0, k1), in place.
__device__ __forceinline__ void hash(unsigned k0, unsigned k1, unsigned& x0, unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
}

// split(key)[j]: the hash of the block (0, j).
__device__ __forceinline__ void split_key(unsigned& k0, unsigned& k1, unsigned j) {
  unsigned a = 0u, b = j;
  hash(k0, k1, a, b);
  k0 = a;
  k1 = b;
}

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
    unsigned a = (unsigned)x0[o0], c = (unsigned)x1[o1];
    hash(key[ok], key[ok + key_word], a, c);
    y0[e] = (long long)a;
    y1[e] = (long long)c;
  }
}

// out[(k·J + j)·size + i] = randint(leaf, (size,), lo, lo + span)[i] for
// the k-th key (keys: u32 [K, 2] contiguous); the leaf is split(key)[j],
// j < 2, when split_first (J = 2), else the key itself (J = 1).  randint's
// own split gives the two halves' keys, its counters are (i >> 32, i).
__global__ void __launch_bounds__(kThreads)
randint(const unsigned* __restrict__ keys, long long total, long long size, int split_first,
        int lo, unsigned span, unsigned mult, int as_float, void* out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e % size, rest = e / size;
    const long long k = split_first ? rest / 2 : rest;
    unsigned k0 = keys[2 * k], k1 = keys[2 * k + 1];
    if (split_first) split_key(k0, k1, (unsigned)(rest % 2));
    unsigned h0 = k0, h1 = k1, l0 = k0, l1 = k1;
    split_key(h0, h1, 0u);
    split_key(l0, l1, 1u);
    const unsigned c_hi = (unsigned)(i >> 32), c_lo = (unsigned)i;
    unsigned a = c_hi, b = c_lo, c = c_hi, d = c_lo;
    hash(h0, h1, a, b);
    hash(l0, l1, c, d);
    const unsigned higher = a ^ b, lower = c ^ d;
    const unsigned offset = (higher % span * mult + lower % span) % span;
    const int v = (int)((unsigned)lo + offset);
    if (as_float) {
      static_cast<float*>(out)[e] = __int2float_rn(v);
    } else {
      static_cast<int*>(out)[e] = v;
    }
  }
}

}  // namespace

// key: uint32 words, word 0 of each key at the key strides' offset and word
// 1 key_word elements after it; x0, x1: int64 counters (values < 2^32);
// y0, y1: int64[total], row-major over b.shape; b: the broadcast (b.ndim
// dims, element strides of the key words and counters, 0 where broadcast).
// All pointers are device memory.
extern "C" int noize_threefry(const unsigned* key, long long key_word, const long long* x0,
                              const long long* x1, NoizeBcast b, long long* y0, long long* y1,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (b.ndim < 0 || b.ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  long long total = 1;
  for (int d = 0; d < b.ndim; ++d) {
    if (b.shape[d] < 0) return static_cast<int>(cudaErrorInvalidValue);
    total *= b.shape[d];
  }
  if (total == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (total + kThreads - 1) / kThreads;
  threefry<<<(int)(blocks < 8192 ? blocks : 8192), kThreads, 0, stream>>>(
      key, key_word, x0, x1, b, total, y0, y1);
  return static_cast<int>(cudaGetLastError());
}

// keys: u32 [n_keys, 2] contiguous device memory; out: [n_keys, J, size]
// int32 or float32 (as_float) device memory, J = 2 if split_first else 1.
// lo: the draw's minval; span, mult: randint's (maxval - minval) mod 2^32
// (1 if maxval <= minval) and (2^16 mod span)^2 mod span.
extern "C" int noize_randint(const unsigned* keys, long long n_keys, long long size,
                             int split_first, int lo, unsigned span, unsigned mult,
                             int as_float, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_keys < 0 || size < 0 || span == 0u) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n_keys * (split_first ? 2 : 1) * size;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (total + kThreads - 1) / kThreads;
  randint<<<(int)(blocks < 8192 ? blocks : 8192), kThreads, 0, stream>>>(
      keys, total, size, split_first, lo, span, mult, as_float, out);
  return static_cast<int>(cudaGetLastError());
}
